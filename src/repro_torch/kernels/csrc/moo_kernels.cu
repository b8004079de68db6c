// Constraint-dominance counts and fronts for the device NSGA-II, for Hopper
// (sm_90a).
//
// dominance_counts (K3) replaces repro/kernels/moo_kernels.py
// dominance_counts_pallas: for every point i, the number of ACTIVE points j
// that constraint-dominate it, where j dominates i iff
//
//   * both are feasible (viol <= 0) and j's objectives are <= i's in every
//     component and < in at least one, or
//   * j is feasible and i is not, or
//   * both are infeasible and viol_j < viol_i.
//
// One thread per point i, 128 to a block.  The block walks the j axis in
// shared-memory tiles of (objs, viol, active) and counts in an int32
// register, so the counts are exact and equal the plain version's.  The
// ragged last tile is masked here, so any P is accepted.
//
// What bounds it on the H100: at the GA's populations (P = 64 and 128) the
// whole call is a few thousand comparisons, so it is bound by the launch, not
// by bytes or operations.  Peeling fronts with it costs one launch and one
// host sync per front, so the GA's ranking takes constraint_fronts below, and
// this kernel is left for populations above its size cap.
//
// constraint_fronts peels every feasible front in one launch: the reference's
// lax.while_loop of dominance_counts_pallas rounds (repro/core/fastmoo.py
// constraint_ranks) as one kernel.  One block, one thread per point
// (P <= 1,024): the points go to shared memory, and thread i builds row i of
// the dominance relation among feasible points once, as a bit mask (word w
// of row i holds bit b for point 32 w + b; P x P bits, 2 KiB at P = 128,
// 128 KiB at P = 1,024, stored word-major so that neighbouring threads read
// neighbouring words).  A second bit mask holds the feasible points not yet
// in a front.  Each round, a point of that set with no dominator left in it
// joins the round's front; one ballot per warp removes the front from the
// set, and __syncthreads_or says whether any point is left.  The fronts'
// count stays on the card as a scalar, so the caller's closed form for the
// infeasible points needs no host sync: the whole ranking is one launch and
// no sync, where it was ~4.4 launches and as many syncs.  A round is a few
// word ANDs per thread; the call is bound by its launch and its chain of
// rounds, not by bytes or operations.
//
// constraint_fronts_lanes is the same kernel over L independent lanes of a
// batched GA (repro/core/fastmoo.py CompiledNSGA2.run_sweep, whose vmap
// ranks every lane in one program): gridDim.x = L, block l at lane l's
// offset into (L, P, n_obj) objs, (L, P) viol and fronts and (L,) counts.
// A sweep's ranking is then one launch for all its lanes, where one lane at
// a time takes L; its bound is the single lane's times L, and each lane's
// block is still bound by its chain of rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kMaxObj = 4;

__global__ void __launch_bounds__(kTile)
dominance_counts_kernel(const float* __restrict__ objs,
                        const float* __restrict__ viol,
                        const unsigned char* __restrict__ active,
                        int* __restrict__ out, int p, int n_obj) {
  extern __shared__ float smem[];
  float* s_obj = smem;                       // (kTile, n_obj)
  float* s_viol = smem + kTile * n_obj;      // (kTile,)
  int* s_act = reinterpret_cast<int*>(s_viol + kTile);  // (kTile,)

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < p;
  float oi[kMaxObj];
  for (int k = 0; k < n_obj; ++k) oi[k] = valid ? objs[i * n_obj + k] : 0.0f;
  const float vi = valid ? viol[i] : 0.0f;
  const bool fi = vi <= 0.0f;

  int count = 0;
  for (int j0 = 0; j0 < p; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < p) {
      for (int k = 0; k < n_obj; ++k)
        s_obj[threadIdx.x * n_obj + k] = objs[j * n_obj + k];
      s_viol[threadIdx.x] = viol[j];
      s_act[threadIdx.x] = active[j] != 0;
    } else {
      s_act[threadIdx.x] = 0;
    }
    __syncthreads();
    const int nj = min(kTile, p - j0);
    for (int t = 0; t < nj; ++t) {
      if (!s_act[t]) continue;  // the same t for every thread: no divergence
      const float vj = s_viol[t];
      const bool fj = vj <= 0.0f;
      bool dom;
      if (fi) {
        bool le = fj;
        bool lt = false;
        for (int k = 0; k < n_obj; ++k) {
          const float oj = s_obj[t * n_obj + k];
          le = le && (oj <= oi[k]);
          lt = lt || (oj < oi[k]);
        }
        dom = le && lt;
      } else {
        dom = fj || (vj < vi);
      }
      count += dom;
    }
    __syncthreads();
  }
  if (valid) out[i] = count;
}

constexpr int kMaxFrontsP = 1024;  // one thread per point in one block

__global__ void __launch_bounds__(kMaxFrontsP)
constraint_fronts_kernel(const float* __restrict__ objs,
                         const float* __restrict__ viol,
                         long long* __restrict__ front,
                         long long* __restrict__ n_fronts, int p, int n_obj) {
  extern __shared__ unsigned int bits[];
  // lane blockIdx.x of a batch of lanes (one lane: blockIdx.x = 0)
  objs += static_cast<size_t>(blockIdx.x) * p * n_obj;
  viol += static_cast<size_t>(blockIdx.x) * p;
  front += static_cast<size_t>(blockIdx.x) * p;
  n_fronts += blockIdx.x;
  const int words = (p + 31) / 32;
  unsigned int* dom = bits;                // (words, p): point 32 w + b dominates i
  unsigned int* left = dom + words * p;    // (words,): feasible, in no front yet
  float* s_obj = reinterpret_cast<float*>(left + words);  // (p, n_obj)
  float* s_viol = s_obj + p * n_obj;                      // (p,)

  const int i = threadIdx.x;
  for (int k = i; k < p * n_obj; k += blockDim.x) s_obj[k] = objs[k];
  for (int k = i; k < p; k += blockDim.x) s_viol[k] = viol[k];
  __syncthreads();

  const bool valid = i < p;
  const bool fi = valid && s_viol[i] <= 0.0f;
  float oi[kMaxObj];
  for (int k = 0; k < n_obj; ++k) oi[k] = valid ? s_obj[i * n_obj + k] : 0.0f;
  // row i: which feasible points Pareto-dominate the feasible point i (an
  // infeasible point is never dominated by one in the peel: it takes no front)
  for (int w = 0; w < words; ++w) {
    unsigned int row = 0;
    if (fi) {
      const int nb = min(32, p - 32 * w);
      for (int b = 0; b < nb; ++b) {
        const int j = 32 * w + b;
        if (!(s_viol[j] <= 0.0f)) continue;
        bool le = true;
        bool lt = false;
        for (int k = 0; k < n_obj; ++k) {
          const float oj = s_obj[j * n_obj + k];
          le = le && (oj <= oi[k]);
          lt = lt || (oj < oi[k]);
        }
        row |= static_cast<unsigned int>(le && lt) << b;
      }
    }
    if (valid) dom[w * p + i] = row;
  }
  const unsigned int feas_warp = __ballot_sync(0xffffffffu, fi);
  if ((i & 31) == 0) left[i >> 5] = feas_warp;   // blockDim = 32 words
  if (valid && !fi) front[i] = -1;

  bool mine = fi;   // still to be placed in a front
  int r = 0;
  int any_left = __syncthreads_or(mine);   // also publishes dom and left
  while (any_left && r <= p) {
    bool joins = false;
    if (mine) {
      unsigned int hit = 0;
      for (int w = 0; w < words; ++w) hit |= dom[w * p + i] & left[w];
      joins = hit == 0;
    }
    if (joins) {
      front[i] = r;
      mine = false;
    }
    const unsigned int joined = __ballot_sync(0xffffffffu, joins);
    any_left = __syncthreads_or(mine);   // every read of left is done
    if ((i & 31) == 0) left[i >> 5] &= ~joined;
    __syncthreads();
    ++r;
  }
  if (i == 0) *n_fronts = r;
}

}  // namespace

extern "C" int dominance_counts_launch(const void* objs, const void* viol,
                                       const void* active, void* out, int p,
                                       int n_obj, void* stream) {
  const int blocks = (p + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kTile) * (n_obj + 2) * sizeof(float);
  dominance_counts_kernel<<<blocks, kTile, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(objs), static_cast<const float*>(viol),
      static_cast<const unsigned char*>(active), static_cast<int*>(out), p,
      n_obj);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// One block of 32 * ceil(p / 32) threads a lane; p in 1..1024, n_obj in 1..4.
int launch_fronts(const void* objs, const void* viol, void* front, void* n_fronts,
                  int lanes, int p, int n_obj, void* stream) {
  if (lanes < 1 || p < 1 || p > kMaxFrontsP || n_obj < 1 || n_obj > kMaxObj)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (p + 31) / 32;
  const size_t smem = (static_cast<size_t>(words) * p + words) * sizeof(unsigned int) +
                      static_cast<size_t>(p) * (n_obj + 1) * sizeof(float);
  if (smem > 48 * 1024) {   // above 48 KB a block's shared memory must be opted into
    const cudaError_t err = cudaFuncSetAttribute(
        constraint_fronts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constraint_fronts_kernel<<<lanes, 32 * words, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(objs), static_cast<const float*>(viol),
      static_cast<long long*>(front), static_cast<long long*>(n_fronts), p, n_obj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// front (p,) int64 gets each feasible point's front (0 = best) and -1 for an
// infeasible one; n_fronts (1,) int64 the number of feasible fronts.
extern "C" int constraint_fronts_launch(const void* objs, const void* viol,
                                        void* front, void* n_fronts, int p,
                                        int n_obj, void* stream) {
  return launch_fronts(objs, viol, front, n_fronts, 1, p, n_obj, stream);
}

// The same over lanes: objs (lanes, p, n_obj), viol (lanes, p), front
// (lanes, p), n_fronts (lanes,); one block a lane.
extern "C" int constraint_fronts_lanes_launch(const void* objs, const void* viol,
                                              void* front, void* n_fronts, int lanes,
                                              int p, int n_obj, void* stream) {
  return launch_fronts(objs, viol, front, n_fronts, lanes, p, n_obj, stream);
}
