// Constraint-dominance counts for the device NSGA-II, for Hopper (sm_90a).
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
// by bytes or operations.  Nothing is done about that in this kernel; the
// caller launches it once per front-peeling round.

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
