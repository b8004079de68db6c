// BEHAV statistics of approximate-multiplier configs, for Hopper (sm_90a).
//
// Two kernels with one output contract, each launched through a plain C
// function (bound from Python with ctypes, see kernels/char_kernels.py):
//
//   behav_stats_table  (K1) replaces repro/kernels/char_kernels.py
//                      behav_stats_pallas: per-row planes come in as the
//                      gathered (R, D, 4, B) int32 "small" tables, the exact
//                      products and relative-error weights as (A, B) tables.
//   behav_stats_entry  (K2) replaces behav_stats_entry_pallas: the only input
//                      is the (D, R) mask block; the block synthesizes its
//                      planes with the carry-chain model (planes.cuh, shared
//                      with K5) and derives the exact products and weights
//                      from the operand codes.
//
// One block owns one (config d, A-tile j) output row, so no atomics are
// needed: it stages config d's (R, 4, B) planes in shared memory (16 KiB at
// 8 bits), strides its 256 threads over the a_tile x B pairs, selects the
// bit-pair plane per row with shifts and masks, and reduces
//
//   int32: 0 sum|e|  1 #(e != 0)  2 max|e|  3 sum hi^2  4 sum hi*lo  5 sum lo^2
//   f32:   0 sum |e| * w
//
// (hi = |e| >> 8, lo = |e| & 255) with warp shuffles, then one store per
// channel.  The A-tile rule of the caller (a_tile * B * max|e| < 2^30) bounds
// every int32 block sum, so the int channels are exact in any order; the f32
// channel sums in another order than the plain version.
//
// What bounds it on the H100: integer issue.  The inputs are a few KiB per
// config and the (A, B) tables stay in L2, while every pair costs ~20 int32
// operations.  The design keeps every operand of the inner loop in registers
// or conflict-free shared memory (consecutive threads read consecutive b).

#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChan = 8;

struct Acc {
  int s_abs, cnt, mx, h2, hl, l2;
  float rel;
};

__device__ __forceinline__ void accumulate(Acc& acc, int err, float w) {
  const int ae = err < 0 ? -err : err;
  const int hi = ae >> 8;
  const int lo = ae & 255;
  acc.s_abs += ae;
  acc.cnt += err != 0;
  acc.mx = max(acc.mx, ae);
  acc.h2 += hi * hi;
  acc.hl += hi * lo;
  acc.l2 += lo * lo;
  acc.rel = __fadd_rn(acc.rel, __fmul_rn(static_cast<float>(ae), w));
}

// Block reduction of the seven channels; thread 0 writes the block's row.
__device__ void reduce_store(Acc acc, int* int_row, float* rel_row) {
  __shared__ int s_int[kWarps][6];
  __shared__ float s_rel[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    acc.s_abs += __shfl_down_sync(0xffffffffu, acc.s_abs, off);
    acc.cnt += __shfl_down_sync(0xffffffffu, acc.cnt, off);
    acc.mx = max(acc.mx, __shfl_down_sync(0xffffffffu, acc.mx, off));
    acc.h2 += __shfl_down_sync(0xffffffffu, acc.h2, off);
    acc.hl += __shfl_down_sync(0xffffffffu, acc.hl, off);
    acc.l2 += __shfl_down_sync(0xffffffffu, acc.l2, off);
    acc.rel += __shfl_down_sync(0xffffffffu, acc.rel, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_int[warp][0] = acc.s_abs;
    s_int[warp][1] = acc.cnt;
    s_int[warp][2] = acc.mx;
    s_int[warp][3] = acc.h2;
    s_int[warp][4] = acc.hl;
    s_int[warp][5] = acc.l2;
    s_rel[warp] = acc.rel;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t[6];
    for (int c = 0; c < 6; ++c) t[c] = s_int[0][c];
    float rel = s_rel[0];
    for (int w = 1; w < kWarps; ++w) {
      t[0] += s_int[w][0];
      t[1] += s_int[w][1];
      t[2] = max(t[2], s_int[w][2]);
      t[3] += s_int[w][3];
      t[4] += s_int[w][4];
      t[5] += s_int[w][5];
      rel += s_rel[w];
    }
    for (int c = 0; c < 6; ++c) int_row[c] = t[c];
    int_row[6] = 0;
    int_row[7] = 0;
    rel_row[0] = rel;
    for (int c = 1; c < kChan; ++c) rel_row[c] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
behav_stats_table_kernel(const int* __restrict__ small,
                         const int* __restrict__ exact,
                         const float* __restrict__ wgt, int* __restrict__ int_out,
                         float* __restrict__ rel_out, int rows, int d_total,
                         int n_bits, int a_tile) {
  extern __shared__ int planes[];  // (R, 4, B) of config d
  const int b_n = 1 << n_bits;
  const int n_ta = b_n / a_tile;
  const int d = blockIdx.x / n_ta;
  const int j = blockIdx.x - d * n_ta;

  const int plane_n = 4 * b_n;
  for (int i = threadIdx.x; i < rows * plane_n; i += kThreads) {
    const int r = i / plane_n;
    planes[i] = small[(static_cast<size_t>(r) * d_total + d) * plane_n +
                      (i - r * plane_n)];
  }
  __syncthreads();

  Acc acc = {0, 0, 0, 0, 0, 0, 0.0f};
  const int n_pairs = a_tile << n_bits;
  const int a_lo = j * a_tile;
  for (int idx = threadIdx.x; idx < n_pairs; idx += kThreads) {
    const int a = a_lo + (idx >> n_bits);
    const int b = idx & (b_n - 1);
    const int off = (a << n_bits) + b;
    accumulate(acc,
               rowplanes::approx_product(planes, rows, n_bits, a, b) - exact[off],
               wgt[off]);
  }
  const size_t row = (static_cast<size_t>(j) * d_total + d) * kChan;
  reduce_store(acc, int_out + row, rel_out + row);
}

__global__ void __launch_bounds__(kThreads)
behav_stats_entry_kernel(const int* __restrict__ masks, int* __restrict__ int_out,
                         float* __restrict__ rel_out, int rows, int d_total,
                         int n_bits, int a_tile) {
  extern __shared__ int planes[];  // (R, 4, B) synthesized for config d
  const int b_n = 1 << n_bits;
  const int half = b_n >> 1;
  const int n_ta = b_n / a_tile;
  const int d = blockIdx.x / n_ta;
  const int j = blockIdx.x - d * n_ta;

  rowplanes::synthesize(planes, masks + static_cast<size_t>(d) * rows, rows,
                        n_bits);
  __syncthreads();

  Acc acc = {0, 0, 0, 0, 0, 0, 0.0f};
  const int n_pairs = a_tile << n_bits;
  const int a_lo = j * a_tile;
  for (int idx = threadIdx.x; idx < n_pairs; idx += kThreads) {
    const int a = a_lo + (idx >> n_bits);
    const int b = idx & (b_n - 1);
    const int as = a >= half ? a - b_n : a;
    const int bs = b >= half ? b - b_n : b;
    const int ex = as * bs;
    const int aex = ex < 0 ? -ex : ex;
    const float w = __fdiv_rn(1.0f, static_cast<float>(max(aex, 1)));
    accumulate(acc, rowplanes::approx_product(planes, rows, n_bits, a, b) - ex, w);
  }
  const size_t row = (static_cast<size_t>(j) * d_total + d) * kChan;
  reduce_store(acc, int_out + row, rel_out + row);
}

}  // namespace

extern "C" int behav_stats_table_launch(const void* small, const void* exact,
                                        const void* wgt, void* int_out,
                                        void* rel_out, int rows, int d,
                                        int n_bits, int a_tile, void* stream) {
  const int n_ta = (1 << n_bits) / a_tile;
  const size_t smem = static_cast<size_t>(rows) * 4 * (1 << n_bits) * sizeof(int);
  behav_stats_table_kernel<<<d * n_ta, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(small), static_cast<const int*>(exact),
      static_cast<const float*>(wgt), static_cast<int*>(int_out),
      static_cast<float*>(rel_out), rows, d, n_bits, a_tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int behav_stats_entry_launch(const void* masks, void* int_out,
                                        void* rel_out, int rows, int d,
                                        int n_bits, int a_tile, void* stream) {
  const int n_ta = (1 << n_bits) / a_tile;
  const size_t smem = static_cast<size_t>(rows) * 4 * (1 << n_bits) * sizeof(int);
  behav_stats_entry_kernel<<<d * n_ta, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(masks), static_cast<int*>(int_out),
      static_cast<float*>(rel_out), rows, d, n_bits, a_tile);
  return static_cast<int>(cudaGetLastError());
}
