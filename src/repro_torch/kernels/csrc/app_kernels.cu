// Table-GEMV kernels of the application-BEHAV engine, for Hopper (sm_90a).
//
// Both compute a batched integer matmul in which every multiply is a lookup
// through one approximate-multiplier config:
//
//   out[d, m, n] = sum_k P_d(a[m, k], b[k, n])      (D, M, N) int32
//
// with config-shared operand codes a (M, K) and b (K, N).  Each is launched
// through a plain C function (bound from Python with ctypes, see
// kernels/app_kernels.py):
//
//   table_gemv  (K4) replaces repro/kernels/app_kernels.py table_gemv_pallas:
//               P_d(a, b) = T_d[a * B + b] from the (D, A*B) flattened
//               product tables.
//   entry_gemv  (K5) replaces entry_gemv_pallas: P_d is synthesized from the
//               (D, R) config masks -- the block builds its config's (R, 4, B)
//               planes in shared memory (planes.cuh, shared with K2) and sums
//               sum_r planes[r][pair_r(a)][b] << 2r.
//
// One block owns one (config d, M-tile) of the output, so no atomics are
// needed.  It stages the M-tile's A codes (pre-shifted by n_bits for K4) and
// the (K, N) B codes in shared memory, K in chunks of k_tile rows, and its
// threads stride over the tile's (m, n) outputs, consecutive threads on
// consecutive n (conflict-free B reads, coalesced stores).  A ragged K is
// handled by the chunk loop, a ragged M by the last tile's row count.  Codes
// are taken modulo 2^n_bits, so every lookup stays inside its table.
//
// int32 accumulation is exact: |P| < 2^16 at 8 bits and the wrapper checks
// K <= 2^14.
//
// What bounds them on the H100.  The TPU kernel keeps the whole table in
// VMEM; at 8 bits one table is 65,536 int32 = 256 KiB, more than the 227 KiB
// of shared memory a block may use.  So K4 gathers it through the read-only
// path (L1, then L2, which holds ~190 such tables): it is bound by gather
// throughput, with 2 int32 ALU operations per lookup beside it (the index add
// and the accumulate; the load issues on the load/store pipe).  K5 reads
// nothing but its codes and masks; it is bound by integer instruction
// throughput, ~R x 3 ALU operations per lookup (index add, shift, accumulate
// per row) plus the synthesis, which every M-tile block of a config repeats.

#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kStaticSmem = 48 * 1024;

// Stage A rows [m0, m0 + m_tile) x columns [k0, k0 + kc) (row stride kts,
// zero past M) and B rows [k0, k0 + kc).
__device__ __forceinline__ void stage(const int* __restrict__ a,
                                      const int* __restrict__ b, int* a_sh,
                                      int* b_sh, int m0, int m_tile, int m_total,
                                      int k_total, int n, int k0, int kc,
                                      int kts, int code_mask, int a_shift) {
  for (int i = threadIdx.x; i < m_tile * kc; i += blockDim.x) {
    const int ml = i / kc;
    const int kk = i - ml * kc;
    const int m = m0 + ml;
    a_sh[ml * kts + kk] =
        m < m_total
            ? (a[static_cast<size_t>(m) * k_total + k0 + kk] & code_mask) << a_shift
            : 0;
  }
  for (int i = threadIdx.x; i < kc * n; i += blockDim.x) {
    b_sh[i] = b[static_cast<size_t>(k0) * n + i] & code_mask;
  }
}

__global__ void __launch_bounds__(kThreads)
table_gemv_kernel(const int* __restrict__ tables, const int* __restrict__ a,
                  const int* __restrict__ b, int* __restrict__ out, int m_total,
                  int k_total, int n, int n_bits, int m_tile, int k_tile) {
  extern __shared__ int smem[];
  const int kts = k_tile + 1;  // odd row stride: rows of A fall in other banks
  int* a_sh = smem;
  int* b_sh = smem + m_tile * kts;
  const int n_mt = (m_total + m_tile - 1) / m_tile;
  const int d = blockIdx.x / n_mt;
  const int m0 = (blockIdx.x - d * n_mt) * m_tile;
  const int n_out = min(m_tile, m_total - m0) * n;
  const int* tab = tables + (static_cast<size_t>(d) << (2 * n_bits));
  int* out_d = out + (static_cast<size_t>(d) * m_total + m0) * n;

  for (int k0 = 0; k0 < k_total; k0 += k_tile) {
    const int kc = min(k_tile, k_total - k0);
    __syncthreads();  // the previous chunk is read before it is overwritten
    stage(a, b, a_sh, b_sh, m0, m_tile, m_total, k_total, n, k0, kc, kts,
          (1 << n_bits) - 1, n_bits);
    __syncthreads();
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      const int ml = o / n;
      const int nn = o - ml * n;
      const int* arow = a_sh + ml * kts;
      int acc = 0;
      for (int kk = 0; kk < kc; ++kk) {
        acc += __ldg(tab + arow[kk] + b_sh[kk * n + nn]);
      }
      out_d[o] = k0 == 0 ? acc : out_d[o] + acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
entry_gemv_kernel(const int* __restrict__ masks, const int* __restrict__ a,
                  const int* __restrict__ b, int* __restrict__ out, int rows,
                  int m_total, int k_total, int n, int n_bits, int m_tile,
                  int k_tile) {
  extern __shared__ int smem[];
  const int kts = k_tile + 1;
  int* planes = smem;  // (R, 4, B) of config d
  int* a_sh = planes + rows * 4 * (1 << n_bits);
  int* b_sh = a_sh + m_tile * kts;
  const int n_mt = (m_total + m_tile - 1) / m_tile;
  const int d = blockIdx.x / n_mt;
  const int m0 = (blockIdx.x - d * n_mt) * m_tile;
  const int n_out = min(m_tile, m_total - m0) * n;
  int* out_d = out + (static_cast<size_t>(d) * m_total + m0) * n;

  rowplanes::synthesize(planes, masks + static_cast<size_t>(d) * rows, rows,
                        n_bits);
  for (int k0 = 0; k0 < k_total; k0 += k_tile) {
    const int kc = min(k_tile, k_total - k0);
    __syncthreads();  // planes written; the previous chunk read
    stage(a, b, a_sh, b_sh, m0, m_tile, m_total, k_total, n, k0, kc, kts,
          (1 << n_bits) - 1, 0);
    __syncthreads();
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      const int ml = o / n;
      const int nn = o - ml * n;
      const int* arow = a_sh + ml * kts;
      int acc = 0;
      for (int kk = 0; kk < kc; ++kk) {
        acc += rowplanes::approx_product(planes, rows, n_bits, arow[kk],
                                         b_sh[kk * n + nn]);
      }
      out_d[o] = k0 == 0 ? acc : out_d[o] + acc;
    }
  }
}

size_t staging_bytes(int m_tile, int k_tile, int n) {
  return (static_cast<size_t>(m_tile) * (k_tile + 1) +
          static_cast<size_t>(k_tile) * n) * sizeof(int);
}

// Dynamic shared memory above the 48 KiB default needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int table_gemv_launch(const void* tables, const void* a,
                                 const void* b, void* out, int d, int m, int k,
                                 int n, int n_bits, int m_tile, int k_tile,
                                 void* stream) {
  const size_t smem = staging_bytes(m_tile, k_tile, n);
  cudaError_t err = allow_smem(table_gemv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_mt = (m + m_tile - 1) / m_tile;
  table_gemv_kernel<<<d * n_mt, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tables), static_cast<const int*>(a),
      static_cast<const int*>(b), static_cast<int*>(out), m, k, n, n_bits,
      m_tile, k_tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int entry_gemv_launch(const void* masks, const void* a,
                                 const void* b, void* out, int rows, int d,
                                 int m, int k, int n, int n_bits, int m_tile,
                                 int k_tile, void* stream) {
  const size_t smem =
      static_cast<size_t>(rows) * 4 * (1 << n_bits) * sizeof(int) +
      staging_bytes(m_tile, k_tile, n);
  cudaError_t err = allow_smem(entry_gemv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_mt = (m + m_tile - 1) / m_tile;
  entry_gemv_kernel<<<d * n_mt, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(masks), static_cast<const int*>(a),
      static_cast<const int*>(b), static_cast<int*>(out), rows, m, k, n, n_bits,
      m_tile, k_tile);
  return static_cast<int>(cudaGetLastError());
}
