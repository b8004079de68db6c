// AxO matmul for Hopper (sm_90a): the paper's approximate multiplier in a
// linear layer, from integer operand codes.
//
//   out[m, n] = sum_k sv[a[m, k]] * sv[b[k, n]]
//             + sum_k sum_r f[a[m, k], r] * g[b[k, n], r]          (M, N) f32
//
// where a (M, K) and b (K, N) are n-bit operand codes (uint8), sv the signed
// value of each code and f, g the rank-R factors of the operator's error
// table E = T - a*b (E[a, b] ~ sum_r f[a, r] g[b, r]).  Launched through a
// plain C function and bound from Python with ctypes (kernels/axo_matmul.py).
//
// Replaces repro/kernels/axo_matmul_kernel.py axo_matmul_pallas, which takes
// the operand values and factors pre-gathered in f32, (R, M, K) and (R, K, N).
// On the H100 those pre-gathered weight factors do not fit: for the 2.53 G
// linear weights of granite-3-2b they are 91 GB at R=8.  So this kernel reads
// the weight codes (1 byte each) and gathers values and factors itself from
// the two (1+R, 2^n) tables [sv; f^T] and [sv; g^T], held in shared memory.
//
// Design: one block of 256 threads per (BM x 64) output tile, and per K-split
// when the tile grid alone is under two waves (decode, M <= 16).  The block
// walks K in steps of BK=8 codes.  Per step it expands its A codes (BM x BK)
// and B codes (BK x 64) through the tables into shared memory as f32 tiles of
// depth (1+R)*BK, zero past the edges of M, N and K (code 0 is not value 0
// for the factors, so the edge is written, not gathered), and then runs a
// plain register-tiled f32 product over that depth: each thread owns TM x 4
// outputs.  IEEE f32 FMAs throughout, no TF32: the reference's tolerance is
// 1e-5.  Split-K partials go to a (splits, M, N) workspace that a second
// kernel sums in split order, so results do not depend on scheduling.
//
// What bounds it on this card: 2*M*N*K*(1+R) f32 FLOPs on the non-tensor
// pipe (no tensor-core f32), against 1 byte per weight code read once.  At
// prefill (M = 512) that is operations by far; at decode (M = 4) the weight
// codes' bytes and the ops are within a few times of each other, and the
// M=16 tile pads 4 rows to 16, so the kernel spends 4x the needed FLOPs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid over the output tile
constexpr int kBK = 8;         // K codes per shared-memory step
constexpr int kBN = 64;        // output columns per block (16 threads x 4)
constexpr size_t kStaticSmem = 48 * 1024;

__host__ __device__ inline int table_stride(int n_codes) {
  return (n_codes + 3) & ~3;  // keep the staged tiles 16-byte aligned
}

template <int BM, int TM>
__global__ void __launch_bounds__(kThreads)
axo_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  const float* __restrict__ sv, const float* __restrict__ ft,
                  const float* __restrict__ gt, float* __restrict__ out, int m_total,
                  int n_total, int k_total, int rank, int n_codes, int k_split) {
  extern __shared__ __align__(16) float smem[];
  const int r1 = rank + 1;
  const int ts = table_stride(n_codes);
  float* ta = smem;               // (1+R, ts): row 0 = sv, row 1+r = f[:, r]
  float* tb = ta + r1 * ts;       // (1+R, ts): row 0 = sv, row 1+r = g[:, r]
  float* as = tb + r1 * ts;       // ((1+R)*BK, BM) expanded A tile
  float* bs = as + r1 * kBK * BM; // ((1+R)*BK, BN) expanded B tile
  const int tid = threadIdx.x;
  const int code_mask = n_codes - 1;

  for (int i = tid; i < r1 * n_codes; i += kThreads) {
    const int j = i / n_codes;
    const int c = i - j * n_codes;
    ta[j * ts + c] = j == 0 ? sv[c] : ft[c * rank + j - 1];
    tb[j * ts + c] = j == 0 ? sv[c] : gt[c * rank + j - 1];
  }

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_split;
  const int ke = min(k_total, kb + k_split);
  const int ty = tid / 16;
  const int tx = tid - ty * 16;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kb; k0 < ke; k0 += kBK) {
    __syncthreads();  // tables written; the previous step's tiles read
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int ml = i % BM;  // consecutive threads, consecutive rows: no conflicts
      const int kk = i / BM;
      const int m = m0 + ml;
      const int k = k0 + kk;
      const bool in = m < m_total && k < ke;
      const int c = in ? (a[static_cast<size_t>(m) * k_total + k] & code_mask) : 0;
      for (int j = 0; j < r1; ++j) as[(j * kBK + kk) * BM + ml] = in ? ta[j * ts + c] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int nl = i % kBN;  // consecutive threads read consecutive code bytes
      const int kk = i / kBN;
      const int n = n0 + nl;
      const int k = k0 + kk;
      const bool in = n < n_total && k < ke;
      const int c = in ? (b[static_cast<size_t>(k) * n_total + n] & code_mask) : 0;
      for (int j = 0; j < r1; ++j) bs[(j * kBK + kk) * kBN + nl] = in ? tb[j * ts + c] : 0.f;
    }
    __syncthreads();
    const int depth = r1 * kBK;
    for (int kp = 0; kp < depth; ++kp) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kp * BM + ty * TM + i];
      const float4 bv = *reinterpret_cast<const float4*>(bs + kp * kBN + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
      }
    }
  }

  float* dst = out + static_cast<size_t>(blockIdx.z) * m_total * n_total;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < n_total) dst[static_cast<size_t>(m) * n_total + n] = acc[i][j];
    }
  }
}

// out[i] = sum_z parts[z, i], in split order.
__global__ void split_sum_kernel(const float* __restrict__ parts, float* __restrict__ out,
                                 int splits, size_t mn) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += parts[z * mn + i];
    out[i] = s;
  }
}

template <int BM, int TM>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const float* sv, const float* ft,
                   const float* gt, float* dst, int m, int n, int k, int rank,
                   int n_codes, int splits, int k_split, size_t smem,
                   cudaStream_t stream) {
  if (smem > kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(axo_matmul_kernel<BM, TM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM, splits);
  axo_matmul_kernel<BM, TM><<<grid, kThreads, smem, stream>>>(
      a, b, sv, ft, gt, dst, m, n, k, rank, n_codes, k_split);
  return cudaGetLastError();
}

// The shared memory one block of the given tile height needs (kernels/
// axo_matmul.py plans with the same formula).
size_t smem_bytes(int bm, int rank, int n_codes) {
  const size_t r1 = static_cast<size_t>(rank) + 1;
  return (2 * r1 * table_stride(n_codes) + r1 * kBK * (bm + kBN)) * sizeof(float);
}

}  // namespace

// bm is 16 (decode-sized M) or 64.  With splits > 1, ws holds splits * m * n
// floats of partials and out receives their sum; with splits == 1 ws is unused.
extern "C" int axo_matmul_launch(const void* a, const void* b, const void* sv,
                                 const void* ft, const void* gt, void* out, void* ws,
                                 int m, int n, int k, int rank, int n_codes, int bm,
                                 int splits, int k_split, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  const size_t smem = smem_bytes(bm, rank, n_codes);
  const auto* ap = static_cast<const uint8_t*>(a);
  const auto* bp = static_cast<const uint8_t*>(b);
  const auto* svp = static_cast<const float*>(sv);
  const auto* fp = static_cast<const float*>(ft);
  const auto* gp = static_cast<const float*>(gt);
  cudaError_t err;
  if (bm == 16) {
    err = launch<16, 1>(ap, bp, svp, fp, gp, dst, m, n, k, rank, n_codes, splits, k_split,
                        smem, s);
  } else if (bm == 64) {
    err = launch<64, 4>(ap, bp, svp, fp, gp, dst, m, n, k, rank, n_codes, splits, k_split,
                        smem, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>(std::min<size_t>((mn + 255) / 256, 4096));
  split_sum_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                          static_cast<float*>(out), splits, mn);
  return static_cast<int>(cudaGetLastError());
}
