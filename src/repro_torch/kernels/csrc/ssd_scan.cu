// Mamba-2 chunked SSD scan for Hopper (sm_90a): the prefill scan of the
// port's Mamba-2 mixer (models/ssm.py).  Per head h, with state (P, N),
//
//   state_t = exp(dt_t a_h) state_{t-1} + dt_t x_t B_t^T
//   y_t     = state_t C_t
//
// over x (B, S, H, P), dt (B, S, H) f32, a (H,) f32 and B, C (B, S, G, N);
// head h reads group h / (H / G).  The state starts from init (or zeros) and
// ends in fin (B, H, P, N) f32; y is rounded once to x's type.  Inputs are
// f32 or bf16, addressed by their (batch, position, head|group) strides with
// the last axis contiguous, so the model's views into its in_proj output are
// read in place.  Launched through plain C functions and bound from Python
// with ctypes (kernels/ssd_scan.py).
//
// Replaces repro/kernels/ssd_scan_kernel.py ssd_scan_pallas.  There the grid
// is (B, chunks) and all H heads' (H, P, N) state sits in VMEM scratch,
// carried from one chunk to the next by the TPU's in-order grid.  On this card
// that state is 768 KiB per batch row at mamba2-130m's width, and blocks run in
// no order.  Both designs here walk the sequence in chunks of kQ = 32
// positions with the decay's cumulative sum cs taken by one warp scan:
//
//   1. M[l, s] = (C_l . B_s) exp(cs_l - cs_s) dt_s for s <= l   (scores)
//   2. y_l = sum_s M[l, s] x_s + exp(cs_l) state C_l               (outputs)
//   3. state = exp(cs_last) state + sum_s B_s exp(cs_last - cs_s) dt_s x_s
//
// The chunked algebra is exact for any chunk length, so kQ need not be the
// model's 128; the results differ from the plain version's only by rounding.
// Positions at or past S are masked as dt = 0, x = 0, which leaves the state
// unchanged.
//
// bf16, the served model's type: two grids on the tensor cores.
//   * More parallelism than B * H blocks: the state's rows are independent
//     (row p of the state reads only column p of x), so the scan splits P
//     into slices of kPB = 32 rows, one sub-block of 4 warps each: 384
//     slices at mamba2-130m's prefill where the first design had 192 blocks.
//     A block holds kSub = 3 sub-blocks (slices of one batch row and group),
//     which share each chunk's B, C and scores in shared memory: a third of
//     the L2 reads of one block a slice (0.40 ms a call in chip_smoke.py on
//     an H100 80GB HBM3 at 700 W), and 128 blocks of 12 warps, one to an SM,
//     one wave.  The other
//     route, chunks in parallel with a state-passing pass between, writes and
//     reads every chunk's (P, N) f32 state: 100 MB per pass at the model's
//     128-position chunk, three such passes, against the scan's 114 MB of
//     operands; here the state never leaves the SM.
//   * C . B^T once per (batch, chunk, group): grid 1 computes each chunk's
//     scores with mma.sync into a (B, chunks, G, 32, 32) f32 scratch (2 MB at
//     mamba2-130m's prefill), which every head and row slice of the group
//     reads; the TPU kernel and the first design did it once per head.
//   * The three contractions run on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate): the scores C B^T; y = M x + exp(cs) C state^T; and the
//     state update (w x)^T B.  x, B and C in bf16 are exact operands.  Each
//     f32 operand (M, w x, the state) goes in as three bf16 terms, hi + mid +
//     lo, each rounding the rest of the one before: 2^-24 relative, f32's own
//     precision: y as close to the exact recurrence as the plain f32 scan
//     at the same chunk.  A hi + lo pair (2^-16) would put y over 10x
//     further from it and flip over 10x more of y's bf16 roundings (emulated
//     on the CPU, tests/test_torch_kernel_design.py), each of which the
//     24-layer model amplifies.  Three bf16 passes cost less than
//     the two TF32 passes that would reach the same (TF32 runs at half the
//     bf16 rate).  Each k step is one chain of the tensor core from a zeroed
//     accumulator, added to the running sum with IEEE rounding, since the
//     tensor core's accumulator does not round to nearest.
//   * Chunk loads (x, B, C, the scores and dt) are double-buffered with
//     cp.async: chunk c + 1 is in flight while chunk c is computed.  TMA and
//     wgmma are left for a later design.
// A chunk in a sub-block: after the block's barrier (chunk c has landed and
// chunk c - 1's buffer is free for chunk c + 1's loads), each warp scans the
// decay; the sub-block's 128 threads make M's and (w x)^T's three terms once
// into shared memory; a barrier of the sub-block; then warp w computes y rows
// 16 (w & 1) .. + 15 for the 8-wide column tiles (w >> 1) + 2 i, and the
// state update for the columns 8 j .. 8 j + 7, j = w + 4 jj, over all 32
// rows.  It keeps those state columns in registers in exact f32 and, after
// the sub-block's second barrier, publishes their three bf16 terms to shared
// memory, from which every warp of the sub-block reads the state for
// C . state^T.  x, B and C rows must be 16-byte aligned (strides multiples of
// 8 elements); the wrapper and this launcher refuse a bf16 call that is not.
//
// f32: the first design, kept, with its bf16 instances beside it so that the
// card's checks time it against the new one.  One block owns one (batch, head): it walks the chunks in order with
// that head's (P, N) state in shared memory (32 KiB f32 at P=64, N=128), all
// math f32 FMAs from shared memory, 4-8 per shared-memory load, the scores
// computed again for each head of a group, B * H = 192 blocks on 132 SMs.
//
// What bounds the bf16 design on this card, at mamba2-130m's prefill (B=8,
// S=2,000, H=24, G=1, P=64, N=128): ~114 MB of operands, 0.034 ms at 3.35
// TB/s, so bytes.  A hi + lo pair per f32 operand would hold K8's contracts
// (tests/test_torch_kernel_design.py), so the least tensor-core work is two
// passes, ~27 GFLOP, 0.027 ms at 989 TFLOP/s; this design's three terms,
// kept to stay as close to the exact recurrence as the f32 scan, are ~40
// GFLOP, 0.041 ms.  The same algebra on the f32 pipe (13.5 GFLOP at 66.9
// TFLOP/s) would take 0.20 ms.  The kernel takes about nine times its bytes
// bound and eight times its three-pass work (PERF.md), and no one
// part holds it back: the loads, making M's and (w x)^T's terms, the two
// products of y, the update and publishing the state each take a share.
// Each chunk is a serial chain of loads, a warp scan, exponentials,
// three-term splits and MMAs behind three barriers, with 12 warps an SM
// (registers allow no more), so its latency per chunk, not the MMA rate, is
// what a later design should attack (wgmma on a larger tile of heads, or the
// state kept as the A operand in registers so that it is never published).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;  // positions per chunk: one warp scans the chunk's decay
constexpr int kScalarThreads = 256;

long long g_grids = 0;  // grids launched since the library was loaded (ssd_scan_grids)

cudaError_t count_grid(cudaError_t err) {  // a launch's error; counts it if it launched
  if (err == cudaSuccess) ++g_grids;
  return err;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of a (batch, position, head|group) view
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// f32 pipe: the first design
// ---------------------------------------------------------------------------

// Rows of B, C and the state are N + 4 floats apart: 16-byte aligned for
// float4 loads, and (for N a multiple of 32) 4 banks apart, so eight lanes
// reading eight rows hit distinct banks.
template <int P, int N>
constexpr int smem_floats() {
  return 2 * kQ * (N + 4)    // C, B
         + kQ * P            // x
         + kQ * (kQ + 4)     // M
         + P * (N + 4)       // state
         + 3 * kQ + 4;       // cs, dt, w, the chunk decay
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kScalarThreads, 2)  // two blocks per SM: <= 128 registers
ssd_scan_scalar_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ fin, Strides xs, Strides dts,
                Strides bs, Strides cs_, int seq, int n_heads, int rep) {
  constexpr int NS = N + 4;
  constexpr int MS = kQ + 4;
  // thread roles: scores rows l = warp + 8 i (i < 4), column s = lane;
  // outputs column p = tid % P, rows l = tid / P + YL i (i < YR);
  // state columns n = 4 (tid % N4) .. + 3, rows p = (tid / N4) UR + i (i < UR)
  constexpr int YL = kScalarThreads / P;
  constexpr int YR = kQ / YL;
  constexpr int N4 = N / 4;
  constexpr int UR = (P * N4 + kScalarThreads - 1) / kScalarThreads;
  constexpr int UT = P / UR * N4;
  static_assert(kScalarThreads % P == 0 && kQ % YL == 0 && P % UR == 0 && UT <= kScalarThreads,
                "unsupported P, N");

  extern __shared__ __align__(16) float smem[];
  float* c_sh = smem;
  float* b_sh = c_sh + kQ * NS;
  float* x_sh = b_sh + kQ * NS;
  float* m_sh = x_sh + kQ * P;
  float* st_sh = m_sh + kQ * MS;
  float* cs_sh = st_sh + P * NS;
  float* dt_sh = cs_sh + kQ;
  float* w_sh = dt_sh + kQ;
  float* dec_sh = w_sh + kQ;

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int gi = hi / rep;
  const float ah = a[hi];
  const T* xp = x + bi * xs.b + hi * xs.h;
  const float* dtp = dt + bi * dts.b + hi * dts.h;
  const T* bp = bm + bi * bs.b + gi * bs.h;
  const T* cp = cm + bi * cs_.b + gi * cs_.h;
  const long long ys = static_cast<long long>(n_heads) * P;  // y is dense (B, S, H, P)
  T* yp = y + (static_cast<long long>(bi) * seq * n_heads + hi) * P;
  const long long state0 = (static_cast<long long>(bi) * n_heads + hi) * P * N;

  for (int i = tid; i < P * N; i += kScalarThreads) {
    const int p = i / N;
    st_sh[p * NS + i - p * N] = init != nullptr ? init[state0 + i] : 0.f;
  }

  const int n_chunks = (seq + kQ - 1) / kQ;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kQ;
    const int valid = min(kQ, seq - t0);
    __syncthreads();  // the previous chunk is read before it is overwritten
    for (int i = tid; i < kQ * N; i += kScalarThreads) {
      const int s = i / N;
      const int n = i - s * N;
      const long long t = t0 + s;
      b_sh[s * NS + n] = s < valid ? to_f32(bp[t * bs.s + n]) : 0.f;
      c_sh[s * NS + n] = s < valid ? to_f32(cp[t * cs_.s + n]) : 0.f;
    }
    for (int i = tid; i < kQ * P; i += kScalarThreads) {
      const int s = i / P;
      const long long t = t0 + s;
      x_sh[i] = s < valid ? to_f32(xp[t * xs.s + i - s * P]) : 0.f;
    }
    if (tid < 32) {  // warp 0: inclusive scan of dt * a over the chunk
      const float d = tid < valid ? dtp[static_cast<long long>(t0 + tid) * dts.s] : 0.f;
      float v = d * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      const float last = __shfl_sync(0xffffffffu, v, 31);
      dt_sh[tid] = d;
      cs_sh[tid] = v;
      w_sh[tid] = expf(last - v) * d;
      if (tid == 0) dec_sh[0] = expf(last);
    }
    __syncthreads();

    {  // 1. M = (C B^T o L) dt, zero above the diagonal
      const int s = tid & 31;
      const int l0 = tid >> 5;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(b_sh + s * NS + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(c_sh + (l0 + 8 * i) * NS + n);
          acc[i] = fmaf(cv.x, bv.x, acc[i]);
          acc[i] = fmaf(cv.y, bv.y, acc[i]);
          acc[i] = fmaf(cv.z, bv.z, acc[i]);
          acc[i] = fmaf(cv.w, bv.w, acc[i]);
        }
      }
      const float cs_s = cs_sh[s];
      const float dt_s = dt_sh[s];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + 8 * i;
        m_sh[l * MS + s] = s <= l ? acc[i] * expf(cs_sh[l] - cs_s) * dt_s : 0.f;
      }
    }
    __syncthreads();

    {  // 2. y = M x + exp(cs) C state^T
      const int p = tid % P;
      const int lr = tid / P;
      float dg[YR];
      float of[YR];
#pragma unroll
      for (int i = 0; i < YR; ++i) dg[i] = of[i] = 0.f;
#pragma unroll 2
      for (int s = 0; s < kQ; s += 4) {
        const float x0 = x_sh[s * P + p];
        const float x1 = x_sh[(s + 1) * P + p];
        const float x2 = x_sh[(s + 2) * P + p];
        const float x3 = x_sh[(s + 3) * P + p];
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const float4 mv = *reinterpret_cast<const float4*>(m_sh + (lr + YL * i) * MS + s);
          dg[i] = fmaf(mv.x, x0, dg[i]);
          dg[i] = fmaf(mv.y, x1, dg[i]);
          dg[i] = fmaf(mv.z, x2, dg[i]);
          dg[i] = fmaf(mv.w, x3, dg[i]);
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        const float4 sv = *reinterpret_cast<const float4*>(st_sh + p * NS + n);
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(c_sh + (lr + YL * i) * NS + n);
          of[i] = fmaf(cv.x, sv.x, of[i]);
          of[i] = fmaf(cv.y, sv.y, of[i]);
          of[i] = fmaf(cv.z, sv.z, of[i]);
          of[i] = fmaf(cv.w, sv.w, of[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        const int l = lr + YL * i;
        if (l < valid) {
          yp[static_cast<long long>(t0 + l) * ys + p] = from_f32<T>(dg[i] + of[i] * expf(cs_sh[l]));
        }
      }
    }
    __syncthreads();

    if (tid < UT) {  // 3. state = exp(cs_last) state + (w x)^T B
      const int n = 4 * (tid % N4);
      const int p0 = (tid / N4) * UR;
      const float dec = dec_sh[0];
      float4 acc[UR];
#pragma unroll
      for (int i = 0; i < UR; ++i) {
        acc[i] = *reinterpret_cast<const float4*>(st_sh + (p0 + i) * NS + n);
        acc[i].x *= dec;
        acc[i].y *= dec;
        acc[i].z *= dec;
        acc[i].w *= dec;
      }
#pragma unroll 4
      for (int s = 0; s < kQ; ++s) {  // masked positions carry w = 0 and x = 0
        const float4 bv = *reinterpret_cast<const float4*>(b_sh + s * NS + n);
        const float w = w_sh[s];
#pragma unroll
        for (int i = 0; i < UR; ++i) {
          const float xw = x_sh[s * P + p0 + i] * w;
          acc[i].x = fmaf(xw, bv.x, acc[i].x);
          acc[i].y = fmaf(xw, bv.y, acc[i].y);
          acc[i].z = fmaf(xw, bv.z, acc[i].z);
          acc[i].w = fmaf(xw, bv.w, acc[i].w);
        }
      }
#pragma unroll
      for (int i = 0; i < UR; ++i) {
        *reinterpret_cast<float4*>(st_sh + (p0 + i) * NS + n) = acc[i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kScalarThreads) {
    const int p = i / N;
    fin[state0 + i] = st_sh[p * NS + i - p * N];
  }
}

template <typename T, int P, int N>
cudaError_t launch_scalar(const void* x, const float* dt, const float* a, const void* bm,
                   const void* cm, const float* init, void* y, float* fin, Strides xs,
                   Strides dts, Strides bs, Strides cs, int b, int seq, int h, int g,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<P, N>() * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {  // above 48 KB a block's shared memory must be opted into
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_scalar_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(h, b);
  ssd_scan_scalar_kernel<T, P, N><<<grid, kScalarThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      init, static_cast<T*>(y), fin, xs, dts, bs, cs, seq, h, h / g);
  return count_grid(cudaGetLastError());
}

template <typename T, int P>
cudaError_t launch_scalar_n(int n, const void* x, const float* dt, const float* a, const void* bm,
                     const void* cm, const float* init, void* y, float* fin, Strides xs,
                     Strides dts, Strides bs, Strides cs, int b, int seq, int h, int g,
                     cudaStream_t stream) {
#define SSD_N(NN)                                                                       \
  case NN:                                                                              \
    return launch_scalar<T, P, NN>(x, dt, a, bm, cm, init, y, fin, xs, dts, bs, cs, b, seq, h, \
                            g, stream);
  switch (n) {
    SSD_N(8)
    SSD_N(16)
    SSD_N(32)
    SSD_N(64)
    SSD_N(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSD_N
}

template <typename T>
cudaError_t launch_scalar_pn(int p, int n, const void* x, const float* dt, const float* a,
                      const void* bm, const void* cm, const float* init, void* y, float* fin,
                      Strides xs, Strides dts, Strides bs, Strides cs, int b, int seq, int h,
                      int g, cudaStream_t stream) {
#define SSD_P(PP)                                                                          \
  case PP:                                                                                 \
    return launch_scalar_n<T, PP>(n, x, dt, a, bm, cm, init, y, fin, xs, dts, bs, cs, b, seq, h, \
                           g, stream);
  switch (p) {
    SSD_P(8)
    SSD_P(16)
    SSD_P(32)
    SSD_P(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSD_P
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;             // warps of a scores block and of a scan sub-block
constexpr int kSub = 3;               // scan sub-blocks a block, sharing B, C, the scores
constexpr int kPB = 32;               // state rows p a sub-block (P = 64: two)
constexpr int kScoreStride = kQ + 8;  // floats per scores row in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// d = a . b (mma_bf16) or d += a . b (mma_bf16_acc) for one 16x8 tile over
// 16 of k, bf16 in, f32 accumulate.  Not volatile: registers in and out
// only, so the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16_acc(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (v0, v1) -> three bf16x2 terms, hi + mid + lo = v to 2^-24 relative: each
// remainder is exact in f32, and each term rounds the one before's rest
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  v0 -= __low2float(h);
  v1 -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(v0, v1);
  v0 -= __low2float(m);
  v1 -= __high2float(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(v0, v1));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int d, bool in) {
  return in ? *reinterpret_cast<const uint32_t*>(row + d) : 0u;
}

// One k step of a product with an f32 operand given as three bf16 terms: one
// chain of the tensor core from a zeroed accumulator, the terms smallest
// first, then added to the running sum with IEEE rounding.  The chain's last
// product rounds once, as a lone product would (the tensor core's
// accumulator does not round to nearest), and the small terms' roundings are
// 2^-8 and 2^-16 smaller; a chain over all of k would add one such rounding
// per step.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&hi)[4],
                                         const uint32_t (&mid)[4], const uint32_t (&lo)[4],
                                         uint32_t b0, uint32_t b1) {
  float t[4];
  mma_bf16(t, lo, b0, b1);
  mma_bf16_acc(t, mid, b0, b1);
  mma_bf16_acc(t, hi, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// the f32 operand on the B side: A bf16, B = b[0] + b[1] + b[2] (hi, mid, lo)
__device__ __forceinline__ void mma3b_add(float (&acc)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[3][2]) {
  float t[4];
  mma_bf16(t, a, b[2][0], b[2][1]);
  mma_bf16_acc(t, a, b[1][0], b[1][1]);
  mma_bf16_acc(t, a, b[0][0], b[0][1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// Grid 1: the scores S = C B^T of every (batch, chunk, group), once for all
// the group's heads, into scratch (B, chunks, G, kQ, kQ) f32.  One block of 4
// warps per chunk: warp w computes rows 16 (w & 1) .. + 15 and columns
// 16 (w >> 1) .. + 15; the block above the diagonal (warp 2) is never read.
// A (C rows) and B (B rows) fragments come straight from device memory, 4
// bytes a lane; positions past seq and state columns past N read as 0.
template <int N>
__global__ void __launch_bounds__(kWarps * 32)
ssd_scores_kernel(const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
                  float* __restrict__ scores, Strides bs, Strides cs, int seq, int n_chunks,
                  int groups) {
  const int c = blockIdx.x;
  const int gi = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mt = warp & 1;
  const int st = warp >> 1;
  if (st > mt) return;   // columns 16..31 of rows 0..15: above the diagonal
  const int t0 = c * kQ;
  const int l0 = 16 * mt + g;
  const __nv_bfloat16* cb = cm + bi * cs.b + gi * cs.h;
  const __nv_bfloat16* bb = bm + bi * bs.b + gi * bs.h;
  const bool in_lo = t0 + l0 < seq;
  const bool in_hi = t0 + l0 + 8 < seq;
  const __nv_bfloat16* c_lo = cb + static_cast<long long>(in_lo ? t0 + l0 : 0) * cs.s;
  const __nv_bfloat16* c_hi = cb + static_cast<long long>(in_hi ? t0 + l0 + 8 : 0) * cs.s;
  float acc[2][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
    const bool k_hi = k0 + 8 < N;   // N = 8: the upper half of the k step is padding
    uint32_t a[4];
    a[0] = load_pair(c_lo, k0 + 2 * t, in_lo);
    a[1] = load_pair(c_hi, k0 + 2 * t, in_hi);
    a[2] = load_pair(c_lo, k0 + 8 + 2 * t, in_lo && k_hi);
    a[3] = load_pair(c_hi, k0 + 8 + 2 * t, in_hi && k_hi);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = 16 * st + 8 * j + g;
      const bool in_s = t0 + s < seq;
      const __nv_bfloat16* brow = bb + static_cast<long long>(in_s ? t0 + s : 0) * bs.s;
      float tmp[4];
      mma_bf16(tmp, a, load_pair(brow, k0 + 2 * t, in_s),
               load_pair(brow, k0 + 8 + 2 * t, in_s && k_hi));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += tmp[e];
    }
  }
  float* out = scores + ((static_cast<long long>(bi) * n_chunks + c) * groups + gi) * kQ * kQ;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = 16 * st + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(out + l0 * kQ + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (l0 + 8) * kQ + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// Shared memory of the scan grid, in bf16 elements per row: x rows hold a
// sub-block's PB columns, B, C and state rows N (at least 16: a k step), the
// three-term M and (w x)^T rows a chunk's 32 positions; each padded by 16
// bytes, so that the 8 rows an ldmatrix reads fall in distinct banks.
template <int PB>
__host__ __device__ constexpr int x_stride() { return PB + 8; }
template <int N>
__host__ __device__ constexpr int n_stride() { return (N < 16 ? 16 : N) + 8; }
constexpr int kTermStride = kQ + 8;
template <int PB>
__host__ __device__ constexpr int wx_rows() { return PB < 16 ? 16 : PB; }   // a 16-row A tile

template <int PB, int N>
__host__ __device__ constexpr int chunk_bytes() {
  // one buffer: B, C (bf16) and the scores (f32), shared by the block; each
  // sub-block's x (bf16) and dt (f32)
  return 2 * kQ * n_stride<N>() * 2 + kQ * kScoreStride * 4 +
         kSub * (kQ * x_stride<PB>() * 2 + kQ * 4);
}

template <int PB, int N>
__host__ __device__ constexpr int sub_bytes() {
  // per sub-block: the state's, M's and (w x)^T's three bf16 terms
  return 3 * (PB * n_stride<N>() + kQ * kTermStride + wx_rows<PB>() * kTermStride) * 2;
}

template <int PB, int N>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 2 * chunk_bytes<PB, N>() + kSub * sub_bytes<PB, N>();
}

// Grid 2: the scan.  A block of kSub sub-blocks of 4 warps; sub-block j owns
// PB state rows of one head (slice blockIdx.x * kSub + j of its group's
// heads x row blocks) and walks the chunks in order; the sub-blocks share
// each chunk's B, C and scores.  See the header for the algebra and the
// roles.
template <int PB, int N>
__global__ void __launch_bounds__(kSub * kWarps * 32, 1)
ssd_scan_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
                    const __nv_bfloat16* __restrict__ cm, const float* __restrict__ scores,
                    const float* __restrict__ init, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ fin, Strides xs, Strides dts, Strides bs, Strides cs_,
                    int seq, int n_heads, int p_total, int rep, int groups, int n_chunks) {
  constexpr int XS = x_stride<PB>();
  constexpr int NS = n_stride<N>();
  constexpr int TS = kTermStride;
  constexpr int KN = (N + 15) / 16;          // k steps over the state columns
  constexpr int NT = N / 8;                  // 8-wide column tiles of the state
  constexpr int NTW = (NT + kWarps - 1) / kWarps;   // per warp: tiles wl + 4 jj
  constexpr int PT = PB / 8;                 // 8-wide column tiles of y
  constexpr int PTW = (PT + 1) / 2;          // per warp: tiles (wl >> 1) + 2 i
  constexpr int MU = PB >= 16 ? PB / 16 : 1; // 16-row tiles of the state
  constexpr bool kFullRows = PB >= 16;       // PB = 8 fills half of a 16-row tile
  constexpr int kSubThreads = kWarps * 32;
  static_assert(PB == 8 || PB == 16 || PB == 32, "unsupported PB");
  static_assert(N % 8 == 0 && N <= 128, "unsupported N");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sub = warp / kWarps;             // this warp's sub-block
  const int wl = warp % kWarps;              // and its place in it
  const int ts = tid % kSubThreads;
  const int gi = blockIdx.y;
  const int bi = blockIdx.z;
  const int row_blocks = p_total / PB;
  const int slice = blockIdx.x * kSub + sub;
  const bool active = slice < rep * row_blocks;
  const int hi = gi * rep + (active ? slice / row_blocks : 0);
  const int p0 = active ? (slice % row_blocks) * PB : 0;
  const float ah = a[hi];

  auto b_sh = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + buf * chunk_bytes<PB, N>());
  };
  auto c_sh = [&](int buf) { return b_sh(buf) + kQ * NS; };
  auto s_sh = [&](int buf) { return reinterpret_cast<float*>(c_sh(buf) + kQ * NS); };
  auto x_sh = [&](int buf, int j) {
    return reinterpret_cast<__nv_bfloat16*>(s_sh(buf) + kQ * kScoreStride) + j * kQ * XS;
  };
  auto d_sh = [&](int buf, int j) {
    return reinterpret_cast<float*>(x_sh(buf, kSub)) + j * kQ;
  };
  __nv_bfloat16* own = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + 2 * chunk_bytes<PB, N>() + sub * sub_bytes<PB, N>());
  __nv_bfloat16* st_sh = own;                          // [3][PB][NS]
  __nv_bfloat16* m_sh = st_sh + 3 * PB * NS;           // [3][kQ][TS]
  __nv_bfloat16* wx_sh = m_sh + 3 * kQ * TS;           // [3][wx_rows][TS]

  // zero everything once: padding columns and rows are never written again
  for (int i = tid; i < mma_smem_bytes<PB, N>() / 16; i += kSub * kSubThreads) {
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const __nv_bfloat16* bb = bm + bi * bs.b + gi * bs.h;
  const __nv_bfloat16* cb = cm + bi * cs_.b + gi * cs_.h;
  const float* sb = scores + (static_cast<long long>(bi) * n_chunks * groups + gi) * kQ * kQ;
  auto load_chunk = [&](int c, int buf) {
    const int t0 = c * kQ;
    for (int i = tid; i < kQ * (N / 8); i += kSub * kSubThreads) {
      const int r = i / (N / 8);
      const int piece = i - r * (N / 8);
      const bool in = t0 + r < seq;
      const long long pos = in ? t0 + r : 0;
      cp_async16(b_sh(buf) + r * NS + 8 * piece, bb + pos * bs.s + 8 * piece, in ? 16 : 0);
      cp_async16(c_sh(buf) + r * NS + 8 * piece, cb + pos * cs_.s + 8 * piece, in ? 16 : 0);
    }
    const float* sc = sb + static_cast<long long>(c) * groups * kQ * kQ;
    for (int i = tid; i < kQ * (kQ / 4); i += kSub * kSubThreads) {
      const int r = i / (kQ / 4);
      const int piece = i - r * (kQ / 4);
      cp_async16(s_sh(buf) + r * kScoreStride + 4 * piece, sc + r * kQ + 4 * piece, 16);
    }
    if (active) {   // this sub-block's x rows and dt
      const __nv_bfloat16* xb = x + bi * xs.b + hi * xs.h + p0;
      for (int i = ts; i < kQ * (PB / 8); i += kSubThreads) {
        const int r = i / (PB / 8);
        const int piece = i - r * (PB / 8);
        const bool in = t0 + r < seq;
        cp_async16(x_sh(buf, sub) + r * XS + 8 * piece,
                   xb + static_cast<long long>(in ? t0 + r : 0) * xs.s + 8 * piece,
                   in ? 16 : 0);
      }
      if (ts < kQ) {
        const bool in = t0 + ts < seq;
        cp_async4(d_sh(buf, sub) + ts,
                  dt + bi * dts.b + hi * dts.h + static_cast<long long>(in ? t0 + ts : 0) * dts.s,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  if (n_chunks > 0) load_chunk(0, 0);   // in flight while the state is set up

  // the state, exact f32, in registers in the accumulator layout: warp wl of
  // the sub-block owns columns 8 j .. 8 j + 7 for j = wl + 4 jj, all PB rows;
  // element e of st[mu][jj] is row 16 mu + g + 8 (e >> 1), column
  // 8 j + 2 t + (e & 1)
  float st[MU][NTW][4];
  const long long state0 = (static_cast<long long>(bi) * n_heads + hi) * p_total * N;
#pragma unroll
  for (int mu = 0; mu < MU; ++mu) {
#pragma unroll
    for (int jj = 0; jj < NTW; ++jj) {
      const int j = wl + kWarps * jj;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mu + g + 8 * (e >> 1);
        const bool in = active && j < NT && (kFullRows || row < PB) && init != nullptr;
        st[mu][jj][e] =
            in ? init[state0 + static_cast<long long>(p0 + row) * N + 8 * j + 2 * t + (e & 1)]
               : 0.f;
      }
    }
  }
  // the state's three bf16 terms, [term][row][column], for C . state^T
  auto publish_state = [&]() {
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) {
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj) {
        const int j = wl + kWarps * jj;
        if (j >= NT) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * mu + g + 8 * half;
          if (!kFullRows && half == 1) continue;
          uint32_t h, m, l;
          split3(st[mu][jj][2 * half], st[mu][jj][2 * half + 1], h, m, l);
          const int off = row * NS + 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(st_sh + off) = h;
          *reinterpret_cast<uint32_t*>(st_sh + PB * NS + off) = m;
          *reinterpret_cast<uint32_t*>(st_sh + 2 * PB * NS + off) = l;
        }
      }
    }
  };
  publish_state();

  const int ym = wl & 1;            // y: rows 16 ym .. + 15 of the chunk
  const int l0 = 16 * ym + g;       // and this lane's two rows l0, l0 + 8
  const long long ys = static_cast<long long>(n_heads) * p_total;   // y is dense (B, S, H, P)
  __nv_bfloat16* yb = y + (static_cast<long long>(bi) * seq * n_heads + hi) * p_total + p0;

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait<0>();
    // chunk c and the state entering it are in shared memory, and every
    // sub-block is done with chunk c - 1's buffer, which chunk c + 1 takes
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1, buf ^ 1);
    if (active) {
      const __nv_bfloat16* xc = x_sh(buf, sub);
      const __nv_bfloat16* bc = b_sh(buf);
      const __nv_bfloat16* cc = c_sh(buf);
      const float* sc = s_sh(buf);

      // the chunk's decay, per warp: lane s holds cs_s = sum_{r <= s} dt_r a,
      // w_s = exp(cs_last - cs_s) dt_s; masked positions have dt 0
      const float d = d_sh(buf, sub)[lane];
      float cs = d * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, cs, off);
        if (lane >= off) cs += u;
      }
      const float cs_last = __shfl_sync(0xffffffffu, cs, 31);
      const float w_lane = expf(cs_last - cs) * d;
      const float decay = expf(cs_last);

      // the sub-block's three-term operands, each value made once:
      // M[l, s] = S[l, s] exp(cs_l - cs_s) dt_s on the three 16 x 16 tiles
      // on and below the diagonal, pairs (l, s), (l, s + 1) a lane
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int q = ts + kSubThreads * k;              // pair q of 3 * 128
        const int tile = q >> 7;                         // (0, 0), (1, 0), (1, 1)
        const int l = 16 * (tile > 0) + ((q >> 3) & 15);
        const int s = 16 * (tile > 1) + 2 * (q & 7);
        const float cs_l = __shfl_sync(0xffffffffu, cs, l);
        const float cs_s0 = __shfl_sync(0xffffffffu, cs, s);
        const float cs_s1 = __shfl_sync(0xffffffffu, cs, s + 1);
        const float d0 = __shfl_sync(0xffffffffu, d, s);
        const float d1 = __shfl_sync(0xffffffffu, d, s + 1);
        const float2 sv = *reinterpret_cast<const float2*>(sc + l * kScoreStride + s);
        const float m0 = s <= l ? sv.x * expf(cs_l - cs_s0) * d0 : 0.f;
        const float m1 = s + 1 <= l ? sv.y * expf(cs_l - cs_s1) * d1 : 0.f;
        uint32_t h, m, lo;
        split3(m0, m1, h, m, lo);
        *reinterpret_cast<uint32_t*>(m_sh + l * TS + s) = h;
        *reinterpret_cast<uint32_t*>(m_sh + kQ * TS + l * TS + s) = m;
        *reinterpret_cast<uint32_t*>(m_sh + 2 * kQ * TS + l * TS + s) = lo;
      }
      // (w x)^T[p, s] = w_s x_s[p], pairs (p, s), (p, s + 1) a lane
      static_assert(PB * kQ / 2 % kSubThreads == 0, "whole rounds of pairs");
#pragma unroll
      for (int k = 0; k < PB * kQ / 2 / kSubThreads; ++k) {
        const int q = ts + kSubThreads * k;
        const int p = q % PB;
        const int s = 2 * (q / PB);
        const float w0 = __shfl_sync(0xffffffffu, w_lane, s);
        const float w1 = __shfl_sync(0xffffffffu, w_lane, s + 1);
        uint32_t h, m, lo;
        split3(__bfloat162float(xc[s * XS + p]) * w0,
               __bfloat162float(xc[(s + 1) * XS + p]) * w1, h, m, lo);
        *reinterpret_cast<uint32_t*>(wx_sh + p * TS + s) = h;
        *reinterpret_cast<uint32_t*>(wx_sh + wx_rows<PB>() * TS + p * TS + s) = m;
        *reinterpret_cast<uint32_t*>(wx_sh + 2 * wx_rows<PB>() * TS + p * TS + s) = lo;
      }
      // the sub-block's operands are complete (a barrier of its 128 threads)
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + sub), "r"(kSubThreads));

      // y rows l0, l0 + 8, columns of tiles (wl >> 1) + 2 i:
      //   diag = M . x over the chunk;  off = C . state_in^T over N
      float acc_d[PTW][4] = {};
      float acc_o[PTW][4] = {};
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, cc + (16 * ym + (lane & 15)) * NS + 16 * kk + 8 * (lane >> 4));
        uint32_t bf[PTW][3][2];
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const __nv_bfloat16* base = st_sh + term * PB * NS + 16 * kk;
          if constexpr (PTW == 2) {   // tiles (wl >> 1) and (wl >> 1) + 2 in one load
            uint32_t r[4];
            ldmatrix_x4(r, base + (8 * ((wl >> 1) + 2 * (lane >> 4)) + (lane & 7)) * NS +
                               8 * ((lane >> 3) & 1));
            bf[0][term][0] = r[0];
            bf[0][term][1] = r[1];
            bf[1][term][0] = r[2];
            bf[1][term][1] = r[3];
          } else {
            const int jy = wl >> 1;
            const int row = jy < PT ? 8 * jy + (lane & 7) : 0;
            ldmatrix_x2(bf[0][term][0], bf[0][term][1], base + row * NS + 8 * ((lane >> 3) & 1));
          }
        }
#pragma unroll
        for (int i = 0; i < PTW; ++i) {
          if ((wl >> 1) + 2 * i >= PT) continue;
          mma3b_add(acc_o[i], af, bf[i]);
        }
      }
      // both s blocks for every warp: M's block above the diagonal (rows
      // 0-15, columns 16-31) is never written and stays zero, and the warps
      // of the lower rows take both blocks anyway
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t mf[3][4];
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          ldmatrix_x4(mf[term], m_sh + term * kQ * TS + (16 * ym + (lane & 15)) * TS + 16 * kk +
                                    8 * (lane >> 4));
        }
#pragma unroll
        for (int i = 0; i < PTW; ++i) {
          const int jy = (wl >> 1) + 2 * i;
          if (jy >= PT) continue;
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, xc + (16 * kk + (lane & 15)) * XS + 8 * jy);
          mma3_add(acc_d[i], mf[0], mf[1], mf[2], b0, b1);
        }
      }
      {
        const int t0 = c * kQ;
        const float e0 = expf(__shfl_sync(0xffffffffu, cs, l0));
        const float e1 = expf(__shfl_sync(0xffffffffu, cs, l0 + 8));
#pragma unroll
        for (int i = 0; i < PTW; ++i) {
          const int jy = (wl >> 1) + 2 * i;
          if (jy >= PT) continue;
          const int col = 8 * jy + 2 * t;
          if (t0 + l0 < seq) {
            *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + l0) * ys + col) =
                __floats2bfloat162_rn(acc_d[i][0] + acc_o[i][0] * e0,
                                      acc_d[i][1] + acc_o[i][1] * e0);
          }
          if (t0 + l0 + 8 < seq) {
            *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + l0 + 8) * ys + col) =
                __floats2bfloat162_rn(acc_d[i][2] + acc_o[i][2] * e1,
                                      acc_d[i][3] + acc_o[i][3] * e1);
          }
        }
      }

      // the chunk's update (w x)^T B: rows p (16-row tiles mu), columns of
      // tiles wl + 4 jj, over the chunk's positions in two k steps
      float upd[MU][NTW][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t wf[MU][3][4];
#pragma unroll
        for (int mu = 0; mu < MU; ++mu) {
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            ldmatrix_x4(wf[mu][term], wx_sh + term * wx_rows<PB>() * TS +
                                          (16 * mu + (lane & 15)) * TS + 16 * kk +
                                          8 * (lane >> 4));
          }
        }
#pragma unroll
        for (int jj = 0; jj < NTW; ++jj) {
          const int j = wl + kWarps * jj;
          if (j >= NT) continue;
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, bc + (16 * kk + (lane & 15)) * NS + 8 * j);
#pragma unroll
          for (int mu = 0; mu < MU; ++mu) {
            mma3_add(upd[mu][jj], wf[mu][0], wf[mu][1], wf[mu][2], b0, b1);
          }
        }
      }
#pragma unroll
      for (int mu = 0; mu < MU; ++mu) {
#pragma unroll
        for (int jj = 0; jj < NTW; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mu][jj][e] = fmaf(st[mu][jj][e], decay, upd[mu][jj][e]);
        }
      }
      // every warp of the sub-block has read the state entering chunk c
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + sub), "r"(kSubThreads));
      publish_state();
    }
  }

  if (!active) return;
#pragma unroll
  for (int mu = 0; mu < MU; ++mu) {
#pragma unroll
    for (int jj = 0; jj < NTW; ++jj) {
      const int j = wl + kWarps * jj;
      if (j >= NT) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * mu + g + 8 * half;
        if (!kFullRows && half == 1) continue;
        *reinterpret_cast<float2*>(fin + state0 + static_cast<long long>(p0 + row) * N + 8 * j +
                                   2 * t) = make_float2(st[mu][jj][2 * half],
                                                        st[mu][jj][2 * half + 1]);
      }
    }
  }
}

template <int PB, int N>
cudaError_t launch_mma(const void* x, const float* dt, const float* a, const void* bm,
                       const void* cm, const float* init, void* y, float* fin, float* scores,
                       Strides xs, Strides dts, Strides bs, Strides cs, int b, int seq, int h,
                       int g, int p, cudaStream_t stream) {
  const int n_chunks = (seq + kQ - 1) / kQ;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(cm);
  if (n_chunks > 0) {
    ssd_scores_kernel<N><<<dim3(n_chunks, g, b), kWarps * 32, 0, stream>>>(
        bb, cb, scores, bs, cs, seq, n_chunks, g);
    const cudaError_t err = count_grid(cudaGetLastError());
    if (err != cudaSuccess) return err;
  }
  constexpr int smem = mma_smem_bytes<PB, N>();
  if (smem > 48 * 1024) {   // above 48 KB a block's shared memory must be opted into
    const cudaError_t err = cudaFuncSetAttribute(ssd_scan_mma_kernel<PB, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int slices = h / g * (p / PB);   // per group: heads x row blocks
  ssd_scan_mma_kernel<PB, N><<<dim3((slices + kSub - 1) / kSub, g, b), kSub * kWarps * 32,
                               smem, stream>>>(
      xb, dt, a, bb, cb, scores, init, static_cast<__nv_bfloat16*>(y), fin, xs, dts, bs, cs,
      seq, h, p, h / g, g, n_chunks);
  return count_grid(cudaGetLastError());
}

template <int PB>
cudaError_t launch_mma_n(int n, const void* x, const float* dt, const float* a, const void* bm,
                         const void* cm, const float* init, void* y, float* fin, float* scores,
                         Strides xs, Strides dts, Strides bs, Strides cs, int b, int seq, int h,
                         int g, int p, cudaStream_t stream) {
#define SSD_MMA_N(NN)                                                                     \
  case NN:                                                                                \
    return launch_mma<PB, NN>(x, dt, a, bm, cm, init, y, fin, scores, xs, dts, bs, cs, b, \
                              seq, h, g, p, stream);
  switch (n) {
    SSD_MMA_N(8)
    SSD_MMA_N(16)
    SSD_MMA_N(32)
    SSD_MMA_N(64)
    SSD_MMA_N(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSD_MMA_N
}

bool rows_aligned(const void* ptr, const Strides& s) {   // 16-byte rows of bf16
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s.b % 8 == 0 && s.s % 8 == 0 &&
         s.h % 8 == 0;
}

}  // namespace

// The f32-pipe design.  dtype 0 = float32, 1 = bfloat16 (x, B, C and y);
// p in {8, 16, 32, 64}, n in {8, 16, 32, 64, 128}.  strides holds the
// (batch, position, head|group) element strides of x, dt, B and C in turn.
// init may be null (a zero state).
extern "C" int ssd_scan_scalar_launch(const void* x, const float* dt, const float* a,
                                      const void* bm, const void* cm, const float* init,
                                      void* y, float* fin, const long long* strides, int dtype,
                                      int b, int seq, int h, int g, int p, int n, void* stream) {
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides dts{strides[3], strides[4], strides[5]};
  const Strides bs{strides[6], strides[7], strides[8]};
  const Strides cs{strides[9], strides[10], strides[11]};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_scalar_pn<float>(p, n, x, dt, a, bm, cm, init, y, fin, xs, dts, bs, cs, b,
                                  seq, h, g, s);
  } else if (dtype == 1) {
    err = launch_scalar_pn<__nv_bfloat16>(p, n, x, dt, a, bm, cm, init, y, fin, xs, dts, bs,
                                          cs, b, seq, h, g, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The bf16 tensor-core design: two grids on the stream (scores, then the
// scan).  Arguments as above, with scores a (b, ceil(seq / 32), g, 32, 32)
// f32 scratch.  Refuses x, B or C rows that are not 16-byte aligned.
extern "C" int ssd_scan_mma_launch(const void* x, const float* dt, const float* a,
                                   const void* bm, const void* cm, const float* init, void* y,
                                   float* fin, float* scores, const long long* strides, int b,
                                   int seq, int h, int g, int p, int n, void* stream) {
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides dts{strides[3], strides[4], strides[5]};
  const Strides bs{strides[6], strides[7], strides[8]};
  const Strides cs{strides[9], strides[10], strides[11]};
  if (!rows_aligned(x, xs) || !rows_aligned(bm, bs) || !rows_aligned(cm, cs)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p) {
    case 8:
      err = launch_mma_n<8>(n, x, dt, a, bm, cm, init, y, fin, scores, xs, dts, bs, cs, b, seq,
                            h, g, p, s);
      break;
    case 16:
      err = launch_mma_n<16>(n, x, dt, a, bm, cm, init, y, fin, scores, xs, dts, bs, cs, b,
                             seq, h, g, p, s);
      break;
    case 32:
    case 64:
      err = launch_mma_n<kPB>(n, x, dt, a, bm, cm, init, y, fin, scores, xs, dts, bs, cs, b,
                              seq, h, g, p, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Grids both designs have launched since the library was loaded.
extern "C" long long ssd_scan_grids() { return g_grids; }
