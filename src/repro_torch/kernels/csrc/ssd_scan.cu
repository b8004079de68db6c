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
// read in place.  Launched through a plain C function and bound from Python
// with ctypes (kernels/ssd_scan.py).
//
// Replaces repro/kernels/ssd_scan_kernel.py ssd_scan_pallas.  There the grid
// is (B, chunks) and all H heads' (H, P, N) state sits in VMEM scratch,
// carried from one chunk to the next by the TPU's in-order grid.  On this card
// that state is 768 KiB per batch row at mamba2-130m's width, and blocks run in
// no order.  So here one block owns one (batch, head): it walks the sequence
// in order, 32 positions at a time, and keeps that head's (P, N) state in
// shared memory (32 KiB f32 at P=64, N=128).  Per chunk, with the decay's
// cumulative sum cs taken by one warp scan:
//
//   1. M[l, s] = (C_l . B_s) exp(cs_l - cs_s) dt_s for s <= l   (scores)
//   2. y_l = sum_s M[l, s] x_s + exp(cs_l) state C_l               (outputs)
//   3. state = exp(cs_last) state + sum_s B_s exp(cs_last - cs_s) dt_s x_s
//
// The chunked algebra is exact for any chunk length, so the kernel's 32 need
// not be the model's 128; the results differ from the plain version's only
// by f32 rounding.  A 32-row chunk halves the quadratic terms' work per
// position against 128 and keeps shared memory near 80 KB, so two blocks fit
// on an SM.  Positions at or past S are masked as dt = 0, x = 0, which leaves
// the state unchanged.  All math is f32 FMAs.
//
// What bounds it on this card: at mamba2-130m's prefill (B=8, S=2,000, H=24,
// P=64, N=128) the chunked algebra at this chunk length is ~13.5 GFLOP
// against ~0.11 GB of operand bytes, so the f32 pipe bounds it (~0.20 ms),
// not memory.  This simple kernel stages
// every operand in shared memory and runs 4-8 FMAs per shared-memory load,
// each thread on a small register tile; the scores are computed again for
// each head of a group, and B * H = 192 blocks fill the 132 SMs unevenly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 32;  // positions per chunk: one warp scans the chunk's decay

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
__global__ void __launch_bounds__(kThreads, 2)  // two blocks per SM: <= 128 registers
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ fin, Strides xs, Strides dts,
                Strides bs, Strides cs_, int seq, int n_heads, int rep) {
  constexpr int NS = N + 4;
  constexpr int MS = kQ + 4;
  // thread roles: scores rows l = warp + 8 i (i < 4), column s = lane;
  // outputs column p = tid % P, rows l = tid / P + YL i (i < YR);
  // state columns n = 4 (tid % N4) .. + 3, rows p = (tid / N4) UR + i (i < UR)
  constexpr int YL = kThreads / P;
  constexpr int YR = kQ / YL;
  constexpr int N4 = N / 4;
  constexpr int UR = (P * N4 + kThreads - 1) / kThreads;
  constexpr int UT = P / UR * N4;
  static_assert(kThreads % P == 0 && kQ % YL == 0 && P % UR == 0 && UT <= kThreads,
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

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    st_sh[p * NS + i - p * N] = init != nullptr ? init[state0 + i] : 0.f;
  }

  const int n_chunks = (seq + kQ - 1) / kQ;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kQ;
    const int valid = min(kQ, seq - t0);
    __syncthreads();  // the previous chunk is read before it is overwritten
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int s = i / N;
      const int n = i - s * N;
      const long long t = t0 + s;
      b_sh[s * NS + n] = s < valid ? to_f32(bp[t * bs.s + n]) : 0.f;
      c_sh[s * NS + n] = s < valid ? to_f32(cp[t * cs_.s + n]) : 0.f;
    }
    for (int i = tid; i < kQ * P; i += kThreads) {
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
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    fin[state0 + i] = st_sh[p * NS + i - p * N];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* bm,
                   const void* cm, const float* init, void* y, float* fin, Strides xs,
                   Strides dts, Strides bs, Strides cs, int b, int seq, int h, int g,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<P, N>() * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {  // above 48 KB a block's shared memory must be opted into
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(h, b);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      init, static_cast<T*>(y), fin, xs, dts, bs, cs, seq, h, h / g);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(int n, const void* x, const float* dt, const float* a, const void* bm,
                     const void* cm, const float* init, void* y, float* fin, Strides xs,
                     Strides dts, Strides bs, Strides cs, int b, int seq, int h, int g,
                     cudaStream_t stream) {
#define SSD_N(NN)                                                                       \
  case NN:                                                                              \
    return launch<T, P, NN>(x, dt, a, bm, cm, init, y, fin, xs, dts, bs, cs, b, seq, h, \
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
cudaError_t launch_pn(int p, int n, const void* x, const float* dt, const float* a,
                      const void* bm, const void* cm, const float* init, void* y, float* fin,
                      Strides xs, Strides dts, Strides bs, Strides cs, int b, int seq, int h,
                      int g, cudaStream_t stream) {
#define SSD_P(PP)                                                                          \
  case PP:                                                                                 \
    return launch_n<T, PP>(n, x, dt, a, bm, cm, init, y, fin, xs, dts, bs, cs, b, seq, h, \
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

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x, B, C and y); p in {8, 16, 32, 64},
// n in {8, 16, 32, 64, 128}.  strides holds the (batch, position, head|group)
// element strides of x, dt, B and C in turn.  init may be null (a zero state).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* a, const void* bm,
                               const void* cm, const float* init, void* y, float* fin,
                               const long long* strides, int dtype, int b, int seq, int h,
                               int g, int p, int n, void* stream) {
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides dts{strides[3], strides[4], strides[5]};
  const Strides bs{strides[6], strides[7], strides[8]};
  const Strides cs{strides[9], strides[10], strides[11]};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_pn<float>(p, n, x, dt, a, bm, cm, init, y, fin, xs, dts, bs, cs, b, seq, h,
                           g, s);
  } else if (dtype == 1) {
    err = launch_pn<__nv_bfloat16>(p, n, x, dt, a, bm, cm, init, y, fin, xs, dts, bs, cs, b,
                                   seq, h, g, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
