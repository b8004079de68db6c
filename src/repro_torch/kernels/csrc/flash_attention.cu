// Causal GQA flash attention for Hopper (sm_90a): the prefill attention of
// the port's dense LM.
//
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h // rep, j]) v[b, h // rep, j]
//
// over the keys j < kv_len and, when causal, j <= q_offset + i (query row i
// sits at absolute position q_offset + i of the KV buffer).  rep = H / G maps
// each query head to its KV group; K/V are read per group and never repeated.
// q_offset and kv_len are runtime arguments, so one build serves a prefill
// into an empty cache (q_offset 0, kv_len S) and into a filled one.  Launched
// through a plain C function and bound from Python with ctypes
// (kernels/flash_attention.py); every tensor is addressed by its (batch, head,
// position) strides with the head dimension contiguous, so the model's
// (B, S, H, hd) activations and (B, Smax, G, hd) caches are read in place.
//
// Replaces repro/kernels/flash_attention_kernel.py flash_attention_pallas.
// There the KV axis is the innermost grid axis and (m, l, acc) live in VMEM
// scratch across it; here one block owns one (batch, head, 64-row query tile)
// and walks the KV axis in a loop, 64 keys at a time staged in shared memory
// as f32.  Each thread owns one query row: its q (pre-scaled by
// scale * log2 e) and its f32 output accumulator sit in registers, and it
// runs the online softmax key by key in the exp2 domain.  Key tiles past the
// tile's last visible position are never loaded (causal block skipping).
// Unlike the TPU kernel, p stays f32 in the p.v product (the TPU rounds it to
// the input type to feed its matrix unit); inputs are f32 or bf16, and the
// output is rounded once to the input type.
//
// What bounds it on this card: the attention FLOPs at the tensor-core rate,
// or the q/k/v/o bytes; at prefill shapes both are microseconds.  This simple
// kernel runs on the f32 pipe with one query row per thread, so it is bound
// by its FMA pipe and shared-memory reads, well above either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows per block, one per thread
constexpr int kBK = 64;       // keys per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of a (batch, head, position, hd) view
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides qs,
                       Strides ks, Strides vs, Strides os, int rep, int sq,
                       float scale_log2, int causal, int q_offset, int kv_len) {
  __shared__ __align__(16) float k_sh[kBK][HD];
  __shared__ __align__(16) float v_sh[kBK][HD];
  const int qt = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / rep;
  const int row = qt * kBQ + threadIdx.x;
  const bool active = row < sq;
  const int qpos = q_offset + row;

  float qr[HD];
  float acc[HD];
  const T* qp = q + bi * qs.b + hi * qs.h + static_cast<long long>(active ? row : 0) * qs.s;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? to_f32(qp[d]) * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // the keys any row of this tile can see
  const int last_row = min(sq, (qt + 1) * kBQ) - 1;
  const int kend = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const T* kp = k + bi * ks.b + gi * ks.h;
  const T* vp = v + bi * vs.b + gi * vs.h;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int kc = min(kBK, kend - k0);
    __syncthreads();  // the previous tile is read before it is overwritten
    for (int i = threadIdx.x; i < kBK * HD; i += kBQ) {
      const int j = i / HD;
      const int d = i - j * HD;
      const long long pos = k0 + j;
      k_sh[j][d] = j < kc ? to_f32(kp[pos * ks.s + d]) : 0.f;
      v_sh[j][d] = j < kc ? to_f32(vp[pos * vs.s + d]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int jmax = causal ? min(kc, qpos - k0 + 1) : kc;
    for (int j = 0; j < jmax; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kv4 = *reinterpret_cast<const float4*>(&k_sh[j][d]);
        s = fmaf(qr[d], kv4.x, s);
        s = fmaf(qr[d + 1], kv4.y, s);
        s = fmaf(qr[d + 2], kv4.z, s);
        s = fmaf(qr[d + 3], kv4.w, s);
      }
      if (s > m) {  // new running maximum: rescale what was summed so far
        const float alpha = exp2f(m - s);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= alpha;
        m = s;
      }
      const float p = exp2f(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&v_sh[j][d]);
        acc[d] = fmaf(p, v4.x, acc[d]);
        acc[d + 1] = fmaf(p, v4.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, v4.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, v4.w, acc[d + 3]);
      }
    }
  }
  if (!active) return;
  // a row with no visible key gives 0/0, as the plain softmax does
  const float inv = 1.f / l;
  T* op = o + bi * os.b + hi * os.h + static_cast<long long>(row) * os.s;
#pragma unroll
  for (int d = 0; d < HD; ++d) op[d] = from_f32<T>(acc[d] * inv);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs,
                   Strides ks, Strides vs, Strides os, int b, int h, int g, int sq,
                   float scale, int causal, int q_offset, int kv_len, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_attention_kernel<T, HD><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, h / g, sq, scale * kLog2e, causal, q_offset,
      kv_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                      Strides qs, Strides ks, Strides vs, Strides os, int b, int h, int g,
                      int sq, float scale, int causal, int q_offset, int kv_len,
                      cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, qs, ks, vs, os, b, h, g, sq, scale, causal, q_offset,
                           kv_len, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, qs, ks, vs, os, b, h, g, sq, scale, causal, q_offset,
                           kv_len, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, os, b, h, g, sq, scale, causal, q_offset,
                           kv_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; hd in {16, 32, 64}.  Each stride array is
// the (batch, head, position) element strides of q, k, v and o in turn.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int dtype, int b, int h,
                                      int g, int sq, int hd, float scale, int causal,
                                      int q_offset, int kv_len, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_hd<float>(hd, q, k, v, o, qs, ks, vs, os, b, h, g, sq, scale, causal,
                           q_offset, kv_len, s);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, qs, ks, vs, os, b, h, g, sq, scale,
                                   causal, q_offset, kv_len, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
