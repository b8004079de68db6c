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
// and walks the KV axis in a loop.
//
// The bf16 kernel (the one the served model runs) is FlashAttention-2 on the
// tensor cores.  A block is 4 warps; each warp owns 16 query rows, whose q
// sits in registers as mma.sync A fragments for the whole call.  K and V
// tiles of 64 keys stay bf16 in shared memory, rows padded by 16 bytes so
// that ldmatrix reads them without bank conflicts, double-buffered: cp.async
// copies tile t+1 in 16-byte row pieces while the warps work on tile t.
// S = q k^T runs through mma.sync.m16n8k16 (bf16 in, f32 accumulate); the
// scale (times log2 e) is applied to the f32 scores, and the online softmax
// runs on the accumulator fragments in the exp2 domain, with each row's max
// and sum reduced over the 4 lanes of its quad by shuffles.  P.V runs through
// the same MMA, its A fragments taken straight from S's accumulators.  Only
// tiles that cross the causal diagonal or kv_len are masked, and tiles past
// the last visible key are never loaded (causal block skipping).
//
// P's precision.  The TPU kernel rounds p to the input type before P.V
// (flash_attention_kernel.py:73).  Here p is carried as a pair of bf16,
// hi = bf16(p) and lo = bf16(p - hi), through two MMAs: p to about 2^-16
// relative.  Emulated in plain f32 at the two serve shapes (S=128 and 77,
// bf16 inputs from a seed, tests/test_torch_kernel_design.py), bf16 p alone
// gives a largest error of 0.0047 and 0.0042 x max|out| against the plain
// version (f32 p), the hi + lo pair 0.0023 and 0.0011, under the 2^-7 =
// 0.0078 limit per call.  The extra MMA per tile keeps the first design's
// margin.
//
// What bounds it on this card: the q/k/v/o bytes, 1.6 microseconds at the
// serve prefill (B=4, H=32, S=128: 5.2 MB), against 0.27 GFLOP of attention
// at the bf16 tensor-core rate.  At these sizes the kernel is bound by
// latency and the launch, not by the MMA rate: 256 blocks, two to an SM, each
// a serial chain of copy -> q.k MMAs -> max -> exp2 -> P.V MMAs over at most
// two key tiles, a third of whose MMAs are the lo half of p.  The row-pad
// layout needs 16-byte aligned rows: the launcher checks q, k, v and o and
// refuses the launch otherwise (the wrapper raises).
//
// The f32 kernel serves only the reduced-config checks and keeps the first
// design: one query row per thread on the f32 FMA pipe, K/V staged in shared
// memory as f32, p kept f32.
//
// Head widths 112 and 128 (internlm2, starcoder2, deepseek-67b at 128,
// kimi-k2 at 112).  The bf16 kernel is the same code: hd = 112 is 7 k-chunks
// of 16 and 14 output tiles of 8, and a 224-byte row padded by 16 bytes
// keeps ldmatrix's eight row addresses on distinct bank quads (row r starts
// at bank 28 r mod 32).  Its double-buffered K/V tiles take 2 x 2 x 64 x
// (hd + 8) bf16: 61,440 bytes at 112 and 69,632 at 128, over the 48 KB a
// block may hold statically, so every instance takes its tiles as dynamic
// shared memory and the launcher raises the block's limit above 48 KB
// (cudaFuncSetAttribute).  The accumulator grows to hd / 2 floats a thread
// (64 at 128) beside q's hd / 4 fragment registers and S's 32: ptxas gives
// the hd 128 instance 173 registers and the hd 112 one 182, no spills.  The
// f32 kernel would hold q and the accumulator in registers, 2 hd floats a
// thread (256 at 128; with q alone moved out, ptxas still spilled 88 bytes
// at 128); above hd 64 it keeps both in shared memory instead, element d of
// a thread's row at d * 64 + thread, so a warp reads 32 consecutive words,
// and unrolls its loops over d by 4 (fully unrolled, ptxas hoisted the q row
// back into 255 registers and spilled 60 bytes at 128; by 4, 48 registers and
// no spills at 112 and 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of a (batch, head, position, hd) view
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;     // 16 query rows each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b for one 16x8 tile over 16 of k, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) -> bf16x2 hi and bf16x2 lo = bf16(x - hi)
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int d, bool in) {
  return in ? *reinterpret_cast<const uint32_t*>(row + d) : 0u;
}

// dynamic shared memory of the bf16 kernel: double-buffered K and V tiles
template <int HD>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 2 * 2 * kBK * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, Strides qs, Strides ks, Strides vs,
                           Strides os, int rep, int sq, float scale_log2, int causal,
                           int q_offset, int kv_len) {
  constexpr int kStride = HD + 8;   // bf16 per shared row: 16 bytes of pad
  constexpr int KC = HD / 16;       // k-chunks of q . k
  constexpr int DT = HD / 8;        // 8-wide tiles of the output
  constexpr int kChunks = HD / 8;   // 16-byte pieces per K/V row
  constexpr int kTile = kBK * kStride;
  // two K tiles, then two V tiles: mma_smem_bytes<HD>() of dynamic memory
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const k_sh = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const v_sh = k_sh + 2 * kTile;

  const int qt = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;      // fragment row (and column of B)
  const int t = lane & 3;       // fragment column pair
  const int row0 = qt * kBQ + warp * 16;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;

  // the keys any row of this block can see, and this warp's rows
  const int last_row = min(sq, (qt + 1) * kBQ) - 1;
  const int kend = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const int n_tiles = (kend + kBK - 1) / kBK;
  const bool w_active = row0 < sq;
  const int w_kend = causal ? min(kv_len, q_offset + min(sq, row0 + 16)) : kv_len;

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const __nv_bfloat16* kb = k + bi * ks.b + gi * ks.h;
  const __nv_bfloat16* vb = v + bi * vs.b + gi * vs.h;
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kBK;
    for (int i = tid; i < kBK * kChunks; i += kWarps * 32) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 8;
      const int pos = k0 + r;
      const long long src = pos < kend ? pos : 0;   // zero-filled past kend
      const int bytes = pos < kend ? 16 : 0;
      cp_async16(&k_sh[buf * kTile + r * kStride + c], kb + src * ks.s + c, bytes);
      cp_async16(&v_sh[buf * kTile + r * kStride + c], vb + src * vs.s + c, bytes);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_tile(0, 0);   // in flight while q is read

  uint32_t qf[KC][4];
  {
    const __nv_bfloat16* qb = q + bi * qs.b + hi * qs.h;
    const __nv_bfloat16* q_lo = qb + static_cast<long long>(r_lo < sq ? r_lo : 0) * qs.s;
    const __nv_bfloat16* q_hi = qb + static_cast<long long>(r_hi < sq ? r_hi : 0) * qs.s;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qf[kc][0] = load_pair(q_lo, 16 * kc + 2 * t, r_lo < sq);
      qf[kc][1] = load_pair(q_hi, 16 * kc + 2 * t, r_hi < sq);
      qf[kc][2] = load_pair(q_lo, 16 * kc + 2 * t + 8, r_lo < sq);
      qf[kc][3] = load_pair(q_hi, 16 * kc + 2 * t + 8, r_hi < sq);
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * kBK;
    if (w_active && k0 < w_kend) {
      const __nv_bfloat16* ksh = k_sh + buf * kTile;
      const __nv_bfloat16* vsh = v_sh + buf * kTile;
      // S = q k^T: 16 rows x 64 keys, 8 tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const int mi = lane >> 3;   // which of ldmatrix's 4 matrices this lane addresses
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          // matrices: keys of tile nt and nt+1, d chunk kc low and high halves
          uint32_t b[4];
          const int key = (nt + (mi >> 1)) * 8 + (lane & 7);
          ldmatrix_x4(b, ksh + key * kStride + 16 * kc + (mi & 1) * 8);
          mma_bf16(s[nt], qf[kc], b[0], b[1]);
          mma_bf16(s[nt + 1], qf[kc], b[2], b[3]);
        }
      }
      // scale into the exp2 domain; mask only where the tile crosses the
      // diagonal of this warp's rows or kv_len
      const bool need_mask =
          k0 + kBK > kv_len || (causal && k0 + kBK - 1 > q_offset + row0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale_log2;
          if (need_mask) {
            const int key = k0 + nt * 8 + 2 * t + (e & 1);
            const int qpos = q_offset + (e < 2 ? r_lo : r_hi);
            if (key >= kv_len || (causal && key > qpos)) x = -INFINITY;
          }
          s[nt][e] = x;
        }
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      // a row that has seen no key yet keeps everything at 0
      const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float alpha_lo = exp2f(m_lo - base_lo);
      const float alpha_hi = exp2f(m_hi - base_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= alpha_lo;
      l_hi *= alpha_hi;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][0] *= alpha_lo;
        acc[dt][1] *= alpha_lo;
        acc[dt][2] *= alpha_hi;
        acc[dt][3] *= alpha_hi;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - base_lo);
        s[nt][1] = exp2f(s[nt][1] - base_lo);
        s[nt][2] = exp2f(s[nt][2] - base_hi);
        s[nt][3] = exp2f(s[nt][3] - base_hi);
        l_lo += s[nt][0] + s[nt][1];
        l_hi += s[nt][2] + s[nt][3];
      }
      // O += P . V over 4 chunks of 16 keys; p as bf16 hi + lo
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ph[4], pl[4];
        split_pack(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
        split_pack(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
        split_pack(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
        split_pack(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          // matrices: keys low and high halves of the chunk, d tiles dt and dt+1
          uint32_t b[4];
          const int key = 16 * kc + (mi & 1) * 8 + (lane & 7);
          ldmatrix_x4_trans(b, vsh + key * kStride + 8 * (dt + (mi >> 1)));
          mma_bf16(acc[dt], ph, b[0], b[1]);
          mma_bf16(acc[dt], pl, b[0], b[1]);
          mma_bf16(acc[dt + 1], ph, b[2], b[3]);
          mma_bf16(acc[dt + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // this buffer is read before the next load overwrites it
  }
  if (!w_active) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // a row with no visible key gives 0/0, as the plain softmax does
  const float inv_lo = 1.f / l_lo;
  const float inv_hi = 1.f / l_hi;
  __nv_bfloat16* ob = o + bi * os.b + hi * os.h;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = 8 * dt + 2 * t;
    if (r_lo < sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(r_lo) * os.s + d) =
          __floats2bfloat162_rn(acc[dt][0] * inv_lo, acc[dt][1] * inv_lo);
    }
    if (r_hi < sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(r_hi) * os.s + d) =
          __floats2bfloat162_rn(acc[dt][2] * inv_hi, acc[dt][3] * inv_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the first design, one query row per thread
// ---------------------------------------------------------------------------

// Above hd 64 the f32 kernel keeps each thread's q row and accumulator in
// shared memory and unrolls its loops over d by 4 (see the header).
template <int HD>
struct F32Rows {
  static constexpr bool kShared = HD > 64;
  static constexpr int kUnroll = kShared ? 4 : HD;
};

// dynamic shared memory of the f32 kernel: a K and a V tile, then q's rows
// and the accumulators, each [HD][kBQ]
template <int HD>
__host__ __device__ constexpr int f32_smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (2 * kBK * HD + (F32Rows<HD>::kShared ? 2 * HD * kBQ : 0));
}

template <int HD>
__global__ void __launch_bounds__(kBQ)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, Strides qs,
                           Strides ks, Strides vs, Strides os, int rep, int sq,
                           float scale_log2, int causal, int q_offset, int kv_len) {
  constexpr bool kShared = F32Rows<HD>::kShared;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const k_sh = reinterpret_cast<float*>(smem);   // [kBK][HD]
  float* const v_sh = k_sh + kBK * HD;                    // [kBK][HD]
  // kShared: element d of this thread's q row and accumulator at d * kBQ +
  // threadIdx.x, so a warp's 32 threads read 32 consecutive words
  float* const q_t = v_sh + kBK * HD + threadIdx.x;
  float* const acc_t = q_t + HD * kBQ;
  const int qt = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / rep;
  const int row = qt * kBQ + threadIdx.x;
  const bool active = row < sq;
  const int qpos = q_offset + row;

  float qr[kShared ? 1 : HD];
  float acc[kShared ? 1 : HD];
  // q (scaled into the exp2 domain) and the accumulator, where they live
  auto q_at = [&](int d) -> float& {
    if constexpr (kShared) {
      return q_t[d * kBQ];
    } else {
      return qr[d];
    }
  };
  auto acc_at = [&](int d) -> float& {
    if constexpr (kShared) {
      return acc_t[d * kBQ];
    } else {
      return acc[d];
    }
  };
  const float* qp = q + bi * qs.b + hi * qs.h + static_cast<long long>(active ? row : 0) * qs.s;
#pragma unroll(F32Rows<HD>::kUnroll)
  for (int d = 0; d < HD; ++d) {
    q_at(d) = active ? qp[d] * scale_log2 : 0.f;
    acc_at(d) = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // the keys any row of this tile can see
  const int last_row = min(sq, (qt + 1) * kBQ) - 1;
  const int kend = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const float* kp = k + bi * ks.b + gi * ks.h;
  const float* vp = v + bi * vs.b + gi * vs.h;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int kc = min(kBK, kend - k0);
    __syncthreads();  // the previous tile is read before it is overwritten
    for (int i = threadIdx.x; i < kBK * HD; i += kBQ) {
      const int j = i / HD;
      const int d = i - j * HD;
      const long long pos = k0 + j;
      k_sh[i] = j < kc ? kp[pos * ks.s + d] : 0.f;
      v_sh[i] = j < kc ? vp[pos * vs.s + d] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int jmax = causal ? min(kc, qpos - k0 + 1) : kc;
    for (int j = 0; j < jmax; ++j) {
      const float* krow = k_sh + j * HD;
      const float* vrow = v_sh + j * HD;
      float s = 0.f;
#pragma unroll(F32Rows<HD>::kUnroll)
      for (int d = 0; d < HD; d += 4) {
        const float4 kv4 = *reinterpret_cast<const float4*>(krow + d);
        s = fmaf(q_at(d), kv4.x, s);
        s = fmaf(q_at(d + 1), kv4.y, s);
        s = fmaf(q_at(d + 2), kv4.z, s);
        s = fmaf(q_at(d + 3), kv4.w, s);
      }
      if (s > m) {  // new running maximum: rescale what was summed so far
        const float alpha = exp2f(m - s);
        l *= alpha;
#pragma unroll(F32Rows<HD>::kUnroll)
        for (int d = 0; d < HD; ++d) acc_at(d) *= alpha;
        m = s;
      }
      const float p = exp2f(s - m);
      l += p;
#pragma unroll(F32Rows<HD>::kUnroll)
      for (int d = 0; d < HD; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + d);
        acc_at(d) = fmaf(p, v4.x, acc_at(d));
        acc_at(d + 1) = fmaf(p, v4.y, acc_at(d + 1));
        acc_at(d + 2) = fmaf(p, v4.z, acc_at(d + 2));
        acc_at(d + 3) = fmaf(p, v4.w, acc_at(d + 3));
      }
    }
  }
  if (!active) return;
  // a row with no visible key gives 0/0, as the plain softmax does
  const float inv = 1.f / l;
  float* op = o + bi * os.b + hi * os.h + static_cast<long long>(row) * os.s;
#pragma unroll(F32Rows<HD>::kUnroll)
  for (int d = 0; d < HD; ++d) op[d] = acc_at(d) * inv;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int b, h, g, sq, causal, q_offset, kv_len;
  float scale_log2;
};

// A block above 48 KB of shared memory needs its kernel's limit raised first,
// once a device: ``done`` holds a bit for each device where it was raised.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <int HD>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  if (dtype == 1) {
    constexpr int bytes = mma_smem_bytes<HD>();
    static unsigned raised = 0;
    const cudaError_t err = allow_smem(flash_attention_mma_kernel<HD>, bytes, raised);
    if (err != cudaSuccess) return err;
    flash_attention_mma_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.qs, a.ks,
        a.vs, a.os, a.h / a.g, a.sq, a.scale_log2, a.causal, a.q_offset, a.kv_len);
  } else {
    constexpr int bytes = f32_smem_bytes<HD>();
    static unsigned raised = 0;
    const cudaError_t err = allow_smem(flash_attention_f32_kernel<HD>, bytes, raised);
    if (err != cudaSuccess) return err;
    flash_attention_f32_kernel<HD><<<grid, kBQ, bytes, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.qs, a.ks, a.vs, a.os,
        a.h / a.g, a.sq, a.scale_log2, a.causal, a.q_offset, a.kv_len);
  }
  return cudaGetLastError();
}

// Every row the bf16 kernel reads or writes starts on a 16-byte boundary: the
// base, and each stride of an axis it walks (extent > 1), in bytes.
bool rows_aligned(const void* p, const Strides& st, int nb, int nh, int ns) {
  constexpr long long kRow = 16 / static_cast<long long>(sizeof(__nv_bfloat16));
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (nb < 2 || st.b % kRow == 0) &&
         (nh < 2 || st.h % kRow == 0) && (ns < 2 || st.s % kRow == 0);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 112, 128}.  Each stride array is
// the (batch, head, position) element strides of q, k, v and o in turn.
// Returns a cudaError_t, or kMisaligned where a bf16 row does not start on a
// 16-byte boundary.
constexpr int kMisaligned = -1;

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int dtype, int b, int h,
                                      int g, int sq, int hd, float scale, int causal,
                                      int q_offset, int kv_len, void* stream) {
  const Args a{q, k, v, o,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]},
               b, h, g, sq, causal, q_offset, kv_len, scale * kLog2e};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && !(rows_aligned(q, a.qs, b, h, sq) && rows_aligned(k, a.ks, b, g, kv_len) &&
                      rows_aligned(v, a.vs, b, g, kv_len) && rows_aligned(o, a.os, b, h, sq)))
    return kMisaligned;
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<16>(dtype, a, s); break;
    case 32: err = launch<32>(dtype, a, s); break;
    case 64: err = launch<64>(dtype, a, s); break;
    case 112: err = launch<112>(dtype, a, s); break;
    case 128: err = launch<128>(dtype, a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
