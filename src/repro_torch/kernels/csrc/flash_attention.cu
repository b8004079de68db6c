// Causal GQA flash attention for Hopper (sm_90a): the prefill attention of
// the port's LMs (and their training forward), causal or not.
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
// The bf16 wgmma route (flash_attention_wgmma_kernel): the long and the
// non-causal calls (kernels/flash_attention.py plan(): every non-causal call,
// and causal ones over 512 keys or more, at hd 64 and 128; the head-stacked
// layout below takes the short causal ones at hd 112 and 128).  The design above
// sat at 19% of its bound over whisper's 1,500 keys, where SDPA reached 38%:
// mma.sync is not the card's full tensor-core rate, its 64-key tiles arrive
// by cp.async copies every thread issues, and the hi + lo pair does 1.5x the
// P.V work.  Here a block is one to three consumer warpgroups of 64 query
// rows (the plan picks 192, 128 or 64 rows: the most whose blocks still fill
// the 132 SMs; three only at hd 64, whose 128 registers a thread leave room)
// and one producer warp.  The producer's one lane loads the block's q rows
// and then each 128-key K and V tile by TMA (cp.async.bulk.tensor, 4-d maps
// over the strided (hd, position, head, batch) views, 128-byte swizzled, keys
// past kv_len filled with zeros) into a ring of two stages, each with full
// and empty mbarriers.  A consumer warpgroup computes S = q k^T with
// wgmma.m64n128k16 from shared memory (q and K both K-major), runs the online
// softmax on S's accumulator fragments in the exp2 domain (ex2.approx.ftz),
// rounds p once to bf16 as the TPU kernel does (its p.astype(v.dtype)) and
// feeds it from registers as the A operand of O += P.V, wgmma.m64n{HD}k16
// with V as the MN-major B operand; a causal warpgroup skips the tiles past
// its last row and masks only the tiles that cross the diagonal or kv_len.
// Every warp arrives on a stage's empty barrier once its tile is read, the
// skipped tiles included, so a round's arrivals never mix with the next's.
// A barrier that has not completed after ~17 s traps instead of holding the
// card.  What bounds it on this card: at hd 64 the softmax's 16,384 exp2 a
// 128 x 128 tile pair on the SFU (16 a clock an SM) about equals the tile's
// wgmma time, and each warpgroup waits for its own products before its
// softmax, so only the other warpgroups overlap them (an S of the next tile
// in flight during this one's softmax did not fit 168 registers a thread: it
// spilled and ran slower).  Measured (chip_smoke.py, H100 80GB HBM3, 700 W,
// CUDA events on the raw launcher [profiler device time]): whisper's encoder
// (4 x 16 heads, 1,500 x 1,500) 0.1353 ms [0.1290] against the mma route's
// 0.2704 [0.2641] and SDPA's 0.1065 [0.1042], bound 0.0373; the VLM's cross
// (128 x 1,600, hd 128) 0.0795 [0.0757] against 0.1658 [0.1607] and 0.0850
// [0.0815]; whisper's cross (128 x 1,500) [0.0183] against [0.0370] and
// [0.0188]; granite's 4 x 4096 causal forward 0.9066 [0.9097, profiled in a
// fresh process in a later run] against 1.8227 [1.8490] and 0.6298
// [0.6281], bound 0.278.  S's and P's fragments are
// those of mma.m16n8k16 per warp, so the softmax code is the design above's.
//
// The head-stacked layout of the wgmma route (STACK; plan()'s "stacked"
// route): the short causal prefills at hd 112 and 128 (internlm2, starcoder2,
// deepseek-67b, kimi-k2: S = 128 over 128 keys).  The mma route sat there at
// 3.9x its bound (deepseek-67b, kimi-k2) and up to 2.1x SDPA on the device:
// latency, a serial copy -> q.k -> softmax -> P.V chain over one or two
// 64-key tiles, a third of its MMAs on p's lo half, and each of a group's
// heads' blocks fetching the same K/V tiles again.  At S <= 256 every tile a
// block's rows see crosses the diagonal, so the causal skip saves nothing;
// what sharing does is feed one TMA-loaded K/V tile to several heads.  Here a
// block's NC consumer warpgroups (1 or 2) take NC heads of one KV group at
// the same 64 query rows, so each K/V tile serves NC heads, and the block
// walks `iters` rounds of NC heads (1 or 2), the producer loading the next
// round's q into a second q buffer (released by a q-empty mbarrier) while
// this round computes; the K/V tiles of a round are the same group's again
// (L2 hits).  plan() picks NC and the rounds for the fewest waves of blocks
// times rounds, then the most rounds, then the fewest heads at once.  hd 112
// runs in the hd 128 instance's 128-wide tiles: the tensor maps' inner
// extent is 112, so TMA fills columns 112-127 of q, K and V with zeros, q.k
// takes 7 k-steps of 16, P.V runs at n = 128 (its last 16 columns zero) and
// only the first 112 are stored (an n = 112 P.V instance was not built).
// What bounds it: latency again, now per round (q.k, a softmax that masks
// every tile, P.V, each waiting on the one before), with two consumer
// warpgroups an SM (the registers: 159-164 a thread); its device times are
// 2.5-4.4x the bytes' bound.  The figures are in PERF.md section 6
// (chip_smoke.py).
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

#include "hopper.cuh"

namespace {

using namespace hopper;

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
// bf16 route 2: warpgroup MMA (wgmma) over a TMA-fed K/V ring
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;           // query rows a consumer warpgroup owns
constexpr int kWgKeys = 128;          // keys a K/V tile holds
constexpr int kSwRow = 128;           // bytes of a 128-byte swizzled row: 64 bf16
constexpr int kSwAtom = 8 * kSwRow;   // the swizzle's period: 8 rows

// Shared memory of a block with NC consumer warpgroups: QB buffers of q's
// rows (two where a block walks several heads, the next head's q in flight),
// then the K and V rings, then the barriers.  A row of HD bf16 lies in HD /
// 64 panels of 128-byte rows, each panel 128-byte swizzled as TMA writes it
// and wgmma reads it; every panel starts on a 1024-byte boundary.
template <int HD, int NC, int QB = 1>
struct WgLayout {
  static constexpr int kStages = 2;                 // K/V tiles in flight
  static constexpr int kPanels = HD / 64;
  static constexpr int kQPanel = kWgRows * kSwRow;    // a warpgroup's q rows, one panel
  static constexpr int kKVPanel = kWgKeys * kSwRow;   // a K or V tile, one panel
  static constexpr int kQBytes = kPanels * kQPanel;   // a warpgroup's q rows
  static constexpr int kTileBytes = kPanels * kKVPanel;
  static constexpr int kK = QB * NC * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q full and empty a buffer; K full, V full and K/V empty a stage
  static constexpr int kBytes = kBar + 8 * (2 * QB + 3 * kStages) + 1024;   // + alignment
  static constexpr int kThreads = NC * 128 + 32;       // the consumers, then the producer warp
};

// a (hd, position, head, batch) box of a 4-d tensor map into shared memory,
// completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 2^x on the SFU, flushing results below 2^-126 to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A . B for a 64 x 128 tile over 16 of k: A and B from shared memory
// (K-major, 128-byte swizzle), bf16 in, f32 accumulate; scale_d 0 zeroes d first
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B for a 64 x 64 tile over 16 of k: A from registers (the
// accumulator layout's fragments), B from shared memory (MN-major, 128-byte
// swizzle), bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B for a 64 x 128 tile over 16 of k: A from registers (the
// accumulator layout's fragments), B from shared memory (MN-major, 128-byte
// swizzle), bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// HD: the width in shared memory (whole 64-wide panels); HDR: the heads'
// own width, 112 or HD (the columns past it TMA fills with zeros).  STACK:
// the consumer warpgroups take NC heads of one KV group at the same 64 query
// rows (the head-stacked layout), `iters` rounds of them a block, the next
// round's q loaded during this one; else NC consecutive 64-row tiles of one
// head (iters 1).
template <int HD, int NC, int HDR = HD, bool STACK = false>
__global__ void __launch_bounds__(WgLayout<HD, NC>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, Strides os, int rep, int sq,
                             float scale_log2, int causal, int q_offset, int kv_len, int iters) {
  constexpr int QB = STACK ? 2 : 1;   // q buffers
  using L = WgLayout<HD, NC, QB>;
  constexpr int P = L::kPanels;
  constexpr int KC = HDR / 16;        // 16-wide k-steps of q . k (7 at hd 112)
  constexpr int DT = HDR / 8;         // 8-wide tiles of the output stored
  constexpr int kBlkRows = STACK ? kWgRows : NC * kWgRows;   // query rows of a block
  constexpr int NT = kWgKeys / 8;     // 8-key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  auto bar_q = [&](int b) { return base + L::kBar + 8u * b; };
  auto q_empty = [&](int b) { return base + L::kBar + 8u * (QB + b); };
  auto full_k = [&](int s) { return base + L::kBar + 8u * (2 * QB + s); };
  auto full_v = [&](int s) { return base + L::kBar + 8u * (2 * QB + L::kStages + s); };
  auto empty = [&](int s) { return base + L::kBar + 8u * (2 * QB + 2 * L::kStages + s); };

  const int qt = blockIdx.x;
  const int head0 = STACK ? blockIdx.y * NC * iters : blockIdx.y;   // the block's first head
  const int bi = blockIdx.z;
  const int gi = head0 / rep;
  const int tid = threadIdx.x;
  const int row_blk = qt * kBlkRows;
  // the keys any row of this block can see: the tiles the producer loads
  const int last_row = min(sq, row_blk + kBlkRows) - 1;
  const int kend = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const int n_tiles = (kend + kWgKeys - 1) / kWgKeys;

  if (tid == 0) {
    for (int b = 0; b < QB; ++b) {
      mbar_init(bar_q(b), 1);
      mbar_init(q_empty(b), 4 * NC);   // one arrival a consumer warp
    }
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 4 * NC);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC * 128) {   // the producer warp: one lane issues every copy
    if (tid == NC * 128) {
      // warpgroups with rows
      const int live = STACK ? NC : min(NC, (sq - row_blk + kWgRows - 1) / kWgRows);
      for (int it = 0; it < iters; ++it) {
        // a round's q, once the round QB before has released its buffer, then
        // its K/V tiles (the same group's tiles again: from L2)
        const int qb = it % QB;
        if (it >= QB) mbar_wait(q_empty(qb), ((it / QB) - 1) & 1);
        mbar_arrive_tx(bar_q(qb), live * L::kQBytes);
        for (int w = 0; w < live; ++w)
          for (int p = 0; p < P; ++p)
            tma_load(base + ((qb * NC + w) * P + p) * L::kQPanel, &tq, 64 * p,
                     STACK ? row_blk : row_blk + w * kWgRows,
                     STACK ? head0 + it * NC + w : head0, bi, bar_q(qb));
        for (int i = it * n_tiles; i < (it + 1) * n_tiles; ++i) {
          const int s = i % L::kStages;
          const int k0 = (i - it * n_tiles) * kWgKeys;
          mbar_wait(empty(s), ((i / L::kStages) & 1) ^ 1);
          mbar_arrive_tx(full_k(s), L::kTileBytes);
          for (int p = 0; p < P; ++p)
            tma_load(base + L::kK + s * L::kTileBytes + p * L::kKVPanel, &tk, 64 * p, k0, gi,
                     bi, full_k(s));
          mbar_arrive_tx(full_v(s), L::kTileBytes);
          for (int p = 0; p < P; ++p)
            tma_load(base + L::kV + s * L::kTileBytes + p * L::kKVPanel, &tv, 64 * p, k0, gi,
                     bi, full_v(s));
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows, 16 a warp
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg_row0 = STACK ? row_blk : row_blk + wg * kWgRows;
  const int row0 = wg_row0 + warp * 16;
  const int r_lo = row0 + g;
  const int r_hi = r_lo + 8;
  const bool wg_active = wg_row0 < sq;
  // the keys this warpgroup's rows see: a causal block's earlier warpgroups
  // may skip the block's last tile
  const int wg_kend = causal ? min(kv_len, q_offset + min(sq, wg_row0 + kWgRows)) : kv_len;

  for (int it = 0; it < iters; ++it) {   // a round: this warpgroup's head of it
    const int qb = it % QB;
    const int head = STACK ? head0 + it * NC + wg : head0;
    const uint32_t q_base = base + (qb * NC + wg) * L::kQBytes;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float sc[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) sc[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    if (wg_active) mbar_wait(bar_q(qb), (it / QB) & 1);

    for (int i = it * n_tiles; i < (it + 1) * n_tiles; ++i) {
      const int s = i % L::kStages;
      const int ph = (i / L::kStages) & 1;
      const int k0 = (i - it * n_tiles) * kWgKeys;
      mbar_wait(full_k(s), ph);
      __syncwarp();   // wgmma is .aligned: the warp converged after its spin
      if (wg_active && k0 < wg_kend) {
        // S = q k^T: 64 rows x 128 keys, HDR / 16 steps of 16
        const uint32_t k_base = base + L::kK + s * L::kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const uint32_t off = (kc & 3) * 32;   // 16 bf16 along the swizzled row
          wgmma_ss_n128(sc, sw128_desc(q_base + (kc >> 2) * L::kQPanel + off, 16, kSwAtom),
                        sw128_desc(k_base + (kc >> 2) * L::kKVPanel + off, 16, kSwAtom), kc > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        // scale into the exp2 domain; mask only where the tile crosses kv_len
        // or the diagonal of this warp's rows
        const bool need_mask =
            k0 + kWgKeys > kv_len || (causal && k0 + kWgKeys - 1 > q_offset + row0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * nt + e] * scale_log2;
            if (need_mask) {
              const int key = k0 + nt * 8 + 2 * t + (e & 1);
              const int qpos = q_offset + (e < 2 ? r_lo : r_hi);
              if (key >= kv_len || (causal && key > qpos)) x = -INFINITY;
            }
            sc[4 * nt + e] = x;
          }
        }
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
          mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
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
        const float alpha_lo = ex2(m_lo - base_lo);
        const float alpha_hi = ex2(m_hi - base_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        l_lo *= alpha_lo;
        l_hi *= alpha_hi;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          acc[4 * dt] *= alpha_lo;
          acc[4 * dt + 1] *= alpha_lo;
          acc[4 * dt + 2] *= alpha_hi;
          acc[4 * dt + 3] *= alpha_hi;
        }
        // p in f32 for the row sums; rounded once to bf16 for P.V, as the TPU
        // kernel's p.astype(v.dtype); the A fragments of 16-key chunk kc are
        // the scores of 8-key tiles 2 kc and 2 kc + 1
        uint32_t pa[kWgKeys / 16][4];
#pragma unroll
        for (int kc = 0; kc < kWgKeys / 16; ++kc) {
          float p[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) p[e] = ex2(sc[8 * kc + e] - ((e & 2) ? base_hi : base_lo));
          l_lo += p[0] + p[1] + p[4] + p[5];
          l_hi += p[2] + p[3] + p[6] + p[7];
          pa[kc][0] = as_u32(__floats2bfloat162_rn(p[0], p[1]));
          pa[kc][1] = as_u32(__floats2bfloat162_rn(p[2], p[3]));
          pa[kc][2] = as_u32(__floats2bfloat162_rn(p[4], p[5]));
          pa[kc][3] = as_u32(__floats2bfloat162_rn(p[6], p[7]));
        }
        // O += P . V: V's tile is the MN-major B operand, 16 keys (two 8-row
        // groups) a step, its HD columns across the panels
        mbar_wait(full_v(s), ph);
        __syncwarp();
        const uint32_t v_base = base + L::kV + s * L::kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kWgKeys / 16; ++kc)
          wgmma_pv<HD>(acc, pa[kc], sw128_desc(v_base + kc * 2 * kSwAtom, L::kKVPanel, kSwAtom));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      } else {
        mbar_wait(full_v(s), ph);   // keeps every warp's arrivals in the tile's round
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    if (lane == 0) mbar_arrive(q_empty(qb));   // this round's q is read
    if (!wg_active) return;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    // a row with no visible key gives 0/0, as the plain softmax does
    const float inv_lo = 1.f / l_lo;
    const float inv_hi = 1.f / l_hi;
    __nv_bfloat16* ob = o + bi * os.b + head * os.h;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = 8 * dt + 2 * t;
      if (r_lo < sq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(r_lo) * os.s + d) =
            __floats2bfloat162_rn(acc[4 * dt] * inv_lo, acc[4 * dt + 1] * inv_lo);
      }
      if (r_hi < sq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(r_hi) * os.s + d) =
            __floats2bfloat162_rn(acc[4 * dt + 2] * inv_hi, acc[4 * dt + 3] * inv_hi);
      }
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

// A (batch, head, position, hd) bf16 view as a 4-d tensor map (hd, position,
// head, batch): boxes of 64 hd x `rows` positions, 128-byte swizzled;
// positions at or past `len` read as zero.  False where libcuda refuses it.
bool tensor_map(CUtensorMap* map, const void* p, const Strides& st, int nb, int nh, int len,
                int hd, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  // an axis of extent 1 is never stepped: it takes any stride the map allows
  auto bytes = [](long long stride, int extent) -> cuuint64_t {
    return extent > 1 ? static_cast<cuuint64_t>(stride) * sizeof(__nv_bfloat16) : 16;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(nh), static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[3] = {bytes(st.s, len), bytes(st.h, nh), bytes(st.b, nb)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma routes at NC consumer warpgroups: 64 NC query rows of a head a
// block, or with STACK 64 query rows of NC heads of one KV group a block;
// sets `refused` where a tensor map cannot be made or a block's heads would
// span two KV groups.
template <int HD, int NC, int HDR = HD, bool STACK = false>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream, bool& refused, int iters = 1) {
  using L = WgLayout<HD, NC, STACK ? 2 : 1>;
  CUtensorMap tq, tk, tv;
  refused = (STACK && (iters < 1 || (a.h / a.g) % (NC * iters) != 0)) ||
            !(tensor_map(&tq, a.q, a.qs, a.b, a.h, a.sq, HDR, kWgRows) &&
              tensor_map(&tk, a.k, a.ks, a.b, a.g, a.kv_len, HDR, kWgKeys) &&
              tensor_map(&tv, a.v, a.vs, a.b, a.g, a.kv_len, HDR, kWgKeys));
  if (refused) return cudaSuccess;
  static unsigned raised = 0;
  const cudaError_t err =
      allow_smem(flash_attention_wgmma_kernel<HD, NC, HDR, STACK>, L::kBytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid = STACK ? dim3((a.sq + kWgRows - 1) / kWgRows, a.h / (NC * iters), a.b)
                          : dim3((a.sq + NC * kWgRows - 1) / (NC * kWgRows), a.h, a.b);
  flash_attention_wgmma_kernel<HD, NC, HDR, STACK><<<grid, L::kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.os, a.h / a.g, a.sq, a.scale_log2,
      a.causal, a.q_offset, a.kv_len, STACK ? iters : 1);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma_rows(const Args& a, int rows, cudaStream_t stream, bool& refused) {
  if (rows == 64) return launch_wgmma<HD, 1>(a, stream, refused);
  if (rows == 128) return launch_wgmma<HD, 2>(a, stream, refused);
  if constexpr (HD == 64) {
    if (rows == 192) return launch_wgmma<HD, 3>(a, stream, refused);
  }
  refused = true;
  return cudaSuccess;
}

// The head-stacked route at hd 112 or 128: `rows` = 64 x the heads a block
// holds at once (its consumer warpgroups), `heads` the heads it walks
template <int HDR>
cudaError_t launch_stacked(const Args& a, int rows, int heads, cudaStream_t stream,
                           bool& refused) {
  if (rows == 64) return launch_wgmma<128, 1, HDR, true>(a, stream, refused, heads);
  if (rows == 128 && heads % 2 == 0)
    return launch_wgmma<128, 2, HDR, true>(a, stream, refused, heads / 2);
  refused = true;
  return cudaSuccess;
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
// route 0 = the mma.sync design (bf16) or the f32 kernel, 1 = the bf16 wgmma
// route, hd 64 or 128, kv_len >= 1, with `rows` = 64 or 128 query rows a block
// (192 at hd 64), 2 = the bf16 head-stacked wgmma route, hd 112 or 128,
// kv_len >= 1, with `rows` = 64 x the heads a block holds at once (1 or 2)
// and `heads` the heads it walks (a multiple of those, dividing H / G).
// Returns a cudaError_t, kMisaligned where a bf16 row does not start on a
// 16-byte boundary, or kRefused where the wgmma route does not take the call
// (its width, its rows, an empty cache, a block's heads across two KV groups,
// or a tensor map libcuda refuses).
constexpr int kMisaligned = -1;
constexpr int kRefused = -2;

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int dtype, int b, int h,
                                      int g, int sq, int hd, float scale, int causal,
                                      int q_offset, int kv_len, int route, int rows,
                                      int heads, void* stream) {
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
  if (route == 1) {
    bool refused = true;
    err = cudaSuccess;
    if (dtype == 1 && kv_len >= 1) {
      if (hd == 64) err = launch_wgmma_rows<64>(a, rows, s, refused);
      if (hd == 128) err = launch_wgmma_rows<128>(a, rows, s, refused);
    }
    return refused ? kRefused : static_cast<int>(err);
  }
  if (route == 2) {
    bool refused = true;
    err = cudaSuccess;
    if (dtype == 1 && kv_len >= 1) {
      if (hd == 112) err = launch_stacked<112>(a, rows, heads, s, refused);
      if (hd == 128) err = launch_stacked<128>(a, rows, heads, s, refused);
    }
    return refused ? kRefused : static_cast<int>(err);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
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
