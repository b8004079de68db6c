// Table-GEMV kernels of the application-BEHAV engine, for Hopper (sm_90a).
//
// Both compute a batched integer matmul in which every multiply is a lookup
// through one approximate-multiplier config:
//
//   out[d, m, n] = sum_k P_d(a[m, k], b[k, n])      (D, M, N) int32
//
// with config-shared operand codes a (M, K) and b (K, N).  Each is launched
// through a plain C function (bound from Python with ctypes, see
// kernels/app_kernels.py, whose plan() picks K4's route by shape):
//
//   table_gemv  (K4) replaces repro/kernels/app_kernels.py table_gemv_pallas:
//               P_d(a, b) = T_d[a * B + b] from the (D, A*B) flattened
//               product tables.  Two routes:
//     staged    one block per config holds its table in shared memory and
//               computes all of the config's outputs from it;
//     gather    (the first design, kept for shapes with few lookups per
//               table entry) one block per (config, M-tile) gathers the table
//               through the read-only path.
//   entry_gemv  (K5) replaces entry_gemv_pallas: P_d is synthesized from the
//               (D, R) config masks -- the block builds its config's (R, 4, B)
//               planes in shared memory (planes.cuh, shared with K2) and sums
//               sum_r planes[r][pair_r(a)][b] << 2r.
//
// Codes are taken modulo 2^n_bits, so every lookup stays inside its table.
// int32 accumulation is exact: |P| < 2^16 at 8 bits and the wrapper checks
// K <= 2^14.
//
// K4's staged route.  At 8 bits a table is 65,536 int32 = 256 KiB, more than
// the 227 KiB of shared memory a block may use, and |P| reaches 512 * 85 =
// 43,520 > 2^15, so it cannot be held as int16.  So the block stages it in
// two passes of 128 rows (128 KiB), split by the a-code's top bit, and each
// pass performs only the lookups whose a-code falls in its half; a pass that
// no a-code needs is skipped (a first grid, pack_codes, records which halves
// the codes use).  That grid also packs the codes as uint8: A as (M_pad,
// K_pad) with rows zero-padded to whole 32-row slabs and K to whole 16-code
// chunks, B transposed as (N, K_pad).  The block keeps B's codes in shared
// memory and streams A in tiles of whole slabs with cp.async, double-
// buffered (a block barrier only where a round brings a new tile).  A warp
// owns one (slab, column) item a round: lane l computes out[32 s + l, n], so
// the 32 lanes of a lookup share b[k, n] and differ in a.  The table is
// stored XOR-swizzled, entry (a, b) at row a, column b ^ a, so lanes with
// one b and different a fall in bank (a ^ b) mod 32 and lanes with one a
// and b read one word; random codes then cost ~3.5 bank wavefronts a warp
// lookup.  A lane sums its item's K in a register and adds the sum to the
// config's sums, held in shared memory column-major (a warp's 32 rows in
// consecutive banks) through both passes; the block writes them out
// coalesced at the end.  Padded K reads T(0, 0) and is subtracted once from
// the first pass.
//
// The launcher computes the shared-memory layout (staged_layout) from (M, K,
// N, n_bits) and refuses a shape whose layout exceeds the 227 KiB a block may
// use or whose scratch buffer is too small; plan() in Python mirrors the size
// only to choose the route.
//
// What bounds it on the H100: the shared-memory gather, one 4-byte word per
// bank per clock (32 lookups per SM per clock at best, fewer with bank
// conflicts), beside ~7 issued instructions a lookup (byte select, index
// swizzle, half test, address, load, add; in the SASS of nvcc 12.9's sm_90a
// build, read by kernels/sass.py, a 16-lookup chunk is 111 instructions with
// the half test and 115 without) and, where both halves are
// needed, the second pass's issue.  Staging a table costs 256 KiB per config,
// which is why shapes with few lookups per table entry keep the gather route.
// A 2-CTA cluster (a table half a CTA, the other half read through
// distributed shared memory) was measured against this design and dropped:
// distributed shared memory serves scattered words far more slowly than a
// second local pass (PERF.md, section 6).
//
// K4's gather route (first design) gathers the table through L1 and L2:
// every warp lookup is a divergent global load of ~32 cache lines, ~1.1
// lookups per SM per clock.  K5 reads nothing but its codes and masks; it is
// bound by integer instruction throughput, ~R x 3 ALU operations per lookup
// (index add, shift, accumulate per row) plus the synthesis, which every
// M-tile block of a config repeats.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

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

// ---- K4, staged route --------------------------------------------------

constexpr int kPackThreads = 256;
constexpr int kStagedThreads = 512;
constexpr int kStagedWarps = kStagedThreads / 32;
constexpr int kSlab = 32;    // A rows a slab: one per lane
constexpr int kChunk = 16;   // codes a 16-byte shared-memory load
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block may use
constexpr int kPackBlocks = 128;         // most blocks of the packing grid

// The staged route's layout for (M, K, N) codes of n_bits bits.  Shared
// memory, in bytes from its start: the pass's table (kRows x B int32), the
// config's sums (N x ostride int32, column-major, ostride = M_pad + 1 odd:
// conflict-free transposed reads), B's codes (N x K_pad bytes) and two A
// tiles of slab_cap slabs of 32 rows (row stride sa, an odd multiple of 16
// bytes: conflict-free 16-byte loads).  A round's 16 items span at most
// 15 / N + 2 slabs.  Scratch (global): A's codes (M_pad x K_pad bytes), B's
// (N x K_pad), then one int of flags a packing block.
struct StagedLayout {
  int m_pad, k_pad, sa, slab_cap, ostride, pack_blocks;
  size_t osh, bsh, tile0, tile1, smem;
  size_t bt8, flags, scratch;
};

size_t round_up(size_t x, size_t to) { return (x + to - 1) / to * to; }

StagedLayout staged_layout(int m, int k, int n, int n_bits) {
  StagedLayout L;
  const int slabs = (m + kSlab - 1) / kSlab;
  L.m_pad = slabs * kSlab;
  L.k_pad = (k + kChunk - 1) / kChunk * kChunk;
  L.sa = L.k_pad + kChunk * (1 - (L.k_pad / kChunk) % 2);
  L.slab_cap = std::min(slabs, (kStagedWarps - 1) / n + 2);
  L.ostride = L.m_pad + 1;
  L.pack_blocks = static_cast<int>(std::min<long long>(
      kPackBlocks,
      (static_cast<long long>(L.m_pad + n) * L.k_pad + 255) / 256));
  const size_t pass_ints = static_cast<size_t>(std::min(1 << n_bits, 128)) << n_bits;
  L.osh = pass_ints * 4;
  L.bsh = L.osh + round_up(static_cast<size_t>(n) * L.ostride, 4) * 4;
  L.tile0 = L.bsh + round_up(static_cast<size_t>(n) * L.k_pad, 16);
  L.tile1 = L.tile0 + static_cast<size_t>(L.slab_cap) * kSlab * L.sa;
  L.smem = L.tile1 + static_cast<size_t>(L.slab_cap) * kSlab * L.sa;
  L.bt8 = static_cast<size_t>(L.m_pad) * L.k_pad;
  L.flags = L.bt8 + round_up(static_cast<size_t>(n) * L.k_pad, 16);
  L.scratch = L.flags + static_cast<size_t>(L.pack_blocks) * sizeof(int);
  return L;
}

// Pack the codes as uint8, modulo 2^n_bits: a (M, K) -> a8 (M_pad, K_pad),
// b (K, N) -> bt8 (N, K_pad), zero-padded.  flags[block] gets bit h set if
// any of the block's A bytes (padding included) has top-bit half h.
__global__ void __launch_bounds__(kPackThreads)
pack_codes_kernel(const int* __restrict__ a, const int* __restrict__ b,
                  uint8_t* __restrict__ a8, uint8_t* __restrict__ bt8,
                  int* __restrict__ flags, int m, int k, int n, int m_pad,
                  int k_pad, int code_mask) {
  __shared__ int s_bits;
  if (threadIdx.x == 0) s_bits = 0;
  __syncthreads();
  const long long total_a = static_cast<long long>(m_pad) * k_pad;
  const long long total = total_a + static_cast<long long>(n) * k_pad;
  int bits = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < total_a) {
      const int row = static_cast<int>(i / k_pad);
      const int col = static_cast<int>(i - static_cast<long long>(row) * k_pad);
      const int v = row < m && col < k
                        ? a[static_cast<size_t>(row) * k + col] & code_mask
                        : 0;
      a8[i] = static_cast<uint8_t>(v);
      bits |= 1 << (v >> 7);
    } else {
      const long long j = i - total_a;
      const int nn = static_cast<int>(j / k_pad);
      const int col = static_cast<int>(j - static_cast<long long>(nn) * k_pad);
      bt8[j] = static_cast<uint8_t>(
          col < k ? b[static_cast<size_t>(col) * n + nn] & code_mask : 0);
    }
  }
  if (bits) atomicOr(&s_bits, bits);
  __syncthreads();
  if (threadIdx.x == 0) flags[blockIdx.x] = s_bits;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Slabs [lo, hi] that round r's kStagedWarps items (slab-major: item = s * n
// + column) touch.
__device__ __forceinline__ int2 round_slabs(int r, int n, int slabs) {
  const int first = r * kStagedWarps;
  return make_int2(first / n, min((first + kStagedWarps - 1) / n, slabs - 1));
}

// cp.async the A rows of slabs [lo, hi] (global row stride k_pad) into a
// tile with row stride sa.
__device__ __forceinline__ void issue_tile(const uint8_t* __restrict__ a8,
                                           uint8_t* tile, int2 sl, int k_pad,
                                           int sa) {
  const int chunks = k_pad / kChunk;
  const int rows = (sl.y - sl.x + 1) * kSlab;
  const uint8_t* src = a8 + static_cast<size_t>(sl.x) * kSlab * k_pad;
  for (int i = threadIdx.x; i < rows * chunks; i += kStagedThreads) {
    const int row = i / chunks;
    const int c = i - row * chunks;
    cp_async16(tile + row * sa + c * kChunk,
               src + static_cast<size_t>(row) * k_pad + c * kChunk);
  }
}

// Table rows [h * kRows, (h + 1) * kRows) of config tab into shared memory,
// entry (a, b) at (a - h * kRows) * B + (b ^ a).  Chunks of 4 entries keep
// their 16-byte slot (b ^ (a & ~3)); a & 3 permutes within it.
template <int NB>
__device__ __forceinline__ void stage_table(const int* __restrict__ tab,
                                            int* tsh, int h) {
  constexpr int B = 1 << NB;
  constexpr int kRows = B > 128 ? 128 : B;
  constexpr int kChunks = kRows * B / 4;
  const int4* src = reinterpret_cast<const int4*>(tab + h * kRows * B);
#pragma unroll 4
  for (int c = threadIdx.x; c < kChunks; c += kStagedThreads) {
    int4 v = __ldg(src + c);
    const int e = c * 4;
    const int al = e >> NB;
    const int a = h * kRows + al;
    const int b0 = e & (B - 1);
    if (a & 1) {
      const int t0 = v.x, t2 = v.z;
      v.x = v.y; v.y = t0; v.z = v.w; v.w = t2;
    }
    if (a & 2) {
      const int t0 = v.x, t1 = v.y;
      v.x = v.z; v.y = v.w; v.z = t0; v.w = t1;
    }
    *reinterpret_cast<int4*>(tsh + (al << NB) + (b0 ^ (a & (B - 1) & ~3))) = v;
  }
}

// Index in the staged pass of lookup (a, b) = byte q of aw, bw, with
// cw = aw ^ bw.  NB = 8: (a << 8 | (a ^ b)) ^ (h << 15), in [0, 32768)
// exactly when a falls in pass h's half.
template <int NB, int Q>
__device__ __forceinline__ unsigned pass_index(unsigned aw, unsigned cw,
                                               unsigned hbias) {
  if constexpr (NB == 8) {
    return (__byte_perm(cw, aw, Q | ((Q + 4) << 4)) ^ hbias) & 0xFFFFu;
  } else {
    const unsigned a = (aw >> (8 * Q)) & 0xFFu;
    const unsigned c = (cw >> (8 * Q)) & 0xFFu;
    return (a << NB) | c;
  }
}

// 16 lookups of one lane: codes a, b at k0 .. k0 + 15.  kCheck (both
// halves in use): only the lookups that fall in the pass's half.
template <int NB, bool kCheck>
__device__ __forceinline__ unsigned lookup16(const int* tsh, uint4 av, uint4 bv,
                                             unsigned hbias) {
  constexpr unsigned kPassInts = (NB == 8 ? 128u : (1u << NB)) << NB;
  const unsigned aw[4] = {av.x, av.y, av.z, av.w};
  const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};
  unsigned acc = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const unsigned cw = aw[w] ^ bw[w];
    const unsigned idx[4] = {pass_index<NB, 0>(aw[w], cw, hbias),
                             pass_index<NB, 1>(aw[w], cw, hbias),
                             pass_index<NB, 2>(aw[w], cw, hbias),
                             pass_index<NB, 3>(aw[w], cw, hbias)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!kCheck || idx[q] < kPassInts) acc += static_cast<unsigned>(tsh[idx[q]]);
    }
  }
  return acc;
}

// The sum over K of one lane's lookups in pass h.
template <int NB, bool kCheck>
__device__ __forceinline__ unsigned lane_sum(const int* tsh, const uint8_t* arow,
                                             const uint8_t* brow, int k_pad,
                                             unsigned hbias) {
  unsigned sum = 0;
  for (int k0 = 0; k0 < k_pad; k0 += kChunk) {
    sum += lookup16<NB, kCheck>(tsh, *reinterpret_cast<const uint4*>(arow + k0),
                                *reinterpret_cast<const uint4*>(brow + k0), hbias);
  }
  return sum;
}

// One block per config, in staged_layout's shared memory (a warp's 32 rows
// of sums are consecutive words).  A warp computes one (slab, column) item a
// round and adds each pass's sums in shared memory; the block then writes
// them out coalesced.
template <int NB>
__global__ void __launch_bounds__(kStagedThreads, 1)
table_gemv_staged_kernel(const int* __restrict__ tables,
                         const uint8_t* __restrict__ a8,
                         const uint8_t* __restrict__ bt8,
                         const int* __restrict__ flags, int* __restrict__ out,
                         int m, int k, int n, StagedLayout L) {
  constexpr int B = 1 << NB;
  constexpr int kRows = B > 128 ? 128 : B;
  constexpr int kPasses = B / kRows;
  extern __shared__ int4 smem4[];  // 16-byte aligned: no static shared memory
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  int* tsh = reinterpret_cast<int*>(smem);
  int* osh = reinterpret_cast<int*>(smem + L.osh);
  uint8_t* bsh = smem + L.bsh;
  uint8_t* tile0 = smem + L.tile0;
  uint8_t* tile1 = smem + L.tile1;
  const int k_pad = L.k_pad, sa = L.sa, ostride = L.ostride;
  const int pack_blocks = L.pack_blocks;
  const int slabs = L.m_pad / kSlab;

  const int d = blockIdx.x;
  const int* tab = tables + (static_cast<size_t>(d) << (2 * NB));
  int* out_d = out + static_cast<size_t>(d) * m * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int items = slabs * n;
  const int rounds = (items + kStagedWarps - 1) / kStagedWarps;
  const unsigned pad_k = static_cast<unsigned>(k_pad - k);

  int used = 0;  // halves the A codes fall in
  for (int i = threadIdx.x; i < pack_blocks; i += kStagedThreads) used |= flags[i];
  const bool has0 = __syncthreads_or(used & 1);
  const bool has1 = __syncthreads_or(used & 2);
  const bool check = has0 && has1;

  for (int i = threadIdx.x; i < n * k_pad / kChunk; i += kStagedThreads) {
    cp_async16(bsh + i * kChunk, bt8 + i * kChunk);
  }
  for (int i = threadIdx.x; i < n * ostride; i += kStagedThreads) osh[i] = 0;
  for (int h = 0; h < kPasses; ++h) {
    if (!(h == 0 ? has0 : has1)) continue;
    __syncthreads();  // the previous pass is done with the table and the tiles
    bool cur = false;
    bool fresh = true;  // this round's tile (the first time, the table) is new
    int2 sl = round_slabs(0, n, slabs);
    issue_tile(a8, tile0, sl, k_pad, sa);
    cp_async_commit();
    stage_table<NB>(tab, tsh, h);
    const unsigned hbias = static_cast<unsigned>(h) << 15;
    for (int r = 0; r < rounds; ++r) {
      const int2 nsl = round_slabs(r + 1, n, slabs);
      const bool next = r + 1 < rounds && (nsl.x != sl.x || nsl.y != sl.y);
      if (next) {
        issue_tile(a8, cur ? tile0 : tile1, nsl, k_pad, sa);
        cp_async_commit();
      }
      if (fresh) {
        if (next) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // the tile (and the first time, the table) is in
      }
      const int item = r * kStagedWarps + warp;
      if (item < items) {
        const int s = item / n;
        const int nn = item - s * n;
        const uint8_t* arow = (cur ? tile1 : tile0) + ((s - sl.x) * kSlab + lane) * sa;
        const uint8_t* brow = bsh + nn * k_pad;
        unsigned acc = check ? lane_sum<NB, true>(tsh, arow, brow, k_pad, hbias)
                             : lane_sum<NB, false>(tsh, arow, brow, k_pad, hbias);
        // padded K looked up T(0, 0), which only the first half holds
        if (h == 0) acc -= pad_k * static_cast<unsigned>(tsh[0]);
        osh[nn * ostride + s * kSlab + lane] += static_cast<int>(acc);
      }
      fresh = next;
      if (next) {
        __syncthreads();  // every warp is done with this tile before it is reused
        cur = !cur;
        sl = nsl;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * n; i += kStagedThreads) {
    const int row = i / n;
    out_d[i] = osh[(i - row * n) * ostride + row];
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

// Bytes of scratch the staged route needs for (M, K, N) codes.
extern "C" long long table_gemv_staged_scratch(int m, int k, int n, int n_bits) {
  return static_cast<long long>(staged_layout(m, k, n, n_bits).scratch);
}

// Refuses (cudaErrorInvalidValue) codes of other than 2..8 bits, a layout
// over kMaxSmem and a scratch buffer smaller than the layout needs.
extern "C" int table_gemv_staged_launch(const void* tables, const void* a,
                                        const void* b, void* scratch,
                                        long long scratch_bytes, void* out,
                                        int d, int m, int k, int n, int n_bits,
                                        void* stream) {
  if (n_bits < 2 || n_bits > 8 || m < 1 || k < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const StagedLayout L = staged_layout(m, k, n, n_bits);
  if (L.smem > kMaxSmem || scratch_bytes < static_cast<long long>(L.scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* a8 = static_cast<uint8_t*>(scratch);
  uint8_t* bt8 = a8 + L.bt8;
  int* flags = reinterpret_cast<int*>(a8 + L.flags);
  pack_codes_kernel<<<L.pack_blocks, kPackThreads, 0, st>>>(
      static_cast<const int*>(a), static_cast<const int*>(b), a8, bt8, flags, m,
      k, n, L.m_pad, L.k_pad, (1 << n_bits) - 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_bits) {
#define K4_STAGED(NB)                                                         \
  case NB: {                                                                  \
    err = allow_smem(table_gemv_staged_kernel<NB>, L.smem);                   \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    table_gemv_staged_kernel<NB><<<d, kStagedThreads, L.smem, st>>>(          \
        static_cast<const int*>(tables), a8, bt8, flags,                      \
        static_cast<int*>(out), m, k, n, L);                                  \
    break;                                                                    \
  }
    K4_STAGED(2)
    K4_STAGED(3)
    K4_STAGED(4)
    K4_STAGED(5)
    K4_STAGED(6)
    K4_STAGED(7)
    K4_STAGED(8)
#undef K4_STAGED
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
