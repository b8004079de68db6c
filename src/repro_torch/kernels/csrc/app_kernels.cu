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
//               (D, R) config masks.  K4's staged structure over the
//               config's nibble planes (below), built in shared memory by
//               the block itself.  Its first design (entry_gemv_first, kept
//               for the comparison on the card): a block per (config, 32-row
//               tile) builds the (R, 4, B) planes bit by bit (planes.cuh,
//               shared with K2) and sums sum_r planes[r][pair_r(a)][b] << 2r.
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
// lookups per SM per clock.
//
// K5.  A config's rows fold pairwise into nibble planes: plane q holds, for
// the 16 values nu of a's nibble q, sum over rows 2q, 2q + 1 of
// planes[r][pair_r(nu << 4q)][b] << 2(r - 2q) (with an odd row count the
// last plane is the last row's 4 entries), so a product is
// sum_q plane_q[(a >> 4q) & 15][b] << 4q: two lookups at 8 bits, no bit-pair
// extraction.  At 8 bits the planes take 2 x 16 x 256 int32 = 32 KiB, so one
// pass holds them, and the block builds them itself from the masks in
// closed form (rowplanes::Column: one masked add a plane value, no bit
// loop).  The codes are packed by K4's packing grid (no halves' flags); the
// block keeps B's codes in shared memory, streams A in 32-row slabs and
// sums in shared memory exactly as K4's staged route does (staged_pass is
// shared).  Entry (nu, b) sits at row nu, column b ^ nu: the lanes of a
// lookup share b, so lanes with different nu fall in 16 distinct banks and
// lanes with one nu read one word -- no bank conflicts.  A 16-code chunk
// takes, per 4-code word and plane, the nibbles (one and, or a shift and an
// and), their columns (one xor) and per code a byte permute that forms
// (nu << 8) | (b ^ nu), the load and the add.  Zero codes pad M and K: plane
// row 0 is 0 for every b, so padding adds nothing.  Where D is below the
// SM count the launcher splits a config's slabs over up to n_sms / D blocks
// (each builds its own planes, a few microseconds), and further where the
// block's sums would not fit; it refuses a layout over 227 KiB even at one
// slab a block.  What bounds it: the shared-memory words, 2 a product at
// one word a bank a clock, beside the issued instructions: in the SASS of
// nvcc 12.9's sm_90a build (kernels/sass.py) a 16-code chunk is 139
// instructions with 34 shared-memory loads (its 32 lookups and the two
// 16-byte code loads): per lookup a byte permute, an address LEA and the
// load, an add per two lookups (IADD3), 8.7 a product; 64 registers, no
// spills.
//
// K5 at 12 bits (entry_gemv_wide).  A config's nibble planes there are 3 x
// 16 x 4,096 int32 = 768 KiB, over the 227 KiB a block may use, so the block
// builds them per product slot instead of per b code: for each chunk of kc
// K-codes it synthesizes, in closed form (rowplanes::Column), the 3 x 16
// plane values of each of the chunk's kc x N b-codes b[k, n] into shared
// memory (kc x N x 3 x 16 int32: 120 KiB at the mnist head, N = 10, kc = 64;
// 192 KiB at the ffn GEMM1, N = 128, kc = 8), then reuses them across all of
// its rows: a product is sum_q slot[q][(a >> 4q) & 15] << 4q, 3 lookups.  A
// warp owns one (32-row slab, column) item a chunk, lane l row 32 s + l, so
// the lanes of a lookup share the slot and read 16 distinct words (a slot's
// 16 values sit XOR-swizzled by the slot's index, which also spreads the
// synthesis's stores over the banks).  A codes are read as given (int32,
// modulo 2^12), from the caches; a lane's sum over a chunk is added to its
// output in device memory (only that lane touches it).  Sums are int32
// modulo 2^32, as the reference's are: wrapping addition does not depend on
// order, so the result equals the plain version bit for bit whatever the
// order.  Where D is below twice the SM count the launcher splits a config's
// slabs over blocks, each synthesizing the slots again.  What bounds it: a
// shared-memory word a lookup, one lookup a product at best (the bound the
// K5 record counts), beside the synthesis: per slot 2 rows x 4 closed-form
// values and 16 stores, once per block.  This first 12-bit design is
// correct first; its time stands in PERF.md.

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
entry_gemv_first_kernel(const int* __restrict__ masks, const int* __restrict__ a,
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

// The staged layout of a block that owns spb 32-row slabs of (M, K, N) codes
// and holds table_ints int32 of table (K4: one pass; K5: the nibble planes).
// Shared memory, in bytes from its start: the table, the block's sums (N x
// ostride int32, column-major, ostride = 32 spb + 1 odd: conflict-free
// transposed reads), B's codes (N x K_pad bytes) and two A tiles of slab_cap
// slabs of 32 rows (row stride sa, an odd multiple of 16 bytes: conflict-
// free 16-byte loads).  A round's 16 items span at most 15 / N + 2 slabs.
// Scratch (global): A's codes (M_pad x K_pad bytes), B's (N x K_pad), then
// one int of flags a packing block.  K4 gives a block every slab (splits =
// 1); K5 may split a config's slabs over several blocks.
struct StagedLayout {
  int m_pad, k_pad, sa, slab_cap, ostride, pack_blocks, spb, splits;
  size_t osh, bsh, tile0, tile1, smem;
  size_t bt8, flags, scratch;
};

size_t round_up(size_t x, size_t to) { return (x + to - 1) / to * to; }

StagedLayout staged_layout(int m, int k, int n, size_t table_ints, int spb) {
  StagedLayout L;
  const int slabs = (m + kSlab - 1) / kSlab;
  L.m_pad = slabs * kSlab;
  L.k_pad = (k + kChunk - 1) / kChunk * kChunk;
  L.sa = L.k_pad + kChunk * (1 - (L.k_pad / kChunk) % 2);
  L.spb = std::min(spb, slabs);
  L.splits = (slabs + L.spb - 1) / L.spb;
  L.slab_cap = std::min(L.spb, (kStagedWarps - 1) / n + 2);
  L.ostride = L.spb * kSlab + 1;
  L.pack_blocks = static_cast<int>(std::min<long long>(
      kPackBlocks,
      (static_cast<long long>(L.m_pad + n) * L.k_pad + 255) / 256));
  L.osh = table_ints * 4;
  L.bsh = L.osh + round_up(static_cast<size_t>(n) * L.ostride, 4) * 4;
  L.tile0 = L.bsh + round_up(static_cast<size_t>(n) * L.k_pad, 16);
  L.tile1 = L.tile0 + static_cast<size_t>(L.slab_cap) * kSlab * L.sa;
  L.smem = L.tile1 + static_cast<size_t>(L.slab_cap) * kSlab * L.sa;
  L.bt8 = static_cast<size_t>(L.m_pad) * L.k_pad;
  L.flags = L.bt8 + round_up(static_cast<size_t>(n) * L.k_pad, 16);
  L.scratch = L.flags + static_cast<size_t>(L.pack_blocks) * sizeof(int);
  return L;
}

// K4's layout: a table pass of up to 128 rows, every slab in one block.
StagedLayout table_layout(int m, int k, int n, int n_bits) {
  const size_t pass_ints = static_cast<size_t>(std::min(1 << n_bits, 128)) << n_bits;
  return staged_layout(m, k, n, pass_ints, (m + kSlab - 1) / kSlab);
}

// Pack the codes as uint8, modulo 2^n_bits: a (M, K) -> a8 (M_pad, K_pad),
// b (K, N) -> bt8 (N, K_pad), zero-padded.  flags[block] gets bit h set if
// any of the block's A bytes (padding included) has top-bit half h (K4;
// K5 passes no flags).
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
  if (flags == nullptr) return;  // K5: no table halves
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

// The shared memory of a staged block, carved as staged_layout lays it out.
struct StagedSmem {
  int* tsh;
  int* osh;
  uint8_t* bsh;
  uint8_t* tile0;
  uint8_t* tile1;
};

__device__ __forceinline__ StagedSmem staged_smem(int4* smem4, const StagedLayout& L) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  return {reinterpret_cast<int*>(smem), reinterpret_cast<int*>(smem + L.osh),
          smem + L.bsh, smem + L.tile0, smem + L.tile1};
}

// B's codes into shared memory (cp.async, completed with the first tile's
// group) and the block's sums zeroed.
__device__ __forceinline__ void stage_b_and_zero(const uint8_t* __restrict__ bt8,
                                                 const StagedSmem& S,
                                                 const StagedLayout& L, int n) {
  for (int i = threadIdx.x; i < n * L.k_pad / kChunk; i += kStagedThreads) {
    cp_async16(S.bsh + i * kChunk, bt8 + i * kChunk);
  }
  for (int i = threadIdx.x; i < n * L.ostride; i += kStagedThreads) S.osh[i] = 0;
}

// One pass of a staged block over its slabs (a8 points at the first; slabs
// of them): prepare() fills the table while the first A tile is in flight,
// then each warp computes one (slab, column) item a round, lane l row 32 s
// + l, and adds lane_sum(A row, B column) to the block's sums.  The tiles
// are double-buffered; a block barrier only where a round brings a new tile.
template <class Prepare, class LaneSum>
__device__ __forceinline__ void staged_pass(const uint8_t* __restrict__ a8,
                                            const StagedSmem& S,
                                            const StagedLayout& L, int n,
                                            int slabs, Prepare prepare,
                                            LaneSum lane_sum) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int items = slabs * n;
  const int rounds = (items + kStagedWarps - 1) / kStagedWarps;
  __syncthreads();  // the previous pass is done with the table and the tiles
  bool cur = false;
  bool fresh = true;  // this round's tile (the first time, the table) is new
  int2 sl = round_slabs(0, n, slabs);
  issue_tile(a8, S.tile0, sl, L.k_pad, L.sa);
  cp_async_commit();
  prepare();
  for (int r = 0; r < rounds; ++r) {
    const int2 nsl = round_slabs(r + 1, n, slabs);
    const bool next = r + 1 < rounds && (nsl.x != sl.x || nsl.y != sl.y);
    if (next) {
      issue_tile(a8, cur ? S.tile0 : S.tile1, nsl, L.k_pad, L.sa);
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
      const uint8_t* arow = (cur ? S.tile1 : S.tile0) + ((s - sl.x) * kSlab + lane) * L.sa;
      S.osh[nn * L.ostride + s * kSlab + lane] +=
          static_cast<int>(lane_sum(arow, S.bsh + nn * L.k_pad));
    }
    fresh = next;
    if (next) {
      __syncthreads();  // every warp is done with this tile before it is reused
      cur = !cur;
      sl = nsl;
    }
  }
}

// The block's sums of rows [0, rows) out to (rows, N) row-major, coalesced.
__device__ __forceinline__ void write_sums(int* __restrict__ out, const int* osh,
                                           int rows, int n, int ostride) {
  __syncthreads();
  for (int i = threadIdx.x; i < rows * n; i += kStagedThreads) {
    const int row = i / n;
    out[i] = osh[(i - row * n) * ostride + row];
  }
}

// K4: one block per config, in table_layout's shared memory (a warp's 32
// rows of sums are consecutive words), one pass per table half in use.
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
  const StagedSmem S = staged_smem(smem4, L);
  const int d = blockIdx.x;
  const int* tab = tables + (static_cast<size_t>(d) << (2 * NB));
  const unsigned pad_k = static_cast<unsigned>(L.k_pad - k);

  int used = 0;  // halves the A codes fall in
  for (int i = threadIdx.x; i < L.pack_blocks; i += kStagedThreads) used |= flags[i];
  const bool has0 = __syncthreads_or(used & 1);
  const bool has1 = __syncthreads_or(used & 2);
  const bool check = has0 && has1;

  stage_b_and_zero(bt8, S, L, n);
  for (int h = 0; h < kPasses; ++h) {
    if (!(h == 0 ? has0 : has1)) continue;
    const unsigned hbias = static_cast<unsigned>(h) << 15;
    staged_pass(
        a8, S, L, n, L.m_pad / kSlab, [&] { stage_table<NB>(tab, S.tsh, h); },
        [&](const uint8_t* arow, const uint8_t* brow) {
          unsigned acc = check ? lane_sum<NB, true>(S.tsh, arow, brow, L.k_pad, hbias)
                               : lane_sum<NB, false>(S.tsh, arow, brow, L.k_pad, hbias);
          // padded K looked up T(0, 0), which only the first half holds
          if (h == 0) acc -= pad_k * static_cast<unsigned>(S.tsh[0]);
          return acc;
        });
  }
  write_sums(out + static_cast<size_t>(d) * m * n, S.osh, m, n, L.ostride);
}

// ---- K5, staged over nibble planes ---------------------------------------

// K5's nibble planes of one config: plane q folds rows 2q and 2q + 1, entry
// nu in [0, 16) being sum over those rows of planes[r][pair_r(nu << 4q)][b]
// << 2(r - 2q); with an odd row count the last plane has the last row's 4
// entries alone.  A product is sum_q plane_q[(a >> 4q) & 15][b] << 4q: two
// lookups at 8 bits.  Entry (nu, b) sits at row nu, column b ^ nu, so for
// one b the 16 values of nu fall in 16 distinct banks (B >= 16).
template <int NB>
struct Nibbles {
  static constexpr int kB = 1 << NB;
  static constexpr int kRows = NB / 2;
  static constexpr int kPlanes = (kRows + 1) / 2;
};

// Row-pair index of the 2-bit field x: 2 * bit0 + bit1.
__device__ __forceinline__ int pair2(int x) { return ((x & 1) << 1) | ((x >> 1) & 1); }

// Every thread builds the nibble-plane entries of (plane, column) items from
// the config's masks, in closed form (rowplanes::Column).
template <int NB>
__device__ __forceinline__ void synthesize_nibbles(int* nib, const int* __restrict__ mask_row) {
  using P = Nibbles<NB>;
  for (int it = threadIdx.x; it < P::kPlanes * P::kB; it += kStagedThreads) {
    const int q = it >> NB;
    const int b = it & (P::kB - 1);
    const rowplanes::Column col(b, NB);
    const int r0 = 2 * q;
    const bool two = r0 + 1 < P::kRows;
    const int k0 = col.keep_of(__ldg(mask_row + r0));
    const int k1 = two ? col.keep_of(__ldg(mask_row + r0 + 1)) : 0;
    int v0[4], v1[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      v0[p] = col.value(p, r0 == P::kRows - 1, k0);
      v1[p] = two ? col.value(p, r0 + 1 == P::kRows - 1, k1) : 0;
    }
    int* plane = nib + q * 16 * P::kB;
#pragma unroll
    for (int nu = 0; nu < 16; ++nu) {  // unrolled: v0, v1 stay in registers
      if (two || nu < 4) {
        plane[nu * P::kB + (b ^ nu)] =
            v0[pair2(nu & 3)] + static_cast<int>(static_cast<unsigned>(v1[pair2(nu >> 2)]) << 2);
      }
    }
  }
}

// (nu << NB) | c for byte J of the nibble word nu and of c = b ^ nu: at 8
// bits one byte permute, whose upper two bytes replicate the sign of a
// nibble byte (0).
template <int NB, int J>
__device__ __forceinline__ unsigned nibble_index(unsigned nu, unsigned cw) {
  if constexpr (NB == 8) {
    unsigned r;
    asm("prmt.b32 %0, %1, %2, %3;"
        : "=r"(r)
        : "r"(cw), "r"(nu), "r"(J | ((J + 4) << 4) | ((12 + J) << 8) | ((12 + J) << 12)));
    return r;
  } else {
    return (((nu >> (8 * J)) & 0xFFu) << NB) | ((cw >> (8 * J)) & 0xFFu);
  }
}

// The sum over K of one lane's products: per 16 codes, per 4-code word and
// nibble plane, the nibbles of a, their swizzled columns and 4 lookups.
template <int NB>
__device__ __forceinline__ unsigned entry_lane_sum(const int* nib, const uint8_t* arow,
                                                   const uint8_t* brow, int k_pad) {
  using P = Nibbles<NB>;
  unsigned acc[P::kPlanes];
#pragma unroll
  for (int q = 0; q < P::kPlanes; ++q) acc[q] = 0;
  for (int k0 = 0; k0 < k_pad; k0 += kChunk) {
    const uint4 av = *reinterpret_cast<const uint4*>(arow + k0);
    const uint4 bv = *reinterpret_cast<const uint4*>(brow + k0);
    const unsigned aw[4] = {av.x, av.y, av.z, av.w};
    const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int q = 0; q < P::kPlanes; ++q) {
        const unsigned nu = (aw[w] >> (4 * q)) & 0x0F0F0F0Fu;
        const unsigned cw = bw[w] ^ nu;
        const int* plane = nib + q * 16 * P::kB;
        acc[q] += static_cast<unsigned>(plane[nibble_index<NB, 0>(nu, cw)]) +
                  static_cast<unsigned>(plane[nibble_index<NB, 1>(nu, cw)]) +
                  static_cast<unsigned>(plane[nibble_index<NB, 2>(nu, cw)]) +
                  static_cast<unsigned>(plane[nibble_index<NB, 3>(nu, cw)]);
      }
    }
  }
  unsigned sum = 0;
#pragma unroll
  for (int q = 0; q < P::kPlanes; ++q) sum += acc[q] << (4 * q);
  return sum;
}

// K5: block (d, split) synthesizes config d's nibble planes and computes the
// outputs of slabs [split * spb, split * spb + spb).  Padded codes are 0,
// and plane row 0 is 0 for every b, so padding adds nothing.
template <int NB>
__global__ void __launch_bounds__(kStagedThreads, 1)
entry_gemv_staged_kernel(const int* __restrict__ masks,
                         const uint8_t* __restrict__ a8,
                         const uint8_t* __restrict__ bt8, int* __restrict__ out,
                         int m, int n, StagedLayout L) {
  extern __shared__ int4 smem4[];
  const StagedSmem S = staged_smem(smem4, L);
  const int d = blockIdx.x;
  const int slab0 = blockIdx.y * L.spb;
  const int slabs = min(L.spb, L.m_pad / kSlab - slab0);
  stage_b_and_zero(bt8, S, L, n);
  staged_pass(
      a8 + static_cast<size_t>(slab0) * kSlab * L.k_pad, S, L, n, slabs,
      [&] { synthesize_nibbles<NB>(S.tsh, masks + static_cast<size_t>(d) * (NB / 2)); },
      [&](const uint8_t* arow, const uint8_t* brow) {
        return entry_lane_sum<NB>(S.tsh, arow, brow, L.k_pad);
      });
  const int row0 = slab0 * kSlab;
  write_sums(out + (static_cast<size_t>(d) * m + row0) * n, S.osh,
             min(slabs * kSlab, m - row0), n, L.ostride);
}

// ---- K5 at 12 bits: nibble planes per product slot ----------------------

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr size_t kWideSlotBudget = 192 * 1024;  // shared memory for a chunk's slots

template <int NB>
struct WideNibbles {
  static constexpr int kRows = NB / 2;
  static constexpr int kPlanes = (kRows + 1) / 2;
  static constexpr int kSlotInts = kPlanes * 16;  // one b code's values
};

// The chunk layout of the wide kernel for (M, K, N) at NB bits: kc K-codes a
// chunk (their slots within kWideSlotBudget), spb slabs a block.
struct WideLayout {
  int kc, spb, splits;
  size_t smem;
};

template <int NB>
WideLayout wide_layout(int d, int m, int k, int n, int n_sms) {
  WideLayout L;
  const size_t per_k = static_cast<size_t>(n) * WideNibbles<NB>::kSlotInts * sizeof(int);
  L.kc = static_cast<int>(std::min<size_t>(k, std::max<size_t>(1, kWideSlotBudget / per_k)));
  L.smem = per_k * L.kc;
  const int slabs = (m + kSlab - 1) / kSlab;
  const int want = std::min(slabs, std::max(1, (2 * n_sms + d - 1) / std::max(d, 1)));
  L.spb = (slabs + want - 1) / want;
  L.splits = (slabs + L.spb - 1) / L.spb;
  return L;
}

// Block (d, split): config d's rows of slabs [split * spb, split * spb + spb).
template <int NB>
__global__ void __launch_bounds__(kWideThreads)
entry_gemv_wide_kernel(const int* __restrict__ masks, const int* __restrict__ a,
                       const int* __restrict__ b, int* __restrict__ out, int m, int k,
                       int n, int kc, int spb) {
  using W = WideNibbles<NB>;
  constexpr int kMask = (1 << NB) - 1;
  extern __shared__ int4 smem4[];
  int* slots = reinterpret_cast<int*>(smem4);  // (kc, n, kPlanes) slots of 16
  const int d = blockIdx.x;
  const int slab0 = blockIdx.y * spb;
  const int slabs = min(spb, (m + kSlab - 1) / kSlab - slab0);
  const int* mask_row = masks + static_cast<size_t>(d) * W::kRows;
  int* out_d = out + static_cast<size_t>(d) * m * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int keep_mask[W::kRows];
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) keep_mask[r] = __ldg(mask_row + r);

  for (int k0 = 0; k0 < k; k0 += kc) {
    const int kcur = min(kc, k - k0);
    __syncthreads();  // the previous chunk's slots are read
    // the chunk's slots: item (kk, nn, q) holds plane q's 16 values at b[k0 + kk, nn]
    for (int it = threadIdx.x; it < kcur * n * W::kPlanes; it += kWideThreads) {
      const int q = it % W::kPlanes;
      const int col = it / W::kPlanes;
      const rowplanes::Column c(__ldg(b + static_cast<size_t>(k0) * n + col) & kMask, NB);
      const int r0 = 2 * q;
      const bool two = r0 + 1 < W::kRows;
      int k0m = 0, k1m = 0;
#pragma unroll
      for (int r = 0; r < W::kRows; ++r) {  // registers, not a local array index
        if (r == r0) k0m = c.keep_of(keep_mask[r]);
        if (r == r0 + 1) k1m = c.keep_of(keep_mask[r]);
      }
      int v0[4], v1[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        v0[p] = c.value(p, r0 == W::kRows - 1, k0m);
        v1[p] = two ? c.value(p, r0 + 1 == W::kRows - 1, k1m) : 0;
      }
      int* slot = slots + it * 16;
      const int sw = it & 15;
#pragma unroll
      for (int nu = 0; nu < 16; ++nu) {
        slot[nu ^ sw] =
            v0[pair2(nu & 3)] + static_cast<int>(static_cast<unsigned>(v1[pair2(nu >> 2)]) << 2);
      }
    }
    __syncthreads();
    for (int item = warp; item < slabs * n; item += kWideWarps) {
      const int s = item / n;
      const int nn = item - s * n;
      const int row = (slab0 + s) * kSlab + lane;
      if (row >= m) continue;
      const int* arow = a + static_cast<size_t>(row) * k + k0;
      unsigned acc = 0;
      for (int kk = 0; kk < kcur; ++kk) {
        const unsigned av = static_cast<unsigned>(__ldg(arow + kk)) & kMask;
        const int it0 = (kk * n + nn) * W::kPlanes;
#pragma unroll
        for (int q = 0; q < W::kPlanes; ++q) {
          const int it = it0 + q;
          const unsigned nu = (av >> (4 * q)) & 15u;
          acc += static_cast<unsigned>(slots[it * 16 + (nu ^ (it & 15))]) << (4 * q);
        }
      }
      int* o = out_d + static_cast<size_t>(row) * n + nn;
      *o = static_cast<int>(k0 == 0 ? acc : static_cast<unsigned>(*o) + acc);
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

// Bytes of scratch the staged route needs for (M, K, N) codes.
extern "C" long long table_gemv_staged_scratch(int m, int k, int n, int n_bits) {
  return static_cast<long long>(table_layout(m, k, n, n_bits).scratch);
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
  const StagedLayout L = table_layout(m, k, n, n_bits);
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

extern "C" int entry_gemv_first_launch(const void* masks, const void* a,
                                       const void* b, void* out, int rows, int d,
                                       int m, int k, int n, int n_bits, int m_tile,
                                       int k_tile, void* stream) {
  const size_t smem =
      static_cast<size_t>(rows) * 4 * (1 << n_bits) * sizeof(int) +
      staging_bytes(m_tile, k_tile, n);
  cudaError_t err = allow_smem(entry_gemv_first_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_mt = (m + m_tile - 1) / m_tile;
  entry_gemv_first_kernel<<<d * n_mt, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(masks), static_cast<const int*>(a),
      static_cast<const int*>(b), static_cast<int*>(out), rows, m, k, n, n_bits,
      m_tile, k_tile);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K5's layout for D configs on a card of n_sms SMs: where D < n_sms, a
// config's slabs are split over up to n_sms / D blocks; where that layout
// exceeds kMaxSmem, over more (the sums and tiles shrink with the slabs).
StagedLayout entry_layout(int d, int m, int k, int n, int n_bits, int n_sms) {
  const int rows = n_bits / 2;
  const size_t ints = static_cast<size_t>((rows / 2) * 16 + (rows % 2) * 4) << n_bits;
  const int slabs = (m + kSlab - 1) / kSlab;
  const int want = std::min(slabs, std::max(1, n_sms / std::max(d, 1)));
  int spb = (slabs + want - 1) / want;
  StagedLayout L = staged_layout(m, k, n, ints, spb);
  while (L.smem > kMaxSmem && spb > 1) {
    spb = (spb + 1) / 2;
    L = staged_layout(m, k, n, ints, spb);
  }
  return L;
}

int sm_count() {
  int dev = 0, n_sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return n_sms;
}

bool entry_takes(int n_bits, int m, int k, int n) {
  return n_bits >= 2 && n_bits <= 8 && n_bits % 2 == 0 && m >= 1 && k >= 1 && n >= 1;
}

}  // namespace

// Bytes of scratch K5 needs for (M, K, N) codes: the uint8 codes.
extern "C" long long entry_gemv_scratch(int m, int k, int n) {
  return static_cast<long long>(staged_layout(m, k, n, 0, 1).scratch);
}

// The blocks a config's slabs are split over on this card, or 0 where K5
// cannot take the shape (its layout exceeds kMaxSmem even at one slab a
// block, or the codes are not of 2, 4, 6 or 8 bits).
extern "C" int entry_gemv_splits(int d, int m, int k, int n, int n_bits) {
  if (!entry_takes(n_bits, m, k, n)) return 0;
  const StagedLayout L = entry_layout(d, m, k, n, n_bits, sm_count());
  return L.smem > kMaxSmem ? 0 : L.splits;
}

// Refuses (cudaErrorInvalidValue) what entry_gemv_splits refuses and a
// scratch buffer smaller than the layout needs.
extern "C" int entry_gemv_launch(const void* masks, const void* a, const void* b,
                                 void* scratch, long long scratch_bytes, void* out,
                                 int d, int m, int k, int n, int n_bits, void* stream) {
  if (!entry_takes(n_bits, m, k, n) || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const StagedLayout L = entry_layout(d, m, k, n, n_bits, sm_count());
  if (L.smem > kMaxSmem || scratch_bytes < static_cast<long long>(L.scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* a8 = static_cast<uint8_t*>(scratch);
  uint8_t* bt8 = a8 + L.bt8;
  pack_codes_kernel<<<L.pack_blocks, kPackThreads, 0, st>>>(
      static_cast<const int*>(a), static_cast<const int*>(b), a8, bt8, nullptr, m,
      k, n, L.m_pad, L.k_pad, (1 << n_bits) - 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(d, L.splits);
  switch (n_bits) {
#define K5_STAGED(NB)                                                          \
  case NB: {                                                                   \
    err = allow_smem(entry_gemv_staged_kernel<NB>, L.smem);                    \
    if (err != cudaSuccess) return static_cast<int>(err);                      \
    entry_gemv_staged_kernel<NB><<<grid, kStagedThreads, L.smem, st>>>(        \
        static_cast<const int*>(masks), a8, bt8, static_cast<int*>(out), m, n, \
        L);                                                                    \
    break;                                                                     \
  }
    K5_STAGED(2)
    K5_STAGED(4)
    K5_STAGED(6)
    K5_STAGED(8)
#undef K5_STAGED
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

bool wide_takes(int n_bits, int m, int k, int n) {
  return n_bits == 12 && m >= 1 && k >= 1 && n >= 1;
}

}  // namespace

// The blocks a config's slabs are split over by K5's 12-bit launcher on this
// card, or 0 where it cannot take the shape (codes not of 12 bits, or one
// K-code's slots over kMaxSmem).
extern "C" int entry_gemv_wide_splits(int d, int m, int k, int n, int n_bits) {
  if (!wide_takes(n_bits, m, k, n) || d < 1) return 0;
  const WideLayout L = wide_layout<12>(d, m, k, n, sm_count());
  return L.smem > kMaxSmem ? 0 : L.splits;
}

// K5 at 12 bits: masks (D, 6) int32, a (M, K) and b (K, N) int32
// codes, out (D, M, N) int32 sums modulo 2^32.  Refuses (cudaErrorInvalidValue)
// what entry_gemv_wide_splits refuses.
extern "C" int entry_gemv_wide_launch(const void* masks, const void* a, const void* b,
                                      void* out, int d, int m, int k, int n, int n_bits,
                                      void* stream) {
  if (!wide_takes(n_bits, m, k, n) || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const WideLayout L = wide_layout<12>(d, m, k, n, sm_count());
  if (L.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(entry_gemv_wide_kernel<12>, L.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  entry_gemv_wide_kernel<12><<<dim3(d, L.splits), kWideThreads, L.smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(masks), static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(out), m, k, n, L.kc, L.spb);
  return static_cast<int>(cudaGetLastError());
}
