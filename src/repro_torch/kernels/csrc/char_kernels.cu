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
//                      is the (D, R) mask block; the plane values come from
//                      the carry-chain model (planes.cuh, shared with K5)
//                      and the exact products and weights from the operand
//                      codes.
//
// Both reduce, per (A-tile j, config d),
//
//   int32: 0 sum|e|  1 #(e != 0)  2 max|e|  3 sum hi^2  4 sum hi*lo  5 sum lo^2
//   f32:   0 sum |e| * w
//
// (hi = |e| >> 8, lo = |e| & 255) over the tile's a_tile x B pairs.  The
// A-tile rule of the caller (a_tile * B * max|e| < 2^30) bounds every int32
// block sum, so the int channels are exact in any order; the f32 channel
// sums in another order than the plain version.
//
// K1 walks registers.  A thread owns one b column and kG configs; the block
// covers one A-tile for 256 / B sub-blocks of kG configs.  Within a group of
// 2^GB consecutive a codes (GB = min(log2 a_tile, 6)) the bit pairs of rows
// >= GB / 2 are fixed, so each config's product is a per-group base (those
// rows' plane values at the column, read once a group) plus the plane
// values of rows < GB / 2, which the thread holds in registers (12 for the
// 8-bit tile of 64: rows 0-2, with row 3 in the base).  The group's 2^GB
// codes are walked fully unrolled, so every plane index is a compile-time
// register and a product is one or two adds of shared partial sums: no
// shared memory, no bit extraction.  exact and w are read coalesced along b,
// each load serving kG configs, from an unrolled body that the compiler
// schedules ahead of use.  Then: sub, abs, the six int updates and the f32
// product and add (|e| goes to f32 exactly through the 2^23 mantissa trick,
// on the full-rate pipes).  The least a pair needs is 11 instructions (sub,
// abs, hi/lo split, three multiplies, count, max, sum, the f32 multiply-add),
// at 4 warp instructions an SM a clock: that is K1's bound.  In the SASS of
// nvcc 12.9's sm_90a build (read by kernels/sass.py) the walk's group loop
// (64 codes x 4 configs at 8 bits) is 5,117 instructions, 20 a pair with
// the loads, the product's adds, the count's select, the exact float
// conversion and the f32 multiply and add kept apart as the plain version
// rounds them.  It holds 255 registers, one block an SM.
//
// K1's first design (behav_stats_table_first, kept for the comparison on the
// card) strides 256 threads over a block's a_tile x B pairs of one config and
// computes each product from the shared-memory planes: per row a bit-pair
// extraction, a shared-memory load, a shift and an add; exact and w are
// loaded for every (config, pair).  In SASS its pair loop is 169
// instructions with a runtime rows loop of 65 inside it.  Both are bound by
// integer issue.
//
// K2 runs K1's walk (one template, behav_stats_walk_kernel<GB, G, true>)
// with nothing to load: a thread computes its column's register plane
// values and each group's base values in closed form from the config's
// keep masks (rowplanes::Column: one masked add a value, no bit loop), and
// per pair the exact product a_s * b_s and w = __frcp_rn(max(|exact|, 1))
// (the correctly rounded reciprocal, equal to the plain version's f32
// division), once for the thread's G configs.  G is 4, or 1 where a grid
// of 4-config threads would leave SMs without a block (the wrapper's
// entry_configs picks it and passes it to the launcher).  In
// the SASS of nvcc 12.9's sm_90a build the group loop at 8 bits is 5,814
// instructions for 64 codes x 4 configs (22.7 a pair; no loads) in 121
// registers, and 2,486 for 64 codes x 1 config (38.8 a pair: the exact
// product and the reciprocal are no longer shared) in 42.  Its
// first design (behav_stats_entry_first): every (config, A-tile) block
// synthesizes all R x 4 x B plane entries bit by bit into shared memory and
// runs K1's first-design pair loop with an IEEE division per (config, pair).

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
behav_stats_table_first_kernel(const int* __restrict__ small,
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
behav_stats_entry_first_kernel(const int* __restrict__ masks, int* __restrict__ int_out,
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

// ---- K1, register walk ------------------------------------------------

constexpr int kWalkThreads = 256;
constexpr int kWalkG = 4;                    // configs a thread walks (K1; K2's most)
constexpr int kMaxSegs = kWalkThreads / 2;   // B >= 2
constexpr int kMaxRows = 4;                  // 8-bit operands

__device__ __forceinline__ int shl(int v, int s) {
  return static_cast<int>(static_cast<unsigned>(v) << s);
}

// Row r's bit-pair plane index of code a: 2 * bit_2r(a) + bit_2r+1(a).
__device__ __forceinline__ int pair_of(int a, int r) {
  return (((a >> (2 * r)) & 1) << 1) | ((a >> (2 * r + 1)) & 1);
}

// |e| (0 <= v < 2^23) as f32, exactly, with an integer or and an f32 sub.
__device__ __forceinline__ float exact_float(int v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f);
}

__device__ __forceinline__ void accumulate_walk(Acc& acc, int err, float w) {
  const int ae = abs(err);
  const int hi = ae >> 8;
  const int lo = ae & 255;
  acc.s_abs += ae;
  acc.cnt += err != 0;
  acc.mx = max(acc.mx, ae);
  acc.h2 += hi * hi;
  acc.hl += hi * lo;
  acc.l2 += lo * lo;
  acc.rel = __fadd_rn(acc.rel, __fmul_rn(exact_float(ae), w));
}

// The walk's inputs: K1's gathered planes, exact products and weights, or
// K2's masks alone.
struct WalkIn {
  const int* small;   // (R, D, 4, B), K1
  const int* exact;   // (A, B), K1
  const float* wgt;   // (A, B), K1
  const int* masks;   // (D, R), K2
};

// K1 (kSynth false) reads a plane value at its column from the gathered
// planes; K2 (kSynth true) computes it in closed form from the config's keep
// mask (rowplanes::Column), and the exact product and its weight from the
// codes: exact = a_s * b_s, w = rn(1 / max(|exact|, 1)) (__frcp_rn, equal to
// the plain version's f32 division).  G configs a thread.
template <int GB, int G, bool kSynth>
__global__ void __launch_bounds__(kWalkThreads)
behav_stats_walk_kernel(WalkIn in, int* __restrict__ int_out,
                        float* __restrict__ rel_out, int rows, int d_total,
                        int n_bits, int a_tile) {
  constexpr int kFull = GB / 2;          // rows whose two bits vary in a group
  constexpr bool kHalf = (GB & 1) != 0;  // row kFull: its low bit varies
  constexpr int kGroup = 1 << GB;
  const int b_n = 1 << n_bits;
  const int b = threadIdx.x & (b_n - 1);
  const int sub = threadIdx.x >> n_bits;
  const int subs = kWalkThreads >> n_bits;
  const int d0 = (blockIdx.x * subs + sub) * G;
  const int j = blockIdx.y;
  const int a_lo = j * a_tile;
  const size_t row_stride = static_cast<size_t>(d_total) * 4 * b_n;

  // config g's planes at column b (K1), or its rows' keep masks (K2)
  const int* col[kSynth ? 1 : G];
  int keep[kSynth ? G : 1][kMaxRows];
  const rowplanes::Column column(b, n_bits);
  // plane value of config g, row r (< kMaxRows), pair p at column b
  auto plane = [&](int g, int r, int p) {
    if constexpr (kSynth) {
      return column.value(p, r == rows - 1, keep[g][r]);
    } else {
      return __ldg(col[g] + r * row_stride + p * b_n);
    }
  };
  int pv[G][kFull > 0 ? kFull : 1][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int d = min(d0 + g, d_total - 1);
    if constexpr (kSynth) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        keep[g][r] = r < rows ? column.keep_of(__ldg(in.masks + d * rows + r)) : 0;
      }
    } else {
      col[g] = in.small + static_cast<size_t>(d) * 4 * b_n + b;
    }
#pragma unroll
    for (int r = 0; r < kFull; ++r) {
#pragma unroll
      for (int p = 0; p < 4; ++p) pv[g][r][p] = shl(plane(g, r, p), 2 * r);
    }
  }

  Acc acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = {0, 0, 0, 0, 0, 0, 0.0f};
  const int half = b_n >> 1;
  const int bs = b >= half ? b - b_n : b;
  for (int a0 = a_lo; a0 < a_lo + a_tile; a0 += kGroup) {
    int base[G];
    int hv[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int s = 0;
      if constexpr (kSynth) {  // a compile-time row indexes keep
#pragma unroll
        for (int r = kFull + (kHalf ? 1 : 0); r < kMaxRows; ++r) {
          if (r < rows) s += shl(plane(g, r, pair_of(a0, r)), 2 * r);
        }
      } else {
        for (int r = kFull + (kHalf ? 1 : 0); r < rows; ++r) {
          s += shl(plane(g, r, pair_of(a0, r)), 2 * r);
        }
      }
      base[g] = s;
      if constexpr (kHalf) {
        const int f = (a0 >> GB) & 1;  // row kFull's high bit, fixed a group
        hv[g][0] = shl(plane(g, kFull, f), 2 * kFull);
        hv[g][1] = shl(plane(g, kFull, 2 + f), 2 * kFull);
      }
    }
    const int* ex_p = kSynth ? nullptr : in.exact + (static_cast<size_t>(a0) << n_bits) + b;
    const float* w_p = kSynth ? nullptr : in.wgt + (static_cast<size_t>(a0) << n_bits) + b;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      int ex;
      float w;
      if constexpr (kSynth) {
        const int a = a0 + i;
        ex = (a >= half ? a - b_n : a) * bs;
        w = __frcp_rn(exact_float(max(abs(ex), 1)));
      } else {
        ex = __ldg(ex_p + i * b_n);
        w = __ldg(w_p + i * b_n);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        int approx = base[g];
        if constexpr (kHalf) approx += hv[g][(i >> (GB - 1)) & 1];
#pragma unroll
        for (int r = kFull - 1; r >= 0; --r) approx += pv[g][r][pair_of(i, r)];
        accumulate_walk(acc[g], approx - ex, w);
      }
    }
  }

  // Reduce over the sub-block's B columns: shuffles within segments of
  // min(B, 32) lanes, then the segments' sums through shared memory.
  const int seg = min(b_n, 32);
  __shared__ int s_int[kMaxSegs][kWalkG][6];
  __shared__ float s_rel[kMaxSegs][kWalkG];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Acc& a = acc[g];
    for (int off = seg >> 1; off > 0; off >>= 1) {
      a.s_abs += __shfl_down_sync(0xffffffffu, a.s_abs, off, seg);
      a.cnt += __shfl_down_sync(0xffffffffu, a.cnt, off, seg);
      a.mx = max(a.mx, __shfl_down_sync(0xffffffffu, a.mx, off, seg));
      a.h2 += __shfl_down_sync(0xffffffffu, a.h2, off, seg);
      a.hl += __shfl_down_sync(0xffffffffu, a.hl, off, seg);
      a.l2 += __shfl_down_sync(0xffffffffu, a.l2, off, seg);
      a.rel = __fadd_rn(a.rel, __shfl_down_sync(0xffffffffu, a.rel, off, seg));
    }
    if ((threadIdx.x & (seg - 1)) == 0) {
      const int sg = threadIdx.x / seg;
      s_int[sg][g][0] = a.s_abs;
      s_int[sg][g][1] = a.cnt;
      s_int[sg][g][2] = a.mx;
      s_int[sg][g][3] = a.h2;
      s_int[sg][g][4] = a.hl;
      s_int[sg][g][5] = a.l2;
      s_rel[sg][g] = a.rel;
    }
  }
  __syncthreads();
  const int segs_per_sub = b_n / seg;
  if (threadIdx.x < subs * G) {
    const int sb = threadIdx.x / G;
    const int g = threadIdx.x - sb * G;
    const int d = (blockIdx.x * subs + sb) * G + g;
    if (d < d_total) {
      const int s0 = sb * segs_per_sub;
      int t[6];
      for (int c = 0; c < 6; ++c) t[c] = s_int[s0][g][c];
      float rel = s_rel[s0][g];
      for (int sg = s0 + 1; sg < s0 + segs_per_sub; ++sg) {
        t[0] += s_int[sg][g][0];
        t[1] += s_int[sg][g][1];
        t[2] = max(t[2], s_int[sg][g][2]);
        t[3] += s_int[sg][g][3];
        t[4] += s_int[sg][g][4];
        t[5] += s_int[sg][g][5];
        rel = __fadd_rn(rel, s_rel[sg][g]);
      }
      const size_t row = (static_cast<size_t>(j) * d_total + d) * kChan;
      for (int c = 0; c < 6; ++c) int_out[row + c] = t[c];
      int_out[row + 6] = 0;
      int_out[row + 7] = 0;
      rel_out[row] = rel;
      for (int c = 1; c < kChan; ++c) rel_out[row + c] = 0.0f;
    }
  }
}

}  // namespace

namespace {

int log2_tile(int a_tile) {
  int tb = 0;
  while ((1 << tb) < a_tile) ++tb;
  return tb < 6 ? tb : 6;
}

// The walk at (GB, G, kSynth) on a grid of blocks of 256 / B sub-blocks of G
// configs by A-tiles.
template <int G, bool kSynth>
int launch_walk(const WalkIn& in, void* int_out, void* rel_out, int rows, int d,
                int n_bits, int a_tile, cudaStream_t st) {
  const int per_block = (kWalkThreads >> n_bits) * G;
  const dim3 grid((d + per_block - 1) / per_block, (1 << n_bits) / a_tile);
  int* io = static_cast<int*>(int_out);
  float* ro = static_cast<float*>(rel_out);
  switch (log2_tile(a_tile)) {
#define WALK(GB)                                                                \
  case GB:                                                                      \
    behav_stats_walk_kernel<GB, G, kSynth><<<grid, kWalkThreads, 0, st>>>(      \
        in, io, ro, rows, d, n_bits, a_tile);                                   \
    break;
    WALK(0)
    WALK(1)
    WALK(2)
    WALK(3)
    WALK(4)
    WALK(5)
    WALK(6)
#undef WALK
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int behav_stats_table_launch(const void* small, const void* exact,
                                        const void* wgt, void* int_out,
                                        void* rel_out, int rows, int d,
                                        int n_bits, int a_tile, void* stream) {
  const WalkIn in = {static_cast<const int*>(small), static_cast<const int*>(exact),
                     static_cast<const float*>(wgt), nullptr};
  return launch_walk<kWalkG, false>(in, int_out, rel_out, rows, d, n_bits, a_tile,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int behav_stats_table_first_launch(const void* small, const void* exact,
                                        const void* wgt, void* int_out,
                                        void* rel_out, int rows, int d,
                                        int n_bits, int a_tile, void* stream) {
  const int n_ta = (1 << n_bits) / a_tile;
  const size_t smem = static_cast<size_t>(rows) * 4 * (1 << n_bits) * sizeof(int);
  behav_stats_table_first_kernel<<<d * n_ta, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(small), static_cast<const int*>(exact),
      static_cast<const float*>(wgt), static_cast<int*>(int_out),
      static_cast<float*>(rel_out), rows, d, n_bits, a_tile);
  return static_cast<int>(cudaGetLastError());
}

// K2 at G = configs (4 or 1) configs a thread.
extern "C" int behav_stats_entry_launch(const void* masks, void* int_out,
                                        void* rel_out, int rows, int d,
                                        int n_bits, int a_tile, int configs,
                                        void* stream) {
  const WalkIn in = {nullptr, nullptr, nullptr, static_cast<const int*>(masks)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (configs) {
    case 4:
      return launch_walk<4, true>(in, int_out, rel_out, rows, d, n_bits, a_tile, st);
    case 1:
      return launch_walk<1, true>(in, int_out, rel_out, rows, d, n_bits, a_tile, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int behav_stats_entry_first_launch(const void* masks, void* int_out,
                                              void* rel_out, int rows, int d,
                                              int n_bits, int a_tile, void* stream) {
  const int n_ta = (1 << n_bits) / a_tile;
  const size_t smem = static_cast<size_t>(rows) * 4 * (1 << n_bits) * sizeof(int);
  behav_stats_entry_first_kernel<<<d * n_ta, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(masks), static_cast<int*>(int_out),
      static_cast<float*>(rel_out), rows, d, n_bits, a_tile);
  return static_cast<int>(cudaGetLastError());
}
