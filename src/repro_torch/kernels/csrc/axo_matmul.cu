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
// Five routes, chosen in kernels/axo_matmul.py plan() by M; each reduces a
// split K in the kernel itself, in split order (below).
//
// 1. M = 81..511, or K or N off 16 bytes: tensor cores, mma.sync.m16n8k8 TF32 with f32
//    accumulate.  A block of 8 warps owns a 128 x 128 output tile; each warp
//    a 64 x 32 one (4 x 4 MMA tiles).  The block walks K in steps of 32
//    codes: cp.async stages the A (128 x 32) and B (32 x 128) code tiles in
//    shared memory, double-buffered, and each warp expands its fragments
//    from the codes through the tables, one table row j of [sv; f] / [sv; g]
//    at a time.  (Expanding the A fragments once per block into shared
//    memory, with a barrier per table row, was tried and ran slower.)  TF32
//    keeps 10 stored mantissa bits:
//    - the value part (j = 0) takes one pass: sv holds integers of at most
//      8 bits, which TF32 holds exactly (a block checks its table and takes
//      three passes where it does not);
//    - each factor part takes three: x = hi + lo with hi = x rounded to
//      TF32 and lo = x - hi (the tensor core truncates lo to TF32 in turn),
//      and hi.hi + hi.lo + lo.hi.  Emulated in plain torch
//      (tests/test_torch_kernel_design.py; M=64, K=2048, N=256, exact sums,
//      rounded once to f32), a single pass gives a relative norm of 1.7e-5
//      for serve.demo_operator(8) and 1.5e-5 for a random 36-bit config,
//      over the 1e-5 contract; three passes 4.3e-9 and 3.2e-8.
//    - The tensor core rounds its f32 sum toward zero (as modelled there), so
//      a long chain of MMAs into one accumulator drifts toward zero.  So each
//      32-code step accumulates from zero in the tensor core and is added to
//      the running sum in IEEE f32, and within each 8 codes the table rows
//      run from the last factor down to the values (each lo.hi, hi.lo,
//      hi.hi), so that small terms meet a small accumulator: 3.2e-7 and
//      1.6e-6 (M=32, N=64), where one chain over all of K=2048 reaches
//      1.8e-5 and 1.3e-4.
//    Work: (1 + 3R) * 2MNK TF32 operations, 0.87 ms at 495 TFLOP/s for the
//    prefill gate/up projection (M=512, K=2048, N=8192, R=8).  What bounds
//    this design: instruction issue around the MMAs, with 8 warps an SM
//    (230 registers a thread).  Per table row and 8 codes a warp issues 48
//    MMAs, 24 shared-memory gathers, their 24 address sums and 72 ALU
//    operations of the hi/lo split (integer adds and masks: with the TF32
//    conversion instruction, which issues at a quarter of the rate, the
//    kernel took longer).
//
// 2. M <= 16 by name (route="gemv"; the plan's below rank 8's route 5 and
//    at other ranks): a split-K GEMV in IEEE f32 on the FMA pipe.  A block
//    of 4 warps owns 512 columns and MT (1, 2, 4 or 8) rows; each lane owns
//    16 columns and streams their weight codes down K with one 16-byte load
//    per row (two aligned loads and a funnel shift where N is not a multiple
//    of 16), each warp keeping its next 4 rows' loads in flight.  The
//    activation side, (K chunk, 1+R, MT) values, is expanded once per chunk
//    into shared memory and read as broadcasts; each weight code's 1+R table
//    entries are gathered once and used for all MT rows: (1+R) * MT FMAs per
//    code, no padded rows at M = 1, 2, 4, 8 and 16.  The 4 warps take
//    interleaved rows of K and are summed in warp order through the table's
//    shared memory, once the table is no longer read.  What bounds it:
//    instruction issue and latency, about 600 cycles an SM per warp and row
//    (16 codes: 9 gathers, 9 address sums and 9 x MT FMAs each) whatever the
//    occupancy; its floor on the FMA pipe is 2*M*N*K*(1+R) f32 operations.
//
// 3. 16 < M <= 80 (the MoE prefill's expert buffers: deepseek-v3's 24 rows,
//    jamba's 80): skinny tensor cores.  Route 1's 128-row tiles spent 104 of
//    128 rows on padding at M = 24 (5.3x the useful MMAs, and each weight
//    code's table expansion spent on 24 real rows).  This route computes
//    out^T = B^T A^T: the weight's columns fill mma.m16n8k8's 16-row A side
//    and the activation rows its 8-wide B side, so a block of 4 warps owns
//    Rows = 24 or 80 rows (no padded row at M = 24 and 80; M = 25..79 pads
//    to 80) and 128 or 64 weight columns; each warp 2 tiles of 16 columns x
//    3 or 5 tiles of 8 rows.  Everything else is route 1's: the tables in shared memory, the
//    codes staged by cp.async in 32-code steps, the values in one TF32 pass
//    and each factor in three (x_lo.w_hi, x_hi.w_lo, x_hi.w_hi, route 1's
//    terms in route 1's order), each step summed from zero in the tensor
//    core and added in IEEE f32, split K summed in split order by the last
//    block.  What bounds it: latency, the shared-memory gathers (1 + R a code
//    on each side, ~3.5-way bank conflicts for random codes) and the MMAs of
//    each table row waiting on them; with 8 warps an SM (8-warp blocks) it ran
//    no faster than route 1 at M = 80, so blocks are 4 warps and an SM holds 3
//    or 4 of them (128-168 registers a thread; the plan's splits fill that
//    many a card), and the table rows are unrolled by two, so that one row's
//    gathers are in flight during the other's MMAs.  Measured (chip_smoke.py, H100 80GB HBM3, 700 W, CUDA
//    events [profiler device time]): deepseek-v3's 24 rows 0.1421 ms
//    [0.1421] (7168 x 2048) and 0.1511 [0.1512] (2048 x 7168) against route
//    1's 0.5148 [0.5110] and 0.5848 [0.5821] and one cuBLAS GEMM's 0.2167
//    and 0.2421; jamba's 80 rows 1.4250 and 1.3974 against 2.3316 and 2.0498
//    (cuBLAS 2.4632, 2.4905); profiled in a fresh process in a later run,
//    jamba's 80 rows [1.4177] and [1.3684] against route 1's [2.2705] and
//    [2.0092] (cuBLAS [2.4716], [2.5270]).  The TF32 bounds are 0.0356 and
//    0.4745.
//
// 4. M >= WGMMA_M = 512 (the prefills' projections, and the encoder and
//    cross K/V projections over whisper's 6,000 frames and the VLM's 6,400
//    image tokens), K and N multiples of 16: wgmma TF32 on planes expanded
//    once a block.  Route 1's bound is
//    instruction issue: each warp expands its own fragments from the codes,
//    so a 128 x 128 tile's A codes are expanded once per warp along N (4
//    times) and its B codes once per warp along M (twice).  Here a block of
//    384 threads owns a 128 x 128 tile: one lane of the expansion warpgroup
//    loads each 32-code step's A (128 x 32) and B (32 x 128) codes by TMA
//    (2-d maps over the uint8 matrices, edges filled with zero codes); the
//    expansion warpgroup's 128 threads hold the step's codes in registers
//    and expand them once, table row by table row, into TF32 hi and lo
//    planes (hi = x rounded to TF32, lo = x - hi, route 1's split), written
//    K-major in the 128-byte swizzled layout wgmma reads (B's transpose is
//    free: each thread writes one weight column's 32 codes), into a ring of
//    three (step, table row) stages of 64 KB with full and empty mbarriers
//    (a thread fences the async proxy before it arrives).  Two consumer
//    warpgroups (64 rows each, all 128 columns) issue
//    wgmma.m64n128k8.f32.tf32.tf32 from shared memory: the values' row one
//    pass, each factor row three (lo.hi, hi.lo, hi.hi), the table rows from
//    the last factor down to the values, each over the step's four 8-code
//    slices; a stage is freed once the next one's products are issued and
//    its own are done (wgmma.wait_group 1).  Route 1's precision contract
//    holds: each step is summed from zero in the tensor core (scale-d 0 on
//    its first wgmma) and added to the running IEEE f32 sum, and a split K
//    is summed in split order by the last block (tests/test_torch_kernel_design.py
//    emulates the order).  What bounds it: shared memory, about 2,500 of its
//    128-byte wavefronts a stage (the 8,192 table gathers with their bank
//    conflicts, the 64 KB of plane stores, and wgmma's reads: each consumer
//    warpgroup reads all of B), against the stage's 1,536 cycles of TF32
//    MMAs, so the stages are three (the expansion runs up to two table rows
//    ahead) and the code tiles one, which serves a step's nine table rows.
//    Its times against route 1's and cuBLAS's are in PERF.md section 6.
//
// 5. M <= 16 at rank 8 (the decode steps' projections, mamba2's head,
//    kimi-k2's expert buffers of 16 and 8 rows): tensor cores at a few rows, each
//    weight code expanded once for all of them.  Route 2 expands each code
//    once per 8 rows (twice at M = 9..16) with 9 scalar shared-memory
//    gathers of ~3.15-way bank conflicts for random codes, and spends
//    9 x MT FMAs a code.  Here out^T = B^T A^T as in route 3: the weight's
//    columns fill mma.m16n8k8's 16-row side and the activation rows its
//    8-wide side (8 rows a block up to M = 8, 16 as two n8 tiles up to 16),
//    so the MMAs take the FMAs and one expansion serves every row.  The
//    weight table is held as planes of 4 entries in 8 copies (a float4 a
//    code, copy l % 8 for lane l: the 8 lanes a 16-byte load serves at once
//    never share a bank) and the 9th entry as a plane of 16 copies, so a
//    code's 9 entries take 3 loads; a lane's 8 columns are adjacent (one
//    8-byte load of codes a K row) and a code's byte gives its offset in
//    every plane.  A block of 8 warps stands WN along N and 8 / WN along
//    K, each warp 4 tiles of 16 columns; the activation side, (32 codes, 9
//    rows, rows / 8, 32 lanes) B fragments, is expanded once a block a
//    32-code step into shared memory.  Each factor takes three TF32 passes,
//    split as route 1 splits them, the values one.  Each 8-code group is
//    summed from zero in the tensor core (at most 25 MMAs a chain, each
//    rounding toward zero) and added to the warp's IEEE f32 sum; the K
//    warps' sums are added in warp order, the splits in split order
//    (tests/test_torch_kernel_design.py emulates the order).  With route
//    1's 32-code chains (100 MMAs, their roundings toward zero adding up)
//    the reduced VLM's AxO pass in chip_smoke.py flipped an activation code
//    and left its plain replay by 0.0245; with 8-code chains it did not
//    (16 f32 adds a lane and group at 8 rows).  The table rows are a
//    template parameter (the source builds
//    rank 8; the plan keeps route 2 at other ranks).  What bounds it:
//    instruction issue.  Per warp and 128 codes it issues 12 gathers, the
//    hi/lo split of 32 factor entries (three operations each), the moves
//    that gather each table row's 4 codes into an MMA operand (each gather
//    brings one code's 4 rows), and 25 MMAs at 8 rows, 50 at 16; probe_k6.py
//    prints each instance's loop-body SASS mix and times it against route 2.
//
// Split K: each block writes its partial tile to a (splits, M, N) workspace;
// the last block of a tile to arrive (an atomic counter per tile, which it
// resets) sums the partials in split order, so the result does not depend on
// which block finishes last.  No second launch.  plan() picks the splits
// that fill the SMs in the fewest waves.  The launch layout (tiles, k-steps,
// shared memory) is this file's: the launcher refuses a plan that disagrees
// with it, rather than overrun shared memory or the counters.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

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

// Fill a (1+R, n_codes) table in shared memory: row 0 = sv, row 1+r =
// fac[:, r].  Each thread reads 8 entries before it writes any, so their
// loads are in flight together.  Returns, block-wide, whether every sv is
// exact in TF32.
__device__ bool fill_table(float* __restrict__ tab, const float* __restrict__ sv,
                           const float* __restrict__ fac, int rank, int n_codes) {
  constexpr int kBatch = 8;
  const int r1 = rank + 1;
  const int total = r1 * n_codes;
  bool exact = true;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int j = i / n_codes;
      const int c = i - j * n_codes;
      x[u] = i >= total ? 0.f : j == 0 ? sv[c] : fac[c * rank + j - 1];
      if (i < total && j == 0) exact = exact && (__float_as_uint(x[u]) & 0x1fffu) == 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) tab[i] = x[u];
    }
  }
  return __syncthreads_and(exact);
}

// Split K: write this block's partial, and let the last block of the tile sum
// all of them in split order into out.  The last block reads the partials 8
// splits at a time (in flight together), 4 columns to a load where rows are
// 16-byte aligned.
__device__ void split_fixup(float* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ counters, int splits, int m_total, int n_total,
                            int m0, int rows, int n0, int cols) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(&counters[tile], 1) == splits - 1;
    if (last) counters[tile] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t mn = static_cast<size_t>(m_total) * n_total;
  const int rows_in = min(rows, m_total - m0);
  const int cols_in = min(cols, n_total - n0);
  constexpr int kBatch = 8;
  if (n_total % 4 == 0 && n0 % 4 == 0) {   // cols_in is a multiple of 4 too
    const int quads = cols_in / 4;
    for (int e = threadIdx.x; e < rows_in * quads; e += blockDim.x) {
      const int r = e / quads;
      const size_t idx = static_cast<size_t>(m0 + r) * n_total + n0 + 4 * (e - r * quads);
      float4 s = __ldcg(reinterpret_cast<const float4*>(ws + idx));
      for (int z0 = 1; z0 < splits; z0 += kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (z0 + u < splits)
            v[u] = __ldcg(reinterpret_cast<const float4*>(ws + (z0 + u) * mn + idx));
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (z0 + u < splits) {
            s.x += v[u].x;
            s.y += v[u].y;
            s.z += v[u].z;
            s.w += v[u].w;
          }
        }
      }
      *reinterpret_cast<float4*>(out + idx) = s;
    }
    return;
  }
  for (int e = threadIdx.x; e < rows_in * cols_in; e += blockDim.x) {
    const int r = e / cols_in;
    const size_t idx = static_cast<size_t>(m0 + r) * n_total + n0 + (e - r * cols_in);
    float s = __ldcg(ws + idx);
    for (int z0 = 1; z0 < splits; z0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (z0 + u < splits) v[u] = __ldcg(ws + (z0 + u) * mn + idx);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (z0 + u < splits) s += v[u];
    }
    out[idx] = s;
  }
}

// ---------------------------------------------------------------------------
// route 1, M > 16: TF32 tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kStepK = 32;
constexpr int kAStride = 48;       // bytes per staged A row: 32 codes + 16 pad
constexpr int kBStride = 144;      // bytes per staged B row: 128 codes + 16 pad
constexpr int kABytes = kTileM * kAStride;
constexpr int kBBytes = kStepK * kBStride;

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 rounds, here by an integer add and mask), lo = x - hi
// exactly; the tensor core reads the top 19 bits of lo, dropping the rest.
// Three full-rate ALU operations, where the conversion instruction would
// issue at a quarter of the rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b for one 16x8 tile over 8 of k, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage one 32-code step of A (128 x 32) and B (32 x 128) into shared memory:
// 16-byte cp.async where the rows are 16-byte aligned, else byte loads.  Codes
// past M, N or K are staged as 0 (their products are discarded or masked).
__device__ void stage_step(uint8_t* as, uint8_t* bs, const uint8_t* __restrict__ a,
                           const uint8_t* __restrict__ b, int m_total, int n_total,
                           int k_total, int m0, int n0, int k0, int kend, bool a_vec,
                           bool b_vec) {
  const int tid = threadIdx.x;
  {  // A: 128 rows x 2 pieces of 16
    const int r = tid >> 1;
    const int c = (tid & 1) * 16;
    const int m = m0 + r;
    const int k = k0 + c;
    uint8_t* dst = as + r * kAStride + c;
    if (a_vec) {
      const bool in = m < m_total && k < kend;
      cp_async16(dst, a + (in ? static_cast<size_t>(m) * k_total + k : 0), in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (m < m_total) {
        const uint8_t* src = a + static_cast<size_t>(m) * k_total;
        for (int i = 0; i < 16; ++i)
          if (k + i < kend) w[i >> 2] |= static_cast<uint32_t>(src[k + i]) << (8 * (i & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  {  // B: 32 rows x 8 pieces of 16
    const int r = tid >> 3;
    const int c = (tid & 7) * 16;
    const int k = k0 + r;
    const int n = n0 + c;
    uint8_t* dst = bs + r * kBStride + c;
    if (b_vec) {
      const bool in = k < kend && n < n_total;
      cp_async16(dst, b + (in ? static_cast<size_t>(k) * n_total + n : 0), in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (k < kend) {
        const uint8_t* src = b + static_cast<size_t>(k) * n_total;
        for (int i = 0; i < 16; ++i)
          if (n + i < n_total) w[i >> 2] |= static_cast<uint32_t>(src[n + i]) << (8 * (i & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kMmaThreads, 1)
axo_mma_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               const float* __restrict__ sv, const float* __restrict__ ft,
               const float* __restrict__ gt, float* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ counters, int m_total, int n_total, int k_total, int rank,
               int n_codes, int splits, int k_split, bool a_vec, bool b_vec) {
  extern __shared__ __align__(16) float smem[];
  const int r1 = rank + 1;
  const int tsz = n_codes;                 // floats per table row
  float* ta = smem;                        // (1+R, n_codes): [sv; f]
  float* tb = ta + r1 * tsz;               // [sv; g]
  uint8_t* as = reinterpret_cast<uint8_t*>(tb + r1 * tsz);   // 2 x (128, 48) A codes
  uint8_t* bs = as + 2 * kABytes;                               // 2 x (32, 144) B codes

  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k_total, kb + k_split);
  const int n_steps = (kend - kb + kStepK - 1) / kStepK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;   // the warp's 64 x 32 piece of the tile
  const int wn = (warp & 3) * 32;
  const int code_mask = n_codes - 1;

  if (n_steps > 0)
    stage_step(as, bs, a, b, m_total, n_total, k_total, m0, n0, kb, kend, a_vec, b_vec);
  const bool sv_exact = fill_table(ta, sv, ft, rank, n_codes);
  fill_table(tb, sv, gt, rank, n_codes);

  float acc[4][4][4] = {};

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const int k0 = kb + step * kStepK;
    if (step + 1 < n_steps) {
      stage_step(as + (buf ^ 1) * kABytes, bs + (buf ^ 1) * kBBytes, a, b, m_total, n_total,
                 k_total, m0, n0, k0 + kStepK, kend, a_vec, b_vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* at = as + buf * kABytes;
    const uint8_t* bt = bs + buf * kBBytes;
    const int klim = kend - k0;   // codes of this step inside the split
    // this step's sum starts from zero in the tensor core (see the header)
    float tmp[4][4][4] = {};
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      // k slot t of the MMA holds code 8s + 2t of the step, slot t + 4 code
      // 8s + 2t + 1: one 16-bit read gives a lane both of a row's codes
      int oa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm + i * 16 + g;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(at + row * kAStride + 8 * s + 2 * t);
        const uint32_t hi =
            *reinterpret_cast<const uint16_t*>(at + (row + 8) * kAStride + 8 * s + 2 * t);
        oa[i][0] = (lo & 0xff) & code_mask;
        oa[i][1] = (hi & 0xff) & code_mask;
        oa[i][2] = (lo >> 8) & code_mask;
        oa[i][3] = (hi >> 8) & code_mask;
      }
      int ob[4][2];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = wn + jn * 8 + g;
        ob[jn][0] = bt[(8 * s + 2 * t) * kBStride + col] & code_mask;
        ob[jn][1] = bt[(8 * s + 2 * t + 1) * kBStride + col] & code_mask;
      }
      const bool v0 = 8 * s + 2 * t < klim;
      const bool v1 = 8 * s + 2 * t + 1 < klim;
      // table rows from the last factor down to the values: the small terms
      // enter the accumulator first, so its rounding toward zero stays small
      // against them (tests/test_torch_kernel_design.py)
#pragma unroll 1
      for (int j = rank; j >= (sv_exact ? 1 : 0); --j) {   // three passes per row
        const float* taj = ta + j * tsz;
        const float* tbj = tb + j * tsz;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(taj[oa[i][e]], ah[i][e], al[i][e]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0 ? tbj[ob[jn][0]] : 0.f, bh0, bl0);
          split_tf32(v1 ? tbj[ob[jn][1]] : 0.f, bh1, bl1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma_tf32(tmp[i][jn], al[i], bh0, bh1);
            mma_tf32(tmp[i][jn], ah[i], bl0, bl1);
            mma_tf32(tmp[i][jn], ah[i], bh0, bh1);
          }
        }
      }
      if (sv_exact) {   // the value part: one pass, exact
        uint32_t af[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) af[i][e] = __float_as_uint(ta[oa[i][e]]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const uint32_t b0 = v0 ? __float_as_uint(tb[ob[jn][0]]) : 0u;
          const uint32_t b1 = v1 ? __float_as_uint(tb[ob[jn][1]]) : 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(tmp[i][jn], af[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] += tmp[i][jn][e];
    __syncthreads();   // this buffer is read before the next stage overwrites it
  }

  float* dst = splits > 1 ? ws + static_cast<size_t>(blockIdx.z) * m_total * n_total : out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int col = n0 + wn + jn * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= m_total) continue;
        float* p = dst + static_cast<size_t>(row) * n_total + col;
        if (col < n_total) p[0] = acc[i][jn][2 * h];
        if (col + 1 < n_total) p[1] = acc[i][jn][2 * h + 1];
      }
    }
  }
  if (splits > 1)
    split_fixup(out, ws, counters, splits, m_total, n_total, m0, kTileM, n0, kTileN);
}

// ---------------------------------------------------------------------------
// route 3, 16 < M <= 80: skinny tensor cores, out^T = B^T . A^T
// ---------------------------------------------------------------------------

// A block of 4 warps owns Cols weight columns x Rows activation rows: the
// warps stand 4 / MW along N and MW along M, each owning 2 weight tiles of 16
// columns (the MMA's 16-row A side) x NTW activation tiles of 8 rows (its
// n8 side).  Instances: Rows = 24 (NTW 3, MW 1, 128 columns) and 80 (5, 2,
// 64), the expert buffers the port serves (deepseek-v3's and jamba's).
constexpr int kSkThreads = 128;
constexpr int kSkBlocksPerSm = 3;   // the fewest blocks an SM holds (ptxas: 128-168 registers)

template <int NTW, int MW>
struct Skinny {
  static constexpr int kWt = 2;                     // 16-column weight tiles a warp
  static constexpr int kWarpsN = 4 / MW;
  static constexpr int kCols = kWarpsN * 16 * kWt;  // weight columns a block
  static constexpr int kRows = MW * NTW * 8;        // activation rows a block
  static constexpr int kBStride = kCols + 16;       // bytes per staged weight row
  static constexpr int kABytes = kRows * kAStride;  // (rows, 48): 32 codes + 16 pad
  static constexpr int kBBytes = kStepK * kBStride;
};

// Stage one 32-code step of the activation codes (Rows x 32) and the weight
// codes (32 x Cols), as stage_step does for route 1.
template <int NTW, int MW>
__device__ void stage_skinny(uint8_t* as, uint8_t* bs, const uint8_t* __restrict__ a,
                             const uint8_t* __restrict__ b, int m_total, int n_total,
                             int k_total, int m0, int n0, int k0, int kend, bool a_vec,
                             bool b_vec) {
  using S = Skinny<NTW, MW>;
  constexpr int kBPieces = kStepK * S::kCols / 16;
  for (int p = threadIdx.x; p < 2 * S::kRows + kBPieces; p += kSkThreads) {
    if (p < 2 * S::kRows) {   // activation codes: a row's 32 codes in two pieces
      const int r = p >> 1;
      const int c = (p & 1) * 16;
      const int m = m0 + r;
      const int k = k0 + c;
      uint8_t* dst = as + r * kAStride + c;
      if (a_vec) {
        const bool in = m < m_total && k < kend;
        cp_async16(dst, a + (in ? static_cast<size_t>(m) * k_total + k : 0), in ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (m < m_total) {
          const uint8_t* src = a + static_cast<size_t>(m) * k_total;
          for (int i = 0; i < 16; ++i)
            if (k + i < kend) w[i >> 2] |= static_cast<uint32_t>(src[k + i]) << (8 * (i & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {                  // weight codes: a k row's Cols codes in pieces of 16
      const int q = p - 2 * S::kRows;
      const int r = q / (S::kCols / 16);
      const int c = (q - r * (S::kCols / 16)) * 16;
      const int k = k0 + r;
      const int n = n0 + c;
      uint8_t* dst = bs + r * S::kBStride + c;
      if (b_vec) {
        const bool in = k < kend && n < n_total;
        cp_async16(dst, b + (in ? static_cast<size_t>(k) * n_total + n : 0), in ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (k < kend) {
          const uint8_t* src = b + static_cast<size_t>(k) * n_total;
          for (int i = 0; i < 16; ++i)
            if (n + i < n_total) w[i >> 2] |= static_cast<uint32_t>(src[n + i]) << (8 * (i & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  cp_async_commit();
}

template <int NTW, int MW>
__global__ void __launch_bounds__(kSkThreads, kSkBlocksPerSm)
axo_skinny_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  const float* __restrict__ sv, const float* __restrict__ ft,
                  const float* __restrict__ gt, float* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ counters, int m_total, int n_total, int k_total, int rank,
                  int n_codes, int splits, int k_split, bool a_vec, bool b_vec) {
  using S = Skinny<NTW, MW>;
  constexpr int WT = S::kWt;
  extern __shared__ __align__(16) float smem[];
  const int r1 = rank + 1;
  const int tsz = n_codes;
  float* ta = smem;                        // (1+R, n_codes): [sv; f], the activation side
  float* tb = ta + r1 * tsz;               // [sv; g], the weight side
  uint8_t* as = reinterpret_cast<uint8_t*>(tb + r1 * tsz);   // 2 x (Rows, 48) codes
  uint8_t* bs = as + 2 * S::kABytes;                           // 2 x (32, Cols + 16) codes

  const int m0 = blockIdx.y * S::kRows;
  const int n0 = blockIdx.x * S::kCols;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k_total, kb + k_split);
  const int n_steps = (kend - kb + kStepK - 1) / kStepK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wn = (warp % S::kWarpsN) * 16 * WT;   // the warp's weight columns
  const int wm = (warp / S::kWarpsN) * NTW * 8;   // and activation rows
  const int code_mask = n_codes - 1;

  if (n_steps > 0)
    stage_skinny<NTW, MW>(as, bs, a, b, m_total, n_total, k_total, m0, n0, kb, kend, a_vec,
                          b_vec);
  const bool sv_exact = fill_table(ta, sv, ft, rank, n_codes);
  fill_table(tb, sv, gt, rank, n_codes);

  float acc[WT][NTW][4] = {};

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const int k0 = kb + step * kStepK;
    if (step + 1 < n_steps) {
      stage_skinny<NTW, MW>(as + (buf ^ 1) * S::kABytes, bs + (buf ^ 1) * S::kBBytes, a, b,
                            m_total, n_total, k_total, m0, n0, k0 + kStepK, kend, a_vec, b_vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* at = as + buf * S::kABytes;
    const uint8_t* bt = bs + buf * S::kBBytes;
    const int klim = kend - k0;
    // this step's sum starts from zero in the tensor core, as in route 1
    float tmp[WT][NTW][4] = {};
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      // k slot t holds code 8s + 2t of the step, slot t + 4 code 8s + 2t + 1,
      // as in route 1.  A side (weights): columns g and g + 8 of each tile.
      int ow[WT][4];
#pragma unroll
      for (int i = 0; i < WT; ++i) {
        const int col = wn + i * 16 + g;
        const uint8_t* r0 = bt + (8 * s + 2 * t) * S::kBStride;
        const uint8_t* r1p = r0 + S::kBStride;
        ow[i][0] = r0[col] & code_mask;
        ow[i][1] = r0[col + 8] & code_mask;
        ow[i][2] = r1p[col] & code_mask;
        ow[i][3] = r1p[col + 8] & code_mask;
      }
      // B side (activations): row g of each 8-row tile, both k slots in one read
      int ox[NTW][2];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int row = wm + nt * 8 + g;
        const uint32_t c2 = *reinterpret_cast<const uint16_t*>(at + row * kAStride + 8 * s + 2 * t);
        ox[nt][0] = (c2 & 0xff) & code_mask;
        ox[nt][1] = (c2 >> 8) & code_mask;
      }
      const bool v0 = 8 * s + 2 * t < klim;
      const bool v1 = 8 * s + 2 * t + 1 < klim;
      // table rows from the last factor down to the values, each factor
      // x_lo.w_hi, x_hi.w_lo, x_hi.w_hi: route 1's order
#pragma unroll 2   // two table rows' gathers in flight together
      for (int j = rank; j >= (sv_exact ? 1 : 0); --j) {
        const float* taj = ta + j * tsz;
        const float* tbj = tb + j * tsz;
        uint32_t wh[WT][4], wl[WT][4];
#pragma unroll
        for (int i = 0; i < WT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(tbj[ow[i][e]], wh[i][e], wl[i][e]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          uint32_t xh0, xl0, xh1, xl1;
          split_tf32(v0 ? taj[ox[nt][0]] : 0.f, xh0, xl0);
          split_tf32(v1 ? taj[ox[nt][1]] : 0.f, xh1, xl1);
#pragma unroll
          for (int i = 0; i < WT; ++i) {
            mma_tf32(tmp[i][nt], wh[i], xl0, xl1);
            mma_tf32(tmp[i][nt], wl[i], xh0, xh1);
            mma_tf32(tmp[i][nt], wh[i], xh0, xh1);
          }
        }
      }
      if (sv_exact) {   // the value part: one pass, exact
        uint32_t wf[WT][4];
#pragma unroll
        for (int i = 0; i < WT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) wf[i][e] = __float_as_uint(tb[ow[i][e]]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const uint32_t x0 = v0 ? __float_as_uint(ta[ox[nt][0]]) : 0u;
          const uint32_t x1 = v1 ? __float_as_uint(ta[ox[nt][1]]) : 0u;
#pragma unroll
          for (int i = 0; i < WT; ++i) mma_tf32(tmp[i][nt], wf[i], x0, x1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WT; ++i)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] += tmp[i][nt][e];
    __syncthreads();   // this buffer is read before the next stage overwrites it
  }

  // the accumulator is out^T: element (weight column, activation row)
  float* dst = splits > 1 ? ws + static_cast<size_t>(blockIdx.z) * m_total * n_total : out;
#pragma unroll
  for (int i = 0; i < WT; ++i) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + wn + i * 16 + g + 8 * (e >> 1);
        const int row = m0 + wm + nt * 8 + 2 * t + (e & 1);
        if (row < m_total && col < n_total)
          dst[static_cast<size_t>(row) * n_total + col] = acc[i][nt][e];
      }
    }
  }
  if (splits > 1)
    split_fixup(out, ws, counters, splits, m_total, n_total, m0, S::kRows, n0, S::kCols);
}

// ---------------------------------------------------------------------------
// route 4, M in the thousands: wgmma TF32 on planes expanded once a block
// ---------------------------------------------------------------------------

constexpr int kWgTile = 128;                        // output rows and columns a block owns
constexpr int kWgConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kWgThreads = (kWgConsumers + 1) * 128;   // + the expansion warpgroup
constexpr int kWgCodeStages = 1;                    // 32-code steps of codes in flight
constexpr int kWgPlaneStages = 3;                   // (step, table row) planes in flight
constexpr int kWgPlane = kWgTile * kStepK * 4;      // 128 rows x 32 TF32, 128-byte swizzled
constexpr int kWgStage = 4 * kWgPlane;              // A hi, A lo, B hi, B lo: 64 KB
constexpr int kWgCodeStage = 2 * kWgTile * kStepK;  // A (128 x 32) and B (32 x 128) codes
constexpr int kWgCodes = kWgPlaneStages * kWgStage;
constexpr int kWgBar = kWgCodes + kWgCodeStages * kWgCodeStage;
constexpr int kWgTables = kWgBar + 8 * 2 * (kWgCodeStages + kWgPlaneStages);

// Dynamic shared memory of a route-4 block: 1024 bytes to align the planes
// (the swizzle's period), the plane ring, the code ring, the barriers, the
// two tables.
size_t wgmma_smem(int r1, int n_codes) {
  return 1024 + kWgTables + 2 * static_cast<size_t>(r1) * n_codes * sizeof(float);
}

// a 2-d box of a uint8 tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// d (+)= A . B for a 64 x 128 tile over 8 of k, both operands K-major TF32 in
// shared memory, f32 accumulate; scale_d 0 zeroes d first
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The byte offset of element (row, k) in a 128 x 32 TF32 plane: each row one
// 128-byte line, its 16-byte chunks XOR-ed with the row's index mod 8 (the
// 128-byte swizzle that wgmma reads, as TMA would write it)
__device__ __forceinline__ uint32_t plane_chunk(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// The expansion of one table row of one step: 4 codes of one row of the plane
// (one 16-byte chunk) through the table row, split into hi and lo.  Codes
// past K (valid false) give 0.
__device__ __forceinline__ void expand_chunk(unsigned char* hi_plane, unsigned char* lo_plane,
                                             uint32_t off, const float* tab, uint32_t codes,
                                             int code_mask, int valid, bool lo_too) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float x = q < valid ? tab[(codes >> (8 * q)) & code_mask] : 0.f;
    split_tf32(x, h[q], l[q]);
  }
  *reinterpret_cast<uint4*>(hi_plane + off) = make_uint4(h[0], h[1], h[2], h[3]);
  if (lo_too) *reinterpret_cast<uint4*>(lo_plane + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

__global__ void __launch_bounds__(kWgThreads, 1)
axo_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                 const float* __restrict__ sv, const float* __restrict__ ft,
                 const float* __restrict__ gt, float* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ counters, int m_total, int n_total, int k_total, int rank,
                 int n_codes, int splits, int k_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);   // planes 1024-aligned
  const uint32_t base = smem_addr(smem);
  float* const ta = reinterpret_cast<float*>(smem + kWgTables);   // (1+R, n_codes): [sv; f]
  float* const tb = ta + (rank + 1) * n_codes;                     // [sv; g]
  auto code_full = [&](int s) { return base + kWgBar + 8u * s; };
  auto plane_full = [&](int s) { return base + kWgBar + 8u * (kWgCodeStages + s); };
  auto plane_empty = [&](int s) {
    return base + kWgBar + 8u * (kWgCodeStages + kWgPlaneStages + s);
  };

  const int m0 = blockIdx.y * kWgTile;
  const int n0 = blockIdx.x * kWgTile;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k_total, kb + k_split);
  const int n_steps = (kend - kb + kStepK - 1) / kStepK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kWgCodeStages; ++s) mbar_init(code_full(s), 1);
    for (int s = 0; s < kWgPlaneStages; ++s) {
      mbar_init(plane_full(s), 128);                 // every expansion thread
      mbar_init(plane_empty(s), 4 * kWgConsumers);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bool sv_exact = fill_table(ta, sv, ft, rank, n_codes);   // its barriers publish the inits
  fill_table(tb, sv, gt, rank, n_codes);
  const int j_value = sv_exact ? 0 : -1;   // the value row's one pass (exact), else three

  if (tid >= kWgConsumers * 128) {
    // The expansion warpgroup.  Thread p expands chunk p & 7 of A's rows
    // p / 8 + 16 i and all 8 chunks of B's row (weight column) p, i = 0..7,
    // holding the step's codes in registers across its table rows.
    const int p = tid - kWgConsumers * 128;
    const int code_mask = n_codes - 1;
    auto load_codes = [&](int step) {
      const int s = step % kWgCodeStages;
      const uint32_t dst = base + kWgCodes + s * kWgCodeStage;
      mbar_arrive_tx(code_full(s), kWgCodeStage);
      tma_load_2d(dst, &tma_a, kb + step * kStepK, m0, code_full(s));
      tma_load_2d(dst + kWgTile * kStepK, &tma_b, n0, kb + step * kStepK, code_full(s));
    };
    if (p == 0)
      for (int step = 0; step < min(n_steps, kWgCodeStages); ++step) load_codes(step);
    int stage = 0;
    for (int step = 0; step < n_steps; ++step) {
      const int s = step % kWgCodeStages;
      mbar_wait(code_full(s), (step / kWgCodeStages) & 1);
      const unsigned char* ca = smem + kWgCodes + s * kWgCodeStage;   // (128 m, 32 k)
      const unsigned char* cb = ca + kWgTile * kStepK;                // (32 k, 128 n)
      uint32_t a_codes[8], b_codes[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a_codes[i] = *reinterpret_cast<const uint32_t*>(ca + ((p >> 3) + 16 * i) * kStepK +
                                                       4 * (p & 7));
        b_codes[i] = cb[(4 * i) * kWgTile + p] | (cb[(4 * i + 1) * kWgTile + p] << 8) |
                     (cb[(4 * i + 2) * kWgTile + p] << 16) |
                     (static_cast<uint32_t>(cb[(4 * i + 3) * kWgTile + p]) << 24);
      }
      // every thread holds the step's codes: the slot takes the step after next
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (p == 0 && step + kWgCodeStages < n_steps) load_codes(step + kWgCodeStages);
      const int klim = kend - (kb + step * kStepK);   // codes of the step inside the split
      for (int j = rank; j >= 0; --j, ++stage) {
        const int ps = stage % kWgPlaneStages;
        mbar_wait(plane_empty(ps), ((stage / kWgPlaneStages) & 1) ^ 1);
        unsigned char* const planes = smem + ps * kWgStage;
        const bool lo_too = j != j_value;
        const float* taj = ta + j * n_codes;
        const float* tbj = tb + j * n_codes;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = (p >> 3) + 16 * i;
          expand_chunk(planes, planes + kWgPlane, plane_chunk(row, p & 7), taj, a_codes[i],
                       code_mask, 4, lo_too);
          expand_chunk(planes + 2 * kWgPlane, planes + 3 * kWgPlane, plane_chunk(p, i), tbj,
                       b_codes[i], code_mask, klim - 4 * i, lo_too);
        }
        // the planes are read by wgmma, through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(plane_full(ps));
      }
    }
  } else {
    // A consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile, all 128
    // columns.  Each step's sum starts from zero in the tensor core (scale-d
    // 0 on its first wgmma) and is added to the running sum in IEEE f32;
    // within a step the table rows run from the last factor down to the
    // values, each factor's 8-code slices lo.hi, hi.lo, hi.hi (route 1's
    // terms and order of rows).
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    float acc[64], tmp[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tmp[i] = 0.f;
    int stage = 0;
    int held = -1;   // the plane stage whose wgmmas may still be in flight
    for (int step = 0; step < n_steps; ++step) {
      for (int j = rank; j >= 0; --j, ++stage) {
        const int ps = stage % kWgPlaneStages;
        mbar_wait(plane_full(ps), (stage / kWgPlaneStages) & 1);
        __syncwarp();   // wgmma is .aligned: the warp converged after its spin
        const uint32_t a_hi = base + ps * kWgStage + wg * 64 * 128;
        const uint32_t a_lo = a_hi + kWgPlane;
        const uint32_t b_hi = base + ps * kWgStage + 2 * kWgPlane;
        const uint32_t b_lo = b_hi + kWgPlane;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kStepK / 8; ++kk) {
          const uint32_t off = kk * 32;   // 8 TF32 along the swizzled row
          if (j != j_value) {
            wgmma_tf32_n128(tmp, sw128_desc(a_lo + off), sw128_desc(b_hi + off),
                            j < rank || kk > 0);
            wgmma_tf32_n128(tmp, sw128_desc(a_hi + off), sw128_desc(b_lo + off), 1);
            wgmma_tf32_n128(tmp, sw128_desc(a_hi + off), sw128_desc(b_hi + off), 1);
          } else {
            wgmma_tf32_n128(tmp, sw128_desc(a_hi + off), sw128_desc(b_hi + off),
                            j < rank || kk > 0);
          }
        }
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();   // the previous stage's products are done: free it
        } else {
          wgmma_wait<0>();
        }
        __syncwarp();
        if (held >= 0 && lane == 0) mbar_arrive(plane_empty(held));
        held = ps;
        if (j == 0) {
          fence_regs(tmp);
          if (lane == 0) mbar_arrive(plane_empty(ps));
          held = -1;
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += tmp[i];
        }
      }
    }
    // the accumulator's fragments: 8-column tile i holds (row g, columns
    // 8 i + 2 t, + 1) and (row g + 8, the same columns)
    float* dst = splits > 1 ? ws + static_cast<size_t>(blockIdx.z) * m_total * n_total : out;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (row >= m_total) continue;
      float* rp = dst + static_cast<size_t>(row) * n_total;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = n0 + 8 * i + 2 * t;
        if (col + 1 < n_total && (n_total & 1) == 0) {
          *reinterpret_cast<float2*>(rp + col) = make_float2(acc[4 * i + 2 * h],
                                                             acc[4 * i + 2 * h + 1]);
        } else {
          if (col < n_total) rp[col] = acc[4 * i + 2 * h];
          if (col + 1 < n_total) rp[col + 1] = acc[4 * i + 2 * h + 1];
        }
      }
    }
  }
  if (splits > 1)
    split_fixup(out, ws, counters, splits, m_total, n_total, m0, kWgTile, n0, kWgTile);
}

// ---------------------------------------------------------------------------
// route 2, M <= 16: f32 GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 128;   // 4 warps over interleaved rows of K
constexpr int kGemvWarps = 4;
constexpr int kGemvCols = 512;      // 32 lanes x 16 columns
constexpr int kChunkK = 32;         // K rows expanded per shared-memory chunk
constexpr int kRing = 4;            // rows of codes a warp keeps in flight

// The 16 codes of columns [col, col + 16) of one row, as raw words: one
// aligned 16-byte load (two where the row is not 16-byte aligned; off is the
// misalignment) or, at the very end of b, byte loads.
struct Window {
  uint4 u0, u1;
  int off;
};

__device__ __forceinline__ Window fetch(const uint8_t* __restrict__ b, size_t idx,
                                        size_t total) {
  Window w;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(b + idx);
  const uintptr_t base = addr & ~static_cast<uintptr_t>(15);
  w.off = static_cast<int>(addr & 15);
  if (base >= reinterpret_cast<uintptr_t>(b) &&
      base + 32 <= reinterpret_cast<uintptr_t>(b + total)) {
    const uint4* p = reinterpret_cast<const uint4*>(base);
    w.u0 = __ldg(p);
    w.u1 = w.off ? __ldg(p + 1) : make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint32_t x[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 16; ++i)
      if (idx + i < total) x[i >> 2] |= static_cast<uint32_t>(b[idx + i]) << (8 * (i & 3));
    w.u0 = make_uint4(x[0], x[1], x[2], x[3]);
    w.u1 = make_uint4(0u, 0u, 0u, 0u);
    w.off = 0;
  }
  return w;
}

__device__ __forceinline__ void window_words(const Window& w, uint32_t (&out)[4]) {
  uint32_t x[8] = {w.u0.x, w.u0.y, w.u0.z, w.u0.w, w.u1.x, w.u1.y, w.u1.z, w.u1.w};
  const int sh = w.off >> 2;
  if (sh & 2) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = x[i + 2];
  }
  if (sh & 1) {
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = x[i + 1];
  }
  const int bits = 8 * (w.off & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __funnelshift_r(x[i], x[i + 1], bits);
}

template <int MT>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[MT]) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MT; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i) v[i] = p[i];
  }
}

template <int MT>
__global__ void __launch_bounds__(kGemvThreads)
axo_gemv_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                const float* __restrict__ sv, const float* __restrict__ ft,
                const float* __restrict__ gt, float* __restrict__ out, float* __restrict__ ws,
                int* __restrict__ counters, int m_total, int n_total, int k_total, int rank,
                int n_codes, int splits, int k_split) {
  extern __shared__ __align__(16) float smem[];
  const int r1 = rank + 1;
  const int tsz = n_codes;
  constexpr int kPass = MT < 4 ? MT : 4;   // rows of partial sums reduced at a time
  float* tb = smem;   // (1+R, n_codes): [sv; g], then the warps' partial sums
  float* ta = tb + max(r1 * tsz, kGemvWarps * kPass * kGemvCols);   // (1+R, n_codes): [sv; f]
  float* work = ta + r1 * n_codes;   // the chunk's (kChunkK, 1+R, MT) activation values
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kGemvCols;
  const int m0 = blockIdx.y * MT;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k_total, kb + k_split);
  const int code_mask = n_codes - 1;
  const size_t total = static_cast<size_t>(k_total) * n_total;
  const int col = n0 + lane * 16;

  fill_table(ta, sv, ft, rank, n_codes);
  fill_table(tb, sv, gt, rank, n_codes);

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

  // warp w takes rows kb + w + 4t of the split; the codes of the next
  // kRing of its rows are in flight while it works on one
  constexpr int kPerChunk = kChunkK / kGemvWarps;   // rows a warp takes per chunk
  Window ring[kRing];
#pragma unroll
  for (int i = 0; i < kRing; ++i) {
    const int row = kb + warp + kGemvWarps * i;
    if (row < kend) ring[i] = fetch(b, static_cast<size_t>(row) * n_total + col, total);
  }
  for (int c0 = kb; c0 < kend; c0 += kChunkK) {
    const int rows = min(kChunkK, kend - c0);
    __syncthreads();   // the previous chunk is read before it is overwritten
    for (int e = tid; e < kChunkK * MT; e += kGemvThreads) {
      const int kk = e / MT;
      const int m = e - kk * MT;
      const bool in = kk < rows && m0 + m < m_total;
      const int code =
          in ? (a[static_cast<size_t>(m0 + m) * k_total + c0 + kk] & code_mask) : 0;
      float* dst = work + kk * r1 * MT + m;
      for (int j = 0; j < r1; ++j) dst[j * MT] = in ? ta[j * n_codes + code] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerChunk; ++i) {
      const int kk = warp + kGemvWarps * i;
      if (kk >= rows) break;
      const Window cur = ring[i % kRing];
      const int ahead = c0 + kk + kGemvWarps * kRing;
      if (ahead < kend)
        ring[i % kRing] = fetch(b, static_cast<size_t>(ahead) * n_total + col, total);
      uint32_t words[4];
      window_words(cur, words);
      int off[16];
#pragma unroll
      for (int c = 0; c < 16; ++c)
        off[c] = (words[c >> 2] >> (8 * (c & 3))) & code_mask;
      const float* av = work + kk * r1 * MT;
#pragma unroll 1
      for (int j = 0; j < r1; ++j) {
        float x[MT];
        load_rows<MT>(av + j * MT, x);
        const float* tbj = tb + j * tsz;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float w = tbj[off[c]];
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(x[m], w, acc[m][c]);
        }
      }
    }
  }

  // sum the 4 warps' partials in warp order, up to 4 rows at a time
  float* dst = splits > 1 ? ws + static_cast<size_t>(blockIdx.z) * m_total * n_total : out;
#pragma unroll
  for (int p0 = 0; p0 < MT; p0 += kPass) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPass; ++m) {
      float* red = tb + (warp * kPass + m) * kGemvCols + lane * 16;
#pragma unroll
      for (int c = 0; c < 16; c += 4)
        *reinterpret_cast<float4*>(red + c) =
            make_float4(acc[p0 + m][c], acc[p0 + m][c + 1], acc[p0 + m][c + 2],
                        acc[p0 + m][c + 3]);
    }
    __syncthreads();
    for (int e = tid; e < kPass * kGemvCols; e += kGemvThreads) {
      const int m = e / kGemvCols;
      const int cc = e - m * kGemvCols;
      const int row = m0 + p0 + m;
      const int n = n0 + cc;
      if (row >= m_total || n >= n_total) continue;
      float s = tb[m * kGemvCols + cc];
      for (int w = 1; w < kGemvWarps; ++w) s += tb[(w * kPass + m) * kGemvCols + cc];
      dst[static_cast<size_t>(row) * n_total + n] = s;
    }
  }
  if (splits > 1)
    split_fixup(out, ws, counters, splits, m_total, n_total, m0, MT, n0, kGemvCols);
}

// ---------------------------------------------------------------------------
// route 5, M <= 16: tensor cores at a few rows, one expansion for all of them
// ---------------------------------------------------------------------------

// A block of 8 warps owns Rows = 8 NT activation rows (NT = 1 up to 8 rows,
// 2 up to 16) and WN x 64 weight columns: WN warps along N, 8 / WN along K.
// Each warp owns 4 weight tiles of 16 columns (the MMA's 16-row A side) x NT
// activation tiles of 8 rows (its n8 side), as the skinny route; a lane's 8
// columns are adjacent (tile i's row g is column 8g + i, row g + 8 column
// 8g + 4 + i), so one 8-byte load gives a lane its 8 codes of a K row.  The
// table rows (1+R = R1 of them) are a template parameter: every loop over
// them unrolls.
constexpr int kSmThreads = 256;
constexpr int kSmWarps = 8;
constexpr int kSmWt = 4;          // 16-column weight tiles a warp
constexpr int kSmCodes = 256;     // code slots of each table plane, whatever the codes
constexpr int kSmPlane = kSmCodes * 8 * 16;   // a plane of 4 entries in 8 copies, bytes

template <int NT, int WN, int R1>
struct Small {
  static constexpr int kWk = kSmWarps / WN;       // warps along K
  static constexpr int kGroups = 4 / kWk;         // 8-code groups a warp takes a step
  static constexpr int kCols = WN * 16 * kSmWt;   // weight columns a block
  static constexpr int kRows = 8 * NT;            // activation rows a block
  static constexpr int kAcc = kSmWt * NT * 4;     // a lane's accumulators
  static constexpr int kFull = R1 / 4;            // planes of 4 table rows
  static constexpr int kRem = R1 % 4;             // table rows after them
  static constexpr int kLast = kRem == 3 ? 4 : kRem;   // floats of the last plane an entry
  static constexpr int kXStep = 4 * R1 * NT * 32 * 2;  // floats of a step's activation fragments
  static constexpr int kTable = kFull * kSmPlane + (kLast == 4 ? kSmPlane : kLast ? kSmPlane / 2 : 0);
};

// The weight side's table in shared memory: the R1 entries of each code
// [sv; g] in planes of 4 (entries 4p .. 4p + 3, a float4) held in 8 copies,
// code c's copy q at byte 128 c + 16 q, so that lane l gathers copy l % 8 and
// the 8 lanes of a quarter warp, which a 16-byte load serves together, never
// share a bank; then the last 1 entry (R1 = 9 at rank 8) in 16 copies of a
// float (at 64 c + 4 (l % 16): lanes l and l + 16 share a bank only where
// their codes differ and have the same parity), 2 entries in 8 copies of a
// float2, or 3 as a full plane.  Planes hold 256 code slots (a code's slot
// holds the entries of the code masked to the table's codes), so that a
// code's offset in one plane is its offset in every plane.  The region then
// holds the K warps' partial sums.
template <int NT, int WN, int R1>
__host__ __device__ constexpr int small_table_bytes() {
  using S = Small<NT, WN, R1>;
  return S::kTable > (S::kWk - 1) * WN * 32 * S::kAcc * 4 ? S::kTable
                                                         : (S::kWk - 1) * WN * 32 * S::kAcc * 4;
}

// the table region, then two 32-code steps' (4 groups, R1, NT, 32 lanes)
// float2 activation fragments
template <int NT, int WN, int R1>
size_t small_smem() {
  return static_cast<size_t>(small_table_bytes<NT, WN, R1>()) +
         2 * Small<NT, WN, R1>::kXStep * sizeof(float);
}

// The 8 codes of columns [col, col + 8) of row k of b, as two words: one
// 8-byte load where N and b are 8-byte aligned (then a lane's columns are all
// in N or all past it), else three 4-byte loads and a funnel shift, or at b's
// very ends byte loads.  Rows at or past kend and columns past N read 0.
__device__ __forceinline__ uint2 small_codes(const uint8_t* __restrict__ b, int k, int kend,
                                             int col, int n_total, size_t total, bool vec) {
  if (k >= kend || col >= n_total) return make_uint2(0u, 0u);
  const size_t idx = static_cast<size_t>(k) * n_total + col;
  if (vec) return __ldg(reinterpret_cast<const uint2*>(b + idx));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(b + idx);
  const uintptr_t base = addr & ~static_cast<uintptr_t>(3);
  if (base >= reinterpret_cast<uintptr_t>(b) && base + 12 <= reinterpret_cast<uintptr_t>(b + total)) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(base);
    const uint32_t w0 = __ldg(p), w1 = __ldg(p + 1), w2 = __ldg(p + 2);
    const int bits = 8 * static_cast<int>(addr & 3);
    return make_uint2(__funnelshift_r(w0, w1, bits), __funnelshift_r(w1, w2, bits));
  }
  uint32_t w[2] = {0u, 0u};
  for (int i = 0; i < 8; ++i)
    if (idx + i < total && col + i < n_total)
      w[i >> 2] |= static_cast<uint32_t>(b[idx + i]) << (8 * (i & 3));
  return make_uint2(w[0], w[1]);
}

// Shared-memory loads at 32-bit shared addresses (a constant added to the
// address folds into the load's offset)
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

template <int NT, int WN, int R1, int IL, int MB>
__global__ void __launch_bounds__(kSmThreads, MB)
axo_small_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 const float* __restrict__ sv, const float* __restrict__ ft,
                 const float* __restrict__ gt, float* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ counters, int m_total, int n_total, int k_total,
                 int n_codes, int splits, int k_split, bool vec) {
  using S = Small<NT, WN, R1>;
  constexpr int WT = kSmWt;
  constexpr int kRank = R1 - 1;
  constexpr int kPlanes = S::kFull + (S::kRem > 0);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int wn = warp % WN;
  const int kw = warp / WN;
  const int n0 = blockIdx.x * S::kCols;
  const int m0 = blockIdx.y * S::kRows;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k_total, kb + k_split);
  const int n_steps = (kend - kb + kStepK - 1) / kStepK;
  const uint32_t code_mask = n_codes - 1;
  const int col = n0 + wn * 16 * WT + (lane >> 2) * 2 * WT;   // the lane's 8 adjacent columns
  const size_t total = static_cast<size_t>(k_total) * n_total;
  char* const tab = reinterpret_cast<char*>(smem);
  float* const xbuf = smem + small_table_bytes<NT, WN, R1>() / 4;

  // the weight side's table: [sv; g] staged row by row in the activation
  // buffers (each thread's loads in flight together), then written out as
  // planes
  bool exact = true;
  for (int i0 = tid; i0 < R1 * n_codes; i0 += 8 * kSmThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kSmThreads;
      const int j = i / n_codes;
      const int c = i - j * n_codes;
      v[u] = i >= R1 * n_codes ? 0.f : j == 0 ? sv[c] : gt[c * kRank + j - 1];
      if (i < n_codes) exact = exact && (__float_as_uint(v[u]) & 0x1fffu) == 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * kSmThreads < R1 * n_codes) xbuf[i0 + u * kSmThreads] = v[u];
  }
  const bool sv_exact = __syncthreads_and(exact);
  auto raw = [&](int j, int c) { return j < R1 ? xbuf[j * n_codes + (c & code_mask)] : 0.f; };
  for (int i = tid; i < S::kTable / 4; i += kSmThreads) {
    const int p = i / (kSmPlane / 4);
    const int w = i - p * (kSmPlane / 4);   // the word in its plane
    const int j = 4 * p;
    if (p < S::kFull || S::kLast == 4) {
      const int c = w >> 5;                 // 32 words a code
      reinterpret_cast<float*>(tab)[i] = raw(j + (w & 3), c);
    } else if (S::kLast == 1) {
      reinterpret_cast<float*>(tab)[i] = raw(j, w >> 4);
    } else {
      reinterpret_cast<float*>(tab)[i] = raw(j + (w & 1), w >> 4);
    }
  }

  // the activation side: item e = tid + 256 u is code k0 + 8s + 2t + h of
  // row 8 u + g (e's bits: h, t, g, s), written with its R1 values to
  // fragment slot (s, j, u, lane 4g + t), word h, where the MMA's B operand
  // reads them; codes past M and kend expand to zeros
  int acode[NT];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int k = k0 + 8 * ((tid >> 6) & 3) + 2 * ((tid >> 1) & 3) + (tid & 1);
      const int m = m0 + 8 * u + ((tid >> 3) & 7);
      acode[u] = m < m_total && k < kend ? a[static_cast<size_t>(m) * k_total + k] & code_mask
                                         : -1;
    }
  };
  auto expand = [&](float* dst) {
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      float* d = dst + ((((tid >> 6) & 3) * R1 * NT + u) * 32 + ((tid >> 1) & 31)) * 2 + (tid & 1);
      const int c = acode[u];
      float v[R1];
#pragma unroll
      for (int j = 0; j < R1; ++j)
        v[j] = c < 0 ? 0.f : j == 0 ? __ldg(sv + c) : __ldg(ft + c * kRank + j - 1);
#pragma unroll
      for (int j = 0; j < R1; ++j) d[j * NT * 64] = v[j];
    }
  };
  if (n_steps > 0) load_a(kb);
  __syncthreads();   // the planes are written; the staged rows are read
  if (n_steps > 0) {
    expand(xbuf);
    if (n_steps > 1) load_a(kb + kStepK);
  }
  __syncthreads();

  float acc[WT][NT][4];
#pragma unroll
  for (int i = 0; i < WT; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  // the warp's groups: s = kw * kGroups + gi of each step; the next group's
  // codes are in flight while it works on one
  auto group_row = [&](int st, int gi) {
    return kb + st * kStepK + 8 * (kw * S::kGroups + gi) + 2 * t;
  };
  uint2 nc0 = small_codes(b, group_row(0, 0), kend, col, n_total, total, vec);
  uint2 nc1 = small_codes(b, group_row(0, 0) + 1, kend, col, n_total, total, vec);
  // the lane's copy in a full plane, and in the last one, as shared addresses
  const uint32_t lane_tab = smem_addr(tab) + (lane & 7) * 16;
  const uint32_t lane_last = smem_addr(tab) + S::kFull * kSmPlane +
                             (S::kLast == 1 ? (lane & 15) * 4 : (lane & 7) * 8);
  const uint32_t lane_x = smem_addr(xbuf) + lane * 8;

  for (int st = 0; st < n_steps; ++st) {
    const uint32_t xs = lane_x + (st & 1) * S::kXStep * 4;
#pragma unroll
    for (int gi = 0; gi < S::kGroups; ++gi) {
      // each 8-code group's sum starts from zero in the tensor core (25 MMAs
      // at most a chain, each rounding toward zero) and is added in IEEE f32
      float tmp[WT][NT][4];
#pragma unroll
      for (int i = 0; i < WT; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[i][nt][e] = 0.f;
      const uint32_t cw[4] = {nc0.x, nc0.y, nc1.x, nc1.y};   // rows 8s + 2t, 8s + 2t + 1
      {
        const int row = gi + 1 < S::kGroups ? group_row(st, gi + 1) : group_row(st + 1, 0);
        nc0 = small_codes(b, row, kend, col, n_total, total, vec);
        nc1 = small_codes(b, row + 1, kend, col, n_total, total, vec);
      }
      const int s = kw * S::kGroups + gi;
      // planes from the last down, each plane's rows from its last: the table
      // rows from the last factor down to the values, each factor x_lo.w_hi,
      // x_hi.w_lo, x_hi.w_hi (route 1's order)
#pragma unroll
      for (int p = kPlanes - 1; p >= 0; --p) {
        const int nj = p < S::kFull ? 4 : S::kRem;
        uint32_t xh[4][NT][2], xl[4][NT][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj >= nj) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 v = lds64(xs + (((s * R1 + 4 * p + jj) * NT + nt) * 32) * 8);
            split_tf32(v.x, xh[jj][nt][0], xl[jj][nt][0]);
            split_tf32(v.y, xh[jj][nt][1], xl[jj][nt][1]);
          }
        }
        // A operand of tile i: (row g, slot t) = code (8s + 2t, 8g + i), (row
        // g + 8, slot t) = (8s + 2t, 8g + 4 + i), then slots t + 4: row 8s +
        // 2t + 1; IL tiles at a time, their MMA chains interleaved
#pragma unroll
        for (int i0 = 0; i0 < WT; i0 += IL) {
          // code (row 8s + 2t + (e >> 1), column 8g + 4 (e & 1) + i): byte i of
          // its word, 128 bytes a code in a full plane, 64 in the last
          float4 wv[IL][4];
#pragma unroll
          for (int ii = 0; ii < IL; ++ii) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t c = __byte_perm(cw[e], 0u, 0x4440 + i0 + ii);
              if (p < S::kFull || S::kLast == 4) {
                wv[ii][e] = lds128(lane_tab + c * 128 + p * kSmPlane);
              } else if (S::kLast == 1) {
                wv[ii][e] = make_float4(lds32(lane_last + c * 64), 0.f, 0.f, 0.f);
              } else {
                const float2 x = lds64(lane_last + c * 64);
                wv[ii][e] = make_float4(x.x, x.y, 0.f, 0.f);
              }
            }
          }
#pragma unroll
          for (int jj = 3; jj >= 0; --jj) {
            if (jj >= nj) continue;
            const bool values = p == 0 && jj == 0 && sv_exact;   // one pass, exact
            uint32_t wh[IL][4], wl[IL][4];
#pragma unroll
            for (int ii = 0; ii < IL; ++ii) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float4& v = wv[ii][e];
                const float w = jj == 0 ? v.x : jj == 1 ? v.y : jj == 2 ? v.z : v.w;
                if (values)
                  wh[ii][e] = __float_as_uint(w);   // exact in TF32
                else
                  split_tf32(w, wh[ii][e], wl[ii][e]);
              }
            }
            if (values) {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int ii = 0; ii < IL; ++ii)
                  mma_tf32(tmp[i0 + ii][nt], wh[ii], xh[0][nt][0], xh[0][nt][1]);
              continue;
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
              for (int ii = 0; ii < IL; ++ii)
                mma_tf32(tmp[i0 + ii][nt], wh[ii], xl[jj][nt][0], xl[jj][nt][1]);
#pragma unroll
              for (int ii = 0; ii < IL; ++ii)
                mma_tf32(tmp[i0 + ii][nt], wl[ii], xh[jj][nt][0], xh[jj][nt][1]);
#pragma unroll
              for (int ii = 0; ii < IL; ++ii)
                mma_tf32(tmp[i0 + ii][nt], wh[ii], xh[jj][nt][0], xh[jj][nt][1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < WT; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] += tmp[i][nt][e];
    }
    if (st + 1 < n_steps) {
      // the other buffer was last read before the previous barrier
      expand(xbuf + ((st + 1) & 1) * S::kXStep);
      if (st + 2 < n_steps) load_a(kb + (st + 2) * kStepK);
    }
    __syncthreads();
  }

  // the K warps' sums, added in warp order through the table's region (no
  // longer read): warps kw > 0 write theirs, warp kw = 0 of each column
  // range adds them to its own and stores
  if constexpr (S::kWk > 1) {
    float* red = smem;
    if (kw > 0) {
      float* dst = red + ((kw - 1) * WN + wn) * S::kAcc * 32 + lane;
#pragma unroll
      for (int i = 0; i < WT; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[((i * NT + nt) * 4 + e) * 32] = acc[i][nt][e];
    }
    __syncthreads();
    if (kw == 0) {
      for (int w = 1; w < S::kWk; ++w) {
        const float* src = red + ((w - 1) * WN + wn) * S::kAcc * 32 + lane;
#pragma unroll
        for (int i = 0; i < WT; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][nt][e] += src[((i * NT + nt) * 4 + e) * 32];
      }
    }
  }

  // the accumulator is out^T: (column 8g + 4 (e >> 1) + i, row 8 nt + 2t + (e & 1))
  float* dst = splits > 1 ? ws + static_cast<size_t>(blockIdx.z) * m_total * n_total : out;
  if (kw == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + nt * 8 + 2 * t + h;
        if (row >= m_total) continue;
        float* o = dst + static_cast<size_t>(row) * n_total + col;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = col + 4 * half;
          const float4 v = make_float4(acc[0][nt][2 * half + h], acc[1][nt][2 * half + h],
                                       acc[2][nt][2 * half + h], acc[3][nt][2 * half + h]);
          if (n_total % 4 == 0) {
            if (c < n_total) *reinterpret_cast<float4*>(o + 4 * half) = v;
          } else {
            const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c + i < n_total) o[4 * half + i] = w[i];
          }
        }
      }
    }
  }
  if (splits > 1)
    split_fixup(out, ws, counters, splits, m_total, n_total, m0, S::kRows, n0, S::kCols);
}

// Dynamic shared memory a block of each route takes, in the layout the kernels
// above carve it into.
size_t mma_smem(int r1, int n_codes) {
  return (2 * static_cast<size_t>(r1) * n_codes) * sizeof(float) + 2 * (kABytes + kBBytes);
}

template <int NTW, int MW>
size_t skinny_smem(int r1, int n_codes) {
  using S = Skinny<NTW, MW>;
  return (2 * static_cast<size_t>(r1) * n_codes) * sizeof(float) + 2 * (S::kABytes + S::kBBytes);
}

size_t gemv_smem(int mt, int r1, int n_codes) {
  const int pass = mt < 4 ? mt : 4;
  return (static_cast<size_t>(max(r1 * n_codes, kGemvWarps * pass * kGemvCols)) +
          static_cast<size_t>(r1) * n_codes + static_cast<size_t>(kChunkK) * r1 * mt) *
         sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int MT>
cudaError_t launch_gemv(const uint8_t* a, const uint8_t* b, const float* sv, const float* ft,
                        const float* gt, float* out, float* ws, int* counters, int m, int n,
                        int k, int rank, int n_codes, int splits, int k_split,
                        size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(axo_gemv_kernel<MT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kGemvCols - 1) / kGemvCols, (m + MT - 1) / MT, splits);
  axo_gemv_kernel<MT><<<grid, kGemvThreads, smem, stream>>>(
      a, b, sv, ft, gt, out, ws, counters, m, n, k, rank, n_codes, splits, k_split);
  return cudaGetLastError();
}

template <int NTW, int MW>
cudaError_t launch_skinny(const uint8_t* a, const uint8_t* b, const float* sv, const float* ft,
                          const float* gt, float* out, float* ws, int* counters, int n_counters,
                          int m, int n, int k, int rank, int n_codes, int splits, int k_split,
                          size_t smem, cudaStream_t stream, bool& mismatch) {
  using S = Skinny<NTW, MW>;
  const dim3 grid((n + S::kCols - 1) / S::kCols, (m + S::kRows - 1) / S::kRows, splits);
  mismatch = k_split % kStepK || smem != skinny_smem<NTW, MW>(rank + 1, n_codes) ||
             (splits > 1 && static_cast<long long>(grid.x) * grid.y > n_counters);
  if (mismatch) return cudaSuccess;
  cudaError_t err = allow_smem(axo_skinny_kernel<NTW, MW>, smem);
  if (err != cudaSuccess) return err;
  const bool a_vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  axo_skinny_kernel<NTW, MW><<<grid, kSkThreads, smem, stream>>>(
      a, b, sv, ft, gt, out, ws, counters, m, n, k, rank, n_codes, splits, k_split, a_vec, b_vec);
  return cudaGetLastError();
}

// Route 5 at Rows = 8 NT, WN x 64 columns a block, R1 table rows, IL tiles'
// MMA chains interleaved and MB blocks an SM; sets `mismatch` where the plan
// disagrees with this file's layout.
template <int NT, int WN, int R1, int IL, int MB>
cudaError_t launch_small(const uint8_t* a, const uint8_t* b, const float* sv, const float* ft,
                         const float* gt, float* out, float* ws, int* counters, int n_counters,
                         int m, int n, int k, int n_codes, int splits, int k_split, size_t smem,
                         cudaStream_t stream, bool& mismatch) {
  using S = Small<NT, WN, R1>;
  const dim3 grid((n + S::kCols - 1) / S::kCols, (m + S::kRows - 1) / S::kRows, splits);
  mismatch = k_split % kStepK || smem != small_smem<NT, WN, R1>() ||
             (splits > 1 && static_cast<long long>(grid.x) * grid.y > n_counters);
  if (mismatch) return cudaSuccess;
  cudaError_t err = allow_smem(axo_small_kernel<NT, WN, R1, IL, MB>, smem);
  if (err != cudaSuccess) return err;
  const bool vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 8 == 0;
  axo_small_kernel<NT, WN, R1, IL, MB><<<grid, kSmThreads, smem, stream>>>(
      a, b, sv, ft, gt, out, ws, counters, m, n, k, n_codes, splits, k_split, vec);
  return cudaGetLastError();
}

// A row-major (rows, cols) uint8 matrix as a 2-d tensor map (cols, rows) with
// boxes of box_cols x box_rows, unswizzled; elements past its edges read as
// zero.  False where libcuda refuses it (a base or row stride off 16 bytes).
bool code_map(CUtensorMap* map, const void* p, int rows, int cols, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Route 4; sets `refused` where a code matrix cannot be mapped and `mismatch`
// where the plan disagrees with this file's layout.
cudaError_t launch_wgmma(const uint8_t* a, const uint8_t* b, const float* sv, const float* ft,
                         const float* gt, float* out, float* ws, int* counters, int n_counters,
                         int m, int n, int k, int rank, int n_codes, int splits, int k_split,
                         size_t smem, cudaStream_t stream, bool& mismatch, bool& refused) {
  const dim3 grid((n + kWgTile - 1) / kWgTile, (m + kWgTile - 1) / kWgTile, splits);
  mismatch = k_split % kStepK || smem != wgmma_smem(rank + 1, n_codes) ||
             (splits > 1 && static_cast<long long>(grid.x) * grid.y > n_counters);
  refused = false;
  if (mismatch) return cudaSuccess;
  CUtensorMap ta, tb;
  refused = !(code_map(&ta, a, m, k, kStepK, kWgTile) && code_map(&tb, b, k, n, kWgTile, kStepK));
  if (refused) return cudaSuccess;
  cudaError_t err = allow_smem(axo_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  axo_wgmma_kernel<<<grid, kWgThreads, smem, stream>>>(ta, tb, sv, ft, gt, out, ws, counters, m,
                                                       n, k, rank, n_codes, splits, k_split);
  return cudaGetLastError();
}

}  // namespace

// route 0 = GEMV (rows = MT, 1/2/4/8 rows per block), 1 = tensor cores, 2 =
// skinny tensor cores (rows = 24 or 80 per block), 3 = wgmma (128 x 128
// tiles), 4 = small-M tensor cores (rows = 8 or 16, cols = 256 or 512 per
// block, rank 8; cols is read by route 4 only).  With splits > 1, ws holds
// splits * m * n floats of partials and counters n_counters zeroed ints, one
// per output tile (left zeroed).  smem is the dynamic shared memory plan()
// computed for the launch.  Returns a cudaError_t, kLayoutMismatch where the
// plan disagrees with this file's layout: smem not what the route's block
// takes, a split not whole k-steps, a row or column count or rank the route
// is not built for, or fewer counters than output tiles;
// or kRefused where route 3 cannot map a code matrix (its base or row stride
// off 16 bytes).
constexpr int kLayoutMismatch = -1;
constexpr int kRefused = -2;

extern "C" int axo_matmul_launch(const void* a, const void* b, const void* sv,
                                 const void* ft, const void* gt, void* out, void* ws,
                                 void* counters, int n_counters, int m, int n, int k,
                                 int rank, int n_codes, int route, int rows, int cols,
                                 int splits, int k_split, long long smem, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const uint8_t*>(a);
  const auto* bp = static_cast<const uint8_t*>(b);
  const auto* svp = static_cast<const float*>(sv);
  const auto* fp = static_cast<const float*>(ft);
  const auto* gp = static_cast<const float*>(gt);
  auto* op = static_cast<float*>(out);
  auto* wp = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counters);
  const size_t sm = static_cast<size_t>(smem);
  const int r1 = rank + 1;
  if (route == 1) {
    const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM, splits);
    if (k_split % kStepK || sm != mma_smem(r1, n_codes) ||
        (splits > 1 && static_cast<long long>(grid.x) * grid.y > n_counters))
      return kLayoutMismatch;
    cudaError_t err = allow_smem(axo_mma_kernel, sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool a_vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const bool b_vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    axo_mma_kernel<<<grid, kMmaThreads, sm, s>>>(ap, bp, svp, fp, gp, op, wp, cnt, m, n, k,
                                                 rank, n_codes, splits, k_split, a_vec, b_vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == 2) {
    bool mismatch = true;
    cudaError_t err = cudaSuccess;
    if (rows == 24)
      err = launch_skinny<3, 1>(ap, bp, svp, fp, gp, op, wp, cnt, n_counters, m, n, k, rank,
                                n_codes, splits, k_split, sm, s, mismatch);
    else if (rows == 80)
      err = launch_skinny<5, 2>(ap, bp, svp, fp, gp, op, wp, cnt, n_counters, m, n, k, rank,
                                n_codes, splits, k_split, sm, s, mismatch);
    return mismatch ? kLayoutMismatch : static_cast<int>(err);
  }
  if (route == 3) {
    bool mismatch = true, refused = false;
    const cudaError_t err =
        rows == kWgTile ? launch_wgmma(ap, bp, svp, fp, gp, op, wp, cnt, n_counters, m, n, k,
                                       rank, n_codes, splits, k_split, sm, s, mismatch, refused)
                        : cudaSuccess;
    return mismatch ? kLayoutMismatch : refused ? kRefused : static_cast<int>(err);
  }
  if (route == 4) {
    // 8 rows: two blocks an SM, one tile's MMA chain at a time; 16 rows: one
    // block an SM (its registers), four tiles' chains interleaved
    using Fn = decltype(&launch_small<1, 4, 9, 1, 2>);
    Fn fn = nullptr;
    if (r1 == 9 && rows == 8)
      fn = cols == 256 ? &launch_small<1, 4, 9, 1, 2> : cols == 512 ? &launch_small<1, 8, 9, 1, 2>
                                                       : nullptr;
    else if (r1 == 9 && rows == 16)
      fn = cols == 256 ? &launch_small<2, 4, 9, 4, 1> : cols == 512 ? &launch_small<2, 8, 9, 4, 1>
                                                       : nullptr;
    bool mismatch = true;
    const cudaError_t err = fn == nullptr ? cudaSuccess
                                          : fn(ap, bp, svp, fp, gp, op, wp, cnt, n_counters, m, n,
                                               k, n_codes, splits, k_split, sm, s, mismatch);
    return mismatch ? kLayoutMismatch : static_cast<int>(err);
  }
  auto* fn = rows == 1 ? &launch_gemv<1> : rows == 2 ? &launch_gemv<2>
            : rows == 4 ? &launch_gemv<4> : rows == 8 ? &launch_gemv<8> : nullptr;
  const long long tiles = static_cast<long long>((n + kGemvCols - 1) / kGemvCols) *
                          ((m + rows - 1) / (rows > 0 ? rows : 1));
  if (route != 0 || fn == nullptr || k_split % kChunkK || sm != gemv_smem(rows, r1, n_codes) ||
      (splits > 1 && tiles > n_counters))
    return kLayoutMismatch;
  const cudaError_t err = fn(ap, bp, svp, fp, gp, op, wp, cnt, m, n, k, rank, n_codes, splits,
                             k_split, sm, s);
  return static_cast<int>(err);
}
