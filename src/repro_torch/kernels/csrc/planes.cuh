// Per-row product planes of a signed approximate multiplier, on the device.
//
// Shared by the BEHAV kernel K2 (char_kernels.cu) and the table-GEMV kernels
// K4/K5 (app_kernels.cu).  A config's approximate product of operand codes
// (a, b) is
//
//   sum_r planes[r][pair_r(a)][b] << 2r,   pair_r(a) = 2*bit_2r(a) + bit_2r+1(a)
//
// over its (R, 4, B) int32 planes (16 KiB at 8 bits), which a block either
// gathers from the precomputed row tables or synthesizes here from the
// config's (R,) keep masks with the carry-chain model of
// operator_model._chain_eval (W = n_bits + 2 columns, the low n_bits + 1 of
// them removable).
//
// The first designs of K2 and K5 evaluate that chain bit by bit
// (chain_eval, synthesize).  The redesigns use its closed form (Column): a
// removed column zeroes its sum bit and its carry out, so the chain is the
// ordinary sum of the operands with the removed columns cleared, cleared
// once more: ((t1 & keep) + (t2 & keep)) & keep.  At a removed column both
// operand bits are 0, so the ordinary sum makes no carry out of it and its
// sum bit is the carry in, which the last mask drops.

#pragma once

#include <cuda_runtime.h>

namespace rowplanes {

// operator_model._chain_eval on int32: carry-truncated W-bit add of t1 + t2
// under the keep mask (columns >= cpr always kept), read as two's complement.
__device__ __forceinline__ int chain_eval(int t1, int t2, int mask, int w,
                                          int cpr) {
  int s = 0;
  int c = 0;
  for (int j = 0; j < w; ++j) {
    const int t1j = (t1 >> j) & 1;
    const int t2j = (t2 >> j) & 1;
    const int p = t1j ^ t2j;
    const int g = t1j & t2j;
    int sj = p ^ c;
    int cn = p ? c : g;
    if (j < cpr) {
      const int kept = (mask >> j) & 1;
      sj &= kept;
      cn &= kept;
    }
    s |= sj << j;
    c = cn;
  }
  return (s & (1 << (w - 1))) ? s - (1 << w) : s;
}

// All threads of the block write the (R, 4, B) planes of one config whose
// per-row masks are mask_row[0..R).  Plane p of row r adds t1 = a0 ? B : 0
// and t2 = a1 ? (+/-B << 1) : 0 (p = 2*a0 + a1; the top row subtracts).
// The caller synchronizes the block before reading the planes.
__device__ __forceinline__ void synthesize(int* planes, const int* mask_row,
                                           int rows, int n_bits) {
  const int b_n = 1 << n_bits;
  const int half = b_n >> 1;
  const int w_bits = n_bits + 2;
  const int cpr = n_bits + 1;
  const int modw = (1 << w_bits) - 1;
  for (int i = threadIdx.x; i < rows * 4 * b_n; i += blockDim.x) {
    const int r = i / (4 * b_n);
    const int p = (i >> n_bits) & 3;
    const int b = i & (b_n - 1);
    const int bs = b >= half ? b - b_n : b;
    const int bx = (r == rows - 1) ? -bs : bs;
    const int t1 = ((p >> 1) & 1) ? (bs & modw) : 0;
    const int t2 =
        (p & 1) ? (static_cast<int>(static_cast<unsigned>(bx) << 1) & modw) : 0;
    planes[i] = chain_eval(t1, t2, mask_row[r], w_bits, cpr);
  }
}

// Approximate product of operand codes (a, b) from staged planes.  Left
// shifts of negative row values go through unsigned.
__device__ __forceinline__ int approx_product(const int* planes, int rows,
                                              int n_bits, int a, int b) {
  int approx = 0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const int pair = (((a >> (2 * r)) & 1) << 1) | ((a >> (2 * r + 1)) & 1);
    const int v = planes[((r * 4 + pair) << n_bits) + b];
    approx += static_cast<int>(static_cast<unsigned>(v) << (2 * r));
  }
  return approx;
}

// One operand column b of a config's planes, in closed form: value(p, top,
// keep) is plane p of a row whose keep mask (keep_of) is keep, top for the
// last (subtracting) row, equal to chain_eval's.
struct Column {
  int t1, t2, t2_top, sign;  // B, +B << 1 and -B << 1 modulo 2^W; 2^(W-1)

  __device__ __forceinline__ Column(int b, int n_bits) {
    const int b_n = 1 << n_bits;
    const int bs = b >= (b_n >> 1) ? b - b_n : b;
    const int modw = (1 << (n_bits + 2)) - 1;
    t1 = bs & modw;
    t2 = static_cast<int>(static_cast<unsigned>(bs) << 1) & modw;
    t2_top = static_cast<int>(static_cast<unsigned>(-bs) << 1) & modw;
    sign = 1 << (n_bits + 1);
  }

  // The row's removable columns 0..n_bits as its mask keeps them, and the
  // sign column W - 1 = n_bits + 1, which is always kept.
  __device__ __forceinline__ int keep_of(int mask) const {
    return (mask & (sign - 1)) | sign;
  }

  __device__ __forceinline__ int value(int p, bool top, int keep) const {
    const int x = (p & 2) ? (t1 & keep) : 0;
    const int y = (p & 1) ? ((top ? t2_top : t2) & keep) : 0;
    const int s = (x + y) & keep;
    return (s ^ sign) - sign;  // W-bit two's complement
  }
};

}  // namespace rowplanes
