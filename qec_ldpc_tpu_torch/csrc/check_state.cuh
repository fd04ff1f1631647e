// The compressed min-sum check state, written once for the three kernels that
// keep it instead of a check's messages: min_sum.cu (K2/K4), lifted_min_sum.cu
// (K5) and layered_min_sum.cu (K3).
//
// Per check, over its edges' values t (V for the flooding kernels, the
// layered kernel's t = q - r): min1 and min2 of |t| over the non-NaN edges,
// the edge index of min1 (kNoArg when no edge is below +inf), the NaN count
// and the parity of the edges' signs (t < 0) xor the syndrome bit.  From it,
// with the edge's own t, the normalized min-sum message of edge l,
//   s * ((alpha * prod_{l' != l} sign t) * min_{l' != l} |t|),
// is rebuilt bit for bit, where the reference takes its leave-one-out
// minimum as a NaN-propagating prefix/suffix minimum (like jnp.minimum):
//   * NaN when another edge is NaN, else min2 when l is the argmin, else
//     min1: minima do not depend on order, a tie puts the later edge in
//     min2 (strict <), and |t| of +-0.0 is +0.0 on both sides;
//   * the sign: products of +-1 are exact, and (+-alpha) * m rounds
//     symmetrically, so s * ((alpha * sgn) * m) = (neg ? -alpha : alpha) * m
//     with neg = parity xor (own t < 0); sign(NaN) and sign(-0.0) are +1,
//     as in the reference (t < 0 is false for both).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kNoArg = 31;  // argmin field when no edge is below +inf

struct CheckState {
  float m1, m2;
  unsigned arg, nans, neg;
};

__device__ __forceinline__ CheckState state_begin(unsigned syndrome_bit) {
  return CheckState{INFINITY, INFINITY, kNoArg, 0u, syndrome_bit};
}

// Fold edge l's value t into the state, edges in any order.  Written with
// selects, not branches: a NaN compares false (so it moves no minimum) and
// fminf ignores it; a = min1 or min2 is the same value, the same bits (every
// |t| is +0.0 or above).  As an if/else chain the compiler branched per
// edge and the min-sum kernel ran 9% slower.
__device__ __forceinline__ void state_add(CheckState& s, float t, unsigned l) {
  const float a = fabsf(t);
  const bool below_m1 = a < s.m1;
  s.neg ^= (t < 0.0f) ? 1u : 0u;
  s.nans += isnan(t) ? 1u : 0u;
  s.m2 = below_m1 ? s.m1 : fminf(a, s.m2);
  s.m1 = fminf(a, s.m1);
  s.arg = below_m1 ? l : s.arg;
}

// The message of edge l: its leave-one-out minimum (NaN when another edge
// is NaN, min2 when l is the argmin, else min1) times +-alpha.
__device__ __forceinline__ float loo_message(float m1, float m2, bool is_arg,
                                             unsigned nans, bool own_nan,
                                             bool neg, float alpha) {
  const bool nan_other = nans > (own_nan ? 1u : 0u);
  const float loo_min = nan_other ? NAN : (is_arg ? m2 : m1);
  return (neg ? -alpha : alpha) * loo_min;
}

// The flooding kernels' stored form: {min1, min2} as one float2 beside a
// meta word arg | nans << 8 | neg << 16 (12 bytes per check).
__device__ __forceinline__ unsigned flood_meta(const CheckState& s) {
  return s.arg | (s.nans << 8) | (s.neg << 16);
}

// The message of edge l from the flooding form, given the edge's own V.
__device__ __forceinline__ float flood_message(float2 m, unsigned meta,
                                               unsigned l, float own,
                                               float alpha) {
  const bool neg = ((meta >> 16) & 1u) ^ (own < 0.0f);
  return loo_message(m.x, m.y, (meta & 31u) == l, (meta >> 8) & 31u,
                     isnan(own), neg, alpha);
}

}  // namespace
