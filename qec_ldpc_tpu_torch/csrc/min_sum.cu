// Normalized min-sum belief propagation (LLR domain) over a circulant Tanner
// graph: the whole decode loop of one graph, for a batch of syndromes, in ONE
// launch, with an optional per-edge damping operand (the relay decoder).
//
// Replaces two TPU kernels, which compute the same function:
//   * qec_ldpc_tpu/kernels/min_sum_pallas.py::min_sum_run_pallas (P < 768)
//   * qec_ldpc_tpu/kernels/min_sum_wide_pallas.py::min_sum_run_wide_pallas
//     (P >= 768), a transposed layout that exists only because the TPU's
//     VMEM runs out at P >= 1051.  Here both routes launch this kernel; what
//     changes with the size is where a lane's arrays live (below).
// Semantics (qec_ldpc_tpu/decoder/min_sum.py::min_sum_run), bit for bit per
// batch lane:
//   * check node   E = s * ((alpha * prod_{l' != l} sign V) * min_{l' != l} |V|)
//                  with s = 1 - 2*syndrome; sign(x) = x < 0 ? -1 : 1
//   * var node     V = prior_llr + sum_{b' != b} E, leaving out the target
//                  check except on the last iteration (full posterior)
//   * damping      V = fma(1 - d, V_new, d * V_old), the one contraction XLA
//                  forms on the CPU for d*V_old + (1-d)*V_new
//   * convergence  after iteration n with n % check_every == 0: a lane is
//                  done when no message has |V| < band (NaN counts as
//                  converged); a done lane keeps its messages.
// The file is compiled with --fmad=false, so the only fused multiply-add is
// the explicit one in the damped blend.
//
// What bounds it on the H100.  The float work is 15 operations per edge and
// iteration (19 damped): 67 TFLOP/s puts 100 iterations of [[610,61]] X at
// batch 2048 at 0.11 ms.  With the messages on chip, what the kernel waits
// for is instruction issue and latency: some 35-40 instructions per edge and
// iteration by count (index arithmetic, the state's compares and selects, the
// leave-one-out sums), two barriers per iteration, and as many lanes in
// flight per SM as registers allow.  The design:
//
//   * One lane per CTA.  A lane's decode ends at its own convergence test and
//     the CTA exits; the hardware block scheduler hands the SM the next lane.
//     No lane waits for another.  (A persistent kernel with an atomic lane
//     counter would do the same balancing with a counter to reset per
//     launch; the block scheduler does it for free.)
//   * Compressed check state instead of E.  The check phase keeps, per
//     check, min1 and min2 of |V| over its non-NaN edges, the edge index of
//     min1, the NaN count and the sign parity of its edges xor the syndrome
//     bit (12 bytes per check, against 4 per edge for E).  This is exact:
//     minima do not depend on order, and the reference's leave-one-out
//     minimum of edge l (a NaN-propagating prefix/suffix minimum) is NaN if
//     another edge is NaN, else min2 if l is the argmin, else min1; products
//     of +-1 are exact, and (+-alpha) * m rounds symmetrically, so folding s
//     into the sign gives s * ((alpha * sgn) * m) bit for bit.  The variable
//     phase rebuilds each E from the state ({min1, min2} in one 8-byte load
//     beside the meta word) and the sign of its own edge's V_old, which it
//     reads before overwriting it.  The state's fold and rebuild are
//     csrc/check_state.cuh, shared with K5 and K3, so that the NaN, +-0.0,
//     +-inf and tie rules are written once.  Writing E over V in the check phase
//     instead (the state in registers) was measured slower: holding a
//     check's L values raised the registers from 38-39 to 48-51 at B = 4, 5
//     and cost a CTA per SM.
//   * Messages on chip.  Per lane, in shared memory, in this order while
//     they fit in what the device lets a CTA opt in to (227 KB on the
//     H100): the syndrome bits, V, the check state, the damping.  [[610,61]] (the K2 route's main path) holds all
//     of it: 9.8 / 12.2 KB of V (X / Z), 2.9 / 3.7 KB of state, and the
//     damping column staged once.  The K4 route at P = 1051 holds V and the
//     state for X (218 KB) and V for Z (210 KB); what does not fit (Z's 63 KB
//     of state, the damping, everything at P >= 2081) goes to a per-lane
//     slab of global scratch, contiguous in the lane so that a warp's
//     accesses coalesce; the resident CTAs' state slabs (~8 MB) stay in the
//     50 MB L2.  A thread-block cluster sharing V through distributed shared
//     memory was the other way to fit P = 1051 Z; it would not fit P = 2081
//     and 4201 either, so one kernel with a placement serves every P.
//   * Latency and issue.  The variable degree B is a template parameter
//     (exact arrays, no guards: 38 / 39 registers at B = 4 / 5, so five
//     CTAs of 320 threads share an SM); threads stride over the lane's
//     checks, then over its variables, with the stride's index steps
//     precomputed; consecutive threads touch consecutive words in both
//     phases (the wrap at (C[b,l] + r) % P is the only break), so
//     shared-memory accesses are conflict-free.  The convergence test runs
//     only on test iterations and rides on the second barrier
//     (__syncthreads_or).
//
// Layout of the operands: (edges, batch) float32 / (checks, batch) int32
// with the batch trailing, edges check-indexed as in decoder/layout.py: edge
// (b, l, r) joins check b*P + r and variable l*P + (C[b,l] + r) % P.  A
// lane's column is strided, so the syndrome and the damping are staged once
// at the start and V written once at the end.

#include "check_state.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;        // variable degree (block rows)
constexpr int kMaxL = 16;       // check degree (block columns)
constexpr int kMaxThreads = 1024;

struct Graph {
  int B, L, P;
  int shift[kMaxL * kMaxB];  // C[b, l] in [0, P) at [l * kMaxB + b]
};

// Where a lane's arrays live: each flag set = shared memory, else the lane's
// slab of global scratch.  The syndrome bits are always in shared memory.
// The wrapper decides it (kernels/min_sum_cuda.py::plan, from the device's
// opt-in limit) and passes the sizes it implies; the kernel lays the arrays
// out in plan's order: V, the check state ({min1, min2}, then meta), the
// damping, the syndrome bits, each 16-byte aligned.
struct Placement {
  int v_shared, state_shared, damping_shared;
};

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// The next array of `bytes` bytes: in shared memory at `sp`, or in the
// lane's slab at `slab`; advances the one it takes from.
template <typename T, bool kAllShared>
__device__ __forceinline__ T* carve(bool shared, size_t bytes,
                                    unsigned char*& sp, unsigned char*& slab) {
  unsigned char*& from = (kAllShared || shared) ? sp : slab;
  T* p = reinterpret_cast<T*>(from);
  from += align16(bytes);
  return p;
}

// kB: the variable degree B, at compile time.  kAllShared: every array in
// shared memory, so the compiler emits shared loads and stores; otherwise
// the pointers are generic.
template <int kB, bool kAllShared>
__global__ void __launch_bounds__(kMaxThreads)
min_sum_kernel(const Graph g, const Placement pl,
               const int32_t* __restrict__ syndrome, float* __restrict__ v_out,
               float* __restrict__ scratch, const size_t slab_floats,
               const float* __restrict__ damping, int32_t* __restrict__ iters,
               const int batch, const float prior_llr, const int max_iters,
               const int check_every, const float band, const float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int L = g.L, P = g.P;
  const int LP = L * P;
  const int checks = kB * P;
  const int vars = LP;
  const int edges = kB * LP;
  const size_t ld = (size_t)batch;
  const bool damped = damping != nullptr;

  // carve the lane's arrays out of shared memory and its slab
  unsigned char* sp = smem;
  unsigned char* slab =
      reinterpret_cast<unsigned char*>(scratch + (size_t)lane * slab_floats);
  float* V = carve<float, kAllShared>(pl.v_shared, 4 * (size_t)edges, sp, slab);
  float2* M = carve<float2, kAllShared>(pl.state_shared, 8 * (size_t)checks, sp, slab);
  unsigned* META =
      carve<unsigned, kAllShared>(pl.state_shared, 4 * (size_t)checks, sp, slab);
  float* D = damped ? carve<float, kAllShared>(pl.damping_shared,
                                               4 * (size_t)edges, sp, slab)
                    : nullptr;
  unsigned char* SYN = sp;

  // stage the lane's strided columns once
  for (int c = tid; c < checks; c += T) {
    SYN[c] = syndrome[(size_t)c * ld + lane] != 0;
  }
  for (int e = tid; e < edges; e += T) {
    V[e] = prior_llr;
    if (damped) D[e] = damping[(size_t)e * ld + lane];
  }
  __syncthreads();

  // a thread's first check (b, r) = (i0, j0) and first variable (l, q) =
  // (i0, j0) (both indices are i*P + j), and its stride T in those
  // coordinates: no division inside the loop
  const int i0 = tid / P, j0 = tid - i0 * P;
  const int Ti = T / P, Tj = T - Ti * P;

  int n = 0;
  while (n < max_iters) {
    const bool last = (n == max_iters - 1);
    const bool test = (n % check_every == 0);

    // ---- check phase: thread walks checks c = (b, r) -> compressed state
    for (int c = tid, b = i0, r = j0; c < checks; c += T) {
      const float* row = V + b * LP + r;  // edge (b, 0, r); (b, l, r) at l*P
      CheckState st = state_begin(SYN[c]);
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) {
        if (l < L) state_add(st, row[l * P], l);
      }
      M[c] = make_float2(st.m1, st.m2);
      META[c] = flood_meta(st);
      b += Ti;
      r += Tj;
      if (r >= P) {
        r -= P;
        ++b;
      }
    }
    __syncthreads();

    // ---- variable phase: thread walks variables (l, q) ----
    bool not_conv = false;
    for (int var = tid, l = i0, q = j0; var < vars; var += T) {
      const int* shift = g.shift + l * kMaxB;
      const int lP = l * P;
      int edge[kB];
      float t[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        int r = q - shift[b];  // edge (b, l, r) carries var q
        if (r < 0) r += P;
        edge[b] = b * LP + lP + r;
        const int c = b * P + r;
        // edge l of check c, rebuilt from the state and its own V_old
        const float old = V[edge[b]];
        t[b] = flood_message(M[c], META[c], l, old, alpha);
      }
      float pre[kB];
      pre[0] = 0.0f;
#pragma unroll
      for (int b = 1; b < kB; ++b) pre[b] = pre[b - 1] + t[b - 1];
      const float full = (pre[kB - 1] + 0.0f) + t[kB - 1];  // loo[-1] + term
      float suf = 0.0f;  // sum of t[b+1 .. B-1], accumulated downwards
#pragma unroll
      for (int b = kB - 1; b >= 0; --b) {
        float vv = prior_llr + (last ? full : pre[b] + suf);
        if (damped) {
          const float d = D[edge[b]];
          vv = __fmaf_rn(1.0f - d, vv, __fmul_rn(d, V[edge[b]]));
        }
        V[edge[b]] = vv;
        if (test) not_conv |= fabsf(vv) < band;
        suf = suf + t[b];
      }
      l += Ti;
      q += Tj;
      if (q >= P) {
        q -= P;
        ++l;
      }
    }
    ++n;
    if (test) {
      if (!__syncthreads_or(not_conv)) break;  // the lane is done
    } else {
      __syncthreads();
    }
  }

  for (int e = tid; e < edges; e += T) v_out[(size_t)e * ld + lane] = V[e];
  if (tid == 0) iters[lane] = n;
}

template <int kB, bool kAllShared>
cudaError_t launch(const Graph& g, const Placement& pl, size_t smem_bytes,
                   int threads, cudaStream_t stream, const int32_t* syndrome,
                   float* v, float* scratch, size_t slab_floats,
                   const float* damping, int32_t* iters, int batch,
                   float prior_llr, int max_iters, int check_every, float band,
                   float alpha) {
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch (it costs nothing next to the decode); a
  // size above the device's limit fails here, with its error
  const cudaError_t attr = cudaFuncSetAttribute(
      min_sum_kernel<kB, kAllShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  min_sum_kernel<kB, kAllShared><<<batch, threads, smem_bytes, stream>>>(
      g, pl, syndrome, v, scratch, slab_floats, damping, iters, batch,
      prior_llr, max_iters, check_every, band, alpha);
  return cudaGetLastError();
}

template <int kB>
cudaError_t launch_b(bool all_shared, const Graph& g, const Placement& pl,
                     size_t smem_bytes, size_t slab_floats, int threads,
                     cudaStream_t st, const int32_t* syndrome, float* v,
                     float* scratch, const float* damping, int32_t* iters,
                     int batch, float prior_llr, int max_iters,
                     int check_every, float band, float alpha) {
  return all_shared
             ? launch<kB, true>(g, pl, smem_bytes, threads, st, syndrome, v,
                                scratch, slab_floats, damping, iters, batch,
                                prior_llr, max_iters, check_every, band, alpha)
             : launch<kB, false>(g, pl, smem_bytes, threads, st, syndrome, v,
                                 scratch, slab_floats, damping, iters, batch,
                                 prior_llr, max_iters, check_every, band,
                                 alpha);
}

}  // namespace

// The dynamic shared memory a CTA may take on `device` with the opt-in, in
// bytes (the limit plan() fills), or minus the cudaError_t of the query.
extern "C" int qec_min_sum_smem_optin(int device) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? optin : -(int)err;
}

// Launch on `stream`.  Device pointers: syndrome (B*P, batch) int32, v
// (B*L*P, batch) float32 (the output), scratch the lanes' global slabs
// (batch * slab_floats float32; may be NULL when slab_floats is 0), damping
// (B*L*P, batch) float32 or NULL for the undamped update, iters (batch,)
// int32.  `shifts` is a HOST pointer to the (B, L) exponent table.  The
// placement flags, `threads`, `smem_bytes` (dynamic shared memory per CTA)
// and `slab_floats` (global scratch per lane) are the wrapper's plan
// (kernels/min_sum_cuda.py::plan).  Returns the cudaError_t of the launch
// (0 on success); does not synchronise.
extern "C" int qec_min_sum(const int32_t* syndrome, float* v, float* scratch,
                           const float* damping, int32_t* iters,
                           const int32_t* shifts, int B, int L, int P,
                           int batch, float prior_llr, int max_iters,
                           int check_every, float band, float alpha,
                           int threads, int v_shared, int state_shared,
                           int damping_shared, long long smem_bytes,
                           long long slab_floats, void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || P < 1 || batch < 1 ||
      max_iters < 0 || check_every < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem_bytes < 0 ||
      slab_floats < 0 || (slab_floats > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Graph g;
  g.B = B;
  g.L = L;
  g.P = P;
  for (int i = 0; i < kMaxL * kMaxB; ++i) g.shift[i] = 0;
  for (int b = 0; b < B; ++b) {
    for (int l = 0; l < L; ++l) {
      const int s = shifts[b * L + l] % P;
      g.shift[l * kMaxB + b] = s < 0 ? s + P : s;
    }
  }
  const Placement pl{v_shared != 0, state_shared != 0, damping_shared != 0};
  const bool all = slab_floats == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_MIN_SUM_B(KB)                                                  \
  case KB:                                                                 \
    err = launch_b<KB>(all, g, pl, (size_t)smem_bytes, (size_t)slab_floats, \
                       threads, st, syndrome, v, scratch, damping, iters,   \
                       batch, prior_llr, max_iters, check_every, band,      \
                       alpha);                                              \
    break;
  switch (B) {
    QEC_MIN_SUM_B(1)
    QEC_MIN_SUM_B(2)
    QEC_MIN_SUM_B(3)
    QEC_MIN_SUM_B(4)
    QEC_MIN_SUM_B(5)
    QEC_MIN_SUM_B(6)
    QEC_MIN_SUM_B(7)
    QEC_MIN_SUM_B(8)
  }
#undef QEC_MIN_SUM_B
  return (int)err;
}
