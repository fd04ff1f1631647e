// Layered (serial-schedule) normalized min-sum over a circulant Tanner graph:
// the whole decode loop of one graph, for a batch of syndromes, in ONE launch.
//
// Replaces the TPU kernel qec_ldpc_tpu/kernels/layered_pallas.py::
// layered_run_pallas and computes what it computes
// (qec_ldpc_tpu/decoder/layered.py::layered_min_sum_run semantics), bit for
// bit per batch lane.  State per lane: posteriors q (L*P, var-indexed) and
// the check->var messages r (B*L*P, check-indexed).  One sweep runs the B
// block-row layers in order; in layer b, check row r touches variable
// var(l) = l*P + (C[b,l] + r) % P of each block column l:
//   t_l    = q[var(l)] - r[b,l,r]
//   r'_l   = ((alpha * s) * prod_{l' != l} sign t) * min_{l' != l} |t|,
//            s = 1 - 2*syndrome[b*P + r], sign(x) = x < 0 ? -1 : 1, the
//            minima NaN-propagating like jnp.minimum
//   q[var(l)] = t_l + r'_l;   r[b,l,r] = r'_l
// For a fixed l, var(l) is distinct over r, so the rows of a layer update
// with no conflict; a barrier separates the layers.  Convergence, after
// sweep n with n % check_every == check_every - 1: a lane is done when the
// hard decision q <= 0 satisfies the syndrome (the parity of every check),
// and stops there.  Compiled with --fmad=false: nothing here is contracted.
//
// What bounds it on the H100.  The float work is 13 operations per edge and
// sweep: 67 TFLOP/s puts 100 sweeps of [[610,61]] X at batch 2048 at 0.1 ms.
// The first design (one 16-lane tile per 512-thread block, q and r in global
// memory) ran 34x that: a layer is only P rows deep (61 for [[610,61]]), so
// a sweep is B short dependent steps of L gathered reads and writes through
// L2, each ending at a barrier, and a tile ran until its slowest lane
// converged (the layered cell's lanes average ~2 sweeps).  What remains with
// the state on chip is latency and instruction issue.  The design:
//
//   * One lane per CTA, the CTA one thread per row of a layer (64 threads at
//     P = 61, 544 at P = 521, 1024 striding at P = 1051).  A lane stops at
//     its own convergence test and the block scheduler hands the SM the next
//     lane; iters[lane] is the lane's own sweep count.  One lane per warp
//     (__syncwarp between the layers, several lanes a CTA) measured 3%
//     slower at P = 61 and was not kept.
//   * r as the compressed check state.  A check's L messages are rebuilt
//     from 12 bytes: min1, min2, the argmin, the NaN count and the sign
//     parity of its t (csrc/check_state.cuh, the min-sum kernels' form),
//     plus, in the meta word, the index of a NaN edge and the sign bit of
//     each edge's t from the sweep that wrote them: those are what the
//     rebuild needs of the edge's own t.  12 bytes per check against 4 * L
//     for r: [[610,61]] holds 2.4 KB of q and 2.9 / 3.7 KB of state (X / Z)
//     per lane, P = 521 21 + 25 / 31 KB, P = 1051 42 + 50 / 63 KB, all in
//     shared memory within the H100's 227 KB.  The first sweep reproduces
//     r = 0 exactly: it takes t = q, which is q - (+0.0) bit for bit (the
//     state is not read before it is written).
//   * Placement by the wrapper's plan from the device's opt-in limit
//     (kernels/layered_cuda.py::plan): the syndrome bits, q and the state in
//     shared memory while they fit, the rest in a per-lane slab of global
//     scratch (P >= 4201).  The syndrome is staged once and q written once.
//   * Latency and issue.  The check degree L is a template parameter (exact
//     register arrays for a row's L values, no guards); a row whose state
//     holds no NaN (all but saturated lanes) takes a copy of the rebuild with
//     the NaN rule folded away, which took 100 sweeps from 1.54 to 1.22 ms;
//     the convergence test rides on the reduction's barrier
//     (__syncthreads_or).
//
// Measured on an H100 (80GB HBM3, 700 W; chip_smoke.py and profile_cells.py,
// PERF.md section 6): 100 fixed sweeps of [[610,61]] X at batch 2048 take
// 1.19 ms, against 3.32-3.34 ms for the first design and a bound of 0.097 ms:
// 12x the bound, latency-bound (a batch of 2048 lanes gives an SM ~16 lanes
// of 2 warps, and a row's fold is a chain of L dependent minima).  In the
// layered cell (early exit, a test every sweep, ~1.4 sweeps a lane) a launch
// takes 0.07 ms against 0.63-0.64.  At P = 521 (Z, 30 sweeps, batch 1024)
// the state in the slab took 2.75 ms against 2.17 on chip (+27%).
//
// Layout of the operands: syndrome (B*P, batch) int32 and q (L*P, batch)
// float32, the batch trailing.

#include "check_state.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;        // variable degree (block rows = layers)
constexpr int kMaxL = 16;       // check degree (block columns)
constexpr int kMaxThreads = 1024;
constexpr int kWarpSize = 32;

struct Graph {
  int B, L, P;
  int shift[kMaxB * kMaxL];  // C[b, l] in [0, P) at [b * kMaxL + l]
};

// Where a lane's q and check state live: set = shared memory, else the
// lane's slab of global scratch.  The syndrome bits are always in shared
// memory.  The wrapper decides it (kernels/layered_cuda.py::plan); the
// kernel lays a lane's arrays out in plan's order: q, the state ({min1,
// min2}, then meta), the syndrome bits, each 16-byte aligned.
struct Placement {
  int q_shared, state_shared;
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

// The layered meta word of a check: bits 0-4 argmin, 5-9 NaN count, 10 the
// sign parity xor the syndrome, 11-15 the index of a NaN edge (read when
// the count is 1), 16-31 the sign bit (t < 0) of each edge.
__device__ __forceinline__ unsigned layered_meta(const CheckState& s,
                                                 unsigned nan_at,
                                                 unsigned signs) {
  return s.arg | (s.nans << 5) | (s.neg << 10) | (nan_at << 11) |
         (signs << 16);
}

// r of edge l as the sweep that stored the state wrote it.  kNaN: the state
// counted a NaN edge; without one the NaN rule drops out (the usual row).
template <bool kNaN>
__device__ __forceinline__ float stored_message(float2 m, unsigned meta,
                                                unsigned l, float alpha) {
  const unsigned nans = kNaN ? (meta >> 5) & 31u : 0u;
  const bool own_nan = kNaN && ((meta >> 11) & 31u) == l;
  const bool neg = ((meta >> 10) & 1u) ^ ((meta >> (16 + l)) & 1u);
  return loo_message(m.x, m.y, (meta & 31u) == l, nans, own_nan, neg, alpha);
}

// kL: the check degree L, at compile time.  kAllShared: q and the state in
// shared memory, so the compiler emits shared loads and stores.
template <int kL, bool kAllShared>
__global__ void __launch_bounds__(kMaxThreads)
layered_min_sum_kernel(const Graph g, const Placement pl,
                       const int32_t* __restrict__ syndrome,
                       float* __restrict__ q_out, float* __restrict__ scratch,
                       const size_t slab_floats,
                       int32_t* __restrict__ iters, const int batch,
                       const float prior_llr, const int max_iters,
                       const int check_every, const float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const int lane = (int)blockIdx.x;
  const int B = g.B, P = g.P;
  const int checks = B * P;
  const int vars = kL * P;
  const size_t ld = (size_t)batch;

  // carve the lane's arrays out of shared memory and its slab
  unsigned char* sp = smem;
  unsigned char* slab =
      reinterpret_cast<unsigned char*>(scratch + (size_t)lane * slab_floats);
  float* Q = carve<float, kAllShared>(pl.q_shared, 4 * (size_t)vars, sp, slab);
  float2* M = carve<float2, kAllShared>(pl.state_shared, 8 * (size_t)checks, sp, slab);
  unsigned* META =
      carve<unsigned, kAllShared>(pl.state_shared, 4 * (size_t)checks, sp, slab);
  unsigned char* SYN = sp;

  // stage the lane's strided syndrome column once
  for (int c = tid; c < checks; c += T) {
    SYN[c] = syndrome[(size_t)c * ld + lane] != 0;
  }
  for (int v = tid; v < vars; v += T) Q[v] = prior_llr;
  __syncthreads();

  // a thread's first check (b, r) of the convergence test, and its stride
  // T in those coordinates: no division inside the loop
  const int b0 = tid / P, r0 = tid - b0 * P;
  const int Tb = T / P, Tr = T - Tb * P;

  int n = 0;
  while (n < max_iters) {
    const bool first = (n == 0);

    // ---- one sweep: the B layers in order ----
    for (int b = 0; b < B; ++b) {
      const int* shift = g.shift + b * kMaxL;
      for (int r = tid; r < P; r += T) {
        const int c = b * P + r;
        int var[kL];
        float t[kL];
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          int col = shift[l] + r;
          if (col >= P) col -= P;
          var[l] = l * P + col;
          t[l] = Q[var[l]];
        }
        // t = q - r; the first sweep's r is +0.0, and q - (+0.0) is q, bit
        // for bit (the state is not read before it is written)
        if (!first) {
          const float2 m = M[c];
          const unsigned meta = META[c];
          if (((meta >> 5) & 31u) == 0) {
#pragma unroll
            for (int l = 0; l < kL; ++l) {
              t[l] = t[l] - stored_message<false>(m, meta, l, alpha);
            }
          } else {
#pragma unroll
            for (int l = 0; l < kL; ++l) {
              t[l] = t[l] - stored_message<true>(m, meta, l, alpha);
            }
          }
        }
        CheckState st = state_begin(SYN[c]);
        unsigned nan_at = 0, signs = 0;
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          state_add(st, t[l], l);
          if (isnan(t[l])) nan_at = l;
          signs |= (t[l] < 0.0f ? 1u : 0u) << l;
        }
        if (st.nans == 0) {
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            Q[var[l]] = t[l] + loo_message(st.m1, st.m2, st.arg == (unsigned)l,
                                           0u, false,
                                           st.neg ^ ((signs >> l) & 1u), alpha);
          }
        } else {
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            Q[var[l]] = t[l] + loo_message(st.m1, st.m2, st.arg == (unsigned)l,
                                           st.nans, isnan(t[l]),
                                           st.neg ^ ((signs >> l) & 1u), alpha);
          }
        }
        M[c] = make_float2(st.m1, st.m2);
        META[c] = layered_meta(st, nan_at, signs);
      }
      __syncthreads();
    }

    // ---- convergence: does the hard decision satisfy the syndrome? ----
    const bool test = (n % check_every == check_every - 1);
    ++n;
    if (test) {
      bool bad = false;
      for (int c = tid, b = b0, r = r0; c < checks && !bad; c += T) {
        const int* shift = g.shift + b * kMaxL;
        unsigned parity = SYN[c];
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          int col = shift[l] + r;
          if (col >= P) col -= P;
          parity ^= Q[l * P + col] <= 0.0f ? 1u : 0u;
        }
        bad = parity != 0;
        b += Tb;
        r += Tr;
        if (r >= P) {
          r -= P;
          ++b;
        }
      }
      if (!__syncthreads_or(bad)) break;  // the lane is done
    }
  }

  for (int v = tid; v < vars; v += T) q_out[(size_t)v * ld + lane] = Q[v];
  if (tid == 0) iters[lane] = n;
}

template <int kL, bool kAllShared>
cudaError_t launch(const Graph& g, const Placement& pl, int threads,
                   size_t smem_bytes, size_t slab_floats, cudaStream_t stream,
                   const int32_t* syndrome, float* q, float* scratch,
                   int32_t* iters, int batch, float prior_llr, int max_iters,
                   int check_every, float alpha) {
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch; a size above the device's limit fails
  // here, with its error
  const cudaError_t attr = cudaFuncSetAttribute(
      layered_min_sum_kernel<kL, kAllShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  layered_min_sum_kernel<kL, kAllShared><<<batch, threads, smem_bytes, stream>>>(
      g, pl, syndrome, q, scratch, slab_floats, iters, batch, prior_llr,
      max_iters, check_every, alpha);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  Device pointers: syndrome (B*P, batch) int32, q
// (L*P, batch) float32 (the posteriors out), scratch the lanes' global slabs
// (batch * slab_floats float32; may be NULL when slab_floats is 0), iters
// (batch,) int32.  `shifts` is a HOST pointer to the (B, L) exponent table.
// The shape and placement are the wrapper's plan
// (kernels/layered_cuda.py::plan): one lane per CTA of `threads` threads,
// `smem_bytes` of dynamic shared memory.  Returns the cudaError_t of the launch
// (0 on success); does not synchronise.
extern "C" int qec_layered_min_sum(const int32_t* syndrome, float* q,
                                   float* scratch, int32_t* iters,
                                   const int32_t* shifts, int B, int L, int P,
                                   int batch, float prior_llr, int max_iters,
                                   int check_every, float alpha, int threads,
                                   int q_shared, int state_shared,
                                   long long smem_bytes, long long slab_floats,
                                   void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || P < 1 || batch < 1 ||
      max_iters < 0 || check_every < 1 || threads < kWarpSize ||
      threads > kMaxThreads || threads % kWarpSize != 0 ||
      smem_bytes < 0 || smem_bytes % 16 != 0 || slab_floats < 0 ||
      (slab_floats > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Graph g;
  g.B = B;
  g.L = L;
  g.P = P;
  for (int i = 0; i < kMaxB * kMaxL; ++i) g.shift[i] = 0;
  for (int b = 0; b < B; ++b) {
    for (int l = 0; l < L; ++l) {
      const int s = shifts[b * L + l] % P;
      g.shift[b * kMaxL + l] = s < 0 ? s + P : s;
    }
  }
  const Placement pl{q_shared != 0, state_shared != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_LAYERED_L(KL)                                                 \
  case KL:                                                                \
    err = slab_floats == 0                                                \
              ? launch<KL, true>(g, pl, threads, (size_t)smem_bytes, 0, st, \
                                 syndrome, q, scratch, iters, batch,       \
                                 prior_llr, max_iters, check_every, alpha) \
              : launch<KL, false>(g, pl, threads, (size_t)smem_bytes,     \
                                  (size_t)slab_floats, st, syndrome, q,   \
                                  scratch, iters, batch, prior_llr,       \
                                  max_iters, check_every, alpha);         \
    break;
  switch (L) {
    QEC_LAYERED_L(1)
    QEC_LAYERED_L(2)
    QEC_LAYERED_L(3)
    QEC_LAYERED_L(4)
    QEC_LAYERED_L(5)
    QEC_LAYERED_L(6)
    QEC_LAYERED_L(7)
    QEC_LAYERED_L(8)
    QEC_LAYERED_L(9)
    QEC_LAYERED_L(10)
    QEC_LAYERED_L(11)
    QEC_LAYERED_L(12)
    QEC_LAYERED_L(13)
    QEC_LAYERED_L(14)
    QEC_LAYERED_L(15)
    QEC_LAYERED_L(16)
  }
#undef QEC_LAYERED_L
  return (int)err;
}
