// Normalized min-sum belief propagation (LLR domain) over a LIFTED Tanner
// graph: PCM blocks that are sums of monomial permutations over Z_P or
// Z_l x Z_m (bivariate bicycle, hypergraph-product and toric codes).  The
// whole decode loop of one graph, for a batch of syndromes, in ONE launch,
// with an optional per-edge damping operand (the relay decoder).
//
// Replaces the TPU kernel
// qec_ldpc_tpu/kernels/lifted_min_sum_pallas.py::lifted_min_sum_run_pallas
// and computes what it computes (qec_ldpc_tpu/decoder/min_sum.py::
// min_sum_run on a LiftedGraph), bit for bit per batch lane:
//   * check node   E = s * ((alpha * prod_{d' != d} sign V) * min_{d' != d} |V|)
//                  over the Dc edge blocks of a check row, s = 1 - 2*syndrome
//   * var node     V = prior_llr + sum_{i' != i} E over the Dv ranked edges
//                  of a variable, leaving out the target edge except on the
//                  last iteration: the full posterior (pre[Dv-1] + 0) + t[Dv-1]
//   * damping      V = fma(1 - d, V_new, d * V_old), the one contraction XLA
//                  forms on the CPU
//   * convergence  after iteration n with n % check_every == 0: a lane is
//                  done when no message has |V| < band (NaN counts as
//                  converged); a done lane keeps its messages.
// The variable side sums over ranks in the graph's rank order (check-major),
// which fixes the float sums; minima propagate NaN like jnp.minimum.
// Compiled with --fmad=false: the only fused multiply-add is the explicit
// one in the damped blend.
//
// What bounds it on the H100.  The float work is 15 operations per edge and
// iteration (19 damped): 67 TFLOP/s puts 100 iterations of the gross X graph
// at batch 2048 at 0.02 ms.  The first design (one 16-lane tile per
// 512-thread block, V and E in global memory) ran 46x that: every phase
// moved 16-24 bytes per edge and lane through L2, and a tile ran until its
// slowest lane converged.  The check update is the min-sum kernel's
// (csrc/min_sum.cu), so this kernel takes that kernel's design, and what
// remains is instruction issue and latency:
//
//   * One lane per CTA.  A lane's decode ends at its own convergence test
//     and the CTA exits; the block scheduler hands the SM the next lane, so
//     no lane waits for another and iters[lane] is the lane's own count.
//   * The compressed check state instead of E (csrc/check_state.cuh, shared
//     with K2 and K3): per check row, min1, min2, the argmin, the NaN count
//     and the sign parity xor the syndrome, 12 bytes; the variable phase
//     rebuilds each E from it and the sign of the edge's own V_old.
//   * Messages on chip, placed by the min-sum kernel's plan
//     (kernels/min_sum_cuda.py::plan, from the device's opt-in limit): per
//     lane the syndrome bits, V, the state and the damping in shared memory
//     while they fit, the rest in a per-lane slab of global scratch.  The
//     gross code holds 1.7 KB of V, 0.9 KB of state and 1.7 KB of damping
//     per lane, so many CTAs of 128 threads share an SM; toric d = 32 16 KB
//     of V; the description allows up to 64 * P edges, so a large lift
//     (the P = 2081 circulant code as a lifted graph: 416 KB of V) puts V in
//     the slab.  The strided syndrome and damping columns are staged once.
//   * Routing by index arithmetic.  Variable (vb, q1, q2)'s rank-i edge is
//     check lane r = ((q1 - a) mod l)*m + (q2 - b) mod m of edge block eb;
//     the launcher resolves each rank entry's eb into its shifts, its edge
//     row base eb*P, its check row base (eb / Dc)*P and its position
//     eb % Dc (csrc/lifted.cuh's Routing, shared with K6), passed by
//     value.  The variable degree Dv is a template parameter (exact
//     arrays, no guards); threads walk the checks, then the
//     variables, with the stride's index steps precomputed; the convergence
//     test rides on the second barrier (__syncthreads_or).
//
// Measured on an H100 (80GB HBM3, 700 W; chip_smoke.py and profile_cells.py,
// PERF.md section 6): 100 fixed iterations of the gross X graph at batch
// 2048 take 0.39 ms, against 0.88-0.90 ms for the first design and a bound
// of 0.02 ms (issue- and latency-bound, as K2); a launch in the gross
// min-sum cell 0.073 ms against 0.41, in the gross relay cell 0.19 ms
// against 0.95-0.96.
//
// Layout of the operands: csrc/lifted.cuh (messages (E*P, batch) float32,
// check-major, check-indexed; the batch trailing).

#include "check_state.cuh"
#include "lifted.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// Where a lane's arrays live: as csrc/min_sum.cu's placement, from
// kernels/min_sum_cuda.py::plan; the kernel lays them out in plan's order:
// V, the check state ({min1, min2}, then meta), the damping, the syndrome
// bits, each 16-byte aligned.
struct Placement {
  int v_shared, state_shared, damping_shared;
};

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

template <typename T, bool kAllShared>
__device__ __forceinline__ T* carve(bool shared, size_t bytes,
                                    unsigned char*& sp, unsigned char*& slab) {
  unsigned char*& from = (kAllShared || shared) ? sp : slab;
  T* p = reinterpret_cast<T*>(from);
  from += align16(bytes);
  return p;
}

// kDv: the variable degree Dv, at compile time.  kAllShared: every array in
// shared memory, so the compiler emits shared loads and stores.
template <int kDv, bool kAllShared>
__global__ void __launch_bounds__(kMaxThreads)
lifted_min_sum_kernel(const Routing g, const Placement pl,
                      const int32_t* __restrict__ syndrome,
                      float* __restrict__ v_out, float* __restrict__ scratch,
                      const size_t slab_floats,
                      const float* __restrict__ damping,
                      int32_t* __restrict__ iters, const int batch,
                      const float prior_llr, const int max_iters,
                      const int check_every, const float band,
                      const float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int P = g.P, gl = g.l, gm = g.m, Dc = g.Dc, Vb = g.V;
  const int DcP = Dc * P;
  const int checks = g.C * P;
  const int vars = Vb * P;
  const int edges = g.C * DcP;
  const size_t ld = (size_t)batch;
  const bool damped = damping != nullptr;

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

  // a thread's first check (cb, r) and first variable (vb, q1, q2), and the
  // stride T in those coordinates: no division inside the loop
  const int cb0 = tid / P, r0 = tid - cb0 * P;
  const int Tc = T / P, Tr = T - Tc * P;
  const int q10 = r0 / gm, q20 = r0 - q10 * gm;
  const int T1 = Tr / gm, T2 = Tr - T1 * gm;

  int n = 0;
  while (n < max_iters) {
    const bool last = (n == max_iters - 1);
    const bool test = (n % check_every == 0);

    // ---- check phase: thread walks check rows c = (cb, r) -> state ----
    for (int c = tid, cb = cb0, r = r0; c < checks; c += T) {
      const float* row = V + cb * DcP + r;  // edge (cb*Dc + d) at d*P
      CheckState st = state_begin(SYN[c]);
#pragma unroll
      for (int d = 0; d < kMaxDc; ++d) {
        if (d < Dc) state_add(st, row[d * P], d);
      }
      M[c] = make_float2(st.m1, st.m2);
      META[c] = flood_meta(st);
      cb += Tc;
      r += Tr;
      if (r >= P) {
        r -= P;
        ++cb;
      }
    }
    __syncthreads();

    // ---- variable phase: thread walks variables (vb, q1, q2) ----
    bool not_conv = false;
    for (int var = tid, vb = cb0, q1 = q10, q2 = q20; var < vars; var += T) {
      int edge[kDv];
      float t[kDv];
#pragma unroll
      for (int i = 0; i < kDv; ++i) {
        const RankEdge& rk = g.rank[i * Vb + vb];
        int r1 = q1 - rk.a;
        if (r1 < 0) r1 += gl;
        int r2 = q2 - rk.b;
        if (r2 < 0) r2 += gm;
        const int r = r1 * gm + r2;
        edge[i] = rk.edge_base + r;
        const int c = rk.check_base + r;
        // edge d of check c, rebuilt from the state and its own V_old
        const float old = V[edge[i]];
        t[i] = flood_message(M[c], META[c], rk.d, old, alpha);
      }
      float pre[kDv];
      pre[0] = 0.0f;
#pragma unroll
      for (int i = 1; i < kDv; ++i) pre[i] = pre[i - 1] + t[i - 1];
      const float full = (pre[kDv - 1] + 0.0f) + t[kDv - 1];  // loo[-1] + term
      float suf = 0.0f;  // sum of t[i+1 .. Dv-1], accumulated downwards
#pragma unroll
      for (int i = kDv - 1; i >= 0; --i) {
        float vv = prior_llr + (last ? full : pre[i] + suf);
        if (damped) {
          const float d = D[edge[i]];
          vv = __fmaf_rn(1.0f - d, vv, __fmul_rn(d, V[edge[i]]));
        }
        V[edge[i]] = vv;
        if (test) not_conv |= fabsf(vv) < band;
        suf = suf + t[i];
      }
      vb += Tc;
      q2 += T2;
      if (q2 >= gm) {
        q2 -= gm;
        ++q1;
      }
      q1 += T1;
      if (q1 >= gl) {
        q1 -= gl;
        ++vb;
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

template <int kDv>
cudaError_t launch(bool all_shared, const Routing& g, const Placement& pl,
                   size_t smem_bytes, size_t slab_floats, int threads,
                   cudaStream_t stream, const int32_t* syndrome, float* v,
                   float* scratch, const float* damping, int32_t* iters,
                   int batch, float prior_llr, int max_iters, int check_every,
                   float band, float alpha) {
  auto kernel = all_shared ? &lifted_min_sum_kernel<kDv, true>
                           : &lifted_min_sum_kernel<kDv, false>;
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch; a size above the device's limit fails here
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<batch, threads, smem_bytes, stream>>>(
      g, pl, syndrome, v, scratch, slab_floats, damping, iters, batch,
      prior_llr, max_iters, check_every, band, alpha);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  Device pointers: syndrome (C*P, batch) int32, v
// (E*P, batch) float32 (the output), scratch the lanes' global slabs (batch
// * slab_floats float32; may be NULL when slab_floats is 0), damping (E*P,
// batch) float32 or NULL for the undamped update, iters (batch,) int32.
// HOST pointers `edges` and `ranks`: see describe_lifted (csrc/lifted.cuh).
// The placement flags, `threads`, `smem_bytes` and `slab_floats` are the
// wrapper's plan (kernels/min_sum_cuda.py::plan).  Returns the cudaError_t
// of the launch (0 on success, cudaErrorInvalidValue for a graph
// describe_lifted refuses or a bad plan); does not synchronise.
extern "C" int qec_lifted_min_sum(const int32_t* syndrome, float* v,
                                  float* scratch, const float* damping,
                                  int32_t* iters, const int32_t* edges,
                                  const int32_t* ranks, int l, int m, int C,
                                  int V, int Dc, int Dv, int E, int batch,
                                  float prior_llr, int max_iters,
                                  int check_every, float band, float alpha,
                                  int threads, int v_shared, int state_shared,
                                  int damping_shared, long long smem_bytes,
                                  long long slab_floats, void* stream) {
  Lifted lg;
  if (!describe_lifted(&lg, edges, ranks, l, m, C, V, Dc, Dv, E, batch,
                       max_iters, check_every) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes < 0 || slab_floats < 0 ||
      (slab_floats > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Routing g = resolve_routing(lg, E);
  const Placement pl{v_shared != 0, state_shared != 0, damping_shared != 0};
  const bool all = slab_floats == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_LIFTED_MIN_SUM_DV(KDV)                                            \
  case KDV:                                                                   \
    err = launch<KDV>(all, g, pl, (size_t)smem_bytes, (size_t)slab_floats,    \
                      threads, st, syndrome, v, scratch, damping, iters,      \
                      batch, prior_llr, max_iters, check_every, band, alpha); \
    break;
  switch (Dv) {
    QEC_LIFTED_MIN_SUM_DV(1)
    QEC_LIFTED_MIN_SUM_DV(2)
    QEC_LIFTED_MIN_SUM_DV(3)
    QEC_LIFTED_MIN_SUM_DV(4)
    QEC_LIFTED_MIN_SUM_DV(5)
    QEC_LIFTED_MIN_SUM_DV(6)
    QEC_LIFTED_MIN_SUM_DV(7)
    QEC_LIFTED_MIN_SUM_DV(8)
  }
#undef QEC_LIFTED_MIN_SUM_DV
  return (int)err;
}
