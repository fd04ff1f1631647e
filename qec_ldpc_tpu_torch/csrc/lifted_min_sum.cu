// Normalized min-sum belief propagation (LLR domain) over a LIFTED Tanner
// graph: PCM blocks that are sums of monomial permutations over Z_P or
// Z_l x Z_m (bivariate bicycle, hypergraph-product and toric codes).  The
// whole decode loop of one graph, for a batch of syndromes, in ONE launch,
// with an optional per-edge damping operand (the relay decoder); or, undamped,
// of both graphs of a code, X and Z, in one launch.
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
//   * Both sectors in one grid (qec_lifted_min_sum_pair).  Under early exit
//     a launch is bounded by its slowest lane, not by its work: in the gross
//     min-sum cell (p = 0.01, 2048 lanes) the bulk stops after 1 or 11
//     iterations, and about 4 lanes in 10,000 run on to max_iters, one lane
//     in about 40% of the sectors.  That lane decodes alone on a nearly
//     empty SM for 100 iterations: X with one such lane took 0.131 ms, Z
//     with none 0.045 ms.  One launch of a sector at a time pays that tail
//     once a sector; the pair interleaves the two sectors' CTAs in one grid,
//     so their slow lanes run at the same time and each sector's bulk fills
//     the SMs the other's tail leaves idle.  Each lane computes what it
//     computes in a launch of its sector alone, bit for bit; a grid of one
//     sector is the same kernel with kSectors = 1.
//
// Measured on an H100 (80GB HBM3, 700 W; chip_smoke.py, perfbench, PERF.md
// sections 5 and 6): 100 fixed iterations of the gross X graph at batch
// 2048 take 0.39 ms, against 0.88-0.90 ms for the first design and a bound
// of 0.02 ms (issue- and latency-bound, as K2); in the gross relay cell a
// launch takes 0.19 ms against 0.95-0.96.  On 32 chunks of the gross
// min-sum cell's traffic the pair takes 0.124 ms a chunk against 0.152 for
// two launches, and in that cell's traced run 0.121 ms against 0.150; at
// the quality cell's 16,384 lanes of [[756,16,34]], many waves, the pair
// reads 0.91-1.00 of two launches.
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

// One sector of a launch, as the host describes it: its graph's routing
// and its own operands (device pointers; the layouts above
// qec_lifted_min_sum).
struct Sector {
  Routing g;
  const int32_t* syndrome;
  const float* damping;  // NULL: the undamped update
  float* v_out;
  int32_t* iters;
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
// shared memory, so the compiler emits shared loads and stores.  kSectors:
// the sectors of the grid, interleaved: CTA b decodes lane b / 2 of sector
// b % 2 (X: g0, syndrome0, v_out0, iters0; Z: the ...1 operands), so
// neither sector's lanes queue behind the whole of the other's.  At
// kSectors = 1 the ...1 operands are unused and every operand the lane reads
// sits at a fixed offset of the parameters, as in a launch of one sector
// alone; the damping is the one sector's (a pair is undamped).
template <int kDv, bool kAllShared, int kSectors>
__global__ void __launch_bounds__(kMaxThreads)
lifted_min_sum_kernel(const Routing g0, const Placement pl,
                      const int32_t* __restrict__ syndrome0,
                      float* __restrict__ v_out0, float* __restrict__ scratch,
                      const size_t slab_floats,
                      const float* __restrict__ damping,
                      int32_t* __restrict__ iters0, const int batch,
                      const float prior_llr, const int max_iters,
                      const int check_every, const float band,
                      const float alpha, const Routing g1,
                      const int32_t* __restrict__ syndrome1,
                      float* __restrict__ v_out1,
                      int32_t* __restrict__ iters1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool z = kSectors == 2 && (blockIdx.x & 1);
  const int lane = kSectors == 2 ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const Routing& g = z ? g1 : g0;
  const int32_t* __restrict__ syndrome = z ? syndrome1 : syndrome0;
  float* __restrict__ v_out = z ? v_out1 : v_out0;
  int32_t* __restrict__ iters = z ? iters1 : iters0;
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

// One launch of sector x alone (kSectors = 1; z is not read) or of x and z
// (kSectors = 2), which share the placement, the CTA size and Dv.
template <int kDv, int kSectors>
cudaError_t launch(bool all_shared, const Sector& x, const Sector& z,
                   const Placement& pl, size_t smem_bytes, size_t slab_floats,
                   int threads, cudaStream_t stream, float* scratch,
                   int batch, float prior_llr, int max_iters,
                   int check_every, float band, float alpha) {
  // a pair keeps every array in shared memory: no slab variant of it
  auto kernel = &lifted_min_sum_kernel<kDv, true, kSectors>;
  if constexpr (kSectors == 1) {
    if (!all_shared) kernel = &lifted_min_sum_kernel<kDv, false, 1>;
  }
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch; a size above the device's limit fails here
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<kSectors * batch, threads, smem_bytes, stream>>>(
      x.g, pl, x.syndrome, x.v_out, scratch, slab_floats, x.damping, x.iters,
      batch, prior_llr, max_iters, check_every, band, alpha, z.g, z.syndrome,
      z.v_out, z.iters);
  return cudaGetLastError();
}

// Fill `s` from a graph's HOST tables (describe_lifted's) and the sector's
// device pointers; false where describe_lifted refuses them.
inline bool describe_sector(Sector* s, const int32_t* syndrome,
                            const float* damping, float* v, int32_t* iters,
                            const int32_t* edges, const int32_t* ranks, int l,
                            int m, int C, int V, int Dc, int Dv, int E,
                            int batch, int max_iters, int check_every) {
  Lifted lg;
  if (!describe_lifted(&lg, edges, ranks, l, m, C, V, Dc, Dv, E, batch,
                       max_iters, check_every)) {
    return false;
  }
  s->g = resolve_routing(lg, E);
  s->syndrome = syndrome;
  s->damping = damping;
  s->v_out = v;
  s->iters = iters;
  return true;
}

// launch<kDv, kSectors> of the described sectors, each of Dv `Dv`, under
// the plan's placement, CTA size and sizes, after the plan's checks.
template <int kSectors>
int launch_sectors(const Sector& x, const Sector& z, int Dv, float* scratch,
                   int batch,
                   float prior_llr, int max_iters, int check_every,
                   float band, float alpha, int threads,
                   const Placement& pl, long long smem_bytes,
                   long long slab_floats, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes < 0 || slab_floats < 0 ||
      (slab_floats > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool all = slab_floats == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_LIFTED_MIN_SUM_DV(KDV)                                            \
  case KDV:                                                                   \
    err = launch<KDV, kSectors>(all, x, z, pl, (size_t)smem_bytes,            \
                                (size_t)slab_floats, threads, st, scratch,    \
                                batch, prior_llr, max_iters, check_every,     \
                                band, alpha);                                 \
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
  Sector s;
  if (!describe_sector(&s, syndrome, damping, v, iters, edges, ranks, l, m, C,
                       V, Dc, Dv, E, batch, max_iters, check_every)) {
    return (int)cudaErrorInvalidValue;
  }
  const Placement pl{v_shared != 0, state_shared != 0, damping_shared != 0};
  return launch_sectors<1>(s, s, Dv, scratch, batch, prior_llr, max_iters,
                           check_every, band, alpha, threads, pl, smem_bytes,
                           slab_floats, stream);
}

// Both sectors of a chunk, X then Z, in ONE launch of 2 * batch CTAs: each
// sector's operands as qec_lifted_min_sum's, undamped and with every array
// in shared memory (the wrapper pairs only graphs whose plans are equal
// and need no slab, kernels/lifted_min_sum_cuda.py::pair_plan), so each
// lane computes what a one-sector launch computes, bit for bit, iters
// included.  Returns cudaErrorInvalidValue where either graph is refused
// or the two degrees Dv differ.
extern "C" int qec_lifted_min_sum_pair(
    const int32_t* syndrome_x, float* v_x, int32_t* iters_x,
    const int32_t* edges_x, const int32_t* ranks_x, int l_x, int m_x, int C_x,
    int V_x, int Dc_x, int Dv_x, int E_x, const int32_t* syndrome_z,
    float* v_z, int32_t* iters_z, const int32_t* edges_z,
    const int32_t* ranks_z, int l_z, int m_z, int C_z, int V_z, int Dc_z,
    int Dv_z, int E_z, int batch, float prior_llr, int max_iters,
    int check_every, float band, float alpha, int threads, int v_shared,
    int state_shared, long long smem_bytes, void* stream) {
  Sector x, z;
  if (Dv_x != Dv_z ||
      !describe_sector(&x, syndrome_x, nullptr, v_x, iters_x, edges_x,
                       ranks_x, l_x, m_x, C_x, V_x, Dc_x, Dv_x, E_x, batch,
                       max_iters, check_every) ||
      !describe_sector(&z, syndrome_z, nullptr, v_z, iters_z, edges_z,
                       ranks_z, l_z, m_z, C_z, V_z, Dc_z, Dv_z, E_z, batch,
                       max_iters, check_every)) {
    return (int)cudaErrorInvalidValue;
  }
  const Placement pl{v_shared != 0, state_shared != 0, 0};
  return launch_sectors<2>(x, z, Dv_x, nullptr, batch, prior_llr, max_iters,
                           check_every, band, alpha, threads, pl, smem_bytes,
                           0, stream);
}
