// Sum-product belief propagation (probability domain) over a LIFTED Tanner
// graph: PCM blocks that are sums of monomial permutations over Z_P or
// Z_l x Z_m (bivariate bicycle, hypergraph-product and toric codes).  The
// whole decode loop of one graph, for a batch of syndromes, in ONE launch.
//
// Replaces the TPU kernel
// qec_ldpc_tpu/kernels/lifted_bp_pallas.py::lifted_bp_run_pallas and
// computes what it computes (qec_ldpc_tpu/decoder/sum_product.py::bp_run on
// a LiftedGraph), bit for bit per batch lane:
//   * check node   E = 0.5 - (0.5 - s) * prod_{d' != d} (1 - 2 V) over the
//                  Dc edge blocks of a check row
//   * var node     V = p*prod(E) / fma(1-p, prod(1-E), p*prod(E)) over the
//                  Dv ranked edges of a variable, leaving out the target
//                  edge except on the last iteration, which forms the full
//                  posterior (products in ascending rank order)
//   * convergence  after iteration n with n % check_every == 0: a lane is
//                  done when no nonzero message lies strictly inside
//                  (conv_low, conv_high); NaN counts as converged.  A done
//                  lane keeps its messages.
// Leave-one-out products use exclusive prefix/suffix order over the graph's
// rank order (check-major), and the file is compiled with --fmad=false so
// the only fused multiply-add is the explicit one in the denominator (XLA
// contracts exactly that one on the CPU).  Division is IEEE (__fdiv_rn),
// and denormals are kept: leave-one-out products of a few small
// probabilities reach them.
//
// What bounds it on the H100.  The float work is 18 operations per edge and
// iteration: 67 TFLOP/s puts 100 iterations of the gross X graph at batch
// 2048 at 0.024 ms.  The first design (one 16-lane tile per 512-thread
// block, V and E in global memory with the batch trailing) ran 50x that:
// every phase moved ~16 bytes per edge and lane through L2 with a stride of
// `batch` floats, and a tile ran until its slowest lane converged.  With the
// messages on chip, what is left is instruction issue and latency, as in the
// sum-product kernel on circulant graphs (csrc/bp_sum_product.cu), whose
// design this one takes, with the lifted min-sum kernel's routing
// (csrc/lifted_min_sum.cu):
//
//   * One lane per CTA.  A lane's decode ends at its own convergence test
//     and the CTA exits; the block scheduler hands the SM the next lane, so
//     no lane waits for another and iters[lane] is the lane's own count.
//   * V and E on chip, placed by the sum-product plan
//     (kernels/placement.py::bp_plan, from the device's opt-in limit): per
//     lane the syndrome bits, V and E (4 bytes per edge each) in shared
//     memory while they fit, the rest in a per-lane slab of global scratch,
//     contiguous in the lane.  The gross code holds 1.7 KB each, so many
//     CTAs of 128 threads share an SM; [[756,16,34]] 9 KB, toric d = 32
//     16 KB; the description allows up to 64 * P edges, so the P = 1051
//     circulant code as a lifted graph (210 KB per array) puts E in the
//     slab, and the P = 2081 one (416 KB) both.
//   * No register arrays in the check phase.  The forward pass writes each
//     edge's exclusive prefix product into E; the backward pass reads it
//     back, multiplies by the running suffix and forms E in place.  1 - 2V
//     is recomputed from V (the same rounding both times), so the check
//     degree Dc stays a runtime loop bound.
//   * Routing resolved on the host (csrc/lifted.cuh's Routing, shared with
//     K5): variable (vb, q1, q2)'s rank-i edge is check lane
//     ((q1 - a) mod l, (q2 - b) mod m) of its edge block, the block's
//     shifts and row base passed by value.  The variable degree Dv is a
//     template parameter (exact arrays, no guards); threads walk the checks,
//     then the variables, with the stride's index steps precomputed; the
//     convergence test rides on the second barrier (__syncthreads_or).  The
//     strided syndrome column is staged once and V written once at the end.
//
// Measured on an H100 (80GB HBM3, 700 W; chip_smoke.py and profile_cells.py,
// PERF.md section 6): 100 fixed iterations of the gross X graph at batch
// 2048 take 0.558-0.575 ms, against 1.160-1.167 ms for the first design in
// the same calls and a bound of 0.024 ms, so it is issue- and latency-bound
// (~24x), as K1 is; ptxas gives the on-chip Dv = 3 kernel 32 registers
// with 8 bytes of spill.  A launch in the gross sum-product cell takes
// 0.064 ms against 0.143, and 0.064-0.065 ms of device time under early
// exit on that cell's X and Z batches.
//
// Layout of the operands: csrc/lifted.cuh (messages (E*P, batch) float32,
// check-major, check-indexed; the batch trailing).

#include "lifted.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// Where a lane's V and E live: set = shared memory, else the lane's slab of
// global scratch.  The syndrome bits are always in shared memory.  The
// wrapper decides it (kernels/placement.py::bp_plan) and passes the sizes
// it implies; the kernel lays the arrays out in that order: V, E, the
// syndrome bits, each 16-byte aligned.
struct Placement {
  int v_shared, e_shared;
};

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

template <bool kAllShared>
__device__ __forceinline__ float* carve(bool shared, size_t bytes,
                                        unsigned char*& sp,
                                        unsigned char*& slab) {
  unsigned char*& from = (kAllShared || shared) ? sp : slab;
  float* p = reinterpret_cast<float*>(from);
  from += align16(bytes);
  return p;
}

__device__ __forceinline__ bool inside_band(float x, float lo, float hi) {
  return x != 0.0f && x > lo && x < hi;
}

// kDv: the variable degree Dv, at compile time.  kAllShared: V and E in
// shared memory, so the compiler emits shared loads and stores.
template <int kDv, bool kAllShared>
__global__ void __launch_bounds__(kMaxThreads)
lifted_bp_kernel(const Routing g, const Placement pl,
                 const int32_t* __restrict__ syndrome,
                 float* __restrict__ v_out, float* __restrict__ scratch,
                 const size_t slab_floats, int32_t* __restrict__ iters,
                 const int batch, const float prior, const int max_iters,
                 const int check_every, const float conv_low,
                 const float conv_high) {
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
  const float one_minus_prior = 1.0f - prior;

  unsigned char* sp = smem;
  unsigned char* slab =
      reinterpret_cast<unsigned char*>(scratch + (size_t)lane * slab_floats);
  float* V = carve<kAllShared>(pl.v_shared, 4 * (size_t)edges, sp, slab);
  float* E = carve<kAllShared>(pl.e_shared, 4 * (size_t)edges, sp, slab);
  unsigned char* SYN = sp;

  // stage the lane's strided syndrome column once
  for (int c = tid; c < checks; c += T) {
    SYN[c] = syndrome[(size_t)c * ld + lane] != 0;
  }
  for (int e = tid; e < edges; e += T) V[e] = prior;
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

    // ---- check phase: thread walks check rows c = (cb, r) ----
    for (int c = tid, cb = cb0, r = r0; c < checks; c += T) {
      const float sgn = SYN[c] ? -0.5f : 0.5f;
      const float* vrow = V + cb * DcP + r;  // edge (cb*Dc + d) at d*P
      float* erow = E + cb * DcP + r;
      float pre = 1.0f;  // exclusive prefix product of t[0 .. d-1]
      for (int d = 0; d < Dc; ++d) {
        erow[d * P] = pre;
        pre = pre * (1.0f - 2.0f * vrow[d * P]);
      }
      float suf = 1.0f;  // suffix product of t[d+1 .. Dc-1]
      for (int d = Dc - 1; d >= 0; --d) {
        const float t = 1.0f - 2.0f * vrow[d * P];
        erow[d * P] = 0.5f - sgn * (erow[d * P] * suf);
        suf = suf * t;
      }
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
      float ep[kDv], em[kDv];
#pragma unroll
      for (int i = 0; i < kDv; ++i) {
        const RankEdge& rk = g.rank[i * Vb + vb];
        int r1 = q1 - rk.a;
        if (r1 < 0) r1 += gl;
        int r2 = q2 - rk.b;
        if (r2 < 0) r2 += gm;
        edge[i] = rk.edge_base + r1 * gm + r2;
        ep[i] = E[edge[i]];
        em[i] = 1.0f - ep[i];
      }
      float pre_p[kDv], pre_m[kDv];
      pre_p[0] = 1.0f;
      pre_m[0] = 1.0f;
#pragma unroll
      for (int i = 1; i < kDv; ++i) {
        pre_p[i] = pre_p[i - 1] * ep[i - 1];
        pre_m[i] = pre_m[i - 1] * em[i - 1];
      }
      // full product, ascending rank order
      const float full_p = pre_p[kDv - 1] * ep[kDv - 1];
      const float full_m = pre_m[kDv - 1] * em[kDv - 1];
      float suf_p = 1.0f, suf_m = 1.0f;
#pragma unroll
      for (int i = kDv - 1; i >= 0; --i) {
        const float prod_p = last ? full_p : pre_p[i] * suf_p;
        const float prod_m = last ? full_m : pre_m[i] * suf_m;
        const float num = prior * prod_p;
        const float den = __fmaf_rn(one_minus_prior, prod_m, num);
        const float vv = __fdiv_rn(num, den);
        V[edge[i]] = vv;
        if (test) not_conv |= inside_band(vv, conv_low, conv_high);
        suf_p = suf_p * ep[i];
        suf_m = suf_m * em[i];
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
                   float* scratch, int32_t* iters, int batch, float prior,
                   int max_iters, int check_every, float conv_low,
                   float conv_high) {
  auto kernel = all_shared ? &lifted_bp_kernel<kDv, true>
                           : &lifted_bp_kernel<kDv, false>;
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch; a size above the device's limit fails here
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<batch, threads, smem_bytes, stream>>>(
      g, pl, syndrome, v, scratch, slab_floats, iters, batch, prior,
      max_iters, check_every, conv_low, conv_high);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  Device pointers: syndrome (C*P, batch) int32, v
// (E*P, batch) float32 (the output), scratch the lanes' global slabs (batch
// * slab_floats float32; may be NULL when slab_floats is 0), iters (batch,)
// int32.  HOST pointers `edges` and `ranks`: see describe_lifted
// (csrc/lifted.cuh).  The placement flags, `threads`, `smem_bytes` and
// `slab_floats` are the wrapper's plan (kernels/placement.py::bp_plan).
// Returns the cudaError_t of the launch (0 on success,
// cudaErrorInvalidValue for a graph describe_lifted refuses or a bad plan);
// does not synchronise.
extern "C" int qec_lifted_bp(const int32_t* syndrome, float* v,
                             float* scratch, int32_t* iters,
                             const int32_t* edges, const int32_t* ranks, int l,
                             int m, int C, int V, int Dc, int Dv, int E,
                             int batch, float prior, int max_iters,
                             int check_every, float conv_low, float conv_high,
                             int threads, int v_shared, int e_shared,
                             long long smem_bytes, long long slab_floats,
                             void* stream) {
  Lifted lg;
  if (!describe_lifted(&lg, edges, ranks, l, m, C, V, Dc, Dv, E, batch,
                       max_iters, check_every) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes < 0 || slab_floats < 0 ||
      (slab_floats > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Routing g = resolve_routing(lg, E);
  const Placement pl{v_shared != 0, e_shared != 0};
  const bool all = slab_floats == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_LIFTED_BP_DV(KDV)                                               \
  case KDV:                                                                 \
    err = launch<KDV>(all, g, pl, (size_t)smem_bytes, (size_t)slab_floats,  \
                      threads, st, syndrome, v, scratch, iters, batch, prior, \
                      max_iters, check_every, conv_low, conv_high);         \
    break;
  switch (Dv) {
    QEC_LIFTED_BP_DV(1)
    QEC_LIFTED_BP_DV(2)
    QEC_LIFTED_BP_DV(3)
    QEC_LIFTED_BP_DV(4)
    QEC_LIFTED_BP_DV(5)
    QEC_LIFTED_BP_DV(6)
    QEC_LIFTED_BP_DV(7)
    QEC_LIFTED_BP_DV(8)
  }
#undef QEC_LIFTED_BP_DV
  return (int)err;
}
