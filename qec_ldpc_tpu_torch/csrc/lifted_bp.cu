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
//                  (conv_low, conv_high); NaN counts as converged.  Done
//                  lanes are frozen; a block exits when all its lanes are
//                  done.
// Leave-one-out products use exclusive prefix/suffix order over the graph's
// rank order (check-major), and the file is compiled with --fmad=false so
// the only fused multiply-add is the explicit one in the denominator (XLA
// contracts exactly that one on the CPU).  Division is IEEE (__fdiv_rn),
// and denormals are kept: leave-one-out products of a few small
// probabilities reach them.
//
// Layout and routing: csrc/lifted.cuh; the variable phase finds each check
// lane by index arithmetic, as csrc/lifted_min_sum.cu.  A block owns a
// 16-lane batch tile for the whole decode; its threads stride over check
// rows, then over variables.  The graph is passed by value.
//
// What bounds it on the H100: latency and bytes, not arithmetic: ~16 bytes
// per edge per lane and iteration through L2, gathered on the variable side.
// A gross-code tile's messages (55 KB) fit in shared memory and the whole
// batch-2048 state (7 MB) in the 50 MB L2: shared-memory residency is the
// next lever.  This first design skips converged lanes, stops a tile as soon
// as all its lanes are done, and reads coalesced 64-byte row segments.

#include "lifted.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool inside_band(float x, float lo, float hi) {
  return x != 0.0f && x > lo && x < hi;
}

__global__ void __launch_bounds__(kThreads)
lifted_bp_kernel(const Lifted g, const int32_t* __restrict__ syndrome,
                 float* __restrict__ v, float* __restrict__ e,
                 int32_t* __restrict__ iters, const int batch,
                 const float prior, const int max_iters,
                 const int check_every, const float conv_low,
                 const float conv_high) {
  __shared__ int done[kTile];
  __shared__ int not_conv[kTile];

  const int lane = threadIdx.x % kTile;
  const int group = threadIdx.x / kTile;
  const int groups = blockDim.x / kTile;
  const int col = blockIdx.x * kTile + lane;
  const bool valid = col < batch;
  const int P = g.P, m = g.m, Dc = g.Dc, Dv = g.Dv, V = g.V;
  const int num_checks = g.C * P;
  const int num_vars = V * P;
  const int num_edges = g.C * Dc * P;
  const size_t ld = (size_t)batch;
  const size_t block_step = (size_t)P * ld;  // edge block e -> e+1, same lane
  const float one_minus_prior = 1.0f - prior;

  // lanes past the batch start (and stay) done
  if (threadIdx.x < kTile) done[threadIdx.x] = valid ? 0 : 1;
  if (valid) {
    for (int r = group; r < num_edges; r += groups) {
      v[(size_t)r * ld + col] = prior;
    }
  }
  __syncthreads();

  int n = 0;
  bool all_done = false;
  while (n < max_iters && !all_done) {
    const bool last = (n == max_iters - 1);
    const bool live = !done[lane];

    // ---- check-node phase: thread (group, lane) walks checks (c, r) ----
    if (live) {
      for (int chk = group; chk < num_checks; chk += groups) {
        const int c = chk / P;
        const int r = chk - c * P;
        const float sgn = 0.5f - (float)syndrome[(size_t)chk * ld + col];
        const size_t base = ((size_t)c * Dc * P + r) * ld + col;  // (c*Dc, r)
        float t[kMaxDc], pre[kMaxDc];
#pragma unroll
        for (int d = 0; d < kMaxDc; ++d) {
          if (d < Dc) t[d] = 1.0f - 2.0f * v[base + d * block_step];
        }
        pre[0] = 1.0f;
#pragma unroll
        for (int d = 1; d < kMaxDc; ++d) {
          if (d < Dc) pre[d] = pre[d - 1] * t[d - 1];
        }
        float suf = 1.0f;  // suffix product of t[d+1 .. Dc-1]
#pragma unroll
        for (int d = kMaxDc - 1; d >= 0; --d) {
          if (d < Dc) {
            e[base + d * block_step] = 0.5f - sgn * (pre[d] * suf);
            suf = suf * t[d];
          }
        }
      }
    }
    __syncthreads();

    // ---- variable-node phase: thread walks variables (vb, q) ----
    if (live) {
      for (int var = group; var < num_vars; var += groups) {
        const int vb = var / P;
        const int q = var - vb * P;
        const int q1 = q / m;
        const int q2 = q - q1 * m;
        size_t row[kMaxDv];
        float ep[kMaxDv], em[kMaxDv], pre_p[kMaxDv], pre_m[kMaxDv];
#pragma unroll
        for (int i = 0; i < kMaxDv; ++i) {
          if (i < Dv) {
            const int eb = g.rank_edge[i * V + vb];
            row[i] = (size_t)var_edge_row(g, eb, q1, q2) * ld + col;
            ep[i] = e[row[i]];
            em[i] = 1.0f - ep[i];
          }
        }
        pre_p[0] = 1.0f;
        pre_m[0] = 1.0f;
        float full_p = 0.0f, full_m = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxDv; ++i) {
          if (i < Dv) {
            if (i > 0) {
              pre_p[i] = pre_p[i - 1] * ep[i - 1];
              pre_m[i] = pre_m[i - 1] * em[i - 1];
            }
            if (i == Dv - 1) {  // full product, ascending order
              full_p = pre_p[i] * ep[i];
              full_m = pre_m[i] * em[i];
            }
          }
        }
        float suf_p = 1.0f, suf_m = 1.0f;
#pragma unroll
        for (int i = kMaxDv - 1; i >= 0; --i) {
          if (i < Dv) {
            const float prod_p = last ? full_p : pre_p[i] * suf_p;
            const float prod_m = last ? full_m : pre_m[i] * suf_m;
            const float num = prior * prod_p;
            const float den = __fmaf_rn(one_minus_prior, prod_m, num);
            v[row[i]] = __fdiv_rn(num, den);
            suf_p = suf_p * ep[i];
            suf_m = suf_m * em[i];
          }
        }
      }
    }
    __syncthreads();

    // ---- convergence test (block reduction per lane) ----
    if (n % check_every == 0) {
      if (threadIdx.x < kTile) not_conv[threadIdx.x] = 0;
      __syncthreads();
      if (live) {
        bool nc = false;
        for (int r = group; r < num_edges && !nc; r += groups) {
          nc = inside_band(v[(size_t)r * ld + col], conv_low, conv_high);
        }
        if (nc) not_conv[lane] = 1;
      }
      __syncthreads();
      if (threadIdx.x < kTile && !not_conv[threadIdx.x]) done[threadIdx.x] = 1;
      __syncthreads();
    }
    ++n;
    all_done = __syncthreads_and(done[lane]) != 0;
  }
  if (valid && group == 0) iters[col] = n;
}

}  // namespace

// Launch on `stream`.  Device pointers: syndrome (C*P, batch) int32, v and
// e (E*P, batch) float32 (e is scratch), iters (batch,) int32.  HOST
// pointers `edges` and `ranks`: see describe_lifted (csrc/lifted.cuh).
// Returns the cudaError_t of the launch (0 on success, cudaErrorInvalidValue
// for a graph describe_lifted refuses); does not synchronise.
extern "C" int qec_lifted_bp(const int32_t* syndrome, float* v, float* e,
                             int32_t* iters, const int32_t* edges,
                             const int32_t* ranks, int l, int m, int C, int V,
                             int Dc, int Dv, int E, int batch, float prior,
                             int max_iters, int check_every, float conv_low,
                             float conv_high, void* stream) {
  Lifted g;
  if (!describe_lifted(&g, edges, ranks, l, m, C, V, Dc, Dv, E, batch,
                       max_iters, check_every)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch + kTile - 1) / kTile;
  lifted_bp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, syndrome, v, e, iters, batch, prior, max_iters, check_every,
      conv_low, conv_high);
  return (int)cudaGetLastError();
}
