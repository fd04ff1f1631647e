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
//                  converged).  Done lanes are frozen; a block exits when
//                  all its lanes are done.
// Leave-one-out minima, sign products and sums use exclusive prefix/suffix
// order; the variable side runs over ranks in the graph's rank order
// (check-major), which fixes the float sums.  Minima propagate NaN like
// jnp.minimum (fminf does not).  Compiled with --fmad=false: the only fused
// multiply-add is the explicit one in the damped blend.
//
// Layout and routing: csrc/lifted.cuh.  The TPU kernel routes a
// product-group shift as two flat rolls plus a select, because Mosaic cannot
// gather inside a loop; here the variable phase computes each check lane by
// index arithmetic, r = ((q1 - a) mod l)*m + (q2 - b) mod m.  A block owns a
// 16-lane batch tile for the whole decode; its threads stride over check
// rows, then over variables.  The graph (edge blocks, shifts, rank table) is
// passed by value.
//
// What bounds it on the H100: latency and bytes, not arithmetic.  Each
// iteration reads V and writes E (check phase), then reads E and writes V
// (variable phase; damped: also reads V and the damping), 16-24 bytes per
// edge per lane, all through L2 with gathered variable-phase rows.  For the
// gross code a 16-lane tile's V and E are 432 x 16 x 4 B x 2 = 55 KB, which
// fits in shared memory, and the whole batch-2048 state (7 MB) sits in the
// 50 MB L2: keeping the tile's messages in shared memory is the next lever.
// This first design does what the circulant kernels do: converged lanes skip
// both phases, a tile stops as soon as all its lanes are done, and accesses
// are coalesced 64-byte row segments.

#include "lifted.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float sign_of(float x) {
  return x < 0.0f ? -1.0f : 1.0f;
}

__global__ void __launch_bounds__(kThreads)
lifted_min_sum_kernel(const Lifted g, const int32_t* __restrict__ syndrome,
                      float* __restrict__ v, float* __restrict__ e,
                      const float* __restrict__ damping,
                      int32_t* __restrict__ iters, const int batch,
                      const float prior_llr, const int max_iters,
                      const int check_every, const float band,
                      const float alpha) {
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

  // lanes past the batch start (and stay) done
  if (threadIdx.x < kTile) done[threadIdx.x] = valid ? 0 : 1;
  if (valid) {
    for (int r = group; r < num_edges; r += groups) {
      v[(size_t)r * ld + col] = prior_llr;
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
        const float s = 1.0f - 2.0f * (float)syndrome[(size_t)chk * ld + col];
        const size_t base = ((size_t)c * Dc * P + r) * ld + col;  // (c*Dc, r)
        float t[kMaxDc], pre_m[kMaxDc], pre_s[kMaxDc];
#pragma unroll
        for (int d = 0; d < kMaxDc; ++d) {
          if (d < Dc) t[d] = v[base + d * block_step];
        }
        pre_m[0] = INFINITY;
        pre_s[0] = 1.0f;
#pragma unroll
        for (int d = 1; d < kMaxDc; ++d) {
          if (d < Dc) {
            pre_m[d] = min_nan(pre_m[d - 1], fabsf(t[d - 1]));
            pre_s[d] = pre_s[d - 1] * sign_of(t[d - 1]);
          }
        }
        float suf_m = INFINITY, suf_s = 1.0f;  // over d+1 .. Dc-1
#pragma unroll
        for (int d = kMaxDc - 1; d >= 0; --d) {
          if (d < Dc) {
            const float loo_min = min_nan(pre_m[d], suf_m);
            const float loo_sgn = pre_s[d] * suf_s;
            e[base + d * block_step] = s * ((alpha * loo_sgn) * loo_min);
            suf_m = min_nan(suf_m, fabsf(t[d]));
            suf_s = suf_s * sign_of(t[d]);
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
        float t[kMaxDv], pre[kMaxDv];
#pragma unroll
        for (int i = 0; i < kMaxDv; ++i) {
          if (i < Dv) {
            const int eb = g.rank_edge[i * V + vb];
            row[i] = (size_t)var_edge_row(g, eb, q1, q2) * ld + col;
            t[i] = e[row[i]];
          }
        }
        pre[0] = 0.0f;
        float full = 0.0f;
#pragma unroll
        for (int i = 1; i < kMaxDv; ++i) {
          if (i < Dv) pre[i] = pre[i - 1] + t[i - 1];
        }
#pragma unroll
        for (int i = 0; i < kMaxDv; ++i) {
          if (i == Dv - 1) full = (pre[i] + 0.0f) + t[i];  // loo[-1] + term
        }
        float suf = 0.0f;  // sum of t[i+1 .. Dv-1], accumulated downwards
#pragma unroll
        for (int i = kMaxDv - 1; i >= 0; --i) {
          if (i < Dv) {
            const float vv = prior_llr + (last ? full : pre[i] + suf);
            if (damping != nullptr) {
              const float d = damping[row[i]];
              v[row[i]] = __fmaf_rn(1.0f - d, vv, __fmul_rn(d, v[row[i]]));
            } else {
              v[row[i]] = vv;
            }
            suf = suf + t[i];
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
          nc = fabsf(v[(size_t)r * ld + col]) < band;
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
// e (E*P, batch) float32 (e is scratch), damping (E*P, batch) float32 or
// NULL for the undamped update, iters (batch,) int32.  HOST pointers
// `edges` and `ranks`: see describe_lifted (csrc/lifted.cuh).  Returns the
// cudaError_t of the launch (0 on success, cudaErrorInvalidValue for a graph
// describe_lifted refuses); does not synchronise.
extern "C" int qec_lifted_min_sum(const int32_t* syndrome, float* v, float* e,
                                  const float* damping, int32_t* iters,
                                  const int32_t* edges, const int32_t* ranks,
                                  int l, int m, int C, int V, int Dc, int Dv,
                                  int E, int batch, float prior_llr,
                                  int max_iters, int check_every, float band,
                                  float alpha, void* stream) {
  Lifted g;
  if (!describe_lifted(&g, edges, ranks, l, m, C, V, Dc, Dv, E, batch,
                       max_iters, check_every)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch + kTile - 1) / kTile;
  lifted_min_sum_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, syndrome, v, e, damping, iters, batch, prior_llr, max_iters,
      check_every, band, alpha);
  return (int)cudaGetLastError();
}
