// Normalized min-sum belief propagation (LLR domain) over a circulant Tanner
// graph: the whole decode loop of one graph, for a batch of syndromes, in ONE
// launch, with an optional per-edge damping operand (the relay decoder).
//
// Replaces two TPU kernels, which compute the same function:
//   * qec_ldpc_tpu/kernels/min_sum_pallas.py::min_sum_run_pallas (P < 768)
//   * qec_ldpc_tpu/kernels/min_sum_wide_pallas.py::min_sum_run_wide_pallas
//     (P >= 768), a transposed layout that exists only because the TPU's
//     VMEM runs out at P >= 1051.  Messages live in global memory here, so
//     the same kernel takes every P; the wrapper keeps the two routes apart.
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
//                  converged).  Done lanes are frozen; a block exits when
//                  all its lanes are done.
// Leave-one-out minima, sign products and sums use the reference's exclusive
// prefix/suffix order; minima propagate NaN like jnp.minimum (fminf does
// not).  The file is compiled with --fmad=false, so the only fused
// multiply-add is the explicit one in the damped blend.
//
// Layout: messages are (edges, batch) float32 with the batch trailing, edges
// check-indexed as in decoder/layout.py: edge (b, l, r) joins check b*P + r
// and variable l*P + (C[b,l] + r) % P.  A block owns a 16-lane batch tile for
// the whole decode; its threads stride over check rows, then over variables,
// and a warp's 32 threads read two 64-byte row segments.  Routing is index
// arithmetic on the exponent table, passed by value.
//
// What bounds it on the H100: bytes and load latency, not arithmetic.  Each
// iteration reads V and writes E (check phase), then reads E and writes V
// (variable phase; damped: also reads V and the damping), 16-24 bytes per
// edge per lane, all through L2 with gathered variable-phase rows.  The
// design does three things about it, as the sum-product kernel does:
// converged lanes skip both phases, a tile stops as soon as all its lanes are
// done, and accesses are coalesced row segments.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;       // variable degree (block rows)
constexpr int kMaxL = 16;      // check degree (block columns)
constexpr int kTile = 16;      // batch lanes per block
constexpr int kThreads = 512;  // kThreads / kTile row groups per block

struct Graph {
  int B, L, P;
  int shift[kMaxB * kMaxL];  // C[b, l] in [0, P), row-major (b, l)
};

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float sign_of(float x) {
  return x < 0.0f ? -1.0f : 1.0f;
}

__global__ void __launch_bounds__(kThreads)
min_sum_kernel(const Graph g, const int32_t* __restrict__ syndrome,
               float* __restrict__ v, float* __restrict__ e,
               const float* __restrict__ damping, int32_t* __restrict__ iters,
               const int batch, const float prior_llr, const int max_iters,
               const int check_every, const float band, const float alpha) {
  __shared__ int done[kTile];
  __shared__ int not_conv[kTile];

  const int lane = threadIdx.x % kTile;
  const int group = threadIdx.x / kTile;
  const int groups = blockDim.x / kTile;
  const int col = blockIdx.x * kTile + lane;
  const bool valid = col < batch;
  const int B = g.B, L = g.L, P = g.P;
  const int num_checks = B * P;
  const int num_vars = L * P;
  const int num_edges = B * L * P;
  const size_t ld = (size_t)batch;
  const size_t block_step = (size_t)P * ld;  // edge (b, l, r) -> (b, l+1, r)

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

    // ---- check-node phase: thread (group, lane) walks checks c = (b, r) ----
    if (live) {
      for (int c = group; c < num_checks; c += groups) {
        const int b = c / P;
        const int r = c - b * P;
        const float s = 1.0f - 2.0f * (float)syndrome[(size_t)c * ld + col];
        const size_t base = ((size_t)b * L * P + r) * ld + col;  // edge (b,0,r)
        float t[kMaxL], pre_m[kMaxL], pre_s[kMaxL];
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
          if (l < L) t[l] = v[base + l * block_step];
        }
        pre_m[0] = INFINITY;
        pre_s[0] = 1.0f;
#pragma unroll
        for (int l = 1; l < kMaxL; ++l) {
          if (l < L) {
            pre_m[l] = min_nan(pre_m[l - 1], fabsf(t[l - 1]));
            pre_s[l] = pre_s[l - 1] * sign_of(t[l - 1]);
          }
        }
        float suf_m = INFINITY, suf_s = 1.0f;  // over l+1 .. L-1
#pragma unroll
        for (int l = kMaxL - 1; l >= 0; --l) {
          if (l < L) {
            const float loo_min = min_nan(pre_m[l], suf_m);
            const float loo_sgn = pre_s[l] * suf_s;
            e[base + l * block_step] = s * ((alpha * loo_sgn) * loo_min);
            suf_m = min_nan(suf_m, fabsf(t[l]));
            suf_s = suf_s * sign_of(t[l]);
          }
        }
      }
    }
    __syncthreads();

    // ---- variable-node phase: thread walks variables (l, q) ----
    if (live) {
      for (int var = group; var < num_vars; var += groups) {
        const int l = var / P;
        const int q = var - l * P;
        size_t row[kMaxB];
        float t[kMaxB], pre[kMaxB];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < B) {
            int r = q - g.shift[b * L + l];  // edge (b, l, r) carries var q
            if (r < 0) r += P;
            row[b] = ((size_t)(b * L + l) * P + r) * ld + col;
            t[b] = e[row[b]];
          }
        }
        pre[0] = 0.0f;
        float full = 0.0f;
#pragma unroll
        for (int b = 1; b < kMaxB; ++b) {
          if (b < B) pre[b] = pre[b - 1] + t[b - 1];
        }
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b == B - 1) full = (pre[b] + 0.0f) + t[b];  // loo[-1] + term
        }
        float suf = 0.0f;  // sum of t[b+1 .. B-1], accumulated downwards
#pragma unroll
        for (int b = kMaxB - 1; b >= 0; --b) {
          if (b < B) {
            const float vv = prior_llr + (last ? full : pre[b] + suf);
            if (damping != nullptr) {
              const float d = damping[row[b]];
              v[row[b]] = __fmaf_rn(1.0f - d, vv, __fmul_rn(d, v[row[b]]));
            } else {
              v[row[b]] = vv;
            }
            suf = suf + t[b];
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

// Launch on `stream`.  Device pointers: syndrome (B*P, batch) int32, v and
// e (B*L*P, batch) float32 (e is scratch), damping (B*L*P, batch) float32 or
// NULL for the undamped update, iters (batch,) int32.  `shifts` is a HOST
// pointer to the (B, L) exponent table.  Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
extern "C" int qec_min_sum(const int32_t* syndrome, float* v, float* e,
                           const float* damping, int32_t* iters,
                           const int32_t* shifts, int B, int L, int P,
                           int batch, float prior_llr, int max_iters,
                           int check_every, float band, float alpha,
                           void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || P < 1 || batch < 1 ||
      max_iters < 0 || check_every < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Graph g;
  g.B = B;
  g.L = L;
  g.P = P;
  for (int i = 0; i < kMaxB * kMaxL; ++i) g.shift[i] = 0;
  for (int i = 0; i < B * L; ++i) {
    const int s = shifts[i] % P;
    g.shift[i] = s < 0 ? s + P : s;
  }
  const int blocks = (batch + kTile - 1) / kTile;
  min_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, syndrome, v, e, damping, iters, batch, prior_llr, max_iters,
      check_every, band, alpha);
  return (int)cudaGetLastError();
}
