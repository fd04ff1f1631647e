// Layered (serial-schedule) normalized min-sum over a circulant Tanner graph:
// the whole decode loop of one graph, for a batch of syndromes, in ONE launch.
//
// Replaces the TPU kernel qec_ldpc_tpu/kernels/layered_pallas.py::
// layered_run_pallas and computes what it computes
// (qec_ldpc_tpu/decoder/layered.py::layered_min_sum_run semantics), bit for
// bit per batch lane.  State per lane: posteriors q (L*P rows, var-indexed)
// and check->var messages r (B*L*P rows, check-indexed).  One sweep runs the
// B block-row layers in order; in layer b, check row r touches variable
// var(l) = l*P + (C[b,l] + r) % P of each block column l:
//   t_l    = q[var(l)] - r[b,l,r]
//   r'_l   = ((alpha * s) * prod_{l' != l} sign t) * min_{l' != l} |t|,
//            s = 1 - 2*syndrome[b*P + r], sign(x) = x < 0 ? -1 : 1
//   q[var(l)] = t_l + r'_l;   r[b,l,r] = r'_l
// For a fixed l, var(l) is distinct over r, so one thread per (row, lane)
// reads and writes its L posteriors with no conflict; a __syncthreads()
// separates the layers.  Convergence, after sweep n with
// n % check_every == check_every - 1: a lane is done when the hard decision
// q <= 0 satisfies the syndrome, tested as the sign-product parity of every
// check (a block reduction per lane).  Done lanes are frozen; a block exits
// when all its lanes are done.  Minima propagate NaN like jnp.minimum.
// Compiled with --fmad=false: no operation here is contracted.
//
// Layout: (rows, batch) float32 with the batch trailing; a block owns a
// 16-lane batch tile and its threads stride over the P rows of a layer.
//
// What bounds it on the H100: load latency.  A layer is only P rows deep
// (61 for [[610,61]]), so a sweep is B short dependent steps of L gathered
// reads and writes each, and every layer ends at a barrier; q and r stay in
// global memory (L2: a 16-lane tile of [[610,61]] is 39 KB of q and 156 KB
// of r).  The design keeps a tile's work in one block for the whole decode,
// skips converged lanes and exits a tile as soon as all its lanes are done.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;       // variable degree (block rows = layers)
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
layered_min_sum_kernel(const Graph g, const int32_t* __restrict__ syndrome,
                       float* __restrict__ q, float* __restrict__ rmsg,
                       int32_t* __restrict__ iters, const int batch,
                       const float prior_llr, const int max_iters,
                       const int check_every, const float alpha) {
  __shared__ int done[kTile];
  __shared__ int unsat[kTile];

  const int lane = threadIdx.x % kTile;
  const int group = threadIdx.x / kTile;
  const int groups = blockDim.x / kTile;
  const int col = blockIdx.x * kTile + lane;
  const bool valid = col < batch;
  const int B = g.B, L = g.L, P = g.P;
  const int num_checks = B * P;
  const size_t ld = (size_t)batch;
  const size_t block_step = (size_t)P * ld;  // edge (b, l, r) -> (b, l+1, r)

  // lanes past the batch start (and stay) done
  if (threadIdx.x < kTile) done[threadIdx.x] = valid ? 0 : 1;
  if (valid) {
    for (int i = group; i < L * P; i += groups) q[(size_t)i * ld + col] = prior_llr;
    for (int i = group; i < B * L * P; i += groups) rmsg[(size_t)i * ld + col] = 0.0f;
  }
  __syncthreads();

  int n = 0;
  bool all_done = false;
  while (n < max_iters && !all_done) {
    const bool live = !done[lane];

    // ---- one sweep: the B layers in order ----
    for (int b = 0; b < B; ++b) {
      if (live) {
        for (int r = group; r < P; r += groups) {
          const float s = 1.0f - 2.0f * (float)syndrome[(size_t)(b * P + r) * ld + col];
          const float as = alpha * s;
          int qrow[kMaxL];  // variable row of block column l
          float t[kMaxL], pre_m[kMaxL], pre_s[kMaxL];
          const size_t rbase = ((size_t)b * L * P + r) * ld + col;  // (b,0,r)
#pragma unroll
          for (int l = 0; l < kMaxL; ++l) {
            if (l < L) {
              int c = g.shift[b * L + l] + r;
              if (c >= P) c -= P;
              qrow[l] = l * P + c;
              t[l] = q[(size_t)qrow[l] * ld + col] - rmsg[rbase + l * block_step];
            }
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
              const float r_new = (as * loo_sgn) * loo_min;
              q[(size_t)qrow[l] * ld + col] = t[l] + r_new;
              rmsg[rbase + l * block_step] = r_new;
              suf_m = min_nan(suf_m, fabsf(t[l]));
              suf_s = suf_s * sign_of(t[l]);
            }
          }
        }
      }
      __syncthreads();
    }

    // ---- convergence: does the hard decision satisfy the syndrome? ----
    if (n % check_every == check_every - 1) {
      if (threadIdx.x < kTile) unsat[threadIdx.x] = 0;
      __syncthreads();
      if (live) {
        bool bad = false;
        for (int c = group; c < num_checks && !bad; c += groups) {
          const int b = c / P;
          const int r = c - b * P;
          const float s = 1.0f - 2.0f * (float)syndrome[(size_t)c * ld + col];
          float parity = 1.0f;
          for (int l = 0; l < L; ++l) {
            int v = g.shift[b * L + l] + r;
            if (v >= P) v -= P;
            parity = parity * (q[(size_t)(l * P + v) * ld + col] <= 0.0f ? -1.0f : 1.0f);
          }
          bad = parity != s;
        }
        if (bad) unsat[lane] = 1;
      }
      __syncthreads();
      if (threadIdx.x < kTile && !unsat[threadIdx.x]) done[threadIdx.x] = 1;
      __syncthreads();
    }
    ++n;
    all_done = __syncthreads_and(done[lane]) != 0;
  }
  if (valid && group == 0) iters[col] = n;
}

}  // namespace

// Launch on `stream`.  Device pointers: syndrome (B*P, batch) int32, q
// (L*P, batch) float32 (the posteriors out), r (B*L*P, batch) float32
// (scratch), iters (batch,) int32.  `shifts` is a HOST pointer to the (B, L)
// exponent table.  Returns the cudaError_t of the launch (0 on success);
// does not synchronise.
extern "C" int qec_layered_min_sum(const int32_t* syndrome, float* q, float* r,
                                   int32_t* iters, const int32_t* shifts,
                                   int B, int L, int P, int batch,
                                   float prior_llr, int max_iters,
                                   int check_every, float alpha, void* stream) {
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
  layered_min_sum_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      g, syndrome, q, r, iters, batch, prior_llr, max_iters, check_every,
      alpha);
  return (int)cudaGetLastError();
}
