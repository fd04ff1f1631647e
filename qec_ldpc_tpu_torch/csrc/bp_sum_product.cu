// Sum-product belief propagation over a circulant Tanner graph: the whole
// decode loop of one graph, for a batch of syndromes, in ONE launch.
//
// Replaces the TPU kernel qec_ldpc_tpu/kernels/bp_pallas.py::bp_run_pallas
// and computes what it computes (qec_ldpc_tpu/decoder/sum_product.py::bp_run
// semantics), bit for bit per batch lane:
//   * check node   E = 0.5 - (0.5 - s) * prod_{l' != l} (1 - 2 V)
//   * var node     V = p*prod(E) / fma(1-p, prod(1-E), p*prod(E)), leaving
//                  out the target check except on the last iteration, which
//                  forms the full posterior
//   * convergence  after iteration n with n % check_every == 0: a lane is
//                  done when no nonzero message lies strictly inside
//                  (conv_low, conv_high); NaN counts as converged.  Done lanes
//                  are frozen; a block exits when all its lanes are done.
// Leave-one-out products use the reference's exclusive prefix/suffix
// association order, and the file is compiled with --fmad=false so the only
// fused multiply-add is the explicit one in the denominator (XLA contracts
// exactly that one).  Division is IEEE (__fdiv_rn), and denormals are kept:
// leave-one-out products of a few small probabilities reach them.
//
// Layout: messages are (edges, batch) float32 with the batch trailing, edges
// check-indexed as in decoder/layout.py: edge (b, l, r) joins check b*P + r
// and variable l*P + (C[b,l] + r) % P.  A thread owns one batch lane of a
// 16-lane tile, so the threads of a warp read neighbouring addresses.  The
// routing is index arithmetic on the exponent table, passed by value.
//
// What bounds it on the H100: bytes, not arithmetic.  Each iteration reads
// and writes both message tensors once (CN: read V, write E; VN: read E,
// write V), ~16 bytes per edge per lane — 80 MB per iteration for the
// [[610,61]] X graph at batch 2048, about the size of the 50 MB L2, so much
// of it reaches HBM, and every thread's loads are gathers across block
// columns.  This first design keeps V and E in global memory (L2) and does
// three things about it: converged lanes skip both phases (no reads or
// writes), a tile stops as soon as all its lanes are done, and each warp's
// accesses are 64-byte coalesced row segments.  Keeping a small lane tile's
// messages in shared memory is the next step.

#include <cuda_runtime.h>
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

__device__ __forceinline__ bool inside_band(float x, float lo, float hi) {
  return x != 0.0f && x > lo && x < hi;
}

__global__ void __launch_bounds__(kThreads)
bp_sum_product_kernel(const Graph g, const int32_t* __restrict__ syndrome,
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
  const int B = g.B, L = g.L, P = g.P;
  const int num_checks = B * P;
  const int num_vars = L * P;
  const int num_edges = B * L * P;
  const size_t ld = (size_t)batch;
  const size_t block_step = (size_t)P * ld;  // edge (b, l, r) -> (b, l+1, r)
  const float one_minus_prior = 1.0f - prior;

  // lanes past the batch start (and stay) done
  if (threadIdx.x < kTile) done[threadIdx.x] = valid ? 0 : 1;
  if (valid) {
    for (int r = group; r < num_edges; r += groups) v[r * ld + col] = prior;
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
        const float sgn = 0.5f - (float)syndrome[(size_t)c * ld + col];
        const size_t base = ((size_t)b * L * P + r) * ld + col;  // edge (b,0,r)
        float t[kMaxL];
        float pre[kMaxL];
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
          if (l < L) t[l] = 1.0f - 2.0f * v[base + l * block_step];
        }
        pre[0] = 1.0f;
#pragma unroll
        for (int l = 1; l < kMaxL; ++l) {
          if (l < L) pre[l] = pre[l - 1] * t[l - 1];
        }
        float suf = 1.0f;  // suffix product of t[l+1 .. L-1]
#pragma unroll
        for (int l = kMaxL - 1; l >= 0; --l) {
          if (l < L) {
            e[base + l * block_step] = 0.5f - sgn * (pre[l] * suf);
            suf = suf * t[l];
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
        float ep[kMaxB], em[kMaxB], pre_p[kMaxB], pre_m[kMaxB];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < B) {
            int r = q - g.shift[b * L + l];  // edge (b, l, r) carries var q
            if (r < 0) r += P;
            row[b] = ((size_t)(b * L + l) * P + r) * ld + col;
            ep[b] = e[row[b]];
            em[b] = 1.0f - ep[b];
          }
        }
        pre_p[0] = 1.0f;
        pre_m[0] = 1.0f;
        float full_p = 0.0f, full_m = 0.0f;
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < B) {
            if (b > 0) {
              pre_p[b] = pre_p[b - 1] * ep[b - 1];
              pre_m[b] = pre_m[b - 1] * em[b - 1];
            }
            if (b == B - 1) {  // full product, ascending order
              full_p = pre_p[b] * ep[b];
              full_m = pre_m[b] * em[b];
            }
          }
        }
        float suf_p = 1.0f, suf_m = 1.0f;
#pragma unroll
        for (int b = kMaxB - 1; b >= 0; --b) {
          if (b < B) {
            const float prod_p = last ? full_p : pre_p[b] * suf_p;
            const float prod_m = last ? full_m : pre_m[b] * suf_m;
            const float num = prior * prod_p;
            const float den = __fmaf_rn(one_minus_prior, prod_m, num);
            v[row[b]] = __fdiv_rn(num, den);
            suf_p = suf_p * ep[b];
            suf_m = suf_m * em[b];
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
          nc = inside_band(v[r * ld + col], conv_low, conv_high);
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
// e (B*L*P, batch) float32 (e is scratch), iters (batch,) int32.  `shifts`
// is a HOST pointer to the (B, L) exponent table.  Returns the cudaError_t
// of the launch (0 on success); does not synchronise.
extern "C" int qec_bp_sum_product(const int32_t* syndrome, float* v, float* e,
                                  int32_t* iters, const int32_t* shifts, int B,
                                  int L, int P, int batch, float prior,
                                  int max_iters, int check_every,
                                  float conv_low, float conv_high,
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
  bp_sum_product_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, syndrome, v, e, iters, batch, prior, max_iters, check_every,
      conv_low, conv_high);
  return (int)cudaGetLastError();
}
