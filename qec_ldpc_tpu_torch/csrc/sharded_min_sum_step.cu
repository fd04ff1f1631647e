// One iteration of graph-sharded normalized min-sum for one shard position:
// everything between two halo all_gathers of the graph-sharded engine
// (qec_ldpc_tpu_torch/parallel/graph_sharded.py), in ONE launch.
//
// Replaces qec_ldpc_tpu/kernels/sharded_step_pallas.py::
// sharded_min_sum_step_pallas (pallas_call at :188), which runs the same body
// on the TPU's transposed (blocks, batch, P padded to 128) tiles.  Here the
// layout is the port's row layout with the batch trailing, so a warp's reads
// of one row are coalesced and there is no padding.
//
// The shard owns Lc = L/G block columns of a B x L circulant graph, in (l, b)
// block order: edge row (l*B + b)*P + r is the edge of check (b, r) in the
// shard's block column l, check-indexed.  Per batch lane, bit for bit with
// the plain version (kernels/sharded_step_cuda.py) and the Pallas body
// (sharded_step_pallas.py:58-130):
//   1. check phase  per check (b, r): the exclusive prefix/suffix minimum of
//                   |V| and +-1 sign product over the shard's Lc columns,
//                   combined with the other shards' (min; sign),
//                   E = s * ((alpha * sign) * min), s the syndrome sign;
//   2. variable phase  per local variable (l, q): route E to var order by
//                   the column's exponent C[b, g*Lc + l], leave-one-out sums
//                   over b in prefix/suffix order (the full sum
//                   (pre[-1] + 0) + E[-1] on the last iteration), plus the
//                   prior LLR, routed back to check order.  Done lanes keep
//                   V bit for bit;
//   3. partials     per check (b, r): the minimum |V_new| and the sign
//                   product over the Lc columns of the masked V_new, the
//                   next iteration's halo payload.
// Minima propagate NaN like jnp.minimum (fminf does not); sign(x) is
// x < 0 ? -1 : 1, so NaN and -0.0 give +1; fabsf(-0.0) is +0.0.  The file is
// compiled with --fmad=false and has no fused multiply-add.
//
// A block owns a 16-lane batch tile; its threads stride over check rows,
// then over variables, then over check rows again, with a barrier between
// the phases.  E goes through a global scratch buffer.  What bounds it on
// the H100: bytes.  The step must read V, the other shards' partials and
// the syndrome signs and write V_new and the partials (about 15 operations
// per edge against 8+ bytes per edge); the kernel also writes and reads E
// and reads V_new again, all coalesced row segments through L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;       // variable degree (block rows)
constexpr int kMaxLc = 16;     // block columns per shard
constexpr int kTile = 16;      // batch lanes per block
constexpr int kThreads = 512;  // kThreads / kTile row groups per block

struct Shard {
  int B, Lc, P;
  int shift[kMaxB * kMaxLc];  // C[b, g*Lc + l] in [0, P), row-major (b, l)
};

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float sign_of(float x) {
  return x < 0.0f ? -1.0f : 1.0f;
}

__global__ void __launch_bounds__(kThreads)
sharded_step_kernel(const Shard s, const float* __restrict__ syn_sign,
                    const float* __restrict__ other,
                    const uint8_t* __restrict__ done,
                    const float* __restrict__ v, float* __restrict__ v_new,
                    float* __restrict__ part, float* __restrict__ e,
                    const int batch, const float prior_llr, const int last,
                    const float alpha) {
  const int lane = threadIdx.x % kTile;
  const int group = threadIdx.x / kTile;
  const int groups = blockDim.x / kTile;
  const int col = blockIdx.x * kTile + lane;
  const bool valid = col < batch;
  const bool live = valid && done[col] == 0;
  const int B = s.B, Lc = s.Lc, P = s.P;
  const int num_checks = B * P;
  const int num_vars = Lc * P;
  const int num_rows = Lc * B * P;
  const size_t ld = (size_t)batch;
  // edge row of (l, b, r) is l*B*P + (b*P + r): column l's block of check c
  const size_t col_step = (size_t)num_checks * ld;

  // ---- 1. check phase: thread (group, lane) walks checks c = b*P + r ----
  if (live) {
    for (int c = group; c < num_checks; c += groups) {
      const size_t base = (size_t)c * ld + col;
      float t[kMaxLc], pre_m[kMaxLc], pre_s[kMaxLc];
#pragma unroll
      for (int l = 0; l < kMaxLc; ++l) {
        if (l < Lc) t[l] = v[base + l * col_step];
      }
      pre_m[0] = INFINITY;
      pre_s[0] = 1.0f;
#pragma unroll
      for (int l = 1; l < kMaxLc; ++l) {
        if (l < Lc) {
          pre_m[l] = min_nan(pre_m[l - 1], fabsf(t[l - 1]));
          pre_s[l] = pre_s[l - 1] * sign_of(t[l - 1]);
        }
      }
      const float omin = other[base];
      const float osgn = other[col_step + base];
      const float sgn = syn_sign[base];
      float suf_m = INFINITY, suf_s = 1.0f;  // over l+1 .. Lc-1
#pragma unroll
      for (int l = kMaxLc - 1; l >= 0; --l) {
        if (l < Lc) {
          const float loo_min = min_nan(min_nan(pre_m[l], suf_m), omin);
          const float loo_sgn = (pre_s[l] * suf_s) * osgn;
          e[base + l * col_step] = sgn * ((alpha * loo_sgn) * loo_min);
          suf_m = min_nan(suf_m, fabsf(t[l]));
          suf_s = suf_s * sign_of(t[l]);
        }
      }
    }
  }
  __syncthreads();

  // ---- 2. variable phase: thread walks the shard's variables (l, q) ----
  if (live) {
    for (int var = group; var < num_vars; var += groups) {
      const int l = var / P;
      const int q = var - l * P;
      size_t row[kMaxB];
      float t[kMaxB], pre[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) {
          int r = q - s.shift[b * Lc + l];  // edge (l, b, r) carries var q
          if (r < 0) r += P;
          row[b] = ((size_t)(l * B + b) * P + r) * ld + col;
          t[b] = e[row[b]];
        }
      }
      pre[0] = 0.0f;
#pragma unroll
      for (int b = 1; b < kMaxB; ++b) {
        if (b < B) pre[b] = pre[b - 1] + t[b - 1];
      }
      float full = 0.0f;
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b == B - 1) full = (pre[b] + 0.0f) + t[b];  // (pre + suf) + term
      }
      float suf = 0.0f;  // sum of t[b+1 .. B-1], accumulated downwards
#pragma unroll
      for (int b = kMaxB - 1; b >= 0; --b) {
        if (b < B) {
          v_new[row[b]] = prior_llr + (last ? full : pre[b] + suf);
          suf = suf + t[b];
        }
      }
    }
  } else if (valid) {
    for (int i = group; i < num_rows; i += groups) {
      v_new[(size_t)i * ld + col] = v[(size_t)i * ld + col];
    }
  }
  __syncthreads();

  // ---- 3. the next iteration's local (min; sign) partials ----
  if (valid) {
    for (int c = group; c < num_checks; c += groups) {
      const size_t base = (size_t)c * ld + col;
      float x = v_new[base];
      float m = fabsf(x), sg = sign_of(x);
      for (int l = 1; l < Lc; ++l) {
        x = v_new[base + l * col_step];
        m = min_nan(m, fabsf(x));
        sg = sg * sign_of(x);
      }
      part[base] = m;
      part[col_step + base] = sg;
    }
  }
}

}  // namespace

// Launch on `stream`.  Device pointers: syn_sign (B*P, batch) float32 +-1,
// other (2*B*P, batch) float32 (the other shards' minima, then their sign
// products), done (batch,) uint8, v and v_new (Lc*B*P, batch) float32, part
// (2*B*P, batch) float32, e (Lc*B*P, batch) float32 scratch.  `shifts` is a
// HOST pointer to the shard's (B, Lc) exponent sub-table.  Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int qec_sharded_min_sum_step(const float* syn_sign,
                                        const float* other,
                                        const uint8_t* done, const float* v,
                                        float* v_new, float* part, float* e,
                                        const int32_t* shifts, int B, int Lc,
                                        int P, int batch, float prior_llr,
                                        int last, float alpha, void* stream) {
  if (B < 1 || B > kMaxB || Lc < 1 || Lc > kMaxLc || P < 1 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Shard s;
  s.B = B;
  s.Lc = Lc;
  s.P = P;
  for (int i = 0; i < kMaxB * kMaxLc; ++i) s.shift[i] = 0;
  for (int i = 0; i < B * Lc; ++i) {
    const int c = shifts[i] % P;
    s.shift[i] = c < 0 ? c + P : c;
  }
  const int blocks = (batch + kTile - 1) / kTile;
  sharded_step_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      s, syn_sign, other, done, v, v_new, part, e, batch, prior_llr, last,
      alpha);
  return (int)cudaGetLastError();
}
