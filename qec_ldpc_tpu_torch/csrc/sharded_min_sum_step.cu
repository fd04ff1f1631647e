// One iteration of graph-sharded normalized min-sum for one shard position:
// everything between two halo all_gathers of the graph-sharded engine
// (qec_ldpc_tpu_torch/parallel/graph_sharded.py), in ONE launch.
//
// Replaces qec_ldpc_tpu/kernels/sharded_step_pallas.py::
// sharded_min_sum_step_pallas (pallas_call at :188), which runs the same body
// on the TPU's transposed (blocks, batch, P padded to 128) tiles.  Here the
// layout is the port's row layout with the batch trailing, so the lanes of a
// CTA read one row's neighbouring words and there is no padding.
//
// The shard owns Lc = L/G block columns of a B x L circulant graph, in (l, b)
// block order: edge row (l*B + b)*P + r is the edge of check (b, r) in the
// shard's block column l, check-indexed.  Per batch lane, bit for bit with
// the plain version (kernels/sharded_step_cuda.py) and the Pallas body
// (sharded_step_pallas.py:58-130):
//   1. check phase  per check (b, r): the leave-one-out minimum of |V| and
//                   +-1 sign product over the shard's Lc columns, combined
//                   with the other shards' (min; sign),
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
// compiled with --fmad=false and has no fused multiply-add.  The syndrome
// signs and the other shards' signs are +-1, as the engine makes them.
//
// What bounds it on the H100.  The step must read V, the other shards'
// partials and the syndrome signs and write V_new and the partials: about 8
// bytes per edge and lane against 15 float operations, so bytes.  The first
// design (one 16-lane tile per block, E through a global scratch buffer,
// V_new read back for the partials) ran 6.9x that bound at batch 1024 and
// hardly followed the batch (0.200 ms at 256, 0.266 at 1024): a thin grid
// (64 blocks at 1024, 16 at 256) each walking the whole shard, waiting on
// latency.  This design:
//
//   * Compressed check state instead of E, as in min_sum.cu.  The check
//     phase keeps, per check and lane, min1 and min2 of |V| over its
//     non-NaN local edges, each already combined with the other shards'
//     minimum (min(m, omin), NaN-propagating), the argmin edge, the NaN
//     count (capped at 2) and the edge of a single NaN, the sign parity of
//     the local edges xor the syndrome sign xor the other shards' sign, and
//     each local edge's own sign bit: 12 bytes per check.  This is exact:
//     minima do not depend on order, NaN propagates by count, min(sel(m1,
//     m2), omin) = sel(min(m1, omin), min(m2, omin)), products of +-1 are
//     exact, and (+-alpha) * m rounds symmetrically, so folding s into the
//     sign gives s * ((alpha * sgn) * m) bit for bit.  The variable phase
//     rebuilds each E from the state alone (its own edge's sign and NaN-ness
//     are in the state too), so V is read once, in the check phase.
//   * Several lanes per CTA, the lanes of a warp's rows neighbouring words
//     (8 lanes: one 32-byte sector per row), the state in shared memory
//     while it fits, else in a per-CTA slab of global scratch.
//     kernels/sharded_step_cuda.py::plan chooses the lanes per CTA and the
//     partials' route.
//   * The partials either folded into the variable phase (shared-memory
//     atomicMin on a NaN-first key of |V_new| and an xor of the sign bits
//     into the state's spare bit; min and +-1 products are order-free, so
//     this is exact; 4 more bytes per check) or read back from V_new, which
//     the CTA has just written (L2-hot).
//   * Done lanes copy V to V_new and take their partials from the check
//     phase's local state; they skip the variable phase.
// The variable degree B is a template parameter (exact arrays, no guards);
// threads stride over a CTA's (check, lane) and (variable, lane) pairs with
// the stride's index steps precomputed.
//
// Measured on an H100 (80GB HBM3, 700 W; chip_smoke.py phase 19), one step
// of shard 0 of 2 of [[5210,521]] X (B = 4, Lc = 5, P = 521), ms at batch
// 256 / 1024 / 2048, lanes per CTA / partials route / state placement:
//   2 read smem    0.057-0.064  0.254  0.518
//   4 read smem    0.044-0.063  0.148  0.284
//   4 fold smem    0.047-0.062  0.142  0.261
//   8 read smem    0.073        0.112  0.227   (the first design: 0.192,
//  16 read slab    0.131        0.175  0.243    0.265, 0.303)
//  16 fold slab    0.137        0.171  0.285
// Eight lanes per CTA (X's state 200 KB, one CTA of 1024 threads per SM)
// win at the main path's 1024 and at 2048; folding the partials beats the
// read-back at equal lanes, so the plan folds wherever the key still fits
// (Z's shard: 4 lanes, 167 KB).  At 1024 the kernel runs 2.9x its bytes
// bound of 0.038 ms.  At 256 the grid is thin again (32 CTAs of 8 lanes)
// and 4 lanes are faster; the plan keeps 8 for the main path's batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;        // variable degree (block rows)
constexpr int kMaxLc = 16;      // block columns per shard
constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = 32;   // lanes per CTA
constexpr unsigned kNoArg = 31; // argmin field when every local edge is NaN

struct Shard {
  int B, Lc, P;
  int shift[kMaxLc * kMaxB];  // C[b, g*Lc + l] in [0, P) at [l * kMaxB + b]
};

// the state's meta word, per check and lane
//   bits  0-4   argmin edge l of min1 (kNoArg when every local edge is NaN)
//   bits  5-6   NaN count over the local edges, capped at 2
//   bits  7-10  the NaN edge when the count is 1
//   bit  11     local edges' sign parity ^ syndrome sign ^ other shards' sign
//   bits 12-27  each local edge l's own sign bit (bit 12 + l)
//   bit  31     the sign parity of V_new, xor-ed in by the variable phase
constexpr unsigned kPartSign = 1u << 31;

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float sign_of(float x) {
  return x < 0.0f ? -1.0f : 1.0f;
}

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// kB: the variable degree B, at compile time.  kShared: the CTA's state in
// shared memory (shared loads and stores); otherwise in its global slab.
// lanes_log2: log2 of the lanes per CTA.  fold: the partials come from the
// variable phase's atomics, else from a read-back of V_new.
template <int kB, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
sharded_step_kernel(const Shard s, const float* __restrict__ syn_sign,
                    const float* __restrict__ other,
                    const uint8_t* __restrict__ done,
                    const float* __restrict__ v, float* __restrict__ v_new,
                    float* __restrict__ part, unsigned char* __restrict__ scratch,
                    const size_t slab_bytes, const int batch,
                    const int lanes_log2, const int fold,
                    const float prior_llr, const int last, const float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NL = 1 << lanes_log2;
  const int tid = threadIdx.x;
  const int ln = tid & (NL - 1);
  const int grp = tid >> lanes_log2;
  const int groups = blockDim.x >> lanes_log2;
  const int col = blockIdx.x * NL + ln;
  const bool valid = col < batch;
  const bool live = valid && done[col] == 0;
  const int Lc = s.Lc, P = s.P;
  const int checks = kB * P;
  const int vars = Lc * P;
  const size_t ld = (size_t)batch;
  // edge row of (l, b, r) is l*B*P + (b*P + r): column l's block of check c
  const size_t col_step = (size_t)checks * ld;

  // the CTA's state: {min1, min2}, meta and (fold) the partial-min key
  unsigned char* base_ptr =
      kShared ? smem : scratch + (size_t)blockIdx.x * slab_bytes;
  const size_t n_state = (size_t)checks * NL;
  float2* M = reinterpret_cast<float2*>(base_ptr);
  unsigned* META = reinterpret_cast<unsigned*>(base_ptr + align16(8 * n_state));
  unsigned* KEY = META + align16(4 * n_state) / 4;

  // ---- 1. check phase: thread walks (check c, lane) pairs ----
  if (valid) {
    for (int c = grp; c < checks; c += groups) {
      const size_t at = (size_t)c * ld + col;
      float m1 = INFINITY, m2 = INFINITY;
      unsigned arg = kNoArg, nans = 0, nan_at = 0, neg = 0, signs = 0;
      const float* vp = v + at;
      for (int l = 0; l < Lc; ++l, vp += col_step) {
        const float t = *vp;
        const float a = fabsf(t);
        const unsigned sb = t < 0.0f;
        neg ^= sb;
        signs |= sb << l;
        if (isnan(t)) {
          ++nans;
          nan_at = l;
        } else if (a < m1) {
          m2 = m1;
          m1 = a;
          arg = l;
        } else if (a < m2) {
          m2 = a;
        }
        if (!live) v_new[at + (size_t)l * col_step] = t;
      }
      if (live) {
        const float omin = other[at];
        neg ^= (other[col_step + at] < 0.0f) ^ (syn_sign[at] < 0.0f);
        const size_t k = (size_t)c * NL + ln;
        M[k] = make_float2(min_nan(m1, omin), min_nan(m2, omin));
        META[k] = arg | (min(nans, 2u) << 5) | (nan_at << 7) | (neg << 11) |
                  (signs << 12);
        if (fold) KEY[k] = 0xffffffffu;
      } else {
        // a done lane's partials: its local minimum and sign product
        part[at] = nans ? NAN : m1;
        part[col_step + at] = neg ? -1.0f : 1.0f;
      }
    }
  }
  __syncthreads();

  // ---- 2. variable phase: thread walks (local variable (l, q), lane) ----
  if (live) {
    const int i0 = grp / P, j0 = grp - i0 * P;
    const int Gi = groups / P, Gj = groups - Gi * P;
    for (int var = grp, l = i0, q = j0; var < vars; var += groups) {
      const int* shift = s.shift + l * kMaxB;
      size_t row[kB];
      unsigned key_at[kB];
      float t[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        int r = q - shift[b];  // edge (l, b, r) carries var q
        if (r < 0) r += P;
        const unsigned k = (unsigned)((b * P + r) * NL + ln);
        key_at[b] = k;
        row[b] = ((size_t)(l * kB + b) * P + r) * ld + col;
        const float2 m = M[k];
        const unsigned meta = META[k];
        // leave-one-out minimum of edge l: NaN when another local edge is
        // NaN (the reference's minima propagate NaN)
        const unsigned nans = (meta >> 5) & 3u;
        const bool nan_other =
            nans > (((meta >> 7) & 15u) == (unsigned)l ? 1u : 0u);
        const float loo_min =
            nan_other ? NAN : ((meta & 31u) == (unsigned)l ? m.y : m.x);
        const unsigned neg = ((meta >> 11) ^ (meta >> (12 + l))) & 1u;
        t[b] = (neg ? -alpha : alpha) * loo_min;
      }
      float pre[kB];
      pre[0] = 0.0f;
#pragma unroll
      for (int b = 1; b < kB; ++b) pre[b] = pre[b - 1] + t[b - 1];
      const float full = (pre[kB - 1] + 0.0f) + t[kB - 1];  // (pre + suf) + term
      float suf = 0.0f;  // sum of t[b+1 .. B-1], accumulated downwards
#pragma unroll
      for (int b = kB - 1; b >= 0; --b) {
        const float vv = prior_llr + (last ? full : pre[b] + suf);
        v_new[row[b]] = vv;
        if (fold) {
          // NaN first (key 0), then |V_new| in bit order
          const unsigned key =
              isnan(vv) ? 0u : __float_as_uint(fabsf(vv)) + 1u;
          atomicMin(KEY + key_at[b], key);
          if (vv < 0.0f) atomicXor(META + key_at[b], kPartSign);
        }
        suf = suf + t[b];
      }
      l += Gi;
      q += Gj;
      if (q >= P) {
        q -= P;
        ++l;
      }
    }
  }
  __syncthreads();

  // ---- 3. the next iteration's local (min; sign) partials ----
  if (live) {
    for (int c = grp; c < checks; c += groups) {
      const size_t at = (size_t)c * ld + col;
      float m, sg;
      if (fold) {
        const size_t k = (size_t)c * NL + ln;
        const unsigned key = KEY[k];
        m = key ? __uint_as_float(key - 1u) : NAN;
        sg = (META[k] & kPartSign) ? -1.0f : 1.0f;
      } else {
        float x = v_new[at];
        m = fabsf(x);
        sg = sign_of(x);
        for (int l = 1; l < Lc; ++l) {
          x = v_new[at + (size_t)l * col_step];
          m = min_nan(m, fabsf(x));
          sg = sg * sign_of(x);
        }
      }
      part[at] = m;
      part[col_step + at] = sg;
    }
  }
}

template <int kB, bool kShared>
cudaError_t launch(const Shard& s, int blocks, int threads, size_t smem_bytes,
                   cudaStream_t st, const float* syn_sign, const float* other,
                   const uint8_t* done, const float* v, float* v_new,
                   float* part, unsigned char* scratch, size_t slab_bytes,
                   int batch, int lanes_log2, int fold, float prior_llr,
                   int last, float alpha) {
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch; a size above the device's limit fails here
  const cudaError_t attr = cudaFuncSetAttribute(
      sharded_step_kernel<kB, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  sharded_step_kernel<kB, kShared><<<blocks, threads, smem_bytes, st>>>(
      s, syn_sign, other, done, v, v_new, part, scratch, slab_bytes, batch,
      lanes_log2, fold, prior_llr, last, alpha);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  Device pointers: syn_sign (B*P, batch) float32 +-1,
// other (2*B*P, batch) float32 (the other shards' minima, then their sign
// products, +-1), done (batch,) uint8, v and v_new (Lc*B*P, batch) float32,
// part (2*B*P, batch) float32, scratch the CTAs' global state slabs
// (ceil(batch / lanes) * slab_bytes bytes; NULL when the state is in shared
// memory).  `shifts` is a HOST pointer to the shard's (B, Lc) exponent
// sub-table.  `lanes` (a power of two up to 32), `threads`, `fold`,
// `smem_bytes` and `slab_bytes` are the wrapper's plan
// (kernels/sharded_step_cuda.py::plan); the state lives in shared memory
// exactly when slab_bytes is 0.  Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int qec_sharded_min_sum_step(
    const float* syn_sign, const float* other, const uint8_t* done,
    const float* v, float* v_new, float* part, unsigned char* scratch,
    const int32_t* shifts, int B, int Lc, int P, int batch, float prior_llr,
    int last, float alpha, int lanes, int threads, int fold,
    long long smem_bytes, long long slab_bytes, void* stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  if (B < 1 || B > kMaxB || Lc < 1 || Lc > kMaxLc || P < 1 || batch < 1 ||
      lanes < 1 || lanes > kMaxLanes || (1 << lanes_log2) != lanes ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes < 0 || slab_bytes < 0 ||
      (slab_bytes > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Shard s;
  s.B = B;
  s.Lc = Lc;
  s.P = P;
  for (int i = 0; i < kMaxLc * kMaxB; ++i) s.shift[i] = 0;
  for (int b = 0; b < B; ++b) {
    for (int l = 0; l < Lc; ++l) {
      const int c = shifts[b * Lc + l] % P;
      s.shift[l * kMaxB + b] = c < 0 ? c + P : c;
    }
  }
  const int blocks = (batch + lanes - 1) / lanes;
  const bool shared = slab_bytes == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_K8_B(KB)                                                        \
  case KB:                                                                  \
    err = shared ? launch<KB, true>(s, blocks, threads, (size_t)smem_bytes, \
                                    st, syn_sign, other, done, v, v_new,    \
                                    part, scratch, 0, batch, lanes_log2,    \
                                    fold, prior_llr, last, alpha)           \
                 : launch<KB, false>(s, blocks, threads, (size_t)smem_bytes,\
                                     st, syn_sign, other, done, v, v_new,   \
                                     part, scratch, (size_t)slab_bytes,     \
                                     batch, lanes_log2, fold, prior_llr,    \
                                     last, alpha);                          \
    break;
  switch (B) {
    QEC_K8_B(1)
    QEC_K8_B(2)
    QEC_K8_B(3)
    QEC_K8_B(4)
    QEC_K8_B(5)
    QEC_K8_B(6)
    QEC_K8_B(7)
    QEC_K8_B(8)
  }
#undef QEC_K8_B
  return (int)err;
}
