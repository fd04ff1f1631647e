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
//                  (conv_low, conv_high); NaN counts as converged.  A done
//                  lane keeps its messages.
// Leave-one-out products use the reference's exclusive prefix/suffix
// association order, and the file is compiled with --fmad=false so the only
// fused multiply-add is the explicit one in the denominator (XLA contracts
// exactly that one).  Division is IEEE (__fdiv_rn), and denormals are kept:
// leave-one-out products of a few small probabilities reach them.
//
// What bounds it on the H100.  The float work is 18 operations per edge and
// iteration: 67 TFLOP/s puts 100 iterations of [[610,61]] X at batch 2048 at
// 0.13 ms.  The first design (one 16-lane tile per block, V and E in global
// memory) ran 63x that: every phase moved ~16 bytes per edge and lane
// through L2, and a tile ran until its slowest lane converged.  With the
// messages on chip, what the kernel waits for is instruction issue and
// latency, as the min-sum kernel (min_sum.cu) showed.  The design follows
// that kernel:
//
//   * One lane per CTA.  A lane's decode ends at its own convergence test and
//     the CTA exits; the block scheduler hands the SM the next lane, so no
//     lane waits for another, and iters[lane] is the lane's own count.
//   * V and E on chip.  The leave-one-out products need every edge's value,
//     so there is no compressed check state: per lane, the syndrome bits, V
//     and E (4 bytes per edge each) live in shared memory while they fit in
//     what the device lets a CTA opt in to (227 KB on the H100).  [[610,61]]
//     takes 19.5 KB (X) / 24.4 KB (Z), so several CTAs share an SM; the
//     P = 521 codes 166.7 / 208.4 KB, one CTA per SM; at P >= 1051 E (then V)
//     goes to a per-lane slab of global scratch, contiguous in the lane so a
//     warp's accesses coalesce.  kernels/bp_cuda.py::plan decides.
//   * No register arrays in the check phase.  The forward pass writes each
//     edge's exclusive prefix product into E; the backward pass reads it
//     back, multiplies by the running suffix and forms E in place.  1 - 2V
//     is recomputed from V (the same rounding both times), so the check
//     degree L stays a runtime loop bound with no kMaxL guards.
//   * Latency and issue.  The variable degree B is a template parameter
//     (exact arrays, no guards); threads stride over the lane's checks, then
//     over its variables, with the stride's index steps precomputed (no
//     division in the loop); consecutive threads touch consecutive words in
//     both phases.  The convergence test runs only on test iterations and
//     rides on the second barrier (__syncthreads_or).
//
// Measured on an H100 (80GB HBM3, 700 W; chip_smoke.py and profile_cells.py):
// 100 fixed iterations of [[610,61]] X at batch 2048 take 2.15 ms, against
// 8.49 ms for the first design in the same run and a bound of 0.134 ms, so
// it is still issue- and latency-bound (~16x): ptxas gives the on-chip B = 4
// and 5 kernels 32 registers with 8-20 bytes of spill (six CTAs of 320
// threads per SM); every iteration is two barriers and ~6 shared accesses
// per edge.  Under early exit on the headline's W=15 batches (every lane
// stops at the n = 10 test) a launch takes 0.27 / 0.33 ms (X / Z), and the
// headline cell's launch 0.30 ms against 1.07.  One version was measured.
//
// Layout of the operands: (edges, batch) float32 / (checks, batch) int32
// with the batch trailing, edges check-indexed as in decoder/layout.py: edge
// (b, l, r) joins check b*P + r and variable l*P + (C[b,l] + r) % P.  A
// lane's column is strided, so the syndrome is staged once at the start and
// V written once at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;        // variable degree (block rows)
constexpr int kMaxL = 16;       // check degree (block columns)
constexpr int kMaxThreads = 1024;

struct Graph {
  int B, L, P;
  int shift[kMaxL * kMaxB];  // C[b, l] in [0, P) at [l * kMaxB + b]
};

// Where a lane's V and E live: set = shared memory, else the lane's slab of
// global scratch.  The syndrome bits are always in shared memory.  The
// wrapper decides it (kernels/bp_cuda.py::plan) and passes the sizes it
// implies; the kernel lays the arrays out in plan's order: V, E, the
// syndrome bits, each 16-byte aligned.
struct Placement {
  int v_shared, e_shared;
};

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// The next array of `bytes` bytes: in shared memory at `sp`, or in the
// lane's slab at `slab`; advances the one it takes from.
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

// kB: the variable degree B, at compile time.  kAllShared: V and E in
// shared memory, so the compiler emits shared loads and stores; otherwise
// the pointers are generic.
template <int kB, bool kAllShared>
__global__ void __launch_bounds__(kMaxThreads)
bp_sum_product_kernel(const Graph g, const Placement pl,
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
  const int L = g.L, P = g.P;
  const int LP = L * P;
  const int checks = kB * P;
  const int vars = LP;
  const int edges = kB * LP;
  const size_t ld = (size_t)batch;
  const float one_minus_prior = 1.0f - prior;

  // carve the lane's arrays out of shared memory and its slab
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

  // a thread's first check (b, r) = (i0, j0) and first variable (l, q) =
  // (i0, j0) (both indices are i*P + j), and its stride T in those
  // coordinates: no division inside the loop
  const int i0 = tid / P, j0 = tid - i0 * P;
  const int Ti = T / P, Tj = T - Ti * P;

  int n = 0;
  while (n < max_iters) {
    const bool last = (n == max_iters - 1);
    const bool test = (n % check_every == 0);

    // ---- check phase: thread walks checks c = (b, r) ----
    for (int c = tid, b = i0, r = j0; c < checks; c += T) {
      const float sgn = SYN[c] ? -0.5f : 0.5f;
      const float* vrow = V + b * LP + r;  // edge (b, 0, r); (b, l, r) at l*P
      float* erow = E + b * LP + r;
      float pre = 1.0f;  // exclusive prefix product of t[0 .. l-1]
      for (int l = 0; l < L; ++l) {
        erow[l * P] = pre;
        pre = pre * (1.0f - 2.0f * vrow[l * P]);
      }
      float suf = 1.0f;  // suffix product of t[l+1 .. L-1]
      for (int l = L - 1; l >= 0; --l) {
        const float t = 1.0f - 2.0f * vrow[l * P];
        erow[l * P] = 0.5f - sgn * (erow[l * P] * suf);
        suf = suf * t;
      }
      b += Ti;
      r += Tj;
      if (r >= P) {
        r -= P;
        ++b;
      }
    }
    __syncthreads();

    // ---- variable phase: thread walks variables (l, q) ----
    bool not_conv = false;
    for (int var = tid, l = i0, q = j0; var < vars; var += T) {
      const int* shift = g.shift + l * kMaxB;
      const int lP = l * P;
      int edge[kB];
      float ep[kB], em[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        int r = q - shift[b];  // edge (b, l, r) carries var q
        if (r < 0) r += P;
        edge[b] = b * LP + lP + r;
        ep[b] = E[edge[b]];
        em[b] = 1.0f - ep[b];
      }
      float pre_p[kB], pre_m[kB];
      pre_p[0] = 1.0f;
      pre_m[0] = 1.0f;
#pragma unroll
      for (int b = 1; b < kB; ++b) {
        pre_p[b] = pre_p[b - 1] * ep[b - 1];
        pre_m[b] = pre_m[b - 1] * em[b - 1];
      }
      // full product, ascending order
      const float full_p = pre_p[kB - 1] * ep[kB - 1];
      const float full_m = pre_m[kB - 1] * em[kB - 1];
      float suf_p = 1.0f, suf_m = 1.0f;
#pragma unroll
      for (int b = kB - 1; b >= 0; --b) {
        const float prod_p = last ? full_p : pre_p[b] * suf_p;
        const float prod_m = last ? full_m : pre_m[b] * suf_m;
        const float num = prior * prod_p;
        const float den = __fmaf_rn(one_minus_prior, prod_m, num);
        const float vv = __fdiv_rn(num, den);
        V[edge[b]] = vv;
        if (test) not_conv |= inside_band(vv, conv_low, conv_high);
        suf_p = suf_p * ep[b];
        suf_m = suf_m * em[b];
      }
      l += Ti;
      q += Tj;
      if (q >= P) {
        q -= P;
        ++l;
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

template <int kB, bool kAllShared>
cudaError_t launch(const Graph& g, const Placement& pl, size_t smem_bytes,
                   int threads, cudaStream_t stream, const int32_t* syndrome,
                   float* v, float* scratch, size_t slab_floats,
                   int32_t* iters, int batch, float prior, int max_iters,
                   int check_every, float conv_low, float conv_high) {
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch (it costs nothing next to the decode); a
  // size above the device's limit fails here, with its error
  const cudaError_t attr = cudaFuncSetAttribute(
      bp_sum_product_kernel<kB, kAllShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  bp_sum_product_kernel<kB, kAllShared><<<batch, threads, smem_bytes, stream>>>(
      g, pl, syndrome, v, scratch, slab_floats, iters, batch, prior,
      max_iters, check_every, conv_low, conv_high);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  Device pointers: syndrome (B*P, batch) int32, v
// (B*L*P, batch) float32 (the output), scratch the lanes' global slabs
// (batch * slab_floats float32; may be NULL when slab_floats is 0), iters
// (batch,) int32.  `shifts` is a HOST pointer to the (B, L) exponent table.
// The placement flags, `threads`, `smem_bytes` (dynamic shared memory per
// CTA) and `slab_floats` (global scratch per lane) are the wrapper's plan
// (kernels/bp_cuda.py::plan).  Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int qec_bp_sum_product(const int32_t* syndrome, float* v,
                                  float* scratch, int32_t* iters,
                                  const int32_t* shifts, int B, int L, int P,
                                  int batch, float prior, int max_iters,
                                  int check_every, float conv_low,
                                  float conv_high, int threads, int v_shared,
                                  int e_shared, long long smem_bytes,
                                  long long slab_floats, void* stream) {
  if (B < 1 || B > kMaxB || L < 1 || L > kMaxL || P < 1 || batch < 1 ||
      max_iters < 0 || check_every < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem_bytes < 0 ||
      slab_floats < 0 || (slab_floats > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Graph g;
  g.B = B;
  g.L = L;
  g.P = P;
  for (int i = 0; i < kMaxL * kMaxB; ++i) g.shift[i] = 0;
  for (int b = 0; b < B; ++b) {
    for (int l = 0; l < L; ++l) {
      const int s = shifts[b * L + l] % P;
      g.shift[l * kMaxB + b] = s < 0 ? s + P : s;
    }
  }
  const Placement pl{v_shared != 0, e_shared != 0};
  const bool all = slab_floats == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_BP_B(KB)                                                        \
  case KB:                                                                  \
    err = all ? launch<KB, true>(g, pl, (size_t)smem_bytes, threads, st,    \
                                 syndrome, v, scratch, (size_t)slab_floats, \
                                 iters, batch, prior, max_iters,            \
                                 check_every, conv_low, conv_high)          \
              : launch<KB, false>(g, pl, (size_t)smem_bytes, threads, st,   \
                                  syndrome, v, scratch,                     \
                                  (size_t)slab_floats, iters, batch, prior, \
                                  max_iters, check_every, conv_low,         \
                                  conv_high);                               \
    break;
  switch (B) {
    QEC_BP_B(1)
    QEC_BP_B(2)
    QEC_BP_B(3)
    QEC_BP_B(4)
    QEC_BP_B(5)
    QEC_BP_B(6)
    QEC_BP_B(7)
    QEC_BP_B(8)
  }
#undef QEC_BP_B
  return (int)err;
}
