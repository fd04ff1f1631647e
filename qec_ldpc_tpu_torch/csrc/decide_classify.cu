// Decide -> classify of the counting chunk in ONE launch: from the final
// messages the decode kernels (K1, K2/K4, K5, K6) return for the X and Z
// graphs to the chunk's nine classification counters and its two
// lane-iteration sums, added into the caller's int64 accumulators.
//
// Replaces no Pallas kernel: the JAX package leaves the decisions and the
// classification to XLA (qec_ldpc_tpu/decoder/decode.py::decide,
// qec_ldpc_tpu/sampling/classify.py::classify_batch).  The port's plain
// composition of the same steps (kernels/classify_cuda.py::
// decide_classify_plain) is about 110 device operations of a few
// microseconds each; this kernel is the same arithmetic, all of it integer
// or compare-only, so its counters equal the plain ones exactly whatever
// order the atomics take.
//
// Per lane b, for each graph (X, then Z) with final messages v:
//   decision  d[j] = some rank i with v[to_var[i*n + j], b] >= threshold
//             (sum-product) or <= 0 (min-sum); a NaN sets no bit
//   conv fail some edge with v != 0 && low < v < high (sum-product) or
//             |v| < band (min-sum); a NaN counts as converged
//   syn fail  some check c with XOR_k d[var(c, k)] != s[c, b]
//   residual  r = e xor d; tested = some e != 0
// then, where neither graph's syndrome failed, the rank-basis test of each
// sector: r lies in rowspace(G) iff r == XOR of the rows t of G with
// r[pivot_t] = 1 (G in RREF), walked over r's set bits.
//
// What bounds it on the H100: bytes.  It reads each final message, error
// and syndrome entry once, (E_x + E_z + 2n + C_x + C_z) x 4 bytes a lane:
// ~60 MB for the [[610,61]] counting chunk of 2048 lanes (18 us at
// 3.35 TB/s), ~11 MB for the gross code's.  Its design keeps every
// intermediate on chip:
//   * a block takes kLanes consecutive lanes (threadIdx.x % kLanes), and its
//     kGroups row groups split the variables, then the checks, then the
//     residual's words, so every row is read as kLanes consecutive words;
//     a thread issues the loads of all of a variable's edges before it
//     compares any, so each warp keeps several rows in flight;
//   * each lane's decisions and residuals are bitsets in shared memory
//     (ceil(n/32) words a graph), set by atomicOr, which is rare: the set
//     bits are the decoded errors and the residual;
//   * the lanes' flags reduce by one warp ballot and __popc per counter,
//     and a block adds its counts with one atomicAdd per nonzero counter.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// 8 lanes (32-byte row segments) by 64 row groups: 256 blocks at 2048
// lanes, two on most SMs.  Of the shapes timed on the counting cells'
// chunks (4..32 lanes, 256..1024 threads) the fastest on both.
constexpr int kLanes = 8;
constexpr int kThreads = 512;
constexpr int kGroups = kThreads / kLanes;
constexpr int kMaxVarDegree = 8;  // every decode kernel's limit

// per-lane flags in shared memory
enum { kConvX, kConvZ, kSynX, kSynZ, kTestedX, kTestedZ, kLogical, kFlags };

struct Graph {
  const float* v;               // (E, batch) final check-indexed messages
  const long long* to_var;      // (dv * n,): edge row of var j's rank-i edge
  const long long* var_of_edge; // (E,): the variable of each edge row
  const int32_t* syndrome;      // (checks, batch)
  const int32_t* errors;        // (n, batch)
  const int32_t* iters;         // (batch,) each lane's executed iterations
  int dv, checks, dc, p;        // check c's rank-k edge row:
                                // (c / p * dc + k) * p + c % p
};

struct Sector {
  const uint32_t* basis;  // (rank, words): row t's bit j at word j / 32
  const int32_t* row_of;  // (n,): the row whose pivot is column j, else -1
};

struct Rule {
  float threshold, low, high, band;
};

// One graph's decisions and residuals into the lane's bitsets, and its
// convergence and tested flags.  Two variables a step, all their loads
// issued before the first compare.
template <bool kMinSum>
__device__ __forceinline__ void decide(const Graph G, const Rule rule, int n,
                                       int batch, int lane, bool valid, int g,
                                       uint32_t* dec, uint32_t* res,
                                       int* conv_flag, int* tested_flag) {
  bool conv = false, tested = false;
  if (valid) {
    for (int j0 = g; j0 < n; j0 += 2 * kGroups) {
      float x[2][kMaxVarDegree];
      int e[2] = {0, 0};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * kGroups;
        if (j < n) {
          e[u] = __ldg(G.errors + (long long)j * batch + lane);
#pragma unroll
          for (int i = 0; i < kMaxVarDegree; ++i) {
            if (i < G.dv) {
              x[u][i] = __ldg(G.v + __ldg(G.to_var + (long long)i * n + j) *
                                        batch + lane);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * kGroups;
        if (j >= n) break;
        bool bit = false;
#pragma unroll
        for (int i = 0; i < kMaxVarDegree; ++i) {
          if (i < G.dv) {
            if (kMinSum) {
              bit |= x[u][i] <= 0.0f;
              conv |= fabsf(x[u][i]) < rule.band;
            } else {
              bit |= x[u][i] >= rule.threshold;
              conv |= x[u][i] != 0.0f && x[u][i] > rule.low &&
                      x[u][i] < rule.high;
            }
          }
        }
        tested |= e[u] != 0;
        const uint32_t m = 1u << (j & 31);
        if (bit) atomicOr(&dec[j >> 5], m);
        // (e + d) % 2 for any int e: e's low bit xor d
        if (bit != ((e[u] & 1) != 0)) atomicOr(&res[j >> 5], m);
      }
    }
  }
  if (conv) atomicOr(conv_flag, 1);
  if (tested) atomicOr(tested_flag, 1);
}

// Whether some check of the lane's rows differs from the re-encoded
// decision.
__device__ __forceinline__ bool syndrome_fails(const Graph G,
                                               const uint32_t* dec, int batch,
                                               int lane, bool valid, int g) {
  bool fail = false;
  if (valid) {
    for (int c = g; c < G.checks; c += kGroups) {
      const int s = __ldg(G.syndrome + (long long)c * batch + lane);
      const long long base = (long long)(c / G.p) * G.dc * G.p + c % G.p;
      int parity = 0;
#pragma unroll 4
      for (int k = 0; k < G.dc; ++k) {
        const int var = (int)__ldg(G.var_of_edge + base + (long long)k * G.p);
        parity ^= (dec[var >> 5] >> (var & 31)) & 1;
      }
      fail |= parity != s;
    }
  }
  return fail;
}

// Whether the residual r differs, in one of the words this thread takes,
// from the combination of basis rows its pivot bits select.
__device__ __forceinline__ bool outside_rowspace(const Sector S,
                                                 const uint32_t* r, int words,
                                                 int g) {
  bool outside = false;
  for (int w = g; w < words; w += kGroups) {
    uint32_t acc = 0;
    for (int k = 0; k < words; ++k) {
      for (uint32_t b = r[k]; b; b &= b - 1) {
        const int t = __ldg(S.row_of + (k << 5) + __ffs(b) - 1);
        if (t >= 0) acc ^= __ldg(S.basis + (long long)t * words + w);
      }
    }
    outside |= acc != r[w];
  }
  return outside;
}

template <bool kMinSum>
__global__ void __launch_bounds__(kThreads)
    decide_classify_kernel(const Graph gx, const Graph gz, const Sector sx,
                           const Sector sz, const Rule rule, int n, int words,
                           int batch, unsigned long long* counters,
                           unsigned long long* iters) {
  // [graph][decision, residual][kLanes][words]
  extern __shared__ uint32_t bits[];
  __shared__ int flags[kFlags][kLanes];
  const int l = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const int lane = blockIdx.x * kLanes + l;
  const bool valid = lane < batch;
  for (int i = threadIdx.x; i < 4 * kLanes * words; i += kThreads) bits[i] = 0;
  if (threadIdx.x < kFlags * kLanes) {
    flags[threadIdx.x / kLanes][threadIdx.x % kLanes] = 0;
  }
  __syncthreads();
  uint32_t* dec_x = bits + (0 * kLanes + l) * words;
  uint32_t* res_x = bits + (1 * kLanes + l) * words;
  uint32_t* dec_z = bits + (2 * kLanes + l) * words;
  uint32_t* res_z = bits + (3 * kLanes + l) * words;

  decide<kMinSum>(gx, rule, n, batch, lane, valid, g, dec_x, res_x,
                  &flags[kConvX][l], &flags[kTestedX][l]);
  decide<kMinSum>(gz, rule, n, batch, lane, valid, g, dec_z, res_z,
                  &flags[kConvZ][l], &flags[kTestedZ][l]);
  __syncthreads();

  if (syndrome_fails(gx, dec_x, batch, lane, valid, g)) {
    atomicOr(&flags[kSynX][l], 1);
  }
  if (syndrome_fails(gz, dec_z, batch, lane, valid, g)) {
    atomicOr(&flags[kSynZ][l], 1);
  }
  __syncthreads();

  // the logical test only counts where neither syndrome failed
  const bool undetected = valid && !flags[kSynX][l] && !flags[kSynZ][l];
  if (undetected && (outside_rowspace(sx, res_x, words, g) ||
                     outside_rowspace(sz, res_z, words, g))) {
    atomicOr(&flags[kLogical][l], 1);
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const bool mine = threadIdx.x < kLanes && valid;
    const bool syn_x = flags[kSynX][l] != 0, syn_z = flags[kSynZ][l] != 0;
    const bool logical = flags[kLogical][l] != 0;
    const bool ok = !syn_x && !syn_z;
    // classify_batch's counter order: tested, x_tested, z_tested,
    // corrected, syndrome-fail X, Z, logical, convergence-fail X, Z
    const bool counted[9] = {true,
                             flags[kTestedX][l] != 0,
                             flags[kTestedZ][l] != 0,
                             ok && !logical,
                             syn_x,
                             syn_z,
                             ok && logical,
                             flags[kConvX][l] != 0,
                             flags[kConvZ][l] != 0};
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int count = __popc(__ballot_sync(0xffffffffu, mine && counted[c]));
      if (threadIdx.x == 0 && count) {
        atomicAdd(&counters[c], (unsigned long long)count);
      }
    }
    long long it_x = mine ? __ldg(gx.iters + lane) : 0;
    long long it_z = mine ? __ldg(gz.iters + lane) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      it_x += __shfl_down_sync(0xffffffffu, it_x, off);
      it_z += __shfl_down_sync(0xffffffffu, it_z, off);
    }
    if (threadIdx.x == 0) {
      if (it_x) atomicAdd(&iters[0], (unsigned long long)it_x);
      if (it_z) atomicAdd(&iters[1], (unsigned long long)it_z);
    }
  }
}

template <bool kMinSum>
cudaError_t launch(const Graph& gx, const Graph& gz, const Sector& sx,
                   const Sector& sz, const Rule& rule, int n, int batch,
                   unsigned long long* counters, unsigned long long* iters,
                   cudaStream_t stream) {
  const int words = (n + 31) / 32;
  const size_t smem = 4ull * kLanes * words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decide_classify_kernel<kMinSum>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + kLanes - 1) / kLanes;
  decide_classify_kernel<kMinSum><<<blocks, kThreads, smem, stream>>>(
      gx, gz, sx, sz, rule, n, words, batch, counters, iters);
  return cudaGetLastError();
}

bool graph_ok(const Graph& G, int n) {
  return G.dv >= 1 && G.dv <= kMaxVarDegree && G.dc >= 1 && G.p >= 1 &&
         G.checks >= 1 && G.checks % G.p == 0 && n >= 1;
}

}  // namespace

// Adds the chunk's nine counters into counters[9] and the X and Z
// lane-iteration sums into iters[2] (both int64 on the device), on
// `stream`.  Returns the cudaError_t of the launch.
extern "C" int qec_decide_classify(
    const float* v_x, const float* v_z, const long long* to_var_x,
    const long long* to_var_z, const long long* var_of_edge_x,
    const long long* var_of_edge_z, const int32_t* syndrome_x,
    const int32_t* syndrome_z, const int32_t* errors_x,
    const int32_t* errors_z, const int32_t* iters_x, const int32_t* iters_z,
    const uint32_t* basis_x, const int32_t* row_of_x, const uint32_t* basis_z,
    const int32_t* row_of_z, int dv_x, int checks_x, int dc_x, int p_x,
    int dv_z, int checks_z, int dc_z, int p_z, int n, int batch, int min_sum,
    float threshold, float low, float high, float band, long long* counters,
    long long* iters, void* stream) {
  const Graph gx{v_x,        to_var_x, var_of_edge_x, syndrome_x, errors_x,
                 iters_x,    dv_x,     checks_x,      dc_x,       p_x};
  const Graph gz{v_z,        to_var_z, var_of_edge_z, syndrome_z, errors_z,
                 iters_z,    dv_z,     checks_z,      dc_z,       p_z};
  if (!graph_ok(gx, n) || !graph_ok(gz, n) || batch < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return (int)cudaSuccess;
  const Sector sx{basis_x, row_of_x};
  const Sector sz{basis_z, row_of_z};
  const Rule rule{threshold, low, high, band};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counters);
  auto* it = reinterpret_cast<unsigned long long*>(iters);
  return (int)(min_sum ? launch<true>(gx, gz, sx, sz, rule, n, batch, c, it, st)
                       : launch<false>(gx, gz, sx, sz, rule, n, batch, c, it,
                                       st));
}
