// A float32 issue-rate probe: dependent chains of one operation per thread.
//
// The counterpart of the peak-reality experiment of
// benchmarks/roofline_breakdown.py (`chain_rate`, an XLA loop on the TPU):
// each element of x runs reps x depth applications of one operation,
//   op 0  y = fma(y, a, b)          (__fmaf_rn: one rounding, 2 FLOPs)
//   op 1  y = y * a                 (1 FLOP)
//   op 2  y = min(y * a, b)         (a multiply and a minimum)
// and its final value is written to out.  A chain of PyTorch elementwise
// calls would stream the tensor through device memory once per call and
// measure HBM, not the FP32 pipes: here the chain stays in registers.
//
// What bounds it on the H100: the FP32 pipes' issue rate (128 FP32 lanes
// per SM and clock; 67 TFLOP/s of fma at the 1.98 GHz boost clock on 132
// SMs).  A dependent chain waits ~4 cycles per operation, so each thread
// carries kChains independent elements (ILP) and the grid fills every SM;
// the loads and stores (8 bytes an element) are negligible beside
// reps x depth operations.  The build's --fmad=false keeps y * a and the
// minimum's multiply from contracting, so each op is exactly the operation
// named, bit for bit the plain PyTorch chain (kernels/peak_chain_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChains = 4;    // independent elements per thread
constexpr int kThreads = 256;

template <int Op>
__device__ __forceinline__ float apply(float y, float a, float b) {
  if (Op == 0) return __fmaf_rn(y, a, b);
  if (Op == 1) return __fmul_rn(y, a);
  return fminf(__fmul_rn(y, a), b);
}

template <int Op>
__global__ void __launch_bounds__(kThreads)
peak_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long n, int depth, int reps, float a, float b) {
  const long long base =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kChains;
  float y[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    y[c] = base + c < n ? x[base + c] : 0.0f;
  }
  for (int r = 0; r < reps; ++r) {
    for (int d = 0; d < depth; ++d) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) y[c] = apply<Op>(y[c], a, b);
    }
  }
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    if (base + c < n) out[base + c] = y[c];
  }
}

}  // namespace

// Launch on `stream`: out[i] = op^(reps * depth)(x[i]) for i < n, float32
// device pointers.  Returns the cudaError_t of the launch (0 on success).
extern "C" int qec_peak_chain(const float* x, float* out, long long n,
                              int depth, int reps, float a, float b, int op,
                              void* stream) {
  if (n < 1 || depth < 0 || reps < 0 || op < 0 || op > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_block = (long long)kThreads * kChains;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  if (op == 0) {
    peak_chain_kernel<0><<<grid, kThreads, 0, st>>>(x, out, n, depth, reps, a, b);
  } else if (op == 1) {
    peak_chain_kernel<1><<<grid, kThreads, 0, st>>>(x, out, n, depth, reps, a, b);
  } else {
    peak_chain_kernel<2><<<grid, kThreads, 0, st>>>(x, out, n, depth, reps, a, b);
  }
  return (int)cudaGetLastError();
}
