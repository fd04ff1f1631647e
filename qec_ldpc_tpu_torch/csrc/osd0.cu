// Batched OSD-0 over GF(2): for each lane, a swap-free Gauss-Jordan walk over
// the reliability-ordered columns of H, with the syndrome carried as an extra
// bit plane, and the read-off of the solution -- in ONE launch.
//
// Replaces the TPU kernel qec_ldpc_tpu/kernels/osd0_pallas.py::
// osd0_eliminate_pallas and fuses the steps the JAX package runs around it
// (qec_ldpc_tpu/decoder/osd_device.py::_solver: the column gather, the bit
// packing and the read-off), since indexed loads are cheap on this card.
// Per lane b, with order o = order[b] (most-likely-in-error first):
//   build    row r, word k, bit j  =  H[r, o[32k + j]]   (w = ceil(n/32)
//            words per row), plus plane w holding the syndrome bit s[r]
//   walk     for c = 0, 1, ...: the pivot is the LOWEST-index unused row with
//            bit c set (jnp.argmax's first maximum in the TPU kernel); it is
//            marked used with pivcol = c, and XORed into every other row
//            with bit c set, syndrome plane included
//   read-off solved = no unused row keeps a syndrome bit; then
//            e[o[pivcol[r]]] = s[r] for every used row r (0 elsewhere)
// The walk stops once `rank` pivots are found.  That exit is exact: row
// operations keep the row space, which the `rank` pivot rows then span, and
// an unused row has 0 in every pivot column, so it is the zero combination
// of them -- every later column has no candidate and changes nothing.
// Everything is integer and bit arithmetic: the result equals the plain
// version bit for bit.
//
// Layout: one block per lane, one thread per parity row (blockDim = m rounded
// up to whole warps, at most 1024), the lane's system resident in shared
// memory plane-major, sys[k * m + r] (W * m * 4 bytes, W = w + 1: 25.6 KB for
// the [[610,61]] Z graph), so a thread's own words and the broadcast pivot
// row are conflict-free.  Building: warp q packs words k = q, q + warps, ...;
// lane j holds column o[32k + j] (H's columns come packed over rows, hcols
// (n, ceil(m/32)) uint32) and one ballot per row forms that row's word.  A
// column step is a ballot per warp, __ffs and an atomicMin on a shared slot
// (three slots rotate, so one barrier per column suffices), then the XOR of
// words k .. w only: an unused row is 0 in every column before c, so the
// pivot row's earlier words are 0.
//
// What bounds it on the H100: the serial walk.  Each column costs a block
// barrier and a few dependent shared-memory steps, ~rank to n columns per
// lane; lanes run in parallel as blocks (several per SM: 25.6 KB and 320
// threads each for [[610,61]] Z).  The design keeps the whole system on chip
// for the walk, so device memory is read once (H's columns from L2, the order
// and the syndrome) and written once (the outputs).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 1024;                 // one thread per row
constexpr int kMaxSharedBytes = 232448;        // 227 KB per block (H100)

__global__ void __launch_bounds__(kMaxRows)
osd0_kernel(const uint32_t* __restrict__ hcols, const int32_t* __restrict__ syndrome,
            const int32_t* __restrict__ order, uint8_t* __restrict__ e,
            uint8_t* __restrict__ solved, uint8_t* __restrict__ s_final,
            uint8_t* __restrict__ used_out, int32_t* __restrict__ pivcol_out,
            const int m, const int n, const int rank, const int lanes) {
  extern __shared__ uint32_t sys[];  // (W, m) plane-major
  __shared__ int pivot[3];

  const int lane = blockIdx.x;
  const int r = threadIdx.x;
  const bool mine = r < m;
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int w = (n + 31) >> 5;  // column words; plane w is the syndrome
  const int mw = (m + 31) >> 5;
  const int32_t* o = order + (size_t)lane * n;

  // ---- build the ordered system ----
  for (int k = warp; k < w; k += warps) {
    const int i = 32 * k + wl;
    const uint32_t* col = i < n ? hcols + (size_t)o[i] * mw : nullptr;
    for (int rw = 0; rw < mw; ++rw) {
      const uint32_t cw = col != nullptr ? col[rw] : 0u;
      for (int t = 0; t < 32; ++t) {
        const unsigned word = __ballot_sync(0xffffffffu, (cw >> t) & 1u);
        const int row = 32 * rw + t;
        if (wl == t && row < m) sys[k * m + row] = word;
      }
    }
  }
  if (mine) sys[w * m + r] = (uint32_t)syndrome[(size_t)r * lanes + lane];
  if (threadIdx.x < 3) pivot[threadIdx.x] = INT_MAX;
  __syncthreads();

  // ---- the walk ----
  bool used = false;
  int pivcol = n + 1;
  int found = 0;
  for (int c = 0; c < n && found < rank; ++c) {
    const int k = c >> 5;
    const bool bit = mine && ((sys[k * m + r] >> (c & 31)) & 1u);
    const unsigned cand = __ballot_sync(0xffffffffu, bit && !used);
    if (wl == 0 && cand != 0u) atomicMin(&pivot[c % 3], 32 * warp + __ffs(cand) - 1);
    __syncthreads();
    const int p = pivot[c % 3];
    // slot (c + 2) % 3 was last read in column c - 1, before this barrier,
    // and is next written in column c + 2, after the next one (the slot of
    // column c + 1 may already be taking a fast warp's atomicMin)
    if (threadIdx.x == 0) pivot[(c + 2) % 3] = INT_MAX;
    if (p == INT_MAX) continue;  // no candidate row: the same for every thread
    if (r == p) {
      used = true;
      pivcol = c;
    } else if (bit) {
      for (int j = k; j <= w; ++j) sys[j * m + r] ^= sys[j * m + p];
    }
    ++found;
  }

  // ---- read-off ----
  const bool s = mine && (sys[w * m + r] & 1u);
  const bool unsolved = __syncthreads_or(mine && !used && s) != 0;
  if (mine) {
    const size_t at = (size_t)lane * m + r;
    s_final[at] = s;
    used_out[at] = used;
    pivcol_out[at] = pivcol;
  }
  for (int v = threadIdx.x; v < n; v += blockDim.x) e[(size_t)v * lanes + lane] = 0;
  __syncthreads();
  if (!unsolved && used && s) e[(size_t)o[pivcol] * lanes + lane] = 1;
  if (threadIdx.x == 0) solved[lane] = !unsolved;
}

}  // namespace

// Launch on `stream`, one block per lane.  Device pointers: hcols (n,
// ceil(m/32)) uint32, H's columns packed over its rows (bit r of word r/32);
// syndrome (m, lanes) int32 in {0, 1}; order (lanes, n) int32, each row a
// permutation of 0..n-1; out: e (n, lanes) uint8 corrections, solved (lanes,)
// uint8, s_final / used (lanes, m) uint8, pivcol (lanes, m) int32 (n + 1
// where unused).  `rank` is the GF(2) rank of H.  Returns the cudaError_t of
// the launch (0 on success); does not synchronise.
extern "C" int qec_osd0(const uint32_t* hcols, const int32_t* syndrome,
                        const int32_t* order, uint8_t* e, uint8_t* solved,
                        uint8_t* s_final, uint8_t* used, int32_t* pivcol, int m,
                        int n, int rank, int lanes, void* stream) {
  if (m < 1 || m > kMaxRows || n < 1 || rank < 0 || rank > m || lanes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t shared = (size_t)((n + 31) / 32 + 1) * m * sizeof(uint32_t);
  if (shared > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      osd0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (attr != cudaSuccess) return (int)attr;
  const int threads = (m + 31) / 32 * 32;
  osd0_kernel<<<lanes, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      hcols, syndrome, order, e, solved, s_final, used, pivcol, m, n, rank,
      lanes);
  return (int)cudaGetLastError();
}
