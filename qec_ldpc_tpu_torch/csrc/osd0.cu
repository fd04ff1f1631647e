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
// What bounds it on the H100.  The osd cell hands a launch the failed lanes
// of one sector (~600 of [[610,61]] X, ~80 of Z), one CTA each, all
// resident at once, so a launch lasts about one lane's elimination: rank
// 301 pivots over most of the Z graph's 610 columns, each XORed into every
// row that holds its bit.  The first design spent a block barrier, an
// atomicMin and a read-modify-write of words k..w in shared memory per
// column, by one thread per row.  This design:
//
//   * Panels.  Within panel k (columns 32k .. 32k+31) the pivot choice reads
//     only word k of each row: an unused row is 0 in every column before c
//     (each is a pivot column or had no candidate), so the pivot row's words
//     before k are 0, and so are its bits before c.  The walk of a panel runs
//     on word k alone, and each row tracks a 32-bit mask M_r of the panel's
//     pivots it has taken: when row r takes pivot j (row p_j),
//     M_r ^= M_{p_j} ^ (1 << j), so in GF(2) row r is old_r xor the
//     old pivot rows of M_r, "old" meaning as at the start of the panel.
//     The trailing words k+1 .. w (the syndrome plane included) then take
//     ONE update per panel, new_r = old_r ^ xor_{j in M_r} old_{p_j}.
//   * A walk with no block barrier.  One warp holds word k of every row in
//     registers, lane l the rows l*kR .. l*kR + kR - 1 (kR = ceil(m/32),
//     rounded up to even, a template parameter), with their masks.  A column
//     is each lane's first unused candidate row, one ballot (the lowest lane
//     with one holds the lowest-index candidate row), three shuffles that
//     broadcast its word, mask and index, and an XOR per row that holds the
//     bit; the next column's bits are read before that XOR and corrected
//     after it, and the pivot rows and columns are stored once per panel,
//     by the lane of each column.  A panel costs three barriers (after the walk, after
//     the table, after the update) instead of 32; rank reached in mid-panel
//     stops the walk where it stops today, and that panel's update still
//     runs.
//   * The update by table (four Russians): per trailing word, the xor of
//     every subset of each group of 4 panel pivots (8 groups of 16 words,
//     built from the pivot rows before any row is written), so a row's word
//     takes one lookup per group that holds a pivot, whatever its mask's
//     weight, and the threads of a warp do not diverge on it.
//   * Build.  Warp q packs words k = q, q + warps, ...; lane j holds column
//     o[32k + j] (H's columns come packed over rows, hcols (n, ceil(m/32))
//     uint32), 32 rows at a time, and a 32 x 32 bit transpose in five
//     shuffle rounds gives each lane its row's word.
// The lane's system stays in shared memory plane-major, sys[k * m + r]
// (W * m * 4 bytes, W = w + 1), beside each row's mask and pivot column and
// the table: kernels/osd0_cuda.py::plan sizes the CTA from m, n and the
// device's opt-in limit.  Device memory is read once (H's columns from L2,
// the order and the syndrome) and written once (the outputs).
//
// Measured on an H100 (80GB HBM3, 700 W; chip_smoke.py phase 15 and
// profile_cells.py, PERF.md section 6): 1,024 failed [[610,61]] Z lanes
// take 0.438-0.449 ms against 0.96-1.00 ms for the first design in the same
// calls (bound 0.038 ms), X 0.359 (0.71 for the first design); the build
// and read-off alone (rank 0) 0.031-0.036 ms; a launch in the osd cell
// 0.190 ms against 0.388.  ptxas: 47 registers at kR = 10, no spill.  What
// is left is the walk, bound by the instructions one warp issues per pivot
// column: it was no faster with fewer rows a lane (a walk over the unused
// rows alone, the other rows' masks replayed after it), with the columns
// that have no candidate skipped, or with the update run beside it on the
// other warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 1024;    // m: the walk warp holds kR <= 32 rows a lane
constexpr int kMaxThreads = 256;

// Lane l holds row l of a 32 x 32 bit matrix (bit j: column j); returns
// column `wl` (bit l: row l's bit wl), in five rounds of block swaps.
__device__ __forceinline__ uint32_t swap_blocks(uint32_t x, int s, uint32_t lo,
                                                int wl) {
  const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
  return (wl & s) ? (x & ~lo) | ((y & ~lo) >> s) : (x & lo) | ((y & lo) << s);
}

__device__ __forceinline__ uint32_t transpose32(uint32_t x, int wl) {
  x = swap_blocks(x, 16, 0x0000ffffu, wl);
  x = swap_blocks(x, 8, 0x00ff00ffu, wl);
  x = swap_blocks(x, 4, 0x0f0f0f0fu, wl);
  x = swap_blocks(x, 2, 0x33333333u, wl);
  return swap_blocks(x, 1, 0x55555555u, wl);
}

template <int kR>
__global__ void __launch_bounds__(kMaxThreads)
osd0_kernel(const uint32_t* __restrict__ hcols,
            const int32_t* __restrict__ syndrome,
            const int32_t* __restrict__ order, uint8_t* __restrict__ e,
            uint8_t* __restrict__ solved, uint8_t* __restrict__ s_final,
            uint8_t* __restrict__ used_out, int32_t* __restrict__ pivcol_out,
            const int m, const int n, const int rank, const int lanes) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int piv_row[32];       // panel column j's pivot row
  __shared__ unsigned pivots_s[2];  // bit j: column 32k + j took a pivot
  __shared__ int found_s[2];        // pivots so far (both by panel parity)

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int warps = T >> 5;
  const int w = (n + 31) >> 5;  // column words; plane w is the syndrome
  const int mw = (m + 31) >> 5;
  uint32_t* sys = smem;                                   // (w + 1, m)
  uint32_t* MASK = sys + (size_t)(w + 1) * m;             // (m,)
  int32_t* PIVCOL = reinterpret_cast<int32_t*>(MASK + m); // (m,), n + 1 unused
  uint32_t* TAB = reinterpret_cast<uint32_t*>(PIVCOL + m);  // (w, 8, 16)
  const int32_t* o = order + (size_t)lane * n;

  // ---- build the ordered system ----
  for (int k = warp; k < w; k += warps) {
    const int i = 32 * k + wl;
    const uint32_t* col = i < n ? hcols + (size_t)o[i] * mw : nullptr;
    uint32_t cw = col != nullptr ? col[0] : 0u;
    for (int rw = 0; rw < mw; ++rw) {
      const uint32_t next = (col != nullptr && rw + 1 < mw) ? col[rw + 1] : 0u;
      const uint32_t word = transpose32(cw, wl);
      const int row = 32 * rw + wl;
      if (row < m) sys[k * m + row] = word;
      cw = next;
    }
  }
  for (int r = tid; r < m; r += T) {
    sys[w * m + r] = (uint32_t)syndrome[(size_t)r * lanes + lane];
    PIVCOL[r] = n + 1;
  }
  __syncthreads();

  // ---- the walk, one panel of 32 columns at a time ----
  unsigned used = 0;  // walk warp: bit i, row wl*kR + i is a pivot row
  int found = 0;
  for (int k = 0; k < w && found < rank; ++k) {
    const int slot = k & 1;
    if (warp == 0) {
      uint32_t word[kR], mask[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = wl * kR + i;
        word[i] = r < m ? sys[k * m + r] : 0u;
        mask[i] = 0u;
      }
      unsigned pivots = 0;
      int mine = 0;
      const int cols = min(32, n - 32 * k);
      // bit i of has: row wl*kR + i has the column's bit; the next
      // column's is read from the words before this column's update and
      // corrected after it, off the ballot-shuffle chain
      unsigned has = 0u;
#pragma unroll
      for (int i = 0; i < kR; ++i) has |= (word[i] & 1u) << i;
      for (int j = 0; j < cols && found < rank; ++j) {
        const int jn = (j + 1) & 31;
        unsigned next = 0u;
#pragma unroll
        for (int i = 0; i < kR; ++i) next |= ((word[i] >> jn) & 1u) << i;
        const unsigned cand = has & ~used;
        const unsigned any = __ballot_sync(0xffffffffu, cand != 0u);
        if (any == 0u) {  // no candidate row: the same for every lane
          has = next;
          continue;
        }
        const int src = __ffs(any) - 1;  // the lowest lane: the lowest row
        const int first = __ffs(cand) - 1;
        uint32_t fw = 0u, fm = 0u;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          fw |= i == first ? word[i] : 0u;
          fm |= i == first ? mask[i] : 0u;
        }
        const int ip = __shfl_sync(0xffffffffu, first, src);
        const uint32_t wp = __shfl_sync(0xffffffffu, fw, src);
        const uint32_t mp = __shfl_sync(0xffffffffu, fm, src) ^ (1u << j);
        const bool owner = wl == src;
        const unsigned take = owner ? has & ~(1u << ip) : has;
        has = next ^ (((wp >> jn) & 1u) ? take : 0u);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          if ((take >> i) & 1u) {
            word[i] ^= wp;
            mask[i] ^= mp;
          }
        }
        used |= owner ? 1u << ip : 0u;
        mine = wl == j ? src * kR + ip : mine;  // lane j keeps column j's pivot
        pivots |= 1u << j;
        ++found;
      }
      if ((pivots >> wl) & 1u) {
        PIVCOL[mine] = 32 * k + wl;
        piv_row[wl] = mine;
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = wl * kR + i;
        if (r < m) MASK[r] = mask[i];
      }
      if (wl == 0) {
        pivots_s[slot] = pivots;
        found_s[slot] = found;
      }
    }
    __syncthreads();
    // the slots alternate: the walk of panel k + 1 may write while a slow
    // thread still reads panel k's (no barrier follows a panel with no pivot)
    const unsigned pivots = pivots_s[slot];
    found = found_s[slot];
    if (pivots == 0u) continue;
    const int tw = w - k;  // trailing words k+1 .. w
    // the xor of every subset of each group of 4 panel pivots, per trailing
    // word, from the pivot rows as they stood at the panel's start: entry
    // (t, g, x) = xor over bits b of x of row piv_row[4g + b]'s word k+1+t.
    // A row's mask holds only pivot bits, so only subsets of a group's
    // pivots are ever read
    for (int x = tid; x < 128 * tw; x += T) {
      const int t = x >> 7, g = (x >> 4) & 7, sub = x & 15;
      if ((sub & ~(pivots >> (4 * g)) & 15u) != 0u) continue;
      const uint32_t* word_t = sys + (k + 1 + t) * m;
      uint32_t acc = 0u;
      for (int b = 0; b < 4; ++b) {
        if ((sub >> b) & 1) acc ^= word_t[piv_row[4 * g + b]];
      }
      TAB[x] = acc;
    }
    __syncthreads();
    // row r, trailing word t: one lookup per group that holds a pivot; the
    // (row, word) pairs are spread over the threads, rows fastest
    {
      int t = tid / m, r = tid - t * m;
      const int Tt = T / m, Tr = T - Tt * m;
      for (; t < tw; t += Tt) {
        const uint32_t mask = MASK[r];
        if (mask != 0u) {
          uint32_t* at = sys + (k + 1 + t) * m + r;
          const uint32_t* tab = TAB + 128 * t;
          uint32_t acc = *at;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            if ((pivots >> (4 * g)) & 15u) {
              acc ^= tab[16 * g + ((mask >> (4 * g)) & 15u)];
            }
          }
          *at = acc;
        }
        r += Tr;
        if (r >= m) {
          r -= m;
          ++t;
        }
      }
    }
    __syncthreads();
  }

  // ---- read-off ----
  bool unsolved_row = false;
  for (int r = tid; r < m; r += T) {
    const bool s = sys[w * m + r] & 1u;
    const int pc = PIVCOL[r];
    const bool u = pc != n + 1;
    unsolved_row |= !u && s;
    const size_t at = (size_t)lane * m + r;
    s_final[at] = s;
    used_out[at] = u;
    pivcol_out[at] = pc;
  }
  const bool unsolved = __syncthreads_or(unsolved_row) != 0;
  for (int v = tid; v < n; v += T) e[(size_t)v * lanes + lane] = 0;
  __syncthreads();
  if (!unsolved) {
    for (int r = tid; r < m; r += T) {
      const int pc = PIVCOL[r];
      if (pc != n + 1 && (sys[w * m + r] & 1u)) {
        e[(size_t)o[pc] * lanes + lane] = 1;
      }
    }
  }
  if (tid == 0) solved[lane] = !unsolved;
}

template <int kR>
cudaError_t launch(int threads, size_t smem_bytes, cudaStream_t stream,
                   const uint32_t* hcols, const int32_t* syndrome,
                   const int32_t* order, uint8_t* e, uint8_t* solved,
                   uint8_t* s_final, uint8_t* used, int32_t* pivcol, int m,
                   int n, int rank, int lanes) {
  // above 48 KB a CTA needs the opt-in, which belongs to the current
  // device: set on every launch; a size above the device's limit fails here
  const cudaError_t attr = cudaFuncSetAttribute(
      osd0_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (attr != cudaSuccess) return attr;
  osd0_kernel<kR><<<lanes, threads, smem_bytes, stream>>>(
      hcols, syndrome, order, e, solved, s_final, used, pivcol, m, n, rank,
      lanes);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`, one block per lane.  Device pointers: hcols (n,
// ceil(m/32)) uint32, H's columns packed over its rows (bit r of word r/32);
// syndrome (m, lanes) int32 in {0, 1}; order (lanes, n) int32, each row a
// permutation of 0..n-1; out: e (n, lanes) uint8 corrections, solved (lanes,)
// uint8, s_final / used (lanes, m) uint8, pivcol (lanes, m) int32 (n + 1
// where unused).  `rank` is the GF(2) rank of H.  `threads`, `rows_per_lane`
// (kR) and `smem_bytes` are the wrapper's plan (kernels/osd0_cuda.py::plan).
// Returns the cudaError_t of the launch (0 on success,
// cudaErrorInvalidValue for arguments or a plan the kernel does not take);
// does not synchronise.
extern "C" int qec_osd0(const uint32_t* hcols, const int32_t* syndrome,
                        const int32_t* order, uint8_t* e, uint8_t* solved,
                        uint8_t* s_final, uint8_t* used, int32_t* pivcol, int m,
                        int n, int rank, int lanes, int threads,
                        int rows_per_lane, long long smem_bytes,
                        void* stream) {
  const long long w = (n + 31) / 32;
  const long long need = 4 * ((w + 1) * m + 2LL * m + 128 * w);
  if (m < 1 || m > kMaxRows || n < 1 || rank < 0 || rank > m || lanes < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      32 * rows_per_lane < m || smem_bytes < need) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QEC_OSD0_KR(KR)                                                      \
  case KR:                                                                   \
    err = launch<KR>(threads, (size_t)smem_bytes, st, hcols, syndrome, order, \
                     e, solved, s_final, used, pivcol, m, n, rank, lanes);   \
    break;
  switch (rows_per_lane) {
    QEC_OSD0_KR(2)
    QEC_OSD0_KR(4)
    QEC_OSD0_KR(6)
    QEC_OSD0_KR(8)
    QEC_OSD0_KR(10)
    QEC_OSD0_KR(12)
    QEC_OSD0_KR(14)
    QEC_OSD0_KR(16)
    QEC_OSD0_KR(18)
    QEC_OSD0_KR(20)
    QEC_OSD0_KR(22)
    QEC_OSD0_KR(24)
    QEC_OSD0_KR(26)
    QEC_OSD0_KR(28)
    QEC_OSD0_KR(30)
    QEC_OSD0_KR(32)
  }
#undef QEC_OSD0_KR
  return (int)err;
}
