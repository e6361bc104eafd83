// Complete-pivot rank-revealing LU of zero-padded panels.
//
// Replaces the Pallas TPU kernel tci_tpu/ops/pallas_lu.py::_rrlu_kernel
// (entry points pallas_rrlu_call and pallas_rrlu_batched) and the XLA
// while-loop bodies tci_tpu/ops/lu_kernel.py::_rrlu_state_fused /
// _rrlu_state_small behind lu_kernel._rrlu_while. The contract is the same:
//
//   - swap-free elimination: rowpos/colpos (original index -> position) and
//     rowperm/colperm (position -> original index) carry the virtual swaps;
//   - pivot column = largest cached per-column max |a|^2 over unpivoted
//     rows, ties to the smallest swapped position; pivot row = largest |a|^2
//     in that column, ties to the smallest swapped position. This is the
//     reference's column-major first maximum in the swapped layout
//     (matrixlu.jl:70-86). Every reduction is a (value, position) argmax, so
//     the winner never depends on thread timing or on how a panel is cut;
//   - stop rule of matrixlu.jl:363 once k > 0 (|pivot| < reltol * largest
//     pivot so far, or < abstol), plus an exactly-zero pivot and "no valid
//     line left"; err is the magnitude of the first rejected pivot (0 when
//     no valid column is left, NaN when maxrank is 0);
//   - one fused pass per pivot does the rank-1 Schur update, stores the
//     multipliers (pivot column when left-orthogonal, pivot row otherwise)
//     and recomputes every column's masked maximum;
//   - the swapped-layout buffer A_sw[i, j] = A[rowperm[i], colperm[j]] is
//     written out of place at the end.
//
// Arithmetic is written with explicit round-to-nearest intrinsics (no FMA
// contraction), so the kernel rounds exactly like the plain PyTorch version
// in tci_tpu_torch/ops/lu_kernel.py (a multiply kernel, then a subtract
// kernel). Pivot order, k, err and the LU buffer agree bitwise with it.
//
// Element types: float32, float64 and complex128 (the body is one template;
// Ops<T> holds each type's arithmetic). For complex128 the pivot metric,
// the magnitudes, err and the tolerances are real float64 (|z|^2 =
// re re + im im, as tci_tpu's _abs2), and the product and the quotient are
// written out on the real and imaginary parts in the formulas the plain
// version uses, so the two agree bitwise there too. A complex element is
// 16 bytes, twice a float64's: the resident mode, bounded in bytes, ends at
// 128 KB panels (80 x 80 or 128 x 64 complex), and every pass moves twice
// the bytes and does four multiplies where a real update does one.
//
// NaN: a NaN metric ranks above every value, equal NaNs by position (the
// rule of jnp.argmax, which tci_tpu's _rrlu_state_small follows), and the
// column maxima propagate NaN as torch's amax does. So the first NaN in the
// swapped column-major order becomes the pivot, err and the magnitudes turn
// NaN, the next update spreads it over the trailing block, and rrlu's check
// raises. The pivot is always a valid row and column, so no swap moves a
// line outside the true extents, and lines outside them are never written.
//
// Three modes, chosen per panel; a call is one launch, or up to three (below):
//
//   - resident (panels up to 128 x 128 f64, kResidentPanelBytes): one
//     1024-thread block per panel holds it in shared memory, so device memory
//     sees one read and one write of the panel in all (0.08 us of HBM time at
//     128^2 f64). What bounds it is latency on one SM: the load, and per
//     pivot a chain of dependent shared-memory steps and block barriers. The
//     design cuts each link of that chain:
//       * the panel, padding included, arrives by Hopper's bulk-copy engine
//         (cp.async.bulk into shared memory, completing on an mbarrier),
//         issued by one thread while the others set up the state vectors;
//       * 32 warps share the pass over <= 128 rows, so shared-memory and f64
//         latency is hidden by other warps, and each thread loads four rows
//         before it stores any;
//       * three block barriers per pivot. The pass leaves, in each thread,
//         its best pivot candidate (|a|^2, column position, row position),
//         so the pivot column and the pivot row come out of one reduction:
//         a warp shuffle at the end of the pass, then warp 0 reduces the 32
//         warp winners, tests the stop rule and publishes the pivot. The
//         virtual swaps, the new row and column keys and the vectors x and
//         y are built in one phase, each thread for its own rows and
//         columns;
//       * the swapped-layout write-out gives rows to warps and columns to
//         lanes (coalesced stores, no 64-bit division).
//     What is left is the chain itself (chip_smoke.py's [split] lines
//     measure the fixed and per-pivot costs);
//   - cluster (larger panels whose true rows fit the shared memory of one
//     thread-block cluster, fits_cluster): one cluster of C CTAs per panel
//     (C = 16 where the card can schedule it, else 8; non-portable sizes),
//     batched panels side by side. The true rows are split over the C CTAs
//     and held, full width, in each CTA's shared memory for the whole
//     elimination (one cp.async.bulk on an mbarrier per CTA); each CTA keeps
//     its own copy of the permutations and keys. Per pivot: every CTA's pass
//     updates its rows and leaves per warp its best candidate and the entry
//     itself in a slot; one cluster barrier (barrier.cluster arrive.release /
//     wait.acquire); then every CTA reads all slots through distributed
//     shared memory, takes the same decision and the same stop test, swaps
//     its own copy, builds x from its own rows and y from the pivot row,
//     which it reads from the owner's shared memory. The right-orthogonal
//     multipliers of row pr are stored by the owner one pivot later, after
//     the next cluster barrier, so no CTA can still be reading the row
//     (a deferred write, not a second barrier). Slots alternate between two
//     sets, so a CTA that runs ahead never overwrites what another still
//     reads. Device memory sees one read of the true rows, one write of the
//     output and one read of the padding rows; no global atomics, no polling.
//     What bounds it is the per-pivot chain: the pass over a few rows, one
//     cluster barrier, the distributed-shared-memory reads;
//   - grid (everything else): a cooperative launch of one 512-thread block
//     an SM (132 on an H100); batched panels take the whole grid in turn.
//     This is the cluster mode's design carried to the whole grid through
//     global memory. Each block owns whole rows of the true extents, full
//     width, for the whole elimination, and keeps its own copy of the
//     permutations and keys. Per pivot: the pass updates the block's rows
//     with the last pivot and leaves one candidate (|a|^2, column position,
//     row position), which the block publishes with the entry and its
//     candidate's whole row in a slot of global memory (one slot set a
//     pivot, kSlotSets in turn); one grid barrier (a release add and
//     acquire loads on one counter); then every block reduces the G slots
//     itself, takes the same decision, stop test and swaps, builds x from
//     its own rows and y from the winner's slot row; the owner stores row
//     pr's multipliers at once (the others read the slot, never its rows).
//     No block decides alone, and no per-column maxima are stored. Two
//     regimes, each an instantiation of the kernel:
//       * grid-resident (fits_grid: the true rows, split over the G blocks,
//         fit each block's shared memory with y and the state; up to ~29 MB
//         of panel on an H100): each block loads its rows once by the
//         bulk-copy engine (plain loads where the rows are not 16-byte
//         aligned) and eliminates in shared memory with resident_pass.
//         Device memory sees one read of the panel, the slots a pivot and
//         the write-out;
//       * streamed (larger panels): the rows live in a work buffer in the
//         scratch, and each pass streams the block's unpivoted rows, in
//         chunks of up to 1,920 columns (960 complex), through a ring of
//         shared-memory stages that one producer warp fills by
//         cp.async.bulk on mbarriers while 15 consumer warps update the
//         stages before them. The
//         write-back is deferred over 2 pivots, or kDefer where the panel
//         is larger than twice the L2 (defer_depth): a pass rebuilds each
//         entry from the buffer by the pending updates a - x_t y_t in
//         their order, the same rounded steps, and writes only every
//         depth-th pass; a pivot's column and row go to the buffer as they
//         stand when it is chosen, and the last pending updates when the
//         elimination stops.
//     The slots, the work buffer and (where a streamed panel's state does
//     not fit beside the ring) the blocks' state live in global scratch the
//     wrapper allocates, so no panel size is refused.
//
// The choice, in the order resident, cluster, grid-resident, streamed:
// resident by the padded shape, on the host. Otherwise, where the padded
// panel fits a cluster, only the cluster kernel is launched; where it may
// not (the true extents live on the device), the cluster kernel and then
// the grid kernel's instantiations that the padded shape allows are
// launched; each reads the clamped extents, applies fits_cluster and
// fits_grid, and each panel is eliminated by exactly one kernel (the others
// skip it before any barrier). Each panel's mode is written to an output
// word: 0 resident, 1 cluster, 2 grid-resident, 3 streamed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lu_common.cuh"

namespace {

constexpr int kResidentThreads = 1024;
constexpr int kResidentWarps = kResidentThreads / 32;
constexpr int kResidentUnroll = 4;       // rows a thread loads before it stores
constexpr unsigned kBulkChunk = 16384;   // bytes per bulk-copy request
// Dynamic shared memory a block may request on sm_90, less room for the
// kernel's static shared memory.
constexpr size_t kSmemLimit = 232448 - 2048;
// Largest panel the one-block mode takes: a 128 x 128 f64 panel (128 KB; a
// complex128 panel of the same bytes). Above it the grid mode of the time
// (then the only other mode) was faster even where the panel would fit (at
// a 160^2 f64 bucket and 80 pivots, 0.93 ms against 2.16 ms on an H100);
// such panels now take the cluster mode, and those past a cluster's shared
// memory the grid mode's grid-resident or streamed regime.
constexpr size_t kResidentPanelBytes = 128 * 128 * 8;

// One panel's true extents and rank cap, clamped to the (mp, np) panel on the
// device: they may come from device arrays that no host code has read (the
// whole-sweep engine computes them on the card), and a bad one must not index
// outside the panel. A rank cap above min(mp, np) changes nothing when cut: no
// elimination takes more pivots than it has valid lines.
__device__ __forceinline__ void clamp_extents(int mp, int np, int& m, int& n,
                                              int& maxrank) {
  m = min(max(m, 0), mp);
  n = min(max(n, 0), np);
  maxrank = min(max(maxrank, 0), min(mp, np));
}

// The work record (lu_cuda.work_record: one per device, alive as long as the
// process, so that graphs recorded with its address stay valid), 8 int64:
// [0] the flag, [1 + mode] panels by mode (0 resident, 1 cluster, 2
// grid-resident, 3 streamed), [5] pivots (the sum of k), [6] real operations
// c * sum_{j<k} (m-1-j)(n-1-j), c = 2 for a real update and 8 for a complex
// one, [7] bytes: the panel read once, the LU buffer, both permutations, k,
// mags and err written once. The arithmetic of chip_smoke.py's bound_parts,
// from the panel's clamped extents and rank. The thread that writes k_out[b]
// calls it; with the flag clear it costs that thread one load.
constexpr int kWorkFlag = 0, kWorkPanels = 1, kWorkPivots = 5, kWorkOps = 6,
              kWorkBytes = 7;

template <typename T>
__device__ void count_work(unsigned long long* work, int mode, int mp, int np,
                           int m, int n, int k) {
  if (work == nullptr || work[kWorkFlag] == 0) return;
  const long long a = m - 1, c = n - 1, kk = k;
  // sum_{j<k} (a - j)(c - j) in closed form
  const long long s = kk * a * c - (a + c) * (kk * (kk - 1) / 2) +
                      (kk - 1) * kk * (2 * kk - 1) / 6;
  const long long es = sizeof(T), real = es < 8 ? es : 8;
  const long long bytes = 2LL * mp * np * es + 8LL * (mp + np + 1) +
                          real * ((mp < np ? mp : np) + 1);
  atomicAdd(work + kWorkPanels + mode, 1ull);
  atomicAdd(work + kWorkPivots, (unsigned long long)kk);
  atomicAdd(work + kWorkOps, (unsigned long long)((es == 16 ? 8 : 2) * s));
  atomicAdd(work + kWorkBytes, (unsigned long long)bytes);
}

// How a pass spreads the true extents over a block's `nwarps` warps: columns
// in chunks of 32 (one per lane), R warps per chunk, each taking every R-th
// row. Computed once per panel (it holds integer divisions).
struct PassLayout {
  int nchunks, R, cstride, wchunk, wsub;
  __device__ PassLayout(int n, int warp, int nwarps) {
    nchunks = (n + 31) >> 5;
    R = nchunks > 0 ? nwarps / nchunks : nwarps;
    if (R < 1) R = 1;
    cstride = nwarps / R;
    wchunk = warp / R;
    wsub = warp % R;
  }
};

// Dynamic shared memory of the resident mode: the panel, then x (mp) and y
// (np); rowpos, rowperm, rkey (mp), colpos, colperm, ckey (np).
template <typename T>
size_t smem_bytes(int mp, int np) {
  return ((size_t)mp * np + mp + np) * sizeof(T) +
         (3 * (size_t)mp + 3 * (size_t)np) * sizeof(int);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One thread arms `bar` for `bytes` (a multiple of 16, both ends 16-byte
// aligned) and copies them from global to shared memory with the bulk-copy
// engine, in requests of kBulkChunk bytes that all complete on `bar`.
__device__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   b),
               "r"(bytes)
               : "memory");
  for (unsigned off = 0; off < bytes; off += kBulkChunk) {
    const unsigned len = bytes - off < kBulkChunk ? bytes - off : kBulkChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(len), "r"(b)
        : "memory");
  }
}

// bulk_copy on a barrier this thread initialises first. The block must pass
// a __syncthreads() (the barrier's initialisation) before anyone waits on it.
__device__ void bulk_load(void* dst, const void* src, unsigned bytes,
                          unsigned long long* bar) {
  mbar_init(bar, 1u);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bulk_copy(dst, src, bytes, bar);
}

// Waits until the barrier's phase `parity` has completed.
__device__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}

// Pivot candidates (|a|^2, column position, row position) in the order of
// the pivot rule: the largest value, then the smallest column position, then
// the smallest row position. The largest candidate over every (column, row
// group) partial is the pivot the two-stage rule picks: its column has the
// largest column maximum with the smallest position, and its row the
// largest |a|^2 in that column with the smallest position. The positions
// travel as one key, column above row, so one unsigned compare orders them:
// a resident panel has fewer than 2^16 - 1 rows and columns (is_resident),
// and kNoRow / kNoKey sort after every real position.
constexpr unsigned kNoRow = 0xFFFFu;
constexpr unsigned kNoKey = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned pos_key(int col, unsigned row) {
  return ((unsigned)col << 16) | row;
}

// One pass over the first m rows of A (row stride np) and its first n
// columns: the resident panel, or a cluster CTA's share of one. Columns go to
// lanes (a warp reads 32 neighbouring entries of a row); the R warps of a
// chunk split its rows. rkey/ckey hold the swapped position of an unpivoted
// row/column and -1 otherwise. With update set, the pass applies the rank-1
// Schur update on unpivoted rows x unpivoted columns and stores the
// multipliers (pivot column pc when left-orthogonal, pivot row pr otherwise;
// -1 for none). In every case each thread ends with its best pivot candidate
// over its columns and its row group's unpivoted rows ((-1, kNoKey) when it
// has none), and every lane of a warp returns the warp's best in bv / bkey.
// That is the whole reduction a barrier needs: no per-column partials are
// stored. U rows of a warp are loaded before any is stored.
template <typename T, int U = kResidentUnroll>
__device__ void resident_pass(T* A, int np, int m, int n,
                              const PassLayout& L, const int* rkey,
                              const int* ckey, const T* x, const T* y,
                              typename Ops<T>::R& bv, unsigned& bkey,
                              bool update, bool leftorth, int pr, int pc) {
  using R = typename Ops<T>::R;
  const int lane = threadIdx.x & 31;
  const int nw = L.R;  // warps a chunk
  const int wsub = L.wsub;
  // shared-memory offsets fit 32 bits; the U rows of a step are `rstep`
  // elements apart
  const int rstep = nw * np;
  bv = R(-1);
  bkey = kNoKey;
  for (int c = L.wchunk; c < L.nchunks; c += L.cstride) {
    const int j = c * 32 + lane;
    R cm = R(-1);
    int cp = kNoRow;
    const int cpos = j < n ? ckey[j] : -1;
    if (j < n) {
      const bool cf = cpos >= 0;
      const bool mcol = update && leftorth && j == pc;
      const bool mrow_col = update && !leftorth && cf;
      const T yj = update && cf ? y[j] : Ops<T>::zero();
      T* col = A + j;
      for (int i0 = wsub; i0 < m; i0 += U * nw) {
        T* p0 = col + i0 * np;
        // U rows loaded before any is stored: a store to A could alias a
        // later load, so the compiler would not hoist them itself
        int rk[U];
        T xi[U], a[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * nw;
          const bool in = i < m;
          rk[u] = in ? rkey[i] : -1;
          xi[u] = in && update ? x[i] : Ops<T>::zero();
          a[u] = in ? p0[u * rstep] : Ops<T>::zero();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * nw;
          if (rk[u] >= 0) {
            if (cf) {
              T v = a[u];
              if (update) {
                v = Ops<T>::sub(v, Ops<T>::mul(xi[u], yj));
                p0[u * rstep] = v;
              }
              const R sq = Ops<T>::abs2(v);
              if (ranks_above(sq, rk[u], cm, cp)) {
                cm = sq;
                cp = rk[u];
              }
            } else if (mcol) {
              p0[u * rstep] = xi[u];
            }
          } else if (mrow_col && i == pr) {
            p0[u * rstep] = yj;
          }
        }
      }
    }
    if (cpos >= 0) {
      const unsigned key = pos_key(cpos, (unsigned)cp);
      if (ranks_above(cm, key, bv, bkey)) {
        bv = cm;
        bkey = key;
      }
    }
  }
  warp_argmax<R>(bv, bkey);
}

template <typename T>
__global__ void __launch_bounds__(kResidentThreads)
    rrlu_kernel(const T* __restrict__ A_in, T* __restrict__ A_sw,
                int64_t* __restrict__ rowperm_out,
                int64_t* __restrict__ colperm_out,
                typename Ops<T>::R* __restrict__ mags_out,
                int64_t* __restrict__ k_out,
                typename Ops<T>::R* __restrict__ err_out,
                int64_t* __restrict__ mode_out, const int* m_arr,
                const int* n_arr, const int* maxrank_arr,
                const typename Ops<T>::R* tol_arr, int m_s, int n_s,
                int maxrank_s, typename Ops<T>::R reltol_s,
                typename Ops<T>::R abstol_s, int mp, int np, int leftorth_i,
                unsigned long long* work) {
  using R = typename Ops<T>::R;
  constexpr int NT = kResidentThreads;
  constexpr int kW = kResidentWarps;
  __shared__ unsigned long long load_bar;
  __shared__ R w_val[kW];  // per-warp winners: value, position key
  __shared__ unsigned w_key[kW];
  // the pivot warp 0 publishes: {stop, pc, pr, bestcolpos, bestrowpos,
  // r_at_k, c_at_k} and the pivot (1 where it is exactly 0)
  __shared__ int s_piv[7];
  __shared__ T s_safe;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int m = m_arr ? m_arr[b] : m_s;
  int n = n_arr ? n_arr[b] : n_s;
  int maxrank = maxrank_arr ? maxrank_arr[b] : maxrank_s;
  clamp_extents(mp, np, m, n, maxrank);
  const R reltol = tol_arr ? tol_arr[2 * b] : reltol_s;
  const R abstol = tol_arr ? tol_arr[2 * b + 1] : abstol_s;
  const bool leftorth = leftorth_i != 0;
  const int rmax = mp < np ? mp : np;
  const size_t panel = (size_t)mp * np;
  const PassLayout L(n, warp, kW);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* x = A + panel;
  T* y = x + mp;
  int* rowpos = reinterpret_cast<int*>(y + np);
  int* rowperm = rowpos + mp;
  int* rkey = rowperm + mp;
  int* colpos = rkey + mp;
  int* colperm = colpos + np;
  int* ckey = colperm + np;

  // The whole bucket, padding included (C-port-2 reads it), by the
  // bulk-copy engine; the state vectors are set up meanwhile.
  if (tid == 0)
    bulk_load(A, A_in + b * panel, (unsigned)(panel * sizeof(T)), &load_bar);
  for (int i = tid; i < mp; i += NT) {
    rowpos[i] = i;
    rowperm[i] = i;
    rkey[i] = i < m ? i : -1;
  }
  for (int j = tid; j < np; j += NT) {
    colpos[j] = j;
    colperm[j] = j;
    ckey[j] = j < n ? j : -1;
  }
  for (int r = tid; r < rmax; r += NT) mags_out[b * rmax + r] = R(0);
  __syncthreads();  // the barrier's initialisation and the vectors
  mbar_wait(&load_bar, 0);
  R bv;
  unsigned bkey;
  resident_pass<T>(A, np, m, n, L, rkey, ckey, x, y, bv, bkey, false,
                   leftorth, -1, -1);
  if (lane == 0) {
    w_val[warp] = bv;
    w_key[warp] = bkey;
  }

  int k = 0;
  R maxerror = R(0);
  R err = Ops<R>::nan();
  while (true) {
    __syncthreads();  // (1) the warps' candidates and the last swap
    if (k >= maxrank) break;  // uniform: k and maxrank are the same everywhere

    // Warp 0 reduces the 32 warp winners, picks the pivot, tests the stop
    // rule and publishes the result; the other warps wait at the barrier.
    // (One warp does it: 32 warps reducing at once contend for the shuffle
    // unit and take longer.)
    if (warp == 0) {
      R cv = w_val[lane];
      unsigned key = w_key[lane];
      warp_argmax<R>(cv, key);
      const int bestcolpos = (int)(key >> 16);
      const int bestrowpos = (int)(key & kNoRow);
      if (lane == 0) {
        int stop = 1;
        R e = R(0);  // no valid column (or row) left: stop with err 0
        int pc = 0, pr = 0;
        T safe = Ops<T>::one();
        if (!(cv < R(0))) {  // a candidate: a value or a NaN
          pc = colperm[bestcolpos];
          pr = rowperm[bestrowpos < mp - 1 ? bestrowpos : mp - 1];
          e = Ops<R>::sqrt(cv);
          stop = k > 0 && (e < Ops<R>::mul(reltol, maxerror) ||
                           e < abstol || e == R(0));
          const T piv = A[pr * np + pc];
          safe = Ops<T>::nonzero(piv) ? piv : Ops<T>::one();
          if (!stop) {
            maxerror = nan_max(maxerror, e);
            mags_out[b * rmax + k] = e;
            // a valid row and column sit at position k or later
            s_piv[5] = rowperm[k];
            s_piv[6] = colperm[k];
          }
        }
        err = e;
        s_piv[0] = stop;
        s_piv[1] = pc;
        s_piv[2] = pr;
        s_piv[3] = bestcolpos;
        s_piv[4] = bestrowpos;
        s_safe = safe;
      }
    }
    __syncthreads();  // (2) the pivot
    if (s_piv[0]) break;
    const int pc = s_piv[1], pr = s_piv[2];
    const int bestcolpos = s_piv[3], bestrowpos = s_piv[4];
    const int r_at_k = s_piv[5], c_at_k = s_piv[6];
    const T safe = s_safe;

    // The virtual swaps (pr to position k, the row there to bestrowpos;
    // likewise the columns), the keys of the next pass and x, y, each
    // thread for its own rows and columns. Nothing writes A, rowperm or
    // colperm in this phase.
    for (int i = tid; i < mp; i += NT) {
      const bool moved = i == pr || i == r_at_k;
      const int p = i == pr ? k : (i == r_at_k ? bestrowpos : rowpos[i]);
      if (moved) rowpos[i] = p;
      const bool rf = p > k && i < m;
      rkey[i] = rf ? p : -1;
      if (rf) {
        const T a = A[i * np + pc];
        x[i] = leftorth ? Ops<T>::div(a, safe) : a;
      }
    }
    // columns start half a block away from rows, on other warps
    for (int j = (tid + NT / 2) % NT; j < np; j += NT) {
      const bool moved = j == pc || j == c_at_k;
      const int p = j == pc ? k : (j == c_at_k ? bestcolpos : colpos[j]);
      if (moved) colpos[j] = p;
      const bool cf = p > k && j < n;
      ckey[j] = cf ? p : -1;
      if (cf) {
        const T a = A[pr * np + j];
        y[j] = leftorth ? a : Ops<T>::div(a, safe);
      }
    }
    __syncthreads();  // (3) keys, x and y; every thread has read the perms
    if (tid == 0) {
      rowperm[bestrowpos] = r_at_k;
      rowperm[k] = pr;
      colperm[bestcolpos] = c_at_k;
      colperm[k] = pc;
    }
    resident_pass<T>(A, np, m, n, L, rkey, ckey, x, y, bv, bkey, true,
                     leftorth, pr, pc);
    if (lane == 0) {
      w_val[warp] = bv;
      w_key[warp] = bkey;
    }
    ++k;
  }
  __syncthreads();

  if (tid == 0) {
    k_out[b] = k;
    err_out[b] = err;
    mode_out[b] = 0;
    count_work<T>(work, 0, mp, np, m, n, k);
  }
  for (int i = tid; i < mp; i += NT) rowperm_out[b * mp + i] = rowperm[i];
  for (int j = tid; j < np; j += NT) colperm_out[b * np + j] = colperm[j];
  // A_sw[i, j] = A[rowperm[i], colperm[j]]: rows to warps, columns to lanes
  T* out = A_sw + b * panel;
  for (int i = warp; i < mp; i += kW) {
    const T* src = A + (size_t)rowperm[i] * np;
    T* dst = out + (size_t)i * np;
    for (int j = lane; j < np; j += 32) dst[j] = src[colperm[j]];
  }
}

// ---------------------------------------------------------------------------
// Cluster mode: one thread-block cluster per panel, its true rows in the
// CTAs' shared memory (distributed shared memory across the cluster).

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
// Threads of a cluster CTA. 512 was the fastest of 256, 512 and 1024 on the
// main path's panels (PERF.md, the cluster mode's rows).
constexpr int kClusterThreads = 512;
// Dynamic shared memory a CTA of the cluster mode may take, less room for
// the kernel's static shared memory.
constexpr size_t kClusterSmem = 232448 - 2048;

// Dynamic shared memory of a cluster CTA that holds `rows` panel rows: the
// rows (np wide), y (np), x (rows); rowperm (mp); colperm, ckey (np); rkey,
// rpos (rows).
__host__ __device__ inline size_t cluster_smem(int rows, int mp, int np,
                                               int elsize) {
  return (size_t)rows * np * elsize + ((size_t)np + rows) * elsize +
         ((size_t)mp + 2 * (size_t)np + 2 * (size_t)rows) * sizeof(int);
}

// Rows of the panel each CTA of a C-CTA cluster holds (the last ones fewer).
__host__ __device__ inline int cluster_rows(int m, int C) {
  return (m + C - 1) / C;
}

// The one rule that sends a panel to the cluster mode: its m true rows,
// split over the C CTAs of a cluster, fit one CTA's shared memory. The
// kernels apply it to the clamped extents on the device, the host to the
// padded shape; C = 0 means no cluster kernel runs.
__host__ __device__ inline bool fits_cluster(int m, int mp, int np, int C,
                                             int elsize) {
  return C > 0 &&
         cluster_smem(cluster_rows(m, C), mp, np, elsize) <= kClusterSmem;
}

// A CTA's best candidate and the entry it names, as it publishes it to the
// cluster.
template <typename T>
struct Slot {
  typename Ops<T>::R val;
  unsigned key;
  T piv;
};

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Per-phase clocks of the cluster kernel, compiled in only with
// -DRRLU_PHASE_CLOCKS (chip_smoke.py --phases builds such a library):
// thread 0 of each CTA of panel 0 adds up the SM cycles (clock64) of each
// phase of its CTA's work, and stores them at the end. Without the macro
// PHASE_MARK is empty.
enum {
  kPhaseLoad,     // set-up and the bulk load of the CTA's rows
  kPhaseFirst,    // the first pass and its publish
  kPhaseBarrier,  // the cluster barrier of each pivot
  kPhaseDecide,   // reading the C slots, the decision, the swaps
  kPhaseXY,       // x, y and the deferred multipliers
  kPhasePass,     // the pass of each pivot
  kPhasePublish,  // the CTA's winner to its slot
  kPhaseFlush,    // the last multipliers and the final cluster barrier
  kPhaseWrite,    // the write-out
  kPhases
};
#ifdef RRLU_PHASE_CLOCKS
__device__ long long rrlu_phase_cycles[kMaxCluster * kPhases];
// the grid kernel's, for each of its first kMaxClockBlocks blocks over the
// last grid launch (every panel)
constexpr int kMaxClockBlocks = 256;
__device__ long long rrlu_grid_phase_cycles[kMaxClockBlocks * kPhases];
#define PHASE_MARK(i)                   \
  do {                                  \
    if (tid == 0) {                     \
      const long long now_ = clock64(); \
      ph[i] += now_ - ph_t;             \
      ph_t = now_;                      \
    }                                   \
  } while (0)
#else
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#endif

// Grid: B clusters of C CTAs (cluster dims (C, 1, 1)) of kClusterThreads
// threads. Cluster b eliminates panel b if fits_cluster holds
// for its clamped extents, and returns at once otherwise (before any cluster
// barrier, the same way in every CTA).
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
    rrlu_cluster_kernel(const T* __restrict__ A_in, T* __restrict__ A_sw,
                        int64_t* __restrict__ rowperm_out,
                        int64_t* __restrict__ colperm_out,
                        typename Ops<T>::R* __restrict__ mags_out,
                        int64_t* __restrict__ k_out,
                        typename Ops<T>::R* __restrict__ err_out,
                        int64_t* __restrict__ mode_out, const int* m_arr,
                        const int* n_arr, const int* maxrank_arr,
                        const typename Ops<T>::R* tol_arr, int m_s, int n_s,
                        int maxrank_s, typename Ops<T>::R reltol_s,
                        typename Ops<T>::R abstol_s, int mp, int np,
                        int leftorth_i, unsigned long long* work) {
  using R = typename Ops<T>::R;
  __shared__ unsigned long long load_bar;
  __shared__ R w_val[32];  // per-warp winners
  __shared__ unsigned w_key[32];
  __shared__ Slot<T> slots[2];  // this CTA's winner, two sets in turn
  __shared__ int s_piv[3];  // {stop, pc, pr}
  __shared__ T s_safe;

  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  constexpr int NT = kClusterThreads;
  constexpr int W = NT / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int m = m_arr ? m_arr[b] : m_s;
  int n = n_arr ? n_arr[b] : n_s;
  int maxrank = maxrank_arr ? maxrank_arr[b] : maxrank_s;
  clamp_extents(mp, np, m, n, maxrank);
  if (!fits_cluster(m, mp, np, C, (int)sizeof(T))) return;
#ifdef RRLU_PHASE_CLOCKS
  long long ph[kPhases] = {};
  long long ph_t = clock64();
#endif
  const R reltol = tol_arr ? tol_arr[2 * b] : reltol_s;
  const R abstol = tol_arr ? tol_arr[2 * b + 1] : abstol_s;
  const bool leftorth = leftorth_i != 0;
  const int rmax = mp < np ? mp : np;
  const size_t panel = (size_t)mp * np;
  const T* Ain = A_in + b * panel;
  // this CTA's rows [r0, r0 + nr) of the true extents
  const int rows = cluster_rows(m, C);
  const int r0 = min(rank * rows, m);
  const int nr = min(rows, m - r0);
  const PassLayout L(n, warp, W);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // (rows, np), local row li
  T* y = A + (size_t)rows * np;
  T* x = y + np;
  int* rowperm = reinterpret_cast<int*>(x + rows);
  int* colperm = rowperm + mp;
  int* ckey = colperm + np;
  int* rkey = ckey + np;
  int* rpos = rkey + rows;

  if (tid == 0 && nr > 0)
    bulk_load(A, Ain + (size_t)r0 * np, (unsigned)((size_t)nr * np * sizeof(T)),
              &load_bar);
  for (int i = tid; i < mp; i += NT) rowperm[i] = i;
  for (int j = tid; j < np; j += NT) {
    colperm[j] = j;
    ckey[j] = j < n ? j : -1;
  }
  for (int li = tid; li < nr; li += NT) {
    rkey[li] = r0 + li;
    rpos[li] = r0 + li;
  }
  if (rank == 0)
    for (int r = tid; r < rmax; r += NT) mags_out[b * rmax + r] = R(0);
  __syncthreads();  // the barrier's initialisation and the vectors
  if (nr > 0) mbar_wait(&load_bar, 0);
  PHASE_MARK(kPhaseLoad);

  // After a pass: warp 0 reduces the warp winners and publishes the CTA's
  // best candidate and the entry it names (the pivot itself, should it win)
  // in slot set `set`.
  auto publish = [&](int set, R bv, unsigned bkey) {
    if (lane == 0) {
      w_val[warp] = bv;
      w_key[warp] = bkey;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < W ? w_val[lane] : R(-1);
      bkey = lane < W ? w_key[lane] : kNoKey;
      warp_argmax<R>(bv, bkey);
      if (lane == 0) {
        T piv = Ops<T>::zero();
        if (!(bv < R(0)))
          piv = A[(size_t)(rowperm[bkey & kNoRow] - r0) * np +
                  colperm[bkey >> 16]];
        slots[set].val = bv;
        slots[set].key = bkey;
        slots[set].piv = piv;
      }
    }
  };
  R bv;
  unsigned bkey;
  resident_pass<T>(A, np, nr, n, L, rkey, ckey, x, y, bv, bkey, false,
                   leftorth, -1, -1);
  publish(0, bv, bkey);
  PHASE_MARK(kPhaseFirst);

  int k = 0;
  R maxerror = R(0);
  R err = Ops<R>::nan();
  int prev_lr = -1;  // local row whose multipliers are still to be stored
  while (true) {
    cluster_barrier();  // every CTA's slots; every read of the last pivot row
    PHASE_MARK(kPhaseBarrier);
    if (k >= maxrank) break;

    // Every CTA reduces the C slots itself (lane r reads CTA r's) and takes
    // the same decision.
    if (warp == 0) {
      R v = R(-1);
      unsigned key = kNoKey;
      T piv = Ops<T>::zero();
      if (lane < C) {
        const Slot<T>* p = cl.map_shared_rank(&slots[k & 1], lane);
        v = p->val;
        key = p->key;
        piv = p->piv;
      }
      const unsigned mine = key;
      warp_argmax<R>(v, key);
      const unsigned holder = __ballot_sync(0xffffffffu, mine == key);
      piv = shfl_from(piv, __ffs(holder) - 1);
      if (lane == 0) {
        int stop = 1;
        R e = R(0);  // no valid column (or row) left: stop with err 0
        int pc = 0, pr = 0;
        T safe = Ops<T>::one();
        if (!(v < R(0))) {  // a candidate: a value or a NaN
          const int bestcolpos = (int)(key >> 16);
          const int bestrowpos = (int)(key & kNoRow);
          pc = colperm[bestcolpos];
          pr = rowperm[bestrowpos];
          e = Ops<R>::sqrt(v);
          stop = k > 0 && (e < Ops<R>::mul(reltol, maxerror) ||
                           e < abstol || e == R(0));
          safe = Ops<T>::nonzero(piv) ? piv : Ops<T>::one();
          if (!stop) {
            maxerror = nan_max(maxerror, e);
            if (rank == 0) mags_out[b * rmax + k] = e;
            // the virtual swaps on this CTA's copy; only the two rows and
            // the two columns that move change their keys
            const int r_at_k = rowperm[k], c_at_k = colperm[k];
            rowperm[bestrowpos] = r_at_k;
            rowperm[k] = pr;
            colperm[bestcolpos] = c_at_k;
            colperm[k] = pc;
            if (r_at_k >= r0 && r_at_k < r0 + nr) {
              rkey[r_at_k - r0] = bestrowpos;
              rpos[r_at_k - r0] = bestrowpos;
            }
            if (pr >= r0 && pr < r0 + nr) {
              rkey[pr - r0] = -1;
              rpos[pr - r0] = k;
            }
            ckey[c_at_k] = bestcolpos;
            ckey[pc] = -1;
          }
        }
        err = e;
        s_piv[0] = stop;
        s_piv[1] = pc;
        s_piv[2] = pr;
        s_safe = safe;
      }
    }
    __syncthreads();  // the decision
    PHASE_MARK(kPhaseDecide);
    if (s_piv[0]) break;
    const int pc = s_piv[1], pr = s_piv[2];
    const T safe = s_safe;
    const int owner = pr / rows;
    const int lr = pr - owner * rows;
    // x from this CTA's rows; left-orthogonal multipliers go to column pc
    for (int li = tid; li < nr; li += NT) {
      if (rkey[li] < 0) continue;
      T* e = A + (size_t)li * np + pc;
      const T xv = leftorth ? Ops<T>::div(*e, safe) : *e;
      x[li] = xv;
      if (leftorth) *e = xv;
    }
    // y from the pivot row, in the owner's shared memory. First the
    // previous pivot row's multipliers (right-orthogonal): its columns were
    // the unpivoted ones now and pc.
    const T* prow = cl.map_shared_rank(A + (size_t)lr * np, owner);
    T* prev = prev_lr >= 0 ? A + (size_t)prev_lr * np : nullptr;
    for (int j = (tid + NT / 2) % NT; j < n; j += NT) {
      const bool cf = ckey[j] >= 0;
      if (prev && (cf || j == pc)) prev[j] = y[j];
      if (cf) y[j] = leftorth ? prow[j] : Ops<T>::div(prow[j], safe);
    }
    prev_lr = (!leftorth && owner == rank) ? lr : -1;
    __syncthreads();  // x, y, the multipliers
    PHASE_MARK(kPhaseXY);
    resident_pass<T>(A, np, nr, n, L, rkey, ckey, x, y, bv, bkey, true,
                     leftorth, -1, -1);
    PHASE_MARK(kPhasePass);
    ++k;
    publish(k & 1, bv, bkey);
    PHASE_MARK(kPhasePublish);
  }
  if (prev_lr >= 0) {
    T* prev = A + (size_t)prev_lr * np;
    for (int j = tid; j < n; j += NT)
      if (ckey[j] >= 0) prev[j] = y[j];
  }
  // no CTA leaves (or writes over its rows) while another may still read
  // its slots or its pivot row
  cluster_barrier();
  PHASE_MARK(kPhaseFlush);

  T* out = A_sw + b * panel;
  // A_sw[i, j] = A[rowperm[i], colperm[j]]: this CTA's rows ...
  for (int li = warp; li < nr; li += W) {
    const T* src = A + (size_t)li * np;
    T* dst = out + (size_t)rpos[li] * np;
    for (int j = lane; j < np; j += 32) dst[j] = src[colperm[j]];
  }
  // ... and the padding rows, which never move, straight from A_in
  for (int i = m + rank * W + warp; i < mp; i += C * W) {
    const T* src = Ain + (size_t)i * np;
    T* dst = out + (size_t)i * np;
    for (int j = lane; j < np; j += 32) dst[j] = src[colperm[j]];
  }
  if (rank == 0) {
    if (tid == 0) {
      k_out[b] = k;
      err_out[b] = err;
      mode_out[b] = 1;
      count_work<T>(work, 1, mp, np, m, n, k);
    }
    for (int i = tid; i < mp; i += NT) rowperm_out[b * mp + i] = rowperm[i];
    for (int j = tid; j < np; j += NT) colperm_out[b * np + j] = colperm[j];
  }
#ifdef RRLU_PHASE_CLOCKS
  PHASE_MARK(kPhaseWrite);
  if (tid == 0 && b == 0)
    for (int i = 0; i < kPhases; ++i)
      rrlu_phase_cycles[rank * kPhases + i] = ph[i];
#endif
}

// ---------------------------------------------------------------------------
// Grid mode: one cooperative launch of one block an SM; every block works on
// one panel at a time (batched panels take the grid in turn).

// Threads of a grid block. At 512 a thread may hold 128 registers (at 768
// ptxas allows 80, at 1024 64, and the kernel then spills); 512 was the
// fastest of 512, 768 and 1024 on every grid-resident panel (PERF.md's
// grid-mode findings). A streamed block has 480 consumer threads and one
// producer warp that feeds the ring; a grid-resident block's 16 warps all
// take the pass.
constexpr int kGridThreads = 512;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kGridConsumerWarps = kGridWarps - 1;
constexpr int kGridConsumers = kGridConsumerWarps * 32;
// Dynamic shared memory of a grid block, less room for the kernel's static
// shared memory: the largest a block may take, so one block runs an SM.
constexpr size_t kGridSmem = 232448 - 2048;
// Columns of a streamed chunk a consumer thread takes (held in registers,
// with their pending y), so a chunk is at most stream_q * kGridConsumers
// elements wide; a complex element takes twice the registers.
constexpr int kStreamQ = 4;
__host__ __device__ constexpr int stream_q(int elsize) {
  return elsize >= 16 ? kStreamQ / 2 : kStreamQ;
}
constexpr int kMaxStages = 8;
constexpr int kSlotReads = 5;  // candidate slots a lane of the decision reads
constexpr int kRowUnroll = 4;  // row entries a thread loads before it stores
// Pivots over which a streamed pass may defer its write-back: a pass
// rebuilds each entry from the work buffer and the x and y of the pivots
// since the last write, and writes every depth-th pass (defer_depth).
constexpr int kDefer = 4;
// Slot sets, taken in turn: one a pivot, and a pivot row stays readable
// while its y is pending (kDefer pivots) and a late block still reads it.
constexpr int kSlotSets = kDefer + 1;
constexpr unsigned long long kNoKey64 = ~0ull;

// The depth of a streamed panel's deferral, from its true extents and the
// card's L2 (measured on an H100, PERF.md's grid-mode findings): 2 up to
// twice the L2 (N = 2000, 2048^2, f32 config 2: a deeper rebuild costs
// more than the writes it saves), kDefer above, where every pass streams
// from device memory and its writes cost as much as its reads (config 2,
// 4200^2). A build with -DRRLU_GRID_DEFER=b defers every streamed panel b
// pivots instead, for measurement (1: a write every pass).
__device__ __forceinline__ int defer_depth(int m, int n, int elsize,
                                           long long l2_bytes) {
#ifdef RRLU_GRID_DEFER
  static_assert(RRLU_GRID_DEFER >= 1 && RRLU_GRID_DEFER <= kDefer,
                "RRLU_GRID_DEFER must lie in [1, kDefer]");
  return RRLU_GRID_DEFER;
#else
  return (long long)m * n * elsize <= 2 * l2_bytes ? 2 : kDefer;
#endif
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Elements a work-buffer and slot row holds: np rounded up to 16 bytes, so
// every row starts where the bulk-copy engine can read it.
__host__ __device__ inline int grid_ld(int np, int elsize) {
  const int q = elsize >= 16 ? 1 : 16 / elsize;
  return (np + q - 1) / q * q;
}

// Rows of the true extents each of the G blocks owns (the last ones fewer).
__host__ __device__ inline int grid_rows(int m, int G) {
  return G > 0 ? (m + G - 1) / G : m;
}

// A block's copy of the elimination's state: x of the pending pivots
// (kDefer x rows), then rowperm (mp); colperm, ckey (np); rkey, rpos (rows).
__host__ __device__ inline size_t grid_state_bytes(int rows, int mp, int np,
                                                   int elsize) {
  return align16((size_t)kDefer * rows * elsize) +
         ((size_t)mp + 2 * (size_t)np + 2 * (size_t)rows) * sizeof(int);
}

// The rule that sends a panel to the grid-resident regime: each block's
// share of the m true rows (full padded width), y and the state fit its
// shared memory, and positions fit the 16-bit halves of resident_pass's
// candidate key. Monotone in m, so the host sizes for the padded shape.
__host__ __device__ inline bool fits_grid(int m, int mp, int np, int G,
                                          int elsize) {
  const int rows = grid_rows(m, G);
  return mp < 0xFFFF && np < 0xFFFF &&
         (size_t)rows * np * elsize + align16((size_t)np * elsize) +
                 grid_state_bytes(rows, mp, np, elsize) <=
             kGridSmem;
}

// The streaming regime keeps the state in shared memory where it fits beside
// two stages of the widest chunk, else in its block's region of the scratch.
__host__ __device__ inline bool stream_state_in_smem(int rows, int mp,
                                                     int np, int elsize) {
  return grid_state_bytes(rows, mp, np, elsize) +
             2 * (size_t)stream_q(elsize) * kGridConsumers * elsize <=
         kGridSmem;
}

// Width of a streamed chunk for n true columns: the columns rounded up to 16
// bytes, cut into as few chunks of at most stream_q * kGridConsumers as
// possible, of equal width (a multiple of 16 bytes).
__host__ __device__ inline int stream_width(int n, int elsize) {
  const int q = elsize >= 16 ? 1 : 16 / elsize;
  const int nw = (n + q - 1) / q * q;
  const int cap = stream_q(elsize) * kGridConsumers;
  const int nch = nw > 0 ? (nw + cap - 1) / cap : 1;
  const int w = (nw + nch - 1) / nch;
  return w > 0 ? (w + q - 1) / q * q : q;
}

// Global scratch of the grid mode, carved from one byte buffer that the
// wrapper allocates (rrlu_scratch_bytes): each block's candidate (|a|^2,
// key, entry) and its candidate's whole row, in kSlotSets slot sets taken
// in turn; the work buffer of a streamed panel; the blocks' state where a
// streamed panel's does not fit shared memory.
template <typename T>
struct GridScratch {
  using R = typename Ops<T>::R;
  R* val;                   // (kSlotSets, G)
  unsigned long long* key;  // (kSlotSets, G): column position << 32 | row
  T* piv;                   // (kSlotSets, G)
  T* rows;                  // (kSlotSets, G, ld)
  T* work;                  // (mp, ld), or null where every panel fits
  unsigned char* state;     // (G, state_stride), or null
  size_t state_stride;
};

template <typename T>
__host__ __device__ size_t grid_scratch(unsigned char* base, int mp, int np,
                                        int G, GridScratch<T>* s) {
  using R = typename Ops<T>::R;
  const int es = (int)sizeof(T);
  const size_t ld = (size_t)grid_ld(np, es);
  const bool stream = !fits_grid(mp, mp, np, G, es);
  const int rows = grid_rows(mp, G);
  const bool gstate = stream && !stream_state_in_smem(rows, mp, np, es);
  const size_t stride = align16(grid_state_bytes(rows, mp, np, es));
  const size_t slots = (size_t)kSlotSets * G;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  unsigned char* val = take(slots * sizeof(R));
  unsigned char* key = take(slots * sizeof(unsigned long long));
  unsigned char* piv = take(slots * sizeof(T));
  unsigned char* rws = take(slots * ld * sizeof(T));
  unsigned char* work = stream ? take((size_t)mp * ld * sizeof(T)) : nullptr;
  unsigned char* st = gstate ? take((size_t)G * stride) : nullptr;
  if (s) {
    s->val = reinterpret_cast<R*>(val);
    s->key = reinterpret_cast<unsigned long long*>(key);
    s->piv = reinterpret_cast<T*>(piv);
    s->rows = reinterpret_cast<T*>(rws);
    s->work = reinterpret_cast<T*>(work);
    s->state = st;
    s->state_stride = stride;
  }
  return off;
}

template <typename T>
struct GridState {
  T* x;  // (kDefer, rows): x of the pending pivots, in order
  int* rowperm;
  int* colperm;
  int* ckey;
  int* rkey;
  int* rpos;
};

template <typename T>
__device__ GridState<T> grid_state(unsigned char* p, int rows, int mp,
                                   int np) {
  GridState<T> st;
  st.x = reinterpret_cast<T*>(p);
  st.rowperm = reinterpret_cast<int*>(
      p + align16((size_t)kDefer * rows * sizeof(T)));
  st.colperm = st.rowperm + mp;
  st.ckey = st.colperm + np;
  st.rkey = st.ckey + np;
  st.rpos = st.rkey + rows;
  return st;
}

// The pivots whose update a streamed panel's work buffer still lacks, in
// order: each one's pivot row (its owner's slot row) and its pivot.
template <typename T>
struct Pending {
  const T* row[kDefer];
  T safe[kDefer];
};

// y_j of pending pivot t: the pivot row's entry, divided by the pivot where
// right-orthogonal (the formula of the decision, so the bits are the same).
template <typename T>
__device__ __forceinline__ T pending_y(const Pending<T>& p, int t, int j,
                                       bool leftorth) {
  const T a = __ldcg(p.row[t] + j);
  return leftorth ? a : Ops<T>::div(a, p.safe[t]);
}

// Grid-wide barrier on one counter that the wrapper zeroes before the
// launch: each block adds one with a release at GPU scope (after bar.sync,
// so it publishes the whole block's writes) and waits, with acquire loads,
// until the counter reaches its own count of arrivals so far (`target`,
// the same in every block). Nothing is reset, so one atomic a block and
// barrier. The launch is cooperative, so every block is resident and the
// spin ends.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& target,
                                             unsigned G) {
  __syncthreads();
  target += G;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
    } while ((int)(v - target) < 0);
  }
  __syncthreads();
}

// A 32-bit candidate key of resident_pass (16-bit positions) as the grid's
// 64-bit key (32-bit positions), in the same order.
__device__ __forceinline__ unsigned long long widen_key(unsigned key) {
  return key == kNoKey ? kNoKey64
                       : ((unsigned long long)(key >> 16) << 32) |
                             (key & kNoRow);
}

// The streaming regime's first pass: the block's nr rows of A_in (row
// stride np) copied whole into its rows of the work buffer (row stride ld),
// and each thread's best candidate over the first n columns, with the
// entry itself; rows sit at their own positions r0 + li.
template <typename T>
__device__ __forceinline__ void stream_first(const T* __restrict__ src,
                                             int np, T* dst,
                             int ld, int nr, int n, int r0,
                             typename Ops<T>::R& bv,
                             unsigned long long& bkey, T& bpiv) {
  using R = typename Ops<T>::R;
  constexpr int U = 4;  // elements a thread loads before it stores
  const int total = nr * np;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * kGridThreads) {
    T a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kGridThreads;
      a[u] = e < total ? src[e] : Ops<T>::zero();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kGridThreads;
      if (e >= total) break;
      const int li = e / np, j = e - li * np;
      dst[(size_t)li * ld + j] = a[u];
      if (j < n) {
        const unsigned long long key =
            ((unsigned long long)j << 32) | (unsigned)(r0 + li);
        const R sq = Ops<T>::abs2(a[u]);
        if (ranks_above(sq, key, bv, bkey)) {
          bv = sq;
          bkey = key;
          bpiv = a[u];
        }
      }
    }
  }
}

// The streaming regime's pass over the block's unpivoted rows of the work
// buffer (row stride ld): chunks of Wc columns (each consumer thread takes
// stream_q of them, their keys and pending y in registers), and in each
// chunk the rows in turn, fed through a ring of S shared-memory stages by
// the producer warp (one bulk copy a row chunk, completing on full[s]; the
// consumer warps release a stage on empty[s]). Each consumer rebuilds the
// entry from the work buffer by the D pending updates a - x_i y_j, in order
// (the last is this pass's pivot), stores it when `write` is set, and keeps
// its best candidate with the entry; `it` counts the ring's items in every
// thread alike. D is a template parameter: a count known only at run time
// would make every rebuild kDefer predicated steps (stream_pass_n picks the
// instantiation).
template <typename T, int D>
__device__ __forceinline__ void stream_pass(
    T* A, int ld, int nr, int n, int Wc, int S, unsigned char* ring,
    unsigned long long* full, unsigned long long* empty, unsigned& it,
    const GridState<T>& st, int rows, const Pending<T>& pend, bool write,
    bool leftorth, typename Ops<T>::R& bv, unsigned long long& bkey,
    T& bpiv) {
  using R = typename Ops<T>::R;
  constexpr int NC = kGridConsumers;
  constexpr int Q = stream_q((int)sizeof(T));
  const int tid = threadIdx.x;
  const int q16 = sizeof(T) >= 16 ? 1 : 16 / (int)sizeof(T);
  const int nw = (n + q16 - 1) / q16 * q16;
  const size_t stage = (size_t)Wc * sizeof(T);
  bv = R(-1);
  bkey = kNoKey64;
  bpiv = Ops<T>::zero();
  if (tid >= NC) {  // the producer warp; lane 0 copies, all lanes count
    for (int c0 = 0; c0 < n; c0 += Wc) {
      const unsigned bytes =
          (unsigned)((nw - c0 < Wc ? nw - c0 : Wc) * sizeof(T));
      for (int li = 0; li < nr; ++li) {
        if (st.rkey[li] < 0) continue;
        if (tid == NC) {
          const unsigned s = it % S, u = it / S;
          if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);
          bulk_copy(ring + s * stage, A + (size_t)li * ld + c0, bytes,
                    &full[s]);
        }
        ++it;
      }
    }
    return;
  }
  for (int c0 = 0; c0 < n; c0 += Wc) {
    const int cend = min(n, c0 + Wc);
    T yq[D][Q];
    int ck[Q];
    R cm[Q];
    int cp[Q];
    T cv[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = c0 + tid + q * NC;
      ck[q] = j < cend ? st.ckey[j] : -1;
#pragma unroll
      for (int t = 0; t < D; ++t)
        yq[t][q] = ck[q] >= 0 ? pending_y(pend, t, j, leftorth)
                              : Ops<T>::zero();
      cm[q] = R(-1);
      cp[q] = -1;
      cv[q] = Ops<T>::zero();
    }
    for (int li = 0; li < nr; ++li) {
      const int rk = st.rkey[li];
      if (rk < 0) continue;
      const unsigned s = it % S, u = it / S;
      mbar_wait(&full[s], u & 1);
      const T* src = reinterpret_cast<const T*>(ring + s * stage);
      T* dst = A + (size_t)li * ld + c0;
      T xr[D];
#pragma unroll
      for (int t = 0; t < D; ++t) xr[t] = st.x[t * rows + li];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (ck[q] < 0) continue;
        const int c = tid + q * NC;
        T v = src[c];
#pragma unroll
        for (int t = 0; t < D; ++t)
          v = Ops<T>::sub(v, Ops<T>::mul(xr[t], yq[t][q]));
        if (write) dst[c] = v;
        const R sq = Ops<T>::abs2(v);
        if (ranks_above(sq, rk, cm[q], cp[q])) {
          cm[q] = sq;
          cp[q] = rk;
          cv[q] = v;
        }
      }
      __syncwarp();
      if ((tid & 31) == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                         smem_addr(&empty[s]))
                     : "memory");
      ++it;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (ck[q] < 0 || cp[q] < 0) continue;
      const unsigned long long key =
          ((unsigned long long)ck[q] << 32) | (unsigned)cp[q];
      if (ranks_above(cm[q], key, bv, bkey)) {
        bv = cm[q];
        bkey = key;
        bpiv = cv[q];
      }
    }
  }
}

// stream_pass with its count of pending updates, D in [1, kDefer].
template <typename T>
__device__ __forceinline__ void stream_pass_n(
    int D, T* A, int ld, int nr, int n, int Wc, int S, unsigned char* ring,
    unsigned long long* full, unsigned long long* empty, unsigned& it,
    const GridState<T>& st, int rows, const Pending<T>& pend, bool write,
    bool leftorth, typename Ops<T>::R& bv, unsigned long long& bkey,
    T& bpiv) {
  static_assert(kDefer == 4, "stream_pass_n instantiates D = 1 ... 4");
#define RRLU_STREAM_PASS(d)                                               \
  stream_pass<T, d>(A, ld, nr, n, Wc, S, ring, full, empty, it, st, rows, \
                    pend, write, leftorth, bv, bkey, bpiv)
  switch (D) {
    case 1:
      RRLU_STREAM_PASS(1);
      break;
    case 2:
      RRLU_STREAM_PASS(2);
      break;
    case 3:
      RRLU_STREAM_PASS(3);
      break;
    default:
      RRLU_STREAM_PASS(4);
  }
#undef RRLU_STREAM_PASS
}

// C is the cluster size of the cluster kernel launched before this one (0:
// none); the panels that fits_cluster gives to it are skipped here. Each
// other panel is grid-resident (fits_grid: mode 2) or streamed (mode 3),
// and the instantiation of its regime takes it (the other skips it). Both
// instantiations run on the same number of blocks, so they agree on the
// rule; `bar` is the instantiation's own barrier counter.
template <typename T, bool Stream>
__global__ void __launch_bounds__(kGridThreads, 1)
    rrlu_grid_kernel(const T* __restrict__ A_in, unsigned char* scratch,
                     unsigned int* bar, T* __restrict__ A_sw,
                     int64_t* __restrict__ rowperm_out,
                     int64_t* __restrict__ colperm_out,
                     typename Ops<T>::R* __restrict__ mags_out,
                     int64_t* __restrict__ k_out,
                     typename Ops<T>::R* __restrict__ err_out,
                     int64_t* __restrict__ mode_out,
                     const int* m_arr, const int* n_arr,
                     const int* maxrank_arr,
                     const typename Ops<T>::R* tol_arr, int m_s, int n_s,
                     int maxrank_s, typename Ops<T>::R reltol_s,
                     typename Ops<T>::R abstol_s, int B, int mp, int np,
                     int leftorth_i, int C, long long l2_bytes,
                     unsigned long long* work) {
  using R = typename Ops<T>::R;
  constexpr int NT = kGridThreads;
  constexpr int W = kGridWarps;
  constexpr int es = (int)sizeof(T);
  __shared__ unsigned long long load_bar;
  __shared__ unsigned long long full[kMaxStages], empty[kMaxStages];
  __shared__ R w_val[W];  // per-warp winners
  __shared__ unsigned long long w_key[W];
  __shared__ T w_piv[W];
  __shared__ int s_piv[4];  // {stop, pc, pr, the winner's local row}
  __shared__ T s_safe;
  __shared__ Pending<T> pend;  // a streamed panel's pending pivots
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = (int)gridDim.x;
  const int g = (int)blockIdx.x;
  const bool leftorth = leftorth_i != 0;
  const int rmax = mp < np ? mp : np;
  const size_t panel = (size_t)mp * np;
  const int ld = grid_ld(np, es);
  GridScratch<T> s;
  grid_scratch<T>(scratch, mp, np, G, &s);
  unsigned target = 0;  // arrivals the last grid barrier waited for
#ifdef RRLU_PHASE_CLOCKS
  long long ph[kPhases] = {};
  long long ph_t = clock64();
#endif

  for (int b = 0; b < B; ++b) {
    int m = m_arr ? m_arr[b] : m_s;
    int n = n_arr ? n_arr[b] : n_s;
    int maxrank = maxrank_arr ? maxrank_arr[b] : maxrank_s;
    clamp_extents(mp, np, m, n, maxrank);
    // a panel that fits the cluster launched before this one is its: every
    // block reads the same extents and skips it before any barrier
    if (fits_cluster(m, mp, np, C, es)) continue;
    const R reltol = tol_arr ? tol_arr[2 * b] : reltol_s;
    const R abstol = tol_arr ? tol_arr[2 * b + 1] : abstol_s;
    const T* Ain = A_in + b * panel;
    // a panel of the other regime is the other instantiation's
    if (fits_grid(m, mp, np, G, es) == Stream) continue;
    const int rows = grid_rows(m, G);
    const int r0 = min(g * rows, m);
    const int nr = min(rows, m - r0);

    // Where the block's rows and state live. Grid-resident: the rows (np
    // wide), y and the state in shared memory. Streamed: the rows in the
    // work buffer (ld wide), the ring in shared memory, the state beside it
    // or in the scratch.
    T* A;
    int lda;
    T* y = nullptr;
    GridState<T> st;
    unsigned char* ring = nullptr;
    int Wc = 0, S = 0;
    if constexpr (!Stream) {
      A = reinterpret_cast<T*>(smem_raw);
      lda = np;
      y = A + (size_t)rows * np;
      st = grid_state<T>(
          smem_raw + (size_t)rows * np * es + align16((size_t)np * es), rows,
          mp, np);
    } else {
      A = s.work + (size_t)r0 * ld;
      lda = ld;
      Wc = stream_width(n, es);
      const size_t stage = (size_t)Wc * es;
      if (stream_state_in_smem(rows, mp, np, es)) {
        const size_t sb = (grid_state_bytes(rows, mp, np, es) + 127) &
                          ~(size_t)127;
        st = grid_state<T>(smem_raw, rows, mp, np);
        ring = smem_raw + sb;
        S = (int)((kGridSmem - sb) / stage);
      } else {
        st = grid_state<T>(s.state + (size_t)g * s.state_stride, rows, mp,
                           np);
        ring = smem_raw;
        S = (int)(kGridSmem / stage);
      }
      if (S > kMaxStages) S = kMaxStages;
    }
    // the ring starts afresh with each streamed panel (its stage count
    // depends on the panel's width); nothing is in flight between panels
    unsigned it = 0;  // items through the ring so far, in every thread
    int npend = 0;    // pivots the work buffer lacks, the same everywhere
    const int depth = Stream ? defer_depth(m, n, es, l2_bytes) : 1;
    if (Stream && tid == 0) {
      for (int i = 0; i < S; ++i) {
        mbar_init(&full[i], 1u);
        mbar_init(&empty[i], (unsigned)kGridConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    const bool bulk = !Stream && nr > 0 &&
                      ((uintptr_t)(Ain + (size_t)r0 * np) & 15) == 0 &&
                      ((size_t)np * es) % 16 == 0;
    if (bulk && tid == 0)
      bulk_load(A, Ain + (size_t)r0 * np, (unsigned)((size_t)nr * np * es),
                &load_bar);
    for (int i = tid; i < mp; i += NT) st.rowperm[i] = i;
    for (int j = tid; j < np; j += NT) {
      st.colperm[j] = j;
      st.ckey[j] = j < n ? j : -1;
    }
    for (int li = tid; li < nr; li += NT) {
      st.rkey[li] = r0 + li;
      st.rpos[li] = r0 + li;
    }
    if (g == 0)
      for (int r = tid; r < rmax; r += NT) mags_out[b * rmax + r] = R(0);
    if (!Stream && !bulk)
      for (int e = tid; e < nr * np; e += NT)
        A[e] = Ain[(size_t)r0 * np + e];
    __syncthreads();  // the barriers' initialisation, the state, the rows
    if (bulk) mbar_wait(&load_bar, 0);
    PHASE_MARK(kPhaseLoad);

    // An entry of the block's row li as it stands after the last pass: the
    // work buffer's, less the pending updates where the column was unpivoted
    // through them (`live`).
    auto current = [&](int li, int j, bool live) {
      T a = A[(size_t)li * lda + j];
      if constexpr (Stream) {
        if (live && npend > 0) {
          T yt[kDefer];  // every load in flight before the chain
#pragma unroll
          for (int t = 0; t < kDefer; ++t)
            yt[t] = t < npend ? pending_y(pend, t, j, leftorth)
                              : Ops<T>::zero();
#pragma unroll
          for (int t = 0; t < kDefer; ++t)
            if (t < npend)
              a = Ops<T>::sub(a, Ops<T>::mul(st.x[t * rows + li], yt[t]));
        }
      }
      return a;
    };

    // After a pass: warp 0 reduces the warp winners and publishes the
    // block's candidate (|a|^2, key, entry) in slot set `set`; then the
    // whole block copies the candidate's row (first n columns, as they
    // stand) beside it.
    auto publish = [&](int set, R bv, unsigned long long bkey, T bpiv) {
      if (lane == 0) {
        w_val[warp] = bv;
        w_key[warp] = bkey;
        w_piv[warp] = bpiv;
      }
      __syncthreads();
      if (warp == 0) {
        bv = lane < W ? w_val[lane] : R(-1);
        bkey = lane < W ? w_key[lane] : kNoKey64;
        bpiv = lane < W ? w_piv[lane] : Ops<T>::zero();
        const unsigned long long mine = bkey;
        warp_argmax<R>(bv, bkey);
        const unsigned holder = __ballot_sync(0xffffffffu, mine == bkey);
        bpiv = shfl_from(bpiv, __ffs(holder) - 1);
        if (lane == 0) {
          const size_t at = (size_t)set * G + g;
          s.val[at] = bv;
          s.key[at] = bkey;
          s.piv[at] = bpiv;
          s_piv[3] = bv < R(0) ? -1 : st.rowperm[(unsigned)bkey] - r0;
        }
      }
      __syncthreads();
      const int li = s_piv[3];
      if (li >= 0) {
        T* dst = s.rows + ((size_t)set * G + g) * ld;
        for (int j0 = tid; j0 < n; j0 += kRowUnroll * NT) {
          T a[kRowUnroll];
#pragma unroll
          for (int u = 0; u < kRowUnroll; ++u)
            a[u] = j0 + u * NT < n
                       ? current(li, j0 + u * NT, st.ckey[j0 + u * NT] >= 0)
                       : Ops<T>::zero();
#pragma unroll
          for (int u = 0; u < kRowUnroll; ++u)
            if (j0 + u * NT < n) dst[j0 + u * NT] = a[u];
        }
      }
    };

    // a grid-resident warp's winner names its entry in shared memory
    auto resident_piv = [&](R bv, unsigned key32) {
      return bv < R(0) ? Ops<T>::zero()
                       : A[(size_t)(st.rowperm[key32 & kNoRow] - r0) * lda +
                           st.colperm[key32 >> 16]];
    };

    R bv = R(-1);
    unsigned long long bkey = kNoKey64;
    T bpiv = Ops<T>::zero();
    if constexpr (!Stream) {
      const PassLayout L(n, warp, W);
      unsigned key32;
      resident_pass<T>(A, np, nr, n, L, st.rkey, st.ckey, st.x, y, bv, key32,
                       false, leftorth, -1, -1);
      bkey = widen_key(key32);
      bpiv = resident_piv(bv, key32);
    } else {
      stream_first<T>(Ain + (size_t)r0 * np, np, A, ld, nr, n, r0, bv, bkey,
                      bpiv);
      // the work buffer is read next by the bulk-copy engine (async proxy)
      asm volatile("fence.proxy.async.global;" ::: "memory");
      const unsigned long long mine = bkey;
      warp_argmax<R>(bv, bkey);
      bpiv = shfl_from(bpiv,
                       __ffs(__ballot_sync(0xffffffffu, mine == bkey)) - 1);
    }
    publish(0, bv, bkey, bpiv);
    PHASE_MARK(kPhaseFirst);

    int k = 0;
    R maxerror = R(0);
    R err = Ops<R>::nan();
    while (true) {
      // The barrier, the decision and x, y; `break` leaves them once the
      // elimination stops (done).
      bool done = false;
      do {
        grid_barrier(bar, target, G);  // every block's slots of set k
        PHASE_MARK(kPhaseBarrier);
        if (k >= maxrank) {
          done = true;
          break;
        }
        const int set = k % kSlotSets;

        // Warp 0 of every block reduces the G slots (lane l reads slots l,
        // l + 32, ...) and takes the same decision and the same swaps.
        if (warp == 0) {
          R v = R(-1);
          unsigned long long key = kNoKey64;
          T piv = Ops<T>::zero();
          // kSlotReads slots a lane, all loads in flight at once (132 SMs:
          // one round)
          for (int q0 = lane; q0 < G; q0 += 32 * kSlotReads) {
            R qv[kSlotReads];
            unsigned long long qk[kSlotReads];
            T qp[kSlotReads];
#pragma unroll
            for (int u = 0; u < kSlotReads; ++u) {
              const int q = q0 + 32 * u;
              const size_t at = (size_t)set * G + q;
              qv[u] = q < G ? __ldcg(s.val + at) : R(-1);
              qk[u] = q < G ? __ldcg(s.key + at) : kNoKey64;
              qp[u] = q < G ? __ldcg(s.piv + at) : Ops<T>::zero();
            }
#pragma unroll
            for (int u = 0; u < kSlotReads; ++u)
              if (ranks_above(qv[u], qk[u], v, key)) {
                v = qv[u];
                key = qk[u];
                piv = qp[u];
              }
          }
          const unsigned long long mine = key;
          warp_argmax<R>(v, key);
          const unsigned holder = __ballot_sync(0xffffffffu, mine == key);
          piv = shfl_from(piv, __ffs(holder) - 1);
          if (lane == 0) {
            int stop = 1;
            R e = R(0);  // no valid column (or row) left: stop with err 0
            int pc = 0, pr = 0;
            T safe = Ops<T>::one();
            if (!(v < R(0))) {  // a candidate: a value or a NaN
              const int bestcolpos = (int)(key >> 32);
              const int bestrowpos = (int)(unsigned)key;
              pc = st.colperm[bestcolpos];
              pr = st.rowperm[bestrowpos];
              e = Ops<R>::sqrt(v);
              stop = k > 0 && (e < Ops<R>::mul(reltol, maxerror) ||
                               e < abstol || e == R(0));
              safe = Ops<T>::nonzero(piv) ? piv : Ops<T>::one();
              if (!stop) {
                maxerror = nan_max(maxerror, e);
                if (g == 0) mags_out[b * rmax + k] = e;
                // the virtual swaps on this block's copy; only the two rows
                // and the two columns that move change their keys
                const int r_at_k = st.rowperm[k], c_at_k = st.colperm[k];
                st.rowperm[bestrowpos] = r_at_k;
                st.rowperm[k] = pr;
                st.colperm[bestcolpos] = c_at_k;
                st.colperm[k] = pc;
                if (r_at_k >= r0 && r_at_k < r0 + nr) {
                  st.rkey[r_at_k - r0] = bestrowpos;
                  st.rpos[r_at_k - r0] = bestrowpos;
                }
                if (pr >= r0 && pr < r0 + nr) {
                  st.rkey[pr - r0] = -1;
                  st.rpos[pr - r0] = k;
                }
                st.ckey[c_at_k] = bestcolpos;
                st.ckey[pc] = -1;
              }
            }
            err = e;
            s_piv[0] = stop;
            s_piv[1] = pc;
            s_piv[2] = pr;
            s_safe = safe;
          }
        }
        __syncthreads();  // the decision
        PHASE_MARK(kPhaseDecide);
        if (s_piv[0]) {
          done = true;
          break;
        }
        const int pc = s_piv[1], pr = s_piv[2];
        const T safe = s_safe;
        const int owner = pr / rows;
        // the pivot row as its owner published it (as it stood after the
        // last pass)
        const T* prow = s.rows + ((size_t)set * G + owner) * ld;
        // x from this block's rows as they stand; the multipliers (left-
        // orthogonal) or the entries (right-orthogonal) go to column pc,
        // which no pass touches again
        T* xk = st.x + (size_t)npend * rows;
        for (int li = tid; li < nr; li += NT) {
          if (st.rkey[li] < 0) continue;
          const T a = current(li, pc, true);  // pc was unpivoted until now
          const T xv = leftorth ? Ops<T>::div(a, safe) : a;
          xk[li] = xv;
          A[(size_t)li * lda + pc] = xv;
        }
        // y (the grid-resident pass reads it from shared memory, the
        // streaming pass from the slot row), and the owner stores row pr as
        // it ends: the entry at pc, and at the other unpivoted columns the
        // entries (left-orthogonal) or the multipliers y. The others read
        // the slot row, never the owner's rows.
        T* own = owner == g ? A + (size_t)(pr - r0) * lda : nullptr;
        if (!Stream || own)
          for (int j0 = tid; j0 < n; j0 += kRowUnroll * NT) {
            T a[kRowUnroll];  // the L2 reads all in flight before any store
#pragma unroll
            for (int u = 0; u < kRowUnroll; ++u) {
              const int j = j0 + u * NT;
              a[u] = j < n && (st.ckey[j] >= 0 || j == pc) ? __ldcg(prow + j)
                                                           : Ops<T>::zero();
            }
#pragma unroll
            for (int u = 0; u < kRowUnroll; ++u) {
              const int j = j0 + u * NT;
              if (j >= n || (st.ckey[j] < 0 && j != pc)) continue;
              const T yv = leftorth || j == pc ? a[u] : Ops<T>::div(a[u], safe);
              if (!Stream && j != pc) y[j] = yv;
              if (own) own[j] = yv;
            }
          }
        if (Stream && tid == 0) {
          pend.row[npend] = prow;
          pend.safe[npend] = safe;
        }
        __syncthreads();  // x, y, the multipliers, the pending list
        PHASE_MARK(kPhaseXY);
      } while (false);
      // A stopped streamed panel makes one more pass, with no new pivot,
      // that writes the pending updates back: the same call as every other
      // pass, so the kernel holds one inlined copy of the pass.
      if (done && (!Stream || npend == 0)) break;
      if constexpr (!Stream) {
        const PassLayout L(n, warp, W);
        unsigned key32;
        resident_pass<T>(A, np, nr, n, L, st.rkey, st.ckey, st.x, y, bv,
                         key32, true, leftorth, -1, -1);
        bkey = widen_key(key32);
        bpiv = resident_piv(bv, key32);
      } else {
        if (!done) ++npend;
        const bool write = done || npend == depth;
        stream_pass_n<T>(npend, A, ld, nr, n, Wc, S, ring, full, empty, it,
                         st, rows, pend, write, leftorth, bv, bkey, bpiv);
        if (write) npend = 0;
        asm volatile("fence.proxy.async.global;" ::: "memory");
        const unsigned long long mine = bkey;
        warp_argmax<R>(bv, bkey);
        bpiv = shfl_from(
            bpiv, __ffs(__ballot_sync(0xffffffffu, mine == bkey)) - 1);
      }
      PHASE_MARK(kPhasePass);
      if (done) {
        __syncthreads();  // the write-out reads what the pass wrote
        break;
      }
      ++k;
      publish(k % kSlotSets, bv, bkey, bpiv);
      PHASE_MARK(kPhasePublish);
    }

    // A_sw[i, j] = A[rowperm[i], colperm[j]]: this block's rows ...
    T* out = A_sw + b * panel;
    for (int li = warp; li < nr; li += W) {
      const T* src = A + (size_t)li * lda;
      T* dst = out + (size_t)st.rpos[li] * np;
      for (int j = lane; j < np; j += 32) dst[j] = src[st.colperm[j]];
    }
    // ... and the padding rows, which never move, straight from A_in
    for (int i = m + g * W + warp; i < mp; i += G * W) {
      const T* src = Ain + (size_t)i * np;
      T* dst = out + (size_t)i * np;
      for (int j = lane; j < np; j += 32) dst[j] = src[st.colperm[j]];
    }
    if (g == 0) {
      if (tid == 0) {
        k_out[b] = k;
        err_out[b] = err;
        mode_out[b] = Stream ? 3 : 2;
        count_work<T>(work, Stream ? 3 : 2, mp, np, m, n, k);
      }
      for (int i = tid; i < mp; i += NT)
        rowperm_out[b * mp + i] = st.rowperm[i];
      for (int j = tid; j < np; j += NT)
        colperm_out[b * np + j] = st.colperm[j];
    }
    PHASE_MARK(kPhaseWrite);
    // the next panel reuses the slots, which a block may still be reading
    if (b + 1 < B) grid_barrier(bar, target, G);
    PHASE_MARK(kPhaseFlush);
  }
#ifdef RRLU_PHASE_CLOCKS
  if (tid == 0 && g < kMaxClockBlocks)
    for (int i = 0; i < kPhases; ++i)
      rrlu_grid_phase_cycles[g * kPhases + i] = ph[i];
#endif
}

// G blocks, each through `iters` grid barriers and nothing else: the
// barrier's cost alone, at the grid mode's launch shape
// (rrlu_grid_barrier_launch).
__global__ void __launch_bounds__(kGridThreads, 1)
    grid_barrier_kernel(unsigned* bar, int iters) {
  unsigned target = 0;
  for (int i = 0; i < iters; ++i) grid_barrier(bar, target, gridDim.x);
}

template <typename T>
bool is_resident(int mp, int np) {
  return (size_t)mp * np * sizeof(T) <= kResidentPanelBytes &&
         smem_bytes<T>(mp, np) <= kSmemLimit && mp < 0xFFFF && np < 0xFFFF;
}

// Whether the cluster kernel can take (mp, np) panels at all: positions fit
// the 16-bit halves of a candidate key, and each row starts on a 16-byte
// boundary for the bulk copy (the wrapper checks the panel's own address).
template <typename T>
bool cluster_capable(int mp, int np) {
  return mp < 0xFFFF && np < 0xFFFF && ((size_t)np * sizeof(T)) % 16 == 0;
}

// How a call on (mp, np) panels runs, with a cluster of C CTAs (0: none):
// 0 the resident kernel, 1 the cluster kernel alone (the padded panel fits),
// 2 the cluster kernel then the grid kernel (each panel takes the one that
// fits_cluster picks from its true extents), 3 the grid kernel alone.
template <typename T>
int host_mode(int mp, int np, int C) {
  if (is_resident<T>(mp, np)) return 0;
  if (C <= 0 || !cluster_capable<T>(mp, np)) return 3;
  return fits_cluster(mp, mp, np, C, (int)sizeof(T)) ? 1 : 2;
}

// Once per device and element type, outside any capture: the resident
// kernel's dynamic shared-memory limit, the cluster kernel's (with clusters
// above the portable 8 CTAs allowed) and the grid kernel's.
template <typename T>
cudaError_t kernel_attributes() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(rrlu_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemLimit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rrlu_cluster_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kClusterSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rrlu_cluster_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rrlu_grid_kernel<T, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGridSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rrlu_grid_kernel<T, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGridSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

// The cluster size at the largest shared memory a CTA may take: 16 where the
// card can schedule such a cluster (cudaOccupancyMaxActiveClusters), else 8;
// an error when neither fits.
template <typename T>
int cluster_size() {
  cudaError_t e = kernel_attributes<T>();
  if (e != cudaSuccess) return -(int)e;
  for (int C = kMaxCluster; C >= 8; C /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = kClusterSmem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, rrlu_cluster_kernel<T>,
                                       &cfg);
    if (e != cudaSuccess) return -(int)e;
    if (clusters >= 1) return C;
  }
  return -(int)cudaErrorInvalidConfiguration;
}

// Blocks of the grid mode: as many as the card holds at once at the
// launch's shared memory (one an SM; the cooperative launch refuses more),
// the fewer of the two instantiations', so that both apply one rule.
template <typename T>
int grid_blocks(int* G) {
  cudaError_t e = kernel_attributes<T>();
  int dev = 0, sms = 0, res_sm = 0, stream_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &res_sm, rrlu_grid_kernel<T, false>, kGridThreads, kGridSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &stream_sm, rrlu_grid_kernel<T, true>, kGridThreads, kGridSmem);
  if (e != cudaSuccess) return (int)e;
  const int per_sm = res_sm < stream_sm ? res_sm : stream_sm;
  if (sms * per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G = sms * per_sm;
  return 0;
}

template <typename T>
long long scratch_bytes(int mp, int np, int C) {
  if (host_mode<T>(mp, np, C) < 2) return 0;
  int G = 0;
  const int rc = grid_blocks<T>(&G);
  if (rc != 0) return -(long long)rc;
  return (long long)grid_scratch<T>(nullptr, mp, np, G, nullptr);
}

template <typename T>
int launch(const void* A_in, void* scratch, void* bar, void* A_sw,
           void* rowperm, void* colperm, void* mags, void* k_out,
           void* err_out, void* mode_out, const void* m_arr,
           const void* n_arr, const void* maxrank_arr, const void* tol_arr,
           int m, int n, int maxrank, double reltol, double abstol, int B,
           int mp, int np, int leftorth, int C, void* work_rec,
           void* stream) {
  using R = typename Ops<T>::R;
  if (B <= 0 || mp <= 0 || np <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int mode = host_mode<T>(mp, np, C);
  const T* a_in = (const T*)A_in;
  T* a_sw = (T*)A_sw;
  int64_t* rp = (int64_t*)rowperm;
  int64_t* cp = (int64_t*)colperm;
  R* mg = (R*)mags;
  int64_t* ko = (int64_t*)k_out;
  R* eo = (R*)err_out;
  int64_t* mo = (int64_t*)mode_out;
  const int* ma = (const int*)m_arr;
  const int* na = (const int*)n_arr;
  const int* ra = (const int*)maxrank_arr;
  const R* ta = (const R*)tol_arr;
  R rt = (R)reltol, at = (R)abstol;
  unsigned long long* wk = (unsigned long long*)work_rec;
  cudaError_t e = kernel_attributes<T>();
  if (e != cudaSuccess) return (int)e;
  if (mode == 0 || mode == 1 || mode == 2) {
    // the bulk copies need 16-byte aligned panels of a multiple of 16 bytes
    if (((uintptr_t)A_in & 15) != 0 || ((size_t)mp * np * sizeof(T)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  if (mode == 0) {
    rrlu_kernel<T><<<B, kResidentThreads, smem_bytes<T>(mp, np), st>>>(
        a_in, a_sw, rp, cp, mg, ko, eo, mo, ma, na, ra, ta, m, n, maxrank, rt,
        at, mp, np, leftorth, wk);
    return (int)cudaGetLastError();
  }
  if (mode == 1 || mode == 2) {
    // shared memory for the most rows a CTA may hold: the padded panel's,
    // or the limit where only smaller true extents fit
    size_t smem = cluster_smem(cluster_rows(mp, C), mp, np, (int)sizeof(T));
    if (smem > kClusterSmem) smem = kClusterSmem;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(B * C);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, rrlu_cluster_kernel<T>, a_in, a_sw, rp, cp,
                           mg, ko, eo, mo, ma, na, ra, ta, m, n, maxrank, rt,
                           at, mp, np, leftorth, wk);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess || mode == 1) return (int)e;
  }
  // mode 2 or 3: the grid kernel, for what the cluster kernel left; the
  // grid-resident instantiation where a panel may fit the grid's shared
  // memory, the streaming one where a panel may not (the true extents
  // choose), each with its own barrier counter
  if (scratch == nullptr || bar == nullptr) return (int)cudaErrorInvalidValue;
  int G = 0, dev = 0, l2 = 0;
  int rc = grid_blocks<T>(&G);
  if (rc != 0) return rc;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) return (int)e;
  unsigned char* scr = (unsigned char*)scratch;
  int Cg = mode == 2 ? C : 0;
  long long l2_bytes = l2;
  const int es = (int)sizeof(T);
  for (int stream = 0; stream < 2; ++stream) {
    // m = 0 rows is the smallest a panel can have, mp the largest
    if (stream ? fits_grid(mp, mp, np, G, es) : !fits_grid(0, mp, np, G, es))
      continue;
    unsigned int* br = (unsigned int*)bar + stream;
    void* args[] = {&a_in, &scr, &br, &a_sw, &rp, &cp, &mg, &ko, &eo, &mo,
                    &ma, &na, &ra, &ta, &m, &n, &maxrank, &rt, &at,
                    &B, &mp, &np, &leftorth, &Cg, &l2_bytes, &wk};
    e = cudaLaunchCooperativeKernel(
        stream ? (const void*)rrlu_grid_kernel<T, true>
               : (const void*)rrlu_grid_kernel<T, false>,
        dim3(G), dim3(kGridThreads), args, kGridSmem, st);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// The cluster size (16 or 8) the cluster kernel of `elsize`-byte elements
// (4: float32, 8: float64, 16: complex128) takes on the current device, minus a CUDA error code when neither can be
// scheduled. Also sets the kernels' shared-memory attributes: call it once
// per device and element type outside any stream capture.
int rrlu_cluster_size(int elsize) {
  switch (elsize) {
    case 4:
      return cluster_size<float>();
    case 8:
      return cluster_size<double>();
    case 16:
      return cluster_size<double2>();
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

// How a call on (mp, np) panels runs with clusters of C CTAs (0: no cluster
// kernel): 0 resident, 1 cluster, 2 cluster then grid, 3 grid; -1 for an
// element size the kernel has no body for.
int rrlu_host_mode(int mp, int np, int elsize, int C) {
  switch (elsize) {
    case 4:
      return host_mode<float>(mp, np, C);
    case 8:
      return host_mode<double>(mp, np, C);
    case 16:
      return host_mode<double2>(mp, np, C);
    default:
      return -1;
  }
}

// Bytes of global scratch a call on (mp, np) panels needs on the current
// device with clusters of C CTAs: 0 unless the grid kernel runs (host modes
// 2 and 3), minus a CUDA error code when the grid cannot be sized or the
// element size is none of the three. The wrapper allocates it, and two
// zeroed 32-bit words: the barrier counters of the grid kernel's two
// instantiations.
long long rrlu_scratch_bytes(int mp, int np, int elsize, int C) {
  switch (elsize) {
    case 4:
      return scratch_bytes<float>(mp, np, C);
    case 8:
      return scratch_bytes<double>(mp, np, C);
    case 16:
      return scratch_bytes<double2>(mp, np, C);
    default:
      return -(long long)cudaErrorInvalidValue;
  }
}

// Blocks of the grid mode's launch for `elsize`-byte elements on the
// current device, minus a CUDA error code.
int rrlu_grid_blocks(int elsize) {
  int G = 0, rc = 0;
  switch (elsize) {
    case 4:
      rc = grid_blocks<float>(&G);
      break;
    case 8:
      rc = grid_blocks<double>(&G);
      break;
    case 16:
      rc = grid_blocks<double2>(&G);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? -rc : G;
}

// Threads of a grid block (and of the barrier's measurement).
int rrlu_grid_threads() { return kGridThreads; }

// The regime the grid kernel takes for a panel of m true rows in (mp, np)
// panels on G blocks: 2 grid-resident (fits_grid), 3 streamed.
int rrlu_grid_regime(int m, int mp, int np, int elsize, int G) {
  return fits_grid(m, mp, np, G, elsize) ? 2 : 3;
}

// `iters` grid barriers of the grid mode's launch shape on the current
// device and `stream`, and nothing else; `bar` is one zeroed 32-bit word.
int rrlu_grid_barrier_launch(int iters, void* bar, void* stream) {
  int G = 0;
  const int rc = grid_blocks<double>(&G);
  if (rc != 0) return rc;
  unsigned* b = (unsigned*)bar;
  void* args[] = {&b, &iters};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_barrier_kernel, dim3(G), dim3(kGridThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// B panels of (mp, np), contiguous. Per-panel sizes, rank caps and
// tolerances come from the device arrays m_arr, n_arr, maxrank_arr ((B,)
// int32) and tol_arr ((B, 2): reltol, abstol) when they are not null, and
// from the scalar arguments otherwise; the kernels clamp them to the panel,
// so the caller need not read them back to check them. C is the cluster
// size from rrlu_cluster_size (0: no cluster kernel); mode_out ((B,) int64)
// receives each panel's mode; `work` is the device's work record (8 int64,
// count_work), or null. Returns the launches' CUDA error code (0 on
// success).
#define RRLU_LAUNCH(NAME, T)                                                  \
  int NAME(const void* A_in, void* scratch, void* bar, void* A_sw,           \
           void* rowperm, void* colperm, void* mags, void* k_out,            \
           void* err_out, void* mode_out, const void* m_arr,                 \
           const void* n_arr, const void* maxrank_arr, const void* tol_arr,  \
           int m, int n, int maxrank, double reltol, double abstol, int B,   \
           int mp, int np, int leftorth, int C, void* work, void* stream) {  \
    return launch<T>(A_in, scratch, bar, A_sw, rowperm, colperm, mags,       \
                     k_out, err_out, mode_out, m_arr, n_arr, maxrank_arr,    \
                     tol_arr, m, n, maxrank, reltol, abstol, B, mp, np,      \
                     leftorth, C, work, stream);                             \
  }
RRLU_LAUNCH(rrlu_launch_f64, double)
RRLU_LAUNCH(rrlu_launch_f32, float)
RRLU_LAUNCH(rrlu_launch_c128, double2)
#undef RRLU_LAUNCH

#ifdef RRLU_PHASE_CLOCKS
// The cycles of each phase (kPhaseLoad ... kPhaseWrite) of each CTA of the
// last cluster launch's panel 0, (kMaxCluster, kPhases) int64, into `out`.
int rrlu_phase_cycles_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, rrlu_phase_cycles,
                                   sizeof(rrlu_phase_cycles));
}

// The cycles of each phase of each of the first 256 blocks of the last
// grid launch, summed over its panels, (256, kPhases) int64, into `out`
// (kPhaseFlush: the barrier between two panels).
int rrlu_grid_phase_cycles_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, rrlu_grid_phase_cycles,
                                   sizeof(rrlu_grid_phase_cycles));
}
#endif

}  // extern "C"
