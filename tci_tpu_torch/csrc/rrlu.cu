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
// Three modes, chosen per panel; a call is one launch, or two (below):
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
//   - grid (everything else): one cooperative launch of as many 1024-thread
//     blocks as fit on the card at once. The true extents are cut into tiles
//     (a band of up to 256 rows x 64 columns), each owned by one block for
//     the whole elimination. Per pivot, block 0 reduces the per-band column
//     maxima, finds the pivot, tests the stop rule and publishes the pivot
//     column and row (x, y); a grid barrier; every block updates its tiles
//     and writes their column maxima; a grid barrier. A panel up to ~40 MB
//     stays in the 50 MB L2 between pivots, a larger one streams from HBM.
//     The state that grows with the panel lives in global scratch the
//     wrapper allocates, so no panel size is refused. Batched panels take
//     the whole grid in turn.
//
// The choice: resident by the padded shape, on the host. Otherwise, where the
// padded panel fits a cluster, only the cluster kernel is launched; where it
// may not (the true extents live on the device), the cluster kernel and then
// the grid kernel are launched, both read the clamped extents and apply
// fits_cluster, and each panel is eliminated by exactly one of them (the
// other returns at once). Each panel's mode is written to an output word:
// 0 resident, 1 cluster, 2 grid.

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
// complex128 panel of the same bytes). Above it the grid mode (then the only
// other mode) was faster even where the panel would fit (at a 160^2 f64
// bucket and 80 pivots, 0.93 ms against 2.16 ms on an H100); such panels now
// take the cluster mode.
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

// One thread copies `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory with the bulk-copy engine, in requests of
// kBulkChunk bytes that all complete on `bar`. The block must pass a
// __syncthreads() (the barrier's initialisation) before anyone waits on it.
__device__ void bulk_load(void* dst, const void* src, unsigned bytes,
                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// Warp-wide argmax of candidates: every lane ends with the winner (a
// butterfly over a total order, so the lanes agree).
template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, unsigned& key) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const unsigned okey = __shfl_xor_sync(0xffffffffu, key, off);
    if (ranks_above(ov, okey, v, key)) {
      v = ov;
      key = okey;
    }
  }
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
// stored.
template <typename T>
__device__ void resident_pass(T* A, int np, int m, int n,
                              const PassLayout& L, const int* rkey,
                              const int* ckey, const T* x, const T* y,
                              typename Ops<T>::R& bv, unsigned& bkey,
                              bool update, bool leftorth, int pr, int pc) {
  using R = typename Ops<T>::R;
  constexpr int U = kResidentUnroll;
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
                typename Ops<T>::R abstol_s, int mp, int np, int leftorth_i) {
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

__device__ __forceinline__ float shfl_from(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ double shfl_from(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ double2 shfl_from(double2 v, int src) {
  return make_double2(__shfl_sync(0xffffffffu, v.x, src),
                      __shfl_sync(0xffffffffu, v.y, src));
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
                        int leftorth_i) {
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
// Grid mode: one cooperative launch, every block of the grid works on one
// panel at a time (batched panels take the grid in turn).

constexpr int kGridThreads = 1024;
constexpr int kTileCols = 64;      // two 32-lane chunks: 512 B of an f64 row
constexpr int kMaxTileRows = 256;  // rows of a band, chosen per launch
constexpr int kUnroll = 4;         // rows a warp loads before it stores

// Grid-wide barrier on two words {arrived, generation} that the wrapper
// zeroes. Thread 0 of each block fences the block's writes (bar.sync makes
// them visible to it, the fence is cumulative) before it arrives, and fences
// again after the generation moves. The launch is cooperative, so every
// block is resident and the spin ends.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;  // before arriving: only our arrival moves it
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1u) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

// Global scratch of the grid mode, carved from one byte buffer that
// the wrapper allocates (rrlu_scratch_bytes). Nothing here grows the
// per-block shared memory.
template <typename T>
struct GridScratch {
  using R = typename Ops<T>::R;
  T* A;       // (mp, np) work buffer, updated in place
  R* pmax;    // (nbands, np) per-band column max |a|^2 over unpivoted rows
  T* x;       // (mp,) scaled pivot column of the current pivot
  T* y;       // (np,) pivot row of the current pivot
  int* rf;    // (mp,) row unpivoted and inside the true extent
  int* cf;    // (np,) column likewise
  int* rowpos;
  int* rowperm;
  int* colpos;
  int* colperm;
  int* ctrl;  // {stop, pr, pc}: published by block 0, read after a barrier
};

__host__ __device__ inline size_t align_up(size_t b) {
  return (b + 255) & ~(size_t)255;
}

template <typename T>
__host__ __device__ size_t grid_scratch(unsigned char* base, int mp, int np,
                                        int nbands, GridScratch<T>* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += align_up(bytes);
    return p;
  };
  unsigned char* a = take((size_t)mp * np * sizeof(T));
  unsigned char* pm = take((size_t)nbands * np *
                           sizeof(typename Ops<T>::R));
  unsigned char* x = take((size_t)mp * sizeof(T));
  unsigned char* y = take((size_t)np * sizeof(T));
  unsigned char* ints = take((3 * (size_t)mp + 3 * (size_t)np + 4) *
                             sizeof(int));
  if (s) {
    s->A = reinterpret_cast<T*>(a);
    s->pmax = reinterpret_cast<typename Ops<T>::R*>(pm);
    s->x = reinterpret_cast<T*>(x);
    s->y = reinterpret_cast<T*>(y);
    s->rf = reinterpret_cast<int*>(ints);
    s->rowpos = s->rf + mp;
    s->rowperm = s->rowpos + mp;
    s->cf = s->rowperm + mp;
    s->colpos = s->cf + np;
    s->colperm = s->colpos + np;
    s->ctrl = s->colperm + np;
  }
  return off;
}

// Rows per band: the tallest of 256, 128, 64, 32 that still cuts the panel
// into at least one tile per block, so block 0's reduction over bands stays
// short on large panels and small ones still spread over the grid.
inline int band_rows(int mp, int np, int nblocks) {
  const int nc = (np + kTileCols - 1) / kTileCols;
  int tr = kMaxTileRows;
  while (tr > 32 && (long)((mp + tr - 1) / tr) * nc < nblocks) tr >>= 1;
  return tr;
}

// One pass over the tiles a block owns (tile t belongs to block
// t % gridDim.x for the whole elimination, so a block reads back only what it
// wrote itself and plain loads of A are safe). With update set it applies the
// rank-1 Schur update on unpivoted rows x unpivoted columns and stores the
// multipliers (the fused pass of resident_pass); in every case it writes each
// tile column's max |a|^2 over its band's unpivoted rows to pmax. x, y and
// the flags were written by block 0 before the last barrier: they are read
// with __ldcg (L2), never through a possibly stale L1 line.
template <typename T>
__device__ void grid_pass(const T* __restrict__ src, GridScratch<T>& s,
                          int np, int m, int n, int tr, bool update,
                          bool leftorth, int pr, int pc, T* x_s, int* rf_s,
                          T* y_s, int* cf_s, typename Ops<T>::R* red) {
  using R = typename Ops<T>::R;
  constexpr int kWarps = kGridThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = (m + tr - 1) / tr;
  const int nc = (n + kTileCols - 1) / kTileCols;
  for (int t = blockIdx.x; t < nb * nc; t += gridDim.x) {
    const int band = t / nc;
    const int i0 = band * tr;
    const int j0 = (t % nc) * kTileCols;
    const int rows = min(tr, m - i0);
    for (int r = threadIdx.x; r < rows; r += kGridThreads) {
      rf_s[r] = update ? __ldcg(s.rf + i0 + r) : 1;
      x_s[r] = update ? __ldcg(s.x + i0 + r) : Ops<T>::zero();
    }
    for (int c = threadIdx.x; c < kTileCols; c += kGridThreads) {
      const int j = j0 + c;
      cf_s[c] = update && j < n ? __ldcg(s.cf + j) : 0;
      y_s[c] = update && j < n ? __ldcg(s.y + j) : Ops<T>::zero();
    }
    __syncthreads();
    // kUnroll rows of a warp are loaded before any is stored, so each
    // thread keeps 2 * kUnroll loads in flight (a store to A could alias a
    // later load, so the compiler would not hoist them itself).
    R cm[2] = {R(-1), R(-1)};
    for (int r0 = warp; r0 < rows; r0 += kUnroll * kWarps) {
      T a[kUnroll][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWarps;
        // a pivoted row has nothing to update or count, bar row pr's
        // multipliers in the right-orthogonal form
        const bool live = r < rows && (rf_s[r] || i0 + r == pr);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = j0 + h * 32 + lane;
          const size_t e = (size_t)(i0 + r) * np + j;
          a[u][h] = live && j < n ? (update ? s.A[e] : src[e])
                                  : Ops<T>::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWarps;
        const int i = i0 + r;
        if (r >= rows) break;
        const int rf = rf_s[r];
        if (!rf && i != pr) continue;
        const T xi = x_s[r];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = h * 32 + lane;
          const int j = j0 + c;
          if (j >= n) continue;
          const size_t e = (size_t)i * np + j;
          T v = a[u][h];
          if (!update) {
            s.A[e] = v;
          } else if (rf && cf_s[c]) {
            v = Ops<T>::sub(v, Ops<T>::mul(xi, y_s[c]));
            s.A[e] = v;
          } else if (leftorth ? (rf && j == pc) : (i == pr && cf_s[c])) {
            v = leftorth ? xi : y_s[c];
            s.A[e] = v;
          }
          if (rf) cm[h] = nan_max(cm[h], Ops<T>::abs2(v));
        }
      }
    }
    red[warp * kTileCols + lane] = cm[0];
    red[warp * kTileCols + 32 + lane] = cm[1];
    __syncthreads();
    if (threadIdx.x < kTileCols && j0 + (int)threadIdx.x < n) {
      R v = red[threadIdx.x];
      for (int w = 1; w < kWarps; ++w)
        v = nan_max(v, red[w * kTileCols + threadIdx.x]);
      s.pmax[(size_t)band * np + j0 + threadIdx.x] = v;
    }
    __syncthreads();  // the staging and red are reused by the next tile
  }
}

// C is the cluster size of the cluster kernel launched before this one (0:
// none); the panels that fits_cluster gives to it are skipped here.
template <typename T>
__global__ void __launch_bounds__(kGridThreads)
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
                     int leftorth_i, int tr, int C) {
  using R = typename Ops<T>::R;
  constexpr int NT = kGridThreads;
  __shared__ R s_val[33];
  __shared__ int s_pos[33];
  __shared__ T x_s[kMaxTileRows];
  __shared__ int rf_s[kMaxTileRows];
  __shared__ T y_s[kTileCols];
  __shared__ int cf_s[kTileCols];
  __shared__ R red[(NT / 32) * kTileCols];

  const int tid = threadIdx.x;
  const bool lead = blockIdx.x == 0;
  const unsigned int G = gridDim.x;
  const bool leftorth = leftorth_i != 0;
  const int rmax = mp < np ? mp : np;
  const size_t panel = (size_t)mp * np;
  const int nbands = (mp + tr - 1) / tr;
  GridScratch<T> s;
  grid_scratch<T>(scratch, mp, np, nbands, &s);
  const size_t gtid = (size_t)blockIdx.x * NT + tid;
  const size_t gstride = (size_t)G * NT;

  for (int b = 0; b < B; ++b) {
    int m = m_arr ? m_arr[b] : m_s;
    int n = n_arr ? n_arr[b] : n_s;
    int maxrank = maxrank_arr ? maxrank_arr[b] : maxrank_s;
    clamp_extents(mp, np, m, n, maxrank);
    // a panel that fits the cluster launched before this one is its: every
    // block reads the same extents and skips it before any barrier
    if (fits_cluster(m, mp, np, C, (int)sizeof(T))) continue;
    const R reltol = tol_arr ? tol_arr[2 * b] : reltol_s;
    const R abstol = tol_arr ? tol_arr[2 * b + 1] : abstol_s;
    const T* Ain = A_in + b * panel;
    const int nbm = (m + tr - 1) / tr;  // bands this panel's pass writes

    // Set-up: the tiles' owners copy the true extents into the work buffer
    // and write the first column maxima; padding is copied grid-stride (it
    // is never updated, only read by the final gather through L2). Block 0
    // alone writes the permutations and flags until the end of the panel.
    for (size_t e = gtid; e < panel; e += gstride) {
      const int i = (int)(e / np), j = (int)(e % np);
      if (i >= m || j >= n) s.A[e] = Ain[e];
    }
    if (lead) {
      for (int i = tid; i < mp; i += NT) {
        s.rowpos[i] = i;
        s.rowperm[i] = i;
        s.rf[i] = i < m;
      }
      for (int j = tid; j < np; j += NT) {
        s.colpos[j] = j;
        s.colperm[j] = j;
        s.cf[j] = j < n;
      }
      for (int r = tid; r < rmax; r += NT) mags_out[b * rmax + r] = R(0);
    }
    grid_pass<T>(Ain, s, np, m, n, tr, false, leftorth, -1, -1, x_s, rf_s,
                 y_s, cf_s, red);
    grid_sync(bar, G);

    int k = 0;
    R maxerror = R(0);  // block 0's
    R err = Ops<R>::nan();
    while (true) {
      if (lead) {
        // (a)-(d) on one block; the others wait at the barrier. Every
        // argmax is a (value, smallest swapped position) pair, so the
        // winner does not depend on how the panel was cut into tiles.
        bool stop = k >= maxrank;
        int pr = -1, pc = -1;
        if (!stop) {
          R cv = R(-1);
          int cp = kBig;
          for (int j = tid; j < n; j += NT) {
            if (!s.cf[j]) continue;
            R v = R(-1);
            for (int bd = 0; bd < nbm; ++bd)
              v = nan_max(v, __ldcg(s.pmax + (size_t)bd * np + j));
            const int p = s.colpos[j];
            if (ranks_above(v, p, cv, cp)) {
              cv = v;
              cp = p;
            }
          }
          block_argmax<R, NT>(cv, cp, s_val, s_pos);
          if (cv < R(0)) {  // no valid column left: stop with err 0
            err = R(0);
            stop = true;
          } else {
            const int bestcolpos = cp;
            pc = s.colperm[bestcolpos];
            R rv = R(-1);
            int rp = kBig;
            for (int i = tid; i < m; i += NT) {
              if (!s.rf[i]) continue;
              const T a = __ldcg(s.A + (size_t)i * np + pc);
              const R v = Ops<T>::abs2(a);
              const int p = s.rowpos[i];
              if (ranks_above(v, p, rv, rp)) {
                rv = v;
                rp = p;
              }
            }
            block_argmax<R, NT>(rv, rp, s_val, s_pos);
            const int bestrowpos = rp;
            pr = s.rowperm[bestrowpos < mp - 1 ? bestrowpos : mp - 1];
            const R newerr = Ops<R>::sqrt(rv < R(0) ? R(0) : rv);
            stop = k > 0 && (newerr < Ops<R>::mul(reltol, maxerror) ||
                             newerr < abstol);
            stop = stop || rv < R(0) || (newerr == R(0) && k > 0);
            err = newerr;
            if (!stop) {
              __syncthreads();  // every thread has read rowperm[bestrowpos]
              if (tid == 0) {
                const int r_at_k = s.rowperm[k];
                s.rowperm[bestrowpos] = r_at_k;
                s.rowperm[k] = pr;
                s.rowpos[r_at_k] = bestrowpos;
                s.rowpos[pr] = k;
                const int c_at_k = s.colperm[k];
                s.colperm[bestcolpos] = c_at_k;
                s.colperm[k] = pc;
                s.colpos[c_at_k] = bestcolpos;
                s.colpos[pc] = k;
                // only the pivot's row and column leave the unpivoted set
                s.rf[pr] = 0;
                s.cf[pc] = 0;
                mags_out[b * rmax + k] = newerr;
              }
              maxerror = nan_max(maxerror, newerr);
              __syncthreads();
              const T piv = __ldcg(s.A + (size_t)pr * np + pc);
              const T safe = Ops<T>::nonzero(piv) ? piv : Ops<T>::one();
              for (int i = tid; i < m; i += NT) {
                const T a = __ldcg(s.A + (size_t)i * np + pc);
                s.x[i] = s.rf[i] ? (leftorth ? Ops<T>::div(a, safe) : a)
                                 : Ops<T>::zero();
              }
              for (int j = tid; j < n; j += NT) {
                const T a = __ldcg(s.A + (size_t)pr * np + j);
                s.y[j] = s.cf[j] ? (leftorth ? a : Ops<T>::div(a, safe))
                                 : Ops<T>::zero();
              }
            }
          }
        }
        if (tid == 0) {
          s.ctrl[0] = stop;
          s.ctrl[1] = pr;
          s.ctrl[2] = pc;
          if (stop) {
            k_out[b] = k;
            err_out[b] = err;
            mode_out[b] = 2;
          }
        }
      }
      grid_sync(bar, G);
      // One word written before the barrier decides for every block, so all
      // take the same branch and meet at the same barriers.
      if (__ldcg(s.ctrl)) break;
      const int pr = __ldcg(s.ctrl + 1);
      const int pc = __ldcg(s.ctrl + 2);
      grid_pass<T>(Ain, s, np, m, n, tr, true, leftorth, pr, pc, x_s, rf_s,
                   y_s, cf_s, red);
      grid_sync(bar, G);
      ++k;
    }

    // The swapped-layout gather, spread over the grid; the work buffer and
    // the permutations were written by other blocks, so they come from L2.
    for (size_t i = gtid; i < (size_t)mp; i += gstride)
      rowperm_out[b * mp + i] = __ldcg(s.rowperm + i);
    for (size_t j = gtid; j < (size_t)np; j += gstride)
      colperm_out[b * np + j] = __ldcg(s.colperm + j);
    T* out = A_sw + b * panel;
    for (size_t e = gtid; e < panel; e += gstride) {
      const int i = (int)(e / np), j = (int)(e % np);
      out[e] = __ldcg(s.A + (size_t)__ldcg(s.rowperm + i) * np +
                      __ldcg(s.colperm + j));
    }
    grid_sync(bar, G);  // the next panel reuses the scratch
  }
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
// kernel's dynamic shared-memory limit, and the cluster kernel's (with
// clusters above the portable 8 CTAs allowed).
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

// Blocks of the grid mode: as many as can be resident at once (the
// cooperative launch refuses more), but no more than the panel has tiles.
template <typename T>
int grid_shape(int mp, int np, int* G, int* tr) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rrlu_grid_kernel<T>, kGridThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long tiles = (long)((mp + 31) / 32) * ((np + kTileCols - 1) / kTileCols);
  long g = (long)sms * per_sm;
  if (g > tiles) g = tiles;
  if (g < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G = (int)g;
  *tr = band_rows(mp, np, *G);
  return 0;
}

template <typename T>
long long scratch_bytes(int mp, int np, int C) {
  if (host_mode<T>(mp, np, C) < 2) return 0;
  int G = 0, tr = 0;
  const int rc = grid_shape<T>(mp, np, &G, &tr);
  if (rc != 0) return -(long long)rc;
  return (long long)grid_scratch<T>(nullptr, mp, np, (mp + tr - 1) / tr,
                                    nullptr);
}

template <typename T>
int launch(const void* A_in, void* scratch, void* bar, void* A_sw,
           void* rowperm, void* colperm, void* mags, void* k_out,
           void* err_out, void* mode_out, const void* m_arr,
           const void* n_arr, const void* maxrank_arr, const void* tol_arr,
           int m, int n, int maxrank, double reltol, double abstol, int B,
           int mp, int np, int leftorth, int C, void* stream) {
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
        at, mp, np, leftorth);
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
                           at, mp, np, leftorth);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess || mode == 1) return (int)e;
  }
  // mode 2 or 3: the grid kernel, for what the cluster kernel left
  if (scratch == nullptr || bar == nullptr) return (int)cudaErrorInvalidValue;
  int G = 0, tr = 0;
  int rc = grid_shape<T>(mp, np, &G, &tr);
  if (rc != 0) return rc;
  unsigned char* scr = (unsigned char*)scratch;
  unsigned int* br = (unsigned int*)bar;
  int Cg = mode == 2 ? C : 0;
  void* args[] = {&a_in, &scr, &br, &a_sw, &rp, &cp, &mg, &ko, &eo, &mo,
                  &ma, &na, &ra, &ta, &m, &n, &maxrank, &rt, &at,
                  &B, &mp, &np, &leftorth, &tr, &Cg};
  e = cudaLaunchCooperativeKernel((const void*)rrlu_grid_kernel<T>, dim3(G),
                                  dim3(kGridThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
// element size is none of the three. The wrapper allocates it, and a zeroed
// pair of 32-bit words for the grid barrier.
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

// B panels of (mp, np), contiguous. Per-panel sizes, rank caps and
// tolerances come from the device arrays m_arr, n_arr, maxrank_arr ((B,)
// int32) and tol_arr ((B, 2): reltol, abstol) when they are not null, and
// from the scalar arguments otherwise; the kernels clamp them to the panel,
// so the caller need not read them back to check them. C is the cluster
// size from rrlu_cluster_size (0: no cluster kernel); mode_out ((B,) int64)
// receives each panel's mode. Returns the launches' CUDA error code (0 on
// success).
#define RRLU_LAUNCH(NAME, T)                                                  \
  int NAME(const void* A_in, void* scratch, void* bar, void* A_sw,           \
           void* rowperm, void* colperm, void* mags, void* k_out,            \
           void* err_out, void* mode_out, const void* m_arr,                 \
           const void* n_arr, const void* maxrank_arr, const void* tol_arr,  \
           int m, int n, int maxrank, double reltol, double abstol, int B,   \
           int mp, int np, int leftorth, int C, void* stream) {              \
    return launch<T>(A_in, scratch, bar, A_sw, rowperm, colperm, mags,       \
                     k_out, err_out, mode_out, m_arr, n_arr, maxrank_arr,    \
                     tol_arr, m, n, maxrank, reltol, abstol, B, mp, np,      \
                     leftorth, C, stream);                                   \
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
#endif

}  // extern "C"
