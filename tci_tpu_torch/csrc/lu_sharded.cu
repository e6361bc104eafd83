// One rank's local step of the row-sharded complete-pivot rank-revealing LU.
//
// Replaces the per-device body of tci_tpu/ops/lu_sharded.py::_make_state_fn
// (the XLA while loop that rrlu_sharded_raw and make_lu_split_sharded run
// inside shard_map). The panel's rows are cut into P contiguous blocks, one
// per rank of a torch.distributed group; every rank holds its block and a
// replicated copy of the permutations and of the elimination's scalars.
// One pivot step is three launches of this file's kernels with a collective
// after each, all on one stream, with no read by the host:
//
//   pick   (one block) the pivot column: the largest global column maximum
//          over the unpivoted valid columns, ties to the smallest swapped
//          position; then this rank's rows of that column: it saves the
//          column (x) and writes its first row, by swapped position, whose
//          |a|^2 equals the column's global maximum (or "none");
//   -> MIN all-reduce of that position: the reference's first occurrence;
//   swap   (one block) the stop test of matrixlu.jl:363, the virtual swaps
//          of the replicated permutations, the pivot row into a buffer
//          (the owner copies its row, every other rank writes zeros), and
//          the column maxima reset to "none";
//   -> SUM all-reduce of the pivot row's bits: one owner, so exact;
//   update (a grid) the rank-1 Schur update a - x y of the unpivoted valid
//          part of this rank's block, the multipliers stored (pivot column
//          when left-orthogonal, pivot row otherwise), and in the same
//          pass this rank's column maxima of |a|^2 for the next step;
//   -> MAX all-reduce of those maxima.
//
// The column maxima travel as integer keys (Key below): the bits of a
// metric, NaN made the positive quiet NaN, compared as signed integers. A
// metric is >= 0, -1 ("no valid row") or NaN, so the integer MAX is exact
// and ranks NaN above every value, as rrlu.cu's ranks_above does; the
// collectives never see a float. Every element is computed with
// lu_common.cuh's intrinsics (no FMA contraction), in rrlu.cu's formulas,
// so each rank rounds exactly as the one-device kernel and the plain
// PyTorch version (tci_tpu_torch/ops/lu_sharded.py) do: the pivot order,
// the pivot count, err and the factored buffer are bitwise theirs.
//
// Once the stop test fires, the swap kernel sets a flag in the replicated
// state and every later launch returns at once; the host reads the flag
// only now and then (ops/lu_sharded.py: CHECK_EVERY), so the steps are
// queued ahead of the device.
//
// Bound: the update reads and writes the rank's unpivoted block once a
// step, (m_blk - j)(n - j) elements at step j (8 bytes each way in f64),
// against 2 (m_blk - j)(n - j) operations (8 in complex128): on an H100
// (3.35 TB/s, 34 TFLOP/s f64) it is memory bound at every size. The pick and the swap touch one column and
// one row. The design streams the block once a step: a thread owns a
// column and walks its rows in groups of four loads, so each warp reads
// and writes 32 neighbouring elements of a row; the column maxima leave
// each block as one integer atomicMax a column. What is left above the
// bound is the per-step chain: three launches and three collectives.

#include <algorithm>

#include "lu_common.cuh"

namespace {

template <typename R>
struct Key;

template <>
struct Key<double> {
  using I = long long;
  __device__ static I of(double v) {
    return v != v ? 0x7ff8000000000000LL : __double_as_longlong(v);
  }
  __device__ static double value(I k) { return __longlong_as_double(k); }
};

template <>
struct Key<float> {
  using I = int;
  __device__ static I of(float v) { return v != v ? 0x7fc00000 : __float_as_int(v); }
  __device__ static float value(I k) { return __int_as_float(k); }
};

// the replicated integer state (ist) and real state (rst)
enum { kK = 0, kDone = 1, kBestCol = 2, kPc = 3, kPr = 4 };
enum { kM = 0, kMaxErr = 1, kErr = 2 };

constexpr int kOneBlock = 1024;    // threads of the pick and swap kernels
constexpr int kUpdateThreads = 256;
constexpr int kRowGroup = 4;       // rows a thread loads before it stores

struct Step {
  void* A;        // this rank's (m_blk, np) block, row-major
  void* xcol;     // (m_blk,) the pivot column of the block, before the update
  void* rowbuf;   // (np,) the pivot row
  void* colkey;   // (np,) the column maxima's keys
  int* rowperm;   // (mp,) position -> row, replicated
  int* rowpos;    // (mp,) row -> position
  int* colperm;   // (np,)
  int* colpos;    // (np,)
  int* pos;       // (1,) this rank's candidate position, then the global one
  int* ist;       // k, done, best column position, pc, pr
  void* rst;      // M (the pivot's |a|^2), the largest pivot so far, err
  void* mags;     // (min(mp, np),) pivot magnitudes
  int m_blk, np, mp, offset, m, n, leftorth;
  double reltol, abstol;
};

template <typename T>
__global__ void __launch_bounds__(kOneBlock) pick_kernel(Step s) {
  using R = typename Ops<T>::R;
  using K = Key<R>;
  __shared__ R s_val[33];
  __shared__ int s_pos[33];
  if (s.ist[kDone]) return;
  const int k = s.ist[kK];
  const auto* colkey = static_cast<const typename K::I*>(s.colkey);
  R best = R(-1);
  int bpos = kBig;
  const int nc = min(s.n, s.np);
  for (int j = threadIdx.x; j < nc; j += blockDim.x) {
    const int p = s.colpos[j];
    if (p >= k) {
      const R v = K::value(colkey[j]);
      if (ranks_above(v, p, best, bpos)) {
        best = v;
        bpos = p;
      }
    }
  }
  block_argmax<R, kOneBlock>(best, bpos, s_val, s_pos);
  const R M = best;
  const int bcp = min(bpos, s.np - 1);
  const int pc = s.colperm[bcp];
  const T* A = static_cast<const T*>(s.A);
  T* xcol = static_cast<T*>(s.xcol);
  R rv = R(-1);
  int rp = kBig;
  for (int i = threadIdx.x; i < s.m_blk; i += blockDim.x) {
    const T a = A[(size_t)i * s.np + pc];
    xcol[i] = a;
    const int gid = s.offset + i;
    if (gid < s.m) {
      const int p = s.rowpos[gid];
      const R v = Ops<T>::abs2(a);
      if (p >= k && ranks_above(v, p, rv, rp)) {
        rv = v;
        rp = p;
      }
    }
  }
  block_argmax<R, kOneBlock>(rv, rp, s_val, s_pos);
  if (threadIdx.x == 0) {
    const bool same = rv == M || (rv != rv && M != M);
    s.pos[0] = same ? rp : kBig;
    s.ist[kBestCol] = bcp;
    s.ist[kPc] = pc;
    static_cast<R*>(s.rst)[kM] = M;
  }
}

template <typename T>
__global__ void __launch_bounds__(kOneBlock) swap_kernel(Step s) {
  using R = typename Ops<T>::R;
  using K = Key<R>;
  if (s.ist[kDone]) return;
  R* rst = static_cast<R*>(s.rst);
  const int k = s.ist[kK];
  const R M = rst[kM];
  const R maxerror = rst[kMaxErr];
  const int brp = min(s.pos[0], s.mp - 1);
  const int pr = s.rowperm[brp];
  const int bcp = s.ist[kBestCol];
  const int pc = s.ist[kPc];
  __syncthreads();  // every thread has read the state before it changes
  if (M < R(0)) {
    // no valid column left: stop with err 0, as the one-device kernel does
    if (threadIdx.x == 0) {
      rst[kErr] = R(0);
      s.ist[kDone] = 1;
    }
    return;
  }
  // M >= 0 or NaN, so sqrt(max(M, 0)) is sqrt(M)
  const R newerr = Ops<R>::sqrt(M);
  const bool stop = k > 0 && (newerr < Ops<R>::mul(R(s.reltol), maxerror) ||
                              newerr < R(s.abstol) || newerr == R(0));
  if (stop) {
    if (threadIdx.x == 0) {
      rst[kErr] = newerr;
      s.ist[kDone] = 1;
    }
    return;
  }
  if (threadIdx.x == 0) {
    const int r_at_k = s.rowperm[k];
    s.rowperm[brp] = r_at_k;
    s.rowperm[k] = pr;
    s.rowpos[r_at_k] = brp;
    s.rowpos[pr] = k;
    const int c_at_k = s.colperm[k];
    s.colperm[bcp] = c_at_k;
    s.colperm[k] = pc;
    s.colpos[c_at_k] = bcp;
    s.colpos[pc] = k;
    static_cast<R*>(s.mags)[k] = newerr;
    rst[kMaxErr] = nan_max(maxerror, newerr);
    rst[kErr] = newerr;
    s.ist[kPr] = pr;
    s.ist[kK] = k + 1;
  }
  const bool owner = pr >= s.offset && pr < s.offset + s.m_blk;
  const T* row = static_cast<const T*>(s.A) + (size_t)(owner ? pr - s.offset : 0) * s.np;
  T* rowbuf = static_cast<T*>(s.rowbuf);
  auto* colkey = static_cast<typename K::I*>(s.colkey);
  for (int j = threadIdx.x; j < s.np; j += blockDim.x) {
    rowbuf[j] = owner ? row[j] : Ops<T>::zero();
    colkey[j] = K::of(R(-1));
  }
}

// The update of one step (Init = false) or, before the first step, the
// column maxima of the valid block alone (Init = true). Block (x, y) takes
// kUpdateThreads columns and every gridDim.y-th row.
template <typename T, bool Init>
__global__ void __launch_bounds__(kUpdateThreads) update_kernel(Step s) {
  using R = typename Ops<T>::R;
  using K = Key<R>;
  if (!Init && s.ist[kDone]) return;
  const int k = Init ? 0 : s.ist[kK];
  const int pc = Init ? -1 : s.ist[kPc];
  const int pr = Init ? -1 : s.ist[kPr];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool col_live = j < min(s.n, s.np) && (Init || s.colpos[j] >= k);
  const bool lo = s.leftorth != 0;
  T* A = static_cast<T*>(s.A);
  const T* xcol = static_cast<const T*>(s.xcol);
  T safe = Ops<T>::one(), y = Ops<T>::zero();
  if (!Init) {
    const T* rowbuf = static_cast<const T*>(s.rowbuf);
    const T piv = rowbuf[pc];
    if (Ops<T>::nonzero(piv)) safe = piv;
    if (j < s.np) y = lo ? rowbuf[j] : Ops<T>::div(rowbuf[j], safe);
  }
  R cmax = R(-1);
  const int step = gridDim.y;
  for (int i0 = blockIdx.y; i0 < s.m_blk; i0 += kRowGroup * step) {
    T a[kRowGroup];
    bool live[kRowGroup];
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) {
      const int i = i0 + u * step;
      const int gid = s.offset + i;
      live[u] = i < s.m_blk && gid < s.m && (Init || s.rowpos[gid] >= k);
      if (live[u] && col_live) a[u] = A[(size_t)i * s.np + j];
    }
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) {
      const int i = i0 + u * step;
      if (Init) {
        if (live[u] && col_live) cmax = nan_max(cmax, Ops<T>::abs2(a[u]));
        continue;
      }
      if (i >= s.m_blk) continue;
      if (!lo && s.offset + i == pr) {
        // the right multipliers: the pivot row divided by the pivot
        if (col_live) A[(size_t)i * s.np + j] = y;
        continue;
      }
      if (!live[u] || !(col_live || (lo && j == pc))) continue;
      const T x = lo ? Ops<T>::div(xcol[i], safe) : xcol[i];
      if (lo && j == pc) A[(size_t)i * s.np + pc] = x;
      if (col_live) {
        const T v = Ops<T>::sub(a[u], Ops<T>::mul(x, y));
        A[(size_t)i * s.np + j] = v;
        cmax = nan_max(cmax, Ops<T>::abs2(v));
      }
    }
  }
  if (col_live) atomicMax(static_cast<typename K::I*>(s.colkey) + j, K::of(cmax));
}

template <typename T>
int launch(int phase, const Step& s, int sms, cudaStream_t stream) {
  if (phase == 1) {
    pick_kernel<T><<<1, kOneBlock, 0, stream>>>(s);
  } else if (phase == 2) {
    swap_kernel<T><<<1, kOneBlock, 0, stream>>>(s);
  } else {
    // the columns up to n (the left multipliers' column pc is one of them),
    // and enough row groups for about eight blocks an SM
    const int ncols = std::max(std::min(s.n, s.np), 1);
    const int gx = (ncols + kUpdateThreads - 1) / kUpdateThreads;
    const int rows = (s.m_blk + kRowGroup - 1) / kRowGroup;
    const int gy = std::max(1, std::min(rows, (8 * sms + gx - 1) / gx));
    const dim3 grid(gx, gy);
    if (phase == 0) {
      update_kernel<T, true><<<grid, kUpdateThreads, 0, stream>>>(s);
    } else {
      update_kernel<T, false><<<grid, kUpdateThreads, 0, stream>>>(s);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of phase 0 (the first column maxima), 1 (pick), 2 (swap) or 3
// (update) on `stream`, for elements of type 0 float32, 1 float64, 2
// complex128. Returns the CUDA error of the launch (0 on success).
int lu_sharded_launch(int dtype, int phase, void* A, void* xcol, void* rowbuf,
                      void* colkey, void* rowperm, void* rowpos, void* colperm,
                      void* colpos, void* pos, void* ist, void* rst, void* mags,
                      int m_blk, int np, int mp, int offset, int m, int n,
                      int leftorth, double reltol, double abstol, int sms,
                      void* stream) {
  Step s{A, xcol, rowbuf, colkey, (int*)rowperm, (int*)rowpos, (int*)colperm,
         (int*)colpos, (int*)pos, (int*)ist, rst, mags, m_blk, np, mp, offset,
         m, n, leftorth, reltol, abstol};
  const cudaStream_t st = (cudaStream_t)stream;
  if (phase < 0 || phase > 3) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(phase, s, sms, st);
    case 1: return launch<double>(phase, s, sms, st);
    case 2: return launch<double2>(phase, s, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
