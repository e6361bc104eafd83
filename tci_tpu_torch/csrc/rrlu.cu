// Complete-pivot rank-revealing LU of zero-padded panels, one thread block
// per panel.
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
//     the winner never depends on thread timing;
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
// What bounds it on an H100: every pivot streams the whole trailing matrix
// once (read + write, m * n * 16 bytes per step in f64), so the kernel is
// memory-bound. A panel that fits in shared memory (a 128 x 128 f64 bucket
// is 128 KB of the 227 KB a block may use) is loaded once and eliminated
// there: device memory sees one read and one write of the panel in all.
// Larger panels (the N = 1000 / 2000 rrlu calls) are updated in place in a
// global-memory work buffer by one block, which uses a single SM's share of
// the memory bandwidth; spreading such panels over many blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Ops;

template <>
struct Ops<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double nan() { return __longlong_as_double(0x7ff8000000000000ULL); }
};

template <>
struct Ops<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
};

constexpr int kBig = 1 << 30;  // "no position" (the TPU kernel's BIG)
constexpr int kResidentThreads = 256;
constexpr int kStreamThreads = 1024;
// Dynamic shared memory a block may request on sm_90, less room for the
// kernel's static shared memory.
constexpr size_t kSmemLimit = 232448 - 2048;

template <typename T>
__device__ __forceinline__ bool better(T v, int p, T bv, int bp) {
  return v > bv || (v == bv && p < bp);
}

// Block-wide argmax over (value, position) pairs: the largest value wins,
// ties go to the smallest position. Every thread returns the winner.
template <typename T, int NT>
__device__ void block_argmax(T& val, int& pos, T* s_val, int* s_pos) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T v = __shfl_down_sync(0xffffffffu, val, off);
    const int p = __shfl_down_sync(0xffffffffu, pos, off);
    if (better(v, p, val, pos)) {
      val = v;
      pos = p;
    }
  }
  if (lane == 0) {
    s_val[warp] = val;
    s_pos[warp] = pos;
  }
  __syncthreads();
  if (warp == 0) {
    val = lane < kWarps ? s_val[lane] : T(-1);
    pos = lane < kWarps ? s_pos[lane] : kBig;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T v = __shfl_down_sync(0xffffffffu, val, off);
      const int p = __shfl_down_sync(0xffffffffu, pos, off);
      if (better(v, p, val, pos)) {
        val = v;
        pos = p;
      }
    }
    if (lane == 0) {
      s_val[32] = val;
      s_pos[32] = pos;
    }
  }
  __syncthreads();
  val = s_val[32];
  pos = s_pos[32];
  __syncthreads();  // the scratch is reused by the next reduction
}

// One pass over the true extents of the panel. Columns go to lanes (so a
// warp reads 32 neighbouring entries of a row), rows are split over the R
// warps that share a 32-column chunk. With update set, the pass applies the
// rank-1 Schur update on unpivoted rows x unpivoted columns and stores the
// multipliers; in every case it leaves each column's max |a|^2 over the
// unpivoted rows in colmax.
template <typename T, int NT>
__device__ void panel_pass(T* A, int np, int m, int n, const int* rflag,
                           const int* cflag, const T* x, const T* y, T* colmax,
                           T* red, bool update, bool leftorth, int pr, int pc) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunks = (n + 31) >> 5;
  int R = kWarps / nchunks;
  if (R < 1) R = 1;
  const int cstride = kWarps / R;
  const int wchunk = warp / R;
  const int wsub = warp % R;
  for (int c = wchunk; c < nchunks; c += cstride) {
    const int j = c * 32 + lane;
    T cm = T(-1);
    if (j < n) {
      const int cf = cflag[j];
      const T yj = y[j];
      for (int i = wsub; i < m; i += R) {
        T* p = A + (size_t)i * np + j;
        const int rf = rflag[i];
        T a = *p;
        if (update) {
          if (rf && cf) {
            a = Ops<T>::sub(a, Ops<T>::mul(x[i], yj));
            *p = a;
          } else if (leftorth ? (rf && j == pc) : (i == pr && cf)) {
            a = leftorth ? x[i] : yj;
            *p = a;
          }
        }
        if (rf) {
          const T sq = Ops<T>::mul(a, a);
          cm = sq > cm ? sq : cm;
        }
      }
    }
    if (R == 1) {
      if (j < n) colmax[j] = cm;
    } else {
      red[warp * 32 + lane] = cm;
    }
  }
  __syncthreads();
  if (R > 1) {
    for (int t = threadIdx.x; t < nchunks * 32; t += NT) {
      const int c = t >> 5;
      const int l = t & 31;
      T cm = red[(c * R) * 32 + l];
      for (int r = 1; r < R; ++r) {
        const T v = red[(c * R + r) * 32 + l];
        cm = v > cm ? v : cm;
      }
      if (c * 32 + l < n) colmax[c * 32 + l] = cm;
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int mp, int np, bool resident, int nthreads) {
  size_t bytes = resident ? (size_t)mp * np * sizeof(T) : 0;
  bytes += ((size_t)np /*colmax*/ + mp /*x*/ + np /*y*/ + nthreads /*red*/) *
           sizeof(T);
  bytes += (3 * (size_t)mp + 3 * (size_t)np) * sizeof(int);
  return bytes;
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT)
    rrlu_kernel(const T* __restrict__ A_in, T* A_work, T* __restrict__ A_sw,
                int64_t* __restrict__ rowperm_out,
                int64_t* __restrict__ colperm_out, T* __restrict__ mags_out,
                int64_t* __restrict__ k_out, T* __restrict__ err_out,
                const int* m_arr, const int* n_arr, const int* maxrank_arr,
                const T* tol_arr, int m_s, int n_s, int maxrank_s, T reltol_s,
                T abstol_s, int mp, int np, int leftorth_i, int resident) {
  __shared__ T s_val[33];
  __shared__ int s_pos[33];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = m_arr ? m_arr[b] : m_s;
  const int n = n_arr ? n_arr[b] : n_s;
  const int maxrank = maxrank_arr ? maxrank_arr[b] : maxrank_s;
  const T reltol = tol_arr ? tol_arr[2 * b] : reltol_s;
  const T abstol = tol_arr ? tol_arr[2 * b + 1] : abstol_s;
  const bool leftorth = leftorth_i != 0;
  const int rmax = mp < np ? mp : np;
  const size_t panel = (size_t)mp * np;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tbase = reinterpret_cast<T*>(smem_raw);
  T* A = resident ? tbase : A_work + b * panel;
  T* colmax = tbase + (resident ? panel : 0);
  T* x = colmax + np;
  T* y = x + mp;
  T* red = y + np;
  int* rowpos = reinterpret_cast<int*>(red + NT);
  int* rowperm = rowpos + mp;
  int* rflag = rowperm + mp;
  int* colpos = rflag + mp;
  int* colperm = colpos + np;
  int* cflag = colperm + np;

  const T* Ain = A_in + b * panel;
  for (size_t e = tid; e < panel; e += NT) A[e] = Ain[e];
  for (int i = tid; i < mp; i += NT) {
    rowpos[i] = i;
    rowperm[i] = i;
    rflag[i] = i < m;
  }
  for (int j = tid; j < np; j += NT) {
    colpos[j] = j;
    colperm[j] = j;
    cflag[j] = 0;
    y[j] = T(0);
  }
  for (int r = tid; r < rmax; r += NT) mags_out[b * rmax + r] = T(0);
  __syncthreads();
  panel_pass<T, NT>(A, np, m, n, rflag, cflag, x, y, colmax, red, false,
                    leftorth, -1, -1);

  int k = 0;
  T maxerror = T(0);
  T err = Ops<T>::nan();
  while (k < maxrank) {
    // pivot column: max cached colmax over valid columns
    T cv = T(-1);
    int cp = kBig;
    for (int j = tid; j < n; j += NT) {
      const int p = colpos[j];
      if (p >= k && better(colmax[j], p, cv, cp)) {
        cv = colmax[j];
        cp = p;
      }
    }
    block_argmax<T, NT>(cv, cp, s_val, s_pos);
    if (cv < T(0)) {  // no valid column left: stop with err 0
      err = T(0);
      break;
    }
    const int bestcolpos = cp;
    const int pc = colperm[bestcolpos];

    // pivot row within column pc
    T rv = T(-1);
    int rp = kBig;
    for (int i = tid; i < m; i += NT) {
      const int p = rowpos[i];
      if (p >= k) {
        const T a = A[(size_t)i * np + pc];
        const T v = Ops<T>::mul(a, a);
        if (better(v, p, rv, rp)) {
          rv = v;
          rp = p;
        }
      }
    }
    block_argmax<T, NT>(rv, rp, s_val, s_pos);
    const T Mr = rv;
    const int bestrowpos = rp;
    const int pr = rowperm[bestrowpos < mp - 1 ? bestrowpos : mp - 1];
    const T newerr = Ops<T>::sqrt(Mr > T(0) ? Mr : T(0));

    bool stop = k > 0 && (newerr < Ops<T>::mul(reltol, maxerror) ||
                          newerr < abstol);
    stop = stop || Mr < T(0) || (newerr == T(0) && k > 0);
    err = newerr;
    if (stop) break;  // block-uniform: every thread saw the same values

    // Every thread has read rowperm[bestrowpos] (pr) before thread 0
    // overwrites that slot below.
    __syncthreads();
    if (tid == 0) {
      const int r_at_k = rowperm[k];
      rowperm[bestrowpos] = r_at_k;
      rowperm[k] = pr;
      rowpos[r_at_k] = bestrowpos;
      rowpos[pr] = k;
      const int c_at_k = colperm[k];
      colperm[bestcolpos] = c_at_k;
      colperm[k] = pc;
      colpos[c_at_k] = bestcolpos;
      colpos[pc] = k;
      mags_out[b * rmax + k] = newerr;
    }
    maxerror = newerr > maxerror ? newerr : maxerror;
    __syncthreads();

    const T piv = A[(size_t)pr * np + pc];
    const T safe = piv != T(0) ? piv : T(1);
    for (int i = tid; i < mp; i += NT) {
      const int rf = rowpos[i] >= k + 1 && i < m;
      rflag[i] = rf;
      const T a = A[(size_t)i * np + pc];
      x[i] = rf ? (leftorth ? Ops<T>::div(a, safe) : a) : T(0);
    }
    for (int j = tid; j < np; j += NT) {
      const int cf = colpos[j] >= k + 1 && j < n;
      cflag[j] = cf;
      const T a = A[(size_t)pr * np + j];
      y[j] = cf ? (leftorth ? a : Ops<T>::div(a, safe)) : T(0);
    }
    __syncthreads();
    panel_pass<T, NT>(A, np, m, n, rflag, cflag, x, y, colmax, red, true,
                      leftorth, pr, pc);
    ++k;
  }

  if (tid == 0) {
    k_out[b] = k;
    err_out[b] = err;
  }
  for (int i = tid; i < mp; i += NT) rowperm_out[b * mp + i] = rowperm[i];
  for (int j = tid; j < np; j += NT) colperm_out[b * np + j] = colperm[j];
  T* out = A_sw + b * panel;
  for (size_t e = tid; e < panel; e += NT) {
    const int i = (int)(e / np);
    const int j = (int)(e % np);
    out[e] = A[(size_t)rowperm[i] * np + colperm[j]];
  }
}

template <typename T>
bool is_resident(int mp, int np) {
  return smem_bytes<T>(mp, np, true, kResidentThreads) <= kSmemLimit;
}

template <typename T, int NT>
int launch_nt(const void* A_in, void* A_work, void* A_sw, void* rowperm,
              void* colperm, void* mags, void* k_out, void* err_out,
              const void* m_arr, const void* n_arr, const void* maxrank_arr,
              const void* tol_arr, int m, int n, int maxrank, double reltol,
              double abstol, int B, int mp, int np, int leftorth,
              int resident, void* stream) {
  const size_t smem = smem_bytes<T>(mp, np, resident != 0, NT);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rrlu_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  rrlu_kernel<T, NT><<<B, NT, smem, (cudaStream_t)stream>>>(
      (const T*)A_in, (T*)A_work, (T*)A_sw, (int64_t*)rowperm,
      (int64_t*)colperm, (T*)mags, (int64_t*)k_out, (T*)err_out,
      (const int*)m_arr, (const int*)n_arr, (const int*)maxrank_arr,
      (const T*)tol_arr, m, n, maxrank, (T)reltol, (T)abstol, mp, np,
      leftorth, resident);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A_in, void* A_work, void* A_sw, void* rowperm,
           void* colperm, void* mags, void* k_out, void* err_out,
           const void* m_arr, const void* n_arr, const void* maxrank_arr,
           const void* tol_arr, int m, int n, int maxrank, double reltol,
           double abstol, int B, int mp, int np, int leftorth, void* stream) {
  if (B <= 0 || mp <= 0 || np <= 0) return (int)cudaErrorInvalidValue;
  if (is_resident<T>(mp, np)) {
    return launch_nt<T, kResidentThreads>(
        A_in, A_work, A_sw, rowperm, colperm, mags, k_out, err_out, m_arr,
        n_arr, maxrank_arr, tol_arr, m, n, maxrank, reltol, abstol, B, mp, np,
        leftorth, 1, stream);
  }
  if (A_work == nullptr) return (int)cudaErrorInvalidValue;
  return launch_nt<T, kStreamThreads>(
      A_in, A_work, A_sw, rowperm, colperm, mags, k_out, err_out, m_arr, n_arr,
      maxrank_arr, tol_arr, m, n, maxrank, reltol, abstol, B, mp, np, leftorth,
      0, stream);
}

}  // namespace

extern "C" {

// 1 when an (mp, np) panel of elements of `elsize` bytes is eliminated in
// shared memory; 0 when the caller must pass a global work buffer.
int rrlu_panel_resident(int mp, int np, int elsize) {
  return elsize == 8 ? (int)is_resident<double>(mp, np)
                     : (int)is_resident<float>(mp, np);
}

// B panels of (mp, np), contiguous. Per-panel sizes, rank caps and
// tolerances come from the device arrays m_arr, n_arr, maxrank_arr ((B,)
// int32) and tol_arr ((B, 2): reltol, abstol) when they are not null, and
// from the scalar arguments otherwise. Returns cudaGetLastError() of the
// launch (0 on success).
int rrlu_launch_f64(const void* A_in, void* A_work, void* A_sw, void* rowperm,
                    void* colperm, void* mags, void* k_out, void* err_out,
                    const void* m_arr, const void* n_arr,
                    const void* maxrank_arr, const void* tol_arr, int m, int n,
                    int maxrank, double reltol, double abstol, int B, int mp,
                    int np, int leftorth, void* stream) {
  return launch<double>(A_in, A_work, A_sw, rowperm, colperm, mags, k_out,
                        err_out, m_arr, n_arr, maxrank_arr, tol_arr, m, n,
                        maxrank, reltol, abstol, B, mp, np, leftorth, stream);
}

int rrlu_launch_f32(const void* A_in, void* A_work, void* A_sw, void* rowperm,
                    void* colperm, void* mags, void* k_out, void* err_out,
                    const void* m_arr, const void* n_arr,
                    const void* maxrank_arr, const void* tol_arr, int m, int n,
                    int maxrank, double reltol, double abstol, int B, int mp,
                    int np, int leftorth, void* stream) {
  return launch<float>(A_in, A_work, A_sw, rowperm, colperm, mags, k_out,
                       err_out, m_arr, n_arr, maxrank_arr, tol_arr, m, n,
                       maxrank, reltol, abstol, B, mp, np, leftorth, stream);
}

}  // extern "C"
