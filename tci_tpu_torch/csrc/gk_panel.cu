// The inputs of a Gauss-Kronrod integrand on one Pi panel: the coordinates
// and the weights of every grid point of the panel, written straight from
// the panel's index sets, designed for Hopper.
//
// Replaces no Pallas kernel. tci_tpu's jax-native integrand
// (tci_tpu/models/integration.py, Fjax) looks the nodes and weights up by
// one-hot contractions inside the XLA program that samples a panel; the
// port first did it with PyTorch operations: the (m n, N) int64 index
// matrix written by two broadcast copies (ops/fused.panel_indices), two
// gathers of it from the (N, K) tables and N - 1 multiplies of strided
// weight columns, about 13 launches that read and write ~0.8 KB a sample at
// N = 10. This kernel writes what the integrand reads and nothing else:
//
//   X[i n + j, d] = nodes[d, t_d],  W[i n + j] = (...((w_0 w_1) w_2) ...) w_{N-1},
//   w_d = weights[d, t_d],  t = [rows[i, :], cols[j, :]]  (nl + nr = N),
//
// for the (m, nl) row and (n, nr) column index sets. The index matrix is
// never formed. Bit for bit the plain version (ops/gk_panel.gk_points_plain):
// a node is copied, and the weight product is taken in the same left-to-right
// order by round-to-nearest multiplies. A row's first nl factors are its
// own, so each block takes that prefix once, starting from 1.0 (1.0 w_0 is
// w_0 exactly), and goes on with each column's factors in order; that is the
// same sequence of roundings.
//
// What bounds it on this card: bytes. The index sets are read once a tile
// and are small (80 KB at the main path's 1024-row sets and N = 10); X and
// W are written once, 8 (N + 1) bytes a sample: 92 MB for a 1024 x 1024
// panel at N = 10, ~27.5 us at 3.35 TB/s (an H100 at 700 W takes 36-38 us,
// tools/gk_panel_ab.py). The lookups are a few hundred operations a block
// on tables of 2 N K doubles (2.4 KB at N = 10, K = 15).
//
// The design, for the store stream:
//
//   - one block a tile of whole samples of one panel row: a run of
//     consecutive columns j whose N-wide rows of X are one contiguous range
//     of X (kTileElems elements, about), so a block's stores are one stream;
//   - X goes out in 16-byte stores (double2), neighbouring threads on
//     neighbouring 16 bytes, a scalar head where the range starts off a
//     16-byte boundary and a scalar tail; each thread walks its elements
//     with a fixed step, carrying (sample, dimension) by one compare, so no
//     element costs a division;
//   - the tables sit in shared memory where they fit beside the row's
//     values (kSmemBytes), else are read through the read-only cache
//     (kShared = false). The copy pays on this card even for 2.4 KB tables
//     that L1 would hold: on an H100 at 700 W, a 1024 x 1024 panel at N =
//     10 takes 37.3 us with them in shared memory against 39.2 through the
//     read-only cache, 512 x 512 11.8 against 12.9, a 960-row index matrix
//     8.1 against 9.1 (medians of 8 runs that spread by 0.4 us or less); the
//     row's nl nodes and its weight prefix are computed once a block into
//     shared memory; a column's indices are read from the read-only cache,
//     each once for X and once more (an L1 hit) for W;
//   - an index is taken as PyTorch takes it: one in [-K, 0) counts from
//     the end of its table row; one outside [-K, K) is clamped, so that it
//     cannot make the kernel read outside the tables, and raises a flag on
//     the device (gk_panel_clamped reads and clears it): the plain version
//     raises for such an index, the kernel writes a clamped sample and
//     says so.
//
// A panel of one column and no column indices (n = 1, nr = 0) is an index
// matrix: the launcher takes its rows as the columns of a one-row panel, so
// a long matrix spreads over many blocks as a wide panel does. The product
// then starts from 1.0 and takes all N factors from the columns, the same
// roundings.
//
// gk_panel_launch returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape it does not take, before any launch).
// gk_panel_clamped(&flag) sets flag to 1 if a launch on the current device
// clamped an index since its last call, else 0, and clears it; it returns
// the error of the copies, which wait for the device.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// elements of X a block writes, about
constexpr int kTileElems = 8192;
// dynamic shared memory a block may take without an attribute
constexpr int kSmemBytes = 48 * 1024;

struct Args {
  const long long* rows;  // (m, nl), row stride row_stride
  const long long* cols;  // (n, nr), row stride col_stride
  const double* nodes;    // (N, K)
  const double* weights;  // (N, K)
  double* X;              // (m n, N)
  double* W;              // (m n,)
  long long row_stride, col_stride;
  int m, nl, n, nr, K;
  int tile_cols, tiles_per_row;
};

template <bool kShared>
__device__ __forceinline__ double table(const double* p) {
  return kShared ? *p : __ldg(p);
}

// 1 once a launch on this device has clamped an index; gk_panel_clamped
// reads and clears it
__device__ int g_clamped = 0;

__device__ __forceinline__ int clamp_index(long long t, int K) {
  if (t >= 0 && t < K) return static_cast<int>(t);
  if (t < 0 && t >= -K) return static_cast<int>(t + K);
  g_clamped = 1;
  return t < 0 ? 0 : K - 1;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) gk_panel_kernel(Args a) {
  extern __shared__ double smem[];
  const int N = a.nl + a.nr, K = a.K, NK = N * K;
  const double* nodes = a.nodes;
  const double* weights = a.weights;
  // the row's nl node values, then its weight prefix
  double* rowx = smem + (kShared ? 2 * NK : 0);
  if (kShared) {
    for (int t = threadIdx.x; t < NK; t += blockDim.x) {
      smem[t] = __ldg(a.nodes + t);
      smem[NK + t] = __ldg(a.weights + t);
    }
    nodes = smem;
    weights = smem + NK;
  }
  const int i = blockIdx.x / a.tiles_per_row;
  const int j0 = (blockIdx.x - i * a.tiles_per_row) * a.tile_cols;
  const int T = min(a.tile_cols, a.n - j0);
  const long long* rowi = a.rows + static_cast<long long>(i) * a.row_stride;
  if (kShared) __syncthreads();
  for (int d = threadIdx.x; d < a.nl; d += blockDim.x)
    rowx[d] = table<kShared>(nodes + d * K + clamp_index(__ldg(rowi + d), K));
  if (threadIdx.x == 0) {
    double w = 1.0;
    for (int d = 0; d < a.nl; ++d)
      w = __dmul_rn(w, table<kShared>(
                           weights + d * K + clamp_index(__ldg(rowi + d), K)));
    rowx[a.nl] = w;
  }
  __syncthreads();

  const long long s0 = static_cast<long long>(i) * a.n + j0;
  const long long* colj = a.cols + static_cast<long long>(j0) * a.col_stride;
  auto value = [&](int s, int d) -> double {
    if (d < a.nl) return rowx[d];
    const long long t = __ldg(colj + s * a.col_stride + (d - a.nl));
    return table<kShared>(nodes + d * K + clamp_index(t, K));
  };

  // X: the tile's T N elements, contiguous from x
  double* x = a.X + s0 * N;
  const int total = T * N;
  const int head = (reinterpret_cast<uintptr_t>(x) & 15u) ? 1 : 0;
  const int npairs = (total - head) / 2;
  const int step = 2 * blockDim.x;
  const int ds = step / N, dd = step - ds * N;
  int e = head + 2 * threadIdx.x;
  int s = e / N, d = e - s * N;
  for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
    int s1 = s, d1 = d + 1;
    if (d1 == N) {
      d1 = 0;
      ++s1;
    }
    *reinterpret_cast<double2*>(x + head + 2 * p) =
        make_double2(value(s, d), value(s1, d1));
    s += ds;
    d += dd;
    if (d >= N) {
      d -= N;
      ++s;
    }
  }
  if (threadIdx.x == 0) {
    if (head) x[0] = value(0, 0);
    if (head + 2 * npairs < total) x[total - 1] = value(T - 1, N - 1);
  }

  // W: the row's prefix times each column's factors, in order
  const double wp = rowx[a.nl];
  for (int c = threadIdx.x; c < T; c += blockDim.x) {
    double w = wp;
    const long long* cj = colj + c * a.col_stride;
    for (int k = 0; k < a.nr; ++k)
      w = __dmul_rn(w, table<kShared>(weights + (a.nl + k) * K +
                                      clamp_index(__ldg(cj + k), K)));
    a.W[s0 + c] = w;
  }
}

}  // namespace

extern "C" {

// The largest N the launcher takes: the row's values live in shared memory.
int gk_panel_max_dims() { return kSmemBytes / 8 - 1; }

int gk_panel_clamped(int* flag) {
  const int zero = 0;
  cudaError_t rc = cudaMemcpyFromSymbol(flag, g_clamped, sizeof(int));
  if (rc == cudaSuccess)
    rc = cudaMemcpyToSymbol(g_clamped, &zero, sizeof(int));
  return static_cast<int>(rc);
}

int gk_panel_launch(const void* rows, long long row_stride, int m, int nl,
                    const void* cols, long long col_stride, int n, int nr,
                    const void* nodes, const void* weights, int K, void* X,
                    void* W, void* stream) {
  const int N = nl + nr;
  if (m < 0 || n < 0 || nl < 0 || nr < 0 || N < 1 || K < 1 ||
      N > gk_panel_max_dims() || static_cast<long long>(N) * K > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  if (n == 1 && nr == 0) {
    // an index matrix: its rows become the columns of a one-row panel
    cols = rows;
    col_stride = row_stride;
    n = m;
    nr = nl;
    m = 1;
    nl = 0;
  }
  const int per_tile = kTileElems / N > 0 ? kTileElems / N : 1;
  const int tiles_per_row = (n + per_tile - 1) / per_tile;
  const int tile_cols = (n + tiles_per_row - 1) / tiles_per_row;
  const long long blocks = static_cast<long long>(m) * tiles_per_row;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const long long*>(rows),
         static_cast<const long long*>(cols),
         static_cast<const double*>(nodes),
         static_cast<const double*>(weights),
         static_cast<double*>(X),
         static_cast<double*>(W),
         row_stride,
         col_stride,
         m,
         nl,
         n,
         nr,
         K,
         tile_cols,
         tiles_per_row};
  const size_t row_bytes = (N + 1) * sizeof(double);
  const size_t table_bytes = 2 * static_cast<size_t>(N) * K * sizeof(double);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_bytes + row_bytes <= kSmemBytes)
    gk_panel_kernel<true><<<static_cast<int>(blocks), kThreads,
                            table_bytes + row_bytes, st>>>(a);
  else
    gk_panel_kernel<false><<<static_cast<int>(blocks), kThreads, row_bytes,
                             st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
