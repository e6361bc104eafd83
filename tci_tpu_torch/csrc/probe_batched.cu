// The batched-grid probe kernels, one thread block per grid program,
// designed for Hopper.
//
// Replaces the six Pallas TPU kernels of benchmarks/probe_pallas_batched.py,
// which bisect the constructs the batched rrLU kernel adds to the
// single-panel one:
//
//   v1  (:47)   a grid whose program b writes row b of a scalar output;
//   v2  (:63)   a scalar read at a program-dependent row of a table;
//   v3  (:81)   a (B, 1, n) blocked vector output written through its row-0
//               view;
//   v4  (:108)  a while loop inside the grid body;
//   v4b (:143)  float32 scalars;
//   v4c (:168)  a read-modify-write of the row inside such a loop.
//
// Each kernel computes exactly what its Pallas body computes, bit for bit
// (the plain PyTorch versions in tci_tpu_torch/ops/probe_batched.py). The
// TPU runs the grid's B programs in order on one core, its scalars in SMEM
// and the row in VMEM; here the grid is B independent blocks (blockIdx.x =
// program_id).
//
// What bounds a probe on this card. Each moves a few KB at most (B = 4, n =
// 256: 32 to 4,144 bytes, ~1e-6 ms at 3.35 TB/s) and does at most trips x n
// integer adds, so neither rate comes near. What is left, in order:
//
//   1. the launch: the blocks scheduled, their threads started and retired,
//      the stores drained before the kernel ends. probe_empty_kernel, an
//      empty kernel launched at a probe's grid and block
//      (ops/probe_batched.floor_ms), measures it; no body goes below it;
//   2. one dependent load: the table's scalar, on which the loop bound, the
//      row and the scalar output all wait;
//   3. the row's bytes, B n 4 of them.
//
// What the design does about each:
//
//   - the launch: a block of ceil(n/4) threads rounded up to a warp (64 at
//     n = 256; one warp for v1 and v2), at most 1024, striding beyond; no
//     shared memory and no barrier in any kernel, so no thread waits for
//     another. v4's loop runs in every thread (the trip count is the same
//     for the whole block, and a trip is a few integer adds) where a
//     thread 0 that ran it alone would hand acc over through a shared word
//     and a barrier.
//   - the load: each thread reads the scalar once, before anything else (a
//     broadcast, one request a warp); v2's two reads are independent.
//   - the bytes: the row goes out in 16-byte stores (int4, float4),
//     neighbouring threads on neighbouring 16 bytes. A scalar head takes
//     the columns before the row's first 16-byte boundary and a scalar tail
//     those after its last: row b starts at b n 4 bytes, so at n = 257
//     three rows in four start off a boundary. On an H100 (700 W) this
//     pays from n = 1024 on: against 4-byte stores from 256 threads, v3
//     and v4b take 0.04 us less a launch at n = 1024 (the same 256
//     threads), 0.07-0.10 at 4096 and ~0.5 at 16384; at n = 256, 64
//     threads storing where 256 did, v3 takes 0.03 us more
//     (tools/probe_ab.py). The (B, 2) scalar output is one 8-byte store
//     (row b of o is 8-byte aligned).
//   - v4c's row lives in registers, Hopper's counterpart of the TPU's VMEM
//     row: each thread owns a group of columns (four, one 16-byte vector, or
//     one of the head or tail), starts it at zero, adds 1 to each element
//     every trip of its own loop and stores it once after the loop. There
//     is no global load or store and no barrier inside the loop.
//
// The loops stay loops, one trip at a time: the trip count is read from
// the table at run time; an empty asm statement makes the carried values
// (v4's acc, v4c's group) opaque to the compiler every trip, so it can
// replace neither v4's loop by lim (lim - 1) / 2 nor v4c's by + lim; and
// #pragma unroll 1 (a "nounroll" pragma in the PTX) keeps the loop from
// being unrolled, which the asm alone does not: it emits nothing, so ptxas
// sees plain adds and, in an unrolled loop, merges sixteen trips of v4c
// into one add of 16. A negative limit makes no trip (k = 0). Integer sums
// wrap modulo 2^32, as int32 does in the Pallas bodies and the plain
// versions; they are computed unsigned so that the wrap is defined. v4b
// rounds 2 t and t + 1 by __fmul_rn and __fadd_rn, as float32 does.
//
// Every launcher has the same C signature (s, v, o, B, cols, n, stream): the
// (B, cols) scalar table, the (B, 1, n) row output, the (B, 2) scalar output
// (null where a kernel has none), and returns cudaGetLastError().
// probe_empty_launch(B, threads, stream) is instrumentation, not a probe.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScalarThreads = 32;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;

// Threads of a probe with an n-column row: one a 16-byte group of columns,
// rounded up to a warp, at most 1024 (ops/probe_batched.launch_shape
// mirrors this).
int row_threads(int n) {
  const int groups = (n + 3) / 4;
  const int threads = (groups + kWarp - 1) / kWarp * kWarp;
  return threads < kMaxThreads ? threads : kMaxThreads;
}

// Writes the n columns of `row`: the columns from its first 16-byte
// boundary on in 16-byte stores of four(c) (the columns c ... c + 3), the
// head before that boundary and the tail after the last one in scalar
// stores of one(c). The items are the head's columns, the vectors and the
// tail's columns, in row order; thread t takes items t, t + blockDim.x, ...
// A row that starts on a boundary and holds whole vectors (the probe's own,
// n = 256) takes a branch of vectors alone, the same for the whole block.
template <typename T, typename V, typename Four, typename One>
__device__ __forceinline__ void write_row(T* row, int n, Four four, One one) {
  const unsigned off =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(row) & 15u);
  if (off == 0 && n % 4 == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<V*>(row)[i] = four(4 * i);
    return;
  }
  const int head = min(static_cast<int>(((16u - off) & 15u) / sizeof(T)), n);
  const int nvec = (n - head) / 4;
  const int items = n - 3 * nvec;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    if (i >= head && i < head + nvec) {
      const int c = head + 4 * (i - head);
      *reinterpret_cast<V*>(row + c) = four(c);
    } else {
      const int c = i < head ? i : i + 3 * nvec;
      row[c] = one(c);
    }
  }
}

// v1 (probe_pallas_batched.py:47): program b writes o[b] = (b, b + 1).
__global__ void probe_v1_kernel(int2* __restrict__ o) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) o[b] = make_int2(b, b + 1);
}

// v2 (:63): a scalar read at a program-dependent row:
// o[b] = (2 s[b, 0], s[b, 2]).
__global__ void probe_v2_kernel(const int* __restrict__ s,
                                int2* __restrict__ o, int cols) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    const int* sb = s + static_cast<size_t>(b) * cols;
    const unsigned s0 = static_cast<unsigned>(__ldg(sb));
    const int s2 = __ldg(sb + 2);
    o[b] = make_int2(static_cast<int>(2u * s0), s2);
  }
}

// v3 (:81): v[b, 0, :] = arange(n) + s[b, 0]; o[b] = (s[b, 0], b).
__global__ void probe_v3_kernel(const int* __restrict__ s,
                                int* __restrict__ v, int2* __restrict__ o,
                                int cols, int n) {
  const int b = blockIdx.x;
  const unsigned s0 =
      static_cast<unsigned>(__ldg(s + static_cast<size_t>(b) * cols));
  if (threadIdx.x == 0) o[b] = make_int2(static_cast<int>(s0), b);
  write_row<int, int4>(
      v + static_cast<size_t>(b) * n, n,
      [=](int c) {
        const unsigned u = static_cast<unsigned>(c) + s0;
        return make_int4(static_cast<int>(u), static_cast<int>(u + 1u),
                         static_cast<int>(u + 2u), static_cast<int>(u + 3u));
      },
      [=](int c) { return static_cast<int>(static_cast<unsigned>(c) + s0); });
}

// v4 (:108): a while loop in the grid body. k runs 0 ... lim - 1 with
// lim = s[b, 0] and acc sums k; v[b, 0, :] = acc, o[b] = (acc, k). Every
// thread runs the loop.
__global__ void probe_v4_kernel(const int* __restrict__ s,
                                int* __restrict__ v, int2* __restrict__ o,
                                int cols, int n) {
  const int b = blockIdx.x;
  const int lim = __ldg(s + static_cast<size_t>(b) * cols);
  int k = 0;
  unsigned acc = 0;
#pragma unroll 1
  while (k < lim) {
    acc += static_cast<unsigned>(k);
    k += 1;
    asm volatile("" : "+r"(acc));  // acc is opaque: the loop stays a loop
  }
  const int a = static_cast<int>(acc);
  if (threadIdx.x == 0) o[b] = make_int2(a, k);
  write_row<int, int4>(
      v + static_cast<size_t>(b) * n, n,
      [=](int) { return make_int4(a, a, a, a); }, [=](int) { return a; });
}

// v4b (:143): a float32 scalar read and store: t = s[b, 0];
// v[b, 0, :] = 2 t, o[b] = (t + 1, t).
__global__ void probe_v4b_kernel(const float* __restrict__ s,
                                 float* __restrict__ v,
                                 float2* __restrict__ o, int cols, int n) {
  const int b = blockIdx.x;
  const float t = __ldg(s + static_cast<size_t>(b) * cols);
  const float twice = __fmul_rn(t, 2.0f);
  if (threadIdx.x == 0) o[b] = make_float2(__fadd_rn(t, 1.0f), t);
  write_row<float, float4>(
      v + static_cast<size_t>(b) * n, n,
      [=](int) { return make_float4(twice, twice, twice, twice); },
      [=](int) { return twice; });
}

// v4c's loop for one group of columns held in registers: lim trips, each
// adding 1 to every element; k is the trip count.
__device__ __forceinline__ int4 v4c_four(int lim, int& k) {
  unsigned x = 0, y = 0, z = 0, w = 0;
  k = 0;
#pragma unroll 1
  while (k < lim) {
    x += 1u;
    y += 1u;
    z += 1u;
    w += 1u;
    k += 1;
    asm volatile("" : "+r"(x), "+r"(y), "+r"(z), "+r"(w));
  }
  return make_int4(static_cast<int>(x), static_cast<int>(y),
                   static_cast<int>(z), static_cast<int>(w));
}

__device__ __forceinline__ int v4c_one(int lim, int& k) {
  unsigned x = 0;
  k = 0;
#pragma unroll 1
  while (k < lim) {
    x += 1u;
    k += 1;
    asm volatile("" : "+r"(x));
  }
  return static_cast<int>(x);
}

// v4c (:168): the row zeroed, then incremented inside a while loop of
// lim = s[b, 0] trips; o[b] = (k, b). Each thread keeps its columns in
// registers through the loop and stores them once after it; thread 0 always
// owns item 0 (n >= 1), so its k is the loop's.
__global__ void probe_v4c_kernel(const int* __restrict__ s,
                                 int* __restrict__ v, int2* __restrict__ o,
                                 int cols, int n) {
  const int b = blockIdx.x;
  const int lim = __ldg(s + static_cast<size_t>(b) * cols);
  int k = 0;
  write_row<int, int4>(
      v + static_cast<size_t>(b) * n, n,
      [&](int) { return v4c_four(lim, k); },
      [&](int) { return v4c_one(lim, k); });
  if (threadIdx.x == 0) o[b] = make_int2(k, b);
}

// The launch floor: no work, at the grid and block a probe is launched with.
__global__ void probe_empty_kernel() {}

}  // namespace

extern "C" {

int probe_v1_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v1_kernel<<<B, kScalarThreads, 0, (cudaStream_t)stream>>>(
      (int2*)o);
  return (int)cudaGetLastError();
}

int probe_v2_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v2_kernel<<<B, kScalarThreads, 0, (cudaStream_t)stream>>>(
      (const int*)s, (int2*)o, cols);
  return (int)cudaGetLastError();
}

int probe_v3_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v3_kernel<<<B, row_threads(n), 0, (cudaStream_t)stream>>>(
      (const int*)s, (int*)v, (int2*)o, cols, n);
  return (int)cudaGetLastError();
}

int probe_v4_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v4_kernel<<<B, row_threads(n), 0, (cudaStream_t)stream>>>(
      (const int*)s, (int*)v, (int2*)o, cols, n);
  return (int)cudaGetLastError();
}

int probe_v4b_launch(const void* s, void* v, void* o, int B, int cols, int n,
                     void* stream) {
  probe_v4b_kernel<<<B, row_threads(n), 0, (cudaStream_t)stream>>>(
      (const float*)s, (float*)v, (float2*)o, cols, n);
  return (int)cudaGetLastError();
}

int probe_v4c_launch(const void* s, void* v, void* o, int B, int cols, int n,
                     void* stream) {
  probe_v4c_kernel<<<B, row_threads(n), 0, (cudaStream_t)stream>>>(
      (const int*)s, (int*)v, (int2*)o, cols, n);
  return (int)cudaGetLastError();
}

int probe_empty_launch(int B, int threads, void* stream) {
  probe_empty_kernel<<<B, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
