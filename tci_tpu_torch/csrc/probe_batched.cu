// The batched-grid probe kernels, one thread block per grid program.
//
// Replaces the six Pallas TPU kernels v1, v2, v3, v4, v4b and v4c of
// benchmarks/probe_pallas_batched.py, which bisect the constructs the batched
// rrLU kernel adds to the single-panel one: a grid whose program b writes
// row b of a scalar output (v1), a data-dependent scalar read (v2), a
// (B, 1, n) blocked vector output written through its row-0 view (v3), a
// while loop inside the grid body (v4), the same with float32 scalars (v4b),
// and a read-modify-write of the row inside such a loop (v4c).
//
// Translation: the TPU grid runs its B programs in order on one core, scalars
// in SMEM, the row in VMEM. Here the grid is B independent blocks
// (blockIdx.x = program_id); the scalars are plain global loads and stores,
// made by thread 0 where the TPU's scalar core made them; the n-wide row is
// spread over the block's threads, neighbouring threads on neighbouring
// columns. A value that thread 0 computes and every thread stores goes through
// one shared-memory word and a barrier.
//
// Each kernel moves a few KB at most (B = 4, n = 256: 32 to 4176 bytes) and
// does a handful of integer operations, so on this card every one is bound by
// the fixed cost of a launch, far above its bytes over the memory rate. The
// design therefore is the simplest that keeps each construct real:
//
//   - v4's and v4c's loops run in the kernel, trip by trip. v4's accumulator
//     passes through an empty asm statement each trip, so the compiler cannot
//     replace the loop by lim (lim - 1) / 2;
//   - v4c re-reads and re-writes the row in global memory on every trip, with
//     a block barrier between trips: the barrier orders one trip's stores
//     before the next trip's loads whichever thread makes them, and keeps the
//     compiler from folding the trips into one add. The loop bound is the
//     same for every thread of a block, so the barrier is never divergent.
//
// Integer sums wrap modulo 2^32, as int32 does in the Pallas bodies and in
// the plain PyTorch versions (tci_tpu_torch/ops/probe_batched.py); they are
// computed unsigned so that the wrap is defined.
//
// Every launcher has the same C signature (s, v, o, B, cols, n, stream): the
// (B, cols) scalar table, the (B, 1, n) row output, the (B, 2) scalar output
// (null where a kernel has none), and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kScalarThreads = 32;
constexpr int kRowThreads = 256;

// v1 (probe_pallas_batched.py:47): program b writes o[b] = (b, b + 1).
__global__ void probe_v1_kernel(int* __restrict__ o) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    o[2 * b] = b;
    o[2 * b + 1] = b + 1;
  }
}

// v2 (:63): a scalar read at a program-dependent row:
// o[b] = (2 s[b, 0], s[b, 2]).
__global__ void probe_v2_kernel(const int* __restrict__ s, int* __restrict__ o,
                                int cols) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    o[2 * b] = (int)(2u * (unsigned)s[b * cols]);
    o[2 * b + 1] = s[b * cols + 2];
  }
}

// v3 (:81): v[b, 0, :] = arange(n) + s[b, 0]; o[b] = (s[b, 0], b).
__global__ void probe_v3_kernel(const int* __restrict__ s, int* __restrict__ v,
                                int* __restrict__ o, int cols, int n) {
  const int b = blockIdx.x;
  const int s0 = s[b * cols];
  int* row = v + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    row[j] = (int)((unsigned)j + (unsigned)s0);
  if (threadIdx.x == 0) {
    o[2 * b] = s0;
    o[2 * b + 1] = b;
  }
}

// v4 (:108): a while loop in the grid body. k runs 0 ... lim - 1 with
// lim = s[b, 0] and acc sums k; v[b, 0, :] = acc, o[b] = (acc, k). Thread 0
// runs the loop, as the TPU's scalar core does, and hands acc to the block.
__global__ void probe_v4_kernel(const int* __restrict__ s, int* __restrict__ v,
                                int* __restrict__ o, int cols, int n) {
  __shared__ int acc_sh;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    const int lim = s[b * cols];
    int k = 0;
    unsigned acc = 0;
    while (k < lim) {
      acc += (unsigned)k;
      k += 1;
      asm volatile("" : "+r"(acc));  // acc is opaque: the loop stays a loop
    }
    acc_sh = (int)acc;
    o[2 * b] = (int)acc;
    o[2 * b + 1] = k;
  }
  __syncthreads();
  const int acc = acc_sh;
  int* row = v + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) row[j] = acc;
}

// v4b (:143): a float32 scalar read and store: t = s[b, 0];
// v[b, 0, :] = 2 t, o[b] = (t + 1, t).
__global__ void probe_v4b_kernel(const float* __restrict__ s,
                                 float* __restrict__ v, float* __restrict__ o,
                                 int cols, int n) {
  const int b = blockIdx.x;
  const float t = s[b * cols];
  const float twice = __fmul_rn(t, 2.0f);
  float* row = v + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) row[j] = twice;
  if (threadIdx.x == 0) {
    o[2 * b] = __fadd_rn(t, 1.0f);
    o[2 * b + 1] = t;
  }
}

// v4c (:168): a read-modify-write of the row inside a while loop:
// v[b, 0, :] is zeroed, then incremented lim = s[b, 0] times; o[b] = (k, b).
// No __restrict__ on v: it is read and written through the same pointer.
__global__ void probe_v4c_kernel(const int* __restrict__ s, int* v,
                                 int* __restrict__ o, int cols, int n) {
  const int b = blockIdx.x;
  const int lim = s[b * cols];
  int* row = v + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) row[j] = 0;
  __syncthreads();
  int k = 0;
  while (k < lim) {
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      row[j] = (int)((unsigned)row[j] + 1u);
    k += 1;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    o[2 * b] = k;
    o[2 * b + 1] = b;
  }
}

}  // namespace

extern "C" {

int probe_v1_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v1_kernel<<<B, kScalarThreads, 0, (cudaStream_t)stream>>>((int*)o);
  return (int)cudaGetLastError();
}

int probe_v2_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v2_kernel<<<B, kScalarThreads, 0, (cudaStream_t)stream>>>(
      (const int*)s, (int*)o, cols);
  return (int)cudaGetLastError();
}

int probe_v3_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v3_kernel<<<B, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const int*)s, (int*)v, (int*)o, cols, n);
  return (int)cudaGetLastError();
}

int probe_v4_launch(const void* s, void* v, void* o, int B, int cols, int n,
                    void* stream) {
  probe_v4_kernel<<<B, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const int*)s, (int*)v, (int*)o, cols, n);
  return (int)cudaGetLastError();
}

int probe_v4b_launch(const void* s, void* v, void* o, int B, int cols, int n,
                     void* stream) {
  probe_v4b_kernel<<<B, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const float*)s, (float*)v, (float*)o, cols, n);
  return (int)cudaGetLastError();
}

int probe_v4c_launch(const void* s, void* v, void* o, int B, int cols, int n,
                     void* stream) {
  probe_v4c_kernel<<<B, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const int*)s, (int*)v, (int*)o, cols, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
