// The grid barrier of the rrLU kernel's grid mode as it stood before the
// one-barrier design (two words {arrived, generation}, an atomicAdd and a
// __nanosleep poll), kept only so that tools/grid_ab.py can time it beside
// the current one (csrc/rrlu.cu's grid_barrier) at the same launch shape.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libgrid_barrier_parent.so tools/grid_barrier_parent.cu

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
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

__global__ void barrier_kernel(unsigned int* bar, int iters) {
  for (int i = 0; i < iters; ++i) grid_sync(bar, gridDim.x);
}

}  // namespace

extern "C" {

// `iters` barriers across G blocks of `threads` threads on `stream`; `bar`
// is two zeroed 32-bit words. Returns the CUDA error code.
int grid_barrier_parent_launch(int G, int threads, int iters, void* bar,
                               void* stream) {
  unsigned int* b = (unsigned int*)bar;
  void* args[] = {&b, &iters};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)barrier_kernel, dim3(G), dim3(threads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
