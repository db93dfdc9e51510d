// Batched unnormalised Walsh-Hadamard transform along the last axis.
//
// Replaces the TPU kernel kernels/fwht/fwht.py:fwht_pallas (_fwht_kernel)
// of the JAX package, which computes x @ H per 512-column block on the
// matrix unit.  On Hopper the transform is bound by memory traffic: N log N
// float adds for 8 bytes moved per element (4 read, 4 written), so tensor
// cores buy nothing.  This kernel runs the butterfly in float32 registers
// instead, one thread per element, with the reference butterfly's stage
// order (h = 1, 2, 4, ...) and operand order (lower = a + b, upper =
// a - b), so its output is bitwise equal to the plain version.  Stages
// with h < 32 exchange values by warp shuffle; stages with h >= 32 (N > 32)
// go through shared memory.  Each block holds whole columns.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fwht_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ y,
                                long long total, int n) {
  extern __shared__ float smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < total;
  float v = live ? x[i] : 0.0f;
  const int j = threadIdx.x & (n - 1);  // position inside the column
  int h = 1;
  for (; h < n && h < 32; h <<= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, h);
    v = (j & h) ? (other - v) : (v + other);
  }
  for (; h < n; h <<= 1) {
    smem[threadIdx.x] = v;
    __syncthreads();
    const float other = smem[threadIdx.x ^ h];
    __syncthreads();
    v = (j & h) ? (other - v) : (v + other);
  }
  if (live) y[i] = v;
}

}  // namespace

// x, y: (c, n) float32, contiguous, n a power of two <= 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int harp_fwht_f32(const float* x, float* y, long long c, int n,
                             void* stream) {
  if (n < 1 || n > 1024 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  const long long total = c * (long long)n;
  if (total == 0) return 0;
  const int threads = n > kThreads ? n : kThreads;
  const long long blocks = (total + threads - 1) / threads;
  const size_t smem = n > 32 ? threads * sizeof(float) : 0;
  fwht_f32_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, y, total, n);
  return (int)cudaGetLastError();
}
