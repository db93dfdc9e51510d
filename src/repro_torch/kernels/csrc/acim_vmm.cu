// Bit-sliced analog compute-in-memory VMM with a fused ADC epilogue, for
// a whole weight leaf of macro tiles.
//
// Replaces the TPU kernels kernels/acim_vmm/acim_vmm.py:
// acim_vmm_tiled_pallas (_acim_tiled_kernel) and acim_vmm_pallas
// (_acim_kernel, the single-tile form, launched here as one tile) of the
// JAX package.  For each output element (b, m), in this order:
//
//   acc = 0
//   for tile ti:                       (tiles in order)
//     tacc = 0
//     for slice l:                     (slices in order)
//       part = sum_r x[b, ti*R + r] * (g_pos[ti,l,r,m] - g_neg[ti,l,r,m])
//       part += noise[ti, l, b, m]                 (pre-ADC read noise)
//       if adc: part = lo + w * clamp(rint((clamp(part, lo, hi) - lo) / w),
//                                     0, 2^bits - 1)
//       tacc += part * 2^(bc*l)
//     acc += tacc
//
// which is the association of the plain version (ref.acim_vmm_tiled) and
// of the TPU kernel; only the order of the sum over r differs.  The
// slice difference is formed before the product, as the TPU kernel does.
//
// What bounds it on Hopper: at decode (B = P*tokens = 40 rows) the leaf's
// g_pos/g_neg planes (8 bytes per cell) dominate the bytes and each is
// used by at most 40 rows, so the kernel is bound by memory; at prefill
// (B = 1280) it has ~160 float operations per byte of g and is bound by
// the float32 rate of the CUDA cores (TF32 tensor cores are off in the
// port).  This first version is simple: a block computes a 32 x 64 tile
// of the output with 256 threads (2 x 4 outputs each, columns strided by
// 16 so that neighbouring threads touch neighbouring addresses), stages
// 32 rows of x and of the slice difference in shared memory per step,
// and accumulates with f32 FMAs on the CUDA cores.  Ragged B, M and R are
// masked, not padded.  The ADC divides in IEEE float (__fdiv_rn: a
// reciprocal multiply would move codes at ties) and rounds half to even
// (rintf, like torch.round).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockB = 32;   // output rows per block
constexpr int kBlockM = 64;   // output columns per block
constexpr int kChunk = 32;    // tile rows staged per step
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kRowsPerThread = kBlockB / kThreadsY;   // 2
constexpr int kColsPerThread = kBlockM / kThreadsX;   // 4
constexpr int kThreads = kThreadsX * kThreadsY;

struct AdcParams {
  int bits;        // -1 = ideal converter (identity)
  float w;         // code width
  float lo;        // lower rail (-FS/2)
  float hi;        // upper rail (+FS/2)
  float code_max;  // 2^bits - 1
};

__global__ void __launch_bounds__(kThreads)
acim_vmm_tiled_kernel(const float* __restrict__ x,      // (B, T*R)
                      const float* __restrict__ g_pos,  // (T, S, R, M)
                      const float* __restrict__ g_neg,  // (T, S, R, M)
                      const float* __restrict__ noise,  // (T, S, B, M) or null
                      float* __restrict__ out,          // (B, M)
                      int b_rows, int n_tiles, int n_slices, int r_rows,
                      int m_cols, int bc, AdcParams adc) {
  __shared__ float xs[kBlockB][kChunk + 1];
  __shared__ float ds[kChunk][kBlockM];

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const int m0 = blockIdx.x * kBlockM;
  const int b0 = blockIdx.y * kBlockB;
  const long long k_total = (long long)n_tiles * r_rows;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;

  for (int ti = 0; ti < n_tiles; ++ti) {
    float tacc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) tacc[i][j] = 0.0f;

    for (int l = 0; l < n_slices; ++l) {
      const size_t plane = ((size_t)ti * n_slices + l) * r_rows * m_cols;
      const float* gp = g_pos + plane;
      const float* gn = g_neg + plane;
      float part[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) part[i][j] = 0.0f;

      for (int k0 = 0; k0 < r_rows; k0 += kChunk) {
        // Stage x[b0 : b0+32, ti*R + k0 : +32] (zero outside).
        for (int idx = threadIdx.x; idx < kBlockB * kChunk; idx += kThreads) {
          const int rb = idx / kChunk, kk = idx % kChunk;
          const int b = b0 + rb, k = k0 + kk;
          xs[rb][kk] = (b < b_rows && k < r_rows)
                           ? x[(size_t)b * k_total + (size_t)ti * r_rows + k]
                           : 0.0f;
        }
        // Stage the slice difference g_pos - g_neg for rows k0 : +32.
        for (int idx = threadIdx.x; idx < kChunk * kBlockM; idx += kThreads) {
          const int kk = idx / kBlockM, mm = idx % kBlockM;
          const int k = k0 + kk, m = m0 + mm;
          float d = 0.0f;
          if (k < r_rows && m < m_cols) {
            const size_t o = (size_t)k * m_cols + m;
            d = gp[o] - gn[o];
          }
          ds[kk][mm] = d;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kChunk; ++kk) {
          float a[kRowsPerThread], bv[kColsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) a[i] = xs[ty + kThreadsY * i][kk];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) bv[j] = ds[kk][tx + kThreadsX * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j)
              part[i][j] = fmaf(a[i], bv[j], part[i][j]);
        }
        __syncthreads();
      }

      // Epilogue of this (tile, slice): noise, ADC, recombination.
      const float slice_w = (float)(1u << (bc * l));
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int b = b0 + ty + kThreadsY * i;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int m = m0 + tx + kThreadsX * j;
          float p = part[i][j];
          if (noise != nullptr && b < b_rows && m < m_cols) {
            p = p + noise[(((size_t)ti * n_slices + l) * b_rows + b) * m_cols + m];
          }
          if (adc.bits >= 0) {
            const float y = fminf(fmaxf(p, adc.lo), adc.hi);
            float code = rintf(__fdiv_rn(y - adc.lo, adc.w));
            code = fminf(fmaxf(code, 0.0f), adc.code_max);
            p = adc.lo + code * adc.w;
          }
          tacc[i][j] = tacc[i][j] + p * slice_w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = acc[i][j] + tacc[i][j];
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int b = b0 + ty + kThreadsY * i;
    if (b >= b_rows) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int m = m0 + tx + kThreadsX * j;
      if (m < m_cols) out[(size_t)b * m_cols + m] = acc[i][j];
    }
  }
}

}  // namespace

// x (b, n_tiles*r) f32; g_pos, g_neg (n_tiles, s, r, m) f32; noise
// (n_tiles, s, b, m) f32 or nullptr; out (b, m) f32; all contiguous.
// adc_bits < 0 selects the ideal converter.  Returns cudaGetLastError()
// after the launch.
extern "C" int harp_acim_vmm_tiled(const float* x, const float* g_pos,
                                   const float* g_neg, const float* noise,
                                   float* out, int b, int n_tiles, int s,
                                   int r, int m, int bc, int adc_bits,
                                   float w, float lo, float hi, float code_max,
                                   void* stream) {
  if (b < 0 || n_tiles < 1 || s < 1 || r < 1 || m < 0 || bc < 0 ||
      bc * (s - 1) > 30)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || m == 0) return 0;
  AdcParams adc{adc_bits, w, lo, hi, code_max};
  const dim3 grid((m + kBlockM - 1) / kBlockM, (b + kBlockB - 1) / kBlockB);
  acim_vmm_tiled_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, g_pos, g_neg, noise, out, b, n_tiles, s, r, m, bc, adc);
  return (int)cudaGetLastError();
}
