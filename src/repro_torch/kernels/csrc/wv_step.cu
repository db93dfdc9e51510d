// Fused fine write-and-verify cell update.
//
// Replaces the TPU kernel kernels/wv_step/wv_step.py:wv_cell_update_pallas
// (_wv_kernel) of the JAX package.  Per cell, in order: ternary threshold
// of the verify aggregate -> streak -> freeze -> pulse count -> nonlinear,
// asymmetric device step with pre-sampled c2c / mapping noise -> clip.
// A column (row of n cells) stops when all its cells entered the update
// frozen, so a block holds whole rows and reduces "any cell unfrozen" per
// row in shared memory.
//
// The update is one pass over memory: 29 bytes read and 17 written per
// cell (25 read for ternary methods, which never load dev_mag), so it is
// bound by bytes.  One thread per cell, consecutive threads on
// consecutive cells.  The arithmetic repeats the plain version operation
// for operation; the library is built with -fmad=false so that no product
// and sum are contracted into an FMA the plain version does not do, and
// rintf is round-half-to-even like torch.round.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct WVParams {
  float threshold;
  int k_streak;
  int can_freeze;
  int ternary;
  float fine_step;
  float max_pulses;
  float g_max;
  float nonlinearity;
  float reset_asymmetry;
  int nmap_sqrt_pulses;
};

__global__ void wv_step_kernel(
    const float* __restrict__ agg, const float* __restrict__ dev_mag,
    const float* __restrict__ g, const int* __restrict__ streak,
    const unsigned char* __restrict__ frozen, const float* __restrict__ c2c,
    const float* __restrict__ nmap, const float* __restrict__ d2d,
    float* __restrict__ g_out, int* __restrict__ streak_out,
    unsigned char* __restrict__ frozen_out, float* __restrict__ np_out,
    float* __restrict__ dir_out, long long total, int n, WVParams p) {
  __shared__ int row_unfrozen[kThreads];
  const int row = threadIdx.x / n;
  if (threadIdx.x < blockDim.x / n) row_unfrozen[threadIdx.x] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < total;
  const bool fz = live ? frozen[i] != 0 : true;
  if (!fz) row_unfrozen[row] = 1;
  __syncthreads();
  if (!live) return;
  const bool col_active = row_unfrozen[row] != 0;

  const float a = agg[i];
  const float decision =
      a > p.threshold ? 1.0f : (a < -p.threshold ? -1.0f : 0.0f);
  const int s_new = decision == 0.0f ? streak[i] + 1 : 0;
  const bool fz_new = fz || (p.can_freeze && s_new >= p.k_streak);

  float n_p = 1.0f;
  if (!p.ternary) {
    n_p = fminf(fmaxf(rintf(dev_mag[i] / p.fine_step), 1.0f), p.max_pulses);
  }
  const bool act = !fz && decision != 0.0f && col_active;
  n_p = act ? n_p : 0.0f;
  const float direction = act ? -decision : 0.0f;

  const float gi = g[i];
  const float frac = fminf(fmaxf(gi / p.g_max, 0.0f), 1.0f);
  const float set_eff = powf(1.0f - frac, p.nonlinearity);
  const float reset_eff = powf(frac, p.nonlinearity) * p.reset_asymmetry;
  const float eff = direction > 0.0f ? set_eff : reset_eff;
  const float delta =
      direction * p.fine_step * eff * d2d[i] * n_p * c2c[i];
  float nm = nmap[i];
  if (p.nmap_sqrt_pulses) nm = nm * sqrtf(fmaxf(n_p, 1.0f));
  const float g_new =
      fminf(fmaxf(gi + delta + (n_p > 0.0f ? nm : 0.0f), 0.0f), p.g_max);

  g_out[i] = n_p > 0.0f ? g_new : gi;
  streak_out[i] = s_new;
  frozen_out[i] = fz_new ? 1 : 0;
  np_out[i] = n_p;
  dir_out[i] = direction;
}

}  // namespace

// All planes (c, n), contiguous; frozen planes are one byte per cell
// (torch.bool).  n must divide 256 or be a power of two <= 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int harp_wv_step(
    const float* agg, const float* dev_mag, const float* g, const int* streak,
    const unsigned char* frozen, const float* c2c, const float* nmap,
    const float* d2d, float* g_out, int* streak_out, unsigned char* frozen_out,
    float* np_out, float* dir_out, long long c, int n, float threshold,
    int k_streak, int can_freeze, int ternary, float fine_step,
    float max_pulses, float g_max, float nonlinearity, float reset_asymmetry,
    int nmap_sqrt_pulses, void* stream) {
  if (n < 1 || n > 1024 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  const long long total = c * (long long)n;
  if (total == 0) return 0;
  WVParams p{threshold, k_streak, can_freeze, ternary, fine_step, max_pulses,
             g_max, nonlinearity, reset_asymmetry, nmap_sqrt_pulses};
  const int threads = n > kThreads ? n : kThreads;
  const long long blocks = (total + threads - 1) / threads;
  wv_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      agg, dev_mag, g, streak, frozen, c2c, nmap, d2d, g_out, streak_out,
      frozen_out, np_out, dir_out, total, n, p);
  return (int)cudaGetLastError();
}
