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
// What bounds it on Hopper, and what the design does about it:
//
// * Decode (B = P * tokens = 40 rows): the g_pos / g_neg planes, 8 bytes a
//   cell, are each used by at most 40 rows, so the kernel is bound by
//   reading them (w_gate layer 0: 50 MB of planes and 8 MB of noise,
//   17.6 us at 3.35 TB/s).  One block per (B-block, M-block) gives only
//   48 blocks there, so the wrapper splits the work (ops._plan): items
//   (tile, slice, B-block, M-block), 768 for w_gate, are walked by as
//   many persistent 4-warp blocks as are resident (3 per SM), each item
//   reading its g bytes once and writing its raw partial sums to a
//   (T, S, B, M) workspace from the wrapper; `epilogue_kernel` then adds
//   the noise, converts, and recombines slices and tiles in the
//   reference's order, with no atomics.  What remains over the bound is
//   the workspace round trip and the per-SM rate of cp.async streams
//   (PERF.md).
// * Prefill (B = 1280): ~160 float operations per byte of g.  One block
//   per (64-row B-block, 128-column M-block) loops over the tiles in
//   order with the epilogue in registers; the products go to the tensor
//   cores when they are exact (below).
//
// Loads: a block streams (tile, slice, 32-row chunk) stages of x and of
// g_pos / g_neg through a ring of 3 shared-memory slots with cp.async:
// 16-byte copies where R % 4 == 0, M % 4 == 0 and the bases are 16-byte
// aligned, 4-byte copies otherwise (ragged M, or planes sliced at an
// unaligned offset); elements past B, R or M are zero-filled.  Two stages
// stay in flight while one is reduced.
//
// Products, chosen per staged chunk on the device (no flag, no host
// sync): after a chunk lands, __syncthreads_and asks whether every x of
// it is 0 or 1 (the DAC planes of cim_matmul always are).  If so, each
// d = g_pos - g_neg (f32) is split into three bf16 parts h = bf16(d),
// m = bf16(d - h), l = bf16(d - h - m) (h + m + l == d exactly for d == 0
// and |d| >= 2^-110: 3 x 8 significand bits cover f32's 24, and each
// remainder is exact in f32; ref.split_bf16x3 is the plain version) and
// x*h + x*m + x*l is accumulated with mma.sync m16n8k16 bf16 -> f32:
// every product is exact because x is 0 or 1, only the order of the f32
// sum differs.  Otherwise (raw activations: the ideal driver) the chunk
// takes f32 FMAs on the CUDA cores into the same accumulators.
//
// Epilogue: noise, then the ADC in IEEE float (__fdiv_rn: a reciprocal
// multiply would move codes at ties) and round half to even (rintf, like
// torch.round), then the recombination.  The library is built with
// -fmad=false; the products use explicit fmaf or mma, which the flag
// does not touch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                   // rows of x per block: 4 m16 tiles
constexpr int kChunk = 32;                  // tile rows per pipeline stage
constexpr int kStages = 3;                  // ring depth
constexpr int kMaxSplitTiles = 384;         // ops.MAX_SPLIT_TILES
constexpr int kEpilogueLanes = 4;           // tile lanes of an epilogue block
// A stage, in floats: x (kRows x 32), then g_pos and g_neg, each cut
// into 32 x 32 halves.  Every 128-byte row is stored with a 16-byte-chunk
// XOR swizzle (chunk j of row r at chunk j ^ (r % 8)), so that the
// fragment loads of both product routes hit 32 distinct banks.
constexpr int kXFloats = kRows * kChunk;
constexpr int kGHalf = kChunk * 32;
__host__ __device__ constexpr int stage_floats(int cols) {
  return kXFloats + 2 * (cols / 32) * kGHalf;
}
__host__ __device__ constexpr int smem_bytes(int cols) {
  return kStages * stage_floats(cols) * 4;
}
// Resident blocks per SM, which bounds registers: the split kernel keeps
// one set of accumulators, the unsplit three.
__host__ __device__ constexpr int min_blocks(int cols, bool split) {
  return cols == 128 ? 1 : (split ? 3 : 2);
}

struct AdcParams {
  int bits;        // -1 = ideal converter (identity)
  float w;         // code width
  float lo;        // lower rail (-FS/2)
  float hi;        // upper rail (+FS/2)
  float code_max;  // 2^bits - 1
};

struct Problem {
  const float* x;      // (B, T*R)
  const float* g_pos;  // (T, S, R, M)
  const float* g_neg;  // (T, S, R, M)
  const float* noise;  // (T, S, B, M) or null
  float* out;          // (B, M); the (T, S, B, M) workspace when split
  int b_rows, n_tiles, n_slices, r_rows, m_cols, bc;
  int vec;             // 16-byte copies (R % 4 == 0, M % 4 == 0, aligned)
  AdcParams adc;
};

// Float offset of element (row, col < 32) in a swizzled 128-byte-row region.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 32 + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

// Float offset of g element (k, n) in a stage's g_pos or g_neg.
__device__ __forceinline__ int goff(int k, int n) { return (n >> 5) * kGHalf + swz(k, n & 31); }

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

// The same, with an L2 eviction policy for the source lines.
__device__ __forceinline__ void cp_async16_ef(float* dst, const float* src, bool pred,
                                              uint64_t policy) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n), "l"(policy) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  return as_u32(__floats2bfloat162_rn(v.x, v.y));
}

// d0, d1 -> (h, m, l) bf16 pairs with h + m + l == d exactly.
__device__ __forceinline__ void split3(float d0, float d1, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(d0, d1);
  const float r0 = d0 - __low2float(hv), r1 = d1 - __high2float(hv);
  const __nv_bfloat162 mv = __floats2bfloat162_rn(r0, r1);
  const float s0 = r0 - __low2float(mv), s1 = r1 - __high2float(mv);
  h = as_u32(hv);
  m = as_u32(mv);
  l = as_u32(__floats2bfloat162_rn(s0, s1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool is01(float v) { return v == 0.0f || v == 1.0f; }

// The ADC of one partial sum (noise already added).
__device__ __forceinline__ float adc_convert(float v, const AdcParams& adc) {
  if (adc.bits >= 0) {
    const float y = fminf(fmaxf(v, adc.lo), adc.hi);
    float code = rintf(__fdiv_rn(y - adc.lo, adc.w));
    code = fminf(fmaxf(code, 0.0f), adc.code_max);
    v = adc.lo + code * adc.w;
  }
  return v;
}

// One block: 64 rows x kCols (64 or 128) columns of output, one warp per
// 16 columns.  Warp w owns all 64 rows of columns 16 w .. +16; element e
// of its m16 tile i and n8 tile j is row 16 i + lane/4 (+8 for e >= 2),
// column 16 w + 8 j + 2 (lane % 4) + e % 2.  Only the first kMt m16
// tiles are computed: fewer than 4 where B < 64 (decode: B = 40, 3).
//
// kSplit = false: the block (blockIdx.x = M-block, blockIdx.y = B-block)
// walks every tile, slice and 32-row chunk in order and runs the noise /
// ADC / recombination epilogue in registers.
// kSplit = true: the block walks work items (tile, slice, B-block,
// M-block) blockIdx.x, + gridDim.x, ... as one stream of chunks through
// its ring and writes each item's raw partial sums to the (T, S, B, M)
// workspace; `epilogue_kernel` then applies noise, ADC and recombination
// in the reference's order.
template <int kCols, bool kSplit, int kMt>
__global__ void __launch_bounds__(2 * kCols, min_blocks(kCols, kSplit))
acim_vmm_kernel(const Problem p) {
  constexpr int kThreads = 2 * kCols;
  constexpr int kStage = stage_floats(kCols);
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wcol = 16 * warp;
  const int n_chunks = (p.r_rows + kChunk - 1) / kChunk;
  const int m_blocks = (p.m_cols + kCols - 1) / kCols;
  const int b_blocks = (p.b_rows + kRows - 1) / kRows;
  const size_t k_total = (size_t)p.n_tiles * p.r_rows;
  // Work items: split, (tile, slice, B-block, M-block) with M fastest, a
  // block taking every gridDim.x-th; unsplit, the block's own (B, M)
  // block over all tiles and slices.
  const int n_items = kSplit ? p.n_tiles * p.n_slices * b_blocks * m_blocks : 1;
  const int my_items =
      kSplit ? (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 1;
  const int steps = kSplit ? my_items * n_chunks : p.n_tiles * p.n_slices * n_chunks;

  // Where a step of this block reads: its chunk c of item j, the item's
  // (tile, slice, B-block, M-block) decoded once per item.  One cursor
  // runs kStages - 1 steps ahead for the loads, one follows the products.
  struct Cursor {
    int c, j, ti, l, b0, m0;
  };
  auto set_item = [&](Cursor& u) {
    if (kSplit) {
      int item = (int)blockIdx.x + u.j * (int)gridDim.x;
      u.m0 = (item % m_blocks) * kCols;
      item /= m_blocks;
      u.b0 = (item % b_blocks) * kRows;
      item /= b_blocks;
      u.l = item % p.n_slices;
      u.ti = item / p.n_slices;
    } else {
      u.l = u.j % p.n_slices;
      u.ti = u.j / p.n_slices;
      u.m0 = blockIdx.x * kCols;
      u.b0 = blockIdx.y * kRows;
    }
  };
  auto advance = [&](Cursor& u) {
    if (++u.c == n_chunks) {
      u.c = 0;
      ++u.j;
      set_item(u);
    }
  };
  Cursor ld{0, 0, 0, 0, 0, 0}, cu{0, 0, 0, 0, 0, 0};
  // Split, each g byte is read once: mark it first to leave L2.
  uint64_t ef_policy = 0;
  if (kSplit) asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(ef_policy));
  set_item(ld);
  set_item(cu);

  // Stage `step` into ring slot step % kStages with cp.async into the
  // swizzled layout: 16-byte copies where rows are 16-byte aligned, else
  // 4-byte ones; masked elements are zero-filled.  Always commits a
  // group, empty past the end.
  auto issue = [&](int step) {
    if (step < steps) {
      const int ti = ld.ti, l = ld.l, b0 = ld.b0, m0 = ld.m0;
      const int k0 = ld.c * kChunk;
      float* xs = smem + (step % kStages) * kStage;
      float* gps = xs + kXFloats;
      float* gns = gps + (kCols / 32) * kGHalf;
      const float* xb = p.x + (size_t)ti * p.r_rows + k0;
      const size_t plane = ((size_t)ti * p.n_slices + l) * p.r_rows + k0;
      if (p.vec) {
#pragma unroll
        for (int q = 0; q < kRows * kChunk / 4 / kThreads; ++q) {
          const int e = tid + q * kThreads;
          const int row = e / (kChunk / 4), cc = (e % (kChunk / 4)) * 4;
          const bool ok = b0 + row < p.b_rows && k0 + cc < p.r_rows;
          cp_async16(xs + swz(row, cc), ok ? xb + (size_t)(b0 + row) * k_total + cc : p.x, ok);
        }
#pragma unroll
        for (int q = 0; q < kChunk * kCols / 4 / kThreads; ++q) {
          const int e = tid + q * kThreads;
          const int row = e / (kCols / 4), cc = (e % (kCols / 4)) * 4;
          const bool ok = k0 + row < p.r_rows && m0 + cc < p.m_cols;
          const size_t o = ok ? (plane + row) * p.m_cols + m0 + cc : 0;
          if (kSplit) {
            cp_async16_ef(gps + goff(row, cc), p.g_pos + o, ok, ef_policy);
            cp_async16_ef(gns + goff(row, cc), p.g_neg + o, ok, ef_policy);
          } else {
            cp_async16(gps + goff(row, cc), p.g_pos + o, ok);
            cp_async16(gns + goff(row, cc), p.g_neg + o, ok);
          }
        }
      } else {
#pragma unroll 2
        for (int q = 0; q < kRows * kChunk / kThreads; ++q) {
          const int e = tid + q * kThreads;
          const int row = e / kChunk, cc = e % kChunk;
          const bool ok = b0 + row < p.b_rows && k0 + cc < p.r_rows;
          cp_async4(xs + swz(row, cc), ok ? xb + (size_t)(b0 + row) * k_total + cc : p.x, ok);
        }
#pragma unroll 2
        for (int q = 0; q < kChunk * kCols / kThreads; ++q) {
          const int e = tid + q * kThreads;
          const int row = e / kCols, cc = e % kCols;
          const bool ok = k0 + row < p.r_rows && m0 + cc < p.m_cols;
          const size_t o = ok ? (plane + row) * p.m_cols + m0 + cc : 0;
          cp_async4(gps + goff(row, cc), p.g_pos + o, ok);
          cp_async4(gns + goff(row, cc), p.g_neg + o, ok);
        }
      }
      advance(ld);
    }
    cp_async_commit();
  };

  // Whether the x elements this thread copied into `xs` are all 0 or 1
  // (its own copies are complete and visible to it after the wait).
  auto own_x_binary = [&](const float* xs) {
    bool ok = true;
    if (p.vec) {
#pragma unroll
      for (int q = 0; q < kRows * kChunk / 4 / kThreads; ++q) {
        const int e = tid + q * kThreads;
        const float4 v = *reinterpret_cast<const float4*>(
            xs + swz(e / (kChunk / 4), (e % (kChunk / 4)) * 4));
        ok = ok && is01(v.x) && is01(v.y) && is01(v.z) && is01(v.w);
      }
    } else {
#pragma unroll 2
      for (int q = 0; q < kRows * kChunk / kThreads; ++q) {
        const int e = tid + q * kThreads;
        ok = ok && is01(xs[swz(e / kChunk, e % kChunk)]);
      }
    }
    return ok;
  };

  float part[4][2][4], tacc[4][2][4], acc[4][2][4], nzr[4][2][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[i][j][e] = tacc[i][j][e] = acc[i][j][e] = nzr[i][j][e] = 0.0f;

  // Steps 1 - kStages .. -1 only fill the ring.
#pragma unroll 1
  for (int step = 1 - kStages; step < steps; ++step) {
    if (step < 0) {
      issue(step + kStages - 1);
      continue;
    }
    const int ti = cu.ti, l = cu.l, b0 = cu.b0, m0 = cu.m0;
    const bool slice_end = cu.c == n_chunks - 1;
    advance(cu);
    const size_t plane = ((size_t)ti * p.n_slices + l) * p.b_rows * p.m_cols;
    if (!kSplit && slice_end && p.noise != nullptr) {
      // The epilogue's noise, loaded before this chunk's products so that
      // its latency hides behind them.
#pragma unroll
      for (int i = 0; i < kMt; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = b0 + 16 * i + gid + (e >= 2 ? 8 : 0);
            const int m = m0 + wcol + 8 * j + 2 * tig + (e & 1);
            const bool live = b < p.b_rows && m < p.m_cols;
            nzr[i][j][e] = __ldg(p.noise + plane + (live ? (size_t)b * p.m_cols + m : 0));
          }
    }

    cp_async_wait<kStages - 2>();
    const float* xs = smem + (step % kStages) * kStage;
    const float* gps = xs + kXFloats;
    const float* gns = gps + (kCols / 32) * kGHalf;
    const bool binary = __syncthreads_and(own_x_binary(xs)) != 0;
    // Every thread is past the reduction of step - 1: refill its slot.
    issue(step + kStages - 1);

    if (binary) {
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t bh[2][2], bm[2][2], bl[2][2];            // [n8][half]
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = wcol + 8 * j + gid;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int k = 16 * ks + 2 * tig + 8 * hf;
            const float d0 = gps[goff(k, n)] - gns[goff(k, n)];
            const float d1 = gps[goff(k + 1, n)] - gns[goff(k + 1, n)];
            split3(d0, d1, bh[j][hf], bm[j][hf], bl[j][hf]);
          }
        }
        uint32_t a[4][4];                                 // [m16][reg]
#pragma unroll
        for (int i = 0; i < kMt; ++i) {
          const int r0 = 16 * i + gid, kc = 16 * ks + 2 * tig;
          a[i][0] = pack_bf16(*reinterpret_cast<const float2*>(xs + swz(r0, kc)));
          a[i][1] = pack_bf16(*reinterpret_cast<const float2*>(xs + swz(r0 + 8, kc)));
          a[i][2] = pack_bf16(*reinterpret_cast<const float2*>(xs + swz(r0, kc + 8)));
          a[i][3] = pack_bf16(*reinterpret_cast<const float2*>(xs + swz(r0 + 8, kc + 8)));
        }
        // Unpredicated over the kMt m16 tiles (rows past B are zero), h,
        // m and l in turn: 2 kMt independent accumulators between
        // dependent products.
#pragma unroll
        for (int i = 0; i < kMt; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(part[i][j], a[i], bh[j][0], bh[j][1]);
#pragma unroll
        for (int i = 0; i < kMt; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(part[i][j], a[i], bm[j][0], bm[j][1]);
#pragma unroll
        for (int i = 0; i < kMt; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(part[i][j], a[i], bl[j][0], bl[j][1]);
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < kChunk; ++kk) {
        float d[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wcol + 8 * j + 2 * tig;
          const float2 gp2 = *reinterpret_cast<const float2*>(gps + goff(kk, col));
          const float2 gn2 = *reinterpret_cast<const float2*>(gns + goff(kk, col));
          d[j][0] = gp2.x - gn2.x;
          d[j][1] = gp2.y - gn2.y;
        }
#pragma unroll
        for (int i = 0; i < kMt; ++i) {
          const float x0 = xs[swz(16 * i + gid, kk)];
          const float x1 = xs[swz(16 * i + gid + 8, kk)];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            part[i][j][0] = fmaf(x0, d[j][0], part[i][j][0]);
            part[i][j][1] = fmaf(x0, d[j][1], part[i][j][1]);
            part[i][j][2] = fmaf(x1, d[j][0], part[i][j][2]);
            part[i][j][3] = fmaf(x1, d[j][1], part[i][j][3]);
          }
        }
      }
    }

    if (!slice_end) continue;
    // This (tile, slice) of the item is reduced.
    const float slice_w = (float)(1u << (p.bc * l));
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = b0 + 16 * i + gid + (e >= 2 ? 8 : 0);
          const int m = m0 + wcol + 8 * j + 2 * tig + (e & 1);
          if (kSplit) {
            if (b < p.b_rows && m < p.m_cols)
              p.out[plane + (size_t)b * p.m_cols + m] = part[i][j][e];
          } else {
            float v = part[i][j][e];
            if (p.noise != nullptr) v = v + nzr[i][j][e];
            tacc[i][j][e] = tacc[i][j][e] + adc_convert(v, p.adc) * slice_w;
          }
          part[i][j][e] = 0.0f;
        }
    if (kSplit || l != p.n_slices - 1) continue;
    // This tile is done.
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = acc[i][j][e] + tacc[i][j][e];
          tacc[i][j][e] = 0.0f;
        }
  }
  cp_async_wait<0>();

  if (!kSplit) {
    const int m0 = blockIdx.x * kCols, b0 = blockIdx.y * kRows;
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = b0 + 16 * i + gid + (e >= 2 ? 8 : 0);
          const int m = m0 + wcol + 8 * j + 2 * tig + (e & 1);
          if (b < p.b_rows && m < p.m_cols) p.out[(size_t)b * p.m_cols + m] = acc[i][j][e];
        }
  }
}

// After the split kernel: out[i] = ((0 + tacc_0) + tacc_1) + ... with
// tacc_t = ((0 + ADC(ws[t, 0, i] + noise[t, 0, i]) * 2^0) + ...) over the
// slices in order: the reference's association.  A block is 32
// consecutive elements x kEpilogueLanes tile lanes; each lane converts
// and recombines the slices of its tiles, then lane 0 adds the tiles in
// order from shared memory.
__global__ void __launch_bounds__(32 * kEpilogueLanes)
epilogue_kernel(const float* __restrict__ ws, const float* __restrict__ noise,
                      float* __restrict__ out, int n_tiles, int n_slices, int bc,
                      long long n, AdcParams adc) {
  extern __shared__ float tsum[];                      // (n_tiles, 32)
  const int e = threadIdx.x % 32, lane_t = threadIdx.x / 32;
  const long long i = (long long)blockIdx.x * 32 + e;
  if (i < n) {
    for (int t = lane_t; t < n_tiles; t += kEpilogueLanes) {
      float tacc = 0.0f;
      for (int l = 0; l < n_slices; ++l) {
        const size_t o = ((size_t)t * n_slices + l) * n + i;
        const float y = noise == nullptr ? __ldcg(ws + o) : __ldcg(ws + o) + __ldcs(noise + o);
        tacc = tacc + adc_convert(y, adc) * (float)(1u << (bc * l));
      }
      tsum[t * 32 + e] = tacc;
    }
  }
  __syncthreads();
  if (lane_t == 0 && i < n) {
    float acc = 0.0f;
    for (int t = 0; t < n_tiles; ++t) acc = acc + tsum[t * 32 + e];
    out[i] = acc;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <int kCols, bool kSplit, int kMt = 4>
cudaError_t launch(const Problem& p, dim3 grid, cudaStream_t st) {
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(acim_vmm_kernel<kCols, kSplit, kMt>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes(kCols));
    if (e != cudaSuccess) return e;
    attribute_set = true;
  }
  acim_vmm_kernel<kCols, kSplit, kMt><<<grid, 2 * kCols, smem_bytes(kCols), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (b, n_tiles*r) f32; g_pos, g_neg (n_tiles, s, r, m) f32; noise
// (n_tiles, s, b, m) f32 or nullptr; out (b, m) f32; all contiguous.
// ws: nullptr, or a (n_tiles, s, b, m) f32 workspace, which splits the
// work over tiles and slices (persistent blocks over (tile, slice,
// B-block, M-block) items, then the ordered epilogue kernel).
// adc_bits < 0 selects the ideal converter.  Returns cudaGetLastError()
// after the launches.
extern "C" int harp_acim_vmm_tiled(const float* x, const float* g_pos,
                                   const float* g_neg, const float* noise,
                                   float* out, float* ws, int b, int n_tiles,
                                   int s, int r, int m, int bc, int adc_bits,
                                   float w, float lo, float hi, float code_max,
                                   void* stream) {
  if (b < 0 || n_tiles < 1 || s < 1 || r < 1 || m < 0 || bc < 0 ||
      bc * (s - 1) > 30)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || m == 0) return 0;
  // The epilogue keeps a tile sum per tile of 32 elements in 48 KB.
  if (ws != nullptr && n_tiles > kMaxSplitTiles) return (int)cudaErrorInvalidValue;
  const AdcParams adc{adc_bits, w, lo, hi, code_max};
  Problem p{x, g_pos, g_neg, noise, ws != nullptr ? ws : out,
            b, n_tiles, s, r, m, bc,
            (r % 4 == 0) && (m % 4 == 0) && aligned16(x) && aligned16(g_pos) &&
                aligned16(g_neg),
            adc};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned b_blocks = (b + kRows - 1) / kRows;
  if (ws == nullptr) {
    // 128-column blocks where there are many rows: half the x re-reads.
    if (b > kRows) {
      if (b_blocks > 65535) return (int)cudaErrorInvalidValue;
      return (int)launch<128, false>(p, dim3((m + 127) / 128, b_blocks), st);
    }
    return (int)launch<64, false>(p, dim3((m + 63) / 64, 1), st);
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // Persistent blocks, as many as are resident at once.
  const long long items = (long long)n_tiles * s * b_blocks * ((m + 63) / 64);
  const long long resident = (long long)min_blocks(64, true) * sms;
  if (items > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(items < resident ? items : resident));
  // Only the m16 tiles that hold rows of x (B = 40 at decode: 3 of 4).
  cudaError_t err;
  switch (b >= kRows ? 4 : (b + 15) / 16) {
    case 1: err = launch<64, true, 1>(p, grid, st); break;
    case 2: err = launch<64, true, 2>(p, grid, st); break;
    case 3: err = launch<64, true, 3>(p, grid, st); break;
    default: err = launch<64, true, 4>(p, grid, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)b * m;
  epilogue_kernel<<<(unsigned)((n + 31) / 32), 32 * kEpilogueLanes, n_tiles * 32 * 4, st>>>(
      ws, noise, out, n_tiles, s, bc, n, adc);
  return (int)cudaGetLastError();
}
