// Multiresolution hash-grid encode for Hopper (sm_90a): forward gather and
// backward scatter-add, with the corner geometry rebuilt in the kernel.
//
// Replaces the Pallas kernels of spinnerf_tpu/ops/hash_encode_win.py:
//   forward  _win_fwd_fused_kernel (:580; _corner_geom :526, _paired_gather :258)
//   backward _win_bwd_fused_kernel (:593; _bwd_accumulate :324)
// It computes what hash_encode_exact(table, *corner_indices_weights_win(...))
// computes: a direct gather at any point count, without the TPU kernel's
// two-page window, its clamp aliasing or its Z-sort.
//
// What bounds it on an H100: every (point, level) reads 8 scattered 8-byte
// table entries (and the backward issues 8 scattered float2 atomics) inside
// a 64 MiB f32 table per field at 2^19 entries x 16 levels, which is larger
// than the 50 MB L2 — so the gather is bound by scattered memory
// transactions, not by arithmetic (about 150 integer and float operations a
// thread). This is the simple first design: one thread per (point, level),
// point-major so that a warp's 8-byte output stores are contiguous and its
// 16 threads of one point share that point's coordinates; the 8 corner loads
// are issued before the blend so they are in flight together. The backward
// sums the hot coarse dense levels in shared memory first
// (he_bwd_dense_kernel).
//
// Bit-exactness: the corner indices must equal the host index function's bit
// for bit, so the geometry rounds as the f32 host path does: explicit
// __fmul_rn / __fsub_rn, and the library is built with -fmad=false (an FMA
// contraction of x*r - floor(x*r) changes frac). Never build with
// --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define HE_MAX_LEVELS 32
#define HE_ROW 8            // (res, dense flag, ox, oy, oz, ex, ey, ez)
#define HE_PAGE_MASK 1023u  // PAGE_ENTRIES - 1: the in-segment hash range
#define HE_THREADS 256

struct LevelRows {
  int v[HE_MAX_LEVELS * HE_ROW];
};

__device__ __forceinline__ uint32_t spread9(uint32_t v) {
  v &= 0x1FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// The 8 corner entry indices and trilinear weights of one point at one
// level, as corner_indices_weights_win computes them. Corner ci takes the +1
// cell on x, y, z where bits 2, 1, 0 of ci are set.
__device__ __forceinline__ void corner_geom(const float xp[3], uint32_t base,
                                            const int* row, uint32_t idx[8],
                                            float w[8]) {
  const float r = (float)row[0];
  const bool dense = row[1] != 0;
  float fr[3][2];
  uint32_t x0[3], cs[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xs = __fmul_rn(xp[a], r);
    // clamp to the grid's last cell: x == 1.0 indexes cell r-1 with frac 1
    const float x0f = fminf(floorf(xs), __fsub_rn(r, 1.0f));
    const float frac = __fsub_rn(xs, x0f);
    fr[a][0] = __fsub_rn(1.0f, frac);
    fr[a][1] = frac;
    x0[a] = (uint32_t)x0f;
    // shifted-morton box coordinate: f32 clip, then the integer cast
    const float c = fminf(fmaxf(__fsub_rn(x0f, (float)row[2 + a]), 0.0f),
                          (float)row[5 + a]);
    cs[a] = (uint32_t)c;
  }
#pragma unroll
  for (int ci = 0; ci < 8; ++ci) {
    const uint32_t i = (ci >> 2) & 1, j = (ci >> 1) & 1, k = ci & 1;
    if (dense) {
      idx[ci] = spread9(cs[0] + i) | (spread9(cs[1] + j) << 1) |
                (spread9(cs[2] + k) << 2);
    } else {
      const uint32_t cx = x0[0] + i, cy = x0[1] + j, cz = x0[2] + k;
      // uint32 products wrap, as the host's uint32 lane math does
      idx[ci] = base + ((cx ^ (cy * 2654435761u) ^ (cz * 805459861u)) &
                        HE_PAGE_MASK);
    }
    w[ci] = __fmul_rn(__fmul_rn(fr[0][i], fr[1][j]), fr[2][k]);
  }
}

__device__ __forceinline__ void load_rows(const LevelRows& rows, int levels,
                                          int* srows) {
  for (int i = threadIdx.x; i < levels * HE_ROW; i += blockDim.x)
    srows[i] = rows.v[i];
  __syncthreads();
}

// out[p, l] (float2) = sum_c w_c * table[l, idx_c]; thread = p * L + l.
__global__ void __launch_bounds__(HE_THREADS)
he_fwd_kernel(const float2* __restrict__ table, const float* __restrict__ x,
              const int* __restrict__ base, LevelRows rows,
              float2* __restrict__ out, int64_t total, int levels,
              int64_t t) {
  __shared__ int srows[HE_MAX_LEVELS * HE_ROW];
  load_rows(rows, levels, srows);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int64_t p = tid / levels;
  const int l = (int)(tid - p * levels);
  const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
  uint32_t idx[8];
  float w[8];
  corner_geom(xp, (uint32_t)base[p], srows + l * HE_ROW, idx, w);
  const float2* tl = table + (int64_t)l * t;
  float2 f[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) f[c] = __ldg(tl + idx[c]);
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f[c].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f[c].y));
  }
  out[tid] = acc;
}

__device__ __forceinline__ void red_add2(float2* addr, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(addr, make_float2(a, b));  // one vector atomic on sm_90
#else
  atomicAdd(&addr->x, a);
  atomicAdd(&addr->y, b);
#endif
}

// dtable[l, idx_c] += w_c * g[p, l] over all points and corners of the
// levels not in `skip` (a bitmask of levels he_bwd_dense_kernel handles).
__global__ void __launch_bounds__(HE_THREADS)
he_bwd_kernel(const float2* __restrict__ g, const float* __restrict__ x,
              const int* __restrict__ base, LevelRows rows, unsigned skip,
              float2* __restrict__ dtable, int64_t total, int levels,
              int64_t t) {
  __shared__ int srows[HE_MAX_LEVELS * HE_ROW];
  load_rows(rows, levels, srows);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int64_t p = tid / levels;
  const int l = (int)(tid - p * levels);
  if ((skip >> l) & 1u) return;
  const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
  uint32_t idx[8];
  float w[8];
  corner_geom(xp, (uint32_t)base[p], srows + l * HE_ROW, idx, w);
  const float2 gv = g[tid];
  float2* dl = dtable + (int64_t)l * t;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    red_add2(dl + idx[c], __fmul_rn(w[c], gv.x), __fmul_rn(w[c], gv.y));
}

// The coarse dense levels: every point lands in a box of a few hundred
// entries, so each entry would take tens of thousands of global atomics per
// call — serialized at one L2 address, and a float32 chain that long loses
// about 1e-5 relative accuracy. Instead each block sums HE_DENSE_POINTS
// points of one level into shared memory (a float2 per entry of the level's
// morton span) and adds its nonzero partial sums to the table once.
#define HE_DENSE_SPAN 4096     // largest span summed in shared memory (32 KB)
#define HE_DENSE_POINTS 4096   // points per block

struct DenseLevels {
  int n;
  int level[HE_MAX_LEVELS];
  int span[HE_MAX_LEVELS];
};

__global__ void __launch_bounds__(HE_THREADS)
he_bwd_dense_kernel(const float2* __restrict__ g, const float* __restrict__ x,
                    const int* __restrict__ base, LevelRows rows,
                    DenseLevels dense, float* __restrict__ dtable, int n,
                    int levels, int64_t t) {
  extern __shared__ float acc[];
  __shared__ int srows[HE_MAX_LEVELS * HE_ROW];
  load_rows(rows, levels, srows);
  const int l = dense.level[blockIdx.y];
  const int span2 = 2 * dense.span[blockIdx.y];
  for (int i = threadIdx.x; i < span2; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
    uint32_t idx[8];
    float w[8];
    corner_geom(xp, (uint32_t)base[p], srows + l * HE_ROW, idx, w);
    const float2 gv = g[p * levels + l];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      atomicAdd(acc + 2 * idx[c], __fmul_rn(w[c], gv.x));
      atomicAdd(acc + 2 * idx[c] + 1, __fmul_rn(w[c], gv.y));
    }
  }
  __syncthreads();
  float* dl = dtable + (int64_t)l * t * 2;
  for (int i = threadIdx.x; i < span2; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(dl + i, v);
  }
}

// Morton span of a dense level's box (box_morton_span), 0 for hash levels.
static int dense_span(const int* row) {
  if (!row[1]) return 0;
  int bits = 0;
  for (int a = 0; a < 3; ++a) {
    int b = 0;
    while ((1 << b) < row[5 + a] + 2) ++b;
    if (b > bits) bits = b;
  }
  return 1 << (3 * bits);
}

static int launch_args(const int* rows_host, int n, int levels,
                       LevelRows* rows, int64_t* total, unsigned* blocks) {
  if (levels <= 0 || levels > HE_MAX_LEVELS || n < 0)
    return (int)cudaErrorInvalidValue;
  memset(rows, 0, sizeof(*rows));
  memcpy(rows->v, rows_host, sizeof(int) * levels * HE_ROW);
  *total = (int64_t)n * levels;
  *blocks = (unsigned)((*total + HE_THREADS - 1) / HE_THREADS);
  return 0;
}

// C interface, bound with ctypes. Pointers are device pointers except
// rows_host ([levels, 8] int32 on the host). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after each launch.
extern "C" int he_win_fwd(const void* table, const void* x, const void* base,
                          const int* rows_host, void* out, int n, int levels,
                          long long t, void* stream) {
  LevelRows rows;
  int64_t total;
  unsigned blocks;
  int err = launch_args(rows_host, n, levels, &rows, &total, &blocks);
  if (err || total == 0) return err;
  he_fwd_kernel<<<blocks, HE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)table, (const float*)x, (const int*)base, rows,
      (float2*)out, total, levels, (int64_t)t);
  return (int)cudaGetLastError();
}

extern "C" int he_win_bwd(const void* g, const void* x, const void* base,
                          const int* rows_host, void* dtable, int n,
                          int levels, long long t, void* stream) {
  LevelRows rows;
  int64_t total;
  unsigned blocks;
  int err = launch_args(rows_host, n, levels, &rows, &total, &blocks);
  if (err || total == 0) return err;
  DenseLevels dense;
  memset(&dense, 0, sizeof(dense));
  unsigned skip = 0;
  int max_span = 0;
  for (int l = 0; l < levels; ++l) {
    const int span = dense_span(rows.v + l * HE_ROW);
    if (span == 0 || span > HE_DENSE_SPAN || span > t) continue;
    dense.level[dense.n] = l;
    dense.span[dense.n] = span;
    dense.n++;
    skip |= 1u << l;
    if (span > max_span) max_span = span;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (skip != (levels == 32 ? 0xFFFFFFFFu : (1u << levels) - 1u)) {
    he_bwd_kernel<<<blocks, HE_THREADS, 0, s>>>(
        (const float2*)g, (const float*)x, (const int*)base, rows, skip,
        (float2*)dtable, total, levels, (int64_t)t);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (dense.n) {
    dim3 grid((unsigned)((n + HE_DENSE_POINTS - 1) / HE_DENSE_POINTS),
              (unsigned)dense.n);
    he_bwd_dense_kernel<<<grid, HE_THREADS, 2 * max_span * sizeof(float),
                          s>>>((const float2*)g, (const float*)x,
                               (const int*)base, rows, dense, (float*)dtable,
                               n, levels, (int64_t)t);
    err = (int)cudaGetLastError();
  }
  return err;
}

extern "C" const char* he_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
