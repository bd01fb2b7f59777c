// Hash-grid encode from precomputed corner indices and weights, for Hopper
// (sm_90a): forward gather-and-blend and backward scatter-add.
//
//   out[n, l, :]        = sum_c w[l, c, n] * table[l, idx[l, c, n], :]
//   dtable[l, idx, :]  += w[l, c, n] * g[n, l, :]
//
// Replaces four Pallas kernels that compute this one function:
//   spinnerf_tpu/ops/hash_encode.py      _fwd_kernel (:78), _bwd_kernel (:113)
//                                        (hash_encode_mxu, the XOR-prime and
//                                        dense index, tables <= 2^12)
//   spinnerf_tpu/ops/hash_encode_win.py  _win_fwd_kernel (:316),
//                                        _win_bwd_kernel (:359)
//                                        (hash_encode_win, the windowed index)
// The TPU kernels reach the table through one-hot MXU products or two-page
// windows; here every corner is a direct gather, at any table size and point
// count, with no rounding of the table or of w*g to bf16.
//
// What bounds it on an H100: bytes. Every (point, level) reads 8 int32
// indices and 8 f32 weights (64 bytes, [L, 8, N]: coalesced along points)
// and gathers 8 scattered 8-byte table entries; the blend is 32 flops. The
// forward gives a warp 32 consecutive points of one level, so each index and
// weight row is one 128-byte line, and stages the [32 points, L] output tile
// in shared memory so that its store to out [N, L, 2] is contiguous.
//
// The backward is a scatter-add with contention: at the reference's
// bound = 100 a scene occupies ~5 % of the unit cube per axis, so on the
// coarse levels a few hundred table entries receive every point's update —
// tens of thousands of f32 atomics on one address, slow and (measured on
// the windowed pair, PERF.md) near 1e-5 relative error. So each block sums
// the updates of a run of points at one level in shared memory first and
// adds each partial sum to the table once:
//   - hi_bwd_level_kernel, tables of at most HI_LEVEL_CAP entries: the whole
//     level row is staged (32 KB at 2^12 entries);
//   - hi_bwd_map_kernel, larger tables: the indices are arbitrary (the XOR
//     hash scatters neighbouring cells over the whole row), so a shared
//     open-addressing map keyed by the entry index collects the sums. An
//     update that finds no slot in PROBES probes goes straight to the
//     table with a global atomic: nothing is dropped. With PROBES = 0 every
//     update is a global atomic (the design without staging, kept so that
//     the smoke run can time it beside the map).
// An index outside [0, T) is skipped by both passes: it reads as zero and
// receives no gradient (the index functions never produce one).
#include <cuda_runtime.h>
#include <stdint.h>

#define HI_MAX_LEVELS 32
#define HI_PTS 32            // forward: points per block (one warp a level row)
#define HI_LROWS 8           // forward: level rows per block, blockDim (32, 8)
#define HI_THREADS 256       // backward threads per block
#define HI_LEVEL_CAP 8192    // largest table staged whole (64 KB of float2)
#define HI_LEVEL_PTS 4096    // points per block of the whole-level backward
#define HI_MAP_LOG2 13
#define HI_MAP_SLOTS (1 << HI_MAP_LOG2)  // 8192 slots: 96 KB of keys + sums
#define HI_MAP_PTS 1024      // points per block: <= 8192 distinct keys
#define HI_MAP_PROBES 8    // probes of the default map path
#define HI_EMPTY (-1)

__global__ void __launch_bounds__(HI_PTS * HI_LROWS)
hi_fwd_kernel(const float2* __restrict__ table, const int* __restrict__ idx,
              const float* __restrict__ w, float2* __restrict__ out, int n,
              int levels, int t) {
  __shared__ float2 tile[HI_PTS * HI_MAX_LEVELS];
  const int n0 = blockIdx.x * HI_PTS;
  const int p = threadIdx.x;
  const int pt = n0 + p;
  for (int l = threadIdx.y; l < levels; l += HI_LROWS) {
    float2 acc = make_float2(0.0f, 0.0f);
    if (pt < n) {
      const int* il = idx + (int64_t)l * 8 * n + pt;
      const float* wl = w + (int64_t)l * 8 * n + pt;
      const float2* tl = table + (int64_t)l * t;
      int ic[8];
      float wc[8];
      float2 f[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        ic[c] = __ldg(il + (int64_t)c * n);
        wc[c] = __ldg(wl + (int64_t)c * n);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        f[c] = (unsigned)ic[c] < (unsigned)t ? __ldg(tl + ic[c])
                                             : make_float2(0.0f, 0.0f);
      // corners in the order 0..7, f32, no FMA contraction
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc.x = __fadd_rn(acc.x, __fmul_rn(wc[c], f[c].x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(wc[c], f[c].y));
      }
    }
    tile[p * levels + l] = acc;
  }
  __syncthreads();
  // the block's rows of out [N, L, 2] are one contiguous run of float2
  const int npts = min(HI_PTS, n - n0);
  float2* dst = out + (int64_t)n0 * levels;
  for (int i = threadIdx.y * HI_PTS + threadIdx.x; i < npts * levels;
       i += HI_PTS * HI_LROWS)
    dst[i] = tile[i];
}

__device__ __forceinline__ void red_add2(float2* addr, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(addr, make_float2(a, b));  // one vector atomic on sm_90
#else
  atomicAdd(&addr->x, a);
  atomicAdd(&addr->y, b);
#endif
}

// Tables of at most HI_LEVEL_CAP entries: block (x, l) sums HI_LEVEL_PTS
// points of level l into a shared copy of the whole level row.
__global__ void __launch_bounds__(HI_THREADS)
hi_bwd_level_kernel(const float2* __restrict__ g, const int* __restrict__ idx,
                    const float* __restrict__ w, float* __restrict__ dtable,
                    int n, int levels, int t) {
  extern __shared__ float acc[];  // [t][2]
  const int l = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * t; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const int n0 = blockIdx.x * HI_LEVEL_PTS;
  const int n1 = min(n, n0 + HI_LEVEL_PTS);
  const int* il = idx + (int64_t)l * 8 * n;
  const float* wl = w + (int64_t)l * 8 * n;
  for (int p = n0 + threadIdx.x; p < n1; p += blockDim.x) {
    const float2 gv = g[(int64_t)p * levels + l];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = il[(int64_t)c * n + p];
      const float wc = wl[(int64_t)c * n + p];
      if ((unsigned)i < (unsigned)t) {
        atomicAdd(acc + 2 * i, __fmul_rn(wc, gv.x));
        atomicAdd(acc + 2 * i + 1, __fmul_rn(wc, gv.y));
      }
    }
  }
  __syncthreads();
  float* dl = dtable + (int64_t)l * t * 2;
  for (int i = threadIdx.x; i < 2 * t; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(dl + i, v);
  }
}

// Larger tables: block (x, l) sums HI_MAP_PTS points of level l into a
// shared open-addressing map (linear probing, keys never removed, so a key
// read back from a slot is final), then adds each slot's sum to the table.
template <int PROBES>
__global__ void __launch_bounds__(HI_THREADS)
hi_bwd_map_kernel(const float2* __restrict__ g, const int* __restrict__ idx,
                  const float* __restrict__ w, float2* __restrict__ dtable,
                  int n, int levels, int t) {
  extern __shared__ int smem[];
  int* keys = smem;                                   // [SLOTS]
  float* sums = reinterpret_cast<float*>(smem + HI_MAP_SLOTS);  // [SLOTS][2]
  for (int s = threadIdx.x; PROBES > 0 && s < HI_MAP_SLOTS; s += blockDim.x) {
    keys[s] = HI_EMPTY;
    sums[2 * s] = 0.0f;
    sums[2 * s + 1] = 0.0f;
  }
  __syncthreads();
  const int l = blockIdx.y;
  const int n0 = blockIdx.x * HI_MAP_PTS;
  const int n1 = min(n, n0 + HI_MAP_PTS);
  const int* il = idx + (int64_t)l * 8 * n;
  const float* wl = w + (int64_t)l * 8 * n;
  float2* dl = dtable + (int64_t)l * t;
  volatile int* vkeys = keys;
  for (int p = n0 + threadIdx.x; p < n1; p += blockDim.x) {
    const float2 gv = g[(int64_t)p * levels + l];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = il[(int64_t)c * n + p];
      if ((unsigned)i >= (unsigned)t) continue;
      const float wc = wl[(int64_t)c * n + p];
      const float a = __fmul_rn(wc, gv.x), b = __fmul_rn(wc, gv.y);
      unsigned s = ((unsigned)i * 2654435761u) >> (32 - HI_MAP_LOG2);
      bool done = false;
      for (int k = 0; k < PROBES; ++k) {
        int cur = vkeys[s];
        // EMPTY back from the CAS: this thread wrote the key
        if (cur == HI_EMPTY) cur = atomicCAS(keys + s, HI_EMPTY, i);
        if (cur == HI_EMPTY || cur == i) {
          atomicAdd(sums + 2 * s, a);
          atomicAdd(sums + 2 * s + 1, b);
          done = true;
          break;
        }
        s = (s + 1) & (HI_MAP_SLOTS - 1);
      }
      if (!done) red_add2(dl + i, a, b);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; PROBES > 0 && s < HI_MAP_SLOTS; s += blockDim.x) {
    const int k = keys[s];
    if (k != HI_EMPTY) red_add2(dl + k, sums[2 * s], sums[2 * s + 1]);
  }
}

static int check_args(int n, int levels, long long t) {
  if (n < 0 || levels <= 0 || levels > HI_MAX_LEVELS || t <= 0 ||
      t > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// C interface, bound with ctypes. All pointers are device pointers: table
// and dtable [L, T, 2] f32, idx [L, 8, N] int32, w [L, 8, N] f32, out and g
// [N, L, 2] f32; dtable must be zeroed by the caller. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after each launch.
// hi_bwd's `variant` picks the backward: 0 the default (whole-level staging
// up to HI_LEVEL_CAP entries, else the map), 1 the map at any size, 2 global
// atomics only. 1 and 2 exist to be timed against 0.
extern "C" int hi_fwd(const void* table, const void* idx, const void* w,
                      void* out, int n, int levels, long long t,
                      void* stream) {
  int err = check_args(n, levels, t);
  if (err || n == 0) return err;
  const dim3 block(HI_PTS, HI_LROWS);
  const unsigned blocks = (unsigned)((n + HI_PTS - 1) / HI_PTS);
  hi_fwd_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
      (const float2*)table, (const int*)idx, (const float*)w, (float2*)out, n,
      levels, (int)t);
  return (int)cudaGetLastError();
}

extern "C" int hi_bwd(const void* g, const void* idx, const void* w,
                      void* dtable, int n, int levels, long long t,
                      int variant, void* stream) {
  int err = check_args(n, levels, t);
  if (!err && (variant < 0 || variant > 2)) err = (int)cudaErrorInvalidValue;
  if (err || n == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0 && t <= HI_LEVEL_CAP) {
    const int smem = (int)(2 * t * sizeof(float));
    err = (int)cudaFuncSetAttribute(hi_bwd_level_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem);
    if (err) return err;
    const dim3 grid((unsigned)((n + HI_LEVEL_PTS - 1) / HI_LEVEL_PTS),
                    (unsigned)levels);
    hi_bwd_level_kernel<<<grid, HI_THREADS, smem, s>>>(
        (const float2*)g, (const int*)idx, (const float*)w, (float*)dtable, n,
        levels, (int)t);
  } else {
    const dim3 grid((unsigned)((n + HI_MAP_PTS - 1) / HI_MAP_PTS),
                    (unsigned)levels);
    if (variant == 2) {
      hi_bwd_map_kernel<0><<<grid, HI_THREADS, 0, s>>>(
          (const float2*)g, (const int*)idx, (const float*)w, (float2*)dtable,
          n, levels, (int)t);
      return (int)cudaGetLastError();
    }
    const int smem = HI_MAP_SLOTS * (int)(sizeof(int) + 2 * sizeof(float));
    err = (int)cudaFuncSetAttribute(hi_bwd_map_kernel<HI_MAP_PROBES>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem);
    if (err) return err;
    hi_bwd_map_kernel<HI_MAP_PROBES><<<grid, HI_THREADS, smem, s>>>(
        (const float2*)g, (const int*)idx, (const float*)w, (float2*)dtable,
        n, levels, (int)t);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
