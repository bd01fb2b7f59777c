// Hash-grid encode by index gather, for Hopper (sm_90a): forward
// gather-and-blend and backward scatter-add, with the corners of each
// (point, level) taken from one of two sources.
//
//   out[n, l, :]        = sum_c w[l, c, n] * table[l, idx[l, c, n], :]
//   dtable[l, idx, :]  += w[l, c, n] * g[n, l, :]
//
// Replaces four Pallas kernels that compute this one function:
//   spinnerf_tpu/ops/hash_encode.py      _fwd_kernel (:78), _bwd_kernel (:113)
//                                        (hash_encode_mxu, the instant-NGP
//                                        index, tables <= 2^12)
//   spinnerf_tpu/ops/hash_encode_win.py  _win_fwd_kernel (:316),
//                                        _win_bwd_kernel (:359)
//                                        (hash_encode_win, the windowed index)
// The TPU kernels reach the table through one-hot MXU products or two-page
// windows; here every corner is a direct gather, at any table size and point
// count, with no rounding of the table or of w*g to bf16.
//
// The corners' two sources, one template parameter of each kernel:
//   - IdxCorners (idx mode): idx / w [L, 8, N] read from memory, 64 bytes a
//     (point, level) — the function JAX's hash_encode_mxu(table, idx, w)
//     defines, behind hash_encode_mxu and hash_encode_win on the card;
//   - PointCorners (points mode, the field's path): x [N, 3] in [0, 1] and
//     the levels' (resolution, dense flag); each thread rebuilds its 8
//     indices and weights in registers as corner_indices_weights_ngp does
//     (ops/hash_encode.py): xs = r*x, frac = xs - floor(xs) with no clamp at
//     the last cell; the linear index (cx*(r+1) + cy)*(r+1) + cz on dense
//     levels, cx ^ cy*2654435761 ^ cz*805459861 (uint32) on the others;
//     & (T-1); w = (wx*wy)*wz. 12 bytes a point instead of 64 a (point,
//     level), and nothing for autograd to keep between the passes.
// Gather, blend and scatter are the same code for both.
//
// What bounds it on an H100. Forward: 8 scattered 8-byte gathers a (point,
// level) from a 64 MiB table (2^19 entries x 16 levels, more than the 50 MB
// L2); the blend is 32 flops. A block takes 32 points x all levels, a warp
// one level row of 32 consecutive points (samples of one ray, so the coarse
// levels' gathers share lines), the 8 gathers issued before the blend, and
// the [32 points, L] output tile staged in shared memory so that its store
// to out [N, L, 2] is contiguous.
//
// Backward: a scatter-add whose contention differs by level (PERF.md §6,
// the census): on the coarse levels of the reference's scenes (bound 100:
// the scene fills ~5 % of the cube per axis) tens of thousands of points
// share an entry; on the fine hashed levels an entry gets ~4 contributions
// over the whole batch. One kernel, its blocks level-major (all blocks of a
// level before the next, so that the level's gradient row stays in L2
// while its reductions land), each block taking a run of consecutive points
// of one level in one of three regimes, planned on the host per level from
// its geometry (ops/hash_encode.py::bwd_plan; the plan changes the speed,
// never the result):
//   - HI_STAGED (tables of at most HI_LEVEL_CAP entries): the level row is
//     summed whole in shared memory, then added to the table once a block;
//   - HI_MAP (hot levels of larger tables): a shared open-addressing map
//     (linear probing, keys never removed), sized by the plan to the
//     block's distinct entries, collects the sums; an update that finds no
//     slot in HI_MAP_PROBES probes goes straight to the table; the map is
//     added to the table once a block;
//   - HI_DIRECT (sparse levels): each corner goes straight to the table as
//     a vector reduction, two corners in one where they can: corners ci and
//     ci+4 differ only in cx, and where cx is even the XOR hash (prime 1 on
//     x) puts them on entries e and e^1, one 16-byte pair, so one
//     red.global.add.v4.f32 carries both (the forward gathers such a pair
//     with one 16-byte load).
// In every regime the lanes of a warp whose corners share an entry are
// summed first (warp_add: __match_any_sync, then a group sum), so a hot
// entry takes one update a warp. Shared sums are updated with one 64-bit
// compare-and-swap (both features at once; two f32 shared adds measured
// slower). What bounds the backward is then not bytes (x, g and one write
// of the table take ~0.031 ms at 262,144 points) but the fine levels'
// global reductions, most of its time, and the hot levels' shared
// updates (PERF.md §6).
//
// The fixed-order variant (hi_bwd_fix, hi_bwd_pts_fix; taken under
// torch.use_deterministic_algorithms): the sums above are f32 adds whose
// order follows the scheduling (the warps' shared updates, the map's slot
// order, which comes from compare-and-swap races, and the global
// reductions), so two launches on the same inputs differ in the last bits.
// The variant rounds each contribution w * g once to an integer multiple of
// 1 / scale and adds the integers as int64 in the same regimes, into int64
// pairs in shared memory and then into an int64 copy of the gradient in
// scratch, which one more kernel converts to f32 (hi_fix_out_kernel):
// integer sums are exact, so no order of adds, inserts or blocks moves a
// bit. scale = 2^(61 - e) with 2^e > 16 N max|g| max|w| (max|w| = 1 in
// points mode; a first kernel finds the maxima), above any sum an entry can
// reach (8 corners a point), so no sum overflows, and a contribution moves
// by at most 32 N max|g| max|w| 2^-62, far below the f32 sums' own
// rounding. A non-finite input makes every entry NaN. As csrc/
// hash_encode_win.cu does for the windowed backward.
//
// Bit-exactness: points mode's indices and weights must equal the host's
// bit for bit, so the geometry rounds with __fmul_rn / __fsub_rn and the
// library is built with -fmad=false. Never build with --use_fast_math.
// An index outside [0, T) (idx mode only) reads as zero and receives no
// gradient.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define HI_MAX_LEVELS 32
#define HI_PTS 32            // forward: points per block (one warp a level row)
#define HI_LROWS 8           // forward: level rows per block, blockDim (32, 8)
#define HI_THREADS 256       // backward threads per block
// The backward's regimes and limits, mirrored in ops/hash_encode.py.
#define HI_DIRECT 0
#define HI_STAGED 1
#define HI_MAP 2
#define HI_LEVEL_CAP 8192    // largest staged level row (64 KB of float2)
#define HI_MAP_MIN 64        // map slots: a power of two in [MIN, CAP]
#define HI_MAP_CAP 8192      // (96 KB of sums and keys)
#define HI_MAP_PROBES 8
#define HI_EMPTY 0xFFFFFFFFu

// ---------------------------------------------------------------------------
// the corners' sources
// ---------------------------------------------------------------------------

struct IdxCorners {
  static constexpr bool unit_w = false;   // the weights are inputs
  const int* idx;  // [L, 8, N]
  const float* w;  // [L, 8, N]
  int64_t n;
  __device__ __forceinline__ void operator()(int64_t p, int l, uint32_t ic[8],
                                             float wc[8]) const {
    const int64_t o = (int64_t)l * 8 * n + p;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ic[c] = (uint32_t)__ldg(idx + o + c * n);
      wc[c] = __ldg(w + o + c * n);
    }
  }
};

struct NgpLevels {
  int res[HI_MAX_LEVELS];
  int dense[HI_MAX_LEVELS];
};

struct PointCorners {
  static constexpr bool unit_w = true;    // products of fractions in [0, 1]
  const float* x;  // [N, 3]
  NgpLevels lv;
  uint32_t mask;   // T - 1
  // Corner ci takes the +1 cell on x, y, z where bits 2, 1, 0 of ci are set.
  __device__ __forceinline__ void operator()(int64_t p, int l, uint32_t ic[8],
                                             float wc[8]) const {
    const float r = (float)lv.res[l];
    const uint32_t r1 = (uint32_t)lv.res[l] + 1u;
    const bool dense = lv.dense[l] != 0;
    float fr[3][2];
    uint32_t c0[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float xs = __fmul_rn(r, __ldg(x + 3 * p + a));
      const float x0f = floorf(xs);
      const float frac = __fsub_rn(xs, x0f);
      fr[a][0] = __fsub_rn(1.0f, frac);
      fr[a][1] = frac;
      c0[a] = (uint32_t)(int)x0f;
    }
#pragma unroll
    for (int ci = 0; ci < 8; ++ci) {
      const uint32_t i = (ci >> 2) & 1, j = (ci >> 1) & 1, k = ci & 1;
      const uint32_t cx = c0[0] + i, cy = c0[1] + j, cz = c0[2] + k;
      // uint32 products wrap, as the host's int32 bit arithmetic does
      const uint32_t h = dense ? (cx * r1 + cy) * r1 + cz
                               : cx ^ (cy * 2654435761u) ^ (cz * 805459861u);
      ic[ci] = h & mask;
      wc[ci] = __fmul_rn(__fmul_rn(fr[0][i], fr[1][j]), fr[2][k]);
    }
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Corners ci and ci+4 differ only in cx; where cx is even the XOR hash puts
// them on entries e and e^1, the two halves of one 16-byte pair (`pairs`:
// T is even and the row 16-byte aligned).
__device__ __forceinline__ bool paired(uint32_t e0, uint32_t e1, uint32_t t) {
  return (e0 ^ e1) == 1u && e0 < t && e1 < t;
}

// The 8 gathers first (a paired ci / ci+4 as one 16-byte load), then the
// blend in corner order 0..7, f32, no FMA.
__device__ __forceinline__ float2 gather_blend(const float2* __restrict__ tl,
                                               const uint32_t ic[8],
                                               const float wc[8], uint32_t t,
                                               bool pairs) {
  float2 f[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t e0 = ic[c], e1 = ic[c + 4];
    if (pairs && paired(e0, e1, t)) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(tl + (e0 & ~1u)));
      const float2 lo = make_float2(v.x, v.y), hi = make_float2(v.z, v.w);
      f[c] = (e0 & 1u) ? hi : lo;
      f[c + 4] = (e0 & 1u) ? lo : hi;
    } else {
      f[c] = e0 < t ? __ldg(tl + e0) : make_float2(0.0f, 0.0f);
      f[c + 4] = e1 < t ? __ldg(tl + e1) : make_float2(0.0f, 0.0f);
    }
  }
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(wc[c], f[c].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(wc[c], f[c].y));
  }
  return acc;
}

template <class Corners>
__global__ void __launch_bounds__(HI_PTS * HI_LROWS)
hi_fwd_kernel(const float2* __restrict__ table, Corners corners,
              float2* __restrict__ out, int n, int levels, uint32_t t,
              bool pairs) {
  __shared__ float2 tile[HI_PTS * HI_MAX_LEVELS];
  const int n0 = blockIdx.x * HI_PTS;
  const int p = threadIdx.x;
  const int pt = n0 + p;
  for (int l = threadIdx.y; l < levels; l += HI_LROWS) {
    float2 acc = make_float2(0.0f, 0.0f);
    if (pt < n) {
      uint32_t ic[8];
      float wc[8];
      corners(pt, l, ic, wc);
      acc = gather_blend(table + (int64_t)l * t, ic, wc, t, pairs);
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The launch's plan, per level: regime, points a block takes, staged
// entries (HI_STAGED) or map slots (HI_MAP), and the level's first block.
struct BwdPlan {
  int regime[HI_MAX_LEVELS];
  int pts[HI_MAX_LEVELS];
  int size[HI_MAX_LEVELS];
  int first[HI_MAX_LEVELS + 1];
};

__device__ __forceinline__ void red_add2(float2* addr, float a, float b) {
  atomicAdd(addr, make_float2(a, b));  // one vector reduction on sm_90
}

// Adds (a, b) to a float2 in shared memory with one 64-bit compare-and-swap
// loop: both features in one update.
__device__ __forceinline__ void smem_add2(float2* p, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(q);
  while (true) {
    float2 v;
    memcpy(&v, &cur, sizeof(v));
    v.x = __fadd_rn(v.x, a);
    v.y = __fadd_rn(v.y, b);
    unsigned long long next;
    memcpy(&next, &v, sizeof(next));
    const unsigned long long seen = atomicCAS(q, cur, next);
    if (seen == cur) break;
    cur = seen;
  }
}

template <class T, int K>
struct Vals {
  T v[K];
};

__device__ __forceinline__ float vsum(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ long long vsum(long long a, long long b) {
  return a + b;
}

// Adds `val` at `key` for every lane of `active` (the lanes that call; a
// prefix of the warp), as warp_add in hash_encode_win.cu: lanes whose keys
// are equal are summed first (an inclusive prefix sum over each group, in
// lane order, by pointer jumping) and the highest lane of each group calls
// add(key, sum). A warp with no two adjacent lanes on one entry skips the
// match; HI_EMPTY keys (nothing to add) never count as a match.
template <class T, int K, class Add>
__device__ __forceinline__ void warp_add(unsigned active, uint32_t key,
                                         Vals<T, K> val, const Add& add) {
  const unsigned lane = threadIdx.x & 31u;
  const uint32_t below = __shfl_up_sync(active, key, 1);
  if (!__any_sync(active, lane > 0 && below == key && key != HI_EMPTY)) {
    add(key, val);
    return;
  }
  const unsigned peers = __match_any_sync(active, key);
  const unsigned lower = peers & ((1u << lane) - 1u);
  int prev = lower ? 31 - __clz(lower) : -1;
  const unsigned most = __reduce_max_sync(active, (unsigned)__popc(peers));
  for (unsigned reach = 1; reach < most; reach <<= 1) {
    const int src = prev >= 0 ? prev : (int)lane;
    Vals<T, K> o;
#pragma unroll
    for (int i = 0; i < K; ++i) o.v[i] = __shfl_sync(active, val.v[i], src);
    const int pp = __shfl_sync(active, prev, src);
    if (prev >= 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) val.v[i] = vsum(val.v[i], o.v[i]);
      prev = pp;
    }
  }
  if ((peers >> lane) == 1u) add(key, val);
}

// The three regimes' updates. A key beyond the row (idx mode's
// out-of-range index, or HI_EMPTY) adds nothing.

// HI_DIRECT: one reduction a 16-byte pair of entries (key = entry / 2).
struct PairAdd {
  float4* dl;
  uint32_t pairs;  // T / 2
  __device__ __forceinline__ void operator()(uint32_t k,
                                             const Vals<float, 4>& v) const {
    if (k < pairs)
      atomicAdd(dl + k, make_float4(v.v[0], v.v[1], v.v[2], v.v[3]));
  }
};

struct StagedAdd {
  float2* acc;
  float2* dl;
  uint32_t size, t;
  __device__ __forceinline__ void operator()(uint32_t k,
                                             const Vals<float, 2>& v) const {
    if (k < size)
      smem_add2(acc + k, v.v[0], v.v[1]);
    else if (k < t)
      red_add2(dl + k, v.v[0], v.v[1]);
  }
};

struct MapAdd {
  float2* acc;
  uint32_t* keys;
  float2* dl;
  uint32_t mask, shift, t;
  __device__ __forceinline__ void operator()(uint32_t k,
                                             const Vals<float, 2>& v) const {
    if (k >= t) return;
    volatile uint32_t* vkeys = keys;
    uint32_t s = (k * 2654435761u) >> shift;
#pragma unroll 1
    for (int probe = 0; probe < HI_MAP_PROBES; ++probe) {
      uint32_t cur = vkeys[s];
      // HI_EMPTY back from the CAS: this thread wrote the key
      if (cur == HI_EMPTY) cur = atomicCAS(keys + s, HI_EMPTY, k);
      if (cur == HI_EMPTY || cur == k) {
        smem_add2(acc + s, v.v[0], v.v[1]);
        return;
      }
      s = (s + 1) & mask;
    }
    red_add2(dl + k, v.v[0], v.v[1]);
  }
};

// The fixed-order variant's updates: int64 pairs, added with 64-bit integer
// atomics (exact, so their order does not matter), in shared memory or in
// the level's row `gl` of the int64 gradient.
__device__ __forceinline__ void fix_add2(longlong2* p, long long a,
                                         long long b) {
  if (a) atomicAdd(reinterpret_cast<unsigned long long*>(&p->x),
                   (unsigned long long)a);
  if (b) atomicAdd(reinterpret_cast<unsigned long long*>(&p->y),
                   (unsigned long long)b);
}

typedef Vals<long long, 2> Fix2;

struct DirectFixAdd {
  longlong2* gl;
  uint32_t t;
  __device__ __forceinline__ void operator()(uint32_t k, const Fix2& v) const {
    if (k < t) fix_add2(gl + k, v.v[0], v.v[1]);
  }
};

struct StagedFixAdd {
  longlong2* acc;
  longlong2* gl;
  uint32_t size, t;
  __device__ __forceinline__ void operator()(uint32_t k, const Fix2& v) const {
    if (k < size)
      fix_add2(acc + k, v.v[0], v.v[1]);
    else if (k < t)
      fix_add2(gl + k, v.v[0], v.v[1]);
  }
};

struct MapFixAdd {
  longlong2* acc;
  uint32_t* keys;
  longlong2* gl;
  uint32_t mask, shift, t;
  __device__ __forceinline__ void operator()(uint32_t k, const Fix2& v) const {
    if (k >= t) return;
    volatile uint32_t* vkeys = keys;
    uint32_t s = (k * 2654435761u) >> shift;
#pragma unroll 1
    for (int probe = 0; probe < HI_MAP_PROBES; ++probe) {
      uint32_t cur = vkeys[s];
      if (cur == HI_EMPTY) cur = atomicCAS(keys + s, HI_EMPTY, k);
      if (cur == HI_EMPTY || cur == k) {
        fix_add2(acc + s, v.v[0], v.v[1]);
        return;
      }
      s = (s + 1) & mask;
    }
    fix_add2(gl + k, v.v[0], v.v[1]);
  }
};

// A contribution as the sums take it: f32 (AsF32), or rounded once to a
// multiple of 1 / scale (AsFix).
struct AsF32 {
  typedef float T;
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

struct AsFix {
  typedef long long T;
  double scale;
  __device__ __forceinline__ long long operator()(float v) const {
    return __double2ll_rn((double)v * scale);
  }
};

struct FixScale {
  double scale, inv;
};

// The launch's scale from amax (max|g|, max|w| as f32 bits; max|w| taken
// as 1 where `unit_w`) and the point count: 2^(61 - e) with 16 n max|g|
// max|w| < 2^e. A non-finite bound gives inv = NaN: every entry NaN.
__device__ __forceinline__ FixScale fix_scale(const unsigned* amax,
                                              long long n, bool unit_w) {
  const double b = 16.0 * (double)n * (double)__uint_as_float(amax[0]) *
                   (unit_w ? 1.0 : (double)__uint_as_float(amax[1]));
  if (!(b <= 1.0e308)) return {0.0, __longlong_as_double(0x7FF8000000000000LL)};
  int e = 0;
  if (b > 0.0) frexp(b, &e);
  e = max(e, -960);   // keeps the scale finite for denormal inputs
  return {ldexp(1.0, 61 - e), ldexp(1.0, e - 61)};
}

// Sums the points [p0, p1) of level l into add, one corner at a time: one
// point a thread, HI_THREADS at a time, warps kept converged for warp_add.
// `val` turns each f32 contribution into what `add` sums.
template <class Corners, class Val, class Add>
__device__ __forceinline__ void scatter(const float2* __restrict__ g,
                                        const Corners& corners, int64_t p0,
                                        int64_t p1, int l, int levels,
                                        uint32_t t, const Val& val,
                                        const Add& add) {
  for (int64_t i0 = p0; i0 < p1; i0 += HI_THREADS) {
    const int64_t p = i0 + threadIdx.x;
    const bool on = p < p1;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
    if (!on) continue;
    uint32_t ic[8];
    float wc[8];
    corners(p, l, ic, wc);
    const float2 gv = g[p * levels + l];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const bool ok = ic[c] < t;
      warp_add(active, ok ? ic[c] : HI_EMPTY,
               Vals<typename Val::T, 2>{
                   {val(ok ? __fmul_rn(wc[c], gv.x) : 0.0f),
                    val(ok ? __fmul_rn(wc[c], gv.y) : 0.0f)}},
               add);
    }
  }
}

// The entry's half of a pair's four floats.
__device__ __forceinline__ void put_half(Vals<float, 4>& v, uint32_t e, float a,
                                         float b) {
  if (e & 1u) {
    v.v[2] = a;
    v.v[3] = b;
  } else {
    v.v[0] = a;
    v.v[1] = b;
  }
}

// scatter for HI_DIRECT (T even, the row 16-byte aligned): corners ci and
// ci+4 on one 16-byte pair go to the table as one red.global.add.v4.f32,
// the others one a reduction (the pair's other half 0).
template <class Corners>
__device__ __forceinline__ void scatter_pairs(const float2* __restrict__ g,
                                              const Corners& corners,
                                              int64_t p0, int64_t p1, int l,
                                              int levels, uint32_t t,
                                              float2* dl) {
  const PairAdd add{reinterpret_cast<float4*>(dl), t >> 1};
  for (int64_t i0 = p0; i0 < p1; i0 += HI_THREADS) {
    const int64_t p = i0 + threadIdx.x;
    const bool on = p < p1;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
    if (!on) continue;
    uint32_t ic[8];
    float wc[8];
    corners(p, l, ic, wc);
    const float2 gv = g[p * levels + l];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t e0 = ic[c], e1 = ic[c + 4];
      const bool both = paired(e0, e1, t);
      Vals<float, 4> v{{0.0f, 0.0f, 0.0f, 0.0f}};
      put_half(v, e0, __fmul_rn(wc[c], gv.x), __fmul_rn(wc[c], gv.y));
      if (both)
        put_half(v, e1, __fmul_rn(wc[c + 4], gv.x),
                 __fmul_rn(wc[c + 4], gv.y));
      warp_add(active, e0 < t ? e0 >> 1 : HI_EMPTY, v, add);
      Vals<float, 4> u{{0.0f, 0.0f, 0.0f, 0.0f}};
      put_half(u, e1, __fmul_rn(wc[c + 4], gv.x), __fmul_rn(wc[c + 4], gv.y));
      warp_add(active, !both && e1 < t ? e1 >> 1 : HI_EMPTY, u, add);
    }
  }
}

// Block b takes level l (plan.first[l] <= b < plan.first[l + 1]) and its
// points [(b - first[l]) * pts[l], + pts[l]). FIX: the fixed-order variant,
// every sum into the int64 gradient acc64 [L, T] (amax: max|g|, max|w|).
template <class Corners, bool FIX>
__global__ void __launch_bounds__(HI_THREADS)
hi_bwd_kernel(const float2* __restrict__ g, Corners corners, BwdPlan plan,
              float2* __restrict__ dtable, int n, int levels, uint32_t t,
              longlong2* __restrict__ acc64, const unsigned* __restrict__ amax) {
  extern __shared__ __align__(16) unsigned char smem[];
  int l = 0;
  while (l + 1 < levels && (int)blockIdx.x >= plan.first[l + 1]) ++l;
  const int regime = plan.regime[l];
  const int64_t p0 = (int64_t)(blockIdx.x - plan.first[l]) * plan.pts[l];
  const int64_t p1 = min((int64_t)n, p0 + plan.pts[l]);
  float2* dl = dtable + (int64_t)l * t;
  const uint32_t size = (uint32_t)plan.size[l];
  const bool map = regime == HI_MAP;
  if constexpr (FIX) {
    const AsFix fix{fix_scale(amax, n, Corners::unit_w).scale};
    longlong2* gl = acc64 + (int64_t)l * t;
    if (regime == HI_DIRECT) {
      scatter(g, corners, p0, p1, l, levels, t, fix, DirectFixAdd{gl, t});
      return;
    }
    longlong2* acc = reinterpret_cast<longlong2*>(smem);     // [size]
    uint32_t* keys = reinterpret_cast<uint32_t*>(acc + size);  // [size] (map)
    for (uint32_t i = threadIdx.x; i < size; i += HI_THREADS) {
      acc[i] = make_longlong2(0, 0);
      if (map) keys[i] = HI_EMPTY;
    }
    __syncthreads();
    if (map)
      scatter(g, corners, p0, p1, l, levels, t, fix,
              MapFixAdd{acc, keys, gl, size - 1, (uint32_t)__clz(size) + 1u,
                        t});
    else
      scatter(g, corners, p0, p1, l, levels, t, fix,
              StagedFixAdd{acc, gl, size, t});
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < size; i += HI_THREADS) {
      const uint32_t k = map ? keys[i] : i;
      if (k != HI_EMPTY) fix_add2(gl + k, acc[i].x, acc[i].y);
    }
  } else {
    if (regime == HI_DIRECT) {
      scatter_pairs(g, corners, p0, p1, l, levels, t, dl);
      return;
    }
    float2* acc = reinterpret_cast<float2*>(smem);       // [size]
    uint32_t* keys = reinterpret_cast<uint32_t*>(acc + size);  // [size] (map)
    for (uint32_t i = threadIdx.x; i < size; i += HI_THREADS) {
      acc[i] = make_float2(0.0f, 0.0f);
      if (map) keys[i] = HI_EMPTY;
    }
    __syncthreads();
    if (map)
      scatter(g, corners, p0, p1, l, levels, t, AsF32{},
              MapAdd{acc, keys, dl, size - 1, (uint32_t)__clz(size) + 1u, t});
    else
      scatter(g, corners, p0, p1, l, levels, t, AsF32{},
              StagedAdd{acc, dl, size, t});
    __syncthreads();
    if (map) {
      for (uint32_t s = threadIdx.x; s < size; s += HI_THREADS) {
        const uint32_t k = keys[s];
        if (k != HI_EMPTY) red_add2(dl + k, acc[s].x, acc[s].y);
      }
    } else {
      // two entries a reduction (size is even; an added 0 changes nothing)
      const float4* a4 = reinterpret_cast<const float4*>(acc);
      float4* d4 = reinterpret_cast<float4*>(dl);
      for (uint32_t i = threadIdx.x; i < size / 2; i += HI_THREADS) {
        const float4 v = a4[i];
        if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
          atomicAdd(d4 + i, v);
      }
    }
  }
}

// FIX: amax[0] = max |g|, amax[1] = max |w| (w null: left 0) as f32 bits
// (non-negative floats order as their bits do; a NaN's above inf's); amax
// zeroed before.
__global__ void __launch_bounds__(HI_THREADS)
hi_absmax_kernel(const float* __restrict__ g, long long ng,
                 const float* __restrict__ w, long long nw,
                 unsigned* __restrict__ amax) {
  unsigned m[2] = {0u, 0u};
  const long long step = (long long)gridDim.x * HI_THREADS;
  const long long i0 = (long long)blockIdx.x * HI_THREADS + threadIdx.x;
  for (long long i = i0; i < ng; i += step)
    m[0] = max(m[0], __float_as_uint(fabsf(g[i])));
  if (w)
    for (long long i = i0; i < nw; i += step)
      m[1] = max(m[1], __float_as_uint(fabsf(w[i])));
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned v = __reduce_max_sync(0xFFFFFFFFu, m[k]);
    if ((threadIdx.x & 31u) == 0 && v) atomicMax(amax + k, v);
  }
}

// FIX: dtable = acc64 / scale, entry for entry (count entries).
template <bool UNIT_W>
__global__ void __launch_bounds__(HI_THREADS)
hi_fix_out_kernel(const longlong2* __restrict__ acc64, long long count,
                  float2* __restrict__ dtable, long long n,
                  const unsigned* __restrict__ amax) {
  const FixScale f = fix_scale(amax, n, UNIT_W);
  for (long long i = (long long)blockIdx.x * HI_THREADS + threadIdx.x;
       i < count; i += (long long)gridDim.x * HI_THREADS) {
    const longlong2 v = acc64[i];
    dtable[i] = make_float2((float)((double)v.x * f.inv),
                            (float)((double)v.y * f.inv));
  }
}

// ---------------------------------------------------------------------------
// C interface, bound with ctypes
// ---------------------------------------------------------------------------

static int check_args(int n, int levels, long long t) {
  if (n < 0 || levels <= 0 || levels > HI_MAX_LEVELS || t <= 0 ||
      t > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Points mode's level geometry; the table size must be a power of two.
static int make_levels(const int* res, const int* dense, int levels,
                       long long t, NgpLevels* lv) {
  if (t & (t - 1)) return (int)cudaErrorInvalidValue;
  memset(lv, 0, sizeof(*lv));
  for (int l = 0; l < levels; ++l) {
    if (res[l] < 1 || res[l] > (1 << 24)) return (int)cudaErrorInvalidValue;
    lv->res[l] = res[l];
    lv->dense[l] = dense[l] != 0;
  }
  return 0;
}

// Validates the per-level plan, fills the block table and returns the
// shared memory a block needs. HI_STAGED and HI_DIRECT add 16-byte pairs of
// entries: they need an even T and a 16-byte aligned dtable.
static int make_plan(const int* regime, const int* pts, const int* size,
                     int n, int levels, long long t, const void* dtable,
                     bool fix, BwdPlan* plan, int* smem) {
  const int entry = fix ? 16 : 8;   // a float2 or, FIX, a longlong2
  const bool pairs = t % 2 == 0 && (uintptr_t)dtable % 16 == 0;
  memset(plan, 0, sizeof(*plan));
  long long blocks = 0;
  *smem = 0;
  for (int l = 0; l < levels; ++l) {
    const int r = regime[l], p = pts[l], s = size[l];
    if (p < 1 || p > (1 << 20)) return (int)cudaErrorInvalidValue;
    if (r == HI_STAGED) {
      if (!pairs || s < 2 || s % 2 || s > HI_LEVEL_CAP || s > t)
        return (int)cudaErrorInvalidValue;
      *smem = s * entry > *smem ? s * entry : *smem;
    } else if (r == HI_MAP) {
      if (s < HI_MAP_MIN || s > HI_MAP_CAP || (s & (s - 1)))
        return (int)cudaErrorInvalidValue;
      *smem = s * (entry + 4) > *smem ? s * (entry + 4) : *smem;
    } else if (r != HI_DIRECT || !pairs) {
      return (int)cudaErrorInvalidValue;
    }
    plan->regime[l] = r;
    plan->pts[l] = p;
    plan->size[l] = s;
    plan->first[l] = (int)blocks;
    blocks += (n + (long long)p - 1) / p;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  }
  plan->first[levels] = (int)blocks;
  return 0;
}

template <class Corners>
static int launch_fwd(const void* table, const Corners& corners, void* out,
                      int n, int levels, long long t, void* stream) {
  const dim3 block(HI_PTS, HI_LROWS);
  const unsigned blocks = (unsigned)((n + HI_PTS - 1) / HI_PTS);
  const bool pairs = t % 2 == 0 && (uintptr_t)table % 16 == 0;
  hi_fwd_kernel<Corners><<<blocks, block, 0, (cudaStream_t)stream>>>(
      (const float2*)table, corners, (float2*)out, n, levels, (uint32_t)t,
      pairs);
  return (int)cudaGetLastError();
}

// FIX: `fix` holds max|g| and max|w| (16 bytes), then the int64 gradient
// [L, T] longlong2, fix_bytes long; w: idx mode's weights (null in points
// mode).
template <class Corners, bool FIX>
static int launch_bwd(const void* g, const Corners& corners, void* dtable,
                      int n, int levels, long long t, const int* regime,
                      const int* pts, const int* size, const float* w,
                      void* fix, long long fix_bytes, void* stream) {
  BwdPlan plan;
  int smem = 0;
  int err = make_plan(regime, pts, size, n, levels, t, dtable, FIX, &plan,
                      &smem);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long entries = (long long)levels * t;
  unsigned* amax = nullptr;
  longlong2* acc64 = nullptr;
  if (FIX) {
    if (!fix || fix_bytes < 16 + entries * 16)
      return (int)cudaErrorInvalidValue;
    amax = (unsigned*)fix;
    acc64 = (longlong2*)((char*)fix + 16);
    err = (int)cudaMemsetAsync(fix, 0, 16 + entries * 16, s);
    if (err) return err;
    const long long ng = (long long)n * levels * 2;
    const long long want = (ng + HI_THREADS - 1) / HI_THREADS;
    hi_absmax_kernel<<<(unsigned)(want < 8 * 132 ? want : 8 * 132),
                       HI_THREADS, 0, s>>>((const float*)g, ng, w,
                                           (long long)levels * 8 * n, amax);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  err = (int)cudaFuncSetAttribute(hi_bwd_kernel<Corners, FIX>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  hi_bwd_kernel<Corners, FIX><<<(unsigned)plan.first[levels], HI_THREADS,
                                smem, s>>>(
      (const float2*)g, corners, plan, (float2*)dtable, n, levels,
      (uint32_t)t, acc64, amax);
  err = (int)cudaGetLastError();
  if (err || !FIX) return err;
  const long long want = (entries + HI_THREADS - 1) / HI_THREADS;
  hi_fix_out_kernel<Corners::unit_w><<<(unsigned)(want < 32 * 132 ? want
                                                                 : 32 * 132),
                                       HI_THREADS, 0, s>>>(
      acc64, entries, (float2*)dtable, n, amax);
  return (int)cudaGetLastError();
}

// All pointers are device pointers except the per-level int arrays (host
// memory, `levels` each): table and dtable [L, T, 2] f32, idx [L, 8, N]
// int32, w [L, 8, N] f32, x [N, 3] f32, out and g [N, L, 2] f32; dtable
// must be zeroed by the caller (the fixed-order entries write it whole).
// res / dense: each level's resolution and
// dense flag (points mode); regime / pts / size: the backward's plan
// (ops/hash_encode.py::bwd_plan). Each call launches one kernel on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int hi_fwd(const void* table, const void* idx, const void* w,
                      void* out, int n, int levels, long long t,
                      void* stream) {
  const int err = check_args(n, levels, t);
  if (err || n == 0) return err;
  return launch_fwd(table, IdxCorners{(const int*)idx, (const float*)w, n},
                    out, n, levels, t, stream);
}

extern "C" int hi_fwd_pts(const void* table, const void* x, const int* res,
                          const int* dense, void* out, int n, int levels,
                          long long t, void* stream) {
  PointCorners pc{(const float*)x, {}, (uint32_t)(t - 1)};
  int err = check_args(n, levels, t);
  if (!err) err = make_levels(res, dense, levels, t, &pc.lv);
  if (err || n == 0) return err;
  return launch_fwd(table, pc, out, n, levels, t, stream);
}

extern "C" int hi_bwd(const void* g, const void* idx, const void* w,
                      void* dtable, int n, int levels, long long t,
                      const int* regime, const int* pts, const int* size,
                      void* stream) {
  const int err = check_args(n, levels, t);
  if (err || n == 0) return err;
  return launch_bwd<IdxCorners, false>(
      g, IdxCorners{(const int*)idx, (const float*)w, n}, dtable, n, levels,
      t, regime, pts, size, nullptr, nullptr, 0, stream);
}

// The fixed-order variants (see the note at the top): the same arguments
// and the scratch `fix` (16 + L x T x 16 bytes).
extern "C" int hi_bwd_fix(const void* g, const void* idx, const void* w,
                          void* dtable, int n, int levels, long long t,
                          const int* regime, const int* pts, const int* size,
                          void* fix, long long fix_bytes, void* stream) {
  const int err = check_args(n, levels, t);
  if (err) return err;
  if (n == 0)
    return (int)cudaMemsetAsync(dtable, 0, (size_t)levels * t * 8,
                                (cudaStream_t)stream);
  return launch_bwd<IdxCorners, true>(
      g, IdxCorners{(const int*)idx, (const float*)w, n}, dtable, n, levels,
      t, regime, pts, size, (const float*)w, fix, fix_bytes, stream);
}

extern "C" int hi_bwd_pts(const void* g, const void* x, const int* res,
                          const int* dense, void* dtable, int n, int levels,
                          long long t, const int* regime, const int* pts,
                          const int* size, void* stream) {
  PointCorners pc{(const float*)x, {}, (uint32_t)(t - 1)};
  int err = check_args(n, levels, t);
  if (!err) err = make_levels(res, dense, levels, t, &pc.lv);
  if (err || n == 0) return err;
  return launch_bwd<PointCorners, false>(g, pc, dtable, n, levels, t, regime,
                                        pts, size, nullptr, nullptr, 0,
                                        stream);
}

extern "C" int hi_bwd_pts_fix(const void* g, const void* x, const int* res,
                              const int* dense, void* dtable, int n,
                              int levels, long long t, const int* regime,
                              const int* pts, const int* size, void* fix,
                              long long fix_bytes, void* stream) {
  PointCorners pc{(const float*)x, {}, (uint32_t)(t - 1)};
  int err = check_args(n, levels, t);
  if (!err) err = make_levels(res, dense, levels, t, &pc.lv);
  if (err) return err;
  if (n == 0)
    return (int)cudaMemsetAsync(dtable, 0, (size_t)levels * t * 8,
                                (cudaStream_t)stream);
  return launch_bwd<PointCorners, true>(g, pc, dtable, n, levels, t, regime,
                                        pts, size, nullptr, fix, fix_bytes,
                                        stream);
}

extern "C" const char* hi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
