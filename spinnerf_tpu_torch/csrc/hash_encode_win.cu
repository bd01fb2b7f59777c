// Multiresolution hash-grid encode for Hopper (sm_90a): forward gather and
// backward scatter-add, with the corner geometry rebuilt in the kernel.
//
// Replaces the Pallas kernels of spinnerf_tpu/ops/hash_encode_win.py:
//   forward  _win_fwd_fused_kernel (:580; _corner_geom :526, _paired_gather
//            :258; the page base _point_bc :718-721)
//   backward _win_bwd_fused_kernel (:593; _bwd_accumulate :324)
// It computes what hash_encode_exact(table, *corner_indices_weights_win(...))
// computes: a direct gather at any point count, without the TPU kernel's
// two-page window, its clamp aliasing or its Z-sort.
//
// What bounds it on an H100. Forward: every (point, level) reads 8
// scattered 8-byte entries of a 64 MiB f32 table (2^19 entries x 16
// levels), larger than the 50 MB L2. In the order the points come (samples
// along rays), 32 consecutive points of a fine level touch some 120
// distinct 32-byte sectors with their 256 corner loads, so a direct gather
// is bound by scattered sector requests, not by its bytes or its ~150
// integer and float operations. But on a paged level all 8 corners of a
// point lie in its own segment's page [base, base + 1024) (8 KB), and on a
// dense level in the box's morton span (<= 32,768 entries). So the
// forward (he_win_fwd)
//   1. finds each point's page in the kernel (hf_key_kernel): the block
//      stages every stride-th of the sorted page bounds (T / 1024 keys <
//      2^27, as int32; at most HF_STAGED of them, 16 KB: all of them up to
//      T = 2^22) in shared memory, and a thread a point computes zkey27
//      (floor(x * 512) clamped to [0, 511], morton-interleaved) and
//      #(bounds <= key) - 1 by halving steps, first over the staged bounds,
//      then over the stride bounds after the one found, read from device
//      memory (3 steps at T = 2^25), as ops/hash_encode_win.py::point_base
//      computes them (searchsorted with right=True counts repeated bounds);
//      it writes the base [N] int32 and counts the points of each segment.
//      T reaches 2^25 (32,768 segments), the range JAX's windowed kernel
//      states (_pack_pages: page ids fit 15 bits);
//   2. sorts the point ids by segment (a counting sort: hb_plan_kernel,
//      hb_scatter_kernel) and cuts each segment into chunks of at most
//      HB_CHUNK points (an empty segment is one empty chunk);
//   3. hf_fwd_kernel: a block takes HF_PTS sorted points of one chunk and
//      every level. A paged level's page is copied whole into shared memory
//      (cp.async, double-buffered: the next paged level's page loads while
//      this one is read) and the corners are read from it. A dense level is
//      gathered directly, corners ci and ci+4 with one 16-byte load where
//      they are entries e and e^1: they differ only in cx, and where cx is
//      even the shifted morton code, which interleaves x lowest, puts them
//      on one 16-byte pair (the paged hash does too: its prime on x is 1).
//      The rows of the block's points are staged in shared memory (an odd
//      pitch, so a warp's column of stores hits 32 banks), and each point's
//      row of out [N, L, 2] is written once, whole.
// The order and the chunk table are the backward's too: autograd keeps the
// scratch they live in, and the backward starts from them. The blend adds
// corners 0..7 in order, f32, no FMA, as the plain version's index and a
// sequential blend would. A block of 128 consecutive points that gathered
// every level directly (no sort) and a block a (chunk, paged level) were
// measured slower (PERF.md section 6).
//
// Backward: the least it can do is read each cotangent once and write each
// gradient entry once; one global atomic per (point, level, corner) would
// instead scatter 8 reductions a (point, level) over the 64 MiB gradient.
// The index makes the writes local, as above. So the backward, from the
// forward's sort,
//   1. paged levels (hb_page_kernel): one block per (chunk, level) sums its
//      points into the page held whole in shared memory (8 KB), then
//      writes the page with plain coalesced stores, zeros included; the
//      chunks of a segment longer than HB_CHUNK add their nonzero entries
//      to a page zeroed before (hb_zero_split_kernel);
//   2. dense levels of span <= HB_DENSE_SPAN (hb_dense_kernel): blocks sum
//      slices of the sorted points over the whole span in shared memory and
//      write per-block partial sums; span HB_WIDE_SPAN (hb_wide_kernel,
//      256 KB): a cluster of HB_CLUSTER blocks holds the span in its
//      distributed shared memory, each corner added in the block that owns
//      its quarter; hb_reduce_kernel sums the partials and writes each dense
//      row once, zeros beyond the span included.
// Within a warp, lanes whose corners share an entry are summed first
// (warp_add: __match_any_sync, then a prefix sum over each group by pointer
// jumping), so a hot coarse entry takes one shared-memory atomic a warp.
// The grids are sized from upper bounds (at most ceil(N / HB_CHUNK) +
// n_segments chunks); surplus blocks exit at once, and no count is read
// back to the host. What bounds it now is not bytes (one pass over g and
// one write of the table take ~0.03 ms at 262,144 points) but the eight
// shared-memory updates a (point, level) and the dependent loads of short
// blocks (PERF.md section 6).
//
// The fixed-order variant (he_win_bwd_fix, taken under
// torch.use_deterministic_algorithms): the sums above are f32 adds whose
// order follows the sort's order within a segment (hb_scatter_kernel's
// atomics place a warp's points), the compare-and-swap races in shared
// memory and the cluster's atomics, so two launches on the same inputs
// differ in the last bits. The variant rounds each contribution w * g once
// to an integer multiple of 1 / scale and adds the integers as int64, in
// the same kernels: integer sums are exact, so no order of points, adds or
// blocks moves a bit. scale = 2^(61 - e) with 2^e > 16 N max|g| (a launch's
// first kernel finds max|g|), above any sum an entry can reach (8 corners a
// point, |w| <= 1 for points in [0, 1], with twice that for headroom), so
// no sum overflows; a contribution moves by at most 32 N max|g| 2^-62
// (2^-37 max|g| at N = 2^20), far below the f32 sums' own rounding. The
// shared sums take 16 bytes an entry (a page 16 KB, a dense span of 4096
// 64 KB, a cluster's quarter 128 KB); the split segments' chunks add their
// pages to int64 pages in scratch, converted once (hb_split_out_kernel); a
// non-finite cotangent makes every entry NaN.
//
// Bit-exactness: the corner indices must equal the host index function's bit
// for bit, so the geometry rounds as the f32 host path does: explicit
// __fmul_rn / __fsub_rn, and the library is built with -fmad=false (an FMA
// contraction of x*r - floor(x*r) changes frac). Never build with
// --use_fast_math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

#define HE_MAX_LEVELS 32
#define HE_ROW 8            // (res, dense flag, ox, oy, oz, ex, ey, ez)
#define HE_PAGE_ENTRIES 1024  // PAGE_ENTRIES: a segment's page
#define HE_PAGE_MASK 1023u  // PAGE_ENTRIES - 1: the in-segment hash range

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

__device__ __forceinline__ void red_add2(float2* addr, float a, float b) {
  atomicAdd(addr, make_float2(a, b));  // one vector reduction on sm_90
}

// The encode's schedule. Compile-time constants, mirrored in
// ops/hash_encode_win.py, which sizes the scratch.
#define HB_THREADS 256
#define HB_CHUNK 1024          // points of one segment a chunk holds
#define HB_DENSE_SPAN 4096     // largest span one block sums (32 KB)
#define HB_WIDE_SPAN 32768     // DENSE_BOX_CAP: summed across a cluster
#define HB_CLUSTER 4           // blocks of a cluster, each a quarter (64 KB)
#define HB_PART (HB_WIDE_SPAN / HB_CLUSTER)
#define HB_PART_BITS 13        // log2(HB_PART)
#define HB_PLAN_THREADS 1024
#define HB_REDUCE_TILE HB_THREADS   // dense-row entries a reduce block writes

struct LevelSet {
  int n;
  int level[HE_MAX_LEVELS];
  int span[HE_MAX_LEVELS];    // morton span (dense), 0 (paged)
  int parts[HE_MAX_LEVELS];   // partial sums of the level (dense)
  long long offset[HE_MAX_LEVELS];  // float2 offset of its partials
};

// The level's row of LevelRows, through shared memory into registers.
__device__ __forceinline__ void level_row(const LevelRows& rows, int l,
                                          int* srow, int row[HE_ROW]) {
  if (threadIdx.x < HE_ROW) srow[threadIdx.x] = rows.v[l * HE_ROW + threadIdx.x];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < HE_ROW; ++i) row[i] = srow[i];
}

// Adds (vx, vy) at entry `key` for every lane of `active` (the lanes that
// call; a prefix of the warp). Lanes whose keys are equal are summed first
// and the highest lane of each group calls add(key, sum): the inclusive
// prefix sum over the group, in lane order, by pointer jumping (each lane
// adds the sum held by its nearest lower group member, then takes that
// member's pointer), ceil(log2(group size)) shuffle rounds. A warp with no
// two adjacent lanes on one entry (the fine levels) skips the match.
__device__ __forceinline__ float vsum(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ long long vsum(long long a, long long b) {
  return a + b;
}

template <class T, class Add>
__device__ __forceinline__ void warp_add(unsigned active, uint32_t key, T vx,
                                         T vy, const Add& add) {
  const unsigned lane = threadIdx.x & 31u;
  const uint32_t below = __shfl_up_sync(active, key, 1);
  if (!__any_sync(active, lane > 0 && below == key)) {
    add(key, vx, vy);
    return;
  }
  const unsigned peers = __match_any_sync(active, key);
  const unsigned lower = peers & ((1u << lane) - 1u);
  int prev = lower ? 31 - __clz(lower) : -1;
  const unsigned most = __reduce_max_sync(active, (unsigned)__popc(peers));
  for (unsigned reach = 1; reach < most; reach <<= 1) {
    const int src = prev >= 0 ? prev : (int)lane;
    const T ox = __shfl_sync(active, vx, src);
    const T oy = __shfl_sync(active, vy, src);
    const int pp = __shfl_sync(active, prev, src);
    if (prev >= 0) {
      vx = vsum(vx, ox);
      vy = vsum(vy, oy);
      prev = pp;
    }
  }
  if ((peers >> lane) == 1u) add(key, vx, vy);
}

// Adds (a, b) to a float2 in the block's own shared memory with one 64-bit
// compare-and-swap loop: both features in one update. (Two f32 reductions,
// red.shared.add.f32, measured slower on the H100.)
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

struct SmemAdd {
  float2* acc;
  __device__ __forceinline__ void operator()(uint32_t k, float a,
                                             float b) const {
    smem_add2(acc + k, a, b);
  }
};

// The span lives in the shared memory of the cluster's blocks, a quarter
// each: entry k in block k >> HB_PART_BITS.
struct ClusterAdd {
  float2* acc;
  __device__ __forceinline__ void operator()(uint32_t k, float a,
                                             float b) const {
    float2* dst = cg::this_cluster().map_shared_rank(acc, k >> HB_PART_BITS) +
                  (k & (HB_PART - 1));
    atomicAdd(&dst->x, a);
    atomicAdd(&dst->y, b);
  }
};

// The fixed-order variant's sums: int64 pairs, added with 64-bit integer
// atomics (exact, so their order does not matter).
__device__ __forceinline__ void fix_add2(longlong2* p, long long a,
                                         long long b) {
  if (a) atomicAdd(reinterpret_cast<unsigned long long*>(&p->x),
                   (unsigned long long)a);
  if (b) atomicAdd(reinterpret_cast<unsigned long long*>(&p->y),
                   (unsigned long long)b);
}

struct SmemFixAdd {
  longlong2* acc;
  __device__ __forceinline__ void operator()(uint32_t k, long long a,
                                             long long b) const {
    fix_add2(acc + k, a, b);
  }
};

struct ClusterFixAdd {
  longlong2* acc;
  __device__ __forceinline__ void operator()(uint32_t k, long long a,
                                             long long b) const {
    fix_add2(cg::this_cluster().map_shared_rank(acc, k >> HB_PART_BITS) +
                 (k & (HB_PART - 1)),
             a, b);
  }
};

// A contribution as the sums take it: f32 (AsF32), or rounded once to a
// multiple of 1 / scale (AsFix).
struct AsF32 {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

struct FixScale {
  double scale, inv;
};

struct AsFix {
  double scale;
  __device__ __forceinline__ long long operator()(float v) const {
    return __double2ll_rn((double)v * scale);
  }
};

// The launch's scale from amax (max |g| as f32 bits) and the point count:
// 2^(61 - e) with 16 n max|g| < 2^e. A non-finite max|g| gives inv = NaN:
// every entry comes out NaN.
__device__ __forceinline__ FixScale fix_scale(const unsigned* amax,
                                              long long n) {
  const double b = 16.0 * (double)n * (double)__uint_as_float(*amax);
  if (!(b <= 1.0e308)) return {0.0, __longlong_as_double(0x7FF8000000000000LL)};
  int e = 0;
  if (b > 0.0) frexp(b, &e);
  e = max(e, -960);   // keeps the scale finite for denormal cotangents
  return {ldexp(1.0, 61 - e), ldexp(1.0, e - 61)};
}

__device__ __forceinline__ float2 from_fix(longlong2 v, const FixScale& f) {
  return make_float2((float)((double)v.x * f.inv), (float)((double)v.y * f.inv));
}

// Sums the points order[i_begin, i_end) of level l (geometry `row`) into
// add: one point a thread, HB_THREADS at a time, warps kept converged for
// warp_add. `seg_base` is the points' common page base on a paged level
// (keys are then offsets in the page), 0 on a dense level. `val` turns each
// f32 contribution into what `add` sums.
template <class Val, class Add>
__device__ __forceinline__ void scatter_points(
    const float2* __restrict__ g, const float* __restrict__ x,
    const int* __restrict__ order, int i_begin, int i_end, int l, int levels,
    const int row[HE_ROW], uint32_t seg_base, const Val& val,
    const Add& add) {
  for (int i0 = i_begin; i0 < i_end; i0 += HB_THREADS) {
    const int i = i0 + (int)threadIdx.x;
    const bool on = i < i_end;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
    if (!on) continue;
    const int64_t p = order[i];
    const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
    uint32_t idx[8];
    float w[8];
    corner_geom(xp, seg_base, row, idx, w);
    const float2 gv = g[p * levels + l];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      warp_add(active, idx[c] - seg_base, val(__fmul_rn(w[c], gv.x)),
               val(__fmul_rn(w[c], gv.y)), add);
  }
}

// The forward's block of sorted points, and the page bounds.
#define HF_PTS 256
#define HF_MAX_SEGS 32768    // T <= 2^25: JAX's range (_pack_pages)
#define HF_STAGED 4096       // page bounds hf_key_kernel stages (16 KB)

// The point's key on the fixed 512^3 partition grid (zkey27 in
// ops/hash_encode_win.py): x * 512 is exact in f32, the cast truncates
// toward zero, then the clamp to [0, 511].
__device__ __forceinline__ int zkey27(const float xp[3]) {
  uint32_t c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    c[a] = (uint32_t)min(max((int)__fmul_rn(xp[a], 512.0f), 0), 511);
  return (int)(spread9(c[0]) | (spread9(c[1]) << 1) | (spread9(c[2]) << 2));
}

// #(bounds[i] <= z) - 1 over the sorted bounds [0, n_seg): the last i with
// bounds[i] <= z (repeated bounds count as torch.searchsorted(right=True)
// counts them); -1 if there is none. sb holds bounds[0], bounds[stride],
// ... (n_st of them; n_st and stride powers of two): halving steps find the
// last staged bound <= z, and every bound from the next staged one on is
// > z, so log2(stride) more steps over the bounds in device memory find
// the answer among the stride bounds from there.
__device__ __forceinline__ int page_of(const int* sb, int n_st,
                                       const long long* __restrict__ bounds,
                                       int stride, int z) {
  if (sb[0] > z) return -1;
  int pos = 0;
  for (int step = n_st >> 1; step > 0; step >>= 1)
    if (sb[pos + step] <= z) pos += step;
  pos *= stride;
  for (int step = stride >> 1; step > 0; step >>= 1)
    if (__ldg(bounds + pos + step) <= (long long)z) pos += step;
  return pos;
}

// The 8 gathers of one (point, level), corner ci and ci+4 from one 16-byte
// load where they are entries e and e^1 (the row is 16-byte aligned: T is
// even), then the blend in corner order 0..7, f32, no FMA.
__device__ __forceinline__ float2 gather_blend(const float2* __restrict__ tl,
                                               const uint32_t idx[8],
                                               const float w[8]) {
  float2 f[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t e0 = idx[c], e1 = idx[c + 4];
    const float4 v = __ldg(reinterpret_cast<const float4*>(tl + (e0 & ~1u)));
    const float2 lo = make_float2(v.x, v.y), hi = make_float2(v.z, v.w);
    const bool odd = (e0 & 1u) != 0;
    f[c] = odd ? hi : lo;
    f[c + 4] = (e0 ^ e1) == 1u ? (odd ? lo : hi) : __ldg(tl + e1);
  }
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f[c].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f[c].y));
  }
  return acc;
}

// 1. base_out[i] = the point's page base, and counts[seg] = points of each
// segment; every stride-th bound staged in shared memory (page_of), one
// global atomic per segment a warp.
__global__ void __launch_bounds__(HB_THREADS)
hf_key_kernel(const float* __restrict__ x, const long long* __restrict__ bounds,
              int n_seg, int n, int* __restrict__ base_out,
              int* __restrict__ counts) {
  __shared__ int sb[HF_STAGED];
  const int stride = n_seg > HF_STAGED ? n_seg / HF_STAGED : 1;
  const int n_st = n_seg / stride;
  for (int i = threadIdx.x; i < n_st; i += HB_THREADS)
    sb[i] = (int)bounds[(int64_t)i * stride];
  __syncthreads();
  const int i = blockIdx.x * HB_THREADS + threadIdx.x;
  const bool on = i < n;
  const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
  if (!on) return;
  const float xp[3] = {x[3 * (int64_t)i], x[3 * (int64_t)i + 1],
                       x[3 * (int64_t)i + 2]};
  const int seg = page_of(sb, n_st, bounds, stride, zkey27(xp));
  base_out[i] = seg * HE_PAGE_ENTRIES;
  const unsigned peers = __match_any_sync(active, seg);
  if ((threadIdx.x & 31u) == (unsigned)(__ffs(peers) - 1))
    atomicAdd(counts + seg, __popc(peers));
}

// Exclusive prefix sum over the block (HB_PLAN_THREADS threads); `tot`
// holds 33 ints of shared memory, *total gets the block's sum.
__device__ int block_excl_scan(int v, int* tot, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) tot[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    const int wv = tot[lane];
    int wi = wv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xFFFFFFFFu, wi, d);
      if (lane >= d) wi += o;
    }
    tot[lane] = wi - wv;
    if (lane == 31) tot[32] = wi;
  }
  __syncthreads();
  const int excl = inc - v + tot[wid];
  *total = tot[32];
  __syncthreads();
  return excl;
}

// 2. One block: segment starts (cursor), the chunk table (segment, first
// sorted position, points, and 1 for the sole chunk of its segment or
// -(1 + k) for a chunk of split segment k), the segments split into
// several chunks, and meta = (chunks, split segments).
__global__ void __launch_bounds__(HB_PLAN_THREADS)
hb_plan_kernel(const int* __restrict__ counts, int n_seg,
               int* __restrict__ cursor, int4* __restrict__ chunks,
               int* __restrict__ split, int* __restrict__ meta) {
  __shared__ int tot[33];
  int carry_p = 0, carry_c = 0, carry_s = 0;
  for (int s0 = 0; s0 < n_seg; s0 += HB_PLAN_THREADS) {
    const int s = s0 + (int)threadIdx.x;
    const int cnt = s < n_seg ? counts[s] : 0;
    const int nch = s < n_seg ? max(1, (cnt + HB_CHUNK - 1) / HB_CHUNK) : 0;
    const int sp = cnt > HB_CHUNK ? 1 : 0;
    int tp, tc, ts;
    const int p0 = carry_p + block_excl_scan(cnt, tot, &tp);
    const int c0 = carry_c + block_excl_scan(nch, tot, &tc);
    const int k0 = carry_s + block_excl_scan(sp, tot, &ts);
    if (s < n_seg) {
      cursor[s] = p0;
      for (int j = 0; j < nch; ++j)
        chunks[c0 + j] = make_int4(s, p0 + j * HB_CHUNK,
                                   min(HB_CHUNK, cnt - j * HB_CHUNK),
                                   nch == 1 ? 1 : -(1 + k0));
      if (sp) split[k0] = s;
    }
    carry_p += tp;
    carry_c += tc;
    carry_s += ts;
  }
  if (threadIdx.x == 0) {
    meta[0] = carry_c;
    meta[1] = carry_s;
  }
}

// 3. order[cursor[seg]++] = i; a warp's points of one segment keep their
// lane order and take one global atomic.
__global__ void __launch_bounds__(HB_THREADS)
hb_scatter_kernel(const int* __restrict__ base, int n, int* __restrict__ cursor,
                  int* __restrict__ order) {
  const int i = blockIdx.x * HB_THREADS + threadIdx.x;
  const bool on = i < n;
  const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
  if (!on) return;
  const int seg = base[i] / HE_PAGE_ENTRIES;
  const unsigned peers = __match_any_sync(active, seg);
  const unsigned lane = threadIdx.x & 31u;
  const int leader = __ffs(peers) - 1;
  int pos = 0;
  if (lane == (unsigned)leader) pos = atomicAdd(cursor + seg, __popc(peers));
  pos = __shfl_sync(peers, pos, leader);
  order[pos + __popc(peers & ((1u << lane) - 1u))] = i;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes device -> shared, asynchronously; groups of them committed and
// waited for
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first paged level at or after l (levels if none).
__device__ __forceinline__ int next_paged(const int* srows, int l, int levels) {
  while (l < levels && srows[l * HE_ROW + 1]) ++l;
  return l;
}

// 4. The forward: block = part (HF_PTS sorted points) of a chunk x every
// level; surplus blocks (past the chunks, or past a chunk's points) exit at
// once. Dynamic shared memory: two pages [2][1024] float2, then the rows
// [HF_PTS][2L + 1] f32.
__global__ void __launch_bounds__(HF_PTS)
hf_fwd_kernel(const float2* __restrict__ table, const float* __restrict__ x,
              LevelRows rows, const int* __restrict__ order,
              const int4* __restrict__ chunks, const int* __restrict__ meta,
              float* __restrict__ out, int levels, int64_t t) {
  extern __shared__ __align__(16) float hf_smem[];
  float2* pages = reinterpret_cast<float2*>(hf_smem);
  float* tile = hf_smem + 4 * HE_PAGE_ENTRIES;
  __shared__ int srows[HE_MAX_LEVELS * HE_ROW];
  __shared__ int sp[HF_PTS];
  constexpr int parts = HB_CHUNK / HF_PTS;
  const int k = blockIdx.x / parts;
  if (k >= meta[0]) return;
  const int4 ch = chunks[k];
  const int i0 = (blockIdx.x - k * parts) * HF_PTS;
  if (i0 >= ch.z) return;
  const int npts = min(HF_PTS, ch.z - i0);
  const int tid = threadIdx.x, pitch = 2 * levels + 1;
  const uint32_t seg_base = (uint32_t)ch.x * HE_PAGE_ENTRIES;
  for (int i = tid; i < levels * HE_ROW; i += HF_PTS) srows[i] = rows.v[i];
  const int p = tid < npts ? order[ch.y + i0 + tid] : -1;
  sp[tid] = p;
  float xp[3] = {0.0f, 0.0f, 0.0f};
  if (p >= 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) xp[a] = x[3 * (int64_t)p + a];
  }
  __syncthreads();
  // the block's page of paged level l into buffer b
  auto stage = [&](int l, int b) {
    const float2* src = table + (int64_t)l * t + seg_base;
    const uint32_t dst = smem_u32(pages + b * HE_PAGE_ENTRIES);
    for (int i = tid; i < HE_PAGE_ENTRIES / 2; i += HF_PTS)
      cp16(dst + 16 * i, src + 2 * i);
    cp_commit();
  };
  int nxt = next_paged(srows, 0, levels), buf = 0;
  if (nxt < levels) stage(nxt, 0);
  for (int l = 0; l < levels; ++l) {
    const int* row = srows + l * HE_ROW;
    uint32_t idx[8];
    float w[8];
    float2 acc = make_float2(0.0f, 0.0f);
    if (row[1]) {   // dense: straight from the table
      if (p >= 0) {
        corner_geom(xp, 0u, row, idx, w);
        acc = gather_blend(table + (int64_t)l * t, idx, w);
      }
    } else {        // paged: from the page, the next one loading meanwhile
      nxt = next_paged(srows, l + 1, levels);
      if (nxt < levels) {
        stage(nxt, buf ^ 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      if (p >= 0) {
        corner_geom(xp, seg_base, row, idx, w);
        const float2* pg = pages + buf * HE_PAGE_ENTRIES;
        float2 f[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) f[c] = pg[idx[c] - seg_base];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f[c].x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f[c].y));
        }
      }
      __syncthreads();   // every read of this page before it is reloaded
      buf ^= 1;
    }
    tile[tid * pitch + 2 * l] = acc.x;
    tile[tid * pitch + 2 * l + 1] = acc.y;
  }
  __syncthreads();
  const int row2 = 2 * levels;
  for (int i = tid; i < npts * row2; i += HF_PTS) {
    const int q = i / row2;
    const int j = i - q * row2;
    out[(int64_t)sp[q] * row2 + j] = tile[q * pitch + j];
  }
}

// The backward's sums: f32 pairs (the default) or, in the fixed-order
// variant, int64 pairs (FIX).
template <bool FIX>
struct Sums {
  typedef float2 T;
};
template <>
struct Sums<true> {
  typedef longlong2 T;
};

// bytes of shared or device memory zeroed with 16-byte stores by the block
__device__ __forceinline__ void zero_bytes(void* p, int bytes) {
  float4* a4 = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    a4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// bytes copied with 16-byte loads and stores by the block
__device__ __forceinline__ void copy_bytes(void* dst, const void* src,
                                           int bytes) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d4[i] = s4[i];
}

// Backward 0 (FIX). amax[0] = max |v| over v[0, count) as f32 bits
// (non-negative floats order as their bits do; a NaN's bits order above
// inf's); amax zeroed before.
__global__ void __launch_bounds__(HB_THREADS)
hb_absmax_kernel(const float* __restrict__ v, long long count,
                 unsigned* __restrict__ amax) {
  unsigned m = 0;
  for (long long i = (long long)blockIdx.x * HB_THREADS + threadIdx.x;
       i < count; i += (long long)gridDim.x * HB_THREADS)
    m = max(m, __float_as_uint(fabsf(v[i])));
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31u) == 0 && m) atomicMax(amax, m);
}

// Backward 1. Zero the pages of the split segments on every paged level
// (FIX: their int64 pages in scratch, split segment k's at (k * paged.n +
// li) pages); block = split segment x paged level.
template <bool FIX>
__global__ void __launch_bounds__(HB_THREADS)
hb_zero_split_kernel(LevelSet paged, const int* __restrict__ split,
                     const int* __restrict__ meta, float2* __restrict__ dtable,
                     int64_t t, longlong2* __restrict__ split_acc) {
  const int li = blockIdx.x % paged.n;
  const int k = blockIdx.x / paged.n;
  if (k >= meta[1]) return;
  if constexpr (FIX)
    zero_bytes(split_acc + ((int64_t)k * paged.n + li) * HE_PAGE_ENTRIES,
               HE_PAGE_ENTRIES * 16);
  else
    zero_bytes(dtable + (int64_t)paged.level[li] * t +
                   (int64_t)split[k] * HE_PAGE_ENTRIES,
               HE_PAGE_ENTRIES * 8);
}

// Backward 2. Paged levels: block = chunk x paged level (the levels of one chunk are
// neighbours in launch order, so a point's cotangent row is read from
// device memory once and from L2 after). One block a (chunk, level) keeps
// ~46 short blocks an SM in flight; one block a chunk looping over the
// levels measured slower (fewer blocks, each a chain of dependent levels).
template <bool FIX>
__global__ void __launch_bounds__(HB_THREADS)
hb_page_kernel(const float2* __restrict__ g, const float* __restrict__ x,
               LevelRows rows, LevelSet paged, const int* __restrict__ order,
               const int4* __restrict__ chunks, const int* __restrict__ meta,
               float2* __restrict__ dtable, int levels, int64_t t,
               const unsigned* __restrict__ amax,
               longlong2* __restrict__ split_acc, int n) {
  typedef typename Sums<FIX>::T S;
  __shared__ __align__(16) S acc[HE_PAGE_ENTRIES];
  __shared__ int srow[HE_ROW];
  const int li = blockIdx.x % paged.n;
  const int k = blockIdx.x / paged.n;
  if (k >= meta[0]) return;
  const int4 ch = chunks[k];
  const int l = paged.level[li];
  zero_bytes(acc, sizeof(acc));
  int row[HE_ROW];
  level_row(rows, l, srow, row);  // its barrier also orders the zeroing
  const uint32_t seg_base = (uint32_t)ch.x * HE_PAGE_ENTRIES;
  float2* dst = dtable + (int64_t)l * t + seg_base;
  if constexpr (FIX) {
    const FixScale f = fix_scale(amax, n);
    scatter_points(g, x, order, ch.y, ch.y + ch.z, l, levels, row, seg_base,
                   AsFix{f.scale}, SmemFixAdd{acc});
    __syncthreads();
    if (ch.w > 0) {
      for (int i = threadIdx.x; i < HE_PAGE_ENTRIES; i += HB_THREADS)
        dst[i] = from_fix(acc[i], f);
    } else {
      longlong2* sa = split_acc +
                      ((int64_t)(-ch.w - 1) * paged.n + li) * HE_PAGE_ENTRIES;
      for (int i = threadIdx.x; i < HE_PAGE_ENTRIES; i += HB_THREADS)
        fix_add2(sa + i, acc[i].x, acc[i].y);
    }
  } else {
    scatter_points(g, x, order, ch.y, ch.y + ch.z, l, levels, row, seg_base,
                   AsF32{}, SmemAdd{acc});
    __syncthreads();
    if (ch.w > 0) {
      copy_bytes(dst, acc, sizeof(acc));
    } else {
      for (int i = threadIdx.x; i < HE_PAGE_ENTRIES; i += HB_THREADS) {
        const float2 v = acc[i];
        if (v.x != 0.0f || v.y != 0.0f) red_add2(dst + i, v.x, v.y);
      }
    }
  }
}

// Backward 2b (FIX). The split segments' int64 pages into the table;
// block = split segment x paged level.
__global__ void __launch_bounds__(HB_THREADS)
hb_split_out_kernel(LevelSet paged, const int* __restrict__ split,
                    const int* __restrict__ meta,
                    const longlong2* __restrict__ split_acc,
                    float2* __restrict__ dtable, int64_t t,
                    const unsigned* __restrict__ amax, int n) {
  const int li = blockIdx.x % paged.n;
  const int k = blockIdx.x / paged.n;
  if (k >= meta[1]) return;
  const FixScale f = fix_scale(amax, n);
  const longlong2* src =
      split_acc + ((int64_t)k * paged.n + li) * HE_PAGE_ENTRIES;
  float2* dst = dtable + (int64_t)paged.level[li] * t +
                (int64_t)split[k] * HE_PAGE_ENTRIES;
  for (int i = threadIdx.x; i < HE_PAGE_ENTRIES; i += HB_THREADS)
    dst[i] = from_fix(src[i], f);
}

// Backward 3. Dense levels of span <= HB_DENSE_SPAN: block = slice b of the sorted
// points x level (the levels of a slice neighbours in launch order); the
// block's sums over the whole span go to its row of the level's partials.
template <bool FIX>
__global__ void __launch_bounds__(HB_THREADS)
hb_dense_kernel(const float2* __restrict__ g, const float* __restrict__ x,
                LevelRows rows, LevelSet dense, const int* __restrict__ order,
                typename Sums<FIX>::T* __restrict__ partials, int n,
                int levels, const unsigned* __restrict__ amax) {
  typedef typename Sums<FIX>::T S;
  extern __shared__ __align__(16) unsigned char dsmem[];
  S* dacc = reinterpret_cast<S*>(dsmem);
  __shared__ int srow[HE_ROW];
  const int di = blockIdx.x % dense.n;
  const int b = blockIdx.x / dense.n;
  const int l = dense.level[di], span = dense.span[di];
  const int parts = dense.parts[di];
  zero_bytes(dacc, span * (int)sizeof(S));
  int row[HE_ROW];
  level_row(rows, l, srow, row);
  const int i0 = (int)((int64_t)n * b / parts);
  const int i1 = (int)((int64_t)n * (b + 1) / parts);
  if constexpr (FIX)
    scatter_points(g, x, order, i0, i1, l, levels, row, 0u,
                   AsFix{fix_scale(amax, n).scale}, SmemFixAdd{dacc});
  else
    scatter_points(g, x, order, i0, i1, l, levels, row, 0u, AsF32{},
                   SmemAdd{dacc});
  __syncthreads();
  copy_bytes(partials + dense.offset[di] + (int64_t)b * span, dacc,
             span * (int)sizeof(S));
}

// Backward 4. Dense levels of span HB_WIDE_SPAN: cluster c of the level sums slice c
// of the sorted points (its blocks a quarter of it each) into the span,
// which its HB_CLUSTER blocks hold a quarter each; each block then writes
// its quarter to the cluster's row of the partials.
template <bool FIX>
__global__ void __cluster_dims__(HB_CLUSTER, 1, 1) __launch_bounds__(HB_THREADS)
hb_wide_kernel(const float2* __restrict__ g, const float* __restrict__ x,
               LevelRows rows, LevelSet wide, const int* __restrict__ order,
               typename Sums<FIX>::T* __restrict__ partials, int n,
               int levels, const unsigned* __restrict__ amax) {
  typedef typename Sums<FIX>::T S;
  extern __shared__ __align__(16) unsigned char wsmem[];
  S* wacc = reinterpret_cast<S*>(wsmem);
  __shared__ int srow[HE_ROW];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / HB_CLUSTER;
  const int di = cid % wide.n;
  const int c = cid / wide.n;
  const int l = wide.level[di];
  const int slices = wide.parts[di] * HB_CLUSTER;
  const int s = c * HB_CLUSTER + rank;
  zero_bytes(wacc, HB_PART * (int)sizeof(S));
  int row[HE_ROW];
  level_row(rows, l, srow, row);
  cluster.sync();  // every quarter zeroed before any block adds to it
  const int i0 = (int)((int64_t)n * s / slices);
  const int i1 = (int)((int64_t)n * (s + 1) / slices);
  if constexpr (FIX)
    scatter_points(g, x, order, i0, i1, l, levels, row, 0u,
                   AsFix{fix_scale(amax, n).scale}, ClusterFixAdd{wacc});
  else
    scatter_points(g, x, order, i0, i1, l, levels, row, 0u, AsF32{},
                   ClusterAdd{wacc});
  cluster.sync();  // every add landed; no block exits while others add
  copy_bytes(partials + wide.offset[di] + (int64_t)c * HB_WIDE_SPAN +
                 (int64_t)rank * HB_PART,
             wacc, HB_PART * (int)sizeof(S));
}

// Backward 5. Dense rows: entry e < span = the sum of the level's partials
// in partial order (FIX: int64, then converted), zero beyond; block = tile
// of HB_REDUCE_TILE entries x dense level.
template <bool FIX>
__global__ void __launch_bounds__(HB_THREADS)
hb_reduce_kernel(const typename Sums<FIX>::T* __restrict__ partials,
                 LevelSet dense, float2* __restrict__ dtable, int64_t t,
                 const unsigned* __restrict__ amax, int n) {
  const int di = blockIdx.x % dense.n;
  const int64_t e = (int64_t)(blockIdx.x / dense.n) * HB_REDUCE_TILE +
                    threadIdx.x;
  if (e >= t) return;
  const int span = dense.span[di];
  float2 sum = make_float2(0.0f, 0.0f);
  if (e < span) {
    const auto* src = partials + dense.offset[di] + e;
    if constexpr (FIX) {
      longlong2 s = make_longlong2(0, 0);
      for (int b = 0; b < dense.parts[di]; ++b) {
        const longlong2 v = src[(int64_t)b * span];
        s.x += v.x;
        s.y += v.y;
      }
      sum = from_fix(s, fix_scale(amax, n));
    } else {
      for (int b = 0; b < dense.parts[di]; ++b) {
        const float2 v = src[(int64_t)b * span];
        sum.x = __fadd_rn(sum.x, v.x);
        sum.y = __fadd_rn(sum.y, v.y);
      }
    }
  }
  dtable[(int64_t)dense.level[di] * t + e] = sum;
}

static int launch_args(const int* rows_host, int n, int levels,
                       LevelRows* rows) {
  if (levels <= 0 || levels > HE_MAX_LEVELS || n < 0)
    return (int)cudaErrorInvalidValue;
  memset(rows, 0, sizeof(*rows));
  memcpy(rows->v, rows_host, sizeof(int) * levels * HE_ROW);
  return 0;
}

// The int32 scratch that the forward's sort fills and the backward reads
// (ops/hash_encode_win.py::bwd_plan sizes it the same): the chunk table
// (4 ints a chunk), counts, cursor, meta (4: chunks, split segments),
// split segments, order.
static int64_t max_chunks(int n, int n_seg) {
  return ((int64_t)n + HB_CHUNK - 1) / HB_CHUNK + n_seg;
}

static int64_t max_split(int n, int n_seg) {
  const int64_t s = (int64_t)n / (HB_CHUNK + 1);
  return s < n_seg ? s : n_seg;
}

struct Work {
  int4* chunks;
  int *counts, *cursor, *meta, *split, *order;
};

static int work_layout(void* work, long long work_ints, int n, int n_seg,
                       Work* w) {
  const int64_t n_chunks = max_chunks(n, n_seg), n_split = max_split(n, n_seg);
  if (work_ints < 4 * n_chunks + 2 * (int64_t)n_seg + 4 + n_split + n)
    return (int)cudaErrorInvalidValue;
  int* p = (int*)work;
  w->chunks = (int4*)p;
  w->counts = p + 4 * n_chunks;
  w->cursor = w->counts + n_seg;
  w->meta = w->cursor + n_seg;
  w->split = w->meta + 4;
  w->order = w->split + n_split;
  return 0;
}

static bool table_ok(long long t) {
  return t >= HE_PAGE_ENTRIES && !(t & (t - 1));
}

#define HB_CHECK()                               \
  do {                                           \
    const int e_ = (int)cudaGetLastError();      \
    if (e_) return e_;                           \
  } while (0)

// C interface, bound with ctypes. Pointers are device pointers except
// rows_host ([levels, 8] int32) and spans_host ([levels] int32) on the
// host. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after each launch.

// The forward: out [n, levels, 2] f32, base_out [n] int32 (each point's
// page base), and the sort in `work` for the backward. bounds: the n_seg =
// t / 1024 sorted page bounds, int64.
extern "C" int he_win_fwd(const void* table, const void* x,
                          const void* bounds, int n_seg, const int* rows_host,
                          void* out, void* base_out, void* work,
                          long long work_ints, int n, int levels, long long t,
                          void* stream) {
  LevelRows rows;
  int err = launch_args(rows_host, n, levels, &rows);
  if (err) return err;
  if (!table_ok(t) || n_seg != t / HE_PAGE_ENTRIES || n_seg > HF_MAX_SEGS)
    return (int)cudaErrorInvalidValue;
  Work w;
  err = work_layout(work, work_ints, n, n_seg, &w);
  if (err) return err;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned pt_blocks = (unsigned)((n + HB_THREADS - 1) / HB_THREADS);
  const size_t fwd_smem = sizeof(float) * (4 * HE_PAGE_ENTRIES +
                                           HF_PTS * (2 * levels + 1));
  if (fwd_smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        hf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)fwd_smem);
    if (err) return err;
  }
  err = (int)cudaMemsetAsync(w.counts, 0, sizeof(int) * n_seg, s);
  if (err) return err;
  hf_key_kernel<<<pt_blocks, HB_THREADS, 0, s>>>(
      (const float*)x, (const long long*)bounds, n_seg, n, (int*)base_out,
      w.counts);
  HB_CHECK();
  hb_plan_kernel<<<1, HB_PLAN_THREADS, 0, s>>>(w.counts, n_seg, w.cursor,
                                               w.chunks, w.split, w.meta);
  HB_CHECK();
  hb_scatter_kernel<<<pt_blocks, HB_THREADS, 0, s>>>((const int*)base_out, n,
                                                     w.cursor, w.order);
  HB_CHECK();
  const int64_t blocks = max_chunks(n, n_seg) * (HB_CHUNK / HF_PTS);
  hf_fwd_kernel<<<(unsigned)blocks, HF_PTS, fwd_smem, s>>>(
      (const float2*)table, (const float*)x, rows, w.order, w.chunks, w.meta,
      (float*)out, levels, (int64_t)t);
  HB_CHECK();
  return 0;
}

// The backward, from the forward's sort in `work`. spans_host: per level 0
// (paged) or the dense box's morton span, a power of 8 <= HB_DENSE_SPAN or
// exactly HB_WIDE_SPAN. dense_parts: partial sums (blocks) per dense level
// of span <= HB_DENSE_SPAN; wide_parts: clusters per level of span
// HB_WIDE_SPAN; partials: per dense level, parts x span entries of 8 bytes
// (float2) or, FIX, 16 (longlong2). FIX: `fix` holds max|g| (16 bytes) and
// then the split segments' int64 pages (max_split x paged levels x 1024
// longlong2), fix_bytes long.
template <bool FIX>
static int win_bwd(const void* g, const void* x, const int* rows_host,
                   void* dtable, int n, int levels, long long t,
                   const int* spans_host, void* work, long long work_ints,
                   void* partials, long long partial_entries, int dense_parts,
                   int wide_parts, void* fix, long long fix_bytes,
                   void* stream) {
  typedef typename Sums<FIX>::T S;
  LevelRows rows;
  int err = launch_args(rows_host, n, levels, &rows);
  if (err) return err;
  if (!table_ok(t) || dense_parts < 1 || wide_parts < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0)
    return (int)cudaMemsetAsync(dtable, 0, (size_t)levels * t * 8, s);
  LevelSet paged, dense, wide, rowsets;
  memset(&paged, 0, sizeof(paged));
  memset(&dense, 0, sizeof(dense));
  memset(&wide, 0, sizeof(wide));
  int64_t part_off = 0;
  int dense_max = 8;
  for (int l = 0; l < levels; ++l) {
    const int span = spans_host[l];
    const bool flag = rows.v[l * HE_ROW + 1] != 0;
    if (span == 0 && !flag) {
      paged.level[paged.n++] = l;
      continue;
    }
    const bool pow8 = span >= 8 && !(span & (span - 1)) &&
                      (__builtin_ctz((unsigned)span) % 3) == 0;
    if (!flag || !pow8 || span > t) return (int)cudaErrorInvalidValue;
    LevelSet* set;
    int parts;
    if (span <= HB_DENSE_SPAN) {
      set = &dense;
      parts = dense_parts;
      if (span > dense_max) dense_max = span;
    } else if (span == HB_WIDE_SPAN) {
      set = &wide;
      parts = wide_parts;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    set->level[set->n] = l;
    set->span[set->n] = span;
    set->parts[set->n] = parts;
    set->offset[set->n] = part_off;
    set->n++;
    part_off += (int64_t)parts * span;
  }
  const int n_seg = (int)(t / HE_PAGE_ENTRIES);
  Work w;
  err = work_layout(work, work_ints, n, n_seg, &w);
  if (err) return err;
  if (partial_entries < part_off) return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = max_chunks(n, n_seg), n_split = max_split(n, n_seg);
  S* part = (S*)partials;
  unsigned* amax = nullptr;
  longlong2* split_acc = nullptr;
  if (FIX) {
    if (!fix || fix_bytes < 16 + n_split * paged.n * HE_PAGE_ENTRIES * 16)
      return (int)cudaErrorInvalidValue;
    amax = (unsigned*)fix;
    split_acc = (longlong2*)((char*)fix + 16);
    err = (int)cudaMemsetAsync(amax, 0, 16, s);
    if (err) return err;
    const long long count = (long long)n * levels * 2;
    const long long want = (count + HB_THREADS - 1) / HB_THREADS;
    hb_absmax_kernel<<<(unsigned)(want < 8 * 132 ? want : 8 * 132),
                       HB_THREADS, 0, s>>>((const float*)g, count, amax);
    HB_CHECK();
  }

  // 1.-2. paged levels
  if (paged.n) {
    if (n_split) {
      hb_zero_split_kernel<FIX><<<(unsigned)(n_split * paged.n), HB_THREADS,
                                  0, s>>>(paged, w.split, w.meta,
                                          (float2*)dtable, (int64_t)t,
                                          split_acc);
      HB_CHECK();
    }
    hb_page_kernel<FIX><<<(unsigned)(n_chunks * paged.n), HB_THREADS, 0, s>>>(
        (const float2*)g, (const float*)x, rows, paged, w.order, w.chunks,
        w.meta, (float2*)dtable, levels, (int64_t)t, amax, split_acc, n);
    HB_CHECK();
    if (FIX && n_split) {
      hb_split_out_kernel<<<(unsigned)(n_split * paged.n), HB_THREADS, 0,
                            s>>>(paged, w.split, w.meta, split_acc,
                                 (float2*)dtable, (int64_t)t, amax, n);
      HB_CHECK();
    }
  }
  // 3.-5. dense levels
  if (dense.n) {
    const size_t smem = (size_t)dense_max * sizeof(S);
    if (smem > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(
          hb_dense_kernel<FIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err) return err;
    }
    hb_dense_kernel<FIX><<<(unsigned)(dense_parts * dense.n), HB_THREADS,
                           smem, s>>>((const float2*)g, (const float*)x, rows,
                                      dense, w.order, part, n, levels, amax);
    HB_CHECK();
  }
  if (wide.n) {
    const size_t smem = (size_t)HB_PART * sizeof(S);
    err = (int)cudaFuncSetAttribute(
        hb_wide_kernel<FIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    hb_wide_kernel<FIX><<<(unsigned)(wide_parts * HB_CLUSTER * wide.n),
                          HB_THREADS, smem, s>>>(
        (const float2*)g, (const float*)x, rows, wide, w.order, part, n,
        levels, amax);
    HB_CHECK();
  }
  memcpy(&rowsets, &dense, sizeof(rowsets));
  for (int i = 0; i < wide.n; ++i) {
    rowsets.level[rowsets.n] = wide.level[i];
    rowsets.span[rowsets.n] = wide.span[i];
    rowsets.parts[rowsets.n] = wide.parts[i];
    rowsets.offset[rowsets.n] = wide.offset[i];
    rowsets.n++;
  }
  if (rowsets.n) {
    const int64_t tiles = (t + HB_REDUCE_TILE - 1) / HB_REDUCE_TILE;
    hb_reduce_kernel<FIX><<<(unsigned)(tiles * rowsets.n), HB_THREADS, 0, s>>>(
        part, rowsets, (float2*)dtable, (int64_t)t, amax, n);
    HB_CHECK();
  }
  return 0;
}

extern "C" int he_win_bwd(const void* g, const void* x, const int* rows_host,
                          void* dtable, int n, int levels, long long t,
                          const int* spans_host, void* work,
                          long long work_ints, void* partials,
                          long long partial_entries, int dense_parts,
                          int wide_parts, void* stream) {
  return win_bwd<false>(g, x, rows_host, dtable, n, levels, t, spans_host,
                        work, work_ints, partials, partial_entries,
                        dense_parts, wide_parts, nullptr, 0, stream);
}

// The fixed-order variant (see the note at the top): the same arguments,
// partials of 16 bytes an entry, and the scratch `fix`.
extern "C" int he_win_bwd_fix(const void* g, const void* x,
                              const int* rows_host, void* dtable, int n,
                              int levels, long long t, const int* spans_host,
                              void* work, long long work_ints, void* partials,
                              long long partial_entries, int dense_parts,
                              int wide_parts, void* fix, long long fix_bytes,
                              void* stream) {
  return win_bwd<true>(g, x, rows_host, dtable, n, levels, t, spans_host,
                       work, work_ints, partials, partial_entries,
                       dense_parts, wide_parts, fix, fix_bytes, stream);
}

extern "C" const char* he_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
