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
// The index makes the writes local, as above. The default backward
// (he_win_bwd, ha_* kernels) sums in f32 with atomics: a (chunk, paged
// level) a block into its page in shared memory (one 64-bit
// compare-and-swap a corner, both features at once), stored whole, or
// added to the table for a segment split into several chunks; dense levels
// as slices of the sorted points over the whole span, a span of 32,768
// across a 4-block cluster, the slices' partial sums added in order. Its
// last bits follow the order in which the adds land, which changes from
// launch to launch.
//
// The fixed-order variant (he_win_bwd_fix; the wrapper takes it under
// torch.use_deterministic_algorithms): launches on the same inputs give
// the same bits, whatever the scheduling, so that a seeded trainer repeats
// itself bit for bit. Each block sums its points exactly: every
// contribution w * g is rounded once to an int64 multiple of 2^-k, k the
// block's own (per feature), chosen from a bound B >= sum |g| over the
// block's points so that 2^(62 - k) > B: no sum of an entry's
// contributions (a point's weights sum to 1) reaches 2^63, and integer sums
// are exact, so the order of the adds, of the warps and of the blocks does
// not matter. The quantum 2^-k is at most 2^-61 B: an entry's sum of n
// contributions is within n / 2 quanta of their exact sum, then rounded
// once to f32, as close as the last rounding of an f32 sum for every entry
// above n 2^-37 B. An int64 sum is held as two 32-bit words (the low one
// unsigned), added with native 32-bit shared atomics: the low word's add
// returns its old value, which gives the carry into the high word (a
// 64-bit integer add in shared memory compiles to a compare-and-swap loop).
// That is four atomics a corner where the default takes one
// compare-and-swap loop, which bounds the variant (PERF.md section 6). The
// block's sums go back to f32 once, and blocks whose points share entries
// are added in f32 in a fixed order. So the variant, from the forward's
// sort,
//   0. sorts the point ids of each segment longer than HB_CHUNK
//      (hb_split_sort_kernel: a bitmap of the ids in shared memory, a
//      scan), so that its chunks hold the same points in every launch (the
//      forward's scatter places a warp's points with an atomic, in an order
//      that changes); a sole chunk's order does not matter (exact sums);
//   1. paged levels (hb_page_kernel): one block per (chunk, level) finds B
//      (max |g|, then each |g| rounded up to a multiple of 2^(e - 32) and
//      summed as integers: no rounding that depends on the points' order),
//      sums its points into the page held whole in shared memory (16 KB) and
//      writes it once, in f32, zeros included: a sole chunk's page straight
//      to the table, a split segment's chunk pages to scratch;
//   2. dense levels of span <= HB_DENSE_SPAN (hb_dense_kernel): blocks sum
//      slices of the points in their own order (the same points each
//      launch; B in double, in a fixed order) over the whole span and write
//      f32 partial sums; span HB_WIDE_SPAN (hb_wide_kernel): a
//      cluster of HB_CLUSTER blocks holds the span in its distributed
//      shared memory (128 KB a block), each corner added in the block that
//      owns its quarter, at one scale (B summed over the cluster in rank
//      order);
//   3. hb_final_kernel adds each dense row's partials and each split
//      segment's chunk pages in order and writes them once, zeros beyond a
//      dense span included.
// In the variant a non-finite cotangent makes every entry NaN (a flag the
// blocks set and the last kernel reads). In both backwards, lanes of a warp
// whose corners share an entry are summed first (warp_add:
// __match_any_sync, then a prefix sum over each group by pointer jumping),
// so a hot coarse entry
// takes one shared-memory update a warp. The grids are sized from upper
// bounds (at most ceil(N / HB_CHUNK) + n_segments chunks); surplus blocks
// exit at once, and no count is read back to the host. What bounds either
// is not bytes (one pass over g and one write of the table take ~0.03 ms at
// 262,144 points) but the eight shared-memory updates a (point, level) and
// the short blocks' dependent loads and barriers (PERF.md section 6).
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

// The encode's schedule. Compile-time constants, mirrored in
// ops/hash_encode_win.py, which sizes the scratch.
#define HB_THREADS 256
#define HB_CHUNK 1024          // points of one segment a chunk holds
#define HB_DENSE_SPAN 4096     // largest span one block sums (32 KB; 64 variant)
#define HB_WIDE_SPAN 32768     // DENSE_BOX_CAP: summed across a cluster
#define HB_CLUSTER 4           // blocks of a cluster, a quarter each (64 KB; 128)
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

// A contribution as the sums take it: an int64 multiple of 2^-k, k chosen
// per block (block_scale, int_scale).
struct AsInt {
  float s[2];      // 2^k of each feature, a normal f32 (|k| <= 126)
  float inv[2];    // 2^-k
  // feature f's contribution v: v * 2^k is exact (a power of two), rounded
  // once to the nearest integer
  __device__ __forceinline__ long long operator()(float v, int f) const {
    return __float2ll_rn(__fmul_rn(v, s[f]));
  }
  // a sum (low words lo, high words hi) back in f32: the integer rounded
  // once to f32, then scaled by a power of two (exact unless the result is
  // subnormal)
  __device__ __forceinline__ float value(unsigned lo, int hi, int f) const {
    const long long v = (long long)(((unsigned long long)(unsigned)hi << 32) |
                                    lo);
    return __fmul_rn(__ll2float_rn(v), inv[f]);
  }
  // two entries (uint4 / int4: x0, y0, x1, y1) into a float4
  __device__ __forceinline__ float4 value2(uint4 lo, int4 hi) const {
    return make_float4(value(lo.x, hi.x, 0), value(lo.y, hi.y, 1),
                       value(lo.z, hi.z, 0), value(lo.w, hi.w, 1));
  }
};

// v added to the int64 held as the words *lo (unsigned) and *hi: native
// 32-bit atomics, the low word's carry taken from the value it held. Every
// add of the low word is counted in the high word once, so the pair is
// exact in any order (the high word's adds wrap as int32; only their total,
// whose sum is below 2^63, has to fit).
__device__ __forceinline__ void add64(unsigned* lo, int* hi, long long v) {
  const unsigned r = (unsigned)v;
  int c = (int)(v >> 32);
  if (r) c += atomicAdd(lo, r) + r < r ? 1 : 0;
  if (c) atomicAdd(hi, c);
}

// The sums: int64 pairs as two 32-bit words each (lo, hi: [entries] uint2 /
// int2, x and y the features), in the block's shared memory or
// (ClusterIntAdd, entry k in block k >> HB_PART_BITS) in the cluster's.
struct SmemIntAdd {
  uint2* lo;
  int2* hi;
  __device__ __forceinline__ void operator()(uint32_t k, long long a,
                                             long long b) const {
    add64(&lo[k].x, &hi[k].x, a);
    add64(&lo[k].y, &hi[k].y, b);
  }
};

struct ClusterIntAdd {
  uint2* lo;
  int2* hi;
  __device__ __forceinline__ void operator()(uint32_t k, long long a,
                                             long long b) const {
    cg::cluster_group cluster = cg::this_cluster();
    const int r = (int)(k >> HB_PART_BITS);
    const uint32_t i = k & (HB_PART - 1);
    uint2* l = cluster.map_shared_rank(lo, r) + i;
    int2* h = cluster.map_shared_rank(hi, r) + i;
    add64(&l->x, &h->x, a);
    add64(&l->y, &h->y, b);
  }
};

// The atomic kernel's sums (ha_*): f32 pairs. In the block's own shared
// memory, one 64-bit compare-and-swap loop adds both features (two f32
// reductions, red.shared.add.f32, measured slower on the H100); in the
// cluster's (entry k in block k >> HB_PART_BITS), two f32 atomics; in
// device memory, one vector reduction.
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

__device__ __forceinline__ void red_add2(float2* addr, float a, float b) {
  atomicAdd(addr, make_float2(a, b));  // one vector reduction on sm_90
}

// A contribution as the atomic kernel sums it: the f32 product itself.
struct AsF32 {
  __device__ __forceinline__ float operator()(float v, int) const {
    return v;
  }
};

// The block's sums back in f32: entries [0, n) (n even) of lo / hi to dst,
// two a thread at a time.
__device__ __forceinline__ void write_sums(float2* dst, const uint2* lo,
                                           const int2* hi, int n,
                                           const AsInt& val) {
  const uint4* l4 = reinterpret_cast<const uint4*>(lo);
  const int4* h4 = reinterpret_cast<const int4*>(hi);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 2; i += blockDim.x)
    d4[i] = val.value2(l4[i], h4[i]);
}

// The block-wide max of m[2] (f32 bits of |g|: non-negative floats order as
// their bits do, a NaN's above inf's), and the block-wide sum of q[2]; `red`
// holds 16 values of shared memory, a call's own. Every thread of the block
// calls; every thread gets the result. Both are exact, so the order of the
// reduction is moot.
__device__ __forceinline__ void block_max2(unsigned m[2],
                                           unsigned long long* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    m[f] = __reduce_max_sync(0xFFFFFFFFu, m[f]);
    if (lane == 0) red[f * 8 + wid] = m[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    m[f] = 0;
    for (int w = 0; w < nw; ++w) m[f] = max(m[f], (unsigned)red[f * 8 + w]);
  }
}

__device__ __forceinline__ void block_sum2(unsigned long long q[2],
                                           unsigned long long* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      q[f] += __shfl_xor_sync(0xFFFFFFFFu, q[f], d);
    if (lane == 0) red[f * 8 + wid] = q[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    q[f] = 0;
    for (int w = 0; w < nw; ++w) q[f] += red[f * 8 + w];
  }
}

// Bounds on the sum of |g| over a block's points, with no rounding that
// depends on their order: given the max m (f32 bits) of a feature, each |g|
// is rounded up to a multiple of 2^(e - 32), where m < 2^e, and the
// multiples are summed as integers (< 2^32 each).
__device__ __forceinline__ int max_exponent(unsigned m) {
  int e = 0;
  if (m && m < 0x7F800000u) frexpf(__uint_as_float(m), &e);
  return e;
}

__device__ __forceinline__ unsigned long long bound_units(float v, int e) {
  return (unsigned long long)ceil(fabs((double)v) * ldexp(1.0, 32 - e));
}

// The scale from bounds b[f] >= sum |g| over the block's points: 2^k with
// 2^(62 - k) above the bound, so that no sum of an entry's contributions
// (|w| <= 1, weights of a point summing to 1) reaches 2^63 (the rounding of
// each to an integer adds at most 1/2 a contribution; 2^62 leaves room for
// 2^61 of them a block). k is clamped to [-126, 126]: a bound under 2^-64
// takes the quantum 2^-126.
__device__ __forceinline__ AsInt int_scale(const double b[2]) {
  AsInt a;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    int eb = 0;
    if (b[f] > 0.0 && b[f] <= 1.0e308) frexp(b[f], &eb);
    const int k = min(max(62 - eb, -126), 126);   // 2^(-k) normal too
    a.s[f] = __int_as_float((k + 127) << 23);
    a.inv[f] = __int_as_float((127 - k) << 23);
  }
  return a;
}

// The block-wide sum of d[2] in a fixed order (each warp's lane 0, then the
// warps in turn) into every thread: the same bits in every launch where
// each thread's d is.
__device__ __forceinline__ void block_sumd2(double d[2], double* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      d[f] += __shfl_down_sync(0xFFFFFFFFu, d[f], o);
    if (lane == 0) red[f * 8 + wid] = d[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    d[f] = 0.0;
    for (int w = 0; w < nw; ++w) d[f] += red[f * 8 + w];
  }
}

// Sums the points i_begin .. i_end - 1 (the ids order[i], or i where order
// is null) of dense level l (geometry `row`) into add: one point a thread,
// HB_THREADS at a time, warps kept converged for warp_add. `val` turns each
// f32 contribution (and its feature) into what `add` sums.
template <class Val, class Add>
__device__ __forceinline__ void scatter_points(
    const float2* __restrict__ g, const float* __restrict__ x,
    const int* __restrict__ order, int i_begin, int i_end, int l, int levels,
    const int row[HE_ROW], const Val& val, const Add& add) {
  for (int i0 = i_begin; i0 < i_end; i0 += HB_THREADS) {
    const int i = i0 + (int)threadIdx.x;
    const bool on = i < i_end;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
    if (!on) continue;
    const int64_t p = order ? order[i] : i;
    const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
    uint32_t idx[8];
    float w[8];
    corner_geom(xp, 0u, row, idx, w);
    const float2 gv = g[p * levels + l];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      warp_add(active, idx[c], val(__fmul_rn(w[c], gv.x), 0),
               val(__fmul_rn(w[c], gv.y), 1), add);
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

// Dense rows: entry e < span = the sum of the level's partials in partial
// order, zero beyond (NaN where `bad`); block b = tile of HB_REDUCE_TILE
// entries x dense level.
__device__ __forceinline__ void reduce_rows(const float2* __restrict__ partials,
                                            const LevelSet& dense,
                                            float2* __restrict__ dtable,
                                            int64_t t, int b, bool bad) {
  const int di = b % dense.n;
  const int64_t e = (int64_t)(b / dense.n) * HB_REDUCE_TILE + threadIdx.x;
  if (e >= t) return;
  const int span = dense.span[di];
  float2 sum = make_float2(0.0f, 0.0f);
  if (e < span) {
    const float2* src = partials + dense.offset[di] + e;
    for (int p = 0; p < dense.parts[di]; ++p) {
      const float2 v = src[(int64_t)p * span];
      sum.x = __fadd_rn(sum.x, v.x);
      sum.y = __fadd_rn(sum.y, v.y);
    }
  }
  if (bad) sum = make_float2(__int_as_float(0x7FC00000), __int_as_float(0x7FC00000));
  dtable[(int64_t)dense.level[di] * t + e] = sum;
}

// ---------------------------------------------------------------------------
// The backward (he_win_bwd; see the note at the top)
// ---------------------------------------------------------------------------

#define HB_PPT (HB_CHUNK / HB_THREADS)   // a chunk's points a thread takes
#define HB_SORT_THREADS 1024             // = HB_PLAN_THREADS (block_excl_scan)
#define HB_SORT_WINDOW (1 << 20)         // point ids a bitmap pass covers
#define HB_FILL_BLOCKS 264               // blocks that write NaN if told to

// The block's scale from its threads' points where the order of a block's
// points may change between launches (a chunk of a segment): m[2] the
// threads' max |g| bits, then each thread's q from `units(e)` (its sum of
// bound_units over its points), summed exactly. Sets *flag if a cotangent
// is not finite.
template <class Units>
__device__ __forceinline__ AsInt block_scale(unsigned m[2],
                                             unsigned long long* red,
                                             int* flag, const Units& units) {
  block_max2(m, red);    // red[0, 16) for the max, red[16, 32) for the sum
  if (threadIdx.x == 0 && (m[0] >= 0x7F800000u || m[1] >= 0x7F800000u))
    atomicOr(flag, 1);
  const int e[2] = {max_exponent(m[0]), max_exponent(m[1])};
  unsigned long long q[2];
  units(e, q);
  block_sum2(q, red + 16);
  const double b[2] = {(double)q[0] * ldexp(1.0, e[0] - 32),
                       (double)q[1] * ldexp(1.0, e[1] - 32)};
  return int_scale(b);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// Backward 1. Each split segment's point ids sorted, in place in `order`, into
// increasing order (block = split segment): a bitmap of the ids in shared
// memory (HB_SORT_WINDOW ids a pass), a block-wide scan of its population
// counts, and the ids written out in order (straight into `order` where
// one pass covers every id; else into `sorted`, then copied back). Its
// chunks then hold the same points in every launch. Also claims the
// segment's slots among the chunk pages (split_slot[k]: where they start;
// which slots it gets does not change a result).
#define HB_SORT_UNROLL 4
__global__ void __launch_bounds__(HB_SORT_THREADS)
hb_split_sort_kernel(int* __restrict__ order, const int* __restrict__ cursor,
                     const int* __restrict__ counts,
                     const int* __restrict__ split,
                     const int* __restrict__ meta, int* __restrict__ sorted,
                     int* __restrict__ split_slot, int* __restrict__ slots,
                     int n) {
  extern __shared__ unsigned bm[];
  __shared__ int tot[33];
  const int k = blockIdx.x;
  if (k >= meta[1]) return;
  const int s = split[k], cnt = counts[s];
  const int start = cursor[s] - cnt;   // the scatter left cursor at the end
  const int tid = threadIdx.x;
  if (tid == 0)
    split_slot[k] = atomicAdd(slots, (cnt + HB_CHUNK - 1) / HB_CHUNK);
  const bool one_pass = n <= HB_SORT_WINDOW;
  int* out_ids = one_pass ? order : sorted;
  int out = start;
  for (int base = 0; base < n; base += HB_SORT_WINDOW) {
    const int span = min(HB_SORT_WINDOW, n - base);
    const int words = (span + 31) / 32;
    for (int i = tid; i < words; i += HB_SORT_THREADS) bm[i] = 0u;
    __syncthreads();
    // every lane of a warp takes each round (the match below)
    for (int i0 = 0; i0 < cnt; i0 += HB_SORT_UNROLL * HB_SORT_THREADS) {
      int p[HB_SORT_UNROLL];
#pragma unroll
      for (int u = 0; u < HB_SORT_UNROLL; ++u) {
        const int i = i0 + tid + u * HB_SORT_THREADS;
        p[u] = i < cnt ? order[start + i] - base : -1;
      }
#pragma unroll
      for (int u = 0; u < HB_SORT_UNROLL; ++u) {
        // a warp's ids are often neighbours: one atomic a word a warp
        const bool in = p[u] >= 0 && p[u] < span;
        const int word = in ? p[u] >> 5 : -1;
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, word);
        const unsigned bits =
            __reduce_or_sync(peers, in ? 1u << (p[u] & 31) : 0u);
        if (in && (threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1))
          atomicOr(bm + word, bits);
      }
    }
    __syncthreads();   // every id read before any is written (one pass)
    const int per = (words + HB_SORT_THREADS - 1) / HB_SORT_THREADS;
    const int w0 = min(tid * per, words), w1 = min(w0 + per, words);
    int c = 0;
    for (int w = w0; w < w1; ++w) c += __popc(bm[w]);
    int total;
    int pos = out + block_excl_scan(c, tot, &total);
    for (int w = w0; w < w1; ++w)
      for (unsigned bits = bm[w]; bits; bits &= bits - 1u)
        out_ids[pos++] = base + w * 32 + __ffs(bits) - 1;
    out += total;
    __syncthreads();   // every bit read before the next pass clears them
  }
  if (!one_pass)
    for (int i = tid; i < cnt; i += HB_SORT_THREADS)
      order[start + i] = sorted[start + i];
}

// Backward 2. Paged levels: block = chunk x paged level (the levels of one
// chunk are neighbours in launch order, so a point's cotangent row is read
// from device memory once and from L2 after), each thread HB_PPT of the
// chunk's points, summed in the block's own fixed point into int64 pairs in
// shared memory (16 KB); the page written once, in f32: a sole chunk's
// straight to the table, a split segment's chunk to its slot of the chunk
// pages (hb_final_kernel adds them in chunk order). Held to 40 registers,
// six blocks an SM, some spilled bytes included: 13 % faster than at 64
// registers and four blocks (PERF.md section 6).
__global__ void __launch_bounds__(HB_THREADS, 6)
hb_page_kernel(const float2* __restrict__ g, const float* __restrict__ x,
                   LevelRows rows, LevelSet paged,
                   const int* __restrict__ order,
                   const int4* __restrict__ chunks,
                   const int* __restrict__ meta,
                   const int* __restrict__ cursor,
                   const int* __restrict__ counts,
                   const int* __restrict__ split_slot,
                   float2* __restrict__ dtable, float2* __restrict__ pages,
                   int* __restrict__ flag, int levels, int64_t t) {
  __shared__ __align__(16) uint2 lo[HE_PAGE_ENTRIES];
  __shared__ __align__(16) int2 hi[HE_PAGE_ENTRIES];
  __shared__ int srow[HE_ROW];
  __shared__ unsigned long long red[32];
  const int li = blockIdx.x % paged.n;
  const int k = blockIdx.x / paged.n;
  if (k >= meta[0]) return;
  const int4 ch = chunks[k];
  const int l = paged.level[li];
  const uint32_t seg_base = (uint32_t)ch.x * HE_PAGE_ENTRIES;
  if (ch.z == 0) {   // an empty segment: its page is 0 (a sole chunk)
    zero_bytes(dtable + (int64_t)l * t + seg_base, HE_PAGE_ENTRIES * 8);
    return;
  }
  zero_bytes(lo, sizeof(lo));
  zero_bytes(hi, sizeof(hi));
  int row[HE_ROW];
  level_row(rows, l, srow, row);
  const int tid = threadIdx.x;
  int p[HB_PPT];
  float2 gv[HB_PPT];
  unsigned m[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < HB_PPT; ++j) {
    const int i = tid + j * HB_THREADS;
    p[j] = i < ch.z ? order[ch.y + i] : -1;
    gv[j] = p[j] >= 0 ? g[(int64_t)p[j] * levels + l]
                      : make_float2(0.0f, 0.0f);
    m[0] = max(m[0], abs_bits(gv[j].x));
    m[1] = max(m[1], abs_bits(gv[j].y));
  }
  const AsInt val = block_scale(m, red, flag,
                                [&](const int e[2], unsigned long long q[2]) {
    q[0] = q[1] = 0;
#pragma unroll
    for (int j = 0; j < HB_PPT; ++j) {
      q[0] += bound_units(gv[j].x, e[0]);
      q[1] += bound_units(gv[j].y, e[1]);
    }
  });
  const SmemIntAdd add{lo, hi};
#pragma unroll
  for (int j = 0; j < HB_PPT; ++j) {
    const bool on = p[j] >= 0;   // the chunk's first points: a warp prefix
    const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
    if (!on) continue;
    const int64_t q = p[j];
    const float xp[3] = {x[3 * q], x[3 * q + 1], x[3 * q + 2]};
    uint32_t idx[8];
    float w[8];
    corner_geom(xp, seg_base, row, idx, w);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      warp_add(active, idx[c] - seg_base, val(__fmul_rn(w[c], gv[j].x), 0),
               val(__fmul_rn(w[c], gv[j].y), 1), add);
  }
  __syncthreads();
  float2* dst;
  if (ch.w > 0) {
    dst = dtable + (int64_t)l * t + seg_base;
  } else {
    const int start = cursor[ch.x] - counts[ch.x];
    const int slot = split_slot[-ch.w - 1] + (ch.y - start) / HB_CHUNK;
    dst = pages + ((int64_t)slot * paged.n + li) * HE_PAGE_ENTRIES;
  }
  write_sums(dst, lo, hi, HE_PAGE_ENTRIES, val);
}

// The thread's max |g| bits and sum of |g| (double, in its points' order)
// over the points [i0, i1) of level l it takes (every HB_THREADS-th from i0
// + its index): a slice's points and their order are the same in every
// launch, so the sums are too.
__device__ __forceinline__ void slice_bound(const float2* __restrict__ g,
                                            int i0, int i1, int l, int levels,
                                            unsigned m[2], double d[2]) {
  m[0] = m[1] = 0u;
  d[0] = d[1] = 0.0;
  for (int i = i0 + (int)threadIdx.x; i < i1; i += HB_THREADS) {
    const float2 v = g[(int64_t)i * levels + l];
    m[0] = max(m[0], abs_bits(v.x));
    m[1] = max(m[1], abs_bits(v.y));
    d[0] += fabs((double)v.x);
    d[1] += fabs((double)v.y);
  }
}

__device__ __forceinline__ void flag_nonfinite(const unsigned m[2],
                                               int* flag) {
  if (threadIdx.x == 0 && (m[0] >= 0x7F800000u || m[1] >= 0x7F800000u))
    atomicOr(flag, 1);
}

// Backward 3. Dense levels of span <= HB_DENSE_SPAN: block = slice b of the
// points in their own order (so the same points each launch) x level, summed
// in the block's fixed point over the whole span (int64 pairs, 16 bytes an
// entry); its row of the level's partials in f32.
__global__ void __launch_bounds__(HB_THREADS)
hb_dense_kernel(const float2* __restrict__ g, const float* __restrict__ x,
                    LevelRows rows, LevelSet dense,
                    float2* __restrict__ partials, int* __restrict__ flag,
                    int n, int levels) {
  extern __shared__ __align__(16) uint2 dsums[];   // lo [span], hi [span]
  __shared__ int srow[HE_ROW];
  __shared__ unsigned long long red[32];
  const int di = blockIdx.x % dense.n;
  const int b = blockIdx.x / dense.n;
  const int l = dense.level[di], span = dense.span[di];
  const int parts = dense.parts[di];
  uint2* lo = dsums;
  int2* hi = reinterpret_cast<int2*>(dsums + span);
  zero_bytes(dsums, span * 16);
  int row[HE_ROW];
  level_row(rows, l, srow, row);
  const int i0 = (int)((int64_t)n * b / parts);
  const int i1 = (int)((int64_t)n * (b + 1) / parts);
  unsigned m[2];
  double d[2];
  slice_bound(g, i0, i1, l, levels, m, d);
  block_max2(m, red);
  flag_nonfinite(m, flag);
  block_sumd2(d, reinterpret_cast<double*>(red + 16));
  const AsInt val = int_scale(d);
  scatter_points(g, x, nullptr, i0, i1, l, levels, row, val,
                 SmemIntAdd{lo, hi});
  __syncthreads();
  write_sums(partials + dense.offset[di] + (int64_t)b * span, lo, hi, span,
             val);
}

// Backward 4. Dense levels of span HB_WIDE_SPAN: cluster c of the level sums
// slice c of the points in their own order (its blocks a quarter each) into
// the span, held a quarter a block as int64 pairs (128 KB), in the fixed
// point of the whole slice: the blocks' sums of |g| are exchanged through
// the cluster's shared memory, so that all four take one scale. Each block
// then writes its quarter, in f32, to the cluster's row of the partials.
__global__ void __cluster_dims__(HB_CLUSTER, 1, 1) __launch_bounds__(HB_THREADS)
hb_wide_kernel(const float2* __restrict__ g, const float* __restrict__ x,
                   LevelRows rows, LevelSet wide,
                   float2* __restrict__ partials, int* __restrict__ flag,
                   int n, int levels) {
  extern __shared__ __align__(16) uint2 wsums[];   // lo, hi [HB_PART]
  __shared__ int srow[HE_ROW];
  __shared__ unsigned long long red[32];
  __shared__ double mine[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / HB_CLUSTER;
  const int di = cid % wide.n;
  const int c = cid / wide.n;
  const int l = wide.level[di];
  const int slices = wide.parts[di] * HB_CLUSTER;
  const int s = c * HB_CLUSTER + rank;
  uint2* lo = wsums;
  int2* hi = reinterpret_cast<int2*>(wsums + HB_PART);
  zero_bytes(wsums, HB_PART * 16);
  int row[HE_ROW];
  level_row(rows, l, srow, row);
  const int i0 = (int)((int64_t)n * s / slices);
  const int i1 = (int)((int64_t)n * (s + 1) / slices);
  // the cluster's bound: the blocks' sums of |g| added in rank order,
  // through `mine`
  unsigned m[2];
  double d[2];
  slice_bound(g, i0, i1, l, levels, m, d);
  block_max2(m, red);
  flag_nonfinite(m, flag);
  block_sumd2(d, reinterpret_cast<double*>(red + 16));
  if (threadIdx.x < 2) mine[threadIdx.x] = d[threadIdx.x];
  cluster.sync();
  d[0] = d[1] = 0.0;
  for (int r = 0; r < HB_CLUSTER; ++r) {
    const double* o = cluster.map_shared_rank(mine, r);
    d[0] += o[0];
    d[1] += o[1];
  }
  const AsInt val = int_scale(d);
  cluster.sync();  // every quarter zeroed and every `mine` read
  scatter_points(g, x, nullptr, i0, i1, l, levels, row, val,
                 ClusterIntAdd{lo, hi});
  cluster.sync();  // every add landed; no block exits while others add
  write_sums(partials + wide.offset[di] + (int64_t)c * HB_WIDE_SPAN +
                 (int64_t)rank * HB_PART,
             lo, hi, HB_PART, val);
}

// Backward 5. The last kernel. Blocks [0, reduce_blocks): the dense rows
// (reduce_rows); then [0, split_blocks): split segment k x paged level,
// the page = its chunk pages added in chunk order; then HB_FILL_BLOCKS
// blocks that return unless a block's cotangents were not finite (*flag),
// and then write NaN to every entry (as every other block then does).
__global__ void __launch_bounds__(HB_THREADS)
hb_final_kernel(const float2* __restrict__ partials, LevelSet rowsets,
                    LevelSet paged, const int* __restrict__ split,
                    const int* __restrict__ meta,
                    const int* __restrict__ counts,
                    const int* __restrict__ split_slot,
                    const float2* __restrict__ pages,
                    const int* __restrict__ flag, float2* __restrict__ dtable,
                    int64_t t, int levels, int reduce_blocks,
                    int split_blocks) {
  const bool bad = *flag != 0;
  const float2 nan2 = make_float2(__int_as_float(0x7FC00000),
                                  __int_as_float(0x7FC00000));
  int b = blockIdx.x;
  if (b < reduce_blocks) {
    reduce_rows(partials, rowsets, dtable, t, b, bad);
    return;
  }
  b -= reduce_blocks;
  if (b < split_blocks) {
    const int li = b % paged.n;
    const int k = b / paged.n;
    if (k >= meta[1]) return;
    const int s = split[k];
    const int nch = (counts[s] + HB_CHUNK - 1) / HB_CHUNK;
    const int64_t stride = (int64_t)paged.n * HE_PAGE_ENTRIES;
    const float2* src =
        pages + ((int64_t)split_slot[k] * paged.n + li) * HE_PAGE_ENTRIES;
    float2* dst = dtable + (int64_t)paged.level[li] * t +
                  (int64_t)s * HE_PAGE_ENTRIES;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < HE_PAGE_ENTRIES / 2; i += HB_THREADS) {
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < nch; ++j) {
        const float4 v = s4[j * (stride / 2) + i];
        sum.x = __fadd_rn(sum.x, v.x);
        sum.y = __fadd_rn(sum.y, v.y);
        sum.z = __fadd_rn(sum.z, v.z);
        sum.w = __fadd_rn(sum.w, v.w);
      }
      d4[i] = bad ? make_float4(nan2.x, nan2.y, nan2.x, nan2.y) : sum;
    }
    return;
  }
  b -= split_blocks;
  if (!bad) return;
  const int64_t total = (int64_t)levels * t;
  for (int64_t e = (int64_t)b * HB_THREADS + threadIdx.x; e < total;
       e += (int64_t)HB_FILL_BLOCKS * HB_THREADS)
    dtable[e] = nan2;
}

// ---------------------------------------------------------------------------
// The atomic backward (he_win_bwd, the default): the same schedule summed
// in f32 with atomics, so the last bits of an entry follow the order in
// which the adds land.
// ---------------------------------------------------------------------------

// Zero the pages of the split segments on every paged level (their chunks
// add into them); block = split segment x paged level.
__global__ void __launch_bounds__(HB_THREADS)
ha_zero_split_kernel(LevelSet paged, const int* __restrict__ split,
                     const int* __restrict__ meta, float2* __restrict__ dtable,
                     int64_t t) {
  const int li = blockIdx.x % paged.n;
  const int k = blockIdx.x / paged.n;
  if (k >= meta[1]) return;
  zero_bytes(dtable + (int64_t)paged.level[li] * t +
                 (int64_t)split[k] * HE_PAGE_ENTRIES,
             HE_PAGE_ENTRIES * 8);
}

// Paged levels: block = chunk x paged level (the levels of one chunk are
// neighbours in launch order, so a point's cotangent row is read from
// device memory once and from L2 after), the chunk's sorted points summed
// into the page in shared memory (8 KB); the page stored whole (a sole
// chunk) or its nonzero entries added to the table (a split segment's).
// One block a (chunk, level) keeps ~46 short blocks an SM in flight; one
// block a chunk looping over the levels measured slower.
__global__ void __launch_bounds__(HB_THREADS)
ha_page_kernel(const float2* __restrict__ g, const float* __restrict__ x,
               LevelRows rows, LevelSet paged, const int* __restrict__ order,
               const int4* __restrict__ chunks, const int* __restrict__ meta,
               float2* __restrict__ dtable, int levels, int64_t t) {
  __shared__ __align__(16) float2 acc[HE_PAGE_ENTRIES];
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
  const SmemAdd add{acc};
  for (int i0 = ch.y; i0 < ch.y + ch.z; i0 += HB_THREADS) {
    const int i = i0 + (int)threadIdx.x;
    const bool on = i < ch.y + ch.z;
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
      warp_add(active, idx[c] - seg_base, __fmul_rn(w[c], gv.x),
               __fmul_rn(w[c], gv.y), add);
  }
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

// Dense levels of span <= HB_DENSE_SPAN: block = slice b of the sorted
// points x level; the block's f32 sums over the whole span go to its row of
// the level's partials.
__global__ void __launch_bounds__(HB_THREADS)
ha_dense_kernel(const float2* __restrict__ g, const float* __restrict__ x,
                LevelRows rows, LevelSet dense, const int* __restrict__ order,
                float2* __restrict__ partials, int n, int levels) {
  extern __shared__ __align__(16) float2 dacc[];
  __shared__ int srow[HE_ROW];
  const int di = blockIdx.x % dense.n;
  const int b = blockIdx.x / dense.n;
  const int l = dense.level[di], span = dense.span[di];
  const int parts = dense.parts[di];
  zero_bytes(dacc, span * 8);
  int row[HE_ROW];
  level_row(rows, l, srow, row);
  const int i0 = (int)((int64_t)n * b / parts);
  const int i1 = (int)((int64_t)n * (b + 1) / parts);
  scatter_points(g, x, order, i0, i1, l, levels, row, AsF32{},
                 SmemAdd{dacc});
  __syncthreads();
  copy_bytes(partials + dense.offset[di] + (int64_t)b * span, dacc, span * 8);
}

// Dense levels of span HB_WIDE_SPAN: cluster c of the level sums slice c of
// the sorted points (its blocks a quarter of it each) into the span, which its
// HB_CLUSTER blocks hold a quarter each (64 KB); each block then writes its
// quarter to the cluster's row of the partials.
__global__ void __cluster_dims__(HB_CLUSTER, 1, 1) __launch_bounds__(HB_THREADS)
ha_wide_kernel(const float2* __restrict__ g, const float* __restrict__ x,
               LevelRows rows, LevelSet wide, const int* __restrict__ order,
               float2* __restrict__ partials, int n, int levels) {
  extern __shared__ __align__(16) float2 wacc[];
  __shared__ int srow[HE_ROW];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / HB_CLUSTER;
  const int di = cid % wide.n;
  const int c = cid / wide.n;
  const int l = wide.level[di];
  const int slices = wide.parts[di] * HB_CLUSTER;
  const int s = c * HB_CLUSTER + rank;
  zero_bytes(wacc, HB_PART * 8);
  int row[HE_ROW];
  level_row(rows, l, srow, row);
  cluster.sync();  // every quarter zeroed before any block adds to it
  const int i0 = (int)((int64_t)n * s / slices);
  const int i1 = (int)((int64_t)n * (s + 1) / slices);
  scatter_points(g, x, order, i0, i1, l, levels, row, AsF32{},
                 ClusterAdd{wacc});
  cluster.sync();  // every add landed; no block exits while others add
  copy_bytes(partials + wide.offset[di] + (int64_t)c * HB_WIDE_SPAN +
                 (int64_t)rank * HB_PART,
             wacc, HB_PART * 8);
}

// Dense rows: the level's partials added in order (reduce_rows).
__global__ void __launch_bounds__(HB_THREADS)
ha_reduce_kernel(const float2* __restrict__ partials, LevelSet rowsets,
                 float2* __restrict__ dtable, int64_t t) {
  reduce_rows(partials, rowsets, dtable, t, blockIdx.x, false);
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

// The backward's level sets from spans_host (per level 0 (paged) or the
// dense box's morton span, a power of 8 <= HB_DENSE_SPAN or exactly
// HB_WIDE_SPAN), the partials' offsets (dense_parts per level of span <=
// HB_DENSE_SPAN, wide_parts clusters per level of span HB_WIDE_SPAN;
// partial_entries float2 needed) and the largest dense span.
static int level_sets(const LevelRows& rows, const int* spans_host,
                      int levels, long long t, int dense_parts,
                      int wide_parts, LevelSet* paged, LevelSet* dense,
                      LevelSet* wide, LevelSet* rowsets, int64_t* part_off,
                      int* dense_max) {
  memset(paged, 0, sizeof(*paged));
  memset(dense, 0, sizeof(*dense));
  memset(wide, 0, sizeof(*wide));
  *part_off = 0;
  *dense_max = 8;
  for (int l = 0; l < levels; ++l) {
    const int span = spans_host[l];
    const bool flag = rows.v[l * HE_ROW + 1] != 0;
    if (span == 0 && !flag) {
      paged->level[paged->n++] = l;
      continue;
    }
    const bool pow8 = span >= 8 && !(span & (span - 1)) &&
                      (__builtin_ctz((unsigned)span) % 3) == 0;
    if (!flag || !pow8 || span > t) return (int)cudaErrorInvalidValue;
    LevelSet* set;
    int parts;
    if (span <= HB_DENSE_SPAN) {
      set = dense;
      parts = dense_parts;
      if (span > *dense_max) *dense_max = span;
    } else if (span == HB_WIDE_SPAN) {
      set = wide;
      parts = wide_parts;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    set->level[set->n] = l;
    set->span[set->n] = span;
    set->parts[set->n] = parts;
    set->offset[set->n] = *part_off;
    set->n++;
    *part_off += (int64_t)parts * span;
  }
  memcpy(rowsets, dense, sizeof(*rowsets));
  for (int i = 0; i < wide->n; ++i) {
    rowsets->level[rowsets->n] = wide->level[i];
    rowsets->span[rowsets->n] = wide->span[i];
    rowsets->parts[rowsets->n] = wide->parts[i];
    rowsets->offset[rowsets->n] = wide->offset[i];
    rowsets->n++;
  }
  return 0;
}

static int64_t pad16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// The backward's scratch `fix` (ops/hash_encode_win.py::bwd_plan sizes it
// the same): the flag and the slot count (16 bytes), split_slot
// (max_split ints), the sorted ids (n ints), each padded to 16 bytes, and
// the chunk pages of the split segments (at most n / HB_CHUNK + max_split
// chunks x paged levels x 1024 float2).
static int64_t fix_need(int n, int n_seg, int paged_levels) {
  const int64_t ns = max_split(n, n_seg);
  if (!ns) return 16;
  return 16 + pad16(4 * ns) + pad16(4 * (int64_t)n) +
         (((int64_t)n + HB_CHUNK - 1) / HB_CHUNK + ns) * paged_levels *
             HE_PAGE_ENTRIES * 8;
}

// The atomic backward, from the forward's sort in `work`. spans_host,
// dense_parts, wide_parts: as level_sets takes them; partials:
// partial_entries float2.
extern "C" int he_win_bwd(const void* g, const void* x, const int* rows_host,
                          void* dtable, int n, int levels, long long t,
                          const int* spans_host, void* work,
                          long long work_ints, void* partials,
                          long long partial_entries, int dense_parts,
                          int wide_parts, void* stream) {
  LevelRows rows;
  int err = launch_args(rows_host, n, levels, &rows);
  if (err) return err;
  if (!table_ok(t) || dense_parts < 1 || wide_parts < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0)
    return (int)cudaMemsetAsync(dtable, 0, (size_t)levels * t * 8, s);
  LevelSet paged, dense, wide, rowsets;
  int64_t part_off;
  int dense_max;
  err = level_sets(rows, spans_host, levels, t, dense_parts, wide_parts,
                   &paged, &dense, &wide, &rowsets, &part_off, &dense_max);
  if (err) return err;
  const int n_seg = (int)(t / HE_PAGE_ENTRIES);
  Work w;
  err = work_layout(work, work_ints, n, n_seg, &w);
  if (err) return err;
  if (partial_entries < part_off) return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = max_chunks(n, n_seg), n_split = max_split(n, n_seg);
  float2* part = (float2*)partials;
  if (paged.n) {
    if (n_split) {
      ha_zero_split_kernel<<<(unsigned)(n_split * paged.n), HB_THREADS, 0,
                             s>>>(paged, w.split, w.meta, (float2*)dtable,
                                  (int64_t)t);
      HB_CHECK();
    }
    ha_page_kernel<<<(unsigned)(n_chunks * paged.n), HB_THREADS, 0, s>>>(
        (const float2*)g, (const float*)x, rows, paged, w.order, w.chunks,
        w.meta, (float2*)dtable, levels, (int64_t)t);
    HB_CHECK();
  }
  if (dense.n) {
    const size_t smem = (size_t)dense_max * 8;
    if (smem > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(
          ha_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err) return err;
    }
    ha_dense_kernel<<<(unsigned)(dense_parts * dense.n), HB_THREADS, smem,
                      s>>>((const float2*)g, (const float*)x, rows, dense,
                           w.order, part, n, levels);
    HB_CHECK();
  }
  if (wide.n) {
    const size_t smem = (size_t)HB_PART * 8;
    err = (int)cudaFuncSetAttribute(
        ha_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    ha_wide_kernel<<<(unsigned)(wide_parts * HB_CLUSTER * wide.n),
                     HB_THREADS, smem, s>>>((const float2*)g, (const float*)x,
                                            rows, wide, w.order, part, n,
                                            levels);
    HB_CHECK();
  }
  if (rowsets.n) {
    const int64_t tiles = (t + HB_REDUCE_TILE - 1) / HB_REDUCE_TILE;
    ha_reduce_kernel<<<(unsigned)(tiles * rowsets.n), HB_THREADS, 0, s>>>(
        part, rowsets, (float2*)dtable, (int64_t)t);
    HB_CHECK();
  }
  return 0;
}

// The fixed-order variant (see the note at the top): the same arguments and
// its scratch `fix`, fix_bytes long.
extern "C" int he_win_bwd_fix(const void* g, const void* x,
                              const int* rows_host, void* dtable, int n,
                              int levels, long long t, const int* spans_host,
                              void* work, long long work_ints, void* partials,
                              long long partial_entries, int dense_parts,
                              int wide_parts, void* fix, long long fix_bytes,
                              void* stream) {
  LevelRows rows;
  int err = launch_args(rows_host, n, levels, &rows);
  if (err) return err;
  if (!table_ok(t) || dense_parts < 1 || wide_parts < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0)
    return (int)cudaMemsetAsync(dtable, 0, (size_t)levels * t * 8, s);
  LevelSet paged, dense, wide, rowsets;
  int64_t part_off;
  int dense_max;
  err = level_sets(rows, spans_host, levels, t, dense_parts, wide_parts,
                   &paged, &dense, &wide, &rowsets, &part_off, &dense_max);
  if (err) return err;
  const int n_seg = (int)(t / HE_PAGE_ENTRIES);
  Work w;
  err = work_layout(work, work_ints, n, n_seg, &w);
  if (err) return err;
  if (partial_entries < part_off || !fix ||
      fix_bytes < fix_need(n, n_seg, paged.n))
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = max_chunks(n, n_seg), n_split = max_split(n, n_seg);
  int* flag = (int*)fix;
  int* slots = flag + 1;
  int* split_slot = (int*)((char*)fix + 16);
  int* sorted = (int*)((char*)split_slot + pad16(4 * n_split));
  float2* pages = (float2*)((char*)sorted + pad16(4 * (int64_t)n));
  float2* part = (float2*)partials;
  err = (int)cudaMemsetAsync(fix, 0, 16, s);
  if (err) return err;
  if (paged.n) {
    if (n_split) {
      const size_t smem =
          (size_t)(((n < HB_SORT_WINDOW ? n : HB_SORT_WINDOW) + 31) / 32) * 4;
      err = (int)cudaFuncSetAttribute(
          hb_split_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err) return err;
      hb_split_sort_kernel<<<(unsigned)n_split, HB_SORT_THREADS, smem, s>>>(
          w.order, w.cursor, w.counts, w.split, w.meta, sorted, split_slot,
          slots, n);
      HB_CHECK();
    }
    hb_page_kernel<<<(unsigned)(n_chunks * paged.n), HB_THREADS, 0, s>>>(
        (const float2*)g, (const float*)x, rows, paged, w.order, w.chunks,
        w.meta, w.cursor, w.counts, split_slot, (float2*)dtable, pages, flag,
        levels, (int64_t)t);
    HB_CHECK();
  }
  if (dense.n) {
    const size_t smem = (size_t)dense_max * 16;
    if (smem > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(
          hb_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err) return err;
    }
    hb_dense_kernel<<<(unsigned)(dense_parts * dense.n), HB_THREADS,
                          smem, s>>>((const float2*)g, (const float*)x, rows,
                                     dense, part, flag, n, levels);
    HB_CHECK();
  }
  if (wide.n) {
    const size_t smem = (size_t)HB_PART * 16;
    err = (int)cudaFuncSetAttribute(
        hb_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    hb_wide_kernel<<<(unsigned)(wide_parts * HB_CLUSTER * wide.n),
                         HB_THREADS, smem, s>>>((const float2*)g,
                                                (const float*)x, rows, wide,
                                                part, flag, n, levels);
    HB_CHECK();
  }
  const int64_t tiles = (t + HB_REDUCE_TILE - 1) / HB_REDUCE_TILE;
  const int64_t reduce_blocks = rowsets.n ? tiles * rowsets.n : 0;
  const int64_t split_blocks = paged.n ? n_split * paged.n : 0;
  const int64_t blocks = reduce_blocks + split_blocks + HB_FILL_BLOCKS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  hb_final_kernel<<<(unsigned)blocks, HB_THREADS, 0, s>>>(
      part, rowsets, paged, w.split, w.meta, w.counts, split_slot, pages,
      flag, (float2*)dtable, (int64_t)t, levels, (int)reduce_blocks,
      (int)split_blocks);
  HB_CHECK();
  return 0;
}

extern "C" const char* he_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
