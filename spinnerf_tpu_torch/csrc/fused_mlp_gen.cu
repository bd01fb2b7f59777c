// The fused NeRF MLP at every compute type and geometry JAX's kernels take,
// on the CUDA cores of Hopper (sm_90a): forward and backward of the v2 pair
// (encoding in the kernel) and of the v1 pair (encodings given, input
// gradients returned).
//
// Replaces, beside csrc/fused_mlp_pe.cu (which stays the route at the one
// configuration its wgmma tiles take: bf16, depth 8, skip 4, width 256,
// view width 128, 128 / 128 encoding lanes, 10 / 4 octaves), the Pallas
// kernels of spinnerf_tpu/ops/fused_mlp.py:
//   v2 forward  _fwd_pe_kernel (:411; pallas_call :574)  fg_fwd
//   v2 backward _bwd_pe_kernel (:424; pallas_call :616)  fg_bwd
//   v1 forward  _fwd_kernel    (:106; pallas_call :248)  fg_fwd_pre
//   v1 backward _bwd_kernel    (:115; pallas_call :294)  fg_bwd_pre
// at any of their configurations within these limits (ops/fused_mlp.py
// checks them first and raises ValueError naming the one broken):
// compute type bf16 or f32; depth 1-32 with depth != skip + 1 (JAX's
// FusedMLPField refuses depth 5 at skip 4); width 8-2,048; view width 1 to
// the width; encoding widths (in_dim, dir_dim) 128 or 256, so v2 takes 0-42
// octaves; with and without the semantic head.
//
// It computes what the plain versions in ops/fused_mlp.py compute
// (fused_mlp_pe_plain, fused_mlp_pe_bwd_plain, fused_mlp_fwd_plain,
// fused_mlp_bwd_plain), roundings included. Every operand of a product is
// rounded to the compute type (bf16: __float2bfloat16_rn and back; the
// wrapper rounds the weights once a call, gen_pack, and the kernels round
// the activations and gradients where the plain version does); products and
// sums are f32 (a product of two bf16 values is exact in f32, so one FMA
// path serves both types); f32 bias, ReLU, then the cast. The skip concat
// [x, h] feeds layer skip + 1 (a depth <= skip has none); the sigma (and
// semantic) head reads the last trunk output; then the feature layer, the
// view layer on [feat, d] and the rgb head. v2 encodes with the full-range
// sinf and pi/2 added in f32, as fm_fwd_kernel does: never build with
// --use_fast_math. The bias gradients are sums over the bf16-rounded
// gradients in v2 and over the f32 ones in v1 (JAX's difference, which the
// plain backward versions keep).
//
// What bounds it on an H100: arithmetic. At 8 x 256 the function needs 1.19
// MFLOP a point forward and 3.49 backward (csrc/fused_mlp_pe.cu's note)
// against 32 bytes of input; on the CUDA cores (132 SMs x 128 FMA lanes x 2
// a clock, 67 TFLOP/s at 1.98 GHz) that bounds 262,144 points at about 4.7
// ms forward and 13.7 ms backward. The forward and the backward of the
// geometries their tensor-core plans refuse (gen_fwd_plan, gen_bwd_plan)
// run on the CUDA cores (fg_fwd_kernel, fg_bwd_kernel): the simple design
// that is right first. Every other geometry runs on the tensor cores (the
// ft_ kernels, below), with f32 as six exact bf16 products.
//
// The block product (block_product). A block of 256 threads owns BM points
// (64, 32, 16 or 8: the largest whose buffers fit, fg_bm) and keeps their
// activations in shared memory, feature-major ([feature][BM] f32, so that a
// thread's 4 points are one 16-byte load). A product [BM x N] walks N in
// passes of 4,096 / BM columns; each thread owns 4 points x 4 columns, the
// lanes of a warp neighbouring points (their activation loads are
// consecutive, their weight loads broadcasts). Weights are staged in tiles
// of 16 rows x the pass's columns by cp.async, two tiles in flight, so each
// block reads each weight once a pass from L2. A layer whose input is a
// concat ([x, h], [feat, d]) is a product over two segments; v2 multiplies
// only the encodings' unpadded lanes (the padding lanes are zero), v1 all
// of them, as JAX's v1 kernel does. The heads (1-3 columns) are plain dot
// products, a thread a (point, head).
//
// Shared memory (bytes): 4 BM (in_dim + dir_dim + 2 width + 8) for the
// encodings, two activation buffers and the cotangent, plus 2 x 16 x 4,096 /
// BM x 4 for the weight tiles: 206,848 at BM 64, width 256 (above 48 KB,
// so cudaFuncSetAttribute), 180,736 at BM 16, width 1,024, and 213,248 at
// BM 8, width 2,048 with 256-lane encodings: the largest width.
//
// The backward on the CUDA cores (the geometries gen_bwd_plan refuses),
// two kernels and a sum, as in the wgmma design. The weight gradient dW =
// A^T G sums over every point, which a block cannot finish:
// - fg_bwd_kernel recomputes the block's forward, writes each layer's input
//   activations A (the ReLU mask kept as the sign of a zero: a unit whose
//   pre-activation is positive but rounds to 0 stores -0) and the
//   cotangent to scratch, then back-propagates, writing each layer's
//   output gradient G; in v1 also dx (the layer-0 and skip-layer products'
//   encoding columns, added by the thread that wrote the first) and dd.
// - fg_dw_kernel reduces A^T r(G) and the bias sums of G. A block owns a
//   64 x 64 tile of one layer's dW and a split of the points; a thread 4 x
//   4 entries, summed in f32 over a stage of 32 points and then added to an
//   f64 sum. The bias sums (of the tiles of row 0) add each point in f64:
//   a sum of a zero-mean gradient cancels, and f32 stages of 32 points
//   lost 1.09e-7 of the semantic head's bias sum against the plain f32
//   version's 6.1e-9 (relative to float64's, at 131,072 points on the
//   H100). Each split writes its f64 partial sums to scratch.
// - fg_split_sum_kernel adds the splits in split order (and a chunk's sum
//   to the sum of the chunks before it, in chunk order), then writes the f32
//   gradients in the weights' layout. No atomics: two launches on the same
//   inputs are bit-equal (the contract ROADMAP.md B1e gave #8 and #10).
// The scratch is P x cols f32, cols = in_dim + dir_dim + 2 (depth + 1)
// width + 2 view_width + 4 + out_extra: 5,124 columns at 8 x 256, 5.37 GB
// at P = 262,144; 19,716 at width 1,024 (view 512), 20.7 GB. So the points
// run in chunks of at most 4 GiB (FG_SCRATCH_BYTES), each chunk a
// backward kernel, a dW kernel and a sum: 2 chunks of 131,072 points
// (2.69 GB) at 8 x 256, 5 of 52,480 (4.14 GB) at width 1,024. The split
// partial sums take splits x (weights) f64, 36 MB at 8 x 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FG_THREADS 256
#define FG_TM 4                    // points a thread in a product
#define FG_TN 4                    // columns a thread in a product
#define FG_KT 16                   // rows of a staged weight tile
#define FG_TILE 4096               // points x columns of one pass
#define FG_MAX_DEPTH 32
#define FG_MAX_JOBS (FG_MAX_DEPTH + 5)
#define FG_SMEM_MAX 232448         // a block's shared memory on the H100
#define FG_GROWS 8                 // cotangent rows in shared memory
#define FG_DT 64                   // fg_dw_kernel's output tile side
#define FG_PT 32                   // points a stage of fg_dw_kernel
#define FG_PS (FG_PT + 4)          // the stride of its staged rows
#define FG_SCRATCH_BYTES (4LL << 30)
#define FG_DW_BLOCKS 1056          // fg_dw_kernel's target grid: 8 an SM

// Bound from ops/fused_mlp.py (_FgParams), field for field. The matrices
// are f32, already rounded to the compute type (gen_pack): tw / feat_w /
// view_w / rgb_w in the JAX layout [in, out] for the forward, twt / featt /
// viewt / rgbt their transposes [out, in] for the backward (sigma_w and
// sem_w serve as their own). Biases are the f32 weights as they are.
// gw / gb: each gradient's element offset in the flat f32 gradient buffer
// (the weights' order), by job: trunk 0..depth-1, feat, view, rgb, sigma,
// sem.
struct FgParams {
  const float* tw[FG_MAX_DEPTH];
  const float* tb[FG_MAX_DEPTH];
  const float* twt[FG_MAX_DEPTH];
  const float* feat_w;
  const float* feat_b;
  const float* featt;
  const float* view_w;
  const float* view_b;
  const float* viewt;
  const float* rgb_w;
  const float* rgb_b;
  const float* rgbt;
  const float* sigma_w;
  const float* sigma_b;
  const float* sem_w;
  const float* sem_b;
  long long gw[FG_MAX_JOBS];
  long long gb[FG_MAX_JOBS];
  long long n_params;
  int depth;
  int skip;
  int width;
  int view_width;
  int in_dim;
  int dir_dim;
  int out_extra;
  int multires;
  int multires_views;
  int bf16;
};

// Scratch columns (features), each P f32 long. A layer's input is
// contiguous: the skip layer's [x, h_skip] and the view layer's [feat, d].
struct FgLayout {
  int cols;
  int xe, feat, de, v, gfeat, gv, gin;
  int h[FG_MAX_DEPTH];
  int gz[FG_MAX_DEPTH];
};

// One weight gradient of fg_dw_kernel: A (k scratch columns from a_off), G
// (n columns from g_off), its tiles from tile0 (ntn across n), and where
// its weight and bias sums go in a split's record.
struct FgJob {
  int a_off, k, g_off, n, tile0, ntn;
  long long w_off, b_off;
};

struct FgPlan {
  int n_jobs, tiles;
  FgJob job[FG_MAX_JOBS];
};

static void fg_layout(const FgParams& p, FgLayout* L) {
  const bool sk = p.skip + 1 < p.depth;
  int c = 0;
  for (int i = 0; i < p.depth; ++i) {
    if (sk && i == p.skip) { L->xe = c; c += p.in_dim; }
    L->h[i] = c;
    c += p.width;
  }
  if (!sk) { L->xe = c; c += p.in_dim; }
  L->feat = c; c += p.width;
  L->de = c; c += p.dir_dim;
  L->v = c; c += p.view_width;
  for (int i = 0; i < p.depth; ++i) { L->gz[i] = c; c += p.width; }
  L->gfeat = c; c += p.width;
  L->gv = c; c += p.view_width;
  L->gin = c; c += 4 + p.out_extra;
  L->cols = c;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bfr(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float rnd(float x, int bf) {
  return bf ? bfr(x) : x;
}

__device__ __forceinline__ float4 rnd4(float4 a, int bf) {
  return bf ? make_float4(bfr(a.x), bfr(a.y), bfr(a.z), bfr(a.w)) : a;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// relu(z) in the compute type; with `mark`, a positive z that rounds to 0
// keeps its mask as -0 (the backward reads the mask back from the sign)
__device__ __forceinline__ float act(float z, int bf, bool mark) {
  const float h = rnd(z > 0.0f ? z : 0.0f, bf);
  return (mark && z > 0.0f && h == 0.0f) ? -0.0f : h;
}

// the gradient through a ReLU whose output h the recompute stored: the
// plain version's g * (z > 0), rounded in v2
__device__ __forceinline__ float relu_grad(float g, float h, bool pre,
                                           int bf) {
  const float r = g * (__float_as_uint(h) != 0u ? 1.0f : 0.0f);
  return pre ? r : rnd(r, bf);
}

__device__ __forceinline__ float4 relu_grad4(float4 g, float4 h, bool pre,
                                             int bf) {
  return make_float4(relu_grad(g.x, h.x, pre, bf), relu_grad(g.y, h.y, pre, bf),
                     relu_grad(g.z, h.z, pre, bf), relu_grad(g.w, h.w, pre, bf));
}

// One lane j of the positional encoding of xyz (3 floats in device memory)
// with nf octaves: [x, sin(x 2^0), cos(x 2^0), sin(x 2^1), ...], zero past
// 3 (1 + 2 nf); cos is sin(x 2^f + pi/2) with the f32 add.
__device__ __forceinline__ float pe_lane(const float* xyz, int j, int nf) {
  if (j < 3) return __ldg(xyz + j);
  if (j >= 3 * (1 + 2 * nf)) return 0.0f;
  const int k = j - 3, f = k / 6, r = k % 6;
  const float scale = __int_as_float((127 + f) << 23);   // 2^f, exact
  const float xb = __fmul_rn(__ldg(xyz + r % 3), scale);
  return sinf(r >= 3 ? __fadd_rn(xb, 1.57079637f) : xb);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = ok ? 4 : 0;       // 0: fill with zeros, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the block product: out[BM x n_out] = sum over segments of A_s B_s, A_s in
// shared memory ([k][BM]), B_s in device memory ([k][ldb], row-major)
// ---------------------------------------------------------------------------

struct Seg {
  const float* a;
  int k;
  const float* b;
  int ldb;
};

__device__ __forceinline__ void tile_of(const Seg* seg, int nseg, int t,
                                        int* s, int* k0) {
  int i = 0;
  while (i + 1 < nseg) {
    const int n_i = (seg[i].k + FG_KT - 1) / FG_KT;
    if (t < n_i) break;
    t -= n_i;
    ++i;
  }
  *s = i;
  *k0 = t * FG_KT;
}

// Stage weight tile t of the pass from column n0: FG_KT rows x nt columns,
// zero past the segment's rows and n_out.
__device__ __forceinline__ void stage_tile(const Seg* seg, int nseg, int t,
                                           int n0, int n_out, int nt,
                                           float* dst) {
  int s, k0;
  tile_of(seg, nseg, t, &s, &k0);
  const Seg g = seg[s];
  for (int idx = threadIdx.x; idx < FG_KT * nt; idx += FG_THREADS) {
    const int kk = idx / nt, nn = idx - kk * nt;
    const int k = k0 + kk, n = n0 + nn;
    const bool ok = k < g.k && n < n_out;
    cp_async4(dst + idx, ok ? g.b + (long long)k * g.ldb + n : g.b, ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ void fma_step(float (&acc)[FG_TM][FG_TN],
                                         const float* a, const float* b) {
  const float4 av = ld4(a), bv = ld4(b);
  const float ar[FG_TM] = {av.x, av.y, av.z, av.w};
  const float br[FG_TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < FG_TM; ++i)
#pragma unroll
    for (int j = 0; j < FG_TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
}

// epi(pt0, n, v): the sums of column n at the thread's points pt0..pt0+3.
// Every thread of the block calls this; it ends with a barrier.
template <class Epi>
__device__ __forceinline__ void block_product(const Seg* seg, int nseg,
                                              int n_out, int bm, float* wt,
                                              Epi epi) {
  const int pgs = bm / FG_TM;
  const int nt = FG_TILE / bm;
  const int pg = threadIdx.x % pgs, cg = threadIdx.x / pgs;
  int n_tiles = 0;
  for (int s = 0; s < nseg; ++s) n_tiles += (seg[s].k + FG_KT - 1) / FG_KT;
  for (int n0 = 0; n0 < n_out; n0 += nt) {
    float acc[FG_TM][FG_TN];
#pragma unroll
    for (int i = 0; i < FG_TM; ++i)
#pragma unroll
      for (int j = 0; j < FG_TN; ++j) acc[i][j] = 0.0f;
    stage_tile(seg, nseg, 0, n0, n_out, nt, wt);
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) {
        stage_tile(seg, nseg, t + 1, n0, n_out, nt,
                   wt + ((t + 1) & 1) * FG_KT * nt);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      int s, k0;
      tile_of(seg, nseg, t, &s, &k0);
      const float* a = seg[s].a + (long long)k0 * bm + pg * FG_TM;
      const float* b = wt + (t & 1) * FG_KT * nt + cg * FG_TN;
      const int kn = min(FG_KT, seg[s].k - k0);
      if (kn == FG_KT) {
#pragma unroll
        for (int kk = 0; kk < FG_KT; ++kk)
          fma_step(acc, a + kk * bm, b + kk * nt);
      } else {
        for (int kk = 0; kk < kn; ++kk) fma_step(acc, a + kk * bm, b + kk * nt);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < FG_TN; ++j) {
      const int n = n0 + cg * FG_TN + j;
      if (n < n_out)
        epi(pg * FG_TM, n,
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the forward of a block's points
// ---------------------------------------------------------------------------

struct FgSmem {
  float *x, *d, *h0, *h1, *gb, *wt;
};

__device__ __forceinline__ FgSmem carve(float* base, const FgParams& p,
                                        int bm) {
  FgSmem s;
  s.x = base;
  s.d = s.x + p.in_dim * bm;
  s.h0 = s.d + p.dir_dim * bm;
  s.h1 = s.h0 + p.width * bm;
  s.gb = s.h1 + p.width * bm;
  s.wt = s.gb + FG_GROWS * bm;
  return s;
}

// The block's points gp0 .. gp0 + bm - 1: encodings (v2) or their rounded
// copies (PRE), trunk, feature and view layers. Without SAVE (the forward
// kernel) the heads too, into out [P][4 + e]; with SAVE (the backward's
// recompute) every layer's input to the scratch columns of L (points lp0..
// of a chunk of pc), the masks kept (act).
template <bool PRE, bool SAVE>
__device__ __forceinline__ void forward_block(
    const FgParams& p, const FgLayout& L, int bm, const FgSmem& s,
    const float* in_x, const float* in_d, long long gp0, float* out,
    float* scr, int pc, int lp0) {
  const int W = p.width, VW = p.view_width, bf = p.bf16;
  const int kx = PRE ? p.in_dim : 3 * (1 + 2 * p.multires);
  const int kd = PRE ? p.dir_dim : 3 * (1 + 2 * p.multires_views);
  for (int idx = threadIdx.x; idx < p.in_dim * bm; idx += FG_THREADS) {
    const int j = idx / bm, pt = idx - j * bm;
    const long long q = gp0 + pt;
    const float v = rnd(PRE ? __ldg(in_x + q * p.in_dim + j)
                            : pe_lane(in_x + q * 8, j, p.multires),
                        bf);
    s.x[idx] = v;
    if (SAVE) scr[(long long)(L.xe + j) * pc + lp0 + pt] = v;
  }
  for (int idx = threadIdx.x; idx < p.dir_dim * bm; idx += FG_THREADS) {
    const int j = idx / bm, pt = idx - j * bm;
    const long long q = gp0 + pt;
    const float v = rnd(PRE ? __ldg(in_d + q * p.dir_dim + j)
                            : pe_lane(in_x + q * 8 + 3, j, p.multires_views),
                        bf);
    s.d[idx] = v;
    if (SAVE) scr[(long long)(L.de + j) * pc + lp0 + pt] = v;
  }
  __syncthreads();

  const bool sk = p.skip + 1 < p.depth;
  float* cur = s.h1;
  for (int i = 0; i < p.depth; ++i) {
    float* nxt = (i & 1) ? s.h1 : s.h0;
    Seg seg[2];
    int ns = 1;
    if (i == 0) {
      seg[0] = Seg{s.x, kx, p.tw[0], W};
    } else if (sk && i == p.skip + 1) {
      seg[0] = Seg{s.x, kx, p.tw[i], W};
      seg[1] = Seg{cur, W, p.tw[i] + (long long)p.in_dim * W, W};
      ns = 2;
    } else {
      seg[0] = Seg{cur, W, p.tw[i], W};
    }
    const float* bias = p.tb[i];
    float* col = SAVE ? scr + (long long)L.h[i] * pc + lp0 : nullptr;
    block_product(seg, ns, W, bm, s.wt, [&](int pt0, int n, float4 z) {
      const float b = __ldg(bias + n);
      const float4 h = make_float4(act(z.x + b, bf, SAVE), act(z.y + b, bf, SAVE),
                                   act(z.z + b, bf, SAVE), act(z.w + b, bf, SAVE));
      st4(nxt + n * bm + pt0, h);
      if (SAVE) st4(col + (long long)n * pc + pt0, h);
    });
    cur = nxt;
  }
  float* hl = cur;                                  // the last trunk output
  float* fb = (p.depth & 1) ? s.h1 : s.h0;          // the other buffer
  const int no = 4 + p.out_extra;

  if (!SAVE) {   // sigma (and the semantic logit) off the last trunk output
    for (int idx = threadIdx.x; idx < bm * (1 + p.out_extra);
         idx += FG_THREADS) {
      const int c = idx / bm, pt = idx - c * bm;
      const float* w = c == 0 ? p.sigma_w : p.sem_w;
      float a = 0.0f;
      for (int k = 0; k < W; ++k) a = fmaf(hl[k * bm + pt], __ldg(w + k), a);
      out[(gp0 + pt) * no + 3 + c] = a + __ldg(c == 0 ? p.sigma_b : p.sem_b);
    }
  }
  {   // the feature layer
    Seg seg[1] = {Seg{hl, W, p.feat_w, W}};
    float* col = SAVE ? scr + (long long)L.feat * pc + lp0 : nullptr;
    block_product(seg, 1, W, bm, s.wt, [&](int pt0, int n, float4 z) {
      const float b = __ldg(p.feat_b + n);
      const float4 f = make_float4(rnd(z.x + b, bf), rnd(z.y + b, bf),
                                   rnd(z.z + b, bf), rnd(z.w + b, bf));
      st4(fb + n * bm + pt0, f);
      if (SAVE) st4(col + (long long)n * pc + pt0, f);
    });
  }
  {   // the view layer on [feat, d], into the last trunk output's buffer
    Seg seg[2] = {Seg{fb, W, p.view_w, VW},
                  Seg{s.d, kd, p.view_w + (long long)W * VW, VW}};
    float* col = SAVE ? scr + (long long)L.v * pc + lp0 : nullptr;
    block_product(seg, 2, VW, bm, s.wt, [&](int pt0, int n, float4 z) {
      const float b = __ldg(p.view_b + n);
      const float4 v = make_float4(act(z.x + b, bf, SAVE), act(z.y + b, bf, SAVE),
                                   act(z.z + b, bf, SAVE), act(z.w + b, bf, SAVE));
      st4(hl + n * bm + pt0, v);
      if (SAVE) st4(col + (long long)n * pc + pt0, v);
    });
  }
  if (!SAVE) {   // rgb off the view layer
    for (int idx = threadIdx.x; idx < bm * 3; idx += FG_THREADS) {
      const int c = idx / bm, pt = idx - c * bm;
      float a = 0.0f;
      for (int k = 0; k < VW; ++k)
        a = fmaf(hl[k * bm + pt], __ldg(p.rgb_w + k * 3 + c), a);
      out[(gp0 + pt) * no + c] = a + __ldg(p.rgb_b + c);
    }
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

template <bool PRE>
__global__ void __launch_bounds__(FG_THREADS)
    fg_fwd_kernel(FgParams p, FgLayout L, int bm, const float* in_x,
                  const float* in_d, float* out) {
  extern __shared__ __align__(16) float fg_smem[];
  const FgSmem s = carve(fg_smem, p, bm);
  forward_block<PRE, false>(p, L, bm, s, in_x, in_d,
                            (long long)blockIdx.x * bm, out, nullptr, 0, 0);
}

// One chunk of pc points from cp0: the recompute, then back-propagation
// from the cotangent g [P][4 + e]; writes A, G and the cotangent to the
// chunk's scratch (column c of point pt at scr[c * pc + pt]) and, with PRE,
// dx [P][in_dim] and dd [P][dir_dim].
template <bool PRE>
__global__ void __launch_bounds__(FG_THREADS)
    fg_bwd_kernel(FgParams p, FgLayout L, int bm, const float* in_x,
                  const float* in_d, const float* g, float* dx, float* dd,
                  float* scr, int pc, long long cp0) {
  extern __shared__ __align__(16) float fg_smem[];
  const FgSmem s = carve(fg_smem, p, bm);
  const int lp0 = blockIdx.x * bm;
  const long long gp0 = cp0 + lp0;
  forward_block<PRE, true>(p, L, bm, s, in_x, in_d, gp0, nullptr, scr, pc,
                           lp0);
  const int W = p.width, VW = p.view_width, bf = p.bf16;
  const int no = 4 + p.out_extra;
  // the scratch column c of the block's points
  auto col = [&](int c) { return scr + (long long)c * pc + lp0; };
  // the cotangent: as it is to scratch (the heads' weight and bias sums),
  // rounded to shared memory (the operand of the heads' products)
  for (int idx = threadIdx.x; idx < no * bm; idx += FG_THREADS) {
    const int c = idx / bm, pt = idx - c * bm;
    const float v = __ldg(g + (gp0 + pt) * no + c);
    col(L.gin + c)[pt] = v;
    s.gb[idx] = rnd(v, bf);
  }
  __syncthreads();

  {   // G_v = (r(g_rgb) r(rgb_w)^T) * [vz > 0]
    Seg seg[1] = {Seg{s.gb, 3, p.rgbt, VW}};
    block_product(seg, 1, VW, bm, s.wt, [&](int pt0, int n, float4 a) {
      const float4 G = relu_grad4(a, ld4(col(L.v + n) + pt0), PRE, bf);
      st4(col(L.gv + n) + pt0, G);
      st4(s.h0 + n * bm + pt0, rnd4(G, bf));
    });
  }
  {   // G_feat = r(G_v) r(view_w[:W])^T (rounded in v2); with PRE also dd,
      // the direction columns
    Seg seg[1] = {Seg{s.h0, VW, p.viewt, W + p.dir_dim}};
    block_product(seg, 1, PRE ? W + p.dir_dim : W, bm, s.wt,
                  [&](int pt0, int n, float4 a) {
      if (n < W) {
        const float4 G = PRE ? a : rnd4(a, bf);
        st4(col(L.gfeat + n) + pt0, G);
        st4(s.h1 + n * bm + pt0, rnd4(G, bf));
      } else {
        float* q = dd + (gp0 + pt0) * p.dir_dim + (n - W);
        q[0] = a.x;
        q[p.dir_dim] = a.y;
        q[2 * p.dir_dim] = a.z;
        q[3 * p.dir_dim] = a.w;
      }
    });
  }
  const int top = p.depth - 1;
  {   // the last trunk layer's G: r(G_feat) r(feat_w)^T + r(g_sigma)
      // r(sigma_w)^T (+ the semantic head's), through its ReLU
    Seg seg[3] = {Seg{s.h1, W, p.featt, W}, Seg{s.gb + 3 * bm, 1, p.sigma_w, W},
                  Seg{s.gb + 4 * bm, 1, p.sem_w, W}};
    block_product(seg, 2 + p.out_extra, W, bm, s.wt,
                  [&](int pt0, int n, float4 a) {
      const float4 G = relu_grad4(a, ld4(col(L.h[top] + n) + pt0), PRE, bf);
      st4(col(L.gz[top] + n) + pt0, G);
      st4(s.h0 + n * bm + pt0, rnd4(G, bf));
    });
  }
  // down the trunk: layer i's input gradient r(G_i) tw_i^T. Its encoding
  // columns (layer 0, the skip layer) are dx with PRE and not computed in
  // v2; the rest is layer i - 1's output gradient, through its ReLU.
  const bool sk = p.skip + 1 < p.depth;
  float* ga = s.h0;
  float* gn = s.h1;
  for (int i = top; i >= (PRE ? 0 : 1); --i) {
    const bool cat = sk && i == p.skip + 1;
    const int ki = i == 0 ? p.in_dim : cat ? p.in_dim + W : W;
    const int xo = (i == 0 || cat) ? p.in_dim : 0;
    const int below = i - 1;
    const bool add = i == 0 && sk;   // dx already holds the skip layer's
    Seg seg[1] = {Seg{ga, W, p.twt[i] + (PRE ? 0 : xo), ki}};
    block_product(seg, 1, PRE ? ki : ki - xo, bm, s.wt,
                  [&](int pt0, int n, float4 a) {
      const int c = PRE ? n : n + xo;
      if (c < xo) {
        float* q = dx + (gp0 + pt0) * p.in_dim + c;
        const int ld = p.in_dim;
        q[0] = add ? q[0] + a.x : a.x;
        q[ld] = add ? q[ld] + a.y : a.y;
        q[2 * ld] = add ? q[2 * ld] + a.z : a.z;
        q[3 * ld] = add ? q[3 * ld] + a.w : a.w;
      } else {
        const int j = c - xo;
        const float4 G =
            relu_grad4(a, ld4(col(L.h[below] + j) + pt0), PRE, bf);
        st4(col(L.gz[below] + j) + pt0, G);
        st4(gn + j * bm + pt0, rnd4(G, bf));
      }
    });
    float* t = ga;
    ga = gn;
    gn = t;
  }
}

// A split of a chunk's points (blockIdx.y, `per` points from blockIdx.y *
// per) for one 64 x 64 tile of one job's dW and, in the tiles of row 0, its
// bias sums; the f64 partial sums go to part[split][n_params] at the
// gradient's offset.
__global__ void __launch_bounds__(FG_THREADS)
    fg_dw_kernel(FgPlan plan, const float* scr, int pc, int per, int bf,
                 double* part, long long n_params) {
  __shared__ __align__(16) float as[FG_DT * FG_PS];
  __shared__ __align__(16) float gs[FG_DT * FG_PS];
  __shared__ __align__(16) float gr[FG_DT * FG_PS];
  int j = 0;
  while (j + 1 < plan.n_jobs && plan.job[j + 1].tile0 <= (int)blockIdx.x) ++j;
  const FgJob jb = plan.job[j];
  const int lt = blockIdx.x - jb.tile0;
  const int k0 = (lt / jb.ntn) * FG_DT, n0 = (lt % jb.ntn) * FG_DT;
  const bool bias = k0 == 0;
  const int p_begin = blockIdx.y * per;
  const int p_end = min(pc, p_begin + per);
  // the thread's entries: rows kr + 16 i, columns nr + 16 j
  const int kr = threadIdx.x % 16, nr = threadIdx.x / 16;
  float acc[4][4];
  double acc64[4][4];
  double bs64[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    bs64[a] = 0.0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      acc[a][b] = 0.0f;
      acc64[a][b] = 0.0;
    }
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int pb = p_begin; pb < p_end; pb += FG_PT) {
    for (int idx = threadIdx.x; idx < FG_DT * (FG_PT / 4);
         idx += FG_THREADS) {
      const int r = idx / (FG_PT / 4), q = (idx % (FG_PT / 4)) * 4;
      const int pnt = pb + q;
      float4 a = zero, g = zero;
      if (pnt < p_end && k0 + r < jb.k)
        a = ld4(scr + (long long)(jb.a_off + k0 + r) * pc + pnt);
      if (pnt < p_end && n0 + r < jb.n)
        g = ld4(scr + (long long)(jb.g_off + n0 + r) * pc + pnt);
      st4(as + r * FG_PS + q, a);
      st4(gs + r * FG_PS + q, rnd4(g, bf));
      if (bias) st4(gr + r * FG_PS + q, g);
    }
    __syncthreads();
#pragma unroll 2
    for (int q = 0; q < FG_PT; q += 4) {
      float4 a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(as + (kr + 16 * i) * FG_PS + q);
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = ld4(gs + (nr + 16 * i) * FG_PS + q);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = acc[i][c];
          t = fmaf(a[i].x, g[c].x, t);
          t = fmaf(a[i].y, g[c].y, t);
          t = fmaf(a[i].z, g[c].z, t);
          t = fmaf(a[i].w, g[c].w, t);
          acc[i][c] = t;
        }
      if (bias && kr == 0) {   // f64 a point: a bias sum cancels
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 v = ld4(gr + (nr + 16 * c) * FG_PS + q);
          bs64[c] = (((bs64[c] + v.x) + v.y) + v.z) + v.w;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc64[a][b] += (double)acc[a][b];
        acc[a][b] = 0.0f;
      }
    }
  }
  double* dst = part + (long long)blockIdx.y * n_params;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + kr + 16 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + nr + 16 * c;
      if (k < jb.k && n < jb.n)
        dst[jb.w_off + (long long)k * jb.n + n] = acc64[i][c];
    }
  }
  if (bias && kr == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + nr + 16 * c;
      if (n < jb.n) dst[jb.b_off + n] = bs64[c];
    }
  }
}

// acc (+)= the splits' sums in split order; the last chunk writes the f32
// gradients.
__global__ void fg_split_sum_kernel(const double* part, int splits,
                                    long long n_params, double* acc,
                                    int first, int last, float* out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_params) return;
  double s = 0.0;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * n_params + e];
  const double a = first ? s : acc[e] + s;
  if (last)
    out[e] = (float)a;
  else
    acc[e] = a;
}

// ---------------------------------------------------------------------------
// The backward on the tensor cores (ft_bwd_kernel, ft_dw_kernel): the two
// passes of fg_bwd_kernel and fg_dw_kernel as wgmma products, for every
// geometry whose buffers fit (ft_geom; ops/fused_mlp.py::gen_bwd_plan is
// its mirror and picks this backward or the CUDA cores' before launch).
//
// f32 as six bf16 products. Every f32 operand x splits into three bf16
// parts, hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid); each
// subtraction is exact and each part carries 8 significant bits, so hi +
// mid + lo == x for |x| >= 2^-100. x w is then lo.hi + mid.mid + hi.lo +
// mid.hi + hi.mid + hi.hi (x's part first), issued smallest first into
// one f32 accumulator; a product of two bf16 values is exact in f32 and the
// three dropped terms are below 2^-24 |x w|. At bf16 the operands are
// already bf16 (gen_pack rounds the weights; the activations and gradients
// are rounded where the plain version rounds them): one part, one product.
// The weights arrive split (ops/fused_mlp.py::gen_ring: three planes a
// stage, pre-swizzled); the activations and gradients are split in
// registers as each wgmma's A fragment is loaded (m64n64k16, A from
// registers). The tensor core's accumulator truncates (measured on the
// H100: a fresh accumulator every 64-deep stage, 24 wgmmas of 16, erred up
// to 4x the plain f32 version against float64), so every k16 step's six
// products go to a fresh accumulator, added in f32 to a sum in registers
// while the next step runs (ft_chunk: two accumulators in turn); pass 2
// adds each stage's f32 sum to an f64 one.
//
// What bounds it on an H100: the products. At 8 x 256 in f32 the backward
// multiplies 3.49 MFLOP a point, 20.9 MFLOP of bf16 as six products: 5.55
// ms at 989 TFLOP/s for 262,144 points (pass 1 about two thirds). Every
// 64-point block streams every weight stage (7.2 MB at 8 x 256 in f32)
// from L2; clusters of two blocks sharing each stage by multicast measured
// no faster, so L2 does not bound it. What the card measured beyond the
// products: in pass 1 each tile's epilogue and each layer's read-back of
// its input (more than half of its time: taking them out left 0.40 of
// it), and registers (the epilogue's loads issued before the products
// held 32 registers through them and made pass 1 1.3x slower); in pass 2 a
// CUDA-core kernel for the heads and the tail of a non-persistent grid
// (2.2x), both gone.
//
// Pass 1, ft_bwd_kernel: a block of 64 points (wgmma's M), two consumer
// warpgroups and a producer warp. The block's activations stay in shared
// memory as f32 rows ([64][wp + 8]: one layer's input, `buf`, and the
// encoding x or d, `xs`); every product of the recompute and of the
// back-propagation walks its output in tiles of 64 columns, the
// warpgroups taking alternate tiles, and its input in 64-deep chunks, one
// weight stage ([64 N][64 K] bf16 in the 128-byte swizzle, per part) a
// chunk. The producer streams the stages, laid out in the order the
// consumers take them, with cp.async.bulk into a ring of `slots` stages
// (full / empty mbarriers; the empty one counts the owning warpgroup's 4
// warps). A tile's epilogue is fg_bwd_kernel's, element for element: bias,
// ReLU with the mask kept as the sign of a zero, the rounding, the scratch
// columns, dx and dd; the rgb head's gradient (3 columns) runs on the CUDA
// cores. A layer's output goes to the scratch only; once every tile is
// done the next product's input is read back from there into buf. The
// scratch holds fg_layout's columns block-major, [P / 64][cols][64] f32, so
// that a block writes and reads back one contiguous region and pass 2's
// stage of 64 points is contiguous (the column-major [cols][P] of the CUDA
// cores' backward scatters a block's accesses in 256-byte pieces over the
// whole chunk). Shared memory: slots x parts x 8 KB + 256 (wp + 8) + 256
// (max(in_dim, dir_dim) + 8) + 2,048 + 16 slots + 1,024 bytes, at most
// 232,448 with at least 2 slots: f32 takes every width to 512 with 128-lane
// encodings and to 384 with 256-lane ones, bf16 to 640 and 512.
//
// Pass 2, ft_dw_kernel: dW = A^T G over the points, for every layer (the
// heads' 1-3 columns padded to a tile of 64). A work item is 128 inputs
// (one warpgroup each 64) x 64 outputs of one layer over a split of the
// points, and the blocks are persistent (one an SM, items in the order
// tile + tiles x split). An item walks its split in stages of 64 points:
// cp.async brings each stage's A^T and G rows (f32, from the scratch; both
// have the points contiguous, K-major) into a ring of 3 raw stages; the
// threads split G into parts in shared memory (double-buffered) and each
// warpgroup loads its A^T fragments from the raw stage, split in
// registers; a stage's four k16 sums are added in f32, then to an f64
// sum. The items of the first 128 inputs also sum G's columns in f64 (the
// bias gradients). Each split writes its f64 partial sums to `part` and
// fg_split_sum_kernel adds them in split and chunk order: no atomics, two
// launches on the same inputs are bit-equal.
// ---------------------------------------------------------------------------

#define FT_BM 64                          // points a block (wgmma's M)
#define FT_CONSUMERS 256                  // two consumer warpgroups
#define FT_THREADS (FT_CONSUMERS + 32)    // and a producer warp
#define FT_T 64                           // a weight stage: 64 N x 64 K
#define FT_PLANE 8192                     // bytes of one bf16 [64][64] part
#define FT_PAD 8                          // f32 row padding of the buffers
#define FT_MIN_SLOTS 2
#define FT_MAX_SLOTS 8
#define FT_ALIGN 1024                     // the swizzle repeats every 1 KB
#define FT_DW_THREADS 256                 // ft_dw_kernel: two warpgroups
#define FT_DW_ITEMS 1056                  // its work items a chunk: 8 an SM
#define FT_FWD_TILES 3                    // ft_fwd_kernel: the most output
                                          // tiles a warpgroup takes a product

// The pass-1 geometry (ft_geom).
struct FtGeom {
  int np;         // parts of an operand: 3 (f32) or 1 (bf16)
  int wp, vwp;    // width and view width, padded to FT_T with zeros
  int emax;       // max(in_dim, dir_dim)
  int slots;      // weight stages in the ring
  int smem;       // bytes of shared memory
  long long stages;
};

static int ft_smem(int np, int wp, int emax, int slots) {
  return slots * np * FT_PLANE + FT_BM * 4 * (wp + FT_PAD) +
         FT_BM * 4 * (emax + FT_PAD) + FT_BM * 8 * 4 + 16 * slots + FT_ALIGN;
}

// The most ring slots, FT_MIN_SLOTS to FT_MAX_SLOTS, whose shared memory
// smem(slots) fits a block; 0 if none does.
template <class Smem>
static int ft_slots(Smem smem) {
  for (int s = FT_MAX_SLOTS; s >= FT_MIN_SLOTS; --s)
    if (smem(s) <= FG_SMEM_MAX) return s;
  return 0;
}

// The products of pass 1, in order: trunk 0..depth-1, feature, view (the
// recompute), then the feature's input gradient (and dd), the last trunk
// layer's, and down the trunk to layer 1 (v2) or 0 (v1, dx).
enum { FT_TRUNK, FT_FEAT, FT_VIEW, FT_GFEAT, FT_GTOP, FT_GTRUNK };

struct FtProd {
  int kind, layer;
  int nk;        // K chunks of FT_T
  int nx;        // of which from xs (the encoding)
  int x_first;   // the xs chunks come first (else last)
  int n;         // output columns (padded), a multiple of FT_T
};

__host__ __device__ __forceinline__ int ft_n_products(const FgParams& p,
                                                      bool pre) {
  return p.depth + 4 + (pre ? p.depth : p.depth - 1);
}

__host__ __device__ __forceinline__ FtProd ft_product(const FgParams& p,
                                                      const FtGeom& G,
                                                      int pi, bool pre) {
  const int D = p.depth, E = p.in_dim / FT_T, Wk = G.wp / FT_T;
  const bool sk = p.skip + 1 < D;
  FtProd r;
  r.layer = 0;
  r.nx = 0;
  r.x_first = 1;
  r.n = G.wp;
  r.nk = Wk;
  if (pi < D) {
    const bool cat = sk && pi == p.skip + 1;
    r.kind = FT_TRUNK;
    r.layer = pi;
    r.nx = (pi == 0 || cat) ? E : 0;
    r.nk = pi == 0 ? E : cat ? E + Wk : Wk;
  } else if (pi == D) {
    r.kind = FT_FEAT;
  } else if (pi == D + 1) {        // [feat, d]: buf's chunks, then xs's
    r.kind = FT_VIEW;
    r.nx = p.dir_dim / FT_T;
    r.nk = Wk + r.nx;
    r.x_first = 0;
    r.n = G.vwp;
  } else if (pi == D + 2) {
    r.kind = FT_GFEAT;
    r.nk = G.vwp / FT_T;
    r.n = G.wp + (pre ? p.dir_dim : 0);
  } else if (pi == D + 3) {
    r.kind = FT_GTOP;
  } else {
    const int i = D - 1 - (pi - D - 4);
    const bool cat = sk && i == p.skip + 1;
    r.kind = FT_GTRUNK;
    r.layer = i;
    if (pre) r.n = i == 0 ? p.in_dim : cat ? p.in_dim + G.wp : G.wp;
  }
  return r;
}

// The geometry of pass 1 for p, from the dims alone; 0 where it does not
// fit (the CUDA cores' backward takes those).
static int ft_geom(const FgParams* p, int pre, FtGeom* G) {
  if (p->in_dim % FT_T || p->dir_dim % FT_T) return 0;
  G->np = p->bf16 ? 1 : 3;
  G->wp = (p->width + FT_T - 1) / FT_T * FT_T;
  G->vwp = (p->view_width + FT_T - 1) / FT_T * FT_T;
  G->emax = p->in_dim > p->dir_dim ? p->in_dim : p->dir_dim;
  G->slots =
      ft_slots([&](int s) { return ft_smem(G->np, G->wp, G->emax, s); });
  if (!G->slots) return 0;
  G->smem = ft_smem(G->np, G->wp, G->emax, G->slots);
  G->stages = 0;
  for (int pi = 0; pi < ft_n_products(*p, pre != 0); ++pi) {
    const FtProd r = ft_product(*p, *G, pi, pre != 0);
    G->stages += (long long)(r.n / FT_T) * r.nk;
  }
  return 1;
}

// The tensor-core forward's shared memory: the ring, two activation
// buffers (a layer's input and its output) and the encoding buffer (no
// cotangent).
static int ft_fwd_smem(int np, int wp, int emax, int slots) {
  return slots * np * FT_PLANE + 2 * FT_BM * 4 * (wp + FT_PAD) +
         FT_BM * 4 * (emax + FT_PAD) + 16 * slots + FT_ALIGN;
}

// The geometry of the tensor-core forward for p (ft_fwd_kernel), from the
// dims alone: the recompute's products of ft_product (trunk, feature, view;
// the same for v1 and v2), so its weight stages are the first of ft_geom's;
// 0 where its buffers and FT_MIN_SLOTS slots do not fit, or a product
// has more than 2 FT_FWD_TILES output tiles (fg_fwd_kernel takes those).
// Its shared memory exceeds ft_geom's, so ft_geom takes every geometry it
// takes.
static int ft_fwd_geom(const FgParams* p, FtGeom* G) {
  if (p->in_dim % FT_T || p->dir_dim % FT_T) return 0;
  G->np = p->bf16 ? 1 : 3;
  G->wp = (p->width + FT_T - 1) / FT_T * FT_T;
  G->vwp = (p->view_width + FT_T - 1) / FT_T * FT_T;
  G->emax = p->in_dim > p->dir_dim ? p->in_dim : p->dir_dim;
  if (G->wp > 2 * FT_FWD_TILES * FT_T) return 0;
  G->slots = ft_slots(
      [&](int s) { return ft_fwd_smem(G->np, G->wp, G->emax, s); });
  if (!G->slots) return 0;
  G->smem = ft_fwd_smem(G->np, G->wp, G->emax, G->slots);
  G->stages = 0;
  for (int pi = 0; pi < p->depth + 2; ++pi) {
    const FtProd r = ft_product(*p, *G, pi, false);
    G->stages += (long long)(r.n / FT_T) * r.nk;
  }
  return 1;
}

// --- wgmma, mbarriers and bulk copies (as in csrc/fused_mlp_pe.cu) --------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A wgmma shared-memory descriptor for the 128-byte swizzle (K-major: sbo
// is the byte stride between groups of 8 rows).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps A's fragment registers alive (unwritten) until here: a wgmma
// reads them asynchronously, until its wait
template <int NP>
__device__ __forceinline__ void keep_frag(uint32_t (&a)[NP][4]) {
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[q][r])::"memory");
}

// d (+)= A B for one 16-deep step of m64n64k16: A [64 x 16] bf16 from
// registers (a0-a3: rows r, r + 8 by columns 2 (t % 4) + {0, 1}, + 8, in
// the accumulator's row order), B [16 x 64] from shared memory, K-major.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t a, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(a), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}
// Wait until the barrier's phase differs from `parity`; a wait of 2^32
// clocks is a fault of the schedule and traps, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  long long t0 = 0;
  for (int n = 0;; ++n) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    if (ok) return;
    if (n == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 32))
      __trap();
  }
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// generic-proxy writes to shared memory, before wgmma reads them
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the two consumer warpgroups (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FT_CONSUMERS) : "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values as NP bf16x2 parts, largest first: part 0 + part 1 + part
// 2 == v exactly (NP = 3); part 0 = v rounded to bf16 (NP = 1).
template <int NP>
__device__ __forceinline__ void split2(float2 v, uint32_t (&o)[NP]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  o[0] = bf2_bits(h);
  if constexpr (NP == 3) {
    const float2 hf = __bfloat1622float2(h);
    const float rx = __fsub_rn(v.x, hf.x), ry = __fsub_rn(v.y, hf.y);
    const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
    const float2 mf = __bfloat1622float2(m);
    o[1] = bf2_bits(m);
    o[2] = bf2_bits(__floats2bfloat162_rn(__fsub_rn(rx, mf.x),
                                          __fsub_rn(ry, mf.y)));
  }
}

// One k16 step: acc (+)= A B over the parts. a[q]: A's part q (0 hi, 1 mid,
// 2 lo); B's part q at b + q * FT_PLANE. The six products smallest first:
// lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi. fresh: the step starts
// the accumulator.
template <int NP>
__device__ __forceinline__ void ft_k16(float (&acc)[32],
                                       const uint32_t (&a)[NP][4],
                                       uint32_t b, int fresh) {
  auto B = [&](int q) { return desc_sw128(b + q * FT_PLANE, 16, 1024); };
  if constexpr (NP == 1) {
    wgmma_rs64(acc, a[0][0], a[0][1], a[0][2], a[0][3], B(0), !fresh);
  } else {
    wgmma_rs64(acc, a[2][0], a[2][1], a[2][2], a[2][3], B(0), !fresh);
    wgmma_rs64(acc, a[1][0], a[1][1], a[1][2], a[1][3], B(1), 1);
    wgmma_rs64(acc, a[0][0], a[0][1], a[0][2], a[0][3], B(2), 1);
    wgmma_rs64(acc, a[1][0], a[1][1], a[1][2], a[1][3], B(0), 1);
    wgmma_rs64(acc, a[0][0], a[0][1], a[0][2], a[0][3], B(1), 1);
    wgmma_rs64(acc, a[0][0], a[0][1], a[0][2], a[0][3], B(0), 1);
  }
}

// A's fragment of one k16 step, split: v = (rows r, r + 8) x (columns c,
// c + 8) as float2 pairs in the register order of wgmma_rs64.
template <int NP>
__device__ __forceinline__ void ft_frag(const float2 (&v)[4],
                                        uint32_t (&a)[NP][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t o[NP];
    split2<NP>(v[r], o);
#pragma unroll
    for (int q = 0; q < NP; ++q) a[q][r] = o[q];
  }
}

// --- pass 1 ----------------------------------------------------------------

// A 64-deep chunk's four k16 steps, each in a fresh accumulator (the
// tensor core's accumulation truncates; a k16 step's six products are 96
// terms) added to sum by fold while the next step runs: two accumulators
// in turn. frag(ks, v) loads A's fragment of step ks as float2 pairs; b is
// the chunk's weight stage (part q at b + q * FT_PLANE). Returns when
// every product has read its operands.
template <int NP, class Frag, class Fold>
__device__ __forceinline__ void ft_chunk(uint32_t b, Frag frag, Fold fold) {
  float acc0[32], acc1[32];
  uint32_t af[4][NP][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    float2 v[4];
    frag(ks, v);
    ft_frag<NP>(v, af[ks]);
    wg_fence();
    if (ks & 1)
      ft_k16<NP>(acc1, af[ks], b + ks * 32, 1);
    else
      ft_k16<NP>(acc0, af[ks], b + ks * 32, 1);
    wg_commit();
    if (ks > 0) {   // step ks - 1 is done
      wg_wait1();
      keep_frag<NP>(af[ks - 1]);
      if (ks & 1) {
        fence_regs(acc0);
        fold(acc0);
      } else {
        fence_regs(acc1);
        fold(acc1);
      }
    }
  }
  wg_wait0();
  keep_frag<NP>(af[3]);
  fence_regs(acc1);
  fold(acc1);
}

// One output tile (64 columns) of product pr for this warpgroup: sum over
// its K chunks, the weight stages gbase + tp * 2 nk + kc * npair + wg of
// the ring.
template <int NP>
__device__ __forceinline__ void ft_tile(float (&sum)[32], const FtProd& pr,
                                        int tp, int npair, int gbase,
                                        const float* buf, int bs,
                                        const float* xs, int xst,
                                        uint32_t ring_s, uint32_t full,
                                        uint32_t empty, const FtGeom& G) {
  const int t = threadIdx.x, wg = t >> 7, lane = t & 31;
  const int r0 = 16 * ((t >> 5) & 3) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = 0.0f;
  for (int kc = 0; kc < pr.nk; ++kc) {
    const bool from_x =
        pr.x_first ? kc < pr.nx : kc >= pr.nk - pr.nx;
    const int ck = from_x ? (pr.x_first ? kc : kc - (pr.nk - pr.nx))
                          : (pr.x_first ? kc - pr.nx : kc);
    const int st = from_x ? xst : bs;
    const float* a = (from_x ? xs : buf) + r0 * st + FT_T * ck + c0;
    const int gi = gbase + tp * 2 * pr.nk + kc * npair + wg;
    const int slot = gi % G.slots;
    mbar_wait(full + 8 * slot, (gi / G.slots) & 1);
    ft_chunk<NP>(
        ring_s + slot * NP * FT_PLANE,
        [&](int ks, float2 (&v)[4]) {
          const float* q = a + 16 * ks;
          v[0] = ld2(q);
          v[1] = ld2(q + 8 * st);
          v[2] = ld2(q + 8);
          v[3] = ld2(q + 8 * st + 8);
        },
        [&](const float (&acc)[32]) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sum[i] += acc[i];
        });
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }
}

// What a tile's epilogue reads besides its sums, loaded together (one
// latency) after the tile's products: the recompute's bias of each output
// column, the back-propagation's ReLU mask of each output (the scratch's
// stored activation); 0 where there is none. (Loaded before the products,
// they held 32 registers through them, and pass 1 ran 1.3x slower on the
// H100.)
template <bool PRE>
__device__ __forceinline__ void ft_pre(const FgParams& p, const FgLayout& L,
                                       const FtProd& pr, int tile,
                                       const float* blk, float (&m)[32]) {
  const int t = threadIdx.x, lane = t & 31, D = p.depth, i = pr.layer;
  const int r0 = 16 * ((t >> 5) & 3) + (lane >> 2);
  const bool cat = p.skip + 1 < D && i == p.skip + 1;
  const int xo = pr.kind == FT_GTRUNK && PRE && (i == 0 || cat) ? p.in_dim : 0;
  const int below = pr.kind == FT_GTOP ? D - 1 : i - 1;
  const float* bias = pr.kind == FT_TRUNK  ? p.tb[i]
                      : pr.kind == FT_FEAT ? p.feat_b
                      : pr.kind == FT_VIEW ? p.view_b
                                           : nullptr;
  const int nb = pr.kind == FT_VIEW ? p.view_width : p.width;
  const bool mask =
      pr.kind == FT_GTOP || (pr.kind == FT_GTRUNK && below >= 0);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = FT_T * tile + 8 * j + 2 * (lane & 3) + e;
        float v = 0.0f;
        if (bias) {
          if (n < nb) v = __ldg(bias + n);
        } else if (mask && n - xo >= 0 && n - xo < p.width) {
          v = __ldcg(blk + (L.h[below] + n - xo) * FT_BM + r0 + 8 * h);
        }
        m[4 * j + 2 * h + e] = v;
      }
}

// The tile's epilogue: fg_bwd_kernel's, element for element (column n of
// the product's padded output at row r0 (+ 8)); pre: ft_pre's.
template <bool PRE>
__device__ __forceinline__ void ft_epi(const FgParams& p, const FgLayout& L,
                                       const FtGeom& G, const FtProd& pr,
                                       int tile, const float (&sum)[32],
                                       const float (&pre)[32], float* blk,
                                       long long gp0, const float* gs,
                                       float* dx, float* dd) {
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * ((t >> 5) & 3) + (lane >> 2);
  const int bf = p.bf16, W = p.width, VW = p.view_width, D = p.depth;
  const int i = pr.layer;
  const bool sk = p.skip + 1 < D, cat = sk && i == p.skip + 1;
  auto each = [&](auto f) {    // f(sum, pre, column, row) of every element
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          f(sum[4 * j + 2 * h + e], pre[4 * j + 2 * h + e],
            FT_T * tile + 8 * j + 2 * (lane & 3) + e, r0 + 8 * h);
  };
  if (pr.kind == FT_TRUNK) {
    float* o = blk + L.h[i] * FT_BM;
    each([&](float a, float b, int n, int row) {
      if (n < W) o[n * FT_BM + row] = act(a + b, bf, true);
    });
  } else if (pr.kind == FT_FEAT) {
    float* o = blk + L.feat * FT_BM;
    each([&](float a, float b, int n, int row) {
      if (n < W) o[n * FT_BM + row] = rnd(a + b, bf);
    });
  } else if (pr.kind == FT_VIEW) {
    float* o = blk + L.v * FT_BM;
    each([&](float a, float b, int n, int row) {
      if (n < VW) o[n * FT_BM + row] = act(a + b, bf, true);
    });
  } else if (pr.kind == FT_GFEAT) {
    float* o = blk + L.gfeat * FT_BM;
    each([&](float a, float, int n, int row) {
      if (n < W)
        o[n * FT_BM + row] = PRE ? a : rnd(a, bf);
      else if (PRE && n >= G.wp)
        dd[(gp0 + row) * p.dir_dim + (n - G.wp)] = a;
    });
  } else if (pr.kind == FT_GTOP) {
    float* o = blk + L.gz[D - 1] * FT_BM;
    each([&](float a, float b, int n, int row) {
      if (n < W) {
        float v = fmaf(gs[row * 8 + 3], __ldg(p.sigma_w + n), a);
        if (p.out_extra) v = fmaf(gs[row * 8 + 4], __ldg(p.sem_w + n), v);
        o[n * FT_BM + row] = relu_grad(v, b, PRE, bf);
      }
    });
  } else {   // FT_GTRUNK: layer i's input gradient; dx from the skip first
    const int xo = PRE && (i == 0 || cat) ? p.in_dim : 0;
    float* o = i > 0 ? blk + L.gz[i - 1] * FT_BM : nullptr;
    each([&](float a, float b, int n, int row) {
      if (n < xo) {
        float* q = dx + (gp0 + row) * p.in_dim + n;
        *q = (i == 0 && sk) ? *q + a : a;
      } else if (n - xo < W) {
        o[(n - xo) * FT_BM + row] = relu_grad(a, b, PRE, bf);
      }
    });
  }
}

// buf[pt][c] = r(the block's scratch column c at pt) for c < n, 0 to npad: a
// thread a column and 8 points, four such at a time (their loads issued
// together).
__device__ __forceinline__ void ft_reload(float* buf, int bs,
                                          const float* src, int n, int npad,
                                          int bf) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int units = npad * (FT_BM / 8);
  for (int u0 = threadIdx.x; u0 < units; u0 += 4 * FT_CONSUMERS) {
    float4 a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = u0 + q * FT_CONSUMERS;
      const int c = u % npad, r = (u / npad) * 8;
      a[q] = b[q] = z;
      if (u < units && c < n) {
        a[q] = __ldcg(reinterpret_cast<const float4*>(src + c * FT_BM + r));
        b[q] = __ldcg(
            reinterpret_cast<const float4*>(src + c * FT_BM + r + 4));
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = u0 + q * FT_CONSUMERS;
      if (u >= units) break;
      const int c = u % npad, r = (u / npad) * 8;
      float* d = buf + r * bs + c;
      d[0] = rnd(a[q].x, bf);
      d[bs] = rnd(a[q].y, bf);
      d[2 * bs] = rnd(a[q].z, bf);
      d[3 * bs] = rnd(a[q].w, bf);
      d[4 * bs] = rnd(b[q].x, bf);
      d[5 * bs] = rnd(b[q].y, bf);
      d[6 * bs] = rnd(b[q].z, bf);
      d[7 * bs] = rnd(b[q].w, bf);
    }
  }
}

// An encoding (x: lanes from 0 of xd; d: from 3) of the block's points
// into xs and, unless scol is null (the forward), its scratch columns,
// rounded; PRE reads it as given.
template <bool PRE>
__device__ __forceinline__ void ft_encode(float* xs, int xst, int dim,
                                          const float* src, int lane0,
                                          int nf, long long gp0, int bf,
                                          float* scol) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < dim * FT_BM; idx += FT_CONSUMERS) {
    const int j = idx / FT_BM, pt = idx - j * FT_BM;
    const long long q = gp0 + pt;
    const float v = rnd(PRE ? __ldg(src + q * dim + j)
                            : pe_lane(src + q * 8 + lane0, j, nf),
                        bf);
    xs[pt * xst + j] = v;
    if (scol) scol[j * FT_BM + pt] = v;
  }
}

// The ring's barriers: full (the producer's arrival with the stage's bytes)
// and empty (the owning warpgroup's 4 warps) of every slot.
__device__ __forceinline__ void ft_ring_init(uint32_t full, uint32_t empty,
                                             int slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: its first thread streams the ring's stages, NP parts
// each, in the consumers' order, a slot once its last stage is consumed.
template <int NP>
__device__ __forceinline__ void ft_produce(const uint8_t* ring,
                                           uint32_t ring_s, uint32_t full,
                                           uint32_t empty, const FtGeom& G) {
  if (threadIdx.x != FT_CONSUMERS) return;
  const uint32_t bytes = NP * FT_PLANE;
  const uint8_t* src = ring;
  for (long long gi = 0; gi < G.stages; ++gi) {
    const int slot = (int)(gi % G.slots);
    if (gi >= G.slots)
      mbar_wait(empty + 8 * slot, (uint32_t)((gi / G.slots) - 1) & 1);
    mbar_expect(full + 8 * slot, bytes);
    bulk_g2s(ring_s + slot * bytes, src, bytes, full + 8 * slot);
    src += bytes;
  }
}

template <bool PRE, int NP>
__global__ void __launch_bounds__(FT_THREADS, 1)
    ft_bwd_kernel(const __grid_constant__ FgParams p,
                  const __grid_constant__ FgLayout L,
                  const __grid_constant__ FtGeom G,
                  const float* in_x, const float* in_d, const float* g,
                  float* dx, float* dd, float* scr, long long cp0,
                  const uint8_t* ring) {
  extern __shared__ uint8_t ft_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      ((uintptr_t)ft_raw + FT_ALIGN - 1) & ~(uintptr_t)(FT_ALIGN - 1));
  const uint32_t ring_s = smem_u32(base);
  float* buf = reinterpret_cast<float*>(base + G.slots * NP * FT_PLANE);
  const int bs = G.wp + FT_PAD, xst = G.emax + FT_PAD;
  float* xs = buf + FT_BM * bs;
  float* gs = xs + FT_BM * xst;                 // the cotangent, rounded
  const uint32_t full = smem_u32(gs + FT_BM * 8), empty = full + 8 * G.slots;
  const int t = threadIdx.x;
  ft_ring_init(full, empty, G.slots);
  const int nprod = ft_n_products(p, PRE);
  if (t >= FT_CONSUMERS) {
    ft_produce<NP>(ring, ring_s, full, empty, G);
    return;
  }
  const long long gp0 = cp0 + (long long)blockIdx.x * FT_BM;
  const int W = p.width, VW = p.view_width, D = p.depth, bf = p.bf16;
  const int no = 4 + p.out_extra, wg = t >> 7;
  // the block's scratch: its columns, 64 points each (block-major)
  float* blk = scr + (long long)blockIdx.x * L.cols * FT_BM;
  auto col = [&](int c) { return blk + c * FT_BM; };
  ft_encode<PRE>(xs, xst, p.in_dim, in_x, 0, p.multires, gp0, bf,
                 col(L.xe));
  consumers_sync();
  int gbase = 0;
  for (int pi = 0; pi < nprod; ++pi) {
    const FtProd pr = ft_product(p, G, pi, PRE);
    const int nt = pr.n / FT_T;
    for (int tp = 0; 2 * tp < nt; ++tp) {
      const int tile = 2 * tp + wg;
      if (tile < nt) {
        float sum[32], pre[32];
        ft_tile<NP>(sum, pr, tp, nt - 2 * tp < 2 ? 1 : 2, gbase, buf, bs, xs,
                    xst, ring_s, full, empty, G);
        ft_pre<PRE>(p, L, pr, tile, blk, pre);
        ft_epi<PRE>(p, L, G, pr, tile, sum, pre, blk, gp0, gs, dx, dd);
      }
    }
    gbase += nt * pr.nk;
    consumers_sync();
    // what the next product reads
    if (pr.kind == FT_TRUNK) {
      ft_reload(buf, bs, col(L.h[pr.layer]), W, G.wp, bf);
    } else if (pr.kind == FT_FEAT) {
      ft_reload(buf, bs, col(L.feat), W, G.wp, bf);
      ft_encode<PRE>(xs, xst, p.dir_dim, PRE ? in_d : in_x, 3,
                     p.multires_views, gp0, bf, col(L.de));
    } else if (pr.kind == FT_VIEW) {
      // the cotangent: as it is to the scratch, rounded to gs; then G_v =
      // (r(g_rgb) r(rgb_w)^T) * [vz > 0] on the CUDA cores into buf (the
      // forward's pack: rgb_w [view_width][3]; the kernel reads no
      // transposes)
      for (int idx = t; idx < no * FT_BM; idx += FT_CONSUMERS) {
        const int c = idx / FT_BM, pt = idx - c * FT_BM;
        const float v = __ldg(g + (gp0 + pt) * no + c);
        col(L.gin + c)[pt] = v;
        gs[pt * 8 + c] = rnd(v, bf);
      }
      consumers_sync();
      for (int i0 = t; i0 < G.vwp * FT_BM; i0 += 8 * FT_CONSUMERS) {
        float vm[8];   // the view layer's stored outputs (masks), together
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int idx = i0 + q * FT_CONSUMERS;
          const int n = idx / FT_BM, pt = idx - n * FT_BM;
          vm[q] = idx < G.vwp * FT_BM && n < VW ? __ldcg(col(L.v + n) + pt)
                                                : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int idx = i0 + q * FT_CONSUMERS;
          if (idx >= G.vwp * FT_BM) break;
          const int n = idx / FT_BM, pt = idx - n * FT_BM;
          float gv = 0.0f;
          if (n < VW) {
            float a = 0.0f;
            for (int c = 0; c < 3; ++c)
              a = fmaf(gs[pt * 8 + c], __ldg(p.rgb_w + n * 3 + c), a);
            gv = relu_grad(a, vm[q], PRE, bf);
            col(L.gv + n)[pt] = gv;
          }
          buf[pt * bs + n] = rnd(gv, bf);
        }
      }
    } else if (pr.kind == FT_GFEAT) {
      ft_reload(buf, bs, col(L.gfeat), W, G.wp, bf);
    } else if (pr.kind == FT_GTOP) {
      ft_reload(buf, bs, col(L.gz[D - 1]), W, G.wp, bf);
    } else if (pr.layer - 1 >= (PRE ? 0 : 1)) {
      ft_reload(buf, bs, col(L.gz[pr.layer - 1]), W, G.wp, bf);
    }
    consumers_sync();
  }
}

// --- pass 2 ----------------------------------------------------------------

// One weight gradient of ft_dw_kernel: A (k scratch columns from a_off), G
// (n columns from g_off), its tiles from tile0: mp blocks of 128 inputs x
// ntn of 64 outputs.
struct FtJob {
  int a_off, k, g_off, n, mp, ntn, tile0;
  long long w_off, b_off;
};

struct FtDwPlan {
  int n_jobs, tiles, cols;   // cols: the scratch's columns (block-major)
  FtJob job[FG_MAX_JOBS];
};

// ft_dw_kernel's shared memory: FT_DW_BUF raw f32 stages (A^T: 128 rows
// x 64 points, G: 64 rows x 64 points, rows padded by FT_PAD), then G's
// parts, double-buffered.
#define FT_DW_BUF 3
#define FT_DW_RS (FT_T + FT_PAD)                       // a raw row's floats
#define FT_DW_RAW (3 * FT_T * FT_DW_RS * 4)            // bytes of a stage
template <int NP>
constexpr int ft_dw_smem() {
  return FT_DW_BUF * FT_DW_RAW + 2 * NP * FT_PLANE + FT_ALIGN;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

template <int NP>
__global__ void __launch_bounds__(FT_DW_THREADS, 1)
    ft_dw_kernel(const __grid_constant__ FtDwPlan plan, const float* scr,
                 int pc, int per, int splits, int bf, double* part,
                 long long n_params) {
  extern __shared__ uint8_t ft_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      ((uintptr_t)ft_raw + FT_ALIGN - 1) & ~(uintptr_t)(FT_ALIGN - 1));
  uint8_t* planes = base + FT_DW_BUF * FT_DW_RAW;
  // persistent blocks: work item = tile + tiles x split, in that order, so
  // that the blocks at work side by side share a split's points in L2
  for (int item = blockIdx.x; item < plan.tiles * splits;
       item += gridDim.x) {
    const int tile = item % plan.tiles, split = item / plan.tiles;
    int j = 0;
    while (j + 1 < plan.n_jobs && plan.job[j + 1].tile0 <= tile) ++j;
    const FtJob& jb = plan.job[j];
    const int lt = tile - jb.tile0;
    const int m2 = lt / jb.ntn, n0 = (lt % jb.ntn) * FT_T;
    const int t = threadIdx.x, wg = t >> 7, lane = t & 31;
    const int r0 = 16 * ((t >> 5) & 3) + (lane >> 2), c0 = 2 * (lane & 3);
    const bool bias = m2 == 0;
    const int p_begin = split * per;
    const int p_end = min(pc, p_begin + per);
    const int n_st = (p_end - p_begin + FT_T - 1) / FT_T;
    const int k0 = m2 * 2 * FT_T;
    // stage s's raw rows (A^T's 128, then G's 64) into buffer s % FT_DW_BUF:
    // 16-byte copies, zeros past the layer's inputs and outputs
    auto issue = [&](int s) {
      if (s < n_st) {
        float* raw =
            reinterpret_cast<float*>(base + (s % FT_DW_BUF) * FT_DW_RAW);
        const int pb = p_begin + s * FT_T;
        for (int c = t; c < 3 * FT_T * (FT_T / 4); c += FT_DW_THREADS) {
          const int row = c / (FT_T / 4), q = (c % (FT_T / 4)) * 4;
          const bool is_a = row < 2 * FT_T;
          const int r = is_a ? k0 + row : n0 + row - 2 * FT_T;
          const bool ok = r < (is_a ? jb.k : jb.n);
          const float* src =
              scr + ((long long)(pb / FT_BM) * plan.cols +
                     (is_a ? jb.a_off : jb.g_off) + (ok ? r : 0)) * FT_BM + q;
          cp_async16(raw + row * FT_DW_RS + q, src, ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    double acc[32];
  #pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0;
    double bsum = 0.0;
    const int ns = t >> 2, q0 = (t & 3) * 16;    // this thread's G row, points
  #pragma unroll
    for (int s = 0; s < FT_DW_BUF - 1; ++s) issue(s);
    for (int s = 0; s < n_st; ++s) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(FT_DW_BUF - 2) : "memory");
      __syncthreads();          // stage s is in; every thread is past s - 1
      issue(s + FT_DW_BUF - 1);
      const float* raw =
          reinterpret_cast<const float*>(base + (s % FT_DW_BUF) * FT_DW_RAW);
      uint8_t* pl = planes + (s & 1) * NP * FT_PLANE;
      // G's row ns, points q0..q0+15: the bias sum (f64, the f32 values),
      // then r(G) split into parts, two 16-byte chunks of each part
      const float* grow = raw + (2 * FT_T + ns) * FT_DW_RS + q0;
  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 u0 = ld4(grow + 8 * h), u1 = ld4(grow + 8 * h + 4);
        if (bias)
          bsum = (((((((bsum + u0.x) + u0.y) + u0.z) + u0.w) + u1.x) + u1.y) +
                  u1.z) + u1.w;
        const float2 v[4] = {make_float2(rnd(u0.x, bf), rnd(u0.y, bf)),
                             make_float2(rnd(u0.z, bf), rnd(u0.w, bf)),
                             make_float2(rnd(u1.x, bf), rnd(u1.y, bf)),
                             make_float2(rnd(u1.z, bf), rnd(u1.w, bf))};
        uint32_t w[NP][4];
        ft_frag<NP>(v, w);
        const int chunk = (q0 >> 3) + h;
  #pragma unroll
        for (int q = 0; q < NP; ++q)
          *reinterpret_cast<uint4*>(pl + q * FT_PLANE + ns * 128 +
                                    ((chunk ^ (ns & 7)) << 4)) =
              make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
      }
      fence_async();
      __syncthreads();
      // A^T's rows wg * 64 + r0 (+ 8) of the stage's raw tile; the stage's
      // four k16 products summed in f32, then added to the f64 sum
      const float* a = raw + (wg * FT_T + r0) * FT_DW_RS + c0;
      float ssum[32];
  #pragma unroll
      for (int i = 0; i < 32; ++i) ssum[i] = 0.0f;
      ft_chunk<NP>(
          smem_u32(pl),
          [&](int ks, float2 (&v)[4]) {
            const float* q = a + 16 * ks;
            v[0] = ld2(q);
            v[1] = ld2(q + 8 * FT_DW_RS);
            v[2] = ld2(q + 8);
            v[3] = ld2(q + 8 * FT_DW_RS + 8);
          },
          [&](const float (&prt)[32]) {
  #pragma unroll
            for (int i = 0; i < 32; ++i) ssum[i] += prt[i];
          });
  #pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += (double)ssum[i];
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    double* dst = part + (long long)split * n_params;
    const int ka = k0 + wg * FT_T + r0;
  #pragma unroll
    for (int jj = 0; jj < 8; ++jj)
  #pragma unroll
      for (int h = 0; h < 2; ++h)
  #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = ka + 8 * h, n = n0 + 8 * jj + c0 + e;
          if (k < jb.k && n < jb.n)
            dst[jb.w_off + (long long)k * jb.n + n] = acc[4 * jj + 2 * h + e];
        }
    if (bias) {   // the 4 threads of row ns, in a fixed order
      double sm = bsum;
      sm += __shfl_xor_sync(0xFFFFFFFFu, sm, 1);
      sm += __shfl_xor_sync(0xFFFFFFFFu, sm, 2);
      if ((t & 3) == 0 && n0 + ns < jb.n) dst[jb.b_off + n0 + ns] = sm;
    }
    __syncthreads();   // the buffers are free for the next item
  }
}

// ---------------------------------------------------------------------------
// The forward on the tensor cores (ft_fwd_kernel): #9 gen and #7 gen, what
// fg_fwd_kernel computes, for every geometry ft_fwd_geom takes
// (ops/fused_mlp.py::gen_fwd_plan is its mirror and picks this forward or
// fg_fwd_kernel before launch).
//
// What bounds it on an H100: the products. At 8 x 256 the forward
// multiplies 1.19 MFLOP a point, 3.11e11 FLOP at 262,144 points: in f32,
// as six exact bf16 products (the backward's note above), 1.89 ms at 989
// TFLOP/s; in bf16 one product. Every 64-point block streams the forward's
// 156 weight stages, 3.8 MB at 8 x 256 in f32, from L2 (15.7 GB a call).
//
// The design is pass 1's recompute without its scratch: a block of 64
// points, two consumer warpgroups taking alternate 64-column tiles of each
// product and a producer warp streaming the ring (ft_produce). The ring is
// the first stages of gen_ring's (the recompute's products come first
// there), so one ring packed for a forward and its backward serves both.
// Its products are ft_product's trunk 0..depth-1 (the skip layer on
// [x, h]), feature, and view on [feat, d], each through ft_tile (a fresh
// accumulator every k16 step). No layer goes to device memory: the block's
// activations stay in shared memory as two f32 buffers [64][wp + 8], a
// layer's input and its output, swapped after each product, beside the
// encoding buffer (x, then d once the trunk is done). Each tile's epilogue
// writes its output to the other buffer at once, so a product ends with one
// barrier. (tools/fwd_variants.py on the H100, f32 8 x 256, 262,144
// points: 5.35-5.46 ms, against 5.53-5.57 with one buffer that each
// warpgroup's finished tiles overwrite once both have read it, held in
// registers until then (5 ring slots, 424 bytes of spills), and 5.46-5.49
// with the first tile staged in shared memory (3 slots, 268 bytes of
// spills): the ring's depth, 2 slots here, is not what bounds it. Only this
// layout, with the tile loop unrolled over FT_FWD_TILES, compiles without
// spills: as a loop of runtime length it spills 36 bytes.) A tile's
// epilogue is fg_fwd_kernel's,
// element for element: bias, ReLU through act(z + b, bf, false), the
// rounding to the compute type (the feature layer without the ReLU), zero
// in the padding columns. The heads are fg_fwd_kernel's f32 FMAs on the
// CUDA cores: sigma (and the semantic logit) off the last trunk output,
// rgb off the view layer's. Shared memory: slots x parts x 8 KB + 512
// (wp + 8) + 256 (max(in_dim, dir_dim) + 8) + 16 slots + 1,024 bytes, at
// most 232,448 with at least 2 slots: f32 takes every width to 256 with
// 128-lane encodings (2 slots) and to 192 with 256-lane ones, bf16 to 320
// and 256.
// ---------------------------------------------------------------------------

// The bias of each of a recompute tile's columns (ft_tile's register
// order; 0 past the layer's outputs).
__device__ __forceinline__ void ft_bias(const FgParams& p, const FtProd& pr,
                                        int tile, float (&b)[32]) {
  const int lane = threadIdx.x & 31;
  const float* bias = pr.kind == FT_TRUNK  ? p.tb[pr.layer]
                      : pr.kind == FT_FEAT ? p.feat_b
                                           : p.view_b;
  const int nb = pr.kind == FT_VIEW ? p.view_width : p.width;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = FT_T * tile + 8 * j + 2 * (lane & 3) + e;
      const float v = n < nb ? __ldg(bias + n) : 0.0f;
      b[4 * j + e] = v;
      b[4 * j + 2 + e] = v;
    }
}

// The forward's epilogue of a tile: fg_fwd_kernel's, element for element.
__device__ __forceinline__ void ft_fwd_epi(const FgParams& p,
                                           const FtProd& pr, int tile,
                                           const float (&sum)[32],
                                           const float (&b)[32],
                                           float (&o)[32]) {
  const int lane = threadIdx.x & 31, bf = p.bf16;
  const int nb = pr.kind == FT_VIEW ? p.view_width : p.width;
  const bool relu = pr.kind != FT_FEAT;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 4 * j + 2 * h + e;
        const int n = FT_T * tile + 8 * j + 2 * (lane & 3) + e;
        const float z = sum[k] + b[k];
        o[k] = n >= nb ? 0.0f : relu ? act(z, bf, false) : rnd(z, bf);
      }
}

// A tile's values o (ft_tile's register order) into columns col0.. of dst
// [64][ds].
__device__ __forceinline__ void ft_put(float* dst, int ds, int col0,
                                       const float (&o)[32]) {
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * ((t >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + (r0 + 8 * h) * ds + col0 + 8 * j +
                                 2 * (lane & 3)) =
          make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
}

// The block's points from blockIdx.x * 64: encodings (v2) or their rounded
// copies (PRE), the products, the heads; raw [P][4 + e] to out.
template <bool PRE, int NP>
__global__ void __launch_bounds__(FT_THREADS, 1)
    ft_fwd_kernel(const __grid_constant__ FgParams p,
                  const __grid_constant__ FtGeom G, const float* in_x,
                  const float* in_d, float* out, const uint8_t* ring) {
  extern __shared__ uint8_t ft_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      ((uintptr_t)ft_raw + FT_ALIGN - 1) & ~(uintptr_t)(FT_ALIGN - 1));
  const uint32_t ring_s = smem_u32(base);
  const int bs = G.wp + FT_PAD, xst = G.emax + FT_PAD;
  float* buf = reinterpret_cast<float*>(base + G.slots * NP * FT_PLANE);
  float* nbuf = buf + FT_BM * bs;
  float* xs = nbuf + FT_BM * bs;
  const uint32_t full = smem_u32(xs + FT_BM * xst), empty = full + 8 * G.slots;
  const int t = threadIdx.x;
  ft_ring_init(full, empty, G.slots);
  if (t >= FT_CONSUMERS) {
    ft_produce<NP>(ring, ring_s, full, empty, G);
    return;
  }
  const long long gp0 = (long long)blockIdx.x * FT_BM;
  const int D = p.depth, bf = p.bf16, no = 4 + p.out_extra, wg = t >> 7;
  ft_encode<PRE>(xs, xst, p.in_dim, in_x, 0, p.multires, gp0, bf, nullptr);
  consumers_sync();
  int gbase = 0;
  for (int pi = 0; pi < D + 2; ++pi) {
    const FtProd pr = ft_product(p, G, pi, PRE);
    const int nt = pr.n / FT_T;
#pragma unroll
    for (int tp = 0; tp < FT_FWD_TILES; ++tp) {
      const int tile = 2 * tp + wg;
      if (tile < nt) {
        float sum[32], b[32], o[32];
        ft_tile<NP>(sum, pr, tp, nt - 2 * tp < 2 ? 1 : 2, gbase, buf, bs, xs,
                    xst, ring_s, full, empty, G);
        ft_bias(p, pr, tile, b);
        ft_fwd_epi(p, pr, tile, sum, b, o);
        ft_put(nbuf, bs, FT_T * tile, o);
      }
    }
    gbase += nt * pr.nk;
    consumers_sync();   // the output is whole, the input read
    float* in = buf;
    buf = nbuf;
    nbuf = in;
    if (pi == D - 1) {
      // x is read no more: the direction's encoding, which the view layer
      // reads after the feature product's barrier; sigma (and the semantic
      // logit) off the last trunk output, which the view layer overwrites
      ft_encode<PRE>(xs, xst, p.dir_dim, PRE ? in_d : in_x, 3,
                     p.multires_views, gp0, bf, nullptr);
      for (int idx = t; idx < FT_BM * (1 + p.out_extra); idx += FT_CONSUMERS) {
        const int c = idx / FT_BM, pt = idx - c * FT_BM;
        const float* w = c == 0 ? p.sigma_w : p.sem_w;
        const float* h = buf + pt * bs;
        float a = 0.0f;
        for (int k = 0; k < p.width; ++k) a = fmaf(h[k], __ldg(w + k), a);
        out[(gp0 + pt) * no + 3 + c] =
            a + __ldg(c == 0 ? p.sigma_b : p.sem_b);
      }
    } else if (pi == D + 1) {   // rgb off the view layer
      for (int idx = t; idx < FT_BM * 3; idx += FT_CONSUMERS) {
        const int c = idx / FT_BM, pt = idx - c * FT_BM;
        const float* v = buf + pt * bs;
        float a = 0.0f;
        for (int k = 0; k < p.view_width; ++k)
          a = fmaf(v[k], __ldg(p.rgb_w + k * 3 + c), a);
        out[(gp0 + pt) * no + c] = a + __ldg(p.rgb_b + c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C interface, bound with ctypes. Pointers are device pointers except the
// struct, which is host memory. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// the kernels do not take).
// ---------------------------------------------------------------------------

// The points a block takes (the largest of 64, 32, 16, 8 whose shared
// memory fits) and its shared memory in bytes; 0 if none fits.
static int fg_bm(const FgParams* p, int* smem) {
  for (int bm = 64; bm >= 8; bm /= 2) {
    const long long fl =
        (long long)bm * (p->in_dim + p->dir_dim + 2 * p->width + FG_GROWS) +
        2LL * FG_KT * (FG_TILE / bm);
    if (fl * 4 <= FG_SMEM_MAX) {
      *smem = (int)(fl * 4);
      return bm;
    }
  }
  return 0;
}

static int fg_check(const FgParams* p, int n_points, bool pre) {
  if (!p || p->depth < 1 || p->depth > FG_MAX_DEPTH || p->skip < 0 ||
      p->skip + 1 == p->depth || p->width < 1 || p->view_width < 1 ||
      p->view_width > p->width || p->in_dim < 1 || p->dir_dim < 1 ||
      (p->out_extra != 0 && p->out_extra != 1) ||
      (p->bf16 != 0 && p->bf16 != 1) || n_points < 0 || n_points % 64 ||
      p->n_params < 1)
    return (int)cudaErrorInvalidValue;
  if (!pre && (p->multires < 0 || 3 * (1 + 2 * p->multires) > p->in_dim ||
               p->multires_views < 0 ||
               3 * (1 + 2 * p->multires_views) > p->dir_dim))
    return (int)cudaErrorInvalidValue;
  int smem;
  if (!fg_bm(p, &smem)) return (int)cudaErrorInvalidValue;
  return 0;
}

static void fg_plan(const FgParams* p, const FgLayout& L, FgPlan* plan) {
  plan->n_jobs = 0;
  plan->tiles = 0;
  auto add = [&](int a_off, int k, int g_off, int n, int job) {
    FgJob& j = plan->job[plan->n_jobs++];
    j.a_off = a_off;
    j.k = k;
    j.g_off = g_off;
    j.n = n;
    j.ntn = (n + FG_DT - 1) / FG_DT;
    j.tile0 = plan->tiles;
    j.w_off = p->gw[job];
    j.b_off = p->gb[job];
    plan->tiles += ((k + FG_DT - 1) / FG_DT) * j.ntn;
  };
  const bool sk = p->skip + 1 < p->depth;
  const int D = p->depth, W = p->width, VW = p->view_width;
  for (int i = 0; i < D; ++i) {
    const bool cat = sk && i == p->skip + 1;
    add(i == 0 || cat ? L.xe : L.h[i - 1],
        i == 0 ? p->in_dim : cat ? p->in_dim + W : W, L.gz[i], W, i);
  }
  add(L.h[D - 1], W, L.gfeat, W, D);                   // feature
  add(L.feat, W + p->dir_dim, L.gv, VW, D + 1);        // view, on [feat, d]
  add(L.v, VW, L.gin, 3, D + 2);                       // rgb
  add(L.h[D - 1], W, L.gin + 3, 1, D + 3);             // sigma
  if (p->out_extra) add(L.h[D - 1], W, L.gin + 4, 1, D + 4);   // semantic
}

// The points of a chunk: as few chunks as keep the scratch within
// FG_SCRATCH_BYTES, each a multiple of 64 points.
static int fg_chunk(const FgLayout& L, int n_points) {
  const long long row = (long long)L.cols * 4;
  for (int n = 1;; ++n) {
    const long long c = ((n_points + n - 1) / n + 63) / 64 * 64;
    if (c * row <= FG_SCRATCH_BYTES || c <= 64) return (int)c;
  }
}

// fg_dw_kernel's splits of a chunk of pc points (about FG_DW_BLOCKS blocks
// in all), each `per` points, a multiple of FG_PT.
static int fg_splits(const FgPlan& plan, int pc, int* per) {
  int s = (FG_DW_BLOCKS + plan.tiles - 1) / plan.tiles;
  if (s > pc / FG_PT) s = pc / FG_PT;
  if (s < 1) s = 1;
  int pp = (pc + s - 1) / s;
  pp = (pp + FG_PT - 1) / FG_PT * FG_PT;
  *per = pp;
  return (pc + pp - 1) / pp;
}

// sizes[0]: the scratch in f32 (one chunk), sizes[1]: the split partial
// sums in f64, sizes[2]: the sum over chunks in f64.
extern "C" int fg_sizes(const FgParams* p, int n_points, int pre,
                        long long* sizes) {
  const int err = fg_check(p, n_points, pre != 0);
  if (err) return err;
  if (n_points == 0) {
    sizes[0] = sizes[1] = sizes[2] = 0;
    return 0;
  }
  FgLayout L;
  fg_layout(*p, &L);
  FgPlan plan;
  fg_plan(p, L, &plan);
  const int chunk = fg_chunk(L, n_points);
  int per;
  const int splits = fg_splits(plan, chunk, &per);   // the most of any chunk
  sizes[0] = (long long)chunk * L.cols;
  sizes[1] = (long long)splits * p->n_params;
  sizes[2] = p->n_params;
  return 0;
}

template <bool PRE>
static int fg_fwd_launch(const FgParams* p, const void* in_x,
                         const void* in_d, void* out, int n_points,
                         void* stream) {
  int err = fg_check(p, n_points, PRE);
  if (err || n_points == 0) return err;
  if (!in_x || (PRE && !in_d) || !out) return (int)cudaErrorInvalidValue;
  int smem;
  const int bm = fg_bm(p, &smem);
  err = (int)cudaFuncSetAttribute(
      fg_fwd_kernel<PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  FgLayout L;
  fg_layout(*p, &L);
  fg_fwd_kernel<PRE><<<n_points / bm, FG_THREADS, smem,
                       (cudaStream_t)stream>>>(
      *p, L, bm, (const float*)in_x, (const float*)in_d, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int fg_fwd(const FgParams* p, const void* xd, void* out,
                      int n_points, void* stream) {
  return fg_fwd_launch<false>(p, xd, nullptr, out, n_points, stream);
}

extern "C" int fg_fwd_pre(const FgParams* p, const void* x_enc,
                          const void* d_enc, void* out, int n_points,
                          void* stream) {
  return fg_fwd_launch<true>(p, x_enc, d_enc, out, n_points, stream);
}

// grads: the flat f32 gradient buffer (p->n_params, every entry written);
// scratch, part, acc sized by fg_sizes. passes: 1 the backward kernels, 2
// the reductions (on the scratch the last pass 1 wrote), 3 both, chunk by
// chunk.
template <bool PRE>
static int fg_bwd_launch(const FgParams* p, const void* in_x,
                         const void* in_d, const void* g, void* grads,
                         void* dx, void* dd, void* scratch, void* part,
                         void* acc, int n_points, int passes, void* stream) {
  int err = fg_check(p, n_points, PRE);
  if (err || n_points == 0) return err;
  if (!in_x || (PRE && (!in_d || !dx || !dd)) || !g || !grads || !scratch ||
      !part || !acc || passes < 1 || passes > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FgLayout L;
  fg_layout(*p, &L);
  FgPlan plan;
  fg_plan(p, L, &plan);
  int smem;
  const int bm = fg_bm(p, &smem);
  err = (int)cudaFuncSetAttribute(
      fg_bwd_kernel<PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const int chunk = fg_chunk(L, n_points);
  for (int c0 = 0; c0 < n_points; c0 += chunk) {
    const int pc = n_points - c0 < chunk ? n_points - c0 : chunk;
    if (passes & 1) {
      fg_bwd_kernel<PRE><<<pc / bm, FG_THREADS, smem, s>>>(
          *p, L, bm, (const float*)in_x, (const float*)in_d,
          (const float*)g, (float*)dx, (float*)dd, (float*)scratch, pc, c0);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    if (passes & 2) {
      int per;
      const int splits = fg_splits(plan, pc, &per);
      fg_dw_kernel<<<dim3(plan.tiles, splits), FG_THREADS, 0, s>>>(
          plan, (const float*)scratch, pc, per, p->bf16, (double*)part,
          p->n_params);
      err = (int)cudaGetLastError();
      if (err) return err;
      fg_split_sum_kernel<<<(unsigned)((p->n_params + 255) / 256), 256, 0,
                            s>>>((const double*)part, splits, p->n_params,
                                 (double*)acc, c0 == 0,
                                 c0 + pc >= n_points, (float*)grads);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
  }
  return 0;
}

// --- the tensor-core backward's host side ---------------------------------

static void ft_dw_plan(const FgParams* p, const FgLayout& L, FtDwPlan* plan) {
  plan->n_jobs = 0;
  plan->tiles = 0;
  plan->cols = L.cols;
  auto add = [&](int a_off, int k, int g_off, int n, int job) {
    FtJob& j = plan->job[plan->n_jobs++];
    j.a_off = a_off;
    j.k = k;
    j.g_off = g_off;
    j.n = n;
    j.mp = (k + 2 * FT_T - 1) / (2 * FT_T);
    j.ntn = (n + FT_T - 1) / FT_T;
    j.tile0 = plan->tiles;
    j.w_off = p->gw[job];
    j.b_off = p->gb[job];
    plan->tiles += j.mp * j.ntn;
  };
  const bool sk = p->skip + 1 < p->depth;
  const int D = p->depth, W = p->width, VW = p->view_width;
  for (int i = 0; i < D; ++i) {
    const bool cat = sk && i == p->skip + 1;
    add(i == 0 || cat ? L.xe : L.h[i - 1],
        i == 0 ? p->in_dim : cat ? p->in_dim + W : W, L.gz[i], W, i);
  }
  add(L.h[D - 1], W, L.gfeat, W, D);                   // feature
  add(L.feat, W + p->dir_dim, L.gv, VW, D + 1);        // view, on [feat, d]
  add(L.v, VW, L.gin, 3, D + 2);                       // rgb
  add(L.h[D - 1], W, L.gin + 3, 1, D + 3);             // sigma
  if (p->out_extra) add(L.h[D - 1], W, L.gin + 4, 1, D + 4);   // semantic
}

// Pass 2's splits of a chunk of pc points (about FT_DW_ITEMS work items,
// tiles x splits, for the persistent blocks), each `per` points, a
// multiple of FT_T.
static int ft_splits(const FtDwPlan& plan, int pc, int* per) {
  int s = (FT_DW_ITEMS + plan.tiles - 1) / plan.tiles;
  if (s > pc / FT_T) s = pc / FT_T;
  if (s < 1) s = 1;
  int pp = (pc + s - 1) / s;
  pp = (pp + FT_T - 1) / FT_T * FT_T;
  *per = pp;
  return (pc + pp - 1) / pp;
}

template <bool PRE, int NP>
static int ft_bwd_launch(const FgParams* p, const FtGeom& G,
                         const void* in_x, const void* in_d, const void* g,
                         void* grads, void* dx, void* dd, void* scratch,
                         void* part, void* acc, const void* ring,
                         int n_points, int passes, cudaStream_t s) {
  FgLayout L;
  fg_layout(*p, &L);
  FtDwPlan dplan;
  ft_dw_plan(p, L, &dplan);
  int dev, sms;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      ft_bwd_kernel<PRE, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G.smem);
  if (err) return err;
  const int dw_smem = ft_dw_smem<NP>();
  err = (int)cudaFuncSetAttribute(
      ft_dw_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err) return err;
  const int chunk = fg_chunk(L, n_points);
  for (int c0 = 0; c0 < n_points; c0 += chunk) {
    const int pc = n_points - c0 < chunk ? n_points - c0 : chunk;
    if (passes & 1) {
      ft_bwd_kernel<PRE, NP><<<pc / FT_BM, FT_THREADS, G.smem, s>>>(
          *p, L, G, (const float*)in_x, (const float*)in_d, (const float*)g,
          (float*)dx, (float*)dd, (float*)scratch, c0, (const uint8_t*)ring);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    if (passes & 2) {
      int per;
      const int splits = ft_splits(dplan, pc, &per);
      const int items = dplan.tiles * splits;
      ft_dw_kernel<NP><<<items < sms ? items : sms, FT_DW_THREADS, dw_smem,
                         s>>>(dplan, (const float*)scratch, pc, per, splits,
                              p->bf16, (double*)part, p->n_params);
      err = (int)cudaGetLastError();
      if (err) return err;
      fg_split_sum_kernel<<<(unsigned)((p->n_params + 255) / 256), 256, 0,
                            s>>>((const double*)part, splits, p->n_params,
                                 (double*)acc, c0 == 0,
                                 c0 + pc >= n_points, (float*)grads);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
  }
  return 0;
}

// Check the arguments, plan, and launch pass 1, 2 or both (passes 1-3).
static int ft_bwd_entry(const FgParams* p, const void* in_x, const void* in_d,
                        const void* g, void* grads, void* dx, void* dd,
                        void* scratch, void* part, void* acc,
                        const void* ring, long long ring_bytes, int n_points,
                        int pre, int passes, void* stream) {
  int err = fg_check(p, n_points, pre != 0);
  if (err || n_points == 0) return err;
  FtGeom G;
  if (!ft_geom(p, pre, &G) ||
      ring_bytes != G.stages * G.np * FT_PLANE)
    return (int)cudaErrorInvalidValue;
  if (!in_x || (pre && (!in_d || !dx || !dd)) || !g || !grads || !scratch ||
      !part || !acc || !ring || passes < 1 || passes > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pre)
    return G.np == 3
               ? ft_bwd_launch<true, 3>(p, G, in_x, in_d, g, grads, dx, dd,
                                        scratch, part, acc, ring, n_points,
                                        passes, s)
               : ft_bwd_launch<true, 1>(p, G, in_x, in_d, g, grads, dx, dd,
                                        scratch, part, acc, ring, n_points,
                                        passes, s);
  return G.np == 3
             ? ft_bwd_launch<false, 3>(p, G, in_x, in_d, g, grads, dx, dd,
                                       scratch, part, acc, ring, n_points,
                                       passes, s)
             : ft_bwd_launch<false, 1>(p, G, in_x, in_d, g, grads, dx, dd,
                                       scratch, part, acc, ring, n_points,
                                       passes, s);
}

extern "C" int fg_bwd(const FgParams* p, const void* xd, const void* g,
                      void* grads, void* scratch, void* part, void* acc,
                      int n_points, void* stream) {
  return fg_bwd_launch<false>(p, xd, nullptr, g, grads, nullptr, nullptr,
                              scratch, part, acc, n_points, 3, stream);
}

// The pre-encoded backward (#8): also writes dx [P][in_dim] and dd
// [P][dir_dim], every entry.
extern "C" int fg_bwd_pre(const FgParams* p, const void* x_enc,
                          const void* d_enc, const void* g, void* grads,
                          void* dx, void* dd, void* scratch, void* part,
                          void* acc, int n_points, void* stream) {
  return fg_bwd_launch<true>(p, x_enc, d_enc, g, grads, dx, dd, scratch, part,
                             acc, n_points, 3, stream);
}

// One pass of either backward (pre: v1), for timing them apart.
extern "C" int fg_bwd_pass(const FgParams* p, const void* in_x,
                           const void* in_d, const void* g, void* grads,
                           void* dx, void* dd, void* scratch, void* part,
                           void* acc, int n_points, int pre, int pass,
                           void* stream) {
  if (pass != 1 && pass != 2) return (int)cudaErrorInvalidValue;
  return pre ? fg_bwd_launch<true>(p, in_x, in_d, g, grads, dx, dd, scratch,
                                   part, acc, n_points, pass, stream)
             : fg_bwd_launch<false>(p, in_x, nullptr, g, grads, nullptr,
                                    nullptr, scratch, part, acc, n_points,
                                    pass, stream);
}

// The tensor-core backward's plan for p (ft_geom): out = {taken (0 / 1),
// shared memory bytes, ring slots, weight stages, ring bytes, padded width,
// padded view width, parts}; ops/fused_mlp.py::gen_bwd_plan mirrors it.
extern "C" int fg_tc_plan(const FgParams* p, int pre, long long* out) {
  if (!p || !out) return (int)cudaErrorInvalidValue;
  FtGeom G;
  const int ok = ft_geom(p, pre, &G);
  out[0] = ok;
  out[1] = ok ? G.smem : 0;
  out[2] = ok ? G.slots : 0;
  out[3] = ok ? G.stages : 0;
  out[4] = ok ? G.stages * G.np * FT_PLANE : 0;
  out[5] = ok ? G.wp : 0;
  out[6] = ok ? G.vwp : 0;
  out[7] = ok ? G.np : 0;
  return 0;
}

// The tensor-core forward's plan for p (ft_fwd_geom; the same for v1 and
// v2, `pre` checked as fg_tc_plan's): out as fg_tc_plan's;
// ops/fused_mlp.py::gen_fwd_plan mirrors it.
extern "C" int fg_tc_fwd_plan(const FgParams* p, int pre, long long* out) {
  if (!p || !out || (pre != 0 && pre != 1)) return (int)cudaErrorInvalidValue;
  FtGeom G;
  const int ok = ft_fwd_geom(p, &G);
  out[0] = ok;
  out[1] = ok ? G.smem : 0;
  out[2] = ok ? G.slots : 0;
  out[3] = ok ? G.stages : 0;
  out[4] = ok ? G.stages * G.np * FT_PLANE : 0;
  out[5] = ok ? G.wp : 0;
  out[6] = ok ? G.vwp : 0;
  out[7] = ok ? G.np : 0;
  return 0;
}

template <bool PRE, int NP>
static int ft_fwd_launch(const FgParams* p, const FtGeom& G,
                         const void* in_x, const void* in_d, void* out,
                         const void* ring, int n_points, cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(
      ft_fwd_kernel<PRE, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G.smem);
  if (err) return err;
  ft_fwd_kernel<PRE, NP><<<n_points / FT_BM, FT_THREADS, G.smem, s>>>(
      *p, G, (const float*)in_x, (const float*)in_d, (float*)out,
      (const uint8_t*)ring);
  return (int)cudaGetLastError();
}

// Check the arguments and the plan, and launch the tensor-core forward.
// ring: gen_ring's forward stages, or its whole ring (ft_geom's stages:
// the ring a forward and its backward share), of ring_bytes.
static int ft_fwd_entry(const FgParams* p, const void* in_x,
                        const void* in_d, void* out, const void* ring,
                        long long ring_bytes, int n_points, int pre,
                        void* stream) {
  int err = fg_check(p, n_points, pre != 0);
  if (err || n_points == 0) return err;
  FtGeom G, B;
  if (!ft_fwd_geom(p, &G)) return (int)cudaErrorInvalidValue;
  const long long stage = (long long)G.np * FT_PLANE;
  if (ring_bytes != G.stages * stage &&
      !(ft_geom(p, pre, &B) && ring_bytes == B.stages * stage))
    return (int)cudaErrorInvalidValue;
  if (!in_x || (pre && !in_d) || !out || !ring)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pre)
    return G.np == 3 ? ft_fwd_launch<true, 3>(p, G, in_x, in_d, out, ring,
                                              n_points, s)
                     : ft_fwd_launch<true, 1>(p, G, in_x, in_d, out, ring,
                                              n_points, s);
  return G.np == 3 ? ft_fwd_launch<false, 3>(p, G, in_x, nullptr, out, ring,
                                             n_points, s)
                   : ft_fwd_launch<false, 1>(p, G, in_x, nullptr, out, ring,
                                             n_points, s);
}

// The tensor-core forward (v2, #9): raw [P][4 + e] f32 from xd [P][8], as
// fg_fwd.
extern "C" int fg_fwd_tc(const FgParams* p, const void* xd, void* out,
                         const void* ring, long long ring_bytes, int n_points,
                         void* stream) {
  return ft_fwd_entry(p, xd, nullptr, out, ring, ring_bytes, n_points, 0,
                      stream);
}

// The tensor-core forward (v1, #7), on the encodings, as fg_fwd_pre.
extern "C" int fg_fwd_tc_pre(const FgParams* p, const void* x_enc,
                             const void* d_enc, void* out, const void* ring,
                             long long ring_bytes, int n_points,
                             void* stream) {
  return ft_fwd_entry(p, x_enc, d_enc, out, ring, ring_bytes, n_points, 1,
                      stream);
}

// fg_sizes for the tensor-core backward: the same scratch and chunk sums,
// its own split count.
extern "C" int fg_tc_sizes(const FgParams* p, int n_points, int pre,
                           long long* sizes) {
  const int err = fg_check(p, n_points, pre != 0);
  if (err) return err;
  FtGeom G;
  if (!ft_geom(p, pre, &G)) return (int)cudaErrorInvalidValue;
  if (n_points == 0) {
    sizes[0] = sizes[1] = sizes[2] = 0;
    return 0;
  }
  FgLayout L;
  fg_layout(*p, &L);
  FtDwPlan plan;
  ft_dw_plan(p, L, &plan);
  const int chunk = fg_chunk(L, n_points);
  int per;
  const int splits = ft_splits(plan, chunk, &per);   // the most of any chunk
  sizes[0] = (long long)chunk * L.cols;
  sizes[1] = (long long)splits * p->n_params;
  sizes[2] = p->n_params;
  return 0;
}

// The tensor-core backward (v2, #10): ring is gen_ring's buffer of
// ring_bytes; the rest as fg_bwd.
extern "C" int fg_bwd_tc(const FgParams* p, const void* xd, const void* g,
                         void* grads, void* scratch, void* part, void* acc,
                         const void* ring, long long ring_bytes, int n_points,
                         void* stream) {
  return ft_bwd_entry(p, xd, nullptr, g, grads, nullptr, nullptr, scratch,
                      part, acc, ring, ring_bytes, n_points, 0, 3, stream);
}

// The tensor-core backward (v1, #8): also dx and dd, as fg_bwd_pre.
extern "C" int fg_bwd_tc_pre(const FgParams* p, const void* x_enc,
                             const void* d_enc, const void* g, void* grads,
                             void* dx, void* dd, void* scratch, void* part,
                             void* acc, const void* ring,
                             long long ring_bytes, int n_points,
                             void* stream) {
  return ft_bwd_entry(p, x_enc, d_enc, g, grads, dx, dd, scratch, part, acc,
                      ring, ring_bytes, n_points, 1, 3, stream);
}

// One pass of either tensor-core backward (pre: v1), for timing them apart.
extern "C" int fg_bwd_tc_pass(const FgParams* p, const void* in_x,
                              const void* in_d, const void* g, void* grads,
                              void* dx, void* dd, void* scratch, void* part,
                              void* acc, const void* ring,
                              long long ring_bytes, int n_points, int pre,
                              int pass, void* stream) {
  if (pass != 1 && pass != 2) return (int)cudaErrorInvalidValue;
  return ft_bwd_entry(p, in_x, in_d, g, grads, dx, dd, scratch, part, acc,
                      ring, ring_bytes, n_points, pre, pass, stream);
}

extern "C" const char* fg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
