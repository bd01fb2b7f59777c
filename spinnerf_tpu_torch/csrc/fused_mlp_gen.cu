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
// ms forward and 13.7 ms backward. This family uses no tensor core: it is
// the simple design that is right first (ROADMAP.md B2 holds its speed
// work: 3 x TF32 or wgmma for f32, width as a template parameter of the
// wgmma tiles for bf16).
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
// The backward, two kernels and a sum, as in the wgmma design. The weight
// gradient dW = A^T G sums over every point, which a block cannot finish:
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

extern "C" const char* fg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
