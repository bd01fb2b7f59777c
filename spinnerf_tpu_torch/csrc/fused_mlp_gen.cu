// The fused NeRF MLP at every compute type and geometry JAX's kernels take,
// on the tensor cores of Hopper (sm_90a): forward and backward of the v2
// pair (encoding in the kernel) and of the v1 pair (encodings given, input
// gradients returned).
//
// Replaces, beside csrc/fused_mlp_pe.cu (which stays the route at the one
// configuration its wgmma tiles take: bf16, depth 8, skip 4, width 256,
// view width 128, 128 / 128 encoding lanes, 10 / 4 octaves), the Pallas
// kernels of spinnerf_tpu/ops/fused_mlp.py:
//   v2 forward  _fwd_pe_kernel (:411; pallas_call :574)  fg_fwd_tc, fg_fwd_ls
//   v2 backward _bwd_pe_kernel (:424; pallas_call :616)  fg_bwd_tc, fg_bwd_ls
//   v1 forward  _fwd_kernel    (:106; pallas_call :248)  fg_fwd_tc_pre, ..._ls
//   v1 backward _bwd_kernel    (:115; pallas_call :294)  fg_bwd_tc_pre, ..._ls
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
// rounded to the compute type (bf16: __float2bfloat16_rn; the weights once
// a call as they are split into stages, the activations and gradients
// where the plain version rounds them); products and sums are f32 (a
// product of two bf16 values is exact in f32); f32 bias, ReLU, then the
// cast. The skip concat [x, h] feeds layer skip + 1 (a depth <= skip has
// none); the sigma (and semantic) head reads the last trunk output; then
// the feature layer, the view layer on [feat, d] and the rgb head. v2
// encodes with the full-range sinf and pi/2 added in f32, as fm_fwd_kernel
// does: never build with --use_fast_math. The bias gradients are sums over
// the bf16-rounded gradients in v2 and over the f32 ones in v1 (JAX's
// difference, which the plain backward versions keep). f32 runs as six
// exact bf16 products on wgmma (split2, the note above ft_k16).
//
// What bounds it on an H100: the products. At 8 x 256 the function needs
// 1.19 MFLOP a point forward and 3.49 backward (csrc/fused_mlp_pe.cu's
// note) against 32 bytes of input; at 8 x 1,024 (view width 512) 18.1 and
// 54.1 (54.3 with v1's input gradients). As six bf16 products at 989
// TFLOP/s, f32 at 8 x 1,024 bounds 262,144 points at 28.8 ms forward and
// 86.0 ms backward; bf16 at a sixth of that. Two routes, picked per
// direction from the dims alone before launch (ops/fused_mlp.py::
// gen_fwd_plan, gen_bwd_plan, gen_layer_plan; each geometry takes exactly
// one):
//
// - The fused tensor-core kernels (ft_fwd_kernel; ft_bwd_kernel, then
//   ft_dw_kernel): a block of 64 points keeps every activation of its
//   points in shared memory as f32 rows and walks the layers one after
//   another. wgmma needs 64 rows, so a block cannot take fewer points, and
//   its buffers (2 x 64 x 4 (wp + 8) bytes forward) cap the width: f32 to
//   256 forward and 512 backward with 128-lane encodings.
//
// - The layer-streamed kernels (ls_, every wider geometry: f32 8 x 512
//   forward, 8 x 1,024 both ways). No activation has to fit in shared
//   memory: each layer is one product [points x K] x [K x N] over a chunk
//   of points (ls_prod_kernel: 128 points x 128 columns a block, a
//   warpgroup each 64 points on m64n128k16 with both operands in shared
//   memory, K in 64-deep stages that a producer warp streams with three
//   bulk copies into an mbarrier ring). Between layers the activations lie
//   in device memory as the next product's operand: its bf16 parts (three
//   at f32, one at bf16), written by the previous layer's epilogue (bias,
//   ReLU, the rounding the plain version makes, then the split), so that
//   f32 stays six exact products and an activation is split once, not once
//   a tile. At f32 8 x 1,024 a layer's operand is 1.5 GiB for 262,144
//   points, in two buffers used in turn; a block reads its 128 points'
//   operand tiles once per 128 output columns (L2 serves the repeats: the
//   column tiles of one row tile are neighbours in the grid). Concat layers
//   are products over two segments. The heads (1-3 columns) are partial
//   sums in each column tile's epilogue, added in tile order by
//   ls_heads_kernel: no atomics. The backward's first pass runs the same
//   products (the recompute, then the back-propagation: G_feat, the last
//   trunk layer's G with the heads' terms, down the trunk; v1's dx and dd
//   as products of their own) and writes the scratch that ft_dw_kernel
//   reads (each layer's input A, the ReLU masks as the sign of a zero, each
//   layer's output gradient G, block-major); the second pass is
//   ft_dw_kernel's. What bounds it beyond the products: every k16 step
//   waits for its six products before adding them to the sum (a fresh
//   accumulator a step: the tensor core's accumulation truncates), a
//   stage's bytes (96 KB at f32) against 2 ring slots, and the operand
//   traffic through L2.
//
// Both backwards sum dW in a fixed order (f64 partial sums per split of the
// points, added in split and chunk order by fg_split_sum_kernel): two
// launches on the same inputs are bit-equal (the contract ROADMAP.md B1e
// gave #8 and #10). The scratch is P x cols f32, cols = in_dim + dir_dim +
// 2 (depth + 1) width + 2 view_width + 4 + out_extra: 5,124 columns at
// 8 x 256, 19,716 at width 1,024 (view 512); the points run in chunks of
// at most 4 GiB of it (FG_SCRATCH_BYTES): 2 chunks of 131,072 points at
// 8 x 256, 5 of 52,480 at width 1,024.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#define FG_MAX_DEPTH 32
#define FG_MAX_JOBS (FG_MAX_DEPTH + 5)
#define FG_MAX_WIDTH 2048          // the widest layer (GEN_LIMITS)
#define FG_SMEM_MAX 232448         // a block's shared memory on the H100
#define FG_SCRATCH_BYTES (4LL << 30)

// Bound from ops/fused_mlp.py (_FgParams), field for field. The heads'
// matrices are f32, rounded to the compute type (gen_heads): rgb_w
// [view_width][3], sigma_w and sem_w [width]; the biases are the f32
// weights as they are. The trunk, feature and view matrices come as bf16
// weight stages (gen_ring, gen_ls_ring). gw / gb: each gradient's element
// offset in the flat f32 gradient buffer (the weights' order), by job:
// trunk 0..depth-1, feat, view, rgb, sigma, sem.
struct FgParams {
  const float* tb[FG_MAX_DEPTH];
  const float* feat_b;
  const float* view_b;
  const float* rgb_w;
  const float* rgb_b;
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

// The backward's scratch columns (features). A layer's input is
// contiguous: the skip layer's [x, h_skip] and the view layer's [feat, d].
struct FgLayout {
  int cols;
  int xe, feat, de, v, gfeat, gv, gin;
  int h[FG_MAX_DEPTH];
  int gz[FG_MAX_DEPTH];
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
// The backward on the tensor cores (ft_bwd_kernel, ft_dw_kernel): a
// recompute and back-propagation pass and a weight-gradient pass, both as
// wgmma products, for every geometry whose buffers fit (ft_geom;
// ops/fused_mlp.py::gen_bwd_plan is its mirror and picks this backward or
// the layer-streamed one before launch).
//
// f32 as six bf16 products. Every f32 operand x splits into three bf16
// parts, hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid); each
// subtraction is exact and each part carries 8 significant bits, so hi +
// mid + lo == x for |x| >= 2^-100. x w is then lo.hi + mid.mid + hi.lo +
// mid.hi + hi.mid + hi.hi (x's part first), issued smallest first into
// one f32 accumulator; a product of two bf16 values is exact in f32 and the
// three dropped terms are below 2^-24 |x w|. At bf16 the operands are
// already bf16 (gen_ring rounds the weights; the activations and gradients
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
// warps). A tile's epilogue is the plain version's, element for element:
// bias, ReLU with the mask kept as the sign of a zero, the rounding, the
// scratch columns, dx and dd; the rgb head's gradient (3 columns) runs on
// the CUDA cores. A layer's output goes to the scratch only; once every tile is
// done the next product's input is read back from there into buf. The
// scratch holds fg_layout's columns block-major, [P / 64][cols][64] f32, so
// that a block writes and reads back one contiguous region and pass 2's
// stage of 64 points is contiguous (a column-major [cols][P] would scatter
// a block's accesses in 256-byte pieces over the whole chunk). Shared
// memory: slots x parts x 8 KB + 256 (wp + 8) + 256
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
// fit (the layer-streamed backward takes those).
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
// has more than 2 FT_FWD_TILES output tiles (the layer-streamed forward
// takes those).
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

// The tile's epilogue: the plain version's, element for element (column n of
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
// The forward on the tensor cores (ft_fwd_kernel): #9 gen and #7 gen, for
// every geometry ft_fwd_geom takes (ops/fused_mlp.py::gen_fwd_plan is its
// mirror and picks this forward or the layer-streamed one before launch).
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
// epilogue is the plain version's, element for element: bias, ReLU through
// act(z + b, bf, false), the rounding to the compute type (the feature
// layer without the ReLU), zero in the padding columns. The heads are f32
// FMAs on the CUDA cores: sigma (and the semantic logit) off the last trunk
// output, rgb off the view layer's. Shared memory: slots x parts x 8 KB + 512
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

// The forward's epilogue of a tile: the plain version's, element for
// element.
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
// The layer-streamed route (ls_ kernels): #9 / #10 and #7 / #8 gen at the
// geometries whose block buffers the ft_ kernels cannot hold (ls_geom takes
// a direction exactly where ft_fwd_geom / ft_geom refuse it;
// ops/fused_mlp.py::gen_layer_plan is its mirror). The design is in the
// note at the head of this file; in short, every layer is one product
// [points x K] x [K x N] over the whole chunk of points, launched on its
// own, and what one layer hands the next lies in device memory as the
// next product's bf16 operand parts.
//
// Operand buffers (ls_put8, ls_put2): [P / 64][kc][parts][64 x 64] bf16,
// kc = the buffer's lanes / 64, each [64 points][64 lanes] tile in the
// 128-byte swizzle (lane chunk c of point r at chunk c ^ (r % 8)), so that
// one bulk copy lands a 64-point stage of all its parts as wgmma reads A
// (K-major). The weight stages (gen_ls_ring): per product, per 128-column
// tile, per 64-deep chunk, [parts][128 N][64 K] in the same swizzle.
// ---------------------------------------------------------------------------

#define LS_BM 128                   // points a block: two warpgroups of 64
#define LS_BN 128                   // output columns a block (m64n128k16)
#define LS_T 64                     // a stage's depth; an operand tile's side
#define LS_CONSUMERS 256            // two consumer warpgroups
#define LS_THREADS (LS_CONSUMERS + 32)   // and a producer warp
#define LS_APLANE 8192              // bytes of a bf16 [64][64] operand part
#define LS_BPLANE 16384             // bytes of a bf16 [128][64] weight part
#define LS_MIN_SLOTS 2
#define LS_MAX_SLOTS 8
#define LS_MAX_PRODS (2 * FG_MAX_DEPTH + 8)
#define LS_HEADS 5                  // head partial sums a point and tile
#define LS_WORK_BYTES (4LL << 30)   // the forward's operand buffers, at most
#define LS_ENC_THREADS 256

// operand buffers: the encodings x and d, two for the layers in turn
enum { LS_BX, LS_BD, LS_BH0, LS_BH1, LS_NBUF };
// what a product's epilogue does with its sums
enum { LS_TRUNK, LS_FEAT, LS_VIEW, LS_GFEAT, LS_DD, LS_GTOP, LS_GTRUNK,
       LS_DX };

// One product: n output columns in ntn tiles of LS_BN, K in nk chunks of
// LS_T, the first nseg0 from operand buffer src0, the rest from src1 (the
// skip layer's [x, h], the view layer's [feat, d]); the epilogue writes the
// next product's operand to buffer dst (-1: none).
struct LsProd {
  int kind, layer, n, ntn, nk, nseg0, src0, src1, dst;
};

// A product's launch (ls_prod_kernel).
struct LsArgs {
  const uint8_t* a0;      // K's first segment's operand buffer
  const uint8_t* a1;      // its second's (null: none)
  int akc0, akc1;         // their chunks (a 64-point block's tiles)
  int nseg0, nk, ntn, kind, layer, pre;
  const uint8_t* b;       // the product's weight stages
  uint8_t* dst;           // the operand buffer written (null: none)
  int dkc;                // its chunks
  float* scr;             // the chunk's scratch (null: the forward)
  float* hp;              // head partial sums [ntn][rows][LS_HEADS] or null
  long long rows;         // the chunk's points, padded to LS_BM
  int n_rows;             // its points
  long long p0;           // its first point (g, dx, dd)
  const float* g;
  float* dx;
  float* dd;
  int dx_add;             // dx += (the skip layer's part is in)
};

// d (+)= A B for one 16-deep step of m64n128k16, both from shared memory,
// K-major (as csrc/fused_mlp_pe.cu's wgmma_n128).
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One k16 step into a fresh accumulator: A's part q at sa + q LS_APLANE,
// B's at sb + q LS_BPLANE; at f32 ft_k16's six products, smallest first.
template <int NP>
__device__ __forceinline__ void ls_k16(float (&acc)[64], uint32_t sa,
                                       uint32_t sb) {
  auto A = [&](int q) { return desc_sw128(sa + q * LS_APLANE, 16, 1024); };
  auto B = [&](int q) { return desc_sw128(sb + q * LS_BPLANE, 16, 1024); };
  if constexpr (NP == 1) {
    wgmma_ss128(acc, A(0), B(0), 0);
  } else {
    wgmma_ss128(acc, A(2), B(0), 0);
    wgmma_ss128(acc, A(1), B(1), 1);
    wgmma_ss128(acc, A(0), B(2), 1);
    wgmma_ss128(acc, A(1), B(0), 1);
    wgmma_ss128(acc, A(0), B(1), 1);
    wgmma_ss128(acc, A(0), B(0), 1);
  }
}

// The byte offset of (point r of 64-point block blk, lane k) in an operand
// buffer of kc chunks, part 0; part q lies q LS_APLANE further.
template <int NP>
__device__ __forceinline__ long long ls_at(long long blk, int kc, int r,
                                           int k) {
  const int kk = k & 63;
  return (blk * kc + (k >> 6)) * NP * (long long)LS_APLANE +
         2 * (r * 64 + ((((kk >> 3) ^ (r & 7))) << 3) + (kk & 7));
}

// Lanes k, k + 1 (k even) of point r as their NP parts.
template <int NP>
__device__ __forceinline__ void ls_put2(uint8_t* buf, int kc, long long blk,
                                        int r, int k, float v0, float v1) {
  uint32_t o[NP];
  split2<NP>(make_float2(v0, v1), o);
  uint8_t* at = buf + ls_at<NP>(blk, kc, r, k);
#pragma unroll
  for (int q = 0; q < NP; ++q)
    *reinterpret_cast<uint32_t*>(at + q * LS_APLANE) = o[q];
}

// Lanes k .. k + 7 (k a multiple of 8) of point r: 16 bytes a part.
template <int NP>
__device__ __forceinline__ void ls_put8(uint8_t* buf, int kc, long long blk,
                                        int r, int k, const float (&v)[8]) {
  uint32_t w[NP][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t o[NP];
    split2<NP>(make_float2(v[2 * m], v[2 * m + 1]), o);
#pragma unroll
    for (int q = 0; q < NP; ++q) w[q][m] = o[q];
  }
  uint8_t* at = buf + ls_at<NP>(blk, kc, r, k);
#pragma unroll
  for (int q = 0; q < NP; ++q)
    *reinterpret_cast<uint4*>(at + q * LS_APLANE) =
        make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
}

// The encodings of a chunk's points (rows from p0; zero past n_rows, up to
// the padded `rows`) rounded to the compute type, into the operand buffers
// X and D and, with scr (the backward), the scratch columns xe / de (as
// ft_encode: v2 computes them, PRE reads them as given). A thread 8 lanes
// of one point, the points of a lane group side by side.
template <bool PRE, int NP>
__global__ void __launch_bounds__(LS_ENC_THREADS)
    ls_encode_kernel(const __grid_constant__ FgParams p,
                     const __grid_constant__ FgLayout L, const float* in_x,
                     const float* in_d, long long p0, int n_rows,
                     long long rows, uint8_t* X, uint8_t* Dd, float* scr) {
  const int gx = p.in_dim / 8, gd = p.dir_dim / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * (gx + gd)) return;
  const int grp = (int)(idx / rows);
  const long long row = idx - grp * rows;
  const bool isx = grp < gx;
  const int dim = isx ? p.in_dim : p.dir_dim;
  const int k0 = 8 * (isx ? grp : grp - gx);
  const long long q = p0 + row, blk = row / LS_T;
  const int r = (int)(row - blk * LS_T);
  const bool live = row < n_rows;
  float* col = scr && live ? scr + blk * L.cols * LS_T +
                                 (long long)((isx ? L.xe : L.de) + k0) *
                                     LS_T + r
                           : nullptr;
  float v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const int j = k0 + l;
    float x = 0.0f;
    if (live)
      x = rnd(PRE ? __ldg((isx ? in_x : in_d) + q * dim + j)
                  : pe_lane(in_x + q * 8 + (isx ? 0 : 3), j,
                            isx ? p.multires : p.multires_views),
              p.bf16);
    v[l] = x;
    if (col) col[l * LS_T] = x;
  }
  ls_put8<NP>(isx ? X : Dd, dim / LS_T, blk, r, k0, v);
}

// The backward's cotangent: as it is to the scratch columns gin (the
// heads' gradients), and G_v = (r(g_rgb) r(rgb_w)^T) * [v > 0] (3 deep, on
// the CUDA cores, as ft_bwd_kernel) to the scratch columns gv and, rounded,
// to the operand buffer H (its first vwp lanes of kc chunks). A thread 8
// columns of one point (a last group of threads the cotangent's columns).
template <int NP>
__global__ void __launch_bounds__(LS_ENC_THREADS)
    ls_gv_kernel(const __grid_constant__ FgParams p,
                 const __grid_constant__ FgLayout L, const float* g, int pre,
                 long long p0, int n_rows, long long rows, int vwp, int kc,
                 uint8_t* H, float* scr) {
  const int ng = vwp / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * (ng + 1)) return;
  const int grp = (int)(idx / rows);
  const long long row = idx - grp * rows;
  const long long q = p0 + row, blk = row / LS_T;
  const int r = (int)(row - blk * LS_T);
  const bool live = row < n_rows;
  const int no = 4 + p.out_extra, bf = p.bf16;
  float* sblk = scr + blk * L.cols * LS_T + r;
  if (grp == ng) {
    if (live)
      for (int c = 0; c < no; ++c)
        sblk[(long long)(L.gin + c) * LS_T] = __ldg(g + q * no + c);
    return;
  }
  float gs[3] = {0.0f, 0.0f, 0.0f};
  if (live)
    for (int c = 0; c < 3; ++c) gs[c] = rnd(__ldg(g + q * no + c), bf);
  const int n0 = 8 * grp;
  float v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const int n = n0 + l;
    float gv = 0.0f;
    if (live && n < p.view_width) {
      float a = 0.0f;
      for (int c = 0; c < 3; ++c)
        a = fmaf(gs[c], __ldg(p.rgb_w + n * 3 + c), a);
      gv = relu_grad(a, sblk[(long long)(L.v + n) * LS_T], pre != 0, bf);
      sblk[(long long)(L.gv + n) * LS_T] = gv;
    }
    v[l] = gv;
  }
  ls_put8<NP>(H, kc, blk, r, n0, v);
}

// The epilogue of a product's tile: column n of the sums at point r0 (+ 8)
// of 64-point block blk; every kind as ft_epi / ft_fwd_epi computes it,
// element for element, the heads' partial sums as fixed-order sums of the
// tile's columns.
template <int NP>
__device__ __forceinline__ void ls_epi(const FgParams& p, const FgLayout& L,
                                       const LsArgs& a, int tn, long long blk,
                                       const float (&sum)[64]) {
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * ((t >> 5) & 3) + (lane >> 2);
  const int bf = p.bf16, W = p.width, D = p.depth, no = 4 + p.out_extra;
  const int kind = a.kind, i = a.layer;
  const bool save = a.scr != nullptr, pre = a.pre != 0;
  float* sblk = save ? a.scr + blk * L.cols * LS_T : nullptr;
  const float* bias = kind == LS_TRUNK  ? p.tb[i]
                      : kind == LS_FEAT ? p.feat_b
                                        : p.view_b;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const long long row = blk * LS_T + r, q = a.p0 + row;
    const bool live = row < a.n_rows;
    float hs[3] = {0.0f, 0.0f, 0.0f};
    float gsig = 0.0f, gsem = 0.0f;
    if (kind == LS_GTOP && live) {
      gsig = rnd(__ldg(a.g + q * no + 3), bf);
      if (p.out_extra) gsem = rnd(__ldg(a.g + q * no + 4), bf);
    }
    auto at = [&](int c, int n) -> float& {
      return sblk[(long long)(c + n) * LS_T + r];
    };
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = LS_BN * tn + 8 * j + 2 * (lane & 3) + e;
        const float z = sum[4 * j + 2 * h + e];
        float o = 0.0f;
        if (kind == LS_TRUNK) {
          if (n < W) {
            o = act(z + __ldg(bias + n), bf, save);
            if (save && live) at(L.h[i], n) = o;
            if (a.hp) {
              hs[0] = fmaf(o, __ldg(p.sigma_w + n), hs[0]);
              if (p.out_extra) hs[1] = fmaf(o, __ldg(p.sem_w + n), hs[1]);
            }
          }
        } else if (kind == LS_FEAT) {
          if (n < W) {
            o = rnd(z + __ldg(bias + n), bf);
            if (save && live) at(L.feat, n) = o;
          }
        } else if (kind == LS_VIEW) {
          if (n < p.view_width) {
            o = act(z + __ldg(bias + n), bf, save);
            if (save && live) at(L.v, n) = o;
            if (a.hp) {
#pragma unroll
              for (int c = 0; c < 3; ++c)
                hs[c] = fmaf(o, __ldg(p.rgb_w + n * 3 + c), hs[c]);
            }
          }
        } else if (kind == LS_GFEAT) {
          if (n < W && live) {
            o = pre ? z : rnd(z, bf);
            at(L.gfeat, n) = o;
          }
        } else if (kind == LS_DD) {
          if (n < p.dir_dim && live) a.dd[q * p.dir_dim + n] = z;
        } else if (kind == LS_GTOP) {
          if (n < W && live) {
            float s = fmaf(gsig, __ldg(p.sigma_w + n), z);
            if (p.out_extra) s = fmaf(gsem, __ldg(p.sem_w + n), s);
            o = relu_grad(s, at(L.h[D - 1], n), pre, bf);
            at(L.gz[D - 1], n) = o;
          }
        } else if (kind == LS_GTRUNK) {
          if (n < W && live) {
            o = relu_grad(z, at(L.h[i - 1], n), pre, bf);
            at(L.gz[i - 1], n) = o;
          }
        } else {   // LS_DX: the encoding's part of layer i's input gradient
          if (n < p.in_dim && live) {
            float* d = a.dx + q * p.in_dim + n;
            *d = a.dx_add ? *d + z : z;
          }
        }
        v[e] = o;
      }
      const int n0 = LS_BN * tn + 8 * j + 2 * (lane & 3);
      if (a.dst && n0 < a.dkc * LS_T)
        ls_put2<NP>(a.dst, a.dkc, blk, r, n0, v[0], v[1]);
    }
    if (a.hp) {   // the row's 4 threads, in a fixed order
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        hs[c] += __shfl_xor_sync(0xFFFFFFFFu, hs[c], 1);
        hs[c] += __shfl_xor_sync(0xFFFFFFFFu, hs[c], 2);
      }
      if ((lane & 3) == 0) {
        float* d = a.hp + ((long long)tn * a.rows + row) * LS_HEADS;
        if (kind == LS_VIEW) {
          d[0] = hs[0];
          d[1] = hs[1];
          d[2] = hs[2];
        } else {
          d[3] = hs[0];
          if (p.out_extra) d[4] = hs[1];
        }
      }
    }
  }
}

// One product over a chunk: a block computes 128 points (a warpgroup each
// 64) x 128 columns (tile tn of blockIdx.x % ntn) over the whole K, its
// stages streamed by the producer warp's first thread (three bulk copies a
// stage: each warpgroup's operand tiles, the weight stage) into a ring of
// `slots`; each k16 step's products in a fresh accumulator added to an f32
// sum (the tensor core's accumulation truncates; ft_chunk's note). Two
// other schedules were measured on the H100 (f32 / bf16 8 x 1,024,
// 262,144 points, against this one's 88.5 / 40.2 ms forward): each k16
// step split into two 64-column halves (m64n64k16) with two accumulators
// in turn, so that the tensor cores run while the threads add, took 1.19x
// at f32 (105.5 ms: the smaller products read A twice from shared memory);
// bf16 with the whole K in one accumulator took 0.84x (33.6 ms) but its
// truncation moved 16,578 of 65,536 points' ReLU masks off float64's
// (the plain bf16 version's 5,321) and failed phase 20's gates.
template <int NP>
__global__ void __launch_bounds__(LS_THREADS, 1)
    ls_prod_kernel(const __grid_constant__ FgParams p,
                   const __grid_constant__ FgLayout L,
                   const __grid_constant__ LsArgs a, int slots) {
  extern __shared__ uint8_t ls_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      ((uintptr_t)ls_raw + FT_ALIGN - 1) & ~(uintptr_t)(FT_ALIGN - 1));
  constexpr uint32_t AB = NP * LS_APLANE, BB = NP * LS_BPLANE;
  constexpr uint32_t ST = 2 * AB + BB;
  const uint32_t ring_s = smem_u32(base);
  const uint32_t full = ring_s + slots * ST, empty = full + 8 * slots;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tn = (int)(blockIdx.x % a.ntn);
  const long long rb = blockIdx.x / a.ntn;   // points LS_BM rb ..
  if (t >= LS_CONSUMERS) {
    if (t != LS_CONSUMERS) return;
    for (int kc = 0; kc < a.nk; ++kc) {
      const int slot = kc % slots;
      if (kc >= slots) mbar_wait(empty + 8 * slot, ((kc / slots) - 1) & 1);
      const uint32_t dst = ring_s + slot * ST, bar = full + 8 * slot;
      mbar_expect(bar, ST);
      const bool s1 = kc >= a.nseg0;
      const int akc = s1 ? a.akc1 : a.akc0;
      const uint8_t* src = (s1 ? a.a1 : a.a0) +
                           ((2 * rb) * akc + (s1 ? kc - a.nseg0 : kc)) *
                               (long long)AB;
      bulk_g2s(dst, src, AB, bar);
      bulk_g2s(dst + AB, src + (long long)akc * AB, AB, bar);
      bulk_g2s(dst + 2 * AB, a.b + ((long long)tn * a.nk + kc) * BB, BB,
               bar);
    }
    return;
  }
  const int wg = t >> 7, lane = t & 31;
  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
  for (int kc = 0; kc < a.nk; ++kc) {
    const int slot = kc % slots;
    mbar_wait(full + 8 * slot, (kc / slots) & 1);
    const uint32_t sa = ring_s + slot * ST + wg * AB;
    const uint32_t sb = ring_s + slot * ST + 2 * AB;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float acc[64];
      wg_fence();
      ls_k16<NP>(acc, sa + ks * 32, sb + ks * 32);
      wg_commit();
      wg_wait0();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }
  ls_epi<NP>(p, L, a, tn, 2 * rb + wg, sum);
}

// The forward's heads: raw [P][4 + e] from the partial sums of the view
// layer's tiles (rgb, columns 0-2) and of the last trunk layer's (sigma,
// the semantic logit), each added in tile order, then the bias.
__global__ void ls_heads_kernel(const __grid_constant__ FgParams p,
                                const float* hp, long long rows, int n_rows,
                                int ntn_t, int ntn_v, float* out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int no = 4 + p.out_extra;
  for (int c = 0; c < no; ++c) {
    const int nt = c < 3 ? ntn_v : ntn_t;
    float s = 0.0f;
    for (int k = 0; k < nt; ++k)
      s += hp[((long long)k * rows + row) * LS_HEADS + c];
    const float b = c < 3 ? __ldg(p.rgb_b + c)
                          : __ldg(c == 3 ? p.sigma_b : p.sem_b);
    out[row * no + c] = s + b;
  }
}

// ---------------------------------------------------------------------------
// C interface, bound with ctypes. Pointers are device pointers except the
// struct, which is host memory. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// the kernels do not take).
// ---------------------------------------------------------------------------

// The arguments every generic kernel takes (GEN_LIMITS); P a multiple of
// 64.
static int fg_check(const FgParams* p, int n_points, bool pre) {
  if (!p || p->depth < 1 || p->depth > FG_MAX_DEPTH || p->skip < 0 ||
      p->skip + 1 == p->depth || p->width < 8 || p->width > FG_MAX_WIDTH ||
      p->view_width < 1 || p->view_width > p->width || p->in_dim < 64 ||
      p->in_dim > 256 || p->in_dim % 64 || p->dir_dim < 64 ||
      p->dir_dim > 256 || p->dir_dim % 64 ||
      (p->out_extra != 0 && p->out_extra != 1) ||
      (p->bf16 != 0 && p->bf16 != 1) || n_points < 0 || n_points % 64 ||
      p->n_params < 1)
    return (int)cudaErrorInvalidValue;
  if (!pre && (p->multires < 0 || 3 * (1 + 2 * p->multires) > p->in_dim ||
               p->multires_views < 0 ||
               3 * (1 + 2 * p->multires_views) > p->dir_dim))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The points of a chunk of the backward: as few chunks as keep the scratch
// within FG_SCRATCH_BYTES, each a multiple of 64 points.
static int fg_chunk(const FgLayout& L, int n_points) {
  const long long row = (long long)L.cols * 4;
  for (int n = 1;; ++n) {
    const long long c = ((n_points + n - 1) / n + 63) / 64 * 64;
    if (c * row <= FG_SCRATCH_BYTES || c <= 64) return (int)c;
  }
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

// --- the layer-streamed route's host side ---------------------------------

// The route's geometry for p, from the dims alone: its products (the
// forward's depth + 2, or with the back-propagation's), weight stages,
// ring slots and shared memory.
struct LsGeom {
  int np, wp, vwp, slots, smem, n_prods;
  long long stages;
  LsProd prod[LS_MAX_PRODS];
};

static int ls_smem(int np, int slots) {
  return slots * np * (2 * LS_APLANE + LS_BPLANE) + 16 * slots + FT_ALIGN;
}

// Every product of a backward, in launch order: the recompute (trunk
// 0..depth-1, the skip layer on [x, h]; feature; view on [feat, d]); then
// the back-propagation from G_v (ls_gv_kernel writes it to H0): G_feat,
// with pre dd, the last trunk layer's G, and down the trunk to layer 1,
// with pre the encoding's part of the skip layer's input gradient before
// it and of layer 0's at the end (dx). The layers alternate between H0
// and H1. Returns the count.
static int ls_products(const FgParams& p, int pre, int wp, int vwp,
                       LsProd* out) {
  const int D = p.depth, W = p.width, E = p.in_dim / LS_T, Wk = wp / LS_T;
  const int cat = p.skip + 1 < D ? p.skip + 1 : -1;
  int n = 0;
  auto add = [&](int kind, int layer, int cols, int s0, int k0, int s1,
                 int k1, int dst) {
    LsProd& r = out[n++];
    r.kind = kind;
    r.layer = layer;
    r.n = cols;
    r.ntn = (cols + LS_BN - 1) / LS_BN;
    r.nseg0 = k0;
    r.nk = k0 + (s1 >= 0 ? k1 : 0);
    r.src0 = s0;
    r.src1 = s1;
    r.dst = dst;
  };
  auto H = [](int i) { return LS_BH0 + (i & 1); };   // layer i's output
  for (int i = 0; i < D; ++i) {
    if (i == 0)
      add(LS_TRUNK, 0, W, LS_BX, E, -1, 0, H(0));
    else if (i == cat)
      add(LS_TRUNK, i, W, LS_BX, E, H(i - 1), Wk, H(i));
    else
      add(LS_TRUNK, i, W, H(i - 1), Wk, -1, 0, H(i));
  }
  add(LS_FEAT, 0, W, H(D - 1), Wk, -1, 0, H(D));
  add(LS_VIEW, 0, p.view_width, H(D), Wk, LS_BD, p.dir_dim / LS_T, -1);
  add(LS_GFEAT, 0, W, LS_BH0, vwp / LS_T, -1, 0, LS_BH1);
  if (pre) add(LS_DD, 0, p.dir_dim, LS_BH0, vwp / LS_T, -1, 0, -1);
  add(LS_GTOP, 0, W, LS_BH1, Wk, -1, 0, LS_BH0);
  auto G = [&](int i) { return LS_BH0 + ((D - 1 - i) & 1); };   // G_i
  for (int i = D - 1; i >= 1; --i) {
    if (pre && i == cat) add(LS_DX, i, p.in_dim, G(i), Wk, -1, 0, -1);
    add(LS_GTRUNK, i, W, G(i), Wk, -1, 0, G(i - 1));
  }
  if (pre) add(LS_DX, 0, p.in_dim, G(0), Wk, -1, 0, -1);
  return n;
}

// The geometry of the forward (`forward`) or the backward on this route;
// 0 where the ft_ kernels take that direction (ft_fwd_geom, ft_geom).
static int ls_geom(const FgParams* p, int pre, int forward, LsGeom* G) {
  FtGeom F;
  if (p->in_dim % LS_T || p->dir_dim % LS_T) return 0;
  if (forward ? ft_fwd_geom(p, &F) : ft_geom(p, pre, &F)) return 0;
  G->np = p->bf16 ? 1 : 3;
  G->wp = (p->width + LS_T - 1) / LS_T * LS_T;
  G->vwp = (p->view_width + LS_T - 1) / LS_T * LS_T;
  G->slots = 0;
  for (int s = LS_MAX_SLOTS; s >= LS_MIN_SLOTS && !G->slots; --s)
    if (ls_smem(G->np, s) <= FG_SMEM_MAX) G->slots = s;
  if (!G->slots) return 0;
  G->smem = ls_smem(G->np, G->slots);
  const int all = ls_products(*p, pre, G->wp, G->vwp, G->prod);
  G->n_prods = forward ? p->depth + 2 : all;
  G->stages = 0;
  for (int i = 0; i < G->n_prods; ++i)
    G->stages += (long long)G->prod[i].ntn * G->prod[i].nk;
  return 1;
}

// A chunk's operand buffers (X, D, H0, H1) and, in the forward, the head
// partial sums, at byte offsets of the work buffer.
struct LsWork {
  long long rows, off[LS_NBUF + 1], bytes;
  int lanes[LS_NBUF];
};

static long long ls_align(long long x) { return (x + 1023) / 1024 * 1024; }

static void ls_work(const FgParams& p, const LsGeom& G, long long chunk,
                    bool heads, LsWork* w) {
  w->rows = (chunk + LS_BM - 1) / LS_BM * LS_BM;
  w->lanes[LS_BX] = p.in_dim;
  w->lanes[LS_BD] = p.dir_dim;
  w->lanes[LS_BH0] = w->lanes[LS_BH1] = G.wp;
  long long o = 0;
  for (int b = 0; b < LS_NBUF; ++b) {
    w->off[b] = o;
    o = ls_align(o + w->rows * w->lanes[b] * 2LL * G.np);
  }
  w->off[LS_NBUF] = o;
  if (heads)
    o = ls_align(o + (long long)((p.width + LS_BN - 1) / LS_BN) * w->rows *
                         LS_HEADS * 4);
  w->bytes = o;
}

// The forward's chunk: as few as keep its work within LS_WORK_BYTES, each a
// multiple of 64 points.
static int ls_fwd_chunk(const FgParams& p, const LsGeom& G, int n_points) {
  for (int n = 1;; ++n) {
    const long long c = ((n_points + n - 1) / n + 63) / 64 * 64;
    LsWork w;
    ls_work(p, G, c, true, &w);
    if (w.bytes <= LS_WORK_BYTES || c <= 64) return (int)c;
  }
}

// One chunk of pc points from c0: the encodings, then each product of
// G (a forward's, with the heads, into out; or a backward's pass 1, into
// the scratch scr, with the cotangent and G_v before the back-propagation).
template <int NP>
static int ls_chunk(const FgParams* p, const FgLayout& L, const LsGeom& G,
                    int pre, bool fwd, const float* in_x, const float* in_d,
                    const float* g, float* out, float* dx, float* dd,
                    float* scr, const uint8_t* ring, uint8_t* work,
                    const LsWork& w, long long c0, int pc, cudaStream_t s) {
  uint8_t* buf[LS_NBUF];
  for (int b = 0; b < LS_NBUF; ++b) buf[b] = work + w.off[b];
  float* hp = fwd ? reinterpret_cast<float*>(work + w.off[LS_NBUF]) : nullptr;
  auto grid = [](long long n) { return (unsigned)((n + 255) / 256); };
  const long long n_enc = w.rows * ((p->in_dim + p->dir_dim) / 8);
  if (pre)
    ls_encode_kernel<true, NP><<<grid(n_enc), LS_ENC_THREADS, 0, s>>>(
        *p, L, in_x, in_d, c0, pc, w.rows, buf[LS_BX], buf[LS_BD], scr);
  else
    ls_encode_kernel<false, NP><<<grid(n_enc), LS_ENC_THREADS, 0, s>>>(
        *p, L, in_x, in_d, c0, pc, w.rows, buf[LS_BX], buf[LS_BD], scr);
  int err = (int)cudaGetLastError();
  if (err) return err;
  long long stage0 = 0;
  for (int pi = 0; pi < G.n_prods; ++pi) {
    const LsProd& pr = G.prod[pi];
    if (pi == p->depth + 2) {   // the cotangent, G_v into H0
      ls_gv_kernel<NP><<<grid(w.rows * (G.vwp / 8 + 1)), LS_ENC_THREADS, 0,
                         s>>>(*p, L, g, pre, c0, pc, w.rows, G.vwp,
                              w.lanes[LS_BH0] / LS_T, buf[LS_BH0], scr);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    LsArgs a = {};
    a.a0 = buf[pr.src0];
    a.akc0 = w.lanes[pr.src0] / LS_T;
    if (pr.src1 >= 0) {
      a.a1 = buf[pr.src1];
      a.akc1 = w.lanes[pr.src1] / LS_T;
    }
    a.nseg0 = pr.nseg0;
    a.nk = pr.nk;
    a.ntn = pr.ntn;
    a.kind = pr.kind;
    a.layer = pr.layer;
    a.pre = pre;
    a.b = ring + stage0 * NP * LS_BPLANE;
    if (pr.dst >= 0) {
      a.dst = buf[pr.dst];
      a.dkc = w.lanes[pr.dst] / LS_T;
    }
    a.scr = scr;
    if (fwd && (pr.kind == LS_VIEW ||
                (pr.kind == LS_TRUNK && pr.layer == p->depth - 1)))
      a.hp = hp;
    a.rows = w.rows;
    a.n_rows = pc;
    a.p0 = c0;
    a.g = g;
    a.dx = dx;
    a.dd = dd;
    a.dx_add = pr.kind == LS_DX && pr.layer == 0 && p->skip + 1 < p->depth;
    const long long blocks = (long long)pr.ntn * (w.rows / LS_BM);
    ls_prod_kernel<NP><<<(unsigned)blocks, LS_THREADS, G.smem, s>>>(
        *p, L, a, G.slots);
    err = (int)cudaGetLastError();
    if (err) return err;
    stage0 += (long long)pr.ntn * pr.nk;
  }
  if (fwd) {
    ls_heads_kernel<<<grid(pc), 256, 0, s>>>(
        *p, hp, w.rows, pc, (p->width + LS_BN - 1) / LS_BN,
        (p->view_width + LS_BN - 1) / LS_BN, out + c0 * (4 + p->out_extra));
    err = (int)cudaGetLastError();
  }
  return err;
}

// The route's plan for p (ls_geom): out = {taken (0 / 1), shared memory
// bytes, ring slots, weight stages, ring bytes, padded width, padded view
// width, parts, products}; ops/fused_mlp.py::gen_layer_plan mirrors it.
extern "C" int fg_ls_plan(const FgParams* p, int pre, int forward,
                          long long* out) {
  if (!p || !out || (pre != 0 && pre != 1)) return (int)cudaErrorInvalidValue;
  LsGeom G;
  const int ok = ls_geom(p, pre, forward, &G);
  out[0] = ok;
  out[1] = ok ? G.smem : 0;
  out[2] = ok ? G.slots : 0;
  out[3] = ok ? G.stages : 0;
  out[4] = ok ? G.stages * G.np * LS_BPLANE : 0;
  out[5] = ok ? G.wp : 0;
  out[6] = ok ? G.vwp : 0;
  out[7] = ok ? G.np : 0;
  out[8] = ok ? G.n_prods : 0;
  return 0;
}

// sizes: [0] the backward's scratch in f32 (one chunk), [1] its split
// partial sums in f64, [2] the sum over chunks in f64 (as fg_tc_sizes; 0
// for a forward), [3] the work buffer's bytes (operand buffers, head
// partial sums).
extern "C" int fg_ls_sizes(const FgParams* p, int n_points, int pre,
                           int forward, long long* sizes) {
  const int err = fg_check(p, n_points, pre != 0);
  if (err) return err;
  LsGeom G;
  if (!sizes || !ls_geom(p, pre, forward, &G))
    return (int)cudaErrorInvalidValue;
  sizes[0] = sizes[1] = sizes[2] = sizes[3] = 0;
  if (n_points == 0) return 0;
  LsWork w;
  if (forward) {
    ls_work(*p, G, ls_fwd_chunk(*p, G, n_points), true, &w);
    sizes[3] = w.bytes;
    return 0;
  }
  FgLayout L;
  fg_layout(*p, &L);
  FtDwPlan plan;
  ft_dw_plan(p, L, &plan);
  const int chunk = fg_chunk(L, n_points);
  int per;
  const int splits = ft_splits(plan, chunk, &per);   // the most of any chunk
  ls_work(*p, G, chunk, false, &w);
  sizes[0] = (long long)chunk * L.cols;
  sizes[1] = (long long)splits * p->n_params;
  sizes[2] = p->n_params;
  sizes[3] = w.bytes;
  return 0;
}

template <int NP>
static int ls_fwd_launch(const FgParams* p, const LsGeom& G,
                         const void* in_x, const void* in_d, void* out,
                         const void* ring, void* work, int n_points, int pre,
                         cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(
      ls_prod_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G.smem);
  if (err) return err;
  FgLayout L;
  fg_layout(*p, &L);
  const int chunk = ls_fwd_chunk(*p, G, n_points);
  LsWork w;
  ls_work(*p, G, chunk, true, &w);
  for (int c0 = 0; c0 < n_points; c0 += chunk) {
    const int pc = n_points - c0 < chunk ? n_points - c0 : chunk;
    err = ls_chunk<NP>(p, L, G, pre, true, (const float*)in_x,
                       (const float*)in_d, nullptr, (float*)out, nullptr,
                       nullptr, nullptr, (const uint8_t*)ring,
                       (uint8_t*)work, w, c0, pc, s);
    if (err) return err;
  }
  return 0;
}

// The layer-streamed forward (#9 / #7 gen with pre): raw [P][4 + e] f32
// from xd [P][8] or from the encodings. ring: gen_ls_ring's forward stages
// or its backward's whole ring (whose first stages they are); work:
// fg_ls_sizes' bytes.
extern "C" int fg_fwd_ls(const FgParams* p, const void* in_x,
                         const void* in_d, void* out, const void* ring,
                         long long ring_bytes, void* work,
                         long long work_bytes, int n_points, int pre,
                         void* stream) {
  int err = fg_check(p, n_points, pre != 0);
  if (err || n_points == 0) return err;
  LsGeom G, B;
  if (!ls_geom(p, pre, 1, &G)) return (int)cudaErrorInvalidValue;
  const long long stage = (long long)G.np * LS_BPLANE;
  if (ring_bytes != G.stages * stage &&
      !(ls_geom(p, pre, 0, &B) && ring_bytes == B.stages * stage))
    return (int)cudaErrorInvalidValue;
  LsWork w;
  ls_work(*p, G, ls_fwd_chunk(*p, G, n_points), true, &w);
  if (!in_x || (pre && !in_d) || !out || !ring || !work ||
      work_bytes < w.bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return G.np == 3 ? ls_fwd_launch<3>(p, G, in_x, in_d, out, ring, work,
                                      n_points, pre, s)
                   : ls_fwd_launch<1>(p, G, in_x, in_d, out, ring, work,
                                      n_points, pre, s);
}

template <int NP>
static int ls_bwd_launch(const FgParams* p, const LsGeom& G,
                         const void* in_x, const void* in_d, const void* g,
                         void* grads, void* dx, void* dd, void* scratch,
                         void* part, void* acc, void* work, const void* ring,
                         int n_points, int pre, int passes, cudaStream_t s) {
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
      ls_prod_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G.smem);
  if (err) return err;
  const int dw_smem = ft_dw_smem<NP>();
  err = (int)cudaFuncSetAttribute(
      ft_dw_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err) return err;
  const int chunk = fg_chunk(L, n_points);
  LsWork w;
  ls_work(*p, G, chunk, false, &w);
  for (int c0 = 0; c0 < n_points; c0 += chunk) {
    const int pc = n_points - c0 < chunk ? n_points - c0 : chunk;
    if (passes & 1) {
      err = ls_chunk<NP>(p, L, G, pre, false, (const float*)in_x,
                         (const float*)in_d, (const float*)g, nullptr,
                         (float*)dx, (float*)dd, (float*)scratch,
                         (const uint8_t*)ring, (uint8_t*)work, w, c0, pc, s);
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

// The layer-streamed backward (#10 / #8 gen with pre: also dx [P][in_dim]
// and dd [P][dir_dim], every entry): pass 1 (passes & 1) the recompute and
// the back-propagation into the scratch, pass 2 (passes & 2) ft_dw_kernel's
// weight gradients into grads (every entry written), chunk by chunk; ring:
// gen_ls_ring's; scratch, part, acc, work: fg_ls_sizes'.
extern "C" int fg_bwd_ls(const FgParams* p, const void* in_x,
                         const void* in_d, const void* g, void* grads,
                         void* dx, void* dd, void* scratch, void* part,
                         void* acc, void* work, long long work_bytes,
                         const void* ring, long long ring_bytes, int n_points,
                         int pre, int passes, void* stream) {
  int err = fg_check(p, n_points, pre != 0);
  if (err || n_points == 0) return err;
  LsGeom G;
  if (!ls_geom(p, pre, 0, &G) ||
      ring_bytes != G.stages * G.np * LS_BPLANE)
    return (int)cudaErrorInvalidValue;
  FgLayout L;
  fg_layout(*p, &L);
  LsWork w;
  ls_work(*p, G, fg_chunk(L, n_points), false, &w);
  if (!in_x || (pre && (!in_d || !dx || !dd)) || !g || !grads || !scratch ||
      !part || !acc || !work || work_bytes < w.bytes || !ring ||
      passes < 1 || passes > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return G.np == 3
             ? ls_bwd_launch<3>(p, G, in_x, in_d, g, grads, dx, dd, scratch,
                                part, acc, work, ring, n_points, pre, passes,
                                s)
             : ls_bwd_launch<1>(p, G, in_x, in_d, g, grads, dx, dd, scratch,
                                part, acc, work, ring, n_points, pre, passes,
                                s);
}

extern "C" const char* fg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}