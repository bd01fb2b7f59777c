// Fused positional encoding + 8x256 NeRF MLP for Hopper (sm_90a): the
// forward, and the backward that returns the weight gradients.
//
// Replaces the Pallas kernels of spinnerf_tpu/ops/fused_mlp.py:
//   forward  _fwd_pe_kernel (:411; pallas_call :574) with _forward_block (:55)
//   backward _bwd_pe_kernel (:424; pallas_call :616)
// It computes what fused_mlp_pe_plain in ops/fused_mlp.py computes: the
// encoding sin(x * 2^f + phase) in f32 (phase pi/2 for the cos lanes, added
// in f32 as the TPU kernel does), bf16 operands with f32 accumulation, f32
// bias, ReLU and a cast to bf16 after every layer, the skip concat [x, h]
// feeding layer skip+1, the sigma (and semantic) head off the trunk, the
// feature layer, the view layer on [feat, dir] and the rgb head.
//
// What bounds it on an H100: arithmetic. The function needs 1.19 MFLOP a
// point forward and 3.49 MFLOP backward (recompute, weight gradients,
// gradients of the activations), counted at the encodings' unpadded widths
// (63 and 27 lanes; the kernels also multiply the zero padding up to 128),
// against 32 bytes of input, so the bound is the tensor-core rate. The
// tensor core's accumulator rounds toward zero, so the backward's kernels
// take each partial product of at most 64 terms in a fresh accumulator and
// add it to an f32 running sum in registers (the forward's error stays
// within its gate without that fold). sinf is the full-range libm sine:
// arguments reach 2^9 * |x|. Never build with --use_fast_math.
//
// fm_fwd_kernel and fm_bwd_kernel share one machinery. One block of 384
// threads owns 64 points: two consumer warpgroups, each computing 128 of
// the 256 output columns (64 of 128) of every product with wgmma
// m64n128k16 (m64n64k16), and a producer warpgroup of which one thread
// works. Every trunk, feature and view product reads A (the block's bf16
// activations, or in the backward its gradients) and B (a 64-deep weight
// stage, [N][64], K contiguous) from shared memory in the 128-byte swizzle.
// The producer streams the stages, which pack_ring lays out pre-swizzled,
// contiguous and in the order the backward consumes them, with
// cp.async.bulk into a ring of 32 KB slots; a full mbarrier a slot counts
// their bytes and an empty one the 8 consumer warps' releases, so no
// consumer waits on a block-wide barrier inside a K loop. Activations live
// in one buffer: a layer's output is written over its input once both
// warpgroups are done with their products (a named barrier). The heads
// (1-3 columns) run on the CUDA cores.
// Registers: ptxas gives a thread 168 (65,536 / 384). In the backward,
// setmaxnreg moves the producer warpgroup to 24 and the consumers to 240 at
// run time, but the consumers' code is allocated within the 168. A
// backward consumer holds a 64-float accumulator and the 64-float running
// sum, with no spills; a second accumulator, to overlap a stage's fold with
// the next stage's product, spilled and ran slower.
//
// The forward (fm_fwd_kernel) multiplies 1.28 MFLOP a point at its padded
// widths (3.35e11 FLOP at P = 262,144: 0.34 ms at 989 TFLOP/s). Its weights
// are the first 42 stages of the backward's ring (the trunk, feature and
// view products: ring_schedule with fwd), 1,248 KB that every block streams
// from L2, 5.2 GB at P = 262,144. With one block of 8 consumer warps an SM,
// what does not overlap the products bounds it: the block's encoding (v2
// takes 84 full-range sines a point), each layer's epilogue and its
// barriers. What the design does about that:
// - fw_product takes no fold: a layer's whole K accumulates in the tensor
//   core, and each stage is issued before the previous one is waited on,
//   so the stages follow each other without a gap. The output stays within
//   twice the plain f32 version's error against float64 (chip_smoke.py
//   phases 6 and 11 hold it there). The backward's recompute keeps the
//   fold, so its activations are not bit-equal to the forward's: the two
//   sum the same bf16 products in another order, and a ReLU mask can
//   differ only where a pre-activation lies within that rounding of 0
//   (ROADMAP.md queue C);
// - the producer warp streams from the block's start, while the other 11
//   warps (the consumers and the producer warpgroup's three idle warps)
//   encode; no setmaxnreg, which made no difference here.
// The sigma and semantic heads read the last trunk output before the
// feature's epilogue overwrites it, the rgb head the view output, four
// threads a point; each point's raw [4 + e] f32 is written once. Shared
// memory (bytes): encodings 2 x 16,384 (the x encoding later v), the
// activation buffer 32,768, the ring 4 x 32,768, barriers 64: 196,672, and
// 1,024 to align the swizzle, of 232,448. A block of 128 points would halve
// the ring's L2 traffic and let one warpgroup's epilogue overlap the
// other's products, but its encodings and activations (128 KB) leave room
// for 3 slots only.
//
// The backward, two kernels. The weight gradient dW = A^T G sums over every
// point, which a block of 64 points cannot finish, so fm_bwd_kernel
// recomputes the forward and back-propagates per block, and writes each
// layer's input activations A and output gradients G to a scratch;
// fm_dw_kernel then reduces A^T G over the points.
// - fm_bwd_kernel is bound by operations: 2.39 MFLOP a point at the widths
//   it multiplies (627 GFLOP at P = 262,144: 0.63 ms at 989 TFLOP/s). Its
//   ring has 4 slots. Each layer's A or G tile leaves with one bulk store
//   (shared -> device) issued after its epilogue, which overlaps the next
//   layer's products; the buffer is rewritten only once the store has read
//   it (cp.async.bulk.wait_group.read). The ReLU masks stay as bits in
//   shared memory, read back by the thread that wrote them. Sigma's and the
//   semantic head's weight gradients read the last trunk output before the
//   feature overwrites it.
//   Shared memory (bytes): encodings 2 x 16,384 (later v and g_v), the
//   activation buffer 32,768, the ring 4 x 32,768, cotangent 2,048,
//   barriers 64, the PRE path's column sums 4,096, ReLU bits (depth + 1) x
//   2,048 = 18,432 at depth 8: 221,248, and 1,024 to align the swizzle, of
//   232,448.
//   Measured and left out on the H100: clusters of 2 or 4 blocks sharing
//   each stage by multicast bulk copies (the same time or slower: the
//   weights' L2 traffic does not bound this kernel), and a 3-slot ring with
//   two activation buffers (slower).
// - The scratch holds, per block of 64 points, the tiles [f / 64][64 points]
//   [64] bf16 of its fa columns of A and fg of G (fm_layout), each tile in
//   the 128-byte swizzle: the shared tiles byte for byte, so that an export
//   is one bulk copy. act is P x fa and grad P x fg bf16, 2.7 GB at
//   P = 262,144 (fa 2,688, fg 2,432).
// - fm_dw_kernel is bound by bytes: reading the scratch once takes 2.68 GB
//   / 3.35 TB/s = 0.80 ms. A block takes 64 inputs of one layer and its
//   whole output width (256, or 128 for the view layer), so a layer's A is
//   read once; its G tile is read by the layer's K / 64 blocks of the same
//   slice of points, which run side by side and meet it in L2. The producer
//   streams chunks of 64 points (an 8 KB A tile and a 32 KB G tile) into a
//   ring of 4 slots; A^T and G are MN-major wgmma operands read straight from
//   the exported tiles; each chunk's product is folded into the f32 sum.
//   Split-K over points, sized to whole waves of one block an SM; each
//   split writes its partial sums to scratch (below). The v2 bias
//   gradients, the column sums of the bf16 G, come in the same pass: the
//   layer's blocks of one slice of points each sum their share of the
//   columns. 288 threads (two consumer warpgroups and a producer warp), 168
//   registers, no spills.
// - A wait on a ring barrier that lasts 2^32 clocks traps: a fault of the
//   schedule fails the launch instead of hanging the card.
//
// Sums in a fixed order, so that a launch's result depends on its inputs
// alone (two launches on the same inputs are bit-equal): the sums that a
// block or a split cannot finish go to scratch, and small kernels add them
// in a fixed order, as JAX's kernel adds its grid steps in order:
// fm_dw_kernel's splits (dwpart [split][layer record: k x n weights, then
// n biases]) in split order (fm_split_sum_kernel), and fm_bwd_kernel's
// per-block head sums (hpart [block][896]: sigma_w, sem_w, rgb_w; hpart64
// [block][8]: the heads' biases) and, with PRE, its per-block f64 bias
// sums (bpart64 [block][(depth + 2) x 256]) in block order (fm_rows_kernel:
// 32 slices of the blocks, each summed in order, then the slices in
// order). The scratch is splits x 0.64 M floats (56 MB at 262,144 points)
// and blocks x 904 values (15 MB); the backward measured within 2 % of the
// float atomics this replaced, whose order changed from run to run
// (PERF.md section 6).
//
// The same kernels, instantiated with PRE = true, also replace the v1 Pallas
// pair of spinnerf_tpu/ops/fused_mlp.py, which reads encodings computed
// outside the kernel and returns the input gradients as well:
//   forward  _fwd_kernel (:106; pallas_call :248)
//   backward _bwd_kernel (:115; pallas_call :294)
// (fused_mlp_fwd_plain / fused_mlp_bwd_plain in ops/fused_mlp.py). With PRE
// the block's encodings are read from x_enc / d_enc [P][128] f32 and rounded
// to bf16, and the backward adds what the v1 kernel returns besides the
// weight gradients: dx [P][128] = g_z0 W0^T + (g_z(skip+1) W(skip+1)^T)[:,
// :128] and dd [P][128] = (g_v view_w^T)[:, 256:], both f32, products of 128
// columns on m64n64k16 with their own weight stages. Each is written to
// device memory as soon as its product is done (the skip slice first, the
// layer-0 product added to it by the same thread), so no f32 tile stays
// resident beside the block's activations. The v1 kernel sums its bias
// gradients over f32 gradients (the v2 kernel over bf16-rounded ones), so
// with PRE the gradient epilogues sum their f32 columns per block in f64
// (bpart64, above), and fm_dw_kernel skips its bias pass. The padded input lanes
// of dx and dd are products with the weights' zero rows: exactly 0. The
// forward's ring prefix is the same with and without PRE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define FM_BM 64             // points per block
#define FM_W 256             // trunk width
#define FM_E 128             // padded encoding widths (in_dim, dir_dim)
#define FM_V 128             // view width
#define FM_KT 64             // depth of a weight stage
#define FM_MAX_DEPTH 16

// Biases (f32) and the bf16 weights, bound from ops/fused_mlp.py
// (_FmParams): the trunk, feature and view matrices as the stages of `ring`
// (pack_ring), the heads as they are (pack_weights).
struct FmParams {
  const float* tb[FM_MAX_DEPTH];  // [256]
  const float* feat_b;
  const float* view_b;
  const bf16* rgb_w;              // [128][3]
  const float* rgb_b;
  const bf16* sigma_w;            // [256]
  const float* sigma_b;
  const bf16* sem_w;              // [256] when out_extra
  const float* sem_b;
  int depth, skip, out_extra, multires, multires_views;
  const bf16* ring;               // the weight stages (pack_ring)
  long long ring_bytes;
};

// f32 weight gradients in the weights' own [in, out] layout (_FmGrads).
// The heads' bias gradients (rgb 0-2, sigma, semantic) are sums of the f32
// cotangent over all points, summed in f64 (head_b) so that their rounding
// stays below the f32 sum's. The PRE path also takes bias64 (f64 bias sums:
// trunk layer i at i * 256, the feature layer at depth * 256, the view
// layer at (depth + 1) * 256), dx and dd; the v2 path passes them null.
struct FmGrads {
  float* tw[FM_MAX_DEPTH];
  float* tb[FM_MAX_DEPTH];
  float *feat_w, *feat_b, *view_w, *view_b, *rgb_w, *sigma_w, *sem_w;
  double* head_b;
  double* bias64;
  float *dx, *dd;
  // the fixed-order sums' scratch (fm_partial_sizes); bpart64 with PRE only
  float* dwpart;
  float* hpart;
  double* hpart64;
  double* bpart64;
};

#define FM_HEADS (2 * FM_W + 3 * FM_V)   // hpart's row: sigma, sem, rgb

// Column offsets (in features; multiples of 64) of each activation and
// gradient in the backward's scratch. A layer's input is contiguous: the skip
// layer's [x, h_skip] and the view layer's [feat, dir].
struct FmLayout {
  int fa, fg;
  int h[FM_MAX_DEPTH];
  int xe, feat, de, v;
  int gz[FM_MAX_DEPTH];
  int gfeat, gv;
};

static void fm_layout(int depth, int skip, FmLayout* L) {
  const bool sk = skip + 1 < depth;
  int col = 0;
  for (int i = 0; i < depth; ++i) {
    if (sk && i == skip) { L->xe = col; col += FM_E; }
    L->h[i] = col;
    col += FM_W;
  }
  if (!sk) { L->xe = col; col += FM_E; }
  L->feat = col; col += FM_W;
  L->de = col; col += FM_E;
  L->v = col; col += FM_V;
  L->fa = col;
  for (int i = 0; i < depth; ++i) L->gz[i] = FM_W * i;
  L->gfeat = FM_W * depth;
  L->gv = L->gfeat + FM_W;
  L->fg = L->gv + FM_V;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bfr(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ldbf(const bf16* p) {
  return __bfloat162float(*p);
}

// The sum of s over the 8 lanes of a warp that share lane % 4: one column's
// sum over the warp's rows in the accumulator layout.
__device__ __forceinline__ float warp_col_sum(float s) {
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 4);
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 8);
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 16);
  return s;
}
// One lane of the positional encoding of x3 (3 floats) with nf octaves:
// [x, sin(x 2^0), cos(x 2^0), sin(x 2^1), ...], zero past 3 (1 + 2 nf).
// cos is sin(x 2^f + pi/2) with the f32 add, as the TPU kernel computes it.
__device__ __forceinline__ float pe_value(const float* x3, int j, int nf) {
  if (j < 3) return x3[j];
  if (j >= 3 * (1 + 2 * nf)) return 0.0f;
  const int k = j - 3, f = k / 6, r = k % 6;
  const float xb = x3[r % 3] * (float)(1 << f);  // exact: a power of two
  return sinf(r >= 3 ? __fadd_rn(xb, 1.57079637f) : xb);
}

// ---------------------------------------------------------------------------
// warpgroup MMA (wgmma) on 128-byte-swizzled tiles, weights through an
// asynchronous ring (see the note at the top)
// ---------------------------------------------------------------------------

#define BW_CONSUMERS 256                 // two consumer warpgroups
#define BW_THREADS (BW_CONSUMERS + 128)  // and a producer warpgroup
#define BW_PRODUCER_REGS 24              // setmaxnreg: 168 a thread at launch
#define BW_CONSUMER_REGS 240             // (65,536 / 384), then 24 and 240
#define DW_THREADS (BW_CONSUMERS + 32)   // fm_dw_kernel: one producer warp
#define BW_SLOTS 4                       // fm_bwd_kernel's weight ring
#define BW_SLOT_BYTES 32768              // one [256][64] bf16 stage
#define BW_MAX_STAGES 160
#define SW_TILE 4096                     // elements of a [64][64] tile
#define SMEM_ALIGN 1024                  // the swizzle repeats every 1024 bytes
#define SMEM_MAX 232448                  // a block's shared memory on the H100

// fm_bwd_kernel's shared memory, in bytes from a 1024-aligned base
#define SB_XE 0                          // x encoding [2][64][64]; later v
#define SB_DE 16384                      // dir encoding [2][64][64]; later g_v
#define SB_H 32768                       // [4][64][64] activations
#define SB_RING 65536
#define SB_GS (SB_RING + BW_SLOTS * BW_SLOT_BYTES)   // cotangent 64 x 8 f32
#define SB_BAR (SB_GS + FM_BM * 8 * 4)               // full[3], empty[3]
#define SB_CSUM (SB_BAR + 64)            // PRE: f32 column sums [4][256]
#define SB_MASK (SB_CSUM + 4 * FM_W * 4) // ReLU bits, 2 words a thread a layer
#define SB_END(depth) (SB_MASK + ((depth) + 1) * 2 * BW_CONSUMERS * 4)

// fm_fwd_kernel's: SB_XE (later v), SB_DE and SB_H as above, then a ring of
// FW_SLOTS slots at SB_RING and its full and empty barriers
#define FW_SLOTS 4
#define FW_ENCODERS (BW_THREADS - 32)    // all warps but the producer's
#define FW_BAR (SB_RING + FW_SLOTS * BW_SLOT_BYTES)
#define FW_SMEM (FW_BAR + FW_SLOTS * 16 + SMEM_ALIGN)
static_assert(FW_SMEM <= SMEM_MAX, "fm_fwd_kernel's ring does not fit");

// fm_dw_kernel's ring: a [64 points][64 inputs] A tile and a [64 points]
// [256 outputs] G tile a stage
#define DW_SLOTS 4
#define DW_A_BYTES (FM_BM * 64 * 2)
#define DW_SLOT_BYTES (DW_A_BYTES + FM_BM * FM_W * 2)
#define DW_BRED (DW_SLOTS * DW_SLOT_BYTES + 64)   // bias sums, 2,048 f32
#define DW_SMEM (DW_BRED + 8 * FM_W * 4 + SMEM_ALIGN)
#define DW_MAX_LAYERS (FM_MAX_DEPTH + 2)

// The weight stages in the order a kernel consumes them: kb[s] is the size
// of stage s in 16 KB ([128][64] bf16) units, 1 or 2 (ring_schedule).
struct BwRing {
  int n;
  unsigned char kb[BW_MAX_STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Element offset of (row, col) in a set of [64 rows][64] bf16 tiles, one
// tile for every 64 columns, each in the 128-byte swizzle: the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8). This is the layout wgmma reads
// K-major (rows = M or N, 64 K a row) and MN-major (rows = K), and the one
// pack_ring (ops/fused_mlp.py) gives the weight stages.
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * SW_TILE + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: lbo is the
// byte stride between 64-element atoms along M/N (MN-major), sbo between
// groups of 8 rows.
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
// keeps the compiler from reading accumulators before wg_wait0
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A B for one 16-deep step on m64nNWk16; T = 1 reads both operands
// MN-major, T = 0 K-major. scale_d = 0 starts a fresh accumulator.
template <int NW, int T>
__device__ __forceinline__ void wgmma_k16(float (&d)[NW / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (NW == 128)
    wgmma_n128<T, T>(d, da, db, scale_d);
  else
    wgmma_n64<T, T>(d, da, db, scale_d);
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
// Wait until the barrier's phase differs from `parity`. A wait that lasts
// 2^32 clocks (seconds) is a fault of the schedule: trap, so that the
// launch fails instead of hanging the card.
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
// device -> shared, completion counted in bytes on the barrier
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// shared -> device, one bulk group a call
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// every bulk store has read its shared source
__device__ __forceinline__ void bulk_wait_read0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, before wgmma or a bulk store reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the two consumer warpgroups (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(BW_CONSUMERS) : "memory");
}

// A ring of `nslots` stages in shared memory: a full barrier a slot
// (the producer's arrival and the bytes of its copies) and an empty one
// (one arrival for each consumer warp). Each thread keeps its own count s
// of the stages it has taken; parities follow from it.
struct Pipe {
  uint32_t base, full, empty;
  int nslots, slot_bytes, s;

  __device__ void init() const {
    for (int i = 0; i < nslots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, BW_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // producer: the slot of the next stage, once its consumers released it;
  // its full barrier then expects `bytes`
  __device__ int produce(uint32_t bytes) {
    const int slot = s % nslots;
    if (s >= nslots) mbar_wait(empty + 8 * slot, ((s / nslots) - 1) & 1);
    mbar_expect(full + 8 * slot, bytes);
    ++s;
    return slot;
  }
  // consumer: the slot of the stage k after the next one to release, once
  // it has arrived
  __device__ int acquire(int k = 0) const {
    const int st = s + k, slot = st % nslots;
    mbar_wait(full + 8 * slot, (st / nslots) & 1);
    return slot;
  }
  // a consumer warp is done with the stage
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (s % nslots));
    ++s;
  }
};

// The producer thread: the plan's stages, read one after another from src,
// each into the next slot of the ring.
__device__ __forceinline__ void stream_ring(const bf16* src_ring,
                                            const BwRing& plan, Pipe& ring) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_ring);
  for (int s = 0; s < plan.n; ++s) {
    const uint32_t bytes = plan.kb[s] * 16384u;
    const int slot = ring.produce(bytes);
    bulk_g2s(ring.base + slot * BW_SLOT_BYTES, src, bytes,
             ring.full + 8 * slot);
    src += bytes;
  }
}

// The consumer thread's place in an m64nNW accumulator: element
// 4j + 2h + e is row acc_row(h), column wg * NW + 8j + 2 (t % 4) + e.
__device__ __forceinline__ int acc_row(int h) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * h;
}

// Element offset, in a set of swizzled [64][64] tiles (swz), of this
// consumer thread's accumulator entries 4j + 2h (+ 1) of warpgroup wg's NW
// columns: row acc_row(h) keeps row % 8, so the chunk's XOR is fixed a
// thread.
template <int NW>
struct AccOff {
  int base, x;
  __device__ __forceinline__ AccOff() {
    const int t = threadIdx.x, r0 = acc_row(0);
    base = (t >> 7) * (NW / 64) * SW_TILE + r0 * 64 + 2 * (t & 3);
    x = (r0 & 7) << 3;
  }
  __device__ __forceinline__ int operator()(int j, int h) const {
    return base + (j >> 3) * SW_TILE + h * 512 + (((j & 7) << 3) ^ x);
  }
};

// sum[64 x NW] (this warpgroup's NW columns of 2 NW) = A B over nkb
// 64-deep stages. A: nkb [64][64] tiles, the first n0 at a0 and the rest at
// a1 (shared addresses). B: the ring's next nkb stages, [2 NW][64] each,
// this warpgroup's rows at wg * NW. Each stage's product is taken in a
// fresh accumulator and added to sum in f32. (Overlapping a stage's fold
// with the next stage's product takes a second accumulator, more registers
// than the 168 that ptxas gives a thread here: it spilled and ran slower.)
template <int NW>
__device__ __forceinline__ void bw_product(float (&sum)[NW / 2], uint32_t a0,
                                           int n0, uint32_t a1, int nkb,
                                           Pipe& ring) {
  const uint32_t boff = (threadIdx.x >> 7) * NW * 128;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) sum[i] = 0.0f;
  for (int kb = 0; kb < nkb; ++kb) {
    const uint32_t a = kb < n0 ? a0 + kb * 8192 : a1 + (kb - n0) * 8192;
    const uint32_t b = ring.base + ring.acquire() * BW_SLOT_BYTES + boff;
    float part[NW / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_k16<NW, 0>(part, desc_sw128(a + ks * 32, 16, 1024),
                       desc_sw128(b + ks * 32, 16, 1024), ks);
    wg_commit();
    wg_wait0();
    fence_regs(part);
    ring.release();
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) sum[i] += part[i];
  }
}

// The forward's product: acc as bw_product's sum, but the whole K
// accumulated in the tensor core (scale-d 1 after the first k16 step) with
// no fold, and stage kb + 1 issued before stage kb is waited on and
// released, so that the tensor cores see no gap between stages.
template <int NW>
__device__ __forceinline__ void fw_product(float (&acc)[NW / 2], uint32_t a0,
                                           int n0, uint32_t a1, int nkb,
                                           Pipe& ring) {
  const uint32_t boff = (threadIdx.x >> 7) * NW * 128;
  for (int kb = 0; kb < nkb; ++kb) {
    const uint32_t a = kb < n0 ? a0 + kb * 8192 : a1 + (kb - n0) * 8192;
    const uint32_t b =
        ring.base + ring.acquire(kb > 0) * BW_SLOT_BYTES + boff;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_k16<NW, 0>(acc, desc_sw128(a + ks * 32, 16, 1024),
                       desc_sw128(b + ks * 32, 16, 1024), kb > 0 || ks > 0);
    wg_commit();
    if (kb > 0) {   // stage kb - 1 is done
      wg_wait1();
      ring.release();
    }
  }
  wg_wait0();
  fence_regs(acc);
  ring.release();
}

// out = bf16(act(sum + bias)) at this thread's accumulator positions; with
// relu, the bits (z > 0) go to mask[w * 256 + t], word w = element / 32.
template <int NW>
__device__ __forceinline__ void bw_epi_act(const float (&sum)[NW / 2],
                                           const float* __restrict__ bias,
                                           bool relu, bf16* out,
                                           uint32_t* mask) {
  const int t = threadIdx.x, c0 = (t >> 7) * NW + 2 * (t & 3);
  const AccOff<NW> off;
  uint32_t bits[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c0 + 8 * j));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      float v0 = sum[i] + b.x, v1 = sum[i + 1] + b.y;
      if (relu) {
        if (v0 > 0.0f) bits[i >> 5] |= 1u << (i & 31);
        if (v1 > 0.0f) bits[i >> 5] |= 1u << ((i + 1) & 31);
        v0 = v0 > 0.0f ? v0 : 0.0f;
        v1 = v1 > 0.0f ? v1 : 0.0f;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + off(j, h)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  if (mask) {
    mask[t] = bits[0];
    mask[BW_CONSUMERS + t] = bits[1];
  }
}

// Gradient epilogue: out = bf16((sum [+ g_sigma sigma_w (+ g_sem sem_w)])
// * relu_mask). gs (the cotangent block) adds the heads' terms when given;
// csum, when given, receives each warp's column sums of the f32 values
// before the rounding (the PRE path's bias gradient) at [warp % 4][column],
// for bias_flush.
template <int NW>
__device__ __forceinline__ void bw_epi_grad(const float (&sum)[NW / 2],
                                            const uint32_t* mask, bf16* out,
                                            const float* gs,
                                            const FmParams& p,
                                            float* csum) {
  const int t = threadIdx.x, c0 = (t >> 7) * NW + 2 * (t & 3);
  const AccOff<NW> off;
  uint32_t bits[2] = {~0u, ~0u};
  if (mask) {
    bits[0] = mask[t];
    bits[1] = mask[BW_CONSUMERS + t];
  }
  // the heads' cotangent at this thread's two rows, rounded to bf16
  float gsig[2] = {0.0f, 0.0f}, gsem[2] = {0.0f, 0.0f};
  if (gs) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gsig[h] = bfr(gs[acc_row(h) * 8 + 3]);
      if (p.out_extra) gsem[h] = bfr(gs[acc_row(h) * 8 + 4]);
    }
  }
  float cs[NW / 8][2];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c0 + 8 * j;
    cs[j][0] = cs[j][1] = 0.0f;
    float ws[2] = {0.0f, 0.0f}, we[2] = {0.0f, 0.0f};
    if (gs) {
      ws[0] = ldbf(p.sigma_w + col);
      ws[1] = ldbf(p.sigma_w + col + 1);
      if (p.out_extra) {
        we[0] = ldbf(p.sem_w + col);
        we[1] = ldbf(p.sem_w + col + 1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      float v[2] = {sum[i], sum[i + 1]};
      if (gs) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] += gsig[h] * ws[e];
          if (p.out_extra) v[e] += gsem[h] * we[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!((bits[(i + e) >> 5] >> ((i + e) & 31)) & 1u)) v[e] = 0.0f;
        cs[j][e] += v[e];
      }
      *reinterpret_cast<__nv_bfloat162*>(out + off(j, h)) =
          __floats2bfloat162_rn(v[0], v[1]);
    }
  }
  if (csum) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = warp_col_sum(cs[j][e]);
        if ((t & 31) < 4) csum[((t >> 5) & 3) * FM_W + c0 + 8 * j + e] = s;
      }
  }
}

// The PRE path's bias gradient of one layer (at `off` in bias64): the four
// warps' column sums that bw_epi_grad left in csum, added in f32, into the
// block's row of bpart64 in f64. Call after the barrier that follows the
// epilogue.
__device__ __forceinline__ void bias_flush(const float* csum,
                                           const FmGrads& gr, int off, int n,
                                           int depth) {
  const int t = threadIdx.x;
  if (t >= n) return;
  const double v = (double)(csum[t] + csum[FM_W + t] + csum[2 * FM_W + t] +
                            csum[3 * FM_W + t]);
  gr.bpart64[(size_t)blockIdx.x * (depth + 2) * FM_W + off + t] = v;
}

// Write (or, with add, add to) this thread's f32 accumulator entries at
// rows 0-63 of dst [.][ld]: the PRE path's dx and dd. The thread that adds
// to an entry is the one that wrote it.
template <int NW>
__device__ __forceinline__ void bw_store_f32(const float (&sum)[NW / 2],
                                             float* dst, int ld, bool add) {
  const int t = threadIdx.x, wg = t >> 7, q = t & 3;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      float2* o = reinterpret_cast<float2*>(
          dst + (size_t)acc_row(h) * ld + wg * NW + 8 * j + 2 * q);
      float2 v = make_float2(sum[i], sum[i + 1]);
      if (add) {
        const float2 a = *o;
        v.x = a.x + v.x;
        v.y = a.y + v.y;
      }
      *o = v;
    }
}

// The block's encodings into the swizzled xe / de tiles: computed from xd
// [P][8] (v2) or, with PRE, read from x_enc / d_enc [P][128] f32 (16-byte
// aligned) and rounded to bf16; by the nt threads numbered t = 0.. nt - 1.
template <bool PRE>
__device__ __forceinline__ void bw_inputs(const float* __restrict__ in_x,
                                          const float* __restrict__ in_d,
                                          int p0, const FmParams& p, bf16* xe,
                                          bf16* de, int t, int nt) {
  if (PRE) {
    constexpr int Q = FM_E / 4;
    for (int i = t; i < FM_BM * Q; i += nt) {
      const int r = i / Q, c = (i - r * Q) * 4;
      const size_t off = (size_t)(p0 + r) * FM_E + c;
      const float4 a = *reinterpret_cast<const float4*>(in_x + off);
      const float4 b = *reinterpret_cast<const float4*>(in_d + off);
      __nv_bfloat162* xo = reinterpret_cast<__nv_bfloat162*>(xe + swz(r, c));
      __nv_bfloat162* dout =
          reinterpret_cast<__nv_bfloat162*>(de + swz(r, c));
      xo[0] = __floats2bfloat162_rn(a.x, a.y);
      xo[1] = __floats2bfloat162_rn(a.z, a.w);
      dout[0] = __floats2bfloat162_rn(b.x, b.y);
      dout[1] = __floats2bfloat162_rn(b.z, b.w);
    }
  } else {
    for (int i = t; i < FM_BM * FM_E; i += nt) {
      const int r = i / FM_E, j = i % FM_E;
      const float* x = in_x + (size_t)(p0 + r) * 8;
      xe[swz(r, j)] = __float2bfloat16_rn(pe_value(x, j, p.multires));
      de[swz(r, j)] = __float2bfloat16_rn(pe_value(x + 3, j, p.multires_views));
    }
  }
}

// fm_fwd_kernel's consumer warpgroups: the block's forward from its
// encodings through the view layer on the ring's stages, then the heads on
// the CUDA cores, four threads a point (row r; columns 2q and 2q + 1 of
// every 8).
__device__ __forceinline__ void fw_consumers(const FmParams& p,
                                             float* __restrict__ out,
                                             uint8_t* smem, Pipe& ring) {
  const uint32_t sb = smem_u32(smem);
  const int tid = threadIdx.x;
  bf16* xe = reinterpret_cast<bf16*>(smem + SB_XE);   // v after the view layer
  // the activation buffer, each layer's output written over its input
  bf16* hb = reinterpret_cast<bf16*>(smem + SB_H);
  const uint32_t a_xe = sb + SB_XE, a_de = sb + SB_DE, a_h = sb + SB_H;
  const int p0 = blockIdx.x * FM_BM;
  const int D = p.depth;
  const bool sk = p.skip + 1 < D;
  // after an epilogue: its tile is complete for wgmma and for every thread
  auto written = [&]() {
    fence_async();
    consumers_sync();
  };

  for (int i = 0; i < D; ++i) {
    float sum[64];
    if (i == 0)
      fw_product<128>(sum, a_xe, 2, a_xe, 2, ring);
    else if (sk && i == p.skip + 1)
      fw_product<128>(sum, a_xe, 2, a_h, 6, ring);
    else
      fw_product<128>(sum, a_h, 4, a_h, 4, ring);
    consumers_sync();   // both warpgroups are done reading hb
    bw_epi_act<128>(sum, p.tb[i], true, hb, nullptr);
    written();
  }
  const int r = tid >> 2, q = tid & 3;
  float s = 0.0f, se = 0.0f;
  {
    float sum[64];
    fw_product<128>(sum, a_h, 4, a_h, 4, ring);
    // sigma and the semantic logit from the last trunk output, before the
    // feature overwrites it
    for (int k = 2 * q; k < FM_W; k += 8) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hb + swz(r, k)));
      s = fmaf(h.x, ldbf(p.sigma_w + k), s);
      s = fmaf(h.y, ldbf(p.sigma_w + k + 1), s);
      if (p.out_extra) {
        se = fmaf(h.x, ldbf(p.sem_w + k), se);
        se = fmaf(h.y, ldbf(p.sem_w + k + 1), se);
      }
    }
    consumers_sync();
    bw_epi_act<128>(sum, p.feat_b, false, hb, nullptr);
    written();
  }
  {
    float sum[32];
    fw_product<64>(sum, a_h, 4, a_de, 6, ring);
    // no reader of the x encoding is left: v goes over it
    bw_epi_act<64>(sum, p.view_b, true, xe, nullptr);
    consumers_sync();
  }
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  for (int k = 2 * q; k < FM_V; k += 8) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xe + swz(r, k)));
    const bf16* w = p.rgb_w + 3 * k;
    c0 = fmaf(v.x, ldbf(w), c0);
    c1 = fmaf(v.x, ldbf(w + 1), c1);
    c2 = fmaf(v.x, ldbf(w + 2), c2);
    c0 = fmaf(v.y, ldbf(w + 3), c0);
    c1 = fmaf(v.y, ldbf(w + 4), c1);
    c2 = fmaf(v.y, ldbf(w + 5), c2);
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    s += __shfl_xor_sync(0xFFFFFFFFu, s, m);
    se += __shfl_xor_sync(0xFFFFFFFFu, se, m);
    c0 += __shfl_xor_sync(0xFFFFFFFFu, c0, m);
    c1 += __shfl_xor_sync(0xFFFFFFFFu, c1, m);
    c2 += __shfl_xor_sync(0xFFFFFFFFu, c2, m);
  }
  // raw [rgb, sigma, (logit)]: thread q writes column q, and q = 0 the logit
  const int nout = 4 + p.out_extra;
  float* o = out + (size_t)(p0 + r) * nout;
  o[q] = q == 0   ? c0 + p.rgb_b[0]
         : q == 1 ? c1 + p.rgb_b[1]
         : q == 2 ? c2 + p.rgb_b[2]
                  : s + p.sigma_b[0];
  if (p.out_extra && q == 0) o[4] = se + p.sem_b[0];
}

// The forward of a block of 64 points: raw [P][4 + out_extra] f32 in out,
// from xd [P][8] (in_x; in_d unused) or, with PRE, the encodings x_enc and
// d_enc [P][128]. Thread 256 streams the plan's stages (the ring's forward
// prefix) through FW_SLOTS slots, and its warp does nothing else; the other
// 11 warps encode the block's inputs. Then threads 0-255 are the consumers
// (warpgroup wg owns output columns wg * NW..). No setmaxnreg: the consumers
// fit in the 168 registers a thread has at launch.
template <bool PRE>
__global__ void __launch_bounds__(BW_THREADS, 1)
fm_fwd_kernel(const FmParams p, const __grid_constant__ BwRing plan,
              const float* __restrict__ in_x, const float* __restrict__ in_d,
              float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + SMEM_ALIGN - 1) & ~(uintptr_t)(SMEM_ALIGN - 1));
  const uint32_t sb = smem_u32(smem);
  Pipe ring = {sb + SB_RING, sb + FW_BAR, sb + FW_BAR + 8 * FW_SLOTS,
               FW_SLOTS, BW_SLOT_BYTES, 0};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >> 5 == BW_CONSUMERS / 32) {   // the producer warp
    if (threadIdx.x == BW_CONSUMERS) stream_ring(p.ring, plan, ring);
    return;
  }
  const int t = threadIdx.x < BW_CONSUMERS ? threadIdx.x : threadIdx.x - 32;
  bw_inputs<PRE>(in_x, in_d, blockIdx.x * FM_BM, p,
                 reinterpret_cast<bf16*>(smem + SB_XE),
                 reinterpret_cast<bf16*>(smem + SB_DE), t, FW_ENCODERS);
  fence_async();
  // named barrier 2: the encoders (the consumers' is 1)
  asm volatile("bar.sync 2, %0;\n" ::"n"(FW_ENCODERS) : "memory");
  if (threadIdx.x < BW_CONSUMERS) fw_consumers(p, out, smem, ring);
}

// fm_bwd_kernel's consumer warpgroups: everything but the weight stream.
template <bool PRE>
__device__ __forceinline__ void bw_consumers(
    const FmParams& p, const FmGrads& gr, const FmLayout& lay,
    const float* __restrict__ in_x, const float* __restrict__ in_d,
    const float* __restrict__ g, bf16* __restrict__ act,
    bf16* __restrict__ grad, uint8_t* smem, Pipe& ring) {
  const uint32_t sb = smem_u32(smem);
  const int tid = threadIdx.x;
  bf16* xe = reinterpret_cast<bf16*>(smem + SB_XE);   // v after the forward
  bf16* de = reinterpret_cast<bf16*>(smem + SB_DE);   // g_v after the heads
  // the activation (or gradient) buffer, each layer's output written over
  // its input once every product that reads it is done
  bf16* hb = reinterpret_cast<bf16*>(smem + SB_H);
  const uint32_t a_xe = sb + SB_XE, a_de = sb + SB_DE, a_h = sb + SB_H;
  float* gs = reinterpret_cast<float*>(smem + SB_GS);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + SB_MASK);
  float* csum = PRE ? reinterpret_cast<float*>(smem + SB_CSUM) : nullptr;
  const int p0 = blockIdx.x * FM_BM;
  const int D = p.depth;
  const bool sk = p.skip + 1 < D;
  const int nout = 4 + p.out_extra;
  const bool lead = tid == 0;
  // this block's scratch: [f / 64][64 points][64] tiles (see the note)
  bf16* act_blk = act + (size_t)blockIdx.x * FM_BM * lay.fa;
  bf16* grad_blk = grad + (size_t)blockIdx.x * FM_BM * lay.fg;
  auto export_tiles = [&](bf16* blk, int col, const bf16* s, int width) {
    if (lead) bulk_s2g(blk + (size_t)col * FM_BM, s, width * FM_BM * 2);
  };
  // Before an epilogue overwrites a buffer: every consumer is done with
  // the products that read it, and every export has read its source.
  auto before_write = [&]() {
    if (lead) bulk_wait_read0();
    consumers_sync();
  };
  // After an epilogue: its tile is complete for wgmma and the bulk store.
  auto after_write = [&]() {
    fence_async();
    consumers_sync();
  };
  // layer i's ReLU bits at mask + i * 512, the view layer's at D * 512

  // ---- the forward, recomputed ----
  bw_inputs<PRE>(in_x, in_d, p0, p, xe, de, tid, BW_CONSUMERS);
  for (int i = tid; i < FM_BM * 8; i += BW_CONSUMERS) {
    const int r = i >> 3, c = i & 7;
    gs[i] = c < nout ? g[(size_t)(p0 + r) * nout + c] : 0.0f;
  }
  after_write();
  export_tiles(act_blk, lay.xe, xe, FM_E);
  export_tiles(act_blk, lay.de, de, FM_E);
  for (int i = 0; i < D; ++i) {
    float sum[64];
    if (i == 0)
      bw_product<128>(sum, a_xe, 2, a_xe, 2, ring);
    else if (sk && i == p.skip + 1)
      bw_product<128>(sum, a_xe, 2, a_h, 6, ring);
    else
      bw_product<128>(sum, a_h, 4, a_h, 4, ring);
    before_write();
    bw_epi_act<128>(sum, p.tb[i], true, hb, mask + i * 512);
    after_write();
    export_tiles(act_blk, lay.h[i], hb, FM_W);
  }
  {
    float sum[64];
    bw_product<128>(sum, a_h, 4, a_h, 4, ring);
    // sigma_w / sem_w from the last trunk output before the feature
    // overwrites it, with the cotangent rounded to bf16
    float s = 0.0f, se = 0.0f;
    for (int r = 0; r < FM_BM; ++r) {
      const float h = __bfloat162float(hb[swz(r, tid)]);
      s = fmaf(h, bfr(gs[r * 8 + 3]), s);
      if (p.out_extra) se = fmaf(h, bfr(gs[r * 8 + 4]), se);
    }
    float* hp = gr.hpart + (size_t)blockIdx.x * FM_HEADS;  // the block's
    hp[tid] = s;
    if (p.out_extra) hp[FM_W + tid] = se;
    before_write();
    bw_epi_act<128>(sum, p.feat_b, false, hb, nullptr);
    after_write();
    export_tiles(act_blk, lay.feat, hb, FM_W);
  }
  {
    float sum[32];
    bw_product<64>(sum, a_h, 4, a_de, 6, ring);
    before_write();
    bw_epi_act<64>(sum, p.view_b, true, xe, mask + D * 512);
    after_write();
    export_tiles(act_blk, lay.v, xe, FM_V);
  }

  // ---- the rgb head, on the CUDA cores ----
  // rgb_w from v, with the cotangent rounded to bf16; the heads' biases
  // from the f32 cotangent, in f64
  for (int o = tid; o < FM_V * 3; o += BW_CONSUMERS) {
    const int n = o / 3, c = o % 3;
    float s = 0.0f;
    for (int r = 0; r < FM_BM; ++r)
      s = fmaf(__bfloat162float(xe[swz(r, n)]), bfr(gs[r * 8 + c]), s);
    gr.hpart[(size_t)blockIdx.x * FM_HEADS + 2 * FM_W + o] = s;
  }
  if (tid < nout) {
    double s = 0.0;
    for (int r = 0; r < FM_BM; ++r) s += (double)gs[r * 8 + tid];
    gr.hpart64[(size_t)blockIdx.x * 8 + tid] = s;
  }

  // g_v = bf16((g_rgb rgb_w^T) * (view > 0)) in the view layer's
  // accumulator layout, so that each thread reads its own mask bits; it
  // replaces the dir encoding in de (PRE: the f32 g_v's column sums are the
  // view layer's bias gradient)
  {
    float gv[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (tid >> 7) * 64 + 8 * j + 2 * (tid & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = acc_row(h);
        const float g0 = bfr(gs[row * 8]), g1 = bfr(gs[row * 8 + 1]),
                    g2 = bfr(gs[row * 8 + 2]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bf16* wr = p.rgb_w + 3 * (col + e);
          float s = g0 * ldbf(wr);
          s = fmaf(g1, ldbf(wr + 1), s);
          gv[4 * j + 2 * h + e] = fmaf(g2, ldbf(wr + 2), s);
        }
      }
    }
    bw_epi_grad<64>(gv, mask + D * 512, de, nullptr, p, csum);
  }
  after_write();
  if (PRE) bias_flush(csum, gr, (D + 1) * FM_W, FM_V, D);
  export_tiles(grad_blk, lay.gv, de, FM_V);

  // ---- the backward ----
  // g_feat = bf16(g_v view_w[:256]^T), over the feature
  {
    float sum[64];
    bw_product<128>(sum, a_de, 2, a_de, 2, ring);
    before_write();
    bw_epi_grad<128>(sum, nullptr, hb, nullptr, p, csum);
  }
  if (PRE) {  // dd = (g_v view_w^T)[:, 256:], the direction slice
    float sum[32];
    bw_product<64>(sum, a_de, 2, a_de, 2, ring);
    bw_store_f32<64>(sum, gr.dd + (size_t)p0 * FM_E, FM_E, false);
  }
  after_write();
  if (PRE) bias_flush(csum, gr, D * FM_W, FM_W, D);
  export_tiles(grad_blk, lay.gfeat, hb, FM_W);

  // g_z of the last trunk layer: (g_feat feat_w^T + heads) * mask
  {
    float sum[64];
    bw_product<128>(sum, a_h, 4, a_h, 4, ring);
    before_write();
    bw_epi_grad<128>(sum, mask + (D - 1) * 512, hb, gs, p, csum);
    after_write();
    if (PRE) bias_flush(csum, gr, (D - 1) * FM_W, FM_W, D);
    export_tiles(grad_blk, lay.gz[D - 1], hb, FM_W);
  }

  // the trunk: g_z(i-1) = bf16((g_z(i) tw_i^T)[h part] * mask(i-1)); PRE
  // also writes the skip layer's encoding slice into dx
  bool dx_written = false;
  for (int i = D - 1; i >= 1; --i) {
    if (PRE && sk && i == p.skip + 1) {
      float sum[32];
      bw_product<64>(sum, a_h, 4, a_h, 4, ring);
      bw_store_f32<64>(sum, gr.dx + (size_t)p0 * FM_E, FM_E, false);
      dx_written = true;
    }
    float sum[64];
    bw_product<128>(sum, a_h, 4, a_h, 4, ring);
    before_write();
    bw_epi_grad<128>(sum, mask + (i - 1) * 512, hb, nullptr, p, csum);
    after_write();
    if (PRE) bias_flush(csum, gr, (i - 1) * FM_W, FM_W, D);
    export_tiles(grad_blk, lay.gz[i - 1], hb, FM_W);
  }
  if (PRE) {  // dx += g_z0 W0^T (each thread adds to the entries it wrote)
    float sum[32];
    bw_product<64>(sum, a_h, 4, a_h, 4, ring);
    bw_store_f32<64>(sum, gr.dx + (size_t)p0 * FM_E, FM_E, dx_written);
  }
  if (lead) bulk_wait_all();
}

// Recompute the forward of a block of 64 points, back-propagate through it,
// write the block's sums of the heads' gradients and export A and G
// of the layers that fm_dw_kernel reduces. PRE: see the note at the top (dx,
// dd and the f32 bias sums). Threads 0-255 are the consumers (warpgroup wg
// owns output columns wg * NW..), threads 256-383 the producer warpgroup,
// of which thread 256 streams the weight ring; consumer thread 0 issues the
// exports.
template <bool PRE>
__global__ void __launch_bounds__(BW_THREADS, 1)
fm_bwd_kernel(const FmParams p, const FmGrads gr, const FmLayout lay,
              const __grid_constant__ BwRing plan,
              const float* __restrict__ in_x, const float* __restrict__ in_d,
              const float* __restrict__ g, bf16* __restrict__ act,
              bf16* __restrict__ grad) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + SMEM_ALIGN - 1) & ~(uintptr_t)(SMEM_ALIGN - 1));
  const uint32_t sb = smem_u32(smem);
  const int tid = threadIdx.x;
  Pipe ring = {sb + SB_RING, sb + SB_BAR, sb + SB_BAR + 8 * BW_SLOTS,
               BW_SLOTS, BW_SLOT_BYTES, 0};
  if (tid == 0) ring.init();
  __syncthreads();

  if (tid >= BW_CONSUMERS) {   // the producer warpgroup: one thread works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        BW_PRODUCER_REGS));
    if (tid == BW_CONSUMERS) stream_ring(p.ring, plan, ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        BW_CONSUMER_REGS));
    bw_consumers<PRE>(p, gr, lay, in_x, in_d, g, act, grad, smem, ring);
  }
}

// dW = A^T G over all points, for every layer whose A and G the backward
// exported. blockIdx.x enumerates (layer, 64 inputs of it), each block
// computing the layer's whole output width; blockIdx.y a slice of the
// points (split-K), whose sum each block adds once.
struct DwLayer {
  int a_off, k, g_off, n, tile0;
  float* dw;
  float* db;
  int nb;            // biases in the layer's split record (n, or 0 with PRE)
  long long poff;    // the record's offset in a split's partial sums
};

struct DwPlan {
  int n;
  DwLayer l[DW_MAX_LAYERS];
  long long stride;  // floats of a split's partial sums (its records)
};

// The consumers of fm_dw_kernel: this warpgroup's NW output columns of the
// block's 64 inputs, over n_chunks chunks of 64 points from the ring. A^T
// (inputs x points) and G (points x outputs) are both MN-major operands:
// the tiles as the backward exported them.
// rec: this split's record of the layer in the partial sums.
template <int NW>
__device__ __forceinline__ void dw_consume(const DwLayer& L, int m,
                                           int n_chunks, Pipe& q,
                                           uint8_t* smem, float* rec) {
  const int t = threadIdx.x, wg = t >> 7;
  // v2's bias gradient: the column sums of the bf16 G. The layer's K / 64
  // blocks of one slice of points share its n / 8 groups of 8 columns, ccw
  // each from cc0; thread t takes the group cc0 + t % ccw on the rows
  // rg, rg + nrg, ... with rg = t / ccw
  const int ncc = L.n / 8, ccw = (ncc + L.k / 64 - 1) / (L.k / 64);
  const int cc0 = m * ccw, nrg = BW_CONSUMERS / ccw;
  const int cc = cc0 + t % ccw, rg = t / ccw;
  const bool bias = L.db != nullptr && cc0 < ncc;
  const bool do_bias = bias && rg < nrg && cc < ncc;
  float bs[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bs[k] = 0.0f;
  float sum[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) sum[i] = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = q.acquire();
    const uint32_t a = q.base + slot * DW_SLOT_BYTES;
    const uint32_t b = a + DW_A_BYTES + wg * NW * 128;
    // the tensor core's accumulator holds one chunk (64 points); the
    // running sum is kept outside it in f32
    float part[NW / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_k16<NW, 1>(part, desc_sw128(a + ks * 2048, 8192, 1024),
                       desc_sw128(b + ks * 2048, 8192, 1024), ks);
    wg_commit();
    wg_wait0();
    fence_regs(part);
    if (do_bias) {
      const bf16* gt = reinterpret_cast<const bf16*>(
          smem + slot * DW_SLOT_BYTES + DW_A_BYTES);
      for (int r = rg; r < FM_BM; r += nrg) {
        const uint4 v = *reinterpret_cast<const uint4*>(gt + swz(r, 8 * cc));
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h2[k]);
          bs[2 * k] += f.x;
          bs[2 * k + 1] += f.y;
        }
      }
    }
    q.release();
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) sum[i] += part[i];
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m * 64 + acc_row(h);
      const int col = wg * NW + 8 * j + 2 * (t & 3);
      *reinterpret_cast<float2*>(rec + (size_t)row * L.n + col) =
          make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
    }
  if (bias) {   // the row groups' sums meet in shared memory
    float* bred = reinterpret_cast<float*>(smem + DW_BRED);
    if (do_bias) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        bred[(rg * ccw + cc - cc0) * 8 + k] = bs[k];
    }
    consumers_sync();
    if (t < 8 * ccw && 8 * cc0 + t < L.n) {
      float s = 0.0f;
      for (int r = 0; r < nrg; ++r) s += bred[r * ccw * 8 + t];
      rec[(size_t)L.k * L.n + 8 * cc0 + t] = s;
    }
  }
}

__global__ void __launch_bounds__(DW_THREADS, 1)
fm_dw_kernel(const bf16* __restrict__ act, int fa,
             const bf16* __restrict__ grad, int fg,
             const __grid_constant__ DwPlan plan, int n_chunks,
             int chunks_per_split, float* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + SMEM_ALIGN - 1) & ~(uintptr_t)(SMEM_ALIGN - 1));
  int li = 0;
  while (li + 1 < plan.n && (int)blockIdx.x >= plan.l[li + 1].tile0) ++li;
  const DwLayer& L = plan.l[li];
  const int m = blockIdx.x - L.tile0;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  if (c_begin >= c_end) return;
  const uint32_t sb = smem_u32(smem);
  const uint32_t bars = sb + DW_SLOTS * DW_SLOT_BYTES;
  Pipe q = {sb, bars, bars + 8 * DW_SLOTS, DW_SLOTS, DW_SLOT_BYTES, 0};
  if (threadIdx.x == 0) q.init();
  __syncthreads();

  if (threadIdx.x >= BW_CONSUMERS) {   // the producer warp
    if (threadIdx.x == BW_CONSUMERS) {
      const uint32_t g_bytes = L.n * FM_BM * 2;
      for (int c = c_begin; c < c_end; ++c) {
        const int slot = q.produce(DW_A_BYTES + g_bytes);
        const uint32_t dst = q.base + slot * DW_SLOT_BYTES;
        bulk_g2s(dst, act + ((size_t)c * fa + L.a_off + m * 64) * FM_BM,
                 DW_A_BYTES, q.full + 8 * slot);
        bulk_g2s(dst + DW_A_BYTES, grad + ((size_t)c * fg + L.g_off) * FM_BM,
                 g_bytes, q.full + 8 * slot);
      }
    }
    return;
  }
  float* rec = part + blockIdx.y * plan.stride + L.poff;
  if (L.n == FM_W)
    dw_consume<128>(L, m, c_end - c_begin, q, smem, rec);
  else
    dw_consume<64>(L, m, c_end - c_begin, q, smem, rec);
}

// fm_dw_kernel's second pass: each layer's weight (and bias)
// gradients from the splits' records in `part`, added in split order;
// blockIdx.y the layer, a thread an element of its record.
__global__ void __launch_bounds__(256)
fm_split_sum_kernel(const float* __restrict__ part, int splits,
                    const __grid_constant__ DwPlan plan) {
  const DwLayer& L = plan.l[blockIdx.y];
  const long long nw = (long long)L.k * L.n, rec = nw + L.nb;
  for (long long e = (long long)blockIdx.x * 256 + threadIdx.x; e < rec;
       e += (long long)gridDim.x * 256) {
    const float* src = part + L.poff + e;
    float v = src[0];
    for (int s = 1; s < splits; ++s) v += src[s * plan.stride];
    if (e < nw)
      L.dw[e] = v;
    else
      L.db[e - nw] = v;
  }
}

// fm_bwd_kernel's per-block sums: dst[c] = the sum over the
// blocks' rows r of src[r * ld + c], c < cols: 32 slices of the rows
// (thread row y takes r = y, y + 32, ...) each summed in order, then the
// slices in order. blockDim (32, 32), 32 columns a block.
template <class T>
__global__ void __launch_bounds__(1024)
fm_rows_kernel(const T* __restrict__ src, int rows, long long ld, int cols,
               T* __restrict__ dst) {
  __shared__ T slice[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  T v = 0;
  if (c < cols)
    for (int r = threadIdx.y; r < rows; r += 32) v += src[r * ld + c];
  slice[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    T sum = slice[0][threadIdx.x];
    for (int k = 1; k < 32; ++k) sum += slice[k][threadIdx.x];
    dst[c] = sum;
  }
}

// ---------------------------------------------------------------------------
// C interface, bound with ctypes. Pointers are device pointers except the
// structs, which are host memory. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernels do not take).
// ---------------------------------------------------------------------------

static int fm_check(const FmParams* p, int n_points, bool pre) {
  if (!p || p->depth < 1 || p->depth > FM_MAX_DEPTH || p->skip < 0 ||
      p->skip + 1 == p->depth || (p->out_extra != 0 && p->out_extra != 1) ||
      n_points < 0 || n_points % FM_BM)
    return (int)cudaErrorInvalidValue;
  if (!pre && (p->multires < 0 || 3 * (1 + 2 * p->multires) > FM_E ||
               p->multires_views < 0 ||
               3 * (1 + 2 * p->multires_views) > FM_E))
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int fm_scratch_cols(int depth, int skip, int* fa, int* fg) {
  if (depth < 1 || depth > FM_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  FmLayout L;
  fm_layout(depth, skip, &L);
  *fa = L.fa;
  *fg = L.fg;
  return 0;
}

// The weight stages in the order fm_bwd_kernel consumes them (and
// ops/fused_mlp.py::pack_ring packs them): the recompute's trunk, feature
// and view products (with fwd only these: fm_fwd_kernel's plan, the same
// with and without pre), then g_feat, (pre) dd, the last trunk layer's g_h,
// the trunk from the top down with (pre) the skip layer's encoding slice
// before its h part, and (pre) layer 0's input gradient. A product with N
// outputs and depth K takes K / 64 stages of N x 64 bf16. Returns false if
// there are more than BW_MAX_STAGES.
static bool ring_schedule(int depth, int skip, bool pre, bool fwd, BwRing* r,
                          long long* bytes) {
  r->n = 0;
  *bytes = 0;
  auto add = [&](int n_out, int k) {
    for (int s = 0; s < k / FM_KT; ++s) {
      if (r->n == BW_MAX_STAGES) return false;
      r->kb[r->n++] = (unsigned char)(n_out / 128);
      *bytes += (long long)n_out * FM_KT * 2;
    }
    return true;
  };
  const bool sk = skip + 1 < depth;
  bool ok = true;
  for (int i = 0; i < depth; ++i)
    ok = ok && add(FM_W, i == 0 ? FM_E : sk && i == skip + 1 ? FM_E + FM_W
                                                             : FM_W);
  ok = ok && add(FM_W, FM_W) && add(FM_V, FM_W + FM_E);
  if (fwd) return ok;
  ok = ok && add(FM_W, FM_V);
  if (pre) ok = ok && add(FM_E, FM_V);
  ok = ok && add(FM_W, FM_W);
  for (int i = depth - 1; i >= 1; --i) {
    if (pre && sk && i == skip + 1) ok = ok && add(FM_E, FM_W);
    ok = ok && add(FM_W, FM_W);
  }
  if (pre) ok = ok && add(FM_E, FM_W);
  return ok;
}

// p->ring: pack_ring's stages, or at least their forward prefix, p->ring_bytes
// long.
template <bool PRE>
static int fm_fwd_launch(const FmParams* p, const void* in_x,
                         const void* in_d, void* out, int n_points,
                         void* stream) {
  int err = fm_check(p, n_points, PRE);
  if (err || n_points == 0) return err;
  BwRing plan;
  long long ring_bytes;
  if (!p->ring ||
      !ring_schedule(p->depth, p->skip, PRE, true, &plan, &ring_bytes) ||
      p->ring_bytes < ring_bytes)
    return (int)cudaErrorInvalidValue;
  err = (int)cudaFuncSetAttribute(fm_fwd_kernel<PRE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  FW_SMEM);
  if (err) return err;
  fm_fwd_kernel<PRE><<<n_points / FM_BM, BW_THREADS, FW_SMEM,
                       (cudaStream_t)stream>>>(
      *p, plan, (const float*)in_x, (const float*)in_d, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int fm_fwd(const FmParams* p, const void* xd, void* out,
                      int n_points, void* stream) {
  return fm_fwd_launch<false>(p, xd, nullptr, out, n_points, stream);
}

// The pre-encoded forward (kernel #7): x_enc, d_enc [n_points][128] f32.
extern "C" int fm_fwd_pre(const FmParams* p, const void* x_enc,
                          const void* d_enc, void* out, int n_points,
                          void* stream) {
  return fm_fwd_launch<true>(p, x_enc, d_enc, out, n_points, stream);
}

// fm_dw_kernel's plan: the layers whose A^T G it reduces (their weight and,
// without PRE, bias gradients from gr; gr null: sizes only), each layer's
// record in a split's partial sums, and the split-K over the points: whole
// waves of one block an SM on the H100's 132 SMs, about seven; per chunks
// of 64 points a split.
static void dw_plan(int depth, int skip, bool pre, const FmGrads* gr,
                    const FmLayout& lay, int n_points, DwPlan* plan,
                    int* splits_out, int* per_out) {
  plan->n = 0;
  int tiles = 0;
  long long poff = 0;
  const bool sk = skip + 1 < depth;
  for (int i = 0; i < depth + 2; ++i) {
    DwLayer& L = plan->l[plan->n++];
    if (i < depth) {
      const bool cat = sk && i == skip + 1;
      L.a_off = (i == 0 || cat) ? lay.xe : lay.h[i - 1];
      L.k = i == 0 ? FM_E : cat ? FM_E + FM_W : FM_W;
      L.g_off = lay.gz[i];
      L.n = FM_W;
      L.dw = gr ? gr->tw[i] : nullptr;
      L.db = gr ? gr->tb[i] : nullptr;
    } else if (i == depth) {
      L.a_off = lay.h[depth - 1];
      L.k = FM_W;
      L.g_off = lay.gfeat;
      L.n = FM_W;
      L.dw = gr ? gr->feat_w : nullptr;
      L.db = gr ? gr->feat_b : nullptr;
    } else {
      L.a_off = lay.feat;
      L.k = FM_W + FM_E;
      L.g_off = lay.gv;
      L.n = FM_V;
      L.dw = gr ? gr->view_w : nullptr;
      L.db = gr ? gr->view_b : nullptr;
    }
    if (pre) L.db = nullptr;   // summed in f32 by fm_bwd_kernel
    L.nb = pre ? 0 : L.n;
    L.poff = poff;
    poff += (long long)L.k * L.n + L.nb;
    L.tile0 = tiles;
    tiles += L.k / 64;
  }
  plan->stride = poff;
  const int n_chunks = n_points / FM_BM;
  int splits = (7 * 132 + tiles / 2) / tiles;
  if (splits < 1) splits = 1;
  if (splits > n_chunks) splits = n_chunks;
  const int per = (n_chunks + splits - 1) / splits;
  *splits_out = (n_chunks + per - 1) / per;
  *per_out = per;
}

template <class T>
static int rows_sum(const T* src, int rows, long long ld, int cols, T* dst,
                    cudaStream_t s) {
  fm_rows_kernel<T><<<(cols + 31) / 32, dim3(32, 32), 0, s>>>(src, rows, ld,
                                                               cols, dst);
  return (int)cudaGetLastError();
}

// The fixed-order sums' scratch, in elements: sizes[0] dwpart (f32),
// sizes[1] hpart (f32), sizes[2] hpart64 (f64), sizes[3] bpart64 (f64, 0
// without pre).
extern "C" int fm_partial_sizes(int depth, int skip, int pre, int n_points,
                            long long* sizes) {
  if (depth < 1 || depth > FM_MAX_DEPTH || n_points < FM_BM ||
      n_points % FM_BM)
    return (int)cudaErrorInvalidValue;
  FmLayout lay;
  fm_layout(depth, skip, &lay);
  DwPlan plan;
  int splits, per;
  dw_plan(depth, skip, pre != 0, nullptr, lay, n_points, &plan, &splits,
          &per);
  const long long blocks = n_points / FM_BM;
  sizes[0] = splits * plan.stride;
  sizes[1] = blocks * FM_HEADS;
  sizes[2] = blocks * 8;
  sizes[3] = pre ? blocks * (depth + 2) * FM_W : 0;
  return 0;
}

// act: n_points x fa bf16, grad: n_points x fg bf16 of scratch
// (fm_scratch_cols); every gradient in `gr` is written whole (with PRE the
// trunk's, feature and view biases go to bias64 instead of tb, feat_b,
// view_b; dx and dd too); p->ring the weight stages of
// pack_ring, p->ring_bytes long. passes: 1 fm_bwd_kernel, 2 fm_dw_kernel
// (on the scratch a pass 1 wrote), 3 both, each pass with its fixed-order
// sums; gr's scratch sized by fm_partial_sizes.
template <bool PRE>
static int fm_bwd_launch(const FmParams* p, const FmGrads* gr,
                         const void* in_x, const void* in_d, const void* g,
                         void* act, void* grad, int n_points, int passes,
                         void* stream) {
  int err = fm_check(p, n_points, PRE);
  if (err || n_points == 0) return err;
  if ((PRE && (!gr->bias64 || !gr->dx || !gr->dd)) || passes < 1 ||
      passes > 3)
    return (int)cudaErrorInvalidValue;
  if (!gr->dwpart || !gr->hpart || !gr->hpart64 || (PRE && !gr->bpart64))
    return (int)cudaErrorInvalidValue;
  const int smem = SB_END(p->depth) + SMEM_ALIGN;
  BwRing ring;
  long long ring_bytes;
  if (smem > SMEM_MAX || !p->ring ||
      !ring_schedule(p->depth, p->skip, PRE, false, &ring, &ring_bytes) ||
      ring_bytes != p->ring_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FmLayout lay;
  fm_layout(p->depth, p->skip, &lay);
  if (passes & 1) {
    err = (int)cudaFuncSetAttribute(
        fm_bwd_kernel<PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err) return err;
    fm_bwd_kernel<PRE><<<n_points / FM_BM, BW_THREADS, smem, s>>>(
        *p, *gr, lay, ring, (const float*)in_x, (const float*)in_d,
        (const float*)g, (bf16*)act, (bf16*)grad);
    err = (int)cudaGetLastError();
    if (err) return err;
    {   // the blocks' head (and PRE bias) sums, in block order
      const int blocks = n_points / FM_BM, D = p->depth;
      err = rows_sum(gr->hpart, blocks, FM_HEADS, FM_W, gr->sigma_w, s);
      if (!err && p->out_extra)
        err = rows_sum(gr->hpart + FM_W, blocks, FM_HEADS, FM_W, gr->sem_w,
                       s);
      if (!err)
        err = rows_sum(gr->hpart + 2 * FM_W, blocks, FM_HEADS, 3 * FM_V,
                       gr->rgb_w, s);
      if (!err)
        err = rows_sum(gr->hpart64, blocks, 8, 4 + p->out_extra, gr->head_b,
                       s);
      if (!err && PRE)
        err = rows_sum(gr->bpart64, blocks, (D + 2) * FM_W,
                       (D + 1) * FM_W + FM_V, gr->bias64, s);
      if (err) return err;
    }
    if (!(passes & 2)) return 0;
  }

  DwPlan plan;
  int splits, per;
  dw_plan(p->depth, p->skip, PRE, gr, lay, n_points, &plan, &splits, &per);
  const int n_chunks = n_points / FM_BM;
  err = (int)cudaFuncSetAttribute(
      fm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err) return err;
  fm_dw_kernel<<<dim3(plan.l[plan.n - 1].tile0 + plan.l[plan.n - 1].k / 64,
                      splits),
                 DW_THREADS, DW_SMEM, s>>>((const bf16*)act, lay.fa,
                                           (const bf16*)grad, lay.fg, plan,
                                           n_chunks, per, gr->dwpart);
  err = (int)cudaGetLastError();
  if (err) return err;
  long long most = 0;
  for (int i = 0; i < plan.n; ++i) {
    const long long rec = (long long)plan.l[i].k * plan.l[i].n + plan.l[i].nb;
    most = rec > most ? rec : most;
  }
  fm_split_sum_kernel<<<dim3((unsigned)((most + 255) / 256), plan.n), 256, 0,
                        s>>>(gr->dwpart, splits, plan);
  return (int)cudaGetLastError();
}

extern "C" int fm_bwd(const FmParams* p, const FmGrads* gr, const void* xd,
                      const void* g, void* act, void* grad, int n_points,
                      void* stream) {
  return fm_bwd_launch<false>(p, gr, xd, nullptr, g, act, grad, n_points, 3,
                              stream);
}

// The pre-encoded backward (kernel #8): also writes gr->dx, gr->dd.
extern "C" int fm_bwd_pre(const FmParams* p, const FmGrads* gr,
                          const void* x_enc, const void* d_enc, const void* g,
                          void* act, void* grad, int n_points, void* stream) {
  return fm_bwd_launch<true>(p, gr, x_enc, d_enc, g, act, grad, n_points, 3,
                             stream);
}

// One pass of either backward (pre: v1), for timing the two kernels apart:
// pass 1 launches fm_bwd_kernel, pass 2 fm_dw_kernel on the scratch that a
// pass 1 wrote.
extern "C" int fm_bwd_pass(const FmParams* p, const FmGrads* gr,
                           const void* in_x, const void* in_d, const void* g,
                           void* act, void* grad, int n_points, int pre,
                           int pass, void* stream) {
  if (pass != 1 && pass != 2) return (int)cudaErrorInvalidValue;
  return pre ? fm_bwd_launch<true>(p, gr, in_x, in_d, g, act, grad, n_points,
                                   pass, stream)
             : fm_bwd_launch<false>(p, gr, in_x, nullptr, g, act, grad,
                                    n_points, pass, stream);
}

extern "C" const char* fm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
