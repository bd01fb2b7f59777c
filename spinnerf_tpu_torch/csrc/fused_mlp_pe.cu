// Fused positional encoding + 8x256 NeRF MLP for Hopper (sm_90a): the
// forward, and the backward that returns the weight gradients only.
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
// design, first version:
// - One block of 256 threads owns 64 points. Their activations stay in
//   shared memory as bf16 (encodings 2 x 64 x 128, two 64 x 256 ping-pong
//   buffers). The tensor core's accumulator rounds toward zero, so each
//   stage's partial product is added to an f32 running sum in registers.
//   The ~0.64 M weights (1.3 MB in bf16) do not fit in a block's
//   227 KB, so each layer's weights stream through a double-buffered
//   64-deep stage with cp.async, K contiguous, read by all 8 warps;
//   fragments come from shared memory with ldmatrix.
// - Products are mma.sync m16n8k16 bf16 -> f32 on the tensor cores (wgmma
//   and TMA are later work). The 1-3 column heads run on the CUDA cores.
// - Backward: the weight gradient dW = A^T G sums over every point, which a
//   block of 64 points cannot finish. fm_bwd_kernel recomputes the forward
//   and back-propagates per block, keeping the ReLU masks as bits in shared
//   memory, and writes each layer's input activations A and output
//   gradients G to device memory in bf16 as (even point, odd point) pairs;
//   fm_dw_kernel then computes every A^T G as a split-K product over points
//   with mma.sync (the pair layout gives the fragments 32-bit loads), with
//   f32 partial sums folded outside the tensor core's accumulator every 32
//   points and one float2 atomic per output per split. The bias gradients
//   are the column sums of G in the same pass. The scratch is
//   (P / 2) x (fa + fg) words, 2.7 GB at P = 262,144.
// - sinf is the full-range libm sine: arguments reach 2^9 * |x|. Never build
//   with --use_fast_math.
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
// :128] and dd [P][128] = (g_v view_w^T)[:, 256:], both f32. Each is written
// to device memory as soon as its product is done (the skip slice first, the
// layer-0 product added to it by the same thread), so no f32 tile stays
// resident beside the block's activations. The v1 kernel sums its bias
// gradients over f32 gradients (the v2 kernel over bf16-rounded ones), so
// with PRE the gradient epilogues add their f32 column sums per warp, in
// f64 atomics, and fm_dw_kernel skips its bias pass. The padded input lanes
// of dx and dd are products with the weights' zero rows: exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define FM_BM 64             // points per block
#define FM_THREADS 256
#define FM_W 256             // trunk width
#define FM_E 128             // padded encoding widths (in_dim, dir_dim)
#define FM_V 128             // view width
#define FM_KT 64             // depth of a weight stage
#define FM_MAX_DEPTH 16
#define LDH (FM_W + 8)       // row pitches in bf16, padded against bank conflicts
#define LDE (FM_E + 8)
#define LDB (FM_KT + 8)
#define STAGE_ELEMS (FM_W * LDB)

// shared memory, in bytes
#define SM_XE 0
#define SM_DE (SM_XE + FM_BM * LDE * 2)
#define SM_H0 (SM_DE + FM_BM * LDE * 2)
#define SM_H1 (SM_H0 + FM_BM * LDH * 2)
#define SM_B (SM_H1 + FM_BM * LDH * 2)
#define SM_FWD_END (SM_B + 2 * STAGE_ELEMS * 2)
#define SM_GS SM_FWD_END                      // cotangent block, 64 x 8 f32
#define SM_MASK (SM_GS + FM_BM * 8 * 4)       // ReLU bits, 2 words a thread a layer
#define SM_BWD_END(depth) (SM_MASK + ((depth) + 1) * 2 * FM_THREADS * 4)

// Weights (bf16) and biases (f32), bound from ops/fused_mlp.py (_FmParams).
struct FmParams {
  const bf16* wt[FM_MAX_DEPTH];   // trunk weights transposed: [256][K_i]
  const bf16* w[FM_MAX_DEPTH];    // trunk weights [K_i][256] (backward)
  const float* tb[FM_MAX_DEPTH];  // [256]
  const bf16* feat_wt;            // [256][256] transposed
  const bf16* feat_w;             // [256][256]
  const float* feat_b;
  const bf16* view_wt;            // [128][384] transposed
  const bf16* view_w;             // [384][128]
  const float* view_b;
  const bf16* rgb_w;              // [128][3]
  const float* rgb_b;
  const bf16* sigma_w;            // [256]
  const float* sigma_b;
  const bf16* sem_w;              // [256] when out_extra
  const float* sem_b;
  int depth, skip, out_extra, multires, multires_views;
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
};

// Column offsets (in point pairs' words) of each activation and gradient in
// the backward's scratch rows. A layer's input is contiguous: the skip
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

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bfr(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ldbf(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void red_add2(float* addr, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float2*>(addr), make_float2(a, b));
#else
  atomicAdd(addr, a);
  atomicAdd(addr + 1, b);
#endif
}

// d += a * b on the tensor cores: A 16x16 (row), B 16x8 (col), bf16 -> f32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register j receives matrix j in the mma
// fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Stage rows [0, NT*32) x columns [k0, k0+FM_KT) of a K-contiguous weight
// matrix bt (row pitch ldb) into dst [NT*32][LDB].
template <int NT>
__device__ __forceinline__ void load_b_stage(bf16* dst,
                                             const bf16* __restrict__ bt,
                                             int ldb, int k0) {
  constexpr int N = NT * 32, CH = FM_KT / 8;   // 16-byte chunks a row
  for (int c = threadIdx.x; c < N * CH; c += FM_THREADS) {
    const int n = c / CH, q = c % CH;
    cp_async16(dst + n * LDB + q * 8, bt + (size_t)n * ldb + k0 + q * 8);
  }
}

// acc[64][NT*32] = A[64][K] * B, where B^T is bt [NT*32][ldb] in device
// memory (K contiguous) and A lies in shared memory: columns [0, k0len) in
// a0 (pitch lda0), the rest in a1 (pitch lda1). Warp w owns rows
// (w/4)*32.. and columns (w%4)*NT*8..; acc[mt][nt][2h+j] is row
// (w/4)*32 + mt*16 + lane/4 + 8h, column (w%4)*NT*8 + nt*8 + 2(lane%4) + j.
// Starts and ends with a __syncthreads, so A may be written just before and
// the output buffer just after.
template <int NT>
__device__ __forceinline__ void block_mma(float (&acc)[2][NT][4],
                                          const bf16* a0, int lda0, int k0len,
                                          const bf16* a1, int lda1,
                                          const bf16* __restrict__ bt,
                                          int ldb, int K, bf16* bst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;
  const int nk = K / FM_KT;
  load_b_stage<NT>(bst, bt, ldb, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load_b_stage<NT>(bst + ((kt + 1) & 1) * STAGE_ELEMS, bt, ldb,
                       (kt + 1) * FM_KT);
    cp_async_commit();  // possibly empty: keeps wait_group 1 exact
    cp_async_wait1();
    __syncthreads();
    const bf16* bs = bst + (kt & 1) * STAGE_ELEMS;
    const int k = kt * FM_KT;
    const bf16* a = k < k0len ? a0 : a1;
    const int lda = k < k0len ? lda0 : lda1;
    const int ka = k < k0len ? k : k - k0len;
    // the tensor core's accumulator holds one stage (64 products); the
    // running sum is kept outside it in f32
    float part[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < FM_KT / 16; ++ks) {
      // A: rows lane % 16, columns + 8 for lanes 16-31 -> a0..a3
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], a + (wm * 32 + mt * 16 + (lane & 15)) * lda + ka +
                            ks * 16 + (lane >> 4) * 8);
      // B (rows n, K contiguous): two n-tiles a load, lanes 0-15 the first
      // (k, k + 8), lanes 16-31 the second -> b0, b1, b0', b1'
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, bs + (wn * NT * 8 + nt * 8 + (lane >> 4) * 8 + (lane & 7)) *
                             LDB + ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(part[0][nt], af[0], bf[0], bf[1]);
        mma16816(part[1][nt], af[1], bf[0], bf[1]);
        mma16816(part[0][nt + 1], af[0], bf[2], bf[3]);
        mma16816(part[1][nt + 1], af[1], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
    __syncthreads();
  }
}

// out = bf16(act(acc + bias)); with relu, the bits (z > 0) of this thread's
// accumulator positions go to mask[word * FM_THREADS + tid].
template <int NT>
__device__ __forceinline__ void epi_bias_act(float (&acc)[2][NT][4],
                                             const float* __restrict__ bias,
                                             bool relu, bf16* out, int ldo,
                                             uint32_t* mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  constexpr int NW = (2 * NT * 4 + 31) / 32;
  uint32_t bits[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) bits[w] = 0u;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wn * NT * 8 + nt * 8 + 2 * t;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mt * 16 + g + 8 * h;
        float v0 = acc[mt][nt][2 * h] + b0;
        float v1 = acc[mt][nt][2 * h + 1] + b1;
        if (relu) {
          const int idx = (mt * NT + nt) * 4 + 2 * h;
          if (v0 > 0.0f) bits[idx >> 5] |= 1u << (idx & 31);
          if (v1 > 0.0f) bits[(idx + 1) >> 5] |= 1u << ((idx + 1) & 31);
          v0 = v0 > 0.0f ? v0 : 0.0f;
          v1 = v1 > 0.0f ? v1 : 0.0f;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  if (mask) {
#pragma unroll
    for (int w = 0; w < NW; ++w) mask[w * FM_THREADS + threadIdx.x] = bits[w];
  }
}

// The sum of s over the 8 lanes of a warp that share lane % 4: one column's
// sum over the warp's rows in the accumulator layout.
__device__ __forceinline__ float warp_col_sum(float s) {
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 4);
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 8);
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 16);
  return s;
}

// Gradient epilogue: out = bf16((acc [+ g_sigma * sigma_w (+ g_sem * sem_w)])
// * relu_mask). gs (the cotangent block) adds the heads' terms when given;
// bsum, when given, receives the column sums of the f32 values before the
// rounding (the bias gradient of the PRE path), one f64 atomic per column
// and warp.
template <int NT>
__device__ __forceinline__ void epi_grad(float (&acc)[2][NT][4],
                                         const uint32_t* mask, bf16* out,
                                         int ldo, const float* gs,
                                         const FmParams& p,
                                         double* bsum = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  constexpr int NW = (2 * NT * 4 + 31) / 32;
  uint32_t bits[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w)
    bits[w] = mask ? mask[w * FM_THREADS + threadIdx.x] : 0xFFFFFFFFu;
  float cs[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) cs[nt][0] = cs[nt][1] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wn * NT * 8 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mt * 16 + g + 8 * h;
        float v[2] = {acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]};
        if (gs) {
          const float gsig = bfr(gs[row * 8 + 3]);
          v[0] += gsig * ldbf(p.sigma_w + col);
          v[1] += gsig * ldbf(p.sigma_w + col + 1);
          if (p.out_extra) {
            const float gsem = bfr(gs[row * 8 + 4]);
            v[0] += gsem * ldbf(p.sem_w + col);
            v[1] += gsem * ldbf(p.sem_w + col + 1);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int idx = (mt * NT + nt) * 4 + 2 * h + j;
          if (!((bits[idx >> 5] >> (idx & 31)) & 1u)) v[j] = 0.0f;
          cs[nt][j] += v[j];
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  if (bsum) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float s = warp_col_sum(cs[nt][j]);
        if (g == 0) atomicAdd(bsum + wn * NT * 8 + nt * 8 + 2 * t + j,
                              (double)s);
      }
  }
}

// Write (or, with add, add to) an f32 [64][NT*32] accumulator tile at the
// block's rows of dst [P][ld]: the PRE path's dx and dd.
template <int NT>
__device__ __forceinline__ void store_f32_tile(const float (&acc)[2][NT][4],
                                               float* dst, int ld, bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mt * 16 + g + 8 * h;
        const int col = wn * NT * 8 + nt * 8 + 2 * t;
        float2* o = reinterpret_cast<float2*>(dst + (size_t)row * ld + col);
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (add) {
          const float2 a = *o;
          v.x = a.x + v.x;
          v.y = a.y + v.y;
        }
        *o = v;
      }
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

__device__ __forceinline__ void encode_block(const float* __restrict__ xd,
                                             int p0, const FmParams& p,
                                             bf16* xe, bf16* de) {
  for (int i = threadIdx.x; i < FM_BM * FM_E; i += FM_THREADS) {
    const int r = i / FM_E, j = i % FM_E;
    const float* x = xd + (size_t)(p0 + r) * 8;
    xe[r * LDE + j] = __float2bfloat16_rn(pe_value(x, j, p.multires));
    de[r * LDE + j] = __float2bfloat16_rn(pe_value(x + 3, j, p.multires_views));
  }
}

// The PRE path's encodings: rows p0.. of x_enc and d_enc ([P][128] f32,
// 16-byte aligned) rounded to bf16, four lanes a thread.
__device__ __forceinline__ void load_block(const float* __restrict__ x_enc,
                                           const float* __restrict__ d_enc,
                                           int p0, bf16* xe, bf16* de) {
  constexpr int Q = FM_E / 4;
  for (int i = threadIdx.x; i < FM_BM * Q; i += FM_THREADS) {
    const int r = i / Q, c = (i - r * Q) * 4;
    const size_t off = (size_t)(p0 + r) * FM_E + c;
    const float4 a = *reinterpret_cast<const float4*>(x_enc + off);
    const float4 b = *reinterpret_cast<const float4*>(d_enc + off);
    __nv_bfloat162* xo = reinterpret_cast<__nv_bfloat162*>(xe + r * LDE + c);
    __nv_bfloat162* dout = reinterpret_cast<__nv_bfloat162*>(de + r * LDE + c);
    xo[0] = __floats2bfloat162_rn(a.x, a.y);
    xo[1] = __floats2bfloat162_rn(a.z, a.w);
    dout[0] = __floats2bfloat162_rn(b.x, b.y);
    dout[1] = __floats2bfloat162_rn(b.z, b.w);
  }
}

// Write f columns of a shared [64][lds] bf16 block to the scratch rows of
// this block's 32 point pairs: word (q, off + c) = (s[2q][c], s[2q+1][c]).
__device__ __forceinline__ void export_block(const bf16* s, int lds, int f,
                                             uint32_t* dst, int ld, int off) {
  const int half = f / 2;
  for (int i = threadIdx.x; i < (FM_BM / 2) * half; i += FM_THREADS) {
    const int q = i / half, c = (i - q * half) * 2;
    const uint32_t r0 = lds32(s + (2 * q) * lds + c);
    const uint32_t r1 = lds32(s + (2 * q + 1) * lds + c);
    uint2 o;
    o.x = __byte_perm(r0, r1, 0x5410);
    o.y = __byte_perm(r0, r1, 0x7632);
    *reinterpret_cast<uint2*>(dst + (size_t)q * ld + off + c) = o;
  }
}

// The forward through the view layer for the block at p0. Leaves the last
// trunk output in hb[(depth-1)&1], the feature in hb[depth&1], the view
// output in xe (the encoding is dead by then) and the dir encoding in de.
// BWD also keeps the ReLU masks and exports every activation. The inputs
// are xd [P][8] (in_x; in_d unused), or with PRE the encodings x_enc and
// d_enc [P][128].
template <bool BWD, bool PRE>
__device__ __forceinline__ void forward_pass(const FmParams& p,
                                             const float* __restrict__ in_x,
                                             const float* __restrict__ in_d,
                                             int p0, uint8_t* smem,
                                             uint32_t* mask, uint32_t* act,
                                             const FmLayout& lay) {
  bf16* xe = reinterpret_cast<bf16*>(smem + SM_XE);
  bf16* de = reinterpret_cast<bf16*>(smem + SM_DE);
  bf16* hb[2] = {reinterpret_cast<bf16*>(smem + SM_H0),
                 reinterpret_cast<bf16*>(smem + SM_H1)};
  bf16* bst = reinterpret_cast<bf16*>(smem + SM_B);
  const int D = p.depth;
  const bool sk = p.skip + 1 < D;

  if (PRE)
    load_block(in_x, in_d, p0, xe, de);
  else
    encode_block(in_x, p0, p, xe, de);
  __syncthreads();
  if (BWD) {
    export_block(xe, LDE, FM_E, act, lay.fa, lay.xe);
    export_block(de, LDE, FM_E, act, lay.fa, lay.de);
  }
  for (int i = 0; i < D; ++i) {
    float acc[2][8][4];
    if (i == 0)
      block_mma<8>(acc, xe, LDE, FM_E, xe, LDE, p.wt[0], FM_E, FM_E, bst);
    else if (sk && i == p.skip + 1)
      block_mma<8>(acc, xe, LDE, FM_E, hb[(i - 1) & 1], LDH, p.wt[i],
                   FM_E + FM_W, FM_E + FM_W, bst);
    else
      block_mma<8>(acc, hb[(i - 1) & 1], LDH, FM_W, hb[(i - 1) & 1], LDH,
                   p.wt[i], FM_W, FM_W, bst);
    epi_bias_act<8>(acc, p.tb[i], true, hb[i & 1], LDH,
                    BWD ? mask + i * 2 * FM_THREADS : nullptr);
    __syncthreads();
    if (BWD) export_block(hb[i & 1], LDH, FM_W, act, lay.fa, lay.h[i]);
  }
  const bf16* hl = hb[(D - 1) & 1];
  bf16* feat = hb[D & 1];
  {
    float acc[2][8][4];
    block_mma<8>(acc, hl, LDH, FM_W, hl, LDH, p.feat_wt, FM_W, FM_W, bst);
    epi_bias_act<8>(acc, p.feat_b, false, feat, LDH, nullptr);
  }
  __syncthreads();
  if (BWD) export_block(feat, LDH, FM_W, act, lay.fa, lay.feat);
  {
    float acc[2][4][4];
    block_mma<4>(acc, feat, LDH, FM_W, de, LDE, p.view_wt, FM_W + FM_E,
                 FM_W + FM_E, bst);
    epi_bias_act<4>(acc, p.view_b, true, xe, LDE,
                    BWD ? mask + D * 2 * FM_THREADS : nullptr);
  }
  __syncthreads();
  if (BWD) export_block(xe, LDE, FM_V, act, lay.fa, lay.v);
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

template <bool PRE>
__global__ void __launch_bounds__(FM_THREADS, 1)
fm_fwd_kernel(const FmParams p, const float* __restrict__ in_x,
              const float* __restrict__ in_d, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int p0 = blockIdx.x * FM_BM;
  const FmLayout none = {};
  forward_pass<false, PRE>(p, in_x, in_d, p0, smem, nullptr, nullptr, none);

  // heads on the CUDA cores: 4 lanes a point, pairs of k interleaved
  const bf16* hl = reinterpret_cast<const bf16*>(
      smem + ((p.depth - 1) & 1 ? SM_H1 : SM_H0));
  const bf16* v = reinterpret_cast<const bf16*>(smem + SM_XE);
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float s = 0.0f, se = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  for (int kk = 0; kk < FM_W / 8; ++kk) {
    const int k = 2 * q + 8 * kk;
    const __nv_bfloat162 h2 =
        *reinterpret_cast<const __nv_bfloat162*>(hl + r * LDH + k);
    const float h0 = __low2float(h2), h1 = __high2float(h2);
    s = fmaf(h0, ldbf(p.sigma_w + k), s);
    s = fmaf(h1, ldbf(p.sigma_w + k + 1), s);
    if (p.out_extra) {
      se = fmaf(h0, ldbf(p.sem_w + k), se);
      se = fmaf(h1, ldbf(p.sem_w + k + 1), se);
    }
  }
  for (int kk = 0; kk < FM_V / 8; ++kk) {
    const int k = 2 * q + 8 * kk;
    const __nv_bfloat162 v2 =
        *reinterpret_cast<const __nv_bfloat162*>(v + r * LDE + k);
    const float v0 = __low2float(v2), v1 = __high2float(v2);
    c0 = fmaf(v0, ldbf(p.rgb_w + 3 * k), c0);
    c1 = fmaf(v0, ldbf(p.rgb_w + 3 * k + 1), c1);
    c2 = fmaf(v0, ldbf(p.rgb_w + 3 * k + 2), c2);
    c0 = fmaf(v1, ldbf(p.rgb_w + 3 * k + 3), c0);
    c1 = fmaf(v1, ldbf(p.rgb_w + 3 * k + 4), c1);
    c2 = fmaf(v1, ldbf(p.rgb_w + 3 * k + 5), c2);
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    s += __shfl_xor_sync(0xFFFFFFFFu, s, m);
    se += __shfl_xor_sync(0xFFFFFFFFu, se, m);
    c0 += __shfl_xor_sync(0xFFFFFFFFu, c0, m);
    c1 += __shfl_xor_sync(0xFFFFFFFFu, c1, m);
    c2 += __shfl_xor_sync(0xFFFFFFFFu, c2, m);
  }
  if (q == 0) {
    const int nout = 4 + p.out_extra;
    float* o = out + (size_t)(p0 + r) * nout;
    o[0] = c0 + p.rgb_b[0];
    o[1] = c1 + p.rgb_b[1];
    o[2] = c2 + p.rgb_b[2];
    o[3] = s + p.sigma_b[0];
    if (p.out_extra) o[4] = se + p.sem_b[0];
  }
}

// Recompute the forward of a block, back-propagate through it, add the
// heads' weight gradients (atomics, once a block) and export A and G of the
// layers that fm_dw_kernel reduces. PRE: see the note at the top (dx, dd
// and the f32 bias sums).
template <bool PRE>
__global__ void __launch_bounds__(FM_THREADS, 1)
fm_bwd_kernel(const FmParams p, const FmGrads gr, const FmLayout lay,
              const float* __restrict__ in_x, const float* __restrict__ in_d,
              const float* __restrict__ g, uint32_t* __restrict__ act,
              uint32_t* __restrict__ grad) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xe = reinterpret_cast<bf16*>(smem + SM_XE);   // view output after fwd
  bf16* de = reinterpret_cast<bf16*>(smem + SM_DE);
  bf16* hb[2] = {reinterpret_cast<bf16*>(smem + SM_H0),
                 reinterpret_cast<bf16*>(smem + SM_H1)};
  bf16* bst = reinterpret_cast<bf16*>(smem + SM_B);
  float* gs = reinterpret_cast<float*>(smem + SM_GS);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + SM_MASK);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * FM_BM;
  const int D = p.depth;
  const bool sk = p.skip + 1 < D;
  const int nout = 4 + p.out_extra;
  uint32_t* act_blk = act + (size_t)blockIdx.x * (FM_BM / 2) * lay.fa;
  uint32_t* grad_blk = grad + (size_t)blockIdx.x * (FM_BM / 2) * lay.fg;

  forward_pass<true, PRE>(p, in_x, in_d, p0, smem, mask, act_blk, lay);
  const bf16* hl = hb[(D - 1) & 1];
  bf16* feat = hb[D & 1];
  const bf16* v = xe;

  for (int i = tid; i < FM_BM * 8; i += FM_THREADS) {
    const int r = i >> 3, c = i & 7;
    gs[i] = c < nout ? g[(size_t)(p0 + r) * nout + c] : 0.0f;
  }
  __syncthreads();

  // heads: rgb_w from v, sigma_w / sem_w from the last trunk output, with
  // the cotangent rounded to bf16; biases from the f32 cotangent
  for (int o = tid; o < FM_V * 3; o += FM_THREADS) {
    const int n = o / 3, c = o % 3;
    float s = 0.0f;
    for (int r = 0; r < FM_BM; ++r)
      s = fmaf(__bfloat162float(v[r * LDE + n]), bfr(gs[r * 8 + c]), s);
    atomicAdd(gr.rgb_w + o, s);
  }
  {
    float s = 0.0f, se = 0.0f;
    for (int r = 0; r < FM_BM; ++r) {
      const float h = __bfloat162float(hl[r * LDH + tid]);
      s = fmaf(h, bfr(gs[r * 8 + 3]), s);
      if (p.out_extra) se = fmaf(h, bfr(gs[r * 8 + 4]), se);
    }
    atomicAdd(gr.sigma_w + tid, s);
    if (p.out_extra) atomicAdd(gr.sem_w + tid, se);
  }
  if (tid < nout) {
    double s = 0.0;
    for (int r = 0; r < FM_BM; ++r) s += (double)gs[r * 8 + tid];
    atomicAdd(gr.head_b + tid, s);
  }

  // g_v = bf16((g_rgb rgb_w^T) * (view > 0)) in the view layer's
  // accumulator layout, so that each thread reads its own mask bits; it
  // replaces the dir encoding in de
  // (PRE: the f32 g_v's column sums are the view layer's bias gradient)
  double* bias64 = PRE ? gr.bias64 : nullptr;
  {
    const int warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;
    const uint32_t bits = mask[D * 2 * FM_THREADS + tid];
    float cs[4][2] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mt * 16 + gq + 8 * h;
          const int col = wn * 32 + nt * 8 + 2 * t;
          const float g0 = bfr(gs[row * 8]), g1 = bfr(gs[row * 8 + 1]),
                      g2 = bfr(gs[row * 8 + 2]);
          float o[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bf16* wr = p.rgb_w + 3 * (col + j);
            float s = g0 * ldbf(wr);
            s = fmaf(g1, ldbf(wr + 1), s);
            s = fmaf(g2, ldbf(wr + 2), s);
            const int idx = (mt * 4 + nt) * 4 + 2 * h + j;
            o[j] = (bits >> idx) & 1u ? s : 0.0f;
            cs[nt][j] += o[j];
          }
          *reinterpret_cast<__nv_bfloat162*>(de + row * LDE + col) =
              __floats2bfloat162_rn(o[0], o[1]);
        }
    if (PRE) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s = warp_col_sum(cs[nt][j]);
          if (gq == 0)
            atomicAdd(bias64 + (D + 1) * FM_W + wn * 32 + nt * 8 + 2 * t + j,
                      (double)s);
        }
    }
  }
  __syncthreads();
  export_block(de, LDE, FM_V, grad_blk, lay.fg, lay.gv);

  // g_feat = bf16(g_v view_w[:256]^T), into the feature's buffer
  {
    float acc[2][8][4];
    block_mma<8>(acc, de, LDE, FM_V, de, LDE, p.view_w, FM_V, FM_V, bst);
    epi_grad<8>(acc, nullptr, feat, LDH, nullptr, p,
                PRE ? bias64 + D * FM_W : nullptr);
  }
  if (PRE) {  // dd = (g_v view_w^T)[:, 256:], the direction slice
    float acc[2][4][4];
    block_mma<4>(acc, de, LDE, FM_V, de, LDE, p.view_w + FM_W * FM_V, FM_V,
                 FM_V, bst);
    store_f32_tile<4>(acc, gr.dd + (size_t)p0 * FM_E, FM_E, false);
  }
  __syncthreads();
  export_block(feat, LDH, FM_W, grad_blk, lay.fg, lay.gfeat);

  // g_z of the last trunk layer: (g_feat feat_w^T + heads) * mask
  {
    float acc[2][8][4];
    block_mma<8>(acc, feat, LDH, FM_W, feat, LDH, p.feat_w, FM_W, FM_W, bst);
    epi_grad<8>(acc, mask + (D - 1) * 2 * FM_THREADS, hb[(D - 1) & 1], LDH,
                gs, p, PRE ? bias64 + (D - 1) * FM_W : nullptr);
  }
  __syncthreads();
  export_block(hb[(D - 1) & 1], LDH, FM_W, grad_blk, lay.fg, lay.gz[D - 1]);

  // the trunk: g_z(i-1) = bf16((g_z(i) tw_i^T)[h part] * mask(i-1)); PRE
  // also writes the skip layer's encoding slice into dx
  bool dx_written = false;
  for (int i = D - 1; i >= 1; --i) {
    const bf16* gin = hb[i & 1];
    bf16* gout = hb[(i - 1) & 1];
    const bool cat = sk && i == p.skip + 1;
    if (PRE && cat) {
      float acc[2][4][4];
      block_mma<4>(acc, gin, LDH, FM_W, gin, LDH, p.w[i], FM_W, FM_W, bst);
      store_f32_tile<4>(acc, gr.dx + (size_t)p0 * FM_E, FM_E, false);
      dx_written = true;
    }
    const bf16* w = cat ? p.w[i] + FM_E * FM_W : p.w[i];
    float acc[2][8][4];
    block_mma<8>(acc, gin, LDH, FM_W, gin, LDH, w, FM_W, FM_W, bst);
    epi_grad<8>(acc, mask + (i - 1) * 2 * FM_THREADS, gout, LDH, nullptr, p,
                PRE ? bias64 + (i - 1) * FM_W : nullptr);
    __syncthreads();
    export_block(gout, LDH, FM_W, grad_blk, lay.fg, lay.gz[i - 1]);
  }
  if (PRE) {  // dx += g_z0 W0^T (each thread adds to the entries it wrote)
    float acc[2][4][4];
    block_mma<4>(acc, hb[0], LDH, FM_W, hb[0], LDH, p.w[0], FM_W, FM_W, bst);
    store_f32_tile<4>(acc, gr.dx + (size_t)p0 * FM_E, FM_E, dx_written);
  }
}

// dW = A^T G over all points, for every layer whose A and G the backward
// exported. blockIdx.x enumerates (layer, 128 x 128 output tile),
// blockIdx.y a slice of the points (split-K); each slice adds its sum once.
#define DW_BI 128
#define DW_BJ 128
#define DW_PAIRS 16             // point pairs (32 points) per stage
#define DW_LD (DW_BI + 8)    // words
#define DW_MAX_LAYERS (FM_MAX_DEPTH + 2)

struct DwLayer {
  int a_off, k, g_off, n, tile0, tiles_j;
  float* dw;
  float* db;
};

struct DwPlan {
  int n;
  DwLayer l[DW_MAX_LAYERS];
};

__global__ void __launch_bounds__(FM_THREADS, 1)
fm_dw_kernel(const uint32_t* __restrict__ act, int fa,
             const uint32_t* __restrict__ grad, int fg, const DwPlan plan,
             int n_chunks, int chunks_per_split) {
  __shared__ __align__(16) uint32_t sa[2][DW_PAIRS][DW_LD];
  __shared__ __align__(16) uint32_t sg[2][DW_PAIRS][DW_LD];
  int li = 0;
  while (li + 1 < plan.n && (int)blockIdx.x >= plan.l[li + 1].tile0) ++li;
  const DwLayer L = plan.l[li];
  const int tile = blockIdx.x - L.tile0;
  const int i0 = (tile / L.tiles_j) * DW_BI, j0 = (tile % L.tiles_j) * DW_BJ;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  if (c_begin >= c_end) return;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wi = warp >> 2, wj = warp & 3;   // warp tile 64 x 32
  const bool do_bias = i0 == 0 && L.db != nullptr;   // null on the PRE path
  const uint32_t* abase = act + L.a_off + i0;
  const uint32_t* gbase = grad + L.g_off + j0;

  float sum[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[mt][nt][c] = 0.0f;
  float bsum = 0.0f;

  auto load = [&](int st, int chunk) {
    const size_t pr0 = (size_t)chunk * DW_PAIRS;
    for (int c = tid; c < DW_PAIRS * (DW_BI / 4); c += FM_THREADS) {
      const int r = c >> 5, q = c & 31;
      cp_async16(&sa[st][r][q * 4], abase + (pr0 + r) * fa + q * 4);
      cp_async16(&sg[st][r][q * 4], gbase + (pr0 + r) * fg + q * 4);
    }
  };
  load(0, c_begin);
  cp_async_commit();
  for (int c = c_begin; c < c_end; ++c) {
    const int st = (c - c_begin) & 1;
    if (c + 1 < c_end) load(st ^ 1, c + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (do_bias && tid < DW_BJ) {
      for (int r = 0; r < DW_PAIRS; ++r) {
        const uint32_t w = sg[st][r][tid];
        bsum += __uint_as_float(w << 16) + __uint_as_float(w & 0xFFFF0000u);
      }
    }
    // the tensor core's accumulator holds 32 points; the running sum is
    // kept outside it in f32
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int r0 = ks * 8 + t;
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int m = wi * 64 + mt * 16 + g;
        af[mt][0] = sa[st][r0][m];
        af[mt][1] = sa[st][r0][m + 8];
        af[mt][2] = sa[st][r0 + 4][m];
        af[mt][3] = sa[st][r0 + 4][m + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wj * 32 + nt * 8 + g;
        const uint32_t b0 = sg[st][r0][n], b1 = sg[st][r0 + 4][n];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][nt][e] += acc[mt][nt][e];
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i0 + wi * 64 + mt * 16 + g + 8 * h;
        const int col = j0 + wj * 32 + nt * 8 + 2 * t;
        red_add2(L.dw + (size_t)row * L.n + col, sum[mt][nt][2 * h],
                 sum[mt][nt][2 * h + 1]);
      }
  if (do_bias && tid < DW_BJ) atomicAdd(L.db + j0 + tid, bsum);
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

template <bool PRE>
static int fm_fwd_launch(const FmParams* p, const void* in_x,
                         const void* in_d, void* out, int n_points,
                         void* stream) {
  int err = fm_check(p, n_points, PRE);
  if (err || n_points == 0) return err;
  err = (int)cudaFuncSetAttribute(fm_fwd_kernel<PRE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SM_FWD_END);
  if (err) return err;
  fm_fwd_kernel<PRE><<<n_points / FM_BM, FM_THREADS, SM_FWD_END,
                       (cudaStream_t)stream>>>(
      *p, (const float*)in_x, (const float*)in_d, (float*)out);
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

// act: (n_points / 2) x fa words, grad: (n_points / 2) x fg words of
// scratch (fm_scratch_cols); every gradient in `gr` zeroed by the caller
// (with PRE: bias64 too; dx and dd are written whole).
template <bool PRE>
static int fm_bwd_launch(const FmParams* p, const FmGrads* gr,
                         const void* in_x, const void* in_d, const void* g,
                         void* act, void* grad, int n_points, void* stream) {
  int err = fm_check(p, n_points, PRE);
  if (err || n_points == 0) return err;
  if (PRE && (!gr->bias64 || !gr->dx || !gr->dd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FmLayout lay;
  fm_layout(p->depth, p->skip, &lay);
  const int smem = SM_BWD_END(p->depth);
  err = (int)cudaFuncSetAttribute(fm_bwd_kernel<PRE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  fm_bwd_kernel<PRE><<<n_points / FM_BM, FM_THREADS, smem, s>>>(
      *p, *gr, lay, (const float*)in_x, (const float*)in_d, (const float*)g,
      (uint32_t*)act, (uint32_t*)grad);
  err = (int)cudaGetLastError();
  if (err) return err;

  DwPlan plan;
  plan.n = 0;
  int tiles = 0;
  const bool sk = p->skip + 1 < p->depth;
  for (int i = 0; i < p->depth + 2; ++i) {
    DwLayer& L = plan.l[plan.n++];
    if (i < p->depth) {
      const bool cat = sk && i == p->skip + 1;
      L.a_off = (i == 0 || cat) ? lay.xe : lay.h[i - 1];
      L.k = i == 0 ? FM_E : cat ? FM_E + FM_W : FM_W;
      L.g_off = lay.gz[i];
      L.n = FM_W;
      L.dw = gr->tw[i];
      L.db = gr->tb[i];
    } else if (i == p->depth) {
      L.a_off = lay.h[p->depth - 1];
      L.k = FM_W;
      L.g_off = lay.gfeat;
      L.n = FM_W;
      L.dw = gr->feat_w;
      L.db = gr->feat_b;
    } else {
      L.a_off = lay.feat;
      L.k = FM_W + FM_E;
      L.g_off = lay.gv;
      L.n = FM_V;
      L.dw = gr->view_w;
      L.db = gr->view_b;
    }
    if (PRE) L.db = nullptr;   // summed in f32 by fm_bwd_kernel
    L.tile0 = tiles;
    L.tiles_j = L.n / DW_BJ;
    tiles += (L.k / DW_BI) * L.tiles_j;
  }
  // about four waves of one block per SM on the H100's 132 SMs
  const int n_chunks = n_points / (2 * DW_PAIRS);
  int splits = (4 * 132 + tiles - 1) / tiles;
  if (splits > n_chunks) splits = n_chunks;
  const int per = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + per - 1) / per;
  fm_dw_kernel<<<dim3(tiles, splits), FM_THREADS, 0, s>>>(
      (const uint32_t*)act, lay.fa, (const uint32_t*)grad, lay.fg, plan,
      n_chunks, per);
  return (int)cudaGetLastError();
}

extern "C" int fm_bwd(const FmParams* p, const FmGrads* gr, const void* xd,
                      const void* g, void* act, void* grad, int n_points,
                      void* stream) {
  return fm_bwd_launch<false>(p, gr, xd, nullptr, g, act, grad, n_points,
                              stream);
}

// The pre-encoded backward (kernel #8): also writes gr->dx, gr->dd.
extern "C" int fm_bwd_pre(const FmParams* p, const FmGrads* gr,
                          const void* x_enc, const void* d_enc, const void* g,
                          void* act, void* grad, int n_points, void* stream) {
  return fm_bwd_launch<true>(p, gr, x_enc, d_enc, g, act, grad, n_points,
                             stream);
}

extern "C" const char* fm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
