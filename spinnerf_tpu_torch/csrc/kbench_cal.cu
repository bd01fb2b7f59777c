// Matrix-rate calibration for Hopper (sm_90a): repeated bf16 products on the
// tensor cores.
//
// Replaces the Pallas kernel of tools/kbench.py: _cal_kernel (:63;
// pallas_call :77 in calibrate). For each of `blocks` blocks i it computes
// reps times the product a[i, :, :k] b[i, :k, :], a [blocks][128][128] bf16
// and b [blocks][128][512] bf16, adds the f32 products and writes the sum,
// [blocks][128][512] f32 (cal_plain in spinnerf_tpu_torch/tools/
// kbench.py computes the same).
//
// What bounds it on an H100: at reps 8 and k 128 it moves 1.745 GB (0.52 ms
// at 3.35 TB/s) for 0.55 TFLOP (0.56 ms at 989 TFLOP/s), so neither clearly;
// at reps 64 the products take ~8x the bytes' time and the tensor cores
// bound it, which is what a calibration wants to see. The design, first
// version: one block of 256 threads per i stages a[i][:, :k] and b[i][:k, :]
// in shared memory once (up to 34 KB + 130 KB), then walks the 512 output
// columns in four 128-column chunks; for each chunk each of the 8 warps owns
// a 64 x 32 tile and repeats the whole k-deep product reps times with
// mma.sync m16n8k16 (fragments from shared memory with ldmatrix, b's through
// .trans since b is stored n-contiguous), adding each repetition's f32
// product to a running sum outside the tensor core's accumulator, as the
// TPU kernel adds its dot products. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define KC_M 128        // rows of a block
#define KC_KMAX 128     // columns of a
#define KC_N 512        // columns of b and of the output
#define KC_NC 128       // output columns a pass
#define KC_THREADS 256
#define KC_LDA (KC_KMAX + 8)   // shared row pitches in bf16, padded against
#define KC_LDB (KC_N + 8)      // bank conflicts

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same from row-major [k][n] storage, transposed into the B fragment:
// register j holds (k = 2 (lane % 4) + {0, 1}, n = lane / 4) of matrix j.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__global__ void __launch_bounds__(KC_THREADS, 1)
kc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
          float* __restrict__ out, int k, int reps) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);                    // [128][LDA]
  bf16* sb = sa + KC_M * KC_LDA;                               // [k][LDB]
  const size_t i = blockIdx.x;
  const bf16* ai = a + i * KC_M * KC_KMAX;
  const bf16* bi = b + i * KC_KMAX * KC_N;
  float* oi = out + i * KC_M * KC_N;

  // stage a[:, :k] and b[:k, :], 16 bytes a thread and step
  const int qa = k / 8;
  for (int c = threadIdx.x; c < KC_M * qa; c += KC_THREADS) {
    const int r = c / qa, q = c - r * qa;
    *reinterpret_cast<uint4*>(sa + r * KC_LDA + q * 8) =
        *reinterpret_cast<const uint4*>(ai + r * KC_KMAX + q * 8);
  }
  constexpr int QB = KC_N / 8;
  for (int c = threadIdx.x; c < k * QB; c += KC_THREADS) {
    const int r = c / QB, q = c - r * QB;
    *reinterpret_cast<uint4*>(sb + r * KC_LDB + q * 8) =
        *reinterpret_cast<const uint4*>(bi + r * KC_N + q * 8);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile 64 x 32
  for (int n0 = 0; n0 < KC_N; n0 += KC_NC) {
    const int ncol = n0 + wn * 32;
    float sum[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[mt][nt][c] = 0.0f;
    for (int rep = 0; rep < reps; ++rep) {
      float part[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
      for (int k0 = 0; k0 < k; k0 += 16) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm_x4(af[mt], sa + (wm * 64 + mt * 16 + (lane & 15)) * KC_LDA +
                              k0 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          // matrix j = lane / 8: k rows k0 + (j & 1) * 8.., n columns
          // ncol + nt * 8 + (j >> 1) * 8..
          uint32_t bf[4];
          const int j = lane >> 3;
          ldsm_x4_trans(bf, sb + (k0 + (j & 1) * 8 + (lane & 7)) * KC_LDB +
                                ncol + nt * 8 + (j >> 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma16816(part[mt][nt], af[mt], bf[0], bf[1]);
            mma16816(part[mt][nt + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[mt][nt][c] += part[mt][nt][c];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 64 + mt * 16 + g + 8 * h;
          const int col = ncol + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(oi + (size_t)row * KC_N + col) =
              make_float2(sum[mt][nt][2 * h], sum[mt][nt][2 * h + 1]);
        }
  }
}

// C interface, bound with ctypes: device pointers a, b, out; launches on
// `stream`, does not synchronise, returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int kc_run(const void* a, const void* b, void* out, int blocks,
                      int k, int reps, void* stream) {
  if (blocks < 0 || k < 16 || k > KC_KMAX || k % 16 || reps < 1)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const int smem = (KC_M * KC_LDA + k * KC_LDB) * 2;
  int err = (int)cudaFuncSetAttribute(
      kc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kc_kernel<<<blocks, KC_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)b, (float*)out, k, reps);
  return (int)cudaGetLastError();
}

extern "C" const char* kc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
