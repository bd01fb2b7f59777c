// Matrix-rate calibration for Hopper (sm_90a): repeated bf16 products on the
// tensor cores with wgmma.
//
// Replaces the Pallas kernel of tools/kbench.py: _cal_kernel (:63;
// pallas_call :77 in calibrate). For each of `blocks` blocks i it computes
// reps times the product a[i, :, :k] b[i, :k, :], a [blocks][128][128] bf16
// and b [blocks][128][512] bf16, adds the f32 products and writes the sum,
// [blocks][128][512] f32 (cal_plain in spinnerf_tpu_torch/tools/
// kbench.py computes the same).
//
// What bounds it on an H100: at reps 8 and k 128 it moves 1.745 GB (0.52 ms
// at 3.35 TB/s) for 0.55 TFLOP (0.56 ms at 989 TFLOP/s), so both about
// equally, and the kernel reaches its bound only if the loads and stores
// of one tile overlap the products of another; at reps 64 the products take
// ~8x the bytes' time and the tensor cores bound it, which is what a
// calibration wants to see.
//
// The design. The unit of work is (i, a quarter of the 512 output
// columns): A = a[i][128][:k] and B = b[i][:k][128 columns], 64 KB at k
// 128, with a [128][128] f32 output. A stage of all 512 columns (160 KB)
// would not fit twice in the 227 KB of shared memory, so nothing could load
// while the products run; a quarter's stage fits three times, and a
// quarter's accumulators fit the registers (below). A is read by the four
// quarters of its i, which run side by side on neighbouring blocks (units
// are numbered i * 4 + quarter) and meet it in L2, so device memory still
// sees each input once. The blocks are persistent, one an SM, each walking
// the units blockIdx.x, + gridDim.x, ...:
//   - a producer warp, of which one thread works, loads each unit's A and B
//     with TMA (cp.async.bulk.tensor, two tensor maps whose 128-byte
//     swizzle is the layout wgmma reads) into the next slot of a ring of
//     KC_SLOTS stages, a full mbarrier a slot counting the bytes and an
//     empty one the 8 consumer warps' releases, so the loads of the next
//     two units run under the current unit's products;
//   - two consumer warpgroups, one for each 64-row half of the unit, each
//     taking every repetition's k-deep product on wgmma m64n128k16 (A
//     K-major, B MN-major: b is n-contiguous) into a fresh accumulator, then
//     adding it to the f32 running sum in registers (the TPU kernel's
//     acc + dot): 64 + 64 registers a thread. While one warpgroup adds, the
//     other's products keep the tensor cores busy;
//   - each consumer stores its [64][128] sum from registers (8 rows x 32
//     bytes a warp instruction, whole sectors) as soon as its last
//     repetition is added and goes on to its next unit: the stores drain
//     while the next unit's products run.
// A wait on a ring barrier that lasts 2^32 clocks traps: a fault of the
// schedule fails the launch instead of hanging the card.
#include <cuda.h>   // CUtensorMap and its enums (the function: at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define KC_M 128         // rows of a block
#define KC_KMAX 128      // columns of a
#define KC_N 512         // columns of b and of the output
#define KC_NU 128        // output columns of a unit
#define KC_QUARTERS (KC_N / KC_NU)
#define KC_CONSUMERS 256 // two warpgroups
#define KC_THREADS (KC_CONSUMERS + 32)
#define KC_SLOTS 3       // stages of the ring
#define KC_TILE 8192     // bytes of a swizzled [64][64] bf16 tile
#define KC_ALIGN 1024    // the 128-byte swizzle repeats every 1024 bytes
#define KC_SMEM_MAX 232448

// The bytes of a unit's stage at depth k (tools/kbench.py::cal_plan
// computes the same): A as [2 row halves][ka][64][64] K-major tiles, ka =
// ceil(k / 64) (TMA loads whole 64-column tiles of a; the products read k
// columns); B as [2 column halves][k][64] MN-major tiles.
__host__ __device__ __forceinline__ uint32_t kc_a_bytes(int k) {
  return 2u * ((k + 63) / 64) * KC_TILE;
}
__host__ __device__ __forceinline__ uint32_t kc_b_bytes(int k) {
  return 2u * k * 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
// keeps the compiler from reading accumulators before wg_wait0
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, one 16-deep step of m64n128k16: A K-major, B MN-major
// (transposed); scale_d = 0 starts a fresh accumulator.
__device__ __forceinline__ void wgmma_n128_kn(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
// A 2-D box of the tensor map at (column c0, row c1) into shared memory at
// dst, its bytes counted on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Threads 0-255: the consumers (warpgroup wg the rows wg * 64..); thread
// 256: the producer. Shared memory from a 1024-aligned base: KC_SLOTS
// stages, then the full and the empty barriers.
// KS = k / 16, the 16-deep steps of a product: a compile-time count, so
// that the steps unroll and no code between two wgmma touches the
// accumulator.
template <int KS>
__global__ void __launch_bounds__(KC_THREADS, 1)
kc_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                float* __restrict__ out, int units, int reps) {
  constexpr int k = 16 * KS, ka = (k + 63) / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + KC_ALIGN - 1) & ~(uintptr_t)(KC_ALIGN - 1));
  const uint32_t sb = smem_u32(smem);
  const uint32_t a_bytes = kc_a_bytes(k), stage = a_bytes + kc_b_bytes(k);
  const uint32_t full = sb + KC_SLOTS * stage, empty = full + 8 * KC_SLOTS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < KC_SLOTS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, KC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= KC_CONSUMERS) {   // the producer warp: one thread works
    if (tid != KC_CONSUMERS) return;
    int s = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++s) {
      const int slot = s % KC_SLOTS;
      if (s >= KC_SLOTS) mbar_wait(empty + 8 * slot, ((s / KC_SLOTS) - 1) & 1);
      const uint32_t bar = full + 8 * slot, dst = sb + slot * stage;
      mbar_expect(bar, stage);
      const int row0 = (u / KC_QUARTERS) * KC_M;
      const int col0 = (u % KC_QUARTERS) * KC_NU;
      for (int h = 0; h < 2; ++h)
        for (int kt = 0; kt < ka; ++kt)
          tma_load(dst + (h * ka + kt) * KC_TILE, &map_a, kt * 64,
                   row0 + h * 64, bar);
      for (int j = 0; j < 2; ++j)
        tma_load(dst + a_bytes + j * k * 128, &map_b, col0 + j * 64, row0,
                 bar);
    }
    return;
  }

  const int wg = tid >> 7, lane = tid & 31;
  // this thread's place in the m64n128 accumulator: element 4j + 2h + e is
  // row r0 + 8h, column 8j + 2 (lane % 4) + e
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2), c0 = 2 * (lane & 3);
  int s = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++s) {
    const int slot = s % KC_SLOTS;
    mbar_wait(full + 8 * slot, (s / KC_SLOTS) & 1);
    const uint32_t a = sb + slot * stage + wg * ka * KC_TILE;
    const uint32_t b = sb + slot * stage + a_bytes;
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
    for (int rep = 0; rep < reps; ++rep) {
      float part[64];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_n128_kn(part,
                      desc_sw128(a + (ks >> 2) * KC_TILE + (ks & 3) * 32, 16,
                                 1024),
                      desc_sw128(b + ks * 2048, k * 128, 1024), ks);
      wg_commit();
      wg_wait0();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += part[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    float* o = out + ((size_t)(u / KC_QUARTERS) * KC_M + wg * 64 + r0) * KC_N +
               (u % KC_QUARTERS) * KC_NU + c0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(o + (size_t)(8 * h) * KC_N + 8 * j) =
            make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link
// against libcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A [rows][cols] bf16 row-major tensor map whose box is [box_rows][64
// columns] in the 128-byte swizzle.
static int make_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                    uint64_t cols, uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int KS>
static int kc_launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
                     void* out, int units, int reps, int grid, int smem,
                     void* stream) {
  int err = (int)cudaFuncSetAttribute(
      kc_wgmma_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kc_wgmma_kernel<KS><<<grid, KC_THREADS, smem, (cudaStream_t)stream>>>(
      map_a, map_b, (float*)out, units, reps);
  return (int)cudaGetLastError();
}

// C interface, bound with ctypes: device pointers a, b, out; `grid`
// persistent blocks and `smem` bytes of shared memory a block, as
// tools/kbench.py::cal_plan computes them (at most one block an SM; a
// shared size other than this source's is refused); launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int kc_run(const void* a, const void* b, void* out, int blocks,
                      int k, int reps, int grid, int smem, void* stream) {
  if (blocks < 0 || k < 16 || k > KC_KMAX || k % 16 || reps < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (smem != (int)(KC_SLOTS * (kc_a_bytes(k) + kc_b_bytes(k)) +
                    16 * KC_SLOTS + KC_ALIGN) ||
      smem > KC_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  CUtensorMap map_a, map_b;
  int err = make_map(&map_a, a, (uint64_t)blocks * KC_M, KC_KMAX, 64);
  if (!err) err = make_map(&map_b, b, (uint64_t)blocks * KC_KMAX, KC_N, k);
  if (err) return err;
  const int units = blocks * KC_QUARTERS;
  grid = grid < units ? grid : units;
  switch (k / 16) {
    case 1: return kc_launch<1>(map_a, map_b, out, units, reps, grid, smem,
                                stream);
    case 2: return kc_launch<2>(map_a, map_b, out, units, reps, grid, smem,
                                stream);
    case 3: return kc_launch<3>(map_a, map_b, out, units, reps, grid, smem,
                                stream);
    case 4: return kc_launch<4>(map_a, map_b, out, units, reps, grid, smem,
                                stream);
    case 5: return kc_launch<5>(map_a, map_b, out, units, reps, grid, smem,
                                stream);
    case 6: return kc_launch<6>(map_a, map_b, out, units, reps, grid, smem,
                                stream);
    case 7: return kc_launch<7>(map_a, map_b, out, units, reps, grid, smem,
                                stream);
    default: return kc_launch<8>(map_a, map_b, out, units, reps, grid, smem,
                                 stream);
  }
}

extern "C" const char* kc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
