// One layer of the wav2vec2 feature extractor's strided conv stack:
// VALID Conv1d with no bias, then the exact (erf) GELU, cast to x's type.
//
// Replaces the TPU kernel speecht5_tpu/ops/pallas_kernels.py
// conv_stack_pallas (:714, pallas_call :753, body _conv_stack_kernel :682,
// reached through conv_stack_fused :783), which runs feature-extractor
// layers 1-6 ((k, s) = (3, 2) x 4, then (2, 2) x 2, 512 channels) in one
// program with every intermediate in VMEM.  That does not carry to Hopper:
// the input span of 32 final frames alone is ~2,000 rows x 512 channels, far
// beyond the 227 KB of shared memory a block can use.  So the Python wrapper
// launches one kernel per layer and the intermediates go through device
// memory.
//
// Each launch is an implicit GEMM:
//
//   y[b, t, co] = gelu( sum_{j < k} sum_{ci} x[b, t*s + j, ci] * w[j, ci, co] )
//
// For tap j, A_j[t, ci] = x[b, t*s + j, ci] is a strided view of x (row
// stride s*Cin), so the layer is k GEMMs against the k slices of w, summed
// in one accumulator: no im2col buffer is ever written.
//
// Two routes, chosen by dtype (the wrapper never hands one dtype to the
// other's kernel):
//
// * bf16 (the path's dtype): wgmma tensor cores fed by TMA.  An output tile
//   is 256 (t) x 128 (co) of one batch row, or 128 x 128 where those fit in
//   one wave of the SMs (the small late layers; tiles never cross a batch
//   row);
//   one persistent block an SM walks the tiles (grid = min(tiles, SMs), so
//   M has no grid cap), the channel tiles of a row tile next to each other
//   so that they find its A rows in L2.  A tile's K loop walks the k taps x
//   ceil(Cin / 64) channel blocks.  One producer warp starts, per K step,
//   TMA loads into a 4-stage ring of shared memory (6 stages for 128-row
//   tiles; 128-byte swizzle),
//   running ahead into the next tile while the consumers finish this one: a
//   256 x 64 box of A_j from a 3D tensor map per tap (dims {Cin, T_out, B},
//   strides {s*Cin, T_in*Cin} elements, base x + j*Cin), and two 64 x 64
//   boxes of w[j] (dims {Cout, Cin, k}) that wgmma reads as an MN-major B,
//   so w needs no transpose.  TMA zero-fills rows past T_out and channels
//   past Cin or Cout.  Completion is counted on one mbarrier per stage.
//   Four (or two) consumer warpgroups each run four wgmma.mma_async
//   m64n128k16 (bf16
//   in, f32 accumulators in registers) per K step on their 64 rows, keep
//   one group in flight, and release the stage behind it to the producer.
//   The epilogue applies the exact GELU in f32, rounds to bf16 once and
//   stores bf16 pairs with the T_out and Cout tails predicated.  Needs Cin %
//   8 == 0 and Cout % 8 == 0 (16-byte TMA strides) and k <= 8 tensor maps;
//   the wrapper raises on anything else.
//
// * f32: the first design, a 64 x 64-tile implicit GEMM on the CUDA cores
//   (16-deep K slices in shared memory, a 4 x 4 micro-tile per thread, f32
//   FMAs).  wgmma has no full-f32 product, only TF32, which keeps about
//   three decimal digits and would break the f32 parity of 1e-4.
//
// What bounds it on an H100: at the Base shapes (16 s bucket, B 1) the stack
// is 78 GFLOP against ~0.1 GB of input, weights and output, so it is bound
// by operations: 0.079 ms at the 989 TFLOP/s bf16 peak.  Layer 1 (M 25599,
// N 512, K 1536) is 52% of the work.  The first design ran the bf16 stack
// on the CUDA cores in f32 (scalar loads, two barriers per 16-deep slice) at
// 4.235 ms, about 18 TFLOP/s (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py);
// the tensor cores are what this design adds.  What is left: wave
// quantization (layer 1 at B 1 is 800 tiles on 132 SMs, so some SMs take 7
// tiles and others 6; layers 5-6 have 52 and 28 tiles and leave most SMs
// idle), and the epilogue's GELU and stores, which overlap the next tile's
// loads but not its products.
//
// x: [B, T_in, Cin]; w: [k, Cin, Cout]; y: [B, T_out, Cout]; one dtype for
// all.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- f32 route

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__global__ void __launch_bounds__(THREADS)
conv_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int B, int T_in, int Cin, int T_out, int Cout,
                     int ksize, int stride) {
  __shared__ float As[BKK][BM + 4];  // A tile, transposed: As[kk][m]
  __shared__ float Bs[BKK][BN];

  const int K = ksize * Cin;
  const long long M = (long long)B * T_out;
  const int n0 = blockIdx.y * BN;
  const long long m0 = (long long)blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // A loader: row a_row of the tile, 4 consecutive kk from a_k
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const long long am = m0 + a_row;
  const float* a_ptr = nullptr;
  if (am < M) {
    const long long b = am / T_out, t = am - b * T_out;
    a_ptr = x + (b * T_in + t * stride) * (long long)Cin;
  }
  // B loader: row b_k of the tile, 4 consecutive columns from b_n
  const int b_k = tid / 16, b_n = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + a_k + e;
      As[a_k + e][a_row] = (a_ptr != nullptr && kk < K) ? a_ptr[kk] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + b_k, nn = n0 + b_n + e;
      Bs[b_k][b_n + e] = (kk < K && nn < Cout) ? w[(long long)kk * Cout + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * bv[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int nn = n0 + tx + 16 * c;
      if (nn < Cout) y[m * Cout + nn] = gelu_exact(acc[r][c]);
    }
  }
}

// ------------------------------------------------------------ bf16 route

constexpr int WG_BN = 128;                 // output channels per tile
constexpr int WG_BK = 64;                  // channels per K step: one 128-byte row
constexpr int B_HALF_BYTES = 64 * 64 * 2;  // a B box: 64 channels x 64 outputs
constexpr int MAX_TAPS = 8;

// Tile shapes: C consumer warpgroups of 64 output rows each (C = 4 for the
// big layers, 2 where 128-row tiles fit in one wave of the SMs).
template <int C>
struct Tile {
  static constexpr int BM = 64 * C;                        // output rows (t) per tile
  static constexpr int A_BYTES = BM * WG_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF_BYTES;
  static constexpr int STAGES = C == 4 ? 4 : 6;            // 192 KB either way
  static constexpr int THREADS = 128 * C + 32;             // + one producer warp
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment
};

struct ConvMaps {
  CUtensorMap a[MAX_TAPS];  // per tap j: rows t*s + j of x, dims {Cin, T_out, B}
  CUtensorMap b;            // w: dims {Cout, Cin, k}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a tile with 128-byte rows in TMA's
// 128-byte swizzle, atoms of 8 rows (1024 bytes) starting 1024-byte
// aligned.  K-major (A): SBO = 1024 steps over 8-row groups of M, LBO is
// unused.  MN-major (B: K rows of 64 output channels): LBO steps to the
// next 64 channels, SBO = 1024 to the next 8 rows of K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], A K-major and B MN-major
// (transposed) in shared memory; each thread of the warpgroup holds 64 f32
// accumulators.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Persistent: grid = min(tiles, SMs), one block an SM walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...; the channel tiles of one row tile
// are neighbours, so the A rows they share come from L2.  The producer runs
// ahead across tiles, filling the ring for the next tile while the
// consumers run the epilogue of this one.
template <int C>
__global__ void __launch_bounds__(Tile<C>::THREADS, 1)
conv_gelu_wgmma_kernel(const __grid_constant__ ConvMaps maps, __nv_bfloat16* __restrict__ y,
                       int T_out, int Cout, int Cin, int ksize, int tiles_m, int tiles_n,
                       int n_tiles) {
  using TL = Tile<C>;
  constexpr int STAGES = TL::STAGES, STAGE_BYTES = TL::STAGE_BYTES, A_BYTES = TL::A_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms must start 1024-byte aligned
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x;
  const int kc = (Cin + WG_BK - 1) / WG_BK;  // channel blocks per tap
  const int iters = ksize * kc;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx arrival + the TMA bytes
      mbar_init(empty(s), C);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // g counts K steps over all of this block's tiles: stage g % STAGES, in
  // its (g / STAGES)-th use
  if (tid >= 128 * C) {  // producer warp: one thread keeps the ring full
    if (tid == 128 * C) {
      int g = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int mt = tile / tiles_n, n0 = (tile - mt * tiles_n) * WG_BN;
        const int b = mt / tiles_m, t0 = (mt - b * tiles_m) * TL::BM;
        for (int it = 0; it < iters; ++it, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty(s), ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          const int j = it / kc, c = (it - j * kc) * WG_BK;
          const uint32_t a_dst = base + s * STAGE_BYTES, b_dst = a_dst + A_BYTES;
          tma_load_3d(a_dst, &maps.a[0] + j, full(s), c, t0, b);
          tma_load_3d(b_dst, &maps.b, full(s), n0, c, j);
          tma_load_3d(b_dst + B_HALF_BYTES, &maps.b, full(s), n0 + 64, c, j);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of each tile
  const int wg = tid / 128;
  const bool lead = tid % 128 == 0;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  int g = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int mt = tile / tiles_n, n0 = (tile - mt * tiles_n) * WG_BN;
    const int b = mt / tiles_m, t0 = (mt - b * tiles_m) * TL::BM;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;

    for (int it = 0; it < iters; ++it, ++g) {
      const int s = g % STAGES;
      mbar_wait(full(s), (g / STAGES) & 1);
      const uint32_t a0 = base + s * STAGE_BYTES + wg * 64 * 128;
      const uint32_t b0 = base + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)  // 16 channels: 32 bytes of A's rows, 16 rows of B
        wgmma_m64n128k16(d, desc_sw128(a0 + kk * 32, 16),
                         desc_sw128(b0 + kk * 16 * 128, B_HALF_BYTES));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with their stage
      if (it > 0 && lead) mbar_arrive(empty((g - 1) % STAGES));
    }
    wgmma_wait<0>();
    if (lead) mbar_arrive(empty((g - 1) % STAGES));

    // accumulator layout of m64nNk16: d[i] is row warp*16 + lane/4 +
    // 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2
    const int row0 = t0 + wg * 64 + warp * 16 + lane / 4;
    __nv_bfloat16* yb = y + (size_t)b * T_out * Cout;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = n0 + 8 * (i >> 2) + 2 * (lane & 3);
      if (row < T_out && col < Cout)  // Cout is even: the pair is in or out as one
        *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)row * Cout + col) =
            __floats2bfloat162_rn(gelu_exact(d[i]), gelu_exact(d[i + 1]));
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiledFn lookup_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                   cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// A bf16 tensor map with a 128-byte-swizzled box whose inner extent is one
// 128-byte row; returns 0 or the CUresult.
int encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                 strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool conv_args_ok(int B, int T_in, int Cin, int T_out, int Cout, int ksize, int stride) {
  return B > 0 && Cin > 0 && Cout > 0 && ksize > 0 && stride > 0 && T_out > 0 &&
         (long long)(T_out - 1) * stride + ksize <= T_in;
}

// Encodes the tensor maps for tiles of Tile<C>::BM rows and launches the
// persistent kernel on min(tiles, sms) blocks.
template <int C>
int launch_wgmma(EncodeTiledFn fn, const __nv_bfloat16* x, const __nv_bfloat16* w,
                 __nv_bfloat16* y, int B, int T_in, int Cin, int T_out, int Cout, int ksize,
                 int stride, int sms, cudaStream_t stream) {
  using TL = Tile<C>;
  const long long tiles_m = (T_out + TL::BM - 1) / TL::BM, tiles_n = (Cout + WG_BN - 1) / WG_BN;
  const long long n_tiles = tiles_m * tiles_n * B;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;

  ConvMaps maps;
  const cuuint32_t box[3] = {WG_BK, TL::BM, 1};
  const cuuint64_t a_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)T_out, (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {(cuuint64_t)stride * Cin * 2, (cuuint64_t)T_in * Cin * 2};
  for (int j = 0; j < ksize; ++j) {
    const int r = encode(fn, &maps.a[j], x + (size_t)j * Cin, 3, a_dims, a_strides, box);
    if (r != 0) return 100000 + r;
  }
  for (int j = ksize; j < MAX_TAPS; ++j) maps.a[j] = maps.a[0];
  const cuuint32_t b_box[3] = {64, WG_BK, 1};
  const cuuint64_t b_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, (cuuint64_t)ksize};
  const cuuint64_t b_strides[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cin * Cout * 2};
  const int r = encode(fn, &maps.b, w, 3, b_dims, b_strides, b_box);
  if (r != 0) return 100000 + r;

  cudaError_t err = cudaFuncSetAttribute(conv_gelu_wgmma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  conv_gelu_wgmma_kernel<C><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      maps, y, T_out, Cout, Cin, ksize, (int)tiles_m, (int)tiles_n, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 route.  Returns a cudaError_t (0 on success).
extern "C" int conv_gelu_f32_launch(const float* x, const float* w, float* y, int B, int T_in,
                                    int Cin, int T_out, int Cout, int ksize, int stride,
                                    void* stream) {
  if (!conv_args_ok(B, T_in, Cin, T_out, Cout, ksize, stride)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * T_out;
  const long long grid_x = (M + BM - 1) / BM;
  if (grid_x > 0x7FFFFFFFLL || (Cout + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (Cout + BN - 1) / BN);
  conv_gelu_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, y, B, T_in, Cin, T_out, Cout, ksize, stride);
  return (int)cudaGetLastError();
}

// bf16 route: x [B, T_in, Cin], w [ksize, Cin, Cout], y [B, T_out, Cout],
// all 16-byte aligned.  256-row tiles, or 128-row ones where those fit in
// one wave of the SMs (the small late layers).  Returns a cudaError_t (0 on
// success), or 100000 + the CUresult when a tensor map cannot be encoded.
extern "C" int conv_gelu_bf16_launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     __nv_bfloat16* y, int B, int T_in, int Cin, int T_out,
                                     int Cout, int ksize, int stride, void* stream) {
  if (!conv_args_ok(B, T_in, Cin, T_out, Cout, ksize, stride) || Cin % 8 != 0 ||
      Cout % 8 != 0 || ksize > MAX_TAPS ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  static const EncodeTiledFn fn = lookup_encode();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles128 =
      (long long)B * ((T_out + 127) / 128) * ((Cout + WG_BN - 1) / WG_BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles128 <= sms)
    return launch_wgmma<2>(fn, x, w, y, B, T_in, Cin, T_out, Cout, ksize, stride, sms, s);
  return launch_wgmma<4>(fn, x, w, y, B, T_in, Cin, T_out, Cout, ksize, stride, sms, s);
}
