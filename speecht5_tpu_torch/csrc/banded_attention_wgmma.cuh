// Shared pieces of the bf16 banded-attention kernels on wgmma tensor cores
// fed by TMA: the forward (banded_attention_fwd.cu) and the train backward
// (banded_attention_train_bwd.cu) include this header, so both run the one
// bias pass below and the same TMA, mbarrier and wgmma helpers.
//
// The bias pass.  The band term of the scores, sum_d q[n,i,d] band[d,i,j],
// is a GEMV for a fixed n and a GEMM only once the query row i is fixed and
// n runs over all N rows: one block a query row i computes
//   bias[n, i, :] = Q_i [N x Dh] . Band_i [Dh x T]   (f32 [N, T, Tp])
// on wgmma, and, for the backward only (DELTA), delta[n, i] = rowsum(dO *
// o) (16-byte loads, a thread a row, while the first tiles load).  The two
// instances differ only in that loop (and in their names in a trace).  The forward's scores and the backward's recomputed scores are
// then S = Q.K^T on the same wgmma tiles plus this one bias, so they are
// the same bits.
//
// Layouts: Tp = T rounded up to 8 (16-byte TMA strides).  The band is read
// as [Dh, T, Tp] (rows of Tp; the columns past T are outside the tensor map
// and never read).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;           // rows of every tile; 64 bf16 = one 128-byte row
constexpr int BOX = TILE * 128;    // bytes of one 64 x 64 bf16 tile
constexpr int THREADS = 128;       // one warpgroup
constexpr int MAX_T = 1024;
constexpr int MAX_DH = 64;
constexpr float NEG_INF = -1e9f;

struct Hash {
  int dropout;
  uint32_t seed, thresh;
  float scale;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int pad8(int t) { return (t + 7) & ~7; }

// the TPU kernel's _dropout_keep for one element (uint32 wrap-around)
__device__ __forceinline__ float keep_scale(const Hash& H, int n, int row, int col) {
  if (!H.dropout) return 1.f;
  uint32_t x = (uint32_t)row * 0x9E3779B1u;
  x ^= (uint32_t)col * 0x85EBCA77u;
  x += H.seed + (uint32_t)n * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < H.thresh ? H.scale : 0.f;
}

// ------------------------------------------------- TMA, mbarrier, wgmma

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

// Shared-memory matrix descriptor of a tile of 128-byte rows in TMA's
// 128-byte swizzle (atoms of 8 rows, 1024 bytes, 1024-byte aligned).
// K-major: SBO = 1024 steps over 8-row groups of M (or N), LBO unused.
// MN-major (rows are K, 64 M or N values each): SBO = 1024 steps over 8-row
// groups of K, LBO would step to the next 64 M or N values (one here).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// k-slice kk (16 deep) of a 64 x 64 tile: K-major steps 32 bytes along the
// rows, MN-major 16 rows
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 32, 16);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, BOX);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin registers that an in-flight wgmma reads or writes in place: the
// compiler may not move their uses across this point.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

#define ACC32(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define REGS32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] . B[16 x 64], both from shared memory; TA / TB
// = 1 reads A / B MN-major (transposed).  Each thread holds 32 f32
// accumulators: d[e] is row warp*16 + lane/4 + 8*((e/2)%2), column
// 8*(e/4) + 2*(lane%4) + e%2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64] with A in registers: the A
// fragment of k-slice kk of a 64 x 64 accumulator x is
// {x[8kk], x[8kk+1]}, {x[8kk+2], x[8kk+3]}, {x[8kk+4], x[8kk+5]},
// {x[8kk+6], x[8kk+7]} as bf16 pairs (frag() below).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the thread's row and column of accumulator element e
__device__ __forceinline__ int acc_row(int e) {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4 + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// --------------------------------------------------- the block's smem

// [F fixed tiles][S stages of two tiles][S + 1 mbarriers: one a stage, one
// for the fixed tiles]
template <int F, int S>
struct Smem {
  static constexpr int BYTES = (F + 2 * S) * BOX + 8 * (S + 1) + 1024;  // + alignment
  uint32_t fixed, stage0, bars;
  __device__ uint32_t stage(int s) const { return stage0 + s * 2 * BOX; }
  __device__ uint32_t bar(int s) const { return bars + 8 * s; }
  __device__ uint32_t bar_fixed() const { return bars + 8 * S; }

  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    fixed = (smem_u32(raw) + 1023u) & ~1023u;  // swizzle atoms start 1024-byte aligned
    stage0 = fixed + F * BOX;
    bars = stage0 + 2 * S * BOX;
    if (threadIdx.x == 0) {
      for (int b = 0; b <= S; ++b) mbar_init(bars + 8 * b, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
};

// Two tiles (2 * BOX bytes) a step through an S-stage ring.  ``issue(it,
// dst, bar)`` starts the TMA loads of step it into dst and dst + BOX;
// ``body(it, stage)`` computes on them and returns with its wgmmas complete.
// ring_start issues the first S steps (thread 0), so that other work can
// run while they load; ring_run then waits for each step in turn, and
// thread 0 starts step it + S into the stage that step it has released.
template <int F, int S, class Issue>
__device__ __forceinline__ void ring_start(const Smem<F, S>& sm, int n_iter, Issue issue) {
  if (threadIdx.x == 0)
    for (int it = 0; it < S && it < n_iter; ++it) {
      mbar_expect_tx(sm.bar(it), 2 * BOX);
      issue(it, sm.stage(it), sm.bar(it));
    }
}

template <int F, int S, class Issue, class Body>
__device__ __forceinline__ void ring_run(const Smem<F, S>& sm, int n_iter, Issue issue,
                                         Body body) {
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % S;
    mbar_wait(sm.bar(s), (it / S) & 1);
    body(it, sm.stage(s));
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && it + S < n_iter) {
      mbar_expect_tx(sm.bar(s), 2 * BOX);
      issue(it + S, sm.stage(s), sm.bar(s));
    }
  }
}

using BiasSmem = Smem<0, 4>;

// ------------------------------------------------------------------ bias

// One block a query row i: bias[:, i, :] (every column up to Tp; the
// band's columns past T read as zeros) and, with DELTA, delta[:, i].
template <bool DELTA>
__global__ void __launch_bounds__(THREADS)
bias_kernel(const __grid_constant__ CUtensorMap q_col, const __grid_constant__ CUtensorMap band_map,
            const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ bias,
            float* __restrict__ delta, int N, int T, int Dh) {
  extern __shared__ uint8_t smem_raw[];
  const BiasSmem sm(smem_raw);
  const int i = blockIdx.x;
  const int Tp = pad8(T);
  const int nmb = cdiv(N, TILE), njt = cdiv(T, TILE);
  auto issue = [&](int it, uint32_t dst, uint32_t bar) {
    const int jt = it % njt, nb = it / njt;
    tma_load_3d(dst, &q_col, bar, 0, i, nb * TILE);              // [64 n][64 d]
    tma_load_3d(dst + BOX, &band_map, bar, jt * TILE, i, 0);     // [64 d][64 j]
  };
  ring_start(sm, nmb * njt, issue);

  // delta while the first tiles load: a thread a row n, 16-byte loads
  for (int n = threadIdx.x; DELTA && n < N; n += THREADS) {
    const uint4* po = reinterpret_cast<const uint4*>(o + ((size_t)n * T + i) * Dh);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + ((size_t)n * T + i) * Dh);
    uint4 a[MAX_DH / 8], b[MAX_DH / 8];
#pragma unroll
    for (int c = 0; c < MAX_DH / 8; ++c)
      if (c < Dh / 8) {
        a[c] = po[c];
        b[c] = pd[c];
      }
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_DH / 8; ++c)
      if (c < Dh / 8) {
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a[c]);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b[c]);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 fx = __bfloat1622float2(x[h]), fy = __bfloat1622float2(y[h]);
          acc += fx.x * fy.x + fx.y * fy.y;
        }
      }
    delta[(size_t)n * T + i] = acc;
  }

  ring_run(
      sm, nmb * njt, issue,
      [&](int it, uint32_t st) {
        const int jt = it % njt, nb = it / njt;
        float acc[32];
        zero(acc);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 1>(acc, kmajor(st, kk), mnmajor(st + BOX, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int n = nb * TILE + acc_row(e), j = jt * TILE + acc_col(e);
          if (n < N && j < Tp)
            *reinterpret_cast<float2*>(bias + ((size_t)n * T + i) * Tp + j) =
                make_float2(acc[e], acc[e + 1]);
        }
      });
}

// ------------------------------------------------------------------ host

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

// A 3D bf16 tensor map (dims innermost first, byte strides of dims 1 and
// 2) whose boxes are 64 x 64 tiles of 128-byte rows in the 128-byte swizzle;
// elements outside the tensor read as zeros.  Returns 0 or 100000 + the
// CUresult.
int encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
           uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b1, uint32_t b2) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {TILE, b1, b2};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 100000 + (int)r;
}

// [N, T, Dh] as 64-row tiles of one n (coordinates 0, t0, n) ...
int rows_map(EncodeTiledFn fn, CUtensorMap* m, const void* p, int N, int T, int Dh) {
  return encode(fn, m, p, Dh, T, N, 2ull * Dh, 2ull * T * Dh, TILE, 1);
}
// ... or as 64 values of n of one row i (coordinates 0, i, n0)
int col_map(EncodeTiledFn fn, CUtensorMap* m, const void* p, int N, int T, int Dh) {
  return encode(fn, m, p, Dh, T, N, 2ull * Dh, 2ull * T * Dh, 1, TILE);
}
// the band [Dh, T, Tp] as [64 d][64 j] tiles of one row i (coordinates j0, i, 0)
int band_map(EncodeTiledFn fn, CUtensorMap* m, const void* p, int T, int Dh) {
  const uint64_t Tp = pad8(T);
  return encode(fn, m, p, T, T, Dh, 2 * Tp, 2 * Tp * T, 1, TILE);
}
bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int check(int N, int T, int Dh, std::initializer_list<const void*> ptrs) {
  if (N <= 0 || T <= 0 || T > MAX_T || Dh < 16 || Dh > MAX_DH || Dh % 16 != 0)
    return (int)cudaErrorInvalidValue;
  for (const void* p : ptrs)
    if (!aligned(p)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = lookup_encode();
  return fn;
}

template <class K>
int prepare(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The bias pass on ``stream``: bias f32 [N, T, Tp] from q [N, T, Dh] and
// the band [Dh, T, Tp]; with DELTA also delta f32 [N, T] from o and dO [N,
// T, Dh] (the forward passes NULL for all three).  Returns a cudaError_t or
// 100000 + a CUresult.
template <bool DELTA>
int launch_bias(const void* q, const void* band, const void* o, const void* dout, float* bias,
                float* delta, int N, int T, int Dh, void* stream) {
  int err = check(N, T, Dh, {q, band, bias});
  if (err) return err;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  CUtensorMap qm, bm;
  if ((err = col_map(fn, &qm, q, N, T, Dh)) || (err = band_map(fn, &bm, band, T, Dh))) return err;
  if ((err = prepare(bias_kernel<DELTA>, BiasSmem::BYTES))) return err;
  bias_kernel<DELTA><<<T, THREADS, BiasSmem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      qm, bm, (const bf16*)o, (const bf16*)dout, bias, delta, N, T, Dh);
  return (int)cudaGetLastError();
}

}  // namespace
