// The bf16 backward of the banded relative-position train attention on
// wgmma tensor cores: dq with dband, and dk with dv.
//
// Replaces, on the bf16 route, the TPU kernels of
// speecht5_tpu/ops/pallas_kernels.py _bfa_train_bwd (:436):
//   pallas_call :446 (_train_attn_bwd_dq_kernel :342)  -> batb_bias_launch,
//                                                         batb_dq_launch, batb_band_launch
//   pallas_call :456 (_train_attn_bwd_dkv_kernel :374) -> batb_bias_launch, batb_dkv_launch
// The f32 route keeps the CUDA-core kernels of banded_attention_train.cu:
// wgmma has no full-f32 product.
//
// Contract: banded_attention_train.cu:10-27 (q pre-scaled; q, k, v, o, dO
// [N, T, Dh] bf16; band [Dh, T, T]; lengths int32 [N]; stats [2, N, T] f32,
// the forward's row max and row sum).  ds is zero at keys at or past a row's
// length, so a row of length 0 gives dv only; the dropout keep mask is the
// lowbias32 hash of (seed, n, global row, global column), bit for bit.
//
// The band term of the scores, sum_d q[n,i,d] band[d,i,j], is a GEMV for a
// fixed n and a GEMM only once the query row i is fixed and n runs over all
// N rows.  So the work is split in four launches:
//
//   bias  (grid T, one query row i a block)
//         bias[n, i, :] = Q_i [N x Dh] . Band_i [Dh x T], f32 [N, T, Tp];
//         also delta[n, i] = rowsum(dO * o), f32 [N, T] (16-byte loads, a
//         thread a row, while the first tiles load).
//   dq    (grid N x T/64, one (n, 64-row query tile) a block, looping over
//         the 64-key tiles below the row's length)
//         S = Q.K^T + bias, dP = dO.V^T; p = exp(S - m) / l; ds = p (dP keep
//         - delta); dq_acc += ds.K (f32 [N, T, Dh]); ds is written in bf16
//         as [T, N, Tp] (zero past the length).
//   band  (grid T, one query row i a block)
//         dq[:, i, :]    = bf16(dq_acc + dS_i [N x T] . Band_i^T [T x Dh])
//         dband[:, i, :] = Q_i^T [Dh x N] . dS_i [N x T]   (f32, the sum over n
//                          in wgmma's K loop: a fixed order, no atomics)
//   dkv   (grid N x T/64, one (n, 64-key tile) a block, looping over every
//         64-row query tile)
//         S^T = K.Q^T + bias^T, dP^T = V.dO^T; dv += bf16(p keep)^T . dO;
//         dk += bf16(ds)^T . Q.
//
// Every product is a wgmma.mma_async m64n64k16 (bf16 in, f32 accumulators in
// registers); the 64 x 64 bf16 tiles are TMA boxes of 128-byte rows in the
// 128-byte swizzle, through a four-stage mbarrier ring (three steps load
// while one computes; the two or three blocks of an SM overlap the rest).
// ds and p keep go from the accumulators straight into wgmma's register A
// operand (the m64nNk16 accumulator layout is the A fragment layout), so
// they never touch shared memory.  The main loops load their bias under the
// S and dP products.  dband's f32 tile goes through shared memory so that a
// warp writes 128 contiguous bytes of a row (the rows of [Dh, T, T] are not
// 8-byte aligned for odd T).  Dh < 64 is zero-filled by TMA up to the 64
// columns of a tile; rows past T, keys past T and rows n past N likewise.
//
// Rounding points (the twin rounds ds only for ds.k):
//   - s, p, dP and ds in f32 as in the twin; bias in f32, so the recomputed
//     scores match the forward's f32 statistics; p = __expf(s - m) times
//     1 / l (the twin divides exp(s - m) by l: a few ulp apart);
//   - ds rounded to bf16 once, and that value feeds all four of its
//     products: ds.k (as in the twin), ds.band (dq's band term), q^T.ds
//     (dband) and ds^T.q (dk); p keep rounded to bf16 for dv (as in the twin);
//   - dq rounded to bf16 once, after its two terms are summed in f32.
//
// Layouts: Tp = T rounded up to 8 (16-byte TMA strides).  The band is read
// through a [Dh, T, Tp] copy when T % 8 != 0 (the wrapper copies it, as the
// JAX wrapper pads it for the TPU kernel; the columns past T are outside
// the tensor map and never read).
//
// What bounds it on an H100: per (n, i, j) pair over the valid keys the dq
// function does 12 Dh flops (S, bias, dP, ds.k, ds.band, q^T.ds) and the dkv
// function 10 Dh (bias, S, dP, dv, dk): at N 192, T 799 about 0.1 ms of bf16
// tensor-core time each.  The bytes this design moves are larger than the
// bytes the function needs: bias (f32 [N, T, T], 490 MB at that shape) is
// written once and read by both, ds (bf16, 245 MB) written and read once.
// The elementwise part (exp, the dropout hash, the bias loads) runs on the
// CUDA cores beside the products.  What is left: the bias pass writes its
// f32 tiles straight from the accumulator layout, after the band copy; the
// main loops wait on each step's chain (products, elementwise, products)
// at two blocks an SM (176-210 registers); the band pass reads ds twice
// (once per phase).
//
// Limits: T <= 1024, Dh a multiple of 16 up to 64; pointers 16-byte
// aligned.  The wrapper raises on anything else.

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// ring stages and fixed tiles of each kernel
using BiasSmem = Smem<0, 4>;
using DqSmem = Smem<2, 4>;
using BandSmem = Smem<3, 4>;  // the fixed tiles stage dband's f32 rows
using DkvSmem = Smem<2, 4>;

// ------------------------------------------------------------------ bias

// One block a query row i: delta[:, i] and bias[:, i, :] (every column up
// to Tp; the band's columns past T read as zeros).
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
  for (int n = threadIdx.x; n < N; n += THREADS) {
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

// -------------------------------------------------------------------- dq

// One block a (n, 64-row query tile): ds (bf16, [T, N, Tp]) and dq_acc =
// ds.k (f32, [N, T, Dh]), looping over the key tiles below the row's length.
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __grid_constant__ CUtensorMap q_rows, const __grid_constant__ CUtensorMap k_rows,
          const __grid_constant__ CUtensorMap v_rows, const __grid_constant__ CUtensorMap do_rows,
          const int* __restrict__ lengths, const float* __restrict__ stats,
          const float* __restrict__ bias, const float* __restrict__ delta, bf16* __restrict__ ds,
          float* __restrict__ dq_acc, int N, int T, int Dh, Hash H) {
  const int nqt = cdiv(T, TILE);
  const int n = blockIdx.x / nqt, i0 = (blockIdx.x % nqt) * TILE;
  const int len = lengths[n];
  const int Tp = pad8(T), rows = min(TILE, T - i0);
  const int nkt = cdiv(len, TILE);  // key tiles with a valid key; 0 for a row of length 0

  {  // ds is zero past the computed key tiles (the band pass reads every column < T)
    const int c0 = nkt * TILE;
    const int chunks = c0 < Tp ? (Tp - c0) / 8 : 0;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += THREADS) {
      const int r = idx / chunks, c = idx - r * chunks;
      *reinterpret_cast<uint4*>(ds + ((size_t)(i0 + r) * N + n) * Tp + c0 + 8 * c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (nkt == 0) {  // no valid key: ds = 0, so ds.k = 0
    for (int idx = threadIdx.x; idx < rows * Dh; idx += THREADS)
      dq_acc[((size_t)n * T + i0) * Dh + idx] = 0.f;
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const DqSmem sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_expect_tx(sm.bar_fixed(), 2 * BOX);
    tma_load_3d(sm.fixed, &q_rows, sm.bar_fixed(), 0, i0, n);
    tma_load_3d(sm.fixed + BOX, &do_rows, sm.bar_fixed(), 0, i0, n);
  }
  const uint32_t qs = sm.fixed, dos = sm.fixed + BOX;
  auto issue = [&](int it, uint32_t dst, uint32_t bar) {
    tma_load_3d(dst, &k_rows, bar, 0, it * TILE, n);
    tma_load_3d(dst + BOX, &v_rows, bar, 0, it * TILE, n);
  };
  ring_start(sm, nkt, issue);

  // the thread's two query rows and their statistics
  const int row0 = i0 + acc_row(0);
  float m[2], l[2], dl[2];  // row max, 1 / row sum, delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < T;
    m[h] = in ? stats[(size_t)n * T + row] : 0.f;
    l[h] = 1.f / (in ? stats[((size_t)N + n) * T + row] : 1.f);
    dl[h] = in ? delta[(size_t)n * T + row] : 0.f;
  }
  float dq[32];
  zero(dq);
  mbar_wait(sm.bar_fixed(), 0);

  ring_run(
      sm, nkt, issue,
      [&](int it, uint32_t st) {
        const int j0 = it * TILE;
        float s[32], dp[32];
        zero(s);
        zero(dp);
        fence_acc(s);
        fence_acc(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(s, kmajor(qs, kk), kmajor(st, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(dp, kmajor(dos, kk), kmajor(st + BOX, kk));
        wgmma_commit();
        float2 b[16];  // the bias of the thread's elements, loaded under the products
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int row = row0 + 8 * ((e >> 1) & 1), j = j0 + acc_col(e);
          b[e / 2] = (row < T && j < Tp)
                         ? *reinterpret_cast<const float2*>(bias + ((size_t)n * T + row) * Tp + j)
                         : make_float2(0.f, 0.f);
        }
        wgmma_wait_all();
        fence_acc(s);
        fence_acc(dp);
        fence_acc(dq);
        uint32_t a[4][4];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int h = (e >> 1) & 1, row = row0 + 8 * h, j = j0 + acc_col(e);
          float g[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            g[u] = 0.f;
            if (row < T && j + u < len) {
              const float x = s[e + u] + (u ? b[e / 2].y : b[e / 2].x) - m[h];
              const float p = __expf(x) * l[h];
              g[u] = p * (dp[e + u] * keep_scale(H, n, row, j + u) - dl[h]);
            }
          }
          const uint32_t pair = pack_bf16(g[0], g[1]);
          a[e >> 3][(e >> 1) & 3] = pair;
          if (row < T && j < T)  // j + 1 may be T: a padding column, never read
            *reinterpret_cast<uint32_t*>(ds + ((size_t)row * N + n) * Tp + j) = pair;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dq, a[kk], mnmajor(st, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(dq);
        fence_frag(a);
      });

#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int row = row0 + 8 * ((e >> 1) & 1), d = acc_col(e);
    if (row < T && d < Dh)
      *reinterpret_cast<float2*>(dq_acc + ((size_t)n * T + row) * Dh + d) =
          make_float2(dq[e], dq[e + 1]);
  }
}

// ------------------------------------------------------------------ band

// One block a query row i.  Steps [0, nmb * njt): per 64-row block of n,
// dq[n, i, :] = bf16(dq_acc + sum over the key tiles of dS_i . Band_i^T).
// Steps [nmb * njt, 2 nmb njt): per key tile, dband[:, i, j] = sum over the
// blocks of n of Q_i^T . dS_i.
__global__ void __launch_bounds__(THREADS)
band_kernel(const __grid_constant__ CUtensorMap q_col, const __grid_constant__ CUtensorMap band_map,
            const __grid_constant__ CUtensorMap ds_map, const float* __restrict__ dq_acc,
            bf16* __restrict__ dq, float* __restrict__ dband, int N, int T, int Dh) {
  extern __shared__ uint8_t smem_raw[];
  const BandSmem sm(smem_raw);
  const int i = blockIdx.x;
  const int nmb = cdiv(N, TILE), njt = cdiv(T, TILE), na = nmb * njt;
  auto issue = [&](int it, uint32_t dst, uint32_t bar) {
    if (it < na) {
      const int nb = it / njt, jt = it % njt;
      tma_load_3d(dst, &ds_map, bar, jt * TILE, nb * TILE, i);    // [64 n][64 j]
      tma_load_3d(dst + BOX, &band_map, bar, jt * TILE, i, 0);    // [64 d][64 j]
    } else {
      const int r = it - na, jt = r / nmb, nb = r % nmb;
      tma_load_3d(dst, &ds_map, bar, jt * TILE, nb * TILE, i);    // [64 n][64 j]
      tma_load_3d(dst + BOX, &q_col, bar, 0, i, nb * TILE);       // [64 n][64 d]
    }
  };
  ring_start(sm, 2 * na, issue);
  float acc[32];
  zero(acc);

  ring_run(
      sm, 2 * na, issue,
      [&](int it, uint32_t st) {
        if (it < na) {
          const int nb = it / njt, jt = it % njt;
          if (jt == 0) zero(acc);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(acc, kmajor(st, kk), kmajor(st + BOX, kk));
          wgmma_commit();
          wgmma_wait_all();
          fence_acc(acc);
          if (jt == njt - 1) {
#pragma unroll
            for (int e = 0; e < 32; e += 2) {
              const int n = nb * TILE + acc_row(e), d = acc_col(e);
              if (n < N && d < Dh) {
                const size_t off = ((size_t)n * T + i) * Dh + d;
                const float2 a = *reinterpret_cast<const float2*>(dq_acc + off);
                *reinterpret_cast<__nv_bfloat162*>(dq + off) =
                    __floats2bfloat162_rn(a.x + acc[e], a.y + acc[e + 1]);
              }
            }
          }
        } else {
          const int r = it - na, jt = r / nmb, nb = r % nmb;
          if (nb == 0) zero(acc);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<1, 1>(acc, mnmajor(st + BOX, kk), mnmajor(st, kk));
          wgmma_commit();
          wgmma_wait_all();
          fence_acc(acc);
          if (nb == nmb - 1) {  // through shared memory, so that a warp writes rows
            float* tile = reinterpret_cast<float*>(smem_raw + (sm.fixed - smem_u32(smem_raw)));
#pragma unroll
            for (int e = 0; e < 32; ++e) tile[acc_row(e) * (TILE + 1) + acc_col(e)] = acc[e];
            __syncthreads();
            const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
            for (int d = warp; d < Dh; d += THREADS / 32)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int j = jt * TILE + lane + 32 * h;
                if (j < T) dband[((size_t)d * T + i) * T + j] = tile[d * (TILE + 1) + lane + 32 * h];
              }
          }
        }
      });
}

// ------------------------------------------------------------------- dkv

// One block a (n, 64-key tile): dk and dv, looping over every query tile.
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const __grid_constant__ CUtensorMap q_rows, const __grid_constant__ CUtensorMap k_rows,
           const __grid_constant__ CUtensorMap v_rows, const __grid_constant__ CUtensorMap do_rows,
           const int* __restrict__ lengths, const float* __restrict__ stats,
           const float* __restrict__ bias, const float* __restrict__ delta, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int N, int T, int Dh, Hash H) {
  const int nt = cdiv(T, TILE);
  const int n = blockIdx.x / nt, j0 = (blockIdx.x % nt) * TILE;
  const int len = lengths[n];
  const int Tp = pad8(T);
  const size_t base = (size_t)n * T * Dh;

  if (len > 0 && j0 >= len) {  // every key of the tile is masked: dk = dv = 0
    const int rows = min(TILE, T - j0);
    for (int idx = threadIdx.x; idx < rows * Dh; idx += THREADS) {
      dk[base + (size_t)j0 * Dh + idx] = __float2bfloat16_rn(0.f);
      dv[base + (size_t)j0 * Dh + idx] = __float2bfloat16_rn(0.f);
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const DkvSmem sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_expect_tx(sm.bar_fixed(), 2 * BOX);
    tma_load_3d(sm.fixed, &k_rows, sm.bar_fixed(), 0, j0, n);
    tma_load_3d(sm.fixed + BOX, &v_rows, sm.bar_fixed(), 0, j0, n);
  }
  const uint32_t ks = sm.fixed, vs = sm.fixed + BOX;
  auto issue = [&](int it, uint32_t dst, uint32_t bar) {
    tma_load_3d(dst, &q_rows, bar, 0, it * TILE, n);
    tma_load_3d(dst + BOX, &do_rows, bar, 0, it * TILE, n);
  };
  ring_start(sm, nt, issue);
  const int key0 = j0 + acc_row(0);  // the thread's two keys: key0, key0 + 8
  float dK[32], dV[32];
  zero(dK);
  zero(dV);
  mbar_wait(sm.bar_fixed(), 0);

  ring_run(
      sm, nt, issue,
      [&](int it, uint32_t st) {
        const int i0 = it * TILE;
        float s[32], dp[32];  // S^T and dP^T: rows are keys, columns query rows
        zero(s);
        zero(dp);
        fence_acc(s);
        fence_acc(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(s, kmajor(ks, kk), kmajor(st, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(dp, kmajor(vs, kk), kmajor(st + BOX, kk));
        wgmma_commit();
        float b[32];  // the bias of the thread's elements, loaded under the products
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = key0 + 8 * ((e >> 1) & 1), i = i0 + acc_col(e);
          b[e] = (i < T && key < len) ? bias[((size_t)n * T + i) * Tp + key] : 0.f;
        }
        wgmma_wait_all();
        fence_acc(s);
        fence_acc(dp);
        fence_acc(dK);
        fence_acc(dV);
        uint32_t ap[4][4], ag[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // the slice's four query rows of this thread: c = 16 kk + 8 (q / 2) + 2 (lane % 4) + q % 2
          float mi[4], li[4], di[4];  // row max, 1 / row sum, delta
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + 16 * kk + 8 * (q >> 1) + 2 * (threadIdx.x & 3) + (q & 1);
            const bool in = i < T;
            mi[q] = in ? stats[(size_t)n * T + i] : 0.f;
            li[q] = 1.f / (in ? stats[((size_t)N + n) * T + i] : 1.f);
            di[q] = in ? delta[(size_t)n * T + i] : 0.f;
          }
#pragma unroll
          for (int e = 8 * kk; e < 8 * kk + 8; e += 2) {
            const int key = key0 + 8 * ((e >> 1) & 1);
            float pd[2], g[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int ee = e + u, q = ((ee >> 2) & 1) * 2 + (ee & 1);
              const int i = i0 + acc_col(ee);
              pd[u] = g[u] = 0.f;
              if (i < T && key < T) {
                const bool valid = key < len;
                const float sc = valid ? s[ee] + b[ee] : NEG_INF;
                const float p = __expf(sc - mi[q]) * li[q];
                const float kp = keep_scale(H, n, i, key);
                pd[u] = p * kp;
                if (valid) g[u] = p * (dp[ee] * kp - di[q]);
              }
            }
            ap[kk][(e >> 1) & 3] = pack_bf16(pd[0], pd[1]);
            ag[kk][(e >> 1) & 3] = pack_bf16(g[0], g[1]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dV, ap[kk], mnmajor(st + BOX, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dK, ag[kk], mnmajor(st, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(dK);
        fence_acc(dV);
        fence_frag(ap);
        fence_frag(ag);
      });

#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int key = key0 + 8 * ((e >> 1) & 1), d = acc_col(e);
    if (key < T && d < Dh) {
      const size_t off = base + (size_t)key * Dh + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(dK[e], dK[e + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dV[e], dV[e + 1]);
    }
  }
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
// ds [T, N, Tp] as [64 n][64 j] tiles of one row i (coordinates j0, n0, i)
int ds_map(EncodeTiledFn fn, CUtensorMap* m, const void* p, int N, int T) {
  const uint64_t Tp = pad8(T);
  return encode(fn, m, p, T, N, T, 2 * Tp, 2 * Tp * N, TILE, 1);
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

}  // namespace

// Every function takes bf16 tensors, returns a cudaError_t (0 on success)
// or 100000 + a CUresult when a tensor map cannot be encoded, and launches
// one kernel on ``stream``.  Tp = T rounded up to 8.

// bias f32 [N, T, Tp] and delta f32 [N, T] from q [N, T, Dh], the band
// [Dh, T, Tp] and o, dO [N, T, Dh].
extern "C" int batb_bias_launch(const void* q, const void* band, const void* o, const void* dout,
                                float* bias, float* delta, int N, int T, int Dh, void* stream) {
  int err = check(N, T, Dh, {q, band, bias});
  if (err) return err;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  CUtensorMap qm, bm;
  if ((err = col_map(fn, &qm, q, N, T, Dh)) || (err = band_map(fn, &bm, band, T, Dh))) return err;
  if ((err = prepare(bias_kernel, BiasSmem::BYTES))) return err;
  bias_kernel<<<T, THREADS, BiasSmem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      qm, bm, (const bf16*)o, (const bf16*)dout, bias, delta, N, T, Dh);
  return (int)cudaGetLastError();
}

// ds bf16 [T, N, Tp] and dq_acc = ds.k f32 [N, T, Dh].  dropout: 0 or 1;
// thresh and scale as the TPU kernel computes them.
extern "C" int batb_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                              const int* lengths, const float* stats, const float* bias,
                              const float* delta, void* ds, float* dq_acc, int N, int T, int Dh,
                              int dropout, unsigned seed, unsigned thresh, float scale,
                              void* stream) {
  int err = check(N, T, Dh, {q, k, v, dout, bias, ds});
  if (err) return err;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  CUtensorMap qm, km, vm, dm;
  if ((err = rows_map(fn, &qm, q, N, T, Dh)) || (err = rows_map(fn, &km, k, N, T, Dh)) ||
      (err = rows_map(fn, &vm, v, N, T, Dh)) || (err = rows_map(fn, &dm, dout, N, T, Dh)))
    return err;
  if ((err = prepare(dq_kernel, DqSmem::BYTES))) return err;
  const Hash H{dropout, seed, thresh, scale};
  dq_kernel<<<N * cdiv(T, TILE), THREADS, DqSmem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, dm, lengths, stats, bias, delta, (bf16*)ds, dq_acc, N, T, Dh, H);
  return (int)cudaGetLastError();
}

// dq bf16 [N, T, Dh] = dq_acc + ds.band and dband f32 [Dh, T, T] = q^T.ds.
extern "C" int batb_band_launch(const void* q, const void* band, const void* ds,
                                const float* dq_acc, void* dq, float* dband, int N, int T,
                                int Dh, void* stream) {
  int err = check(N, T, Dh, {q, band, ds});
  if (err) return err;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  CUtensorMap qm, bm, sm;
  if ((err = col_map(fn, &qm, q, N, T, Dh)) || (err = band_map(fn, &bm, band, T, Dh)) ||
      (err = ds_map(fn, &sm, ds, N, T)))
    return err;
  if ((err = prepare(band_kernel, BandSmem::BYTES))) return err;
  band_kernel<<<T, THREADS, BandSmem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      qm, bm, sm, dq_acc, (bf16*)dq, dband, N, T, Dh);
  return (int)cudaGetLastError();
}

// dk, dv bf16 [N, T, Dh].
extern "C" int batb_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                               const int* lengths, const float* stats, const float* bias,
                               const float* delta, void* dk, void* dv, int N, int T, int Dh,
                               int dropout, unsigned seed, unsigned thresh, float scale,
                               void* stream) {
  int err = check(N, T, Dh, {q, k, v, dout, bias});
  if (err) return err;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  CUtensorMap qm, km, vm, dm;
  if ((err = rows_map(fn, &qm, q, N, T, Dh)) || (err = rows_map(fn, &km, k, N, T, Dh)) ||
      (err = rows_map(fn, &vm, v, N, T, Dh)) || (err = rows_map(fn, &dm, dout, N, T, Dh)))
    return err;
  if ((err = prepare(dkv_kernel, DkvSmem::BYTES))) return err;
  const Hash H{dropout, seed, thresh, scale};
  dkv_kernel<<<N * cdiv(T, TILE), THREADS, DkvSmem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, dm, lengths, stats, bias, delta, (bf16*)dk, (bf16*)dv, N, T, Dh, H);
  return (int)cudaGetLastError();
}
