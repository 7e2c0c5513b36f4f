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
//   bias  (grid T, one query row i a block; banded_attention_wgmma.cuh,
//         the pass the forward runs too, so the recomputed scores are the
//         forward's bits)
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
// with rows of Tp: the encoder builds it so once a forward (a [Dh, T, T]
// view of [Dh, T, Tp] storage), and the wrapper copies only a contiguous
// band with T % 8 != 0 into such rows; the columns past T are outside the
// tensor map and never read.
//
// What bounds it on an H100: per (n, i, j) pair over the valid keys the dq
// function does 12 Dh flops (S, bias, dP, ds.k, ds.band, q^T.ds) and the dkv
// function 10 Dh (bias, S, dP, dv, dk): at N 192, T 799 about 0.1 ms of bf16
// tensor-core time each.  The bytes this design moves are larger than the
// bytes the function needs: bias (f32 [N, T, T], 490 MB at that shape) is
// written once and read by both, ds (bf16, 245 MB) written and read once.
// The elementwise part (exp, the dropout hash, the bias loads) runs on the
// CUDA cores beside the products.  What is left: the bias pass writes its
// f32 tiles straight from the accumulator layout; the
// main loops wait on each step's chain (products, elementwise, products)
// at two blocks an SM (176-210 registers); the band pass reads ds twice
// (once per phase).
//
// Limits: T <= 1024, Dh a multiple of 16 up to 64; pointers 16-byte
// aligned.  The wrapper raises on anything else.

#include "banded_attention_wgmma.cuh"

namespace {

// ring stages and fixed tiles of each kernel (the bias pass: BiasSmem)
using DqSmem = Smem<2, 4>;
using BandSmem = Smem<3, 4>;  // the fixed tiles stage dband's f32 rows
using DkvSmem = Smem<2, 4>;

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

// ds [T, N, Tp] as [64 n][64 j] tiles of one row i (coordinates j0, n0, i)
int ds_map(EncodeTiledFn fn, CUtensorMap* m, const void* p, int N, int T) {
  const uint64_t Tp = pad8(T);
  return encode(fn, m, p, T, N, T, 2 * Tp, 2 * Tp * N, TILE, 1);
}

}  // namespace

// Every function takes bf16 tensors, returns a cudaError_t (0 on success)
// or 100000 + a CUresult when a tensor map cannot be encoded, and launches
// one kernel on ``stream``.  Tp = T rounded up to 8.

// bias f32 [N, T, Tp] and delta f32 [N, T] from q [N, T, Dh], the band
// [Dh, T, Tp] and o, dO [N, T, Dh].
extern "C" int batb_bias_launch(const void* q, const void* band, const void* o, const void* dout,
                                float* bias, float* delta, int N, int T, int Dh, void* stream) {
  return launch_bias<true>(q, band, o, dout, bias, delta, N, T, Dh, stream);
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
