// Banded relative-position self-attention for training: forward and the two
// backward kernels, with counter-hash probability dropout.
//
// Replaces the TPU kernels of speecht5_tpu/ops/pallas_kernels.py
// banded_flash_attention_train (:411):
//   bat_fwd_launch     <- pallas_call :427 (_train_attn_fwd_kernel :310)
//   bat_bwd_dq_launch  <- pallas_call :446 (_train_attn_bwd_dq_kernel :342), f32
//   bat_bwd_dkv_launch <- pallas_call :456 (_train_attn_bwd_dkv_kernel :374), f32
//
// Contract (q pre-scaled; q, k, v, o, dO: [N, T, Dh]; band: [Dh, T, T];
// lengths: int32 [N]; every product and sum in f32):
//   s[n,i,j]  = sum_d q[n,i,d] * (k[n,j,d] + band[d,i,j]),  -1e9 where j >= len[n]
//   p         = exp(s - m) / l,  m = rowmax(s), l = max(rowsum(exp(s - m)), 1e-30)
//   keep      = lowbias32(seed, n, i, j) < thresh   (pallas_kernels.py:265-287)
//   pd        = p * keep / (1 - rate)               (pd = p without dropout)
//   o         = cast_to_v_type(pd) . v
//   ds        = p * (dO.v^T * keep / (1 - rate) - rowsum(dO * o)),  0 where j >= len[n]
//   dq        = cast_to_k_type(ds) . k + sum_j ds[i,j] * band[:,i,j]
//   dband     = sum_n q[n,i,:] * ds[n,i,j]           (f32)
//   dv        = cast_to_dO_type(pd)^T . dO,   dk = ds^T . q
// The forward saves the row statistics m and l ([2, N, T] f32) so that the
// backward tiles need no whole key row; the TPU kernels recompute them only
// because Mosaic's tiling rules forbid an [N, T] residual (:290-295).  ds is
// zero at masked keys, the dense path's gradient: a row of length 0 (uniform
// p over the T keys) then gives dv but no dq, dk or dband, where the Pallas
// kernel lets such a row leak into all three (ROADMAP.md C).
//
// Routes.  The three kernels here are the f32 route only: the bf16 forward
// (the training path's dtype) runs on wgmma tensor cores in
// banded_attention_fwd.cu and the bf16 backward in
// banded_attention_train_bwd.cu; wgmma has no full-f32 product, so f32 stays
// on these CUDA-core kernels.  The band may come with rows of Tp = T rounded
// up to 8 (the encoder's row-padded band): every kernel takes its row stride.
//
// Design.
// - Forward: one block owns 16 query rows of one n and keeps the whole score
//   row in shared memory (16 x T f32), so the softmax is exact over the row
//   and p is normalised, dropped out and rounded to V's type exactly where
//   the TPU kernel does it.  Grid (N, T/16) with n in blockIdx.x, so blocks
//   that read one [Dh, 16, T] band slab run together and hit L2.
// - Backward K1 (dq and dband) is one launch with two kinds of block.  The
//   first T/16 x T/16 blocks each own a 16 x 16 (query, key) tile of dband
//   and loop over all n in order, accumulating in registers: the sum over N
//   is deterministic and needs no float atomics (blocks on Hopper run in no
//   order and carry nothing between them).  The band tile is read once per
//   block.  The remaining N x T/16 blocks each own 16 query rows of one n and
//   loop over the key tiles, accumulating dq in registers.
// - Backward K2 (dk, dv): one block per (n, 16-row key tile), looping over
//   the query tiles.
// - rowsum(dO * o) is recomputed per 16-row tile (Dh products a row) from dO
//   and the saved o instead of a separate pre-pass.
// - Key tiles at or beyond a row's length contribute nothing when the length
//   is > 0 and are skipped.
//
// What bounds it on an H100: the flops, ~14 N T^2 Dh in all three kernels
// over the valid keys; the bytes (q, k, v, o, dO, dq, dk, dv and two band
// sized tensors) are far smaller.  These kernels compute on the CUDA cores
// in f32 out of shared memory, so they sit well above the tensor-core bound
// (at f32 that bound is the 67 TFLOP/s of the CUDA cores).  A
// table-resident bias that reads the [2M, Dh] table instead of the band is
// later work.
//
// Limits: T <= 1024 (the forward's score row lives in shared memory; the
// module routes longer sequences to the plain path, as the JAX module
// does), Dh <= 64 (register accumulators; every SpeechT5 preset has 64).
// The bf16 route also needs Dh a multiple of 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_T = 1024;
constexpr int MAX_DH = 64;
constexpr float NEG_INF = -1e9f;
// forward tiles
constexpr int FQ = 16;
constexpr int FK = 64;
constexpr int F_OUT = FQ * MAX_DH / THREADS;
// backward tiles: one thread per (row, column) pair of a 16 x 16 tile
constexpr int BQ = 16;
constexpr int BK = 16;
constexpr int TILE = BQ * BK;
constexpr int BSTRIDE = TILE + 1;   // band tile stride per d: conflict-free reads
constexpr int PSTRIDE = BK + 1;
constexpr int DCH = MAX_DH / 16;    // d values per thread in the accumulations

struct Params {
  int N, T, Dh, ldb, dropout;  // ldb: the band's row stride in elements
  uint32_t seed, thresh;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the storage type T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the TPU kernel's _dropout_keep for one element (uint32 wrap-around)
__device__ __forceinline__ float keep_scale(const Params& P, int n, int row, int col) {
  if (!P.dropout) return 1.f;
  uint32_t x = (uint32_t)row * 0x9E3779B1u;
  x ^= (uint32_t)col * 0x85EBCA77u;
  x += P.seed + (uint32_t)n * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < P.thresh ? P.scale : 0.f;
}

// rows [row0, row0 + rows) of a [T, Dh] matrix into dst[r * ld + d], 0 past T
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int row0,
                                          int rows, int T_len, int Dh) {
  for (int idx = threadIdx.x; idx < rows * Dh; idx += THREADS) {
    const int r = idx / Dh, d = idx - r * Dh;
    const int row = row0 + r;
    dst[r * ld + d] = row < T_len ? to_f32(src[(size_t)row * Dh + d]) : 0.f;
  }
}

// band[:, q0:q0+BQ, k0:k0+BK] into dst[d * BSTRIDE + i * BK + j], 0 past T
// (rows of ldb elements)
template <typename T>
__device__ __forceinline__ void load_band_tile(float* dst, const T* band, int q0, int k0,
                                               int T_len, int Dh, int ldb) {
  for (int idx = threadIdx.x; idx < Dh * TILE; idx += THREADS) {
    const int d = idx / TILE, t = idx - d * TILE;
    const int row = q0 + t / BK, col = k0 + t % BK;
    dst[d * BSTRIDE + t] =
        (row < T_len && col < T_len)
            ? to_f32(band[((size_t)d * T_len + row) * ldb + col])
            : 0.f;
  }
}

// rowsum(dO * o) of query row `row`, reduced over the 16 lanes that share
// the row (threads tid = i * 16 + c); every one of them returns the sum
template <typename T>
__device__ __forceinline__ float row_delta(const float* do_row, const T* o, int row,
                                           int T_len, int Dh) {
  const int c = threadIdx.x & 15;
  float acc = 0.f;
  if (row < T_len)
    for (int d = c; d < Dh; d += 16) acc += do_row[d] * to_f32(o[(size_t)row * Dh + d]);
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// p, pd and ds of one (row, col) pair from staged tiles; q_i and do_i point
// at the row's q and dO, k_j and v_j at the column's k and v (stride 1 in
// d), band_t at band[0, row, col] in the tile (stride BSTRIDE in d)
struct Pair {
  float pd, ds;
};

__device__ __forceinline__ Pair pair_grad(const Params& P, const float* q_i, const float* do_i,
                                          const float* k_j, const float* v_j,
                                          const float* band_t, int n, int row, int col,
                                          int len, float m, float l, float delta) {
  Pair r{0.f, 0.f};
  if (row >= P.T || col >= P.T) return r;
  float s = 0.f, dpn = 0.f;
  for (int d = 0; d < P.Dh; ++d) {
    s += q_i[d] * (k_j[d] + band_t[d * BSTRIDE]);
    dpn += do_i[d] * v_j[d];
  }
  if (col >= len) s = NEG_INF;
  const float p = expf(s - m) / l;
  const float ks = keep_scale(P, n, row, col);
  r.pd = p * ks;
  r.ds = col < len ? p * (dpn * ks - delta) : 0.f;
  return r;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------------ forward

inline size_t fwd_smem(int T_len, int Dh) {
  return sizeof(float) * ((size_t)FQ * cdiv(T_len, FK) * FK + (size_t)FQ * Dh +
                          (size_t)FK * (Dh + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ band, const int* __restrict__ lengths,
           T* __restrict__ out, float* __restrict__ stats, Params P) {
  extern __shared__ float smem[];
  const int T_len = P.T, Dh = P.Dh;
  const int t_pad = cdiv(T_len, FK) * FK;
  const int ldkv = Dh + 1;
  float* s_sc = smem;               // [FQ][t_pad] scores, then probabilities
  float* s_q = s_sc + FQ * t_pad;   // [FQ][Dh]
  float* s_kv = s_q + FQ * Dh;      // [FK][Dh + 1] key or value tile

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * FQ;
  const int tid = threadIdx.x;
  const int len = lengths[n];
  const size_t base = (size_t)n * T_len * Dh;
  const size_t dstride = (size_t)T_len * P.ldb;

  load_rows(s_q, Dh, q + base, q0, FQ, T_len, Dh);

  // ---- scores
  const int j = tid % FK;
  for (int k0 = 0; k0 < T_len; k0 += FK) {
    __syncthreads();
    load_rows(s_kv, ldkv, k + base, k0, FK, T_len, Dh);
    __syncthreads();
    const int col = k0 + j;
    for (int i = tid / FK; i < FQ; i += THREADS / FK) {
      const int row = q0 + i;
      float acc = 0.f;
      if (row < T_len && col < T_len) {
        const T* bp = band + (size_t)row * P.ldb + col;
        const float* qi = s_q + i * Dh;
        const float* kj = s_kv + j * ldkv;
        for (int d = 0; d < Dh; ++d) acc += qi[d] * (kj[d] + to_f32(bp[d * dstride]));
        if (col >= len) acc = NEG_INF;
      }
      s_sc[i * t_pad + col] = acc;
    }
  }
  __syncthreads();

  // ---- exact row softmax, normalised, dropped out, rounded to V's type
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < FQ; i += THREADS / 32) {
    const int row = q0 + i;
    float* srow = s_sc + i * t_pad;
    float m = -3.0e38f;  // below every score, masked ones included
    for (int c = lane; c < T_len; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < T_len; c += 32) {
      const float e = expf(srow[c] - m);
      l += e;
      srow[c] = e;
    }
    l = fmaxf(warp_sum(l), 1e-30f);
    for (int c = lane; c < T_len; c += 32)
      srow[c] = round_to<T>(srow[c] / l * keep_scale(P, n, row, c));
    for (int c = T_len + lane; c < t_pad; c += 32) srow[c] = 0.f;
    if (lane == 0 && row < T_len) {
      stats[(size_t)n * T_len + row] = m;
      stats[((size_t)P.N + n) * T_len + row] = l;
    }
  }

  // ---- out = P . V
  float acc[F_OUT];
#pragma unroll
  for (int r = 0; r < F_OUT; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += FK) {
    __syncthreads();
    load_rows(s_kv, ldkv, v + base, k0, FK, T_len, Dh);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < F_OUT; ++r) {
      const int idx = tid + r * THREADS;
      if (idx < FQ * Dh) {
        const int i = idx / Dh, d = idx - i * Dh;
        const float* prow = s_sc + i * t_pad + k0;
        float a = acc[r];
        for (int jj = 0; jj < FK; ++jj) a += prow[jj] * s_kv[jj * ldkv + d];
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < F_OUT; ++r) {
    const int idx = tid + r * THREADS;
    if (idx < FQ * Dh) {
      const int i = idx / Dh, d = idx - i * Dh;
      const int row = q0 + i;
      if (row < T_len) out[base + (size_t)row * Dh + d] = from_f32<T>(acc[r]);
    }
  }
}

// ------------------------------------------------------------ backward K1/K2

// shared memory of both backward kernels: q and dO tiles [BQ][Dh], k and v
// tiles [BK][Dh + 1], the band tile [Dh][BSTRIDE], two [BQ][PSTRIDE] tiles
inline size_t bwd_smem(int Dh) {
  return sizeof(float) * (2 * (size_t)BQ * Dh + 2 * (size_t)BK * (Dh + 1) +
                          (size_t)Dh * BSTRIDE + 2 * (size_t)BQ * PSTRIDE);
}

struct BwdSmem {
  float *q, *dO, *k, *v, *band, *t0, *t1;
  __device__ BwdSmem(float* s, int Dh) {
    q = s;
    dO = q + BQ * Dh;
    k = dO + BQ * Dh;
    v = k + BK * (Dh + 1);
    band = v + BK * (Dh + 1);
    t0 = band + Dh * BSTRIDE;
    t1 = t0 + BQ * PSTRIDE;
  }
};

// one 16 x 16 dband tile, summed over every n in order
template <typename T>
__device__ void dband_block(const T* q, const T* k, const T* v, const T* band,
                            const int* lengths, const T* o, const T* dout,
                            const float* stats, float* dband, const Params& P,
                            int qt, int kt, float* smem) {
  const int T_len = P.T, Dh = P.Dh, ldk = Dh + 1;
  BwdSmem S(smem, Dh);
  const int tid = threadIdx.x;
  const int i = tid / BK, j = tid % BK;
  const int q0 = qt * BQ, k0 = kt * BK;
  const int row = q0 + i, col = k0 + j;
  load_band_tile(S.band, band, q0, k0, T_len, Dh, P.ldb);

  float acc[MAX_DH];
#pragma unroll
  for (int d = 0; d < MAX_DH; ++d) acc[d] = 0.f;

  for (int n = 0; n < P.N; ++n) {
    const int len = lengths[n];
    if (len > 0 && k0 >= len) continue;   // ds is 0 on the whole tile
    const size_t base = (size_t)n * T_len * Dh;
    __syncthreads();
    load_rows(S.q, Dh, q + base, q0, BQ, T_len, Dh);
    load_rows(S.dO, Dh, dout + base, q0, BQ, T_len, Dh);
    load_rows(S.k, ldk, k + base, k0, BK, T_len, Dh);
    load_rows(S.v, ldk, v + base, k0, BK, T_len, Dh);
    __syncthreads();
    const float delta = row_delta(S.dO + i * Dh, o + base, row, T_len, Dh);
    float m = 0.f, l = 1.f;
    if (row < T_len) {
      m = stats[(size_t)n * T_len + row];
      l = stats[((size_t)P.N + n) * T_len + row];
    }
    const Pair g = pair_grad(P, S.q + i * Dh, S.dO + i * Dh, S.k + j * ldk, S.v + j * ldk,
                             S.band + tid, n, row, col, len, m, l, delta);
    const float* qi = S.q + i * Dh;
#pragma unroll
    for (int d = 0; d < MAX_DH; ++d)
      if (d < Dh) acc[d] += qi[d] * g.ds;
  }
  if (row < T_len && col < T_len) {
#pragma unroll
    for (int d = 0; d < MAX_DH; ++d)
      if (d < Dh) dband[(size_t)d * T_len * T_len + (size_t)row * T_len + col] = acc[d];
  }
}

// dq of 16 query rows of one n, looping over the key tiles
template <typename T>
__device__ void dq_block(const T* q, const T* k, const T* v, const T* band,
                         const int* lengths, const T* o, const T* dout, const float* stats,
                         T* dq, const Params& P, int n, int qt, float* smem) {
  const int T_len = P.T, Dh = P.Dh, ldk = Dh + 1;
  BwdSmem S(smem, Dh);
  float* ds_s = S.t0;
  const int tid = threadIdx.x;
  const int i = tid / BK, j = tid % BK;   // pair phase: (query row, key column)
  const int dc = tid % 16;                // accumulation phase: (query row, d chunk)
  const int q0 = qt * BQ, row = q0 + i;
  const int len = lengths[n];
  const size_t base = (size_t)n * T_len * Dh;

  load_rows(S.q, Dh, q + base, q0, BQ, T_len, Dh);
  load_rows(S.dO, Dh, dout + base, q0, BQ, T_len, Dh);
  __syncthreads();
  const float delta = row_delta(S.dO + i * Dh, o + base, row, T_len, Dh);
  float m = 0.f, l = 1.f;
  if (row < T_len) {
    m = stats[(size_t)n * T_len + row];
    l = stats[((size_t)P.N + n) * T_len + row];
  }

  float acc[DCH];
#pragma unroll
  for (int r = 0; r < DCH; ++r) acc[r] = 0.f;
  const int kend = len > 0 ? len : T_len;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_rows(S.k, ldk, k + base, k0, BK, T_len, Dh);
    load_rows(S.v, ldk, v + base, k0, BK, T_len, Dh);
    load_band_tile(S.band, band, q0, k0, T_len, Dh, P.ldb);
    __syncthreads();
    const Pair g = pair_grad(P, S.q + i * Dh, S.dO + i * Dh, S.k + j * ldk, S.v + j * ldk,
                             S.band + tid, n, row, k0 + j, len, m, l, delta);
    ds_s[i * PSTRIDE + j] = g.ds;
    __syncthreads();
    for (int jj = 0; jj < BK; ++jj) {
      const float dsv = ds_s[i * PSTRIDE + jj];
      const float dsk = round_to<T>(dsv);
      const float* kj = S.k + jj * ldk;
      const float* bt = S.band + i * BK + jj;
#pragma unroll
      for (int r = 0; r < DCH; ++r) {
        const int d = dc + 16 * r;
        if (d < Dh) acc[r] += dsk * kj[d] + dsv * bt[d * BSTRIDE];
      }
    }
  }
  if (row < T_len) {
#pragma unroll
    for (int r = 0; r < DCH; ++r) {
      const int d = dc + 16 * r;
      if (d < Dh) dq[base + (size_t)row * Dh + d] = from_f32<T>(acc[r]);
    }
  }
}

// K1: blocks [0, nQ*nK) own dband tiles (the long ones start first), the
// rest own (n, query tile) rows of dq
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ band, const int* __restrict__ lengths,
              const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ stats, T* __restrict__ dq,
              float* __restrict__ dband, Params P) {
  extern __shared__ float smem[];
  const int nQ = cdiv(P.T, BQ), nK = cdiv(P.T, BK);
  const int b = blockIdx.x;
  if (b < nQ * nK) {
    dband_block(q, k, v, band, lengths, o, dout, stats, dband, P, b / nK, b % nK, smem);
  } else {
    const int r = b - nQ * nK;
    dq_block(q, k, v, band, lengths, o, dout, stats, dq, P, r % P.N, r / P.N, smem);
  }
}

// K2: dk and dv of 16 key rows of one n, looping over the query tiles
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ band, const int* __restrict__ lengths,
               const T* __restrict__ o, const T* __restrict__ dout,
               const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
               Params P) {
  extern __shared__ float smem[];
  const int T_len = P.T, Dh = P.Dh, ldk = Dh + 1;
  BwdSmem S(smem, Dh);
  float* pd_s = S.t0;
  float* ds_s = S.t1;
  const int n = blockIdx.x % P.N;
  const int k0 = (blockIdx.x / P.N) * BK;
  const int tid = threadIdx.x;
  const int i = tid / BK, j = tid % BK;   // pair phase: (query row, key column)
  const int jr = tid / 16, dc = tid % 16; // accumulation phase: (key row, d chunk)
  const int len = lengths[n];
  const size_t base = (size_t)n * T_len * Dh;

  float acc_k[DCH], acc_v[DCH];
#pragma unroll
  for (int r = 0; r < DCH; ++r) acc_k[r] = acc_v[r] = 0.f;

  if (!(len > 0 && k0 >= len)) {   // else dk = dv = 0 on the whole tile
    load_rows(S.k, ldk, k + base, k0, BK, T_len, Dh);
    load_rows(S.v, ldk, v + base, k0, BK, T_len, Dh);
    for (int q0 = 0; q0 < T_len; q0 += BQ) {
      __syncthreads();
      load_rows(S.q, Dh, q + base, q0, BQ, T_len, Dh);
      load_rows(S.dO, Dh, dout + base, q0, BQ, T_len, Dh);
      load_band_tile(S.band, band, q0, k0, T_len, Dh, P.ldb);
      __syncthreads();
      const int row = q0 + i;
      const float delta = row_delta(S.dO + i * Dh, o + base, row, T_len, Dh);
      float m = 0.f, l = 1.f;
      if (row < T_len) {
        m = stats[(size_t)n * T_len + row];
        l = stats[((size_t)P.N + n) * T_len + row];
      }
      const Pair g = pair_grad(P, S.q + i * Dh, S.dO + i * Dh, S.k + j * ldk,
                               S.v + j * ldk, S.band + tid, n, row, k0 + j, len, m, l,
                               delta);
      pd_s[i * PSTRIDE + j] = round_to<T>(g.pd);
      ds_s[i * PSTRIDE + j] = g.ds;
      __syncthreads();
      for (int ii = 0; ii < BQ; ++ii) {
        const float pdv = pd_s[ii * PSTRIDE + jr];
        const float dsv = ds_s[ii * PSTRIDE + jr];
        const float* qi = S.q + ii * Dh;
        const float* doi = S.dO + ii * Dh;
#pragma unroll
        for (int r = 0; r < DCH; ++r) {
          const int d = dc + 16 * r;
          if (d < Dh) {
            acc_v[r] += pdv * doi[d];
            acc_k[r] += dsv * qi[d];
          }
        }
      }
    }
  }
  const int krow = k0 + jr;
  if (krow < T_len) {
#pragma unroll
    for (int r = 0; r < DCH; ++r) {
      const int d = dc + 16 * r;
      if (d < Dh) {
        dk[base + (size_t)krow * Dh + d] = from_f32<T>(acc_k[r]);
        dv[base + (size_t)krow * Dh + d] = from_f32<T>(acc_v[r]);
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// The launchers take f32 only (dtype 0): the bf16 forward runs on wgmma in
// banded_attention_fwd.cu, the bf16 backward in banded_attention_train_bwd.cu.
int check(int N, int T_len, int Dh, int ldb, int dtype) {
  if (N <= 0 || T_len <= 0 || T_len > MAX_T || Dh <= 0 || Dh > MAX_DH || ldb < T_len ||
      dtype != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* band, const int* lengths,
        void* out, float* stats, const Params& P, cudaStream_t s) {
  const size_t smem = fwd_smem(P.T, P.Dh);
  int err = set_smem(fwd_kernel<T>, smem);
  if (err) return err;
  dim3 grid(P.N, cdiv(P.T, FQ));
  fwd_kernel<T><<<grid, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)band, lengths, (T*)out, stats, P);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* band,
           const int* lengths, const void* o, const void* dout, const float* stats,
           void* dq, float* dband, const Params& P, cudaStream_t s) {
  const size_t smem = bwd_smem(P.Dh);
  int err = set_smem(bwd_dq_kernel<T>, smem);
  if (err) return err;
  const int blocks = cdiv(P.T, BQ) * cdiv(P.T, BK) + P.N * cdiv(P.T, BQ);
  bwd_dq_kernel<T><<<blocks, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)band, lengths, (const T*)o,
      (const T*)dout, stats, (T*)dq, dband, P);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* band,
            const int* lengths, const void* o, const void* dout, const float* stats,
            void* dk, void* dv, const Params& P, cudaStream_t s) {
  const size_t smem = bwd_smem(P.Dh);
  int err = set_smem(bwd_dkv_kernel<T>, smem);
  if (err) return err;
  const int blocks = P.N * cdiv(P.T, BK);
  bwd_dkv_kernel<T><<<blocks, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)band, lengths, (const T*)o,
      (const T*)dout, stats, (T*)dk, (T*)dv, P);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the only one these take).  ldb: the band's row stride
// in elements (T, or Tp = T rounded up to 8 for the encoder's row-padded
// band).  dropout: 0 or 1; thresh and scale are computed on the host as the
// TPU kernel computes them.  stats: [2, N, T] f32 (row max, row sum).  Each
// returns a cudaError_t (0 on success).
extern "C" int bat_fwd_launch(const void* q, const void* k, const void* v, const void* band,
                              const int* lengths, void* out, float* stats, int N, int T_len,
                              int Dh, int ldb, int dtype, int dropout, unsigned seed,
                              unsigned thresh, float scale, void* stream) {
  int err = check(N, T_len, Dh, ldb, dtype);
  if (err) return err;
  const Params P{N, T_len, Dh, ldb, dropout, seed, thresh, scale};
  return fwd<float>(q, k, v, band, lengths, out, stats, P, static_cast<cudaStream_t>(stream));
}

extern "C" int bat_bwd_dq_launch(const void* q, const void* k, const void* v,
                                 const void* band, const int* lengths, const void* o,
                                 const void* dout, const float* stats, void* dq,
                                 float* dband, int N, int T_len, int Dh, int ldb, int dtype,
                                 int dropout, unsigned seed, unsigned thresh, float scale,
                                 void* stream) {
  int err = check(N, T_len, Dh, ldb, dtype);
  if (err) return err;
  const Params P{N, T_len, Dh, ldb, dropout, seed, thresh, scale};
  return bwd_dq<float>(q, k, v, band, lengths, o, dout, stats, dq, dband, P,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int bat_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                  const void* band, const int* lengths, const void* o,
                                  const void* dout, const float* stats, void* dk, void* dv,
                                  int N, int T_len, int Dh, int ldb, int dtype, int dropout,
                                  unsigned seed, unsigned thresh, float scale,
                                  void* stream) {
  int err = check(N, T_len, Dh, ldb, dtype);
  if (err) return err;
  const Params P{N, T_len, Dh, ldb, dropout, seed, thresh, scale};
  return bwd_dkv<float>(q, k, v, band, lengths, o, dout, stats, dk, dv, P,
                        static_cast<cudaStream_t>(stream));
}
