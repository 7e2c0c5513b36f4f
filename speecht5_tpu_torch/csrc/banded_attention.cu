// Banded relative-position self-attention for the post-LN SpeechT5 encoder.
//
// Replaces the TPU kernel speecht5_tpu/ops/pallas_kernels.py
// banded_flash_attention (:215, body _banded_attn_kernel :183) with the same
// contract:
//
//   s[n,i,j] = sum_d q[n,i,d] * (k[n,j,d] + band[d,i,j])      (q pre-scaled)
//   s[n,i,j] = -1e9                       where j >= lengths[n]
//   p        = exp(s - rowmax(s))          (f32)
//   out[n,i] = sum_j cast_to_v_type(p[i,j]) * v[n,j] / max(sum_j p[i,j], 1e-30)
//
// q, k, v, out: [N, T, Dh]; band: [Dh, T, T] with rows of ldb elements (T,
// or Tp = T rounded up to 8 for the encoder's row-padded band, so that no
// route copies it); lengths: int32 [N].  This file is the f32 route: the
// bf16 route runs on wgmma tensor cores in banded_attention_fwd.cu (wgmma
// has no full-f32 product).  Every product and sum is f32.  A row whose
// length is 0 sees -1e9 on every key and so returns the mean of V over the
// T keys, never NaN.
//
// Design.  One block owns BQ = 16 query rows of one (batch*head) row n.  The
// grid is (N, ceil(T / BQ)) with n in blockIdx.x, so the blocks that share a
// query block -- and so the same [Dh, BQ, T] slab of the band -- are
// scheduled next to each other and read the slab from L2 rather than device
// memory (13 MB at T = 799, f32).  The whole score row lives in shared
// memory (BQ x T f32, 64 KB at T = 1024), so the softmax is exact over the
// row, as in the TPU kernel, and the unnormalised probabilities are rounded
// to V's type before P.V exactly where the TPU kernel rounds them.  Keys and
// values are staged through shared memory in tiles of BK = 64 rows.
//
// What bounds it on an H100: the work is ~6*N*T*T*Dh flops and, at the
// least, one read of the band (Dh*T*T elements, the largest input).  In f32
// the flops set the floor.  This kernel runs every product on the CUDA
// cores in f32; the design keeps the band traffic in check (L2 reuse across
// heads, above).  A table-resident variant that reads the [2M, Dh] table
// instead of the band is later work.
//
// Limits: T <= 1024 (the row of scores must fit in shared memory; the
// caller routes longer sequences to the plain path, as the JAX module does),
// Dh <= 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 16;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int MAX_T = 1024;
constexpr int MAX_DH = 128;
constexpr int OUT_PER_THREAD = BQ * MAX_DH / THREADS;
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline int padded_len(int T) { return (T + BK - 1) / BK * BK; }

inline size_t smem_bytes(int T, int Dh) {
  return sizeof(float) * ((size_t)BQ * padded_len(T) + (size_t)BQ * Dh + (size_t)BK * (Dh + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
banded_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ band,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int T_len, int Dh, int ldb) {
  extern __shared__ float smem[];
  __shared__ float s_l[BQ];
  const int t_pad = (T_len + BK - 1) / BK * BK;
  const int ldkv = Dh + 1;  // odd stride: conflict-free column reads
  float* s_sc = smem;                 // [BQ][t_pad] scores, then probabilities
  float* s_q = s_sc + BQ * t_pad;     // [BQ][Dh]
  float* s_kv = s_q + BQ * Dh;        // [BK][Dh + 1] key or value tile

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int len = lengths[n];
  const size_t base = (size_t)n * T_len * Dh;
  const size_t dstride = (size_t)T_len * ldb;

  for (int idx = tid; idx < BQ * Dh; idx += THREADS) {
    const int i = idx / Dh, d = idx - i * Dh;
    const int row = q0 + i;
    s_q[idx] = row < T_len ? to_f32(q[base + (size_t)row * Dh + d]) : 0.f;
  }

  // ---- scores: s = q . (k + band), masked
  const int j = tid % BK;
  const int i_first = tid / BK;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * Dh; idx += THREADS) {
      const int jj = idx / Dh, d = idx - jj * Dh;
      const int col = k0 + jj;
      s_kv[jj * ldkv + d] = col < T_len ? to_f32(k[base + (size_t)col * Dh + d]) : 0.f;
    }
    __syncthreads();
    const int col = k0 + j;
    for (int i = i_first; i < BQ; i += THREADS / BK) {
      const int row = q0 + i;
      float acc = 0.f;
      if (row < T_len && col < T_len) {
        const T* bp = band + (size_t)row * ldb + col;
        const float* qi = s_q + i * Dh;
        const float* kj = s_kv + j * ldkv;
        for (int d = 0; d < Dh; ++d) acc += qi[d] * (kj[d] + to_f32(bp[d * dstride]));
        if (col >= len) acc = NEG_INF;
      }
      s_sc[i * t_pad + col] = acc;
    }
  }
  __syncthreads();

  // ---- exact row softmax statistics; p rounded to V's type for P.V
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < BQ; i += THREADS / 32) {
    float* srow = s_sc + i * t_pad;
    float m = -3.0e38f;  // below every score, masked ones included
    for (int c = lane; c < T_len; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < T_len; c += 32) {
      const float p = expf(srow[c] - m);
      l += p;
      srow[c] = to_f32(from_f32<T>(p));
    }
    for (int c = T_len + lane; c < t_pad; c += 32) srow[c] = 0.f;
    l = warp_sum(l);
    if (lane == 0) s_l[i] = l;
  }

  // ---- out = P . V / l
  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int r = 0; r < OUT_PER_THREAD; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * Dh; idx += THREADS) {
      const int jj = idx / Dh, d = idx - jj * Dh;
      const int col = k0 + jj;
      s_kv[jj * ldkv + d] = col < T_len ? to_f32(v[base + (size_t)col * Dh + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OUT_PER_THREAD; ++r) {
      const int idx = tid + r * THREADS;
      if (idx < BQ * Dh) {
        const int i = idx / Dh, d = idx - i * Dh;
        const float* prow = s_sc + i * t_pad + k0;
        float a = acc[r];
        for (int jj = 0; jj < BK; ++jj) a += prow[jj] * s_kv[jj * ldkv + d];
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < OUT_PER_THREAD; ++r) {
    const int idx = tid + r * THREADS;
    if (idx < BQ * Dh) {
      const int i = idx / Dh, d = idx - i * Dh;
      const int row = q0 + i;
      if (row < T_len)
        out[base + (size_t)row * Dh + d] = from_f32<T>(acc[r] / fmaxf(s_l[i], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* band,
           const int* lengths, void* out, int N, int T_len, int Dh, int ldb,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(T_len, Dh);
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, (T_len + BQ - 1) / BQ);
  banded_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(band), lengths, static_cast<T*>(out), T_len, Dh, ldb);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (bf16: banded_attention_fwd.cu); ldb: the band's row
// stride in elements, T <= ldb.  Returns a cudaError_t (0 on success).
extern "C" int banded_attention_launch(const void* q, const void* k, const void* v,
                                       const void* band, const int* lengths, void* out,
                                       int N, int T_len, int Dh, int ldb, int dtype,
                                       void* stream) {
  if (N <= 0 || T_len <= 0 || T_len > MAX_T || Dh <= 0 || Dh > MAX_DH || ldb < T_len ||
      dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch<float>(q, k, v, band, lengths, out, N, T_len, Dh, ldb,
                       static_cast<cudaStream_t>(stream));
}
