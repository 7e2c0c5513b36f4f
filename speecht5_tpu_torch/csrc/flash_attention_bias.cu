// Streaming attention with an additive bias and a key mask, for the decode
// steps of the beam search.
//
// Replaces the TPU kernel speecht5_tpu/ops/pallas_kernels.py
// flash_attention_bias (:592, body _flash_kernel :553, pallas_call :624)
// with the contract of its dense specification
// (tests/test_pallas_kernels.py:105-112):
//
//   s[n,i,j] = sum_d q[n,i,d] * k[n,j,d] + bias[n,i,j]     (no scale: q comes
//                                                           scaled)
//   s[n,i,j] = -1e9                        where key_valid[n,j] is false
//   out[n,i] = sum_j softmax_j(s[n,i,:]) * v[n,j]
//
// q: [N, Tq, D]; k, v: [N, Tk, D]; out: [N, Tq, D]; bias: f32 [N, Tq, Tk] or
// null (a zero bias); key_valid: uint8 [N / R, Tk] or null (every key
// valid), row n reading mask row n / R (R = 12 heads on the decode path:
// one mask row per sample serves its heads, so no [N, Tk] copy is made).
// q, k, v and out share one dtype (f32 or bf16); every product and sum is
// f32.  A row whose keys are all invalid sees -1e9 on every key and so
// returns the mean of V over the Tk keys, as the dense formula does (the
// Pallas kernel averages over its padded length instead, ROADMAP C.3).
//
// Design.  One block owns BQ = 8 queries of one row n; the grid is
// (ceil(Tq / BQ), N).  The block streams the keys in tiles of BK = 64
// through one shared f32 buffer (K for the scores, then V for the product)
// and keeps, per query, the running max m, the running sum l of
// exp(s - m) and an f32 accumulator, as the TPU kernel does (:563-588):
// per tile m' = max(m, max_j s), alpha = exp(m - m'), p = exp(s - m'),
// l' = l * alpha + sum_j p, acc' = acc * alpha + cast_to_v_type(p) . V;
// the output is acc / max(l, 1e-30).  A tile with no valid key is skipped
// once every query of the block has a running max above -5e8: its keys would
// add exp(-1e9 - m) = 0 to l and acc and leave m unchanged, so skipping it
// changes no bit, and K and V are read only where the mask lets a key in (a
// row whose keys are all invalid still walks every tile).  No score row is
// kept, so Tk has no
// limit; the tails of Tq and Tk are guarded in the kernel (nothing is
// padded).  One warp owns a query row in the softmax step (two keys a
// lane); each thread keeps BQ * D / 128 outputs in registers.
//
// What bounds it on an H100: the work is 4 * Tq * D flops per valid key
// against reading q, the valid keys' K and V and the mask once and writing
// out once.  At the beam's shapes (N 12, Tq 5, Tk 799 with 549 valid, and
// N 60, Tq 1, Tk 201 with 101 valid, D 64) that is one or two MB, under a
// microsecond at 3.35 TB/s, so the floor is the launch itself; the kernel
// runs every product on the CUDA cores in f32, reads K and V once per query
// tile (once per row here), and its time is set by the serial walk over the
// key tiles of too few blocks (12 at the cross shape).  A split over the
// keys (flash decoding) is the later redesign.
//
// Limits: D <= 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 8;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 128;
constexpr int OUT_PER_THREAD = BQ * MAX_D / THREADS;
constexpr float NEG_INF = -1e9f;
// a running max above this makes exp(NEG_INF - m) exactly 0 in f32
constexpr float SKIP_ABOVE = -5e8f;

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

inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BQ * BK);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  const uint8_t* __restrict__ key_valid, T* __restrict__ out,
                  int Tq, int Tk, int D, int R) {
  extern __shared__ float smem[];
  __shared__ float s_m[BQ], s_l[BQ], s_alpha[BQ];
  const int ld = D + 1;  // odd stride: conflict-free reads along keys
  float* s_q = smem;               // [BQ][D]
  float* s_kv = s_q + BQ * D;      // [BK][D + 1]: the K tile, then the V tile
  float* s_p = s_kv + BK * ld;     // [BQ][BK]: scores, then probabilities

  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t q_base = (size_t)n * Tq * D;
  const size_t kv_base = (size_t)n * Tk * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int i = idx / D, d = idx - i * D;
    const int row = q0 + i;
    s_q[idx] = row < Tq ? to_f32(q[q_base + (size_t)row * D + d]) : 0.f;
  }
  if (tid < BQ) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int r = 0; r < OUT_PER_THREAD; ++r) acc[r] = 0.f;

  const int j = tid % BK;
  const int i_first = tid / BK;
  __syncthreads();  // s_q, s_m and s_l are set before any thread reads them
  const uint8_t* mask_row = key_valid == nullptr ? nullptr : key_valid + (size_t)(n / R) * Tk;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    const int col = k0 + j;
    const bool in_range = col < Tk;
    const bool valid = in_range && (mask_row == nullptr || mask_row[col]);
    bool settled = true;
    for (int i = 0; i < BQ; ++i) settled = settled && s_m[i] > SKIP_ABOVE;
    // the barrier also means the previous tile's P.V is done with s_kv and
    // s_p; every thread sees the same answer, so the skip is uniform
    if (!__syncthreads_or(valid) && settled) continue;
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int jj = idx / D, d = idx - jj * D;
      const int c = k0 + jj;
      s_kv[jj * ld + d] = c < Tk ? to_f32(k[kv_base + (size_t)c * D + d]) : 0.f;
    }
    __syncthreads();

    // ---- scores of this tile: q . k + bias, masked keys exactly -1e9
    for (int i = i_first; i < BQ; i += THREADS / BK) {
      const int row = q0 + i;
      float s = -INFINITY;  // keys past Tk take no part
      if (in_range) {
        if (valid) {
          const float* qi = s_q + i * D;
          const float* kj = s_kv + j * ld;
          float a = 0.f;
          for (int d = 0; d < D; ++d) a += qi[d] * kj[d];
          if (bias != nullptr && row < Tq)
            a += bias[((size_t)n * Tq + row) * Tk + col];
          s = a;
        } else {
          s = NEG_INF;
        }
      }
      s_p[i * BK + j] = s;
    }
    __syncthreads();

    // ---- online softmax, one warp per query row; meanwhile stage V
    for (int i = warp; i < BQ; i += WARPS) {
      float* prow = s_p + i * BK;
      const float s0 = prow[lane], s1 = prow[lane + 32];
      const float m_old = s_m[i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = k0 + lane < Tk ? expf(s0 - m_new) : 0.f;
      const float p1 = k0 + lane + 32 < Tk ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      // the probabilities enter P.V rounded to V's type, as in the TPU kernel
      prow[lane] = to_f32(from_f32<T>(p0));
      prow[lane + 32] = to_f32(from_f32<T>(p1));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        s_alpha[i] = alpha;
        s_l[i] = s_l[i] * alpha + sum;
        s_m[i] = m_new;
      }
    }
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int jj = idx / D, d = idx - jj * D;
      const int c = k0 + jj;
      s_kv[jj * ld + d] = c < Tk ? to_f32(v[kv_base + (size_t)c * D + d]) : 0.f;
    }
    __syncthreads();

    // ---- acc = acc * alpha + P . V
#pragma unroll
    for (int r = 0; r < OUT_PER_THREAD; ++r) {
      const int idx = tid + r * THREADS;
      if (idx < BQ * D) {
        const int i = idx / D, d = idx - i * D;
        const float* prow = s_p + i * BK;
        float a = acc[r] * s_alpha[i];
        for (int jj = 0; jj < BK; ++jj) a += prow[jj] * s_kv[jj * ld + d];
        acc[r] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < OUT_PER_THREAD; ++r) {
    const int idx = tid + r * THREADS;
    if (idx < BQ * D) {
      const int i = idx / D, d = idx - i * D;
      const int row = q0 + i;
      if (row < Tq)
        out[q_base + (size_t)row * D + d] = from_f32<T>(acc[r] / fmaxf(s_l[i], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const uint8_t* key_valid, void* out, int N, int Tq, int Tk, int D,
           int R, cudaStream_t stream) {
  dim3 grid((Tq + BQ - 1) / BQ, N);
  flash_bias_kernel<T><<<grid, THREADS, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, key_valid, static_cast<T*>(out), Tq, Tk, D, R);
  return (int)cudaGetLastError();
}

}  // namespace

// bias and key_valid may be null; rows_per_mask (R) divides N.  dtype: 0 =
// float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_bias_launch(const void* q, const void* k, const void* v,
                                 const void* bias, const void* key_valid, void* out,
                                 int N, int Tq, int Tk, int D, int rows_per_mask,
                                 int dtype, void* stream) {
  if (N <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > MAX_D || N > 65535 ||
      rows_per_mask <= 0 || N % rows_per_mask != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  const int R = rows_per_mask;
  if (dtype == 0) return launch<float>(q, k, v, b, kv, out, N, Tq, Tk, D, R, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, b, kv, out, N, Tq, Tk, D, R, s);
  return (int)cudaErrorInvalidValue;
}
