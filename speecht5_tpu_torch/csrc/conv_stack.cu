// One layer of the wav2vec2 feature extractor's strided conv stack:
// VALID Conv1d with no bias, then the exact (erf) GELU, cast to x's type.
//
// Replaces the TPU kernel speecht5_tpu/ops/pallas_kernels.py
// conv_stack_pallas (:714, body _conv_stack_kernel :682, reached through
// conv_stack_fused :783), which runs feature-extractor layers 1-6
// ((k, s) = (3, 2) x 4, then (2, 2) x 2, 512 channels) in one program with
// every intermediate in VMEM.  That does not carry to Hopper: the input span
// of 32 final frames alone is ~2,000 rows x 512 channels, far beyond the
// 227 KB of shared memory a block can use.  So the Python wrapper launches
// this kernel once per layer and the intermediates go through device memory.
//
// Each launch is an implicit GEMM:
//
//   y[b, t, co] = gelu( sum_{j < k} sum_{ci} x[b, t*s + j, ci] * w[j, ci, co] )
//
// Because x rows are contiguous ([T, Cin] per batch row), the K = k*Cin
// inputs of output row t are one contiguous span of x starting at t*s*Cin:
// A[m, kk] = x[b][t*s*Cin + kk].  So the layer is a plain GEMM whose A rows
// overlap (row stride s*Cin < K), with B = w viewed as [k*Cin, Cout].  Tiles
// of 64 x 64 outputs, 16-deep K slices staged in shared memory, a 4 x 4
// micro-tile per thread, f32 accumulation, and the GELU and the cast fused
// into the store.
//
// What bounds it on an H100: at the Base shapes the stack is ~160 GFLOP for
// a 2 x 16 s batch against ~0.3 GB of input and output, so the work is bound
// by operations.  This first kernel runs them on the CUDA cores in f32, far
// from the bf16 tensor-core peak; a wgmma/TMA version is later work.
//
// x: [B, T_in, Cin]; w: [k, Cin, Cout]; y: [B, T_out, Cout]; one dtype
// (f32 or bf16) for all three.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_gelu_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                 int B, int T_in, int Cin, int T_out, int Cout, int ksize, int stride) {
  __shared__ float As[BKK][BM + 4];  // A tile, transposed: As[kk][m]
  __shared__ float Bs[BKK][BN];

  const int K = ksize * Cin;
  const long long M = (long long)B * T_out;
  const int n0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // A loader: row a_row of the tile, 4 consecutive kk from a_k
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const long long am = m0 + a_row;
  const T* a_ptr = nullptr;
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
      As[a_k + e][a_row] = (a_ptr != nullptr && kk < K) ? to_f32(a_ptr[kk]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + b_k, nn = n0 + b_n + e;
      Bs[b_k][b_n + e] = (kk < K && nn < Cout) ? to_f32(w[(long long)kk * Cout + nn]) : 0.f;
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
      if (nn < Cout) y[m * Cout + nn] = from_f32<T>(gelu_exact(acc[r][c]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int T_in, int Cin,
           int T_out, int Cout, int ksize, int stride, cudaStream_t s) {
  const long long M = (long long)B * T_out;
  const long long grid_y = (M + BM - 1) / BM;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((Cout + BN - 1) / BN, (unsigned)grid_y);
  conv_gelu_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      B, T_in, Cin, T_out, Cout, ksize, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int conv_gelu_launch(const void* x, const void* w, void* y, int B, int T_in,
                                int Cin, int T_out, int Cout, int ksize, int stride,
                                int dtype, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || ksize <= 0 || stride <= 0 || T_out <= 0 ||
      (long long)(T_out - 1) * stride + ksize > T_in)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, B, T_in, Cin, T_out, Cout, ksize, stride, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, B, T_in, Cin, T_out, Cout, ksize, stride, s);
  return (int)cudaErrorInvalidValue;
}
