// Waveform -> log10-mel spectrogram in one pass (librosa parity):
//
//   x        = reflect_pad(wav, n_fft / 2)              (center only)
//   X[f, k]  = sum_t x[f*hop + t] * win[t] * exp(-2 pi i t k / n_fft)
//   mel[f,m] = sum_k sqrt(re(X)^2 + im(X)^2 + 1e-30) * fb[m, k]
//   out[f,m] = log10(max(eps, mel[f,m]))
//
// Replaces the TPU kernel speecht5_tpu/ops/pallas_kernels.py fused_log_mel
// (:97, body _mel_kernel :57, pallas_call :154).  The TPU kernel runs the
// DFT as products against cos/sin tables on the MXU; on Hopper the transform
// is an FFT in registers and warp shuffles instead.
//
// Design: a block of 8 warps owns 8 consecutive frames of one utterance,
// a warp a frame.  It stages their strip of 7 * hop + n_fft samples in
// shared memory once (reflect padding resolved while staging, loads batched
// ahead of their stores, float4s where the strip is inside the waveform
// and aligned).  Per frame, the n_fft-point real FFT is an M = n_fft / 2
// point complex FFT of z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1], done as a
// four-step FFT with M = N1 x 32 (n = lane + 32 n1, k = k1 + N1 k2):
//   1. lane l loads its N1 samples z[l + 32 n1] (window applied) and runs
//      an N1-point radix-2 DIF in registers;
//   2. multiplies its k1-th result by exp(-2 pi i l k1 / M);
//   3. the 32-point DFTs over the lanes run as a radix-2 DIF by warp
//      shuffles, so lane l ends with Z[k1 + N1 * bitrev5(l)] for every k1;
//   4. one store puts Z in shared memory in natural order, a pad word
//      after every N1 entries keeping the store and the reads below free of
//      bank conflicts.
// The split step then gives the n_fft / 2 + 1 bins: X[k] = E + W^k O with
// E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i and
// W = exp(-2 pi i / n_fft), and the magnitudes go to shared memory over the
// frame's own row of Z.  The filterbank is sparse: each mel reads its own [start, start +
// len) bins and its weights, stored transposed and padded with zeros to the
// longest support (942 of 41,040 entries are non-zero at Base, 35 the longest
// support), and a thread per (frame, mel) sums it and stores the log, mels
// contiguous.  All twiddles come from one table built on the host in float64
// and cast to f32.  Every operation is an f32 FMA or add on the CUDA cores:
// no TF32 or bf16 anywhere, since reduced precision distorts the low-energy
// bins after the log.  An all-zero frame gives magnitudes of exactly
// sqrt(1e-30), so log10(eps) exactly.
//
// What bounds it on an H100: the function needs, per frame, the window, one
// real FFT (2.5 * n_fft * log2(n_fft) flops), the magnitudes, a multiply-add
// for each of the filterbank's 942 non-zero entries and a log per mel, about
// 31 kflop; at the t2s step's batch of 16 x 768 frames (n_fft 1024, 513
// bins, 80 mels) that is 0.38 GFLOP, 5.7 us at the 67 TFLOP/s f32 peak,
// against 4.9 us for the 16.6 MB of waveform and output it must move.  The
// first design ran the O(n^2) DFT as two products against windowed cos and
// sin tables plus the dense filterbank product, 25.9 GFLOP, at 1.467 ms
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).  This one does the
// function's own work.  A first FFT design of this kind, mixed-radix
// Stockham passes through shared memory, took 0.069 ms: every pass read and
// wrote the frame's M values, with 2-4-way bank conflicts in the early
// passes.  The four-step form keeps the transform in registers and
// shuffles and touches shared memory once per value: 0.054 ms (same card,
// chip_smoke.py), bound by instruction throughput: ~2400 warp
// instructions a frame, a third of them the cross-lane shuffles.
//
// wav: [B, T] f32; win: [n_fft] f32; tw: [3 n_fft / 2] complex f32,
// exp(-2 pi i k / n_fft) for k < n_fft, then exp(-2 pi i l k1 / M) at
// n_fft + 32 k1 + l; fb_w: [max len, n_mels] f32, mel m's q-th weight at
// [q, m]; fb_idx: [n_mels, 2] int32 (start bin, length); out: [B, n_frames,
// n_mels] f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int FPB = 8;                 // frames per block, a warp each
constexpr int THREADS = 32 * FPB;
constexpr int MAX_MELS = 128;
constexpr int MIN_N_FFT = 256;
constexpr int MAX_N_FFT = 2048;

__device__ __forceinline__ int reflect_index(int j, int T) {
  // numpy / torch "reflect" (the edge sample is not repeated); pad < T
  if (j < 0) j = -j;
  if (j >= T) j = 2 * (T - 1) - j;
  return j;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// f(std::integral_constant<int, i>()) for i = 0 .. N-1, unrolled at compile
// time, so that register arrays are only ever indexed by constants (one
// indexed at run time would go to local memory)
template <class F, int... I>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>()), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>());
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }
__host__ __device__ constexpr int bitrev(int k, int bits) {
  return bits == 0 ? 0 : ((k & 1) << (bits - 1)) | bitrev(k >> 1, bits - 1);
}

// shared memory: per frame a padded row of Z (M + 32 entries: one pad after
// every N1; the magnitudes later), then the strip
size_t smem_bytes(int n_fft, int hop) {
  return sizeof(float2) * FPB * (n_fft / 2 + 32) +
         sizeof(float) * ((size_t)(FPB - 1) * hop + n_fft);
}

template <int N1>
__global__ void __launch_bounds__(THREADS)
log_mel_fft_kernel(const float* __restrict__ wav, const float* __restrict__ win,
                   const float2* __restrict__ tw, const float* __restrict__ fb_w,
                   const int* __restrict__ fb_idx, float* __restrict__ out, int T,
                   int n_frames, int hop, int n_mels, int center, float eps) {
  constexpr int M = 32 * N1, N = 2 * M, LOG_N1 = ilog2(N1), ZS = M + 32;
  extern __shared__ float2 smem2[];
  float2* zs = smem2;                                          // [FPB][ZS]
  float* strip = reinterpret_cast<float*>(zs + FPB * ZS);      // [(FPB-1)*hop + N]
  const int strip_len = (FPB - 1) * hop + N;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FPB;
  const int tid = threadIdx.x;
  const float* x = wav + (size_t)b * T;
  const int pad = center ? N / 2 : 0;
  const long long padded_len = (long long)T + 2 * pad;

  // the strip of the (padded) signal that the block's frames cover; samples
  // past its end belong only to frames past n_frames, which are not stored.
  // Loads are batched ahead of their stores; a strip inside the waveform
  // and 16-byte aligned goes in float4s.
  const long long p0 = (long long)f0 * hop;
  const float* first = x + (p0 - pad);
  if (p0 - pad >= 0 && p0 - pad + strip_len <= T && strip_len % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(first) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(first);
    float4* strip4 = reinterpret_cast<float4*>(strip);
#pragma unroll 4
    for (int i = tid; i < strip_len / 4; i += THREADS) strip4[i] = __ldg(src4 + i);
  } else {
#pragma unroll 8
    for (int i = tid; i < strip_len; i += THREADS) {
      const long long q = p0 + i;
      float v = 0.f;
      if (q < padded_len) v = __ldg(x + (center ? reflect_index((int)(q - pad), T) : (int)q));
      strip[i] = v;
    }
  }
  __syncthreads();

  const int f = tid / 32, lane = tid % 32;
  const float2* tw_n = tw;       // exp(-2 pi i k / N), k < N
  const float2* tw_m = tw + N;   // [N1][32]: exp(-2 pi i lane k1 / M)

  // 1. z[lane + 32 n1], windowed, then an N1-point DIF in registers:
  //    a[bitrev(k1)] = sum_n1 z[lane + 32 n1] W_N1^(n1 k1)
  float2 a[N1];
  const float* xs = strip + f * hop;
  const float2* win2 = reinterpret_cast<const float2*>(win);
#pragma unroll
  for (int n1 = 0; n1 < N1; ++n1) {
    const int n = lane + 32 * n1;
    // the pair x[2n], x[2n+1] as one load when hop keeps it 8-byte aligned
    const float2 xv = (hop & 1) ? make_float2(xs[2 * n], xs[2 * n + 1])
                                : reinterpret_cast<const float2*>(xs)[n];
    const float2 wv = __ldg(win2 + n);
    a[n1] = make_float2(xv.x * wv.x, xv.y * wv.y);
  }
  static_for<LOG_N1>([&](auto st) {
    constexpr int h = N1 >> (decltype(st)::value + 1);
    static_for<N1 / 2>([&](auto bf) {   // butterfly bf of the stage
      constexpr int j = decltype(bf)::value % h;
      constexpr int lo = (decltype(bf)::value / h) * 2 * h + j;
      const float2 u = a[lo], v = a[lo + h];
      a[lo] = cadd(u, v);
      a[lo + h] = j == 0 ? csub(u, v) : cmul(csub(u, v), __ldg(tw_n + j * (N / (2 * h))));
    });
  });

  // register j now holds k1 = bitrev(j); the values stay where they are and
  // the permutation goes into the addresses.
  // 2. W_M^(lane k1); 3. the 32-point DFTs over the lanes, radix-2 DIF by
  //    shuffles: lane l ends with Z[k1 + N1 bitrev5(l)]
  static_for<N1>([&](auto jc) {
    constexpr int j = decltype(jc)::value, k1 = bitrev(j, LOG_N1);
    a[j] = cmul(a[j], __ldg(tw_m + k1 * 32 + lane));
  });
  static_for<5>([&](auto st) {
    constexpr int h = 16 >> decltype(st)::value;
    const float2 w = __ldg(tw_n + (lane & (h - 1)) * (N / (2 * h)));
    const bool upper = lane & h;
    static_for<N1>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      const float2 p = make_float2(__shfl_xor_sync(0xffffffffu, a[j].x, h),
                                   __shfl_xor_sync(0xffffffffu, a[j].y, h));
      a[j] = upper ? cmul(csub(p, a[j]), w) : cadd(a[j], p);
    });
  });

  // 4. Z in natural order, entry k at k + k / N1
  float2* zf = zs + f * ZS;
  const int k2 = __brev(lane) >> 27;
  static_for<N1>([&](auto jc) {
    constexpr int j = decltype(jc)::value, k1 = bitrev(j, LOG_N1);
    zf[k1 + (N1 + 1) * k2] = a[j];
  });
  __syncwarp();

  // split step: the n_fft / 2 + 1 bins of the real transform, as
  // magnitudes, held in registers until the warp has read all of Z and then
  // written over the frame's own row
  constexpr int KPL = (M + 1 + 31) / 32;  // bins per lane
  float mv[KPL];
  static_for<KPL>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    const int k = lane + 32 * i;
    if (k <= M) {
      const int ka = k & (M - 1), kb = (M - k) & (M - 1);
      const float2 za = zf[ka + (ka >> LOG_N1)];
      const float2 zc = zf[kb + (kb >> LOG_N1)];           // conj taken below
      const float2 e = make_float2(0.5f * (za.x + zc.x), 0.5f * (za.y - zc.y));
      const float2 dd = make_float2(0.5f * (za.x - zc.x), 0.5f * (za.y + zc.y));
      const float2 o = make_float2(dd.y, -dd.x);           // dd / i
      const float2 X = cadd(e, cmul(__ldg(tw_n + k), o));
      mv[i] = sqrtf(X.x * X.x + X.y * X.y + 1e-30f);
    }
  });
  __syncwarp();
  float* mf = reinterpret_cast<float*>(zf);                // [M + 1] of the row
  static_for<KPL>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    if (lane + 32 * i <= M) mf[lane + 32 * i] = mv[i];
  });
  __syncthreads();

  // sparse filterbank and log, a thread per (frame, mel), consecutive
  // threads on consecutive mels: mel m's q-th weight sits at fb_w[q * n_mels
  // + m], so a warp reads its weights in one coalesced load a step
  for (int item = tid; item < FPB * n_mels; item += THREADS) {
    const int g = item / n_mels, m = item - g * n_mels;
    if (f0 + g >= n_frames) break;    // items run frame by frame
    const int start = __ldg(fb_idx + 2 * m), len = __ldg(fb_idx + 2 * m + 1);
    const float* mg = reinterpret_cast<const float*>(zs + g * ZS) + start;
    float acc = 0.f;
#pragma unroll 4
    for (int q = 0; q < len; ++q) acc = fmaf(mg[q], __ldg(fb_w + q * n_mels + m), acc);
    out[((size_t)b * n_frames + f0 + g) * n_mels + m] = log10f(fmaxf(eps, acc));
  }
}

template <int N1>
int launch(const float* wav, const float* win, const float* tw, const float* fb_w,
           const int* fb_idx, float* out, int B, int T, int n_frames, int hop, int n_mels,
           int center, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(64 * N1, hop);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_fft_kernel<N1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + FPB - 1) / FPB, B);
  log_mel_fft_kernel<N1><<<grid, THREADS, smem, stream>>>(
      wav, win, reinterpret_cast<const float2*>(tw), fb_w, fb_idx, out, T, n_frames, hop,
      n_mels, center, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// center: 1 = reflect-pad n_fft / 2 on both sides (n_frames = 1 + T / hop),
// 0 = frame the waveform as given (n_frames = 1 + (T - n_fft) / hop).
// n_fft a power of two in [256, 2048], hop | n_fft, 0 < n_mels <= 128.
// Returns a cudaError_t (0 on success); launches on ``stream`` and does not
// synchronise.
extern "C" int log_mel_launch(const float* wav, const float* win, const float* tw,
                              const float* fb_w, const int* fb_idx, float* out, int B, int T,
                              int n_frames, int n_fft, int hop, int n_mels, int center,
                              float eps, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || n_frames <= 0 || n_fft < MIN_N_FFT ||
      n_fft > MAX_N_FFT || (n_fft & (n_fft - 1)) != 0 || hop <= 0 || n_fft % hop != 0 ||
      n_mels <= 0 || n_mels > MAX_MELS)
    return (int)cudaErrorInvalidValue;
  if (center ? (T <= n_fft / 2 || n_frames != 1 + T / hop)
             : (T < n_fft || n_frames != 1 + (T - n_fft) / hop))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto n1) {
    return launch<decltype(n1)::value>(wav, win, tw, fb_w, fb_idx, out, B, T, n_frames, hop,
                                       n_mels, center, eps, s);
  };
  switch (n_fft) {  // N1 = n_fft / 64
    case 256: return go(std::integral_constant<int, 4>());
    case 512: return go(std::integral_constant<int, 8>());
    case 1024: return go(std::integral_constant<int, 16>());
    default: return go(std::integral_constant<int, 32>());
  }
}
