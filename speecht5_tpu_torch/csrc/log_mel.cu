// Waveform -> log10-mel spectrogram in one pass (librosa parity):
//
//   x      = reflect_pad(wav, n_fft / 2)              (center only)
//   re[f,k] = sum_t x[f*hop + t] * cos(2 pi t k / n_fft) * win[t]
//   im[f,k] = sum_t x[f*hop + t] * sin(-2 pi t k / n_fft) * win[t]
//   mel[f,m] = sum_k sqrt(re^2 + im^2 + 1e-30) * fb[k, m]
//   out[f,m] = log10(max(eps, mel[f,m]))
//
// Replaces the TPU kernel speecht5_tpu/ops/pallas_kernels.py fused_log_mel
// (:97, body _mel_kernel :57, pallas_call :154).  The TPU kernel DMAs n_fft
// / hop shifted row copies of the waveform so that every copy offset is
// 8-aligned (a Mosaic rule); Hopper has no such rule, so this kernel reads
// the waveform once, straight from device memory.
//
// Design: one block owns FT = 32 consecutive frames of one utterance.  It
// stages their strip of (FT - 1) * hop + n_fft samples in shared memory
// (reflect padding resolved while staging), then loops over tiles of KB = 64
// DFT bins.  A tile's re and im are a small GEMM of the frames (rows read
// from the strip) against the windowed DFT tables cos*win and sin*win
// ([n_fft, n_bins] f32, staged TT = 32 rows at a time), accumulated in f32
// FMAs on the CUDA cores with a 4-frame x 2-bin micro-tile per thread.  The
// tile's magnitudes go to shared memory and are projected at once onto the
// n_mels outputs, which the block keeps in registers for the whole loop:
// the [frames, n_bins] spectrum never reaches device memory.  The log is
// taken in the epilogue.  Every product is a true f32 FMA: no TF32 or bf16
// anywhere, since reduced precision distorts the low-energy bins after the
// log.
//
// What bounds it on an H100: the function needs, per frame, the window, one
// real FFT (2.5 * n_fft * log2(n_fft) flops), the magnitudes, a multiply-add
// for each of the filterbank's 942 non-zero entries and a log per mel, about
// 31 kflop; at the t2s step's batch of 16 x 768 frames (n_fft 1024, 513
// bins, 80 mels) that is 0.38 GFLOP, 5.7 us at the 67 TFLOP/s f32 peak,
// against 4.9 us for the 16.6 MB of waveform and output it must move.  This
// first kernel does far more work than that: the O(n^2) DFT as two products
// against the windowed tables plus the dense filterbank product, 25.9 GFLOP,
// on the CUDA cores in f32 with the products fed from shared memory (about
// two FMAs per shared load), so it sits some 250x off the bound.  An FFT in
// shared memory (O(n log n) instead of the O(n^2) DFT) and a sparse
// filterbank are the later redesign that closes most of that gap.
//
// wav: [B, T] f32; cosw, sinw: [n_fft, n_bins] f32; fb: [n_bins, n_mels]
// f32; out: [B, n_frames, n_mels] f32.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;        // frames per block
constexpr int KB = 64;        // DFT bins per tile (two per lane)
constexpr int TT = 32;        // table rows staged per step
constexpr int THREADS = 256;  // 32 lanes (bins) x 8 warps (frame groups)
constexpr int FPT = FT / (THREADS / 32);  // frames per thread: 4
constexpr int MAX_MELS = 128;
constexpr int OPT = FT * MAX_MELS / THREADS;  // mel outputs per thread: 16

__device__ __forceinline__ int reflect_index(int j, int T) {
  // numpy / torch "reflect" (the edge sample is not repeated); pad < T
  if (j < 0) j = -j;
  if (j >= T) j = 2 * (T - 1) - j;
  return j;
}

size_t smem_bytes(int n_fft, int hop) {
  return sizeof(float) * ((size_t)(FT - 1) * hop + n_fft + 2 * TT * KB + FT * KB);
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ wav, const float* __restrict__ cosw,
               const float* __restrict__ sinw, const float* __restrict__ fb,
               float* __restrict__ out, int T, int n_frames, int n_fft, int hop,
               int n_mels, int center, float eps) {
  extern __shared__ float smem[];
  const int n_bins = n_fft / 2 + 1;
  const int strip_len = (FT - 1) * hop + n_fft;
  float* strip = smem;                  // [strip_len]
  float* cos_s = strip + strip_len;     // [TT][KB]
  float* sin_s = cos_s + TT * KB;       // [TT][KB]
  float* mag_s = sin_s + TT * KB;       // [FT][KB]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int fr = (tid >> 5) * FPT;      // this thread's first frame in the tile
  const float* x = wav + (size_t)b * T;
  const int pad = center ? n_fft / 2 : 0;
  const long long padded_len = (long long)T + 2 * pad;

  // the strip of the (padded) signal that the tile's frames cover; samples
  // past its end belong only to frames past n_frames, which are not stored
  const long long p0 = (long long)f0 * hop;
  for (int i = tid; i < strip_len; i += THREADS) {
    const long long p = p0 + i;
    float v = 0.f;
    if (p < padded_len) v = x[center ? reflect_index((int)(p - pad), T) : (int)p];
    strip[i] = v;
  }

  const int n_out = FT * n_mels;
  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < n_bins; k0 += KB) {
    float re[FPT][2], im[FPT][2];
#pragma unroll
    for (int r = 0; r < FPT; ++r) {
      re[r][0] = re[r][1] = 0.f;
      im[r][0] = im[r][1] = 0.f;
    }
    for (int t0 = 0; t0 < n_fft; t0 += TT) {
      __syncthreads();  // the strip is staged / the previous tile is consumed
      for (int i = tid; i < TT * KB; i += THREADS) {
        const int tt = i / KB, k = k0 + (i % KB);
        float c = 0.f, s = 0.f;
        if (k < n_bins) {
          const size_t at = (size_t)(t0 + tt) * n_bins + k;
          c = cosw[at];
          s = sinw[at];
        }
        cos_s[i] = c;
        sin_s[i] = s;
      }
      __syncthreads();
      const float* xs = strip + fr * hop + t0;
#pragma unroll 8
      for (int tt = 0; tt < TT; ++tt) {
        const float c0 = cos_s[tt * KB + lane], c1 = cos_s[tt * KB + lane + 32];
        const float s0 = sin_s[tt * KB + lane], s1 = sin_s[tt * KB + lane + 32];
#pragma unroll
        for (int r = 0; r < FPT; ++r) {
          const float v = xs[r * hop + tt];
          re[r][0] = fmaf(v, c0, re[r][0]);
          re[r][1] = fmaf(v, c1, re[r][1]);
          im[r][0] = fmaf(v, s0, im[r][0]);
          im[r][1] = fmaf(v, s1, im[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < FPT; ++r) {
      mag_s[(fr + r) * KB + lane] = sqrtf(re[r][0] * re[r][0] + im[r][0] * im[r][0] + 1e-30f);
      mag_s[(fr + r) * KB + lane + 32] =
          sqrtf(re[r][1] * re[r][1] + im[r][1] * im[r][1] + 1e-30f);
    }
    __syncthreads();
    // project the tile's magnitudes onto the mel outputs this thread owns
    const int kn = min(KB, n_bins - k0);
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int o = tid + j * THREADS;
      if (o < n_out) {
        const int f = o / n_mels, m = o - f * n_mels;
        const float* mg = mag_s + f * KB;
        const float* w = fb + (size_t)k0 * n_mels + m;
        float a = acc[j];
        for (int kk = 0; kk < kn; ++kk) a = fmaf(mg[kk], w[(size_t)kk * n_mels], a);
        acc[j] = a;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int o = tid + j * THREADS;
    if (o < n_out) {
      const int f = o / n_mels, m = o - f * n_mels;
      if (f0 + f < n_frames)
        out[((size_t)b * n_frames + f0 + f) * n_mels + m] = log10f(fmaxf(eps, acc[j]));
    }
  }
}

}  // namespace

// center: 1 = reflect-pad n_fft / 2 on both sides (n_frames = 1 + T / hop),
// 0 = frame the waveform as given (n_frames = 1 + (T - n_fft) / hop).
// Returns a cudaError_t (0 on success); launches on ``stream`` and does not
// synchronise.
extern "C" int log_mel_launch(const float* wav, const float* cosw, const float* sinw,
                              const float* fb, float* out, int B, int T, int n_frames,
                              int n_fft, int hop, int n_mels, int center, float eps,
                              void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || n_frames <= 0 || n_fft <= 0 || hop <= 0 ||
      n_fft % TT != 0 || n_fft % hop != 0 || n_mels <= 0 || n_mels > MAX_MELS)
    return (int)cudaErrorInvalidValue;
  if (center ? (T <= n_fft / 2 || n_frames != 1 + T / hop)
             : (T < n_fft || n_frames != 1 + (T - n_fft) / hop))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + FT - 1) / FT, B);
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, cosw, sinw, fb, out, T, n_frames, n_fft, hop, n_mels, center, eps);
  return (int)cudaGetLastError();
}
