// The bf16 forward of the banded relative-position self-attention on wgmma
// tensor cores: the inference attention and the train forward.
//
// Replaces, on the bf16 route, the TPU kernels of
// speecht5_tpu/ops/pallas_kernels.py:
//   pallas_call :253 (banded_flash_attention, _banded_attn_kernel :183)
//       -> baf_bias_launch, baf_main_launch(train = 0)
//   pallas_call :427 (_bfa_train_fwd, _train_attn_fwd_kernel :310)
//       -> baf_bias_launch, baf_main_launch(train = 1)
// The f32 route keeps the CUDA-core kernels of banded_attention.cu and
// banded_attention_train.cu: wgmma has no full-f32 product.
//
// Contracts: banded_attention.cu:7-15 (inference) and
// banded_attention_train.cu:10-27 (train).  q pre-scaled; q, k, v, out
// [N, T, Dh] bf16; band [Dh, T, T] read with rows of Tp (below); lengths
// int32 [N]:
//   s[n,i,j] = sum_d q[n,i,d] (k[n,j,d] + band[d,i,j]),  -1e9 at j >= len[n]
//   inference: out = sum_j p[i,j] v[j] / max(l, 1e-30),  p = exp(s - m)
//   train:     out = sum_j p[i,j] keep[i,j] / (1 - rate) v[j] / l, with the
//              lowbias32 keep mask of (seed, n, row, column), bit for bit
//              (pallas_kernels.py:265-287), and stats [2, N, T] f32 = (m,
//              l = max(rowsum exp(s - m), 1e-30)), which the backward reads.
// A row of length 0 sees -1e9 on every one of the T keys: uniform p, so its
// output is the (dropped-out) mean of V over the T keys, never NaN.
//
// Two launches:
//   bias  (grid T, one query row i a block; banded_attention_wgmma.cuh, the
//         backward's bias pass without delta)
//         bias[n, i, :] = Q_i [N x Dh] . Band_i [Dh x T], f32 [N, T, Tp]
//   main  (grid N x T/64, one (n, 64-row query tile) a block, looping over
//         the 64-key tiles below the row's length; a row of length 0 over
//         every tile of the T keys)
//         S = Q.K^T (wgmma m64n64k16, Q and K K-major, K and V through a
//         three-stage TMA ring), plus the f32 bias tile loaded under the
//         product, the keys at or past the length dropped; an online f32
//         softmax in registers (running row max m and sum l, the four lanes
//         of a row reduced with shuffles); O = O exp(m_old - m) + bf16(p).V
//         with p going from the S accumulators straight into wgmma's
//         register A operand (the accumulator layout is the A fragment
//         layout) and V read MN-major.  The end divides by l (inference:
//         max(l, 1e-30)) and writes out in bf16 (train: and the stats).
// The scores are Q.K^T on the same wgmma tiles as the backward's dq main
// loop plus the same bias pass, so the backward recomputes the forward's
// scores bit for bit.
//
// Rounding points (the twins round the probabilities to bf16 once before
// P.V: the inference twin the unnormalised exp(s - m) at the final row max,
// the train twin the normalised p keep / (1 - rate)):
//   - s, the bias, m and l in f32; p = __expf(s - m_running), summed into l
//     in f32 before the keep mask;
//   - p (train: p keep / (1 - rate)) rounded to bf16 at the running max for
//     P.V; O rescaled by exp(m_old - m) in f32; the final division in f32.
// So each probability is rounded to bf16 once in both forms, at another
// scale (exp(m_final - m_running)) in the kernel: the two differ by about
// one bf16 rounding of each probability, well inside 3e-2 x max|ref|.
//
// What bounds it on an H100: the function needs q, k, v, out and the band
// once (82 MB of band at T 799) and 6 Dh flops a (n, i, j) pair over the
// valid keys: bytes bound.  This design also writes and reads the f32 bias
// (N T Tp x 4 bytes: 31 MB at N 12, 491 MB at N 192, T 799), which sets the
// pace at the train shapes.  The main loop waits on each tile's chain (S
// product, bias, softmax, P.V product); the other blocks of an SM (57 KB of
// shared memory each, so the registers set how many) fill the gaps.
//
// Limits: T <= 1024, Dh a multiple of 16 up to 64; pointers 16-byte
// aligned.  The wrapper raises on anything else.

#include "banded_attention_wgmma.cuh"

namespace {

using MainSmem = Smem<1, 3>;  // the Q tile; three stages of (K, V)

template <bool TRAIN>
__global__ void __launch_bounds__(THREADS)
main_kernel(const __grid_constant__ CUtensorMap q_rows, const __grid_constant__ CUtensorMap k_rows,
            const __grid_constant__ CUtensorMap v_rows, const int* __restrict__ lengths,
            const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ stats,
            int N, int T, int Dh, Hash H) {
  const int nqt = cdiv(T, TILE);
  const int n = blockIdx.x / nqt, i0 = (blockIdx.x % nqt) * TILE;
  const int len = lengths[n];
  const int Tp = pad8(T);
  const bool none = len <= 0;            // no valid key: every key at -1e9
  const int lim = none ? T : min(len, T);  // the keys that take part
  const int nkt = cdiv(lim, TILE);

  extern __shared__ uint8_t smem_raw[];
  const MainSmem sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_expect_tx(sm.bar_fixed(), BOX);
    tma_load_3d(sm.fixed, &q_rows, sm.bar_fixed(), 0, i0, n);
  }
  auto issue = [&](int it, uint32_t dst, uint32_t bar) {
    tma_load_3d(dst, &k_rows, bar, 0, it * TILE, n);
    tma_load_3d(dst + BOX, &v_rows, bar, 0, it * TILE, n);
  };
  ring_start(sm, nkt, issue);

  const int row0 = i0 + acc_row(0);  // the thread's two query rows: row0, row0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float o[32];
  zero(o);
  mbar_wait(sm.bar_fixed(), 0);

  ring_run(
      sm, nkt, issue,
      [&](int it, uint32_t st) {
        const int j0 = it * TILE;
        float s[32];
        zero(s);
        fence_acc(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(s, kmajor(sm.fixed, kk), kmajor(st, kk));
        wgmma_commit();
        float2 b[16];  // the bias of the thread's elements, loaded under the product
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int row = row0 + 8 * ((e >> 1) & 1), j = j0 + acc_col(e);
          b[e / 2] = (!none && row < T && j < lim)
                         ? *reinterpret_cast<const float2*>(bias + ((size_t)n * T + row) * Tp + j)
                         : make_float2(0.f, 0.f);
        }
        wgmma_wait_all();
        fence_acc(s);
        fence_acc(o);

        float mt[2] = {-INFINITY, -INFINITY};  // the tile's row max
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int j = j0 + acc_col(e);
          const float x = j >= lim ? -INFINITY
                          : none   ? NEG_INF
                                   : s[e] + ((e & 1) ? b[e / 2].y : b[e / 2].x);
          s[e] = x;
          mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], x);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
          mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
          // every tile holds a key below lim, so the new max is finite
          const float mn = fmaxf(m[h], mt[h]);
          const float alpha = __expf(m[h] - mn);  // 0 on the first tile
          m[h] = mn;
          l[h] *= alpha;
#pragma unroll
          for (int e = 0; e < 32; ++e)
            if (((e >> 1) & 1) == h) o[e] *= alpha;
        }

        uint32_t a[4][4];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int h = (e >> 1) & 1;
          float p[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            p[u] = __expf(s[e + u] - m[h]);  // 0 for a dropped key (s = -inf)
            l[h] += p[u];
            if (TRAIN) p[u] *= keep_scale(H, n, row0 + 8 * h, j0 + acc_col(e) + u);
          }
          a[e >> 3][(e >> 1) & 3] = pack_bf16(p[0], p[1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, a[kk], mnmajor(st + BOX, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o);
        fence_frag(a);
      });

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / l[h];
  }
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int h = (e >> 1) & 1, row = row0 + 8 * h, d = acc_col(e);
    if (row < T && d < Dh)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)n * T + row) * Dh + d) =
          __floats2bfloat162_rn(o[e] * inv[h], o[e + 1] * inv[h]);
  }
  if (TRAIN && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < T) {
        stats[(size_t)n * T + row] = m[h];
        stats[((size_t)N + n) * T + row] = l[h];
      }
    }
  }
}

}  // namespace

// Both functions take bf16 tensors, return a cudaError_t (0 on success) or
// 100000 + a CUresult when a tensor map cannot be encoded, and launch one
// kernel on ``stream``.  Tp = T rounded up to 8.

// bias f32 [N, T, Tp] = q.band from q [N, T, Dh] and the band [Dh, T, Tp].
extern "C" int baf_bias_launch(const void* q, const void* band, float* bias, int N, int T,
                               int Dh, void* stream) {
  return launch_bias<false>(q, band, nullptr, nullptr, bias, nullptr, N, T, Dh, stream);
}

// out bf16 [N, T, Dh] from q, k, v [N, T, Dh], lengths int32 [N] and the
// bias pass's bias.  train: 0 (inference: stats unused, may be NULL) or 1
// (stats f32 [2, N, T]; dropout 0 or 1, thresh and scale as the TPU kernel
// computes them).
extern "C" int baf_main_launch(const void* q, const void* k, const void* v, const int* lengths,
                               const float* bias, void* out, float* stats, int N, int T, int Dh,
                               int train, int dropout, unsigned seed, unsigned thresh,
                               float scale, void* stream) {
  int err = check(N, T, Dh, {q, k, v, bias, out});
  if (err) return err;
  if (train && stats == nullptr) return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  CUtensorMap qm, km, vm;
  if ((err = rows_map(fn, &qm, q, N, T, Dh)) || (err = rows_map(fn, &km, k, N, T, Dh)) ||
      (err = rows_map(fn, &vm, v, N, T, Dh)))
    return err;
  const Hash H{dropout, seed, thresh, scale};
  auto kernel = train ? main_kernel<true> : main_kernel<false>;
  if ((err = prepare(kernel, MainSmem::BYTES))) return err;
  kernel<<<N * cdiv(T, TILE), THREADS, MainSmem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, lengths, bias, (bf16*)out, stats, N, T, Dh, H);
  return (int)cudaGetLastError();
}
