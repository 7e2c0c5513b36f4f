// Attention with an additive bias and a key mask at long queries, on wgmma
// tensor cores fed by TMA: the query-tiled path of flash_attention_bias, for
// WavLM's self-attention (Tq = Tk = 499 at 10 s, 1499 at 30 s).
//
// Replaces, for bf16 calls of the contract entry with long queries, the
// TPU kernel speecht5_tpu/ops/pallas_kernels.py flash_attention_bias
// (:592, body _flash_kernel :553, pallas_call :624), which is query-tiled
// too (block_q 128).  The decode steps (1-8 queries), f32, D 80 / 128 and
// the cached entry keep the cluster split of flash_attention_bias.cu;
// ops/cuda_kernels.py:flash_bias_path routes between the two.
//
// Contract (flash_attention_bias.cu:11-27, the dense specification of
// tests/test_pallas_kernels.py:105-112), on [N, T, D] rows:
//   s[n,i,j] = sum_d q[n,i,d] k[n,j,d] + bias[n,i,j]   (q comes scaled)
//   s[n,i,j] = -1e9          where key_valid[n / R, j] is false
//   out[n,i] = sum_j softmax_j(s[n,i,:]) v[n,j]
// q [N, Tq, D], k, v [N, Tk, D], out [N, Tq, D] bf16, contiguous; bias f32
// [N, Tq, Tk] or null (zero); key_valid uint8 [N / R, Tk] or null (every key
// valid).  A row whose keys are all invalid sees -1e9 on every key, so it
// returns the mean of V over exactly its Tk keys.
//
// What bounds it on an H100: per row the function reads the f32 bias (Tq x
// Tk x 4 bytes: 108 MB at N 12, T 1499) and 4 D flops a (query, key) pair:
// 64 flops per 4-byte bias element, under the bf16 ridge (~295 a byte), so
// the bias bytes set the bound (0.032 ms at T 1499).  The split kernel re-read
// a row's K and V once per 8 queries on CUDA cores; this one reads them once
// per 64 queries (from L2: 4.6 MB of K and V at T 1499) and does the
// products on tensor cores, so the bias read is what is left.
//
// Design: one block of one warpgroup (128 threads) a (row n, 64-query tile),
// grid N x ceil(Tq / 64), the banded forward's main loop
// (banded_attention_fwd.cu:70-200) on its helpers
// (banded_attention_wgmma.cuh):
//   - the Q tile loaded once by TMA (rows past Tq read as zeros);
//   - the row's key mask staged in shared memory once, and from it the list
//     of 64-key tiles to visit: those with a valid key, or every tile when
//     the row has none (then every key of the Tk is read at -1e9);
//   - the listed K/V tiles through a three-stage TMA ring (keys past Tk read
//     as zeros); S = Q.K^T on wgmma m64n64k16;
//   - the f32 bias of the thread's accumulator elements read straight from
//     device memory with 4-byte loads (a bias row is Tk floats, 5996 bytes at
//     Tk 1499: rows are not 8-byte aligned, so no float2 and no TMA), issued
//     for the next listed tile while this one is computed (the loads are
//     independent of the ring), and only where the key is valid;
//   - an online f32 softmax in registers (row max and sum; the four lanes of
//     a row reduced with shuffles): valid key s + bias, invalid key -1e9, a
//     key past Tk -inf (no part in the sum);
//   - O = O exp(m_old - m) + bf16(p).V, p going from the S accumulators
//     straight into wgmma's register A operand, V read MN-major;
//   - one division by l at the end and a bf16 store of the rows below Tq.
// No atomics and no scratch: two calls give the same bits.  Three blocks
// share an SM (145 registers, 61 KB of shared memory at Tk 1499).  Two
// alternatives measured slower on an H100 (PERF.md §6): the largest
// shared-memory carveout (a smaller L1, which serves the bias loads' second
// half-sector) and coalesced bias loads through a per-warp shared-memory
// transpose (two blocks an SM).
//
// Rounding points: s, the bias, m and l in f32; p = __expf(s - m_running)
// summed into l in f32, and rounded to bf16 at the running max for P.V; O
// rescaled in f32.  The twin rounds exp(s - m_final) / l once: the two differ
// by about one bf16 rounding of each probability, within 3e-2 x max|ref|
// (tests/test_torch_flash_bias_tiled.py holds a model of these points
// against the twin).
//
// Limits: D a multiple of 16 up to 64 (one 128-byte swizzled row a key);
// Tk <= 16384 (its mask and tile list in shared memory); q, k, v, out
// 16-byte aligned.  flash_bias_path sends other shapes to the split kernel;
// the launch refuses a misaligned pointer and the wrapper then raises.

#include "banded_attention_wgmma.cuh"

namespace {

using TiledSmem = Smem<1, 3>;  // the Q tile; three stages of (K, V)
constexpr int MAX_TK = 16384;

// dynamic shared memory: the ring and its barriers, then the key mask [nkt *
// 64] and the tile list [nkt]
__host__ __device__ inline int tiled_smem_bytes(int Tk) {
  const int nkt = cdiv(Tk, TILE);
  return TiledSmem::BYTES + nkt * TILE + 2 * nkt;
}

// The thread's bias elements of key tile j0, zero where the key is not
// valid (or past Tk) or the query row is past Tq.  ``vbits``: bit e of the
// thread's element e is a valid key.
__device__ __forceinline__ void load_bias(float (&b)[32], const float* __restrict__ brow0,
                                          const float* __restrict__ brow1, int j0,
                                          uint32_t vbits) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float* row = ((e >> 1) & 1) ? brow1 : brow0;
    b[e] = (vbits >> e & 1u) && row != nullptr ? __ldg(row + j0 + acc_col(e)) : 0.f;
  }
}

// bit e: the thread's element e of key tile j0 is a valid key
__device__ __forceinline__ uint32_t valid_bits(const uint8_t* s_valid, int j0) {
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // columns 8c + 2 (lane % 4) + {0, 1}, both query rows: elements 4c .. 4c + 3
    const uint16_t pair =
        *reinterpret_cast<const uint16_t*>(s_valid + j0 + 8 * c + 2 * (threadIdx.x & 3));
    const uint32_t lo = pair & 0xFFu ? 1u : 0u, hi = pair >> 8 ? 1u : 0u;
    bits |= (lo | hi << 1 | lo << 2 | hi << 3) << (4 * c);
  }
  return bits;
}

__global__ void __launch_bounds__(THREADS)
tiled_kernel(const __grid_constant__ CUtensorMap q_rows, const __grid_constant__ CUtensorMap k_rows,
             const __grid_constant__ CUtensorMap v_rows, const float* __restrict__ bias,
             const uint8_t* __restrict__ mask, bf16* __restrict__ out, int Tq, int Tk, int D,
             int mask_div) {
  const int nqt = cdiv(Tq, TILE), nkt = cdiv(Tk, TILE);
  const int n = blockIdx.x / nqt, i0 = (blockIdx.x % nqt) * TILE;

  extern __shared__ uint8_t smem_raw[];
  const TiledSmem sm(smem_raw);
  // [nkt * 64]: 1 = a valid key; right after the ring's barriers (32-byte
  // aligned, inside TiledSmem::BYTES of the start whatever its alignment)
  uint8_t* s_valid = smem_raw + (sm.bar_fixed() + 8 - smem_u32(smem_raw));
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_valid + nkt * TILE);
  __shared__ int s_count;
  if (threadIdx.x == 0) {
    mbar_expect_tx(sm.bar_fixed(), BOX);
    tma_load_3d(sm.fixed, &q_rows, sm.bar_fixed(), 0, i0, n);
  }

  // the row's key mask, while Q loads
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)(n / mask_div) * Tk;
  bool mine = false;
  for (int j = threadIdx.x; j < nkt * TILE; j += THREADS) {
    const bool v = j < Tk && (mrow == nullptr || mrow[j] != 0);
    s_valid[j] = v;
    mine |= v;
  }
  const bool row_any = __syncthreads_or(mine);
  // the tiles to visit, in order: warp 0, a tile a lane, 32 tiles a round
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int t0 = 0; t0 < nkt; t0 += 32) {
      const int t = t0 + lane;
      bool visit = t < nkt;
      if (visit && row_any) {
        const uint4* p = reinterpret_cast<const uint4*>(s_valid + t * TILE);
        uint4 x = p[0];
#pragma unroll
        for (int u = 1; u < TILE / 16; ++u) {
          const uint4 y = p[u];
          x.x |= y.x; x.y |= y.y; x.z |= y.z; x.w |= y.w;
        }
        visit = (x.x | x.y | x.z | x.w) != 0;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, visit);
      if (visit) s_list[count + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)t;
      count += __popc(ballot);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  const int n_iter = s_count;

  auto issue = [&](int it, uint32_t dst, uint32_t bar) {
    const int t = s_list[it];
    tma_load_3d(dst, &k_rows, bar, 0, t * TILE, n);
    tma_load_3d(dst + BOX, &v_rows, bar, 0, t * TILE, n);
  };
  ring_start(sm, n_iter, issue);

  const int row0 = i0 + acc_row(0);  // the thread's two query rows: row0, row0 + 8
  const float* brow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    brow[h] = bias != nullptr && row0 + 8 * h < Tq
                  ? bias + ((size_t)n * Tq + row0 + 8 * h) * Tk
                  : nullptr;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float o[32];
  zero(o);
  // the first listed tile's bias, in flight while Q and the ring load
  uint32_t vbits = valid_bits(s_valid, s_list[0] * TILE);
  float bn[32];
  load_bias(bn, brow[0], brow[1], s_list[0] * TILE, vbits);
  mbar_wait(sm.bar_fixed(), 0);

  ring_run(sm, n_iter, issue, [&](int it, uint32_t st) {
    const int j0 = s_list[it] * TILE;
    float b[32];
    const uint32_t bits = vbits;
#pragma unroll
    for (int e = 0; e < 32; ++e) b[e] = bn[e];
    if (it + 1 < n_iter) {  // the next tile's bias, in flight under this one
      const int jn = s_list[it + 1] * TILE;
      vbits = valid_bits(s_valid, jn);
      load_bias(bn, brow[0], brow[1], jn, vbits);
    }
    float s[32];
    zero(s);
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(s, kmajor(sm.fixed, kk), kmajor(st, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(o);

    float mt[2] = {-INFINITY, -INFINITY};  // the tile's row max
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = j0 + acc_col(e);
      const float x = j >= Tk ? -INFINITY : (bits >> e & 1u) ? s[e] + b[e] : NEG_INF;
      s[e] = x;
      mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      // every listed tile holds a key below Tk, so the new max is finite
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
        p[u] = __expf(s[e + u] - m[h]);  // 0 past Tk (s = -inf)
        l[h] += p[u];
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
    inv[h] = 1.f / l[h];  // >= 1: the row's max key adds exp(0)
  }
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int h = (e >> 1) & 1, row = row0 + 8 * h, d = acc_col(e);
    if (row < Tq && d < D)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)n * Tq + row) * D + d) =
          __floats2bfloat162_rn(o[e] * inv[h], o[e + 1] * inv[h]);
  }
}

}  // namespace

// out bf16 [N, Tq, D] from q [N, Tq, D], k, v [N, Tk, D] (bf16, contiguous),
// bias f32 [N, Tq, Tk] or NULL, key_valid uint8 [N / mask_div, Tk] or NULL.
// One launch on ``stream``.  Returns a cudaError_t (0 on success) or 100000 +
// a CUresult when a tensor map cannot be encoded.
extern "C" int flash_tiled_launch(const void* q, const void* k, const void* v, const float* bias,
                                  const void* key_valid, void* out, int N, int Tq, int Tk, int D,
                                  int mask_div, void* stream) {
  if (N <= 0 || Tq <= 0 || Tk <= 0 || Tk > MAX_TK || D < 16 || D > MAX_DH || D % 16 != 0
      || mask_div <= 0 || N % mask_div != 0 || (long long)N * cdiv(Tq, TILE) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out))
    return (int)cudaErrorMisalignedAddress;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidResourceHandle;
  CUtensorMap qm, km, vm;
  int err;
  if ((err = rows_map(fn, &qm, q, N, Tq, D)) || (err = rows_map(fn, &km, k, N, Tk, D)) ||
      (err = rows_map(fn, &vm, v, N, Tk, D)))
    return err;
  if ((err = prepare(tiled_kernel, tiled_smem_bytes(MAX_TK)))) return err;
  tiled_kernel<<<N * cdiv(Tq, TILE), THREADS, tiled_smem_bytes(Tk),
                 static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, bias, static_cast<const uint8_t*>(key_valid), (bf16*)out, Tq, Tk, D, mask_div);
  return (int)cudaGetLastError();
}
