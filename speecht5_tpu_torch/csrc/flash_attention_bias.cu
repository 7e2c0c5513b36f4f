// Attention with an additive bias and a key mask, for the decode steps of
// the beam search: the keys split over a thread-block cluster, the partial
// results combined through distributed shared memory in the same launch.
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
//   maxp[n,i] = max_j softmax_j(s[n,i,:])                   (optional, f32)
//
// Rows n = b * H + h of B samples by H heads.  q [B, Tq, H, D], out [B, Tq,
// H, D] and k, v [Bk, Tk, H, D] are read and written through element strides
// (batch, token, head; d contiguous), so the decoder's KV cache [B, Tmax, H,
// Dh] and the head-major cross K/V are read where they lie.  An optional
// row map rows [B, Tk] (int64) names the physical batch row of each
// key: key j of row b is k[rows[b, j], j], the beam's ancestry map, read
// with no gather.  bias: f32 [N, Tq, Tk] or null (a zero bias); key_valid:
// uint8 [N / R, Tk] or null (every key valid), row n reading mask row n / R.
// q, k, v and out share one dtype (f32 or bf16); every product and sum is
// f32.  A row whose keys are all invalid sees -1e9 on every key and so
// returns the mean of V over its Tk keys, as the dense formula does.
// maxp, when asked for (the TTS decoder's focus rate reads it), is the
// largest probability of each row and query: 1 / sum_j exp(s_j - max s),
// which the combine holds anyway (the L below), so it costs one f32 store a
// query and no other work; with maxp null the kernel is the same as without.
//
// What bounds it on an H100: the function does about 4 * Tq flops per valid
// key and element against 4 bytes of K and V (bf16): Tq = 5 at the grouped
// cross-attention, 1 at the cached self-attention, some 300x under the
// bf16 ridge.  So it is bound by the bytes of the valid keys' K and V (one
// or two MB at the beam's shapes, under a microsecond at 3.35 TB/s), and in
// practice by the latency of one launch: the design moves each valid key's
// K and V once, over many SMs, and needs no tensor cores.
//
// Design.  A cluster of CS = min(8, tiles) blocks of 256 threads shares one
// (row n, query tile): BQ = 1 query when Tq is 1 (the self step), else 8
// (the cross step's 5 grouped queries in one block, so the keys are read
// once for the group); key tiles of BK = 64 keys, or 128 past 512 keys so
// that 8 blocks cover up to 1024 keys a tile each.  The grid is (CS,
// ceil(Tq / BQ), N): the beam's cross step runs 12 x 7 blocks, its self
// step 60 x 4.  Block r of the cluster walks tiles r, r + CS, ... (Tk has
// no limit: a block walks more tiles), each staged in its own type with
// 16-byte cp.async copies into a double-buffered K/V ring, the next tile's
// copies in flight while this one is computed; the first tile's copies go
// out before q is loaded.  Scores: eight lanes a key, each a 16-byte vector
// of k against its slice of the queries (kept in registers), summed over
// the eight lanes by a reduce-scatter of shuffles (7 for 8 queries) in one
// unconditional chain.  Softmax: one warp a query row, the online form of
// the TPU kernel (:563-588): m' = max(m, max_j s), alpha = exp(m - m'), p =
// exp(s - m'), l' = l * alpha + sum_j p, acc' = acc * alpha +
// cast_to_v_type(p) . V.  P.V: each thread owns a 16-byte column of V and
// one key phase of the tile, for all the tile's queries, so V is read from
// shared memory once; the key phases are summed in a fixed order (shuffles,
// then the eight warps).  Then each block holds a partial (m, l, acc) for
// each query; after cluster.sync() every block reads all ranks' (m, l)
// through distributed shared memory, weighs rank r by w_r = exp(m_r - M) in
// f32, and writes its share of the outputs, out = sum_r w_r acc_r / sum_r
// w_r l_r, summing the ranks' acc in rank order.  A second cluster.sync()
// keeps every block's shared memory alive until all reads are done.  No
// float atomics, no scratch in device memory, no second launch: two calls
// give the same bits.  The loops around the shuffles run the same count in
// every lane, so the compiler issues each chain of shuffles back to back (a
// shuffle under a lane-varying loop or a per-query condition gets a
// divergence check of its own, and the shuffles then run one at a time).
//
// Only valid keys are read.  If the row has a valid key, a key that is not
// valid is neither copied (its slots are zero-filled) nor able to add
// anything (exp(-1e9 - m) = 0 in f32 once m is a valid key's score), and a
// tile with no valid key is skipped; a split whose keys are all invalid
// leaves (m, l, acc) = (-inf, 0, 0) and weight 0 in the combine, so it
// changes no bit of the result.  A block whose first tile has no valid key
// scans the row's mask; if the row has none, every key is read at -1e9 and
// the result is the mean of V.
//
// Numerics against the twin (gather, then the dense formula): each block
// rounds exp(s - m_block) to V's type, m_block its running max over its own
// tiles, and the combine rescales in f32; the twin rounds exp(s - m_final)
// once, the TPU kernel exp(s - m_running).  bf16 agrees within 3e-2 x
// max|ref|, f32 within 1e-4.
//
// Head sizes.  A key row is VPR = D * sizeof(T) / 16 vectors.  The lane
// layout of the score and P.V passes wants a power of two (the lanes of a key,
// the lanes that share a column of V), so it is laid out for VPRP, VPR rounded
// up to a power of two, and the lanes of the vectors past VPR load nothing and
// add nothing: D 80 in bf16 (the fusion LM's head size, 10 vectors) runs on
// the layout of D 128 with 10 of its 16 columns live.  The loops and shuffle
// chains stay the same in every lane; only the loads and the products test
// the column.  The K/V ring, q and the partial sums keep D elements a row, so
// no padding is read or written.
//
// Limits: D a multiple of 16, or a power of two, with 16 <= D * sizeof(T) and
// D <= 128 (f32 past D 64 keeps 64-key tiles: 128 would overflow shared
// memory); k, v 16-byte aligned with strides of whole 16-byte vectors; N <=
// 65535.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_BQ = 8;   // queries a block (1 when Tq is 1)
constexpr int THREADS = 256;
// keys a tile: 64, or 128 past this many keys, so that a cluster of 8
// walks one tile a block up to 1024 keys
constexpr int WIDE_TILES_ABOVE = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 128;
constexpr int MAX_CLUSTER = 8;
constexpr float NEG_INF = -1e9f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const uint8_t* mask;
  const long long* rows;
  void* out;
  float* maxp;                           // [N, Tq] or null
  long long qs[3], ks[3], vs[3], os[3];  // batch, token, head strides (elements)
  int H, Tq, Tk, mask_div, ntiles;
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;  // elements in 16 bytes
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 g = __bfloat1622float2(h[e]);
      f[2 * e] = g.x;
      f[2 * e + 1] = g.y;
    }
  }
};

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

// Sums v[0..N) over the lanes of an aligned group of 2 * O lanes, scattering
// as it goes: each round halves the values a lane keeps (the lane with bit O
// set keeps the upper half) and adds its partner's copy of them, so after the
// rounds a lane holds max(1, N / (2 * O)) sums, those of queries ``base`` +
// k.  N - 1 shuffles instead of N log2(2 * O) for a group of 8.
template <int O, int CNT, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane, int& base) {
  if constexpr (O > 0) {
    if constexpr (CNT == 1) {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<O / 2, 1, N>(v, lane, base);
    } else {
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < CNT / 2; ++k) {
        const float send = upper ? v[k] : v[k + CNT / 2];
        const float keep = upper ? v[k + CNT / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (upper) base += CNT / 2;
      reduce_scatter<O / 2, CNT / 2, N>(v, lane, base);
    }
  }
}

// 16 bytes global -> shared, zero-filled when ``bytes`` is 0 (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int VPR, int BK, int BQ>
constexpr size_t smem_bytes() {
  // K/V ring (2 stages x K and V), q, scores, the per-warp P.V partials
  return 4 * (size_t)BK * VPR * 16 + sizeof(float) * ((size_t)BQ * VPR * Vec<T>::N
         + (size_t)BQ * BK + (size_t)WARPS * BQ * VPR * Vec<T>::N);
}

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// VPR: 16-byte vectors per key row (D = VPR * Vec<T>::N); BK: keys a tile;
// BQ: queries a block
template <typename T, int VPR, int BK, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_split_kernel(const Params p) {
  constexpr int EPV = Vec<T>::N;
  constexpr int D = VPR * EPV;
  constexpr int VPRP = pow2_ceil(VPR);          // the lane layout's columns
  constexpr bool FULL = VPRP == VPR;            // every column live
  constexpr int LPK = VPRP < 8 ? VPRP : 8;      // lanes a key in the score pass
  constexpr int VPL = VPRP / LPK;               // vectors a lane
  constexpr int KPW = 32 / LPK;                 // keys a warp per pass
  constexpr int NPH = THREADS / VPRP;           // key phases of the P.V pass

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_kv = reinterpret_cast<T*>(smem_raw);     // [2][2][BK][D]: stage, K/V
  float* s_q = reinterpret_cast<float*>(smem_raw + 4 * (size_t)BK * VPR * 16);  // [BQ][D]
  float* s_p = s_q + BQ * D;                    // [BQ][BK]
  float* s_red = s_p + BQ * BK;                 // [WARPS][BQ][D]; [0] ends as the block's acc
  __shared__ float s_m[BQ], s_l[BQ], s_alpha[BQ];
  __shared__ float s_rm[MAX_CLUSTER][BQ], s_rl[MAX_CLUSTER][BQ];  // every rank's m, l
  __shared__ float s_w[BQ][MAX_CLUSTER], s_L[BQ];
  __shared__ uint8_t s_valid[2][BK];            // the staged tiles' key mask

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q0 = blockIdx.y * BQ;
  const int n = blockIdx.z;
  const int b = n / p.H, h = n - b * p.H;
  const int nq = min(BQ, p.Tq - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Tk = p.Tk;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* kg = static_cast<const T*>(p.k) + h * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + h * p.vs[2];
  const uint8_t* mrow = p.mask == nullptr ? nullptr : p.mask + (size_t)(n / p.mask_div) * Tk;

  // does the row have a valid key?  Then only valid keys are read.  Assumed
  // until the block's first tile is seen to have none.
  bool row_any = true;

  // issue the copies of tile t into stage s; returns whether a key of this
  // thread's chunks is valid
  auto issue = [&](int t, int s) {
    T* sk = s_kv + (size_t)(2 * s) * BK * D;
    T* sv = sk + BK * D;
    bool any = false;
    constexpr int CHUNKS = BK * VPR;            // 16-byte chunks a tile
#pragma unroll
    for (int u = 0; u < (CHUNKS + THREADS - 1) / THREADS; ++u) {
      const int c = tid + u * THREADS;
      if (c >= CHUNKS) continue;
      const int jj = c / VPR, col = c % VPR;
      const int j = t * BK + jj;
      const bool valid = j < Tk && (mrow == nullptr || mrow[j] != 0);
      any |= valid;
      if (col == 0) s_valid[s][jj] = valid;
      const bool read = j < Tk && (valid || !row_any);
      long long pb = b;
      if (read && p.rows != nullptr)
        pb = p.rows[(long long)b * Tk + j];
      const T* ksrc = read ? kg + pb * p.ks[0] + (long long)j * p.ks[1] + col * EPV : kg;
      const T* vsrc = read ? vg + pb * p.vs[0] + (long long)j * p.vs[1] + col * EPV : vg;
      cp_async16(sk + jj * D + col * EPV, ksrc, read ? 16 : 0);
      cp_async16(sv + jj * D + col * EPV, vsrc, read ? 16 : 0);
    }
    return any;
  };

  float acc[BQ][EPV];
#pragma unroll
  for (int i = 0; i < BQ; ++i)
#pragma unroll
    for (int e = 0; e < EPV; ++e) acc[i][e] = 0.f;

  // the P.V pass's column and key phase; columns >= VPR are idle lanes
  const int col = tid % VPRP, ph = tid / VPRP;
  const int nt = p.ntiles;
  int stage = 0;
  bool cur_valid = issue(rank, 0);             // rank < CS <= nt
  cp_async_commit();
  // q while the first tile is in flight
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int i = idx / D, d = idx % D;
    s_q[idx] = i < nq ? to_f32(qg[(long long)(q0 + i) * p.qs[1] + d]) : 0.f;
  }
  if (tid < BQ) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  if (!__syncthreads_or(cur_valid)) {           // also publishes s_q, s_m, s_l
    // the first tile has no valid key: scan the row
    bool mine = false;
    for (int j = tid; j < Tk && !mine; j += THREADS) mine = mrow[j] != 0;
    row_any = __syncthreads_or(mine);
    if (!row_any) {   // no valid key in the row: every key is read, at -1e9
      cp_async_wait<0>();
      issue(rank, 0);
      cp_async_commit();
    }
  }
  // this lane's slice of every query, for the score pass
  float qr[BQ][VPL * EPV];
#pragma unroll
  for (int i = 0; i < BQ; ++i)
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int vc = (lane % LPK) + u * LPK;
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        qr[i][u * EPV + e] = FULL || vc < VPR ? s_q[i * D + vc * EPV + e] : 0.f;
    }
  for (int t = rank; t < nt; t += CS) {
    const bool next_valid = t + CS < nt ? issue(t + CS, stage ^ 1) : false;
    cp_async_commit();
    cp_async_wait<1>();
    const bool tile_any = __syncthreads_or(cur_valid);  // the tile is in shared memory
    cur_valid = next_valid;
    const int cur = stage;
    const T* sk = s_kv + (size_t)(2 * cur) * BK * D;
    const T* sv = sk + BK * D;
    stage ^= 1;
    if (!tile_any && row_any) continue;         // no valid key: adds nothing

    // ---- scores: LPK lanes a key, 16-byte vectors of k against every query.
    // The passes are counted the same in every lane, so the compiler sees a
    // converged warp at the shuffles and issues them back to back.
    constexpr int KEYS_A_PASS = WARPS * KPW;
#pragma unroll
    for (int pass = 0; pass < (BK + KEYS_A_PASS - 1) / KEYS_A_PASS; ++pass) {
      const int jl = pass * KEYS_A_PASS + warp * KPW + lane / LPK;
      const bool live = jl < BK;                // false only where a pass outruns the tile
      const int jj = live ? jl : 0;
      float dot[BQ];
#pragma unroll
      for (int i = 0; i < BQ; ++i) dot[i] = 0.f;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vc = (lane % LPK) + u * LPK;
        if (FULL || vc < VPR) {        // no shuffle inside: the chain below stays whole
          float kf[EPV];
          Vec<T>::load(sk + jj * D + vc * EPV, kf);
#pragma unroll
          for (int i = 0; i < BQ; ++i)   // rows past nq hold q = 0
#pragma unroll
            for (int e = 0; e < EPV; ++e) dot[i] += qr[i][u * EPV + e] * kf[e];
        }
      }
      // the key's LPK lanes: one unconditional chain of shuffles that leaves
      // each lane the whole sums of its own queries
      int base = 0;
      reduce_scatter<LPK / 2, BQ, BQ>(dot, lane, base);
      constexpr int HELD = BQ >= LPK ? BQ / LPK : 1;
      const int j = t * BK + jj;
      const bool in_range = j < Tk;
      const bool valid = s_valid[cur][jj];
#pragma unroll
      for (int k = 0; k < HELD; ++k) {
        const int i = base + k;
        if (live && i < nq && (BQ >= LPK || lane % LPK == 0)) {
          float s = -INFINITY;   // keys past Tk take no part
          if (valid) {
            s = dot[k];
            if (p.bias != nullptr)
              s += p.bias[((size_t)n * p.Tq + q0 + i) * Tk + j];
          } else if (in_range) {
            s = NEG_INF;
          }
          s_p[i * BK + jj] = s;
        }
      }
    }
    __syncthreads();

    // ---- online softmax, one warp a query row
    for (int i = warp; i < nq; i += WARPS) {
      constexpr int KPL = BK / 32;              // keys a lane
      float* prow = s_p + i * BK;
      float sc[KPL];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        sc[u] = prow[lane + 32 * u];
        mx = fmaxf(mx, sc[u]);
      }
      const float m_old = s_m[i];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const float pu = t * BK + lane + 32 * u < Tk ? expf(sc[u] - m_new) : 0.f;
        part += pu;
        // the probabilities enter P.V rounded to V's type, as in the TPU kernel
        prow[lane + 32 * u] = to_f32(from_f32<T>(pu));
      }
      const float sum = warp_sum(part);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the block's first tile
        s_alpha[i] = alpha;
        s_l[i] = s_l[i] * alpha + sum;
        s_m[i] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P . V: column ``col``, keys ph, ph + NPH, ...
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      if (i < nq) {
        const float a = s_alpha[i];
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[i][e] *= a;
      }
    }
#pragma unroll
    for (int u = 0; u < (BK + NPH - 1) / NPH; ++u) {
      const int jj = ph + u * NPH;
      if (jj < BK && (FULL || col < VPR)) {
        float vf[EPV];
        Vec<T>::load(sv + jj * D + col * EPV, vf);
#pragma unroll
        for (int i = 0; i < BQ; ++i) {
          if (i < nq) {
            const float pij = s_p[i * BK + jj];
#pragma unroll
            for (int e = 0; e < EPV; ++e) acc[i][e] += pij * vf[e];
          }
        }
      }
    }
    __syncthreads();  // the stage and s_p are free for the next tile
  }
  cp_async_wait<0>();

  // ---- the block's acc: the key phases of a warp by shuffles, then the
  // warps in order (a fixed order: two calls give the same bits)
#pragma unroll
  for (int o = VPRP; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < BQ; ++i)
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
  if (lane < VPR) {
#pragma unroll
    for (int i = 0; i < BQ; ++i)
#pragma unroll
      for (int e = 0; e < EPV; ++e) s_red[(warp * BQ + i) * D + col * EPV + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = tid; idx < nq * D; idx += THREADS) {
    float a = s_red[idx];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) a += s_red[w * BQ * D + idx];
    s_red[idx] = a;
  }

  // ---- combine the cluster's partials: every block reads all ranks' (m, l)
  // at once, then writes its share of the outputs, each summing the ranks'
  // acc in rank order (the same bits whichever block writes it)
  cluster.sync();
  if (tid < CS * BQ) {
    const int r = tid / BQ, i = tid % BQ;
    if (i < nq) {
      s_rm[r][i] = *cluster.map_shared_rank(&s_m[i], r);
      s_rl[r][i] = *cluster.map_shared_rank(&s_l[i], r);
    }
  }
  __syncthreads();
  if (tid < nq) {
    float M = -INFINITY;
    for (int r = 0; r < CS; ++r) M = fmaxf(M, s_rm[r][tid]);
    float L = 0.f;
    for (int r = 0; r < CS; ++r) {
      const float m_r = s_rm[r][tid];
      const float w = m_r == -INFINITY ? 0.f : expf(m_r - M);
      s_w[tid][r] = w;
      L += w * s_rl[r][tid];
    }
    s_L[tid] = fmaxf(L, 1e-30f);
    if (p.maxp != nullptr && rank == 0)   // the largest probability, exp(M - M) / L
      p.maxp[(size_t)n * p.Tq + q0 + tid] = 1.f / s_L[tid];
  }
  __syncthreads();
  T* og = static_cast<T*>(p.out) + b * p.os[0] + h * p.os[2];
  for (int idx = rank * THREADS + tid; idx < nq * D; idx += CS * THREADS) {
    const int i = idx / D, d = idx % D;
    float part[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      part[r] = r < CS ? *cluster.map_shared_rank(&s_red[idx], r) : 0.f;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < CS) o += s_w[i][r] * part[r];
    og[(long long)(q0 + i) * p.os[1] + d] = from_f32<T>(o / s_L[i]);
  }
  cluster.sync();  // no block leaves while another may read its shared memory
}

template <typename T, int VPR, int BK, int BQ>
int launch(const Params& prm, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, VPR, BK, BQ>();
  static unsigned configured = 0;  // a bit a device: the attribute is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && dev < 32 && !(configured >> dev & 1u)) {
    // past the default limit of dynamic shared memory
    e = cudaFuncSetAttribute(flash_split_kernel<T, VPR, BK, BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured |= 1u << dev;
  }
  Params run = prm;
  run.ntiles = (prm.Tk + BK - 1) / BK;
  const int cs = run.ntiles < MAX_CLUSTER ? run.ntiles : MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (run.Tq + BQ - 1) / BQ, N);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_split_kernel<T, VPR, BK, BQ>, run);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// vpr: vectors a key row, D / Vec<T>::N; the cases are the head sizes the
// host check lets through (D a power of two, or a multiple of 16, <= 128)
template <typename T, int BK, int BQ>
int dispatch(const Params& prm, int N, int vpr, cudaStream_t s) {
  constexpr bool F32 = sizeof(T) == 4;
  switch (vpr) {
    case 1: return launch<T, 1, BK, BQ>(prm, N, s);
    case 2: return launch<T, 2, BK, BQ>(prm, N, s);
    case 4: return launch<T, 4, BK, BQ>(prm, N, s);
    case 8: return launch<T, 8, BK, BQ>(prm, N, s);
    case 12: return launch<T, 12, BK, BQ>(prm, N, s);   // bf16 D 96, f32 D 48
    case 16: return launch<T, 16, BK, BQ>(prm, N, s);
    default: break;
  }
  if constexpr (!F32) {   // bf16 D 48, 80, 112
    switch (vpr) {
      case 6: return launch<T, 6, BK, BQ>(prm, N, s);
      case 10: return launch<T, 10, BK, BQ>(prm, N, s);
      case 14: return launch<T, 14, BK, BQ>(prm, N, s);
      default: break;
    }
  } else {   // f32 D 80-128; 128-key tiles would overflow shared memory
    switch (vpr) {
      case 20: return launch<T, 20, 64, BQ>(prm, N, s);
      case 24: return launch<T, 24, 64, BQ>(prm, N, s);
      case 28: return launch<T, 28, 64, BQ>(prm, N, s);
      case 32: return launch<T, 32, 64, BQ>(prm, N, s);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int BQ>
int dispatch_tiles(const Params& prm, int N, int vpr, cudaStream_t s) {
  if (prm.Tk > WIDE_TILES_ABOVE) return dispatch<T, 128, BQ>(prm, N, vpr, s);
  return dispatch<T, 64, BQ>(prm, N, vpr, s);
}

template <typename T>
int dispatch_queries(const Params& prm, int N, int vpr, cudaStream_t s) {
  if (prm.Tq == 1) return dispatch_tiles<T, 1>(prm, N, vpr, s);
  return dispatch_tiles<T, MAX_BQ>(prm, N, vpr, s);
}

}  // namespace

// q, k, v, out: pointers with element strides ``strides`` (host array of 12:
// q, k, v, out, each batch, token, head); maxp: f32 [B * H, Tq] or NULL (the
// largest probability of each row and query); rows: int64 [B, Tk] or NULL;
// bias: f32 [B * H, Tq, Tk] or NULL; key_valid: uint8 [B * H / mask_div,
// Tk] or NULL.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 on success); a refused cluster launch is returned, not
// worked around.
extern "C" int flash_bias_launch(const void* q, const void* k, const void* v,
                                 const void* bias, const void* key_valid,
                                 const void* rows, void* out, void* maxp,
                                 const long long* strides, int B, int H, int Tq,
                                 int Tk, int D, int mask_div, int dtype,
                                 void* stream) {
  const int epv = dtype == 0 ? 4 : 8;
  const long long N = (long long)B * H;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D < epv || D > MAX_D || D % epv != 0
      || ((D & (D - 1)) != 0 && D % 16 != 0)
      || N > 65535 || (Tq + MAX_BQ - 1) / MAX_BQ > 65535 || mask_div <= 0 || N % mask_div != 0
      || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.q = q; prm.k = k; prm.v = v;
  prm.bias = static_cast<const float*>(bias);
  prm.mask = static_cast<const uint8_t*>(key_valid);
  prm.rows = static_cast<const long long*>(rows);
  prm.out = out;
  prm.maxp = static_cast<float*>(maxp);
  for (int a = 0; a < 3; ++a) {
    prm.qs[a] = strides[a];
    prm.ks[a] = strides[3 + a];
    prm.vs[a] = strides[6 + a];
    prm.os[a] = strides[9 + a];
  }
  prm.H = H; prm.Tq = Tq; prm.Tk = Tk;
  prm.mask_div = mask_div;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpr = D / epv;
  if (dtype == 0) return dispatch_queries<float>(prm, (int)N, vpr, s);
  return dispatch_queries<__nv_bfloat16>(prm, (int)N, vpr, s);
}
