"""Multi-head attention with the SpeechT5 relative-position bias.

Port of ``speecht5_tpu/models/attention.py`` (reference
modules/multihead_attention.py:24-522): q is scaled by head_dim**-0.5
before use; the relative-position bias is the first-order term
B[b,h,i,j] = q_scaled[b,h,i,:] . pe_k[clip(i-j)] (reference :343-353);
masks use -1e9, not -inf, so a fully masked row gives a uniform softmax.
A pre-LN layer hands in its own normed table instead of a band: the plain
path adds ``relative_bias`` (one einsum against the table, then the
gather-free skew, JAX attention.py:33-101), the kernels read the band built
from that table.  Self-attention (encoder, causal decoder) and
cross-attention against the encoder output are ported with probability
dropout on the training path, and the attention weights (the f32 softmax
before dropout, JAX attention.py:305-316) on request.  Decode steps (JAX attention.py:159-221):
the self-attention KV cache is written at ``cache_index`` (in place: the
beam loop never needs the old buffer), read through the ancestry map
``cache_rows`` and masked causally at the step; cross-attention reads K/V
from ``precompute_kv``, untiled when the queries are a beam's tiles
(grouped: each sample's K/V read once for its G beams).  The decode-step
kernel reads the cache and the cross K/V where they lie, the ancestry map
included; the plain path gathers the cache with one flattened gather of
(row, position) pairs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_kernels
from ..parallel.distributed import dropout_row_offset
from .common import Dense

NEG_INF = -1e9
# the fused kernels keep a whole score row on chip; longer sequences take
# the plain path, the JAX module's own routing rule (attention.py:236)
MAX_FUSED_KEYS = 1024
# the band's rows are stored padded to a multiple of 8 elements (16 bytes in
# bf16), the row stride the wgmma kernels' TMA maps need
BAND_ROW_MULTIPLE = 8


def rel_position_index(q_pos, k_pos, max_dist: int):
    """clip(i - j, -max_dist, max_dist - 1) + max_dist -> index into the pe table."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    return torch.clamp(rel, -max_dist, max_dist - 1) + max_dist


def band_from_table(pos_table, T: int, max_dist: int, dtype=None,
                    row_multiple: int = 1):
    """pe_band[d, i, j] = pos_table[clip(i-j, -M, M-1) + M, d] -> [Dh, T, T],
    cast to ``dtype`` (default: the table's).

    Built once per encoder forward and shared by every layer and head of the
    post-LN stack (the reference applies norm_k to the table only on the
    pre-LN path, transformer_layer.py:90-93); on the kernel route a pre-LN
    layer builds one from its own normed table.  The JAX package realises
    the same band with a gather-free skew (``_skew_band``); here it is one
    gather.  With ``row_multiple`` > 1 the band's rows are stored padded to
    Tp, a multiple of it, and the result is the ``[Dh, T, T]`` view of that
    ``[Dh, T, Tp]`` storage (strides ``(T * Tp, Tp, 1)``): the layout the
    wgmma kernels read through TMA (16-byte row strides at ``row_multiple``
    8), made here once instead of copied in every attention call.  The
    padding columns hold gathered values that no kernel reads; the gradient
    reaches the table through the view alone."""
    Tp = -(-T // row_multiple) * row_multiple
    dev = pos_table.device
    idx = rel_position_index(torch.arange(T, device=dev), torch.arange(Tp, device=dev),
                             max_dist)                     # [T, Tp]
    band = pos_table.t()[:, idx]                           # [Dh, T, Tp]
    if dtype is not None:
        band = band.to(dtype)
    return band[..., :T]


def relative_bias_banded(q, pos_band):
    """q: [B, Tq, H, Dh] (scaled); pos_band: [Dh, T, T] -> bias [B, H, Tq, Tk]."""
    return torch.einsum("bqhd,dqk->bhqk", q, pos_band.to(q.dtype))


def _skew_band(scores_r, T: int, max_dist: int):
    """B[..., i, j] = S[..., i, clip(i - j, -M, M - 1) + M] from S =
    ``scores_r`` [..., T, 2M], with a pad and reshapes only (JAX
    attention.py:33-66, the same steps): the reversed columns padded by T,
    flattened and re-cut with one element less a row, so that row i
    shifts left by i; the distances past the table's clip take its first
    or last column."""
    M = max_dist
    R = 2 * M
    W = R + T
    p = F.pad(scores_r.flip(-1), (0, T))
    flat = p.reshape(*p.shape[:-2], T * W)
    band = flat[..., : T * (W - 1)].reshape(*p.shape[:-2], T, W - 1)[..., M - 1 : M - 1 + T]
    dev = scores_r.device
    col = (torch.arange(T, device=dev)[None, :] - torch.arange(T, device=dev)[:, None]
           + (M - 1))
    out = torch.where(col <= 0, scores_r[..., -1:], band)
    return torch.where(col >= R - 1, scores_r[..., :1], out)


def relative_bias(q, pos_table):
    """q: [B, T, H, Dh] (scaled); pos_table: [2M, Dh] -> bias [B, H, T, T]
    of full self-attention (JAX attention.py:86-101): one einsum against
    the table, then the skew; at T == 1 the single entry at distance 0."""
    T = q.shape[1]
    M = pos_table.shape[0] // 2
    scores_r = torch.einsum("bqhd,rd->bhqr", q, pos_table.to(q.dtype))
    if T == 1:
        return scores_r[..., M : M + 1]
    return _skew_band(scores_r, T, M)


class MultiheadAttention(nn.Module):
    """Projections + attention.  ``use_pallas`` routes inference passes of
    full self-attention with a band to the CUDA inference kernel, and the
    softmax-times-V of decode steps (a cache or precomputed cross K/V, no
    weights asked for) to ``flash_attention_bias``; ``use_pallas_train``
    routes training passes to the differentiable train kernel, as
    ``config.use_pallas_attn`` / ``use_pallas_attn_train`` do in the JAX
    package (whose decode steps take XLA whatever the flag: its tokens are
    the oracle either way); everything else takes the plain path."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, *,
                 dtype=torch.float32, use_pallas: bool = False,
                 use_pallas_train: bool = False, scores_f32: bool = True):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.use_pallas_train = use_pallas_train
        self.scores_f32 = scores_f32
        self.q_proj = Dense(d_model, d_model, dtype)
        self.k_proj = Dense(d_model, d_model, dtype)
        self.v_proj = Dense(d_model, d_model, dtype)
        self.out_proj = Dense(d_model, d_model, dtype)

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    def fused(self, Tk: int) -> bool:
        """Whether full self-attention over ``Tk`` keys with a rel-pos bias
        takes a kernel in the current mode (JAX attention.py:225-236): the
        inference kernel when not training, the train kernel when training,
        each when its flag asks, up to ``MAX_FUSED_KEYS`` keys."""
        return (Tk <= MAX_FUSED_KEYS
                and (self.use_pallas_train if self.training else self.use_pallas))

    def train_seed(self, pos_band, Tk: int, generator=None):
        """The train kernel's dropout seed for a training self-attention
        pass over ``Tk`` keys with ``pos_band`` (a band or a per-layer
        table: anything but None), drawn now from
        ``generator`` (a CPU ``torch.Generator``, the default one when None:
        no device sync), or None when such a pass draws none (another route,
        or no dropout).  The caller draws it, once, outside any recomputed
        (checkpointed) call, and hands it to ``forward`` as ``dropout_seed``."""
        if (self.training and self.dropout > 0.0 and pos_band is not None
                and self.fused(Tk)):
            # an int32 draw, as jax.random.randint(.., 0, 2**31-1)
            return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
        return None

    def forward(self, x, key_valid=None, pos_band=None, *, pos_table=None, x_kv=None,
                causal: bool = False, dropout_seed=None,
                return_weights: bool = False, cache=None, cache_index=None,
                cache_rows=None, cross_kv=None, return_max_prob: bool = False):
        """x: [B, Tq, D]; key_valid: bool [B, Tk] (True = attend, a
        contiguous prefix); pos_band: [Dh, T, T] or None; pos_table: a
        layer's own [2M, Dh] table (the pre-LN layers'; the plain path adds
        ``relative_bias``, the kernels take the band built from it by
        ``band_from_table``); x_kv: [B, Tk, D]
        for cross-attention (None = self-attention); causal: mask keys after
        the query.  ``dropout_seed``: the train kernel's dropout seed from
        ``train_seed`` (required when that pass drops out).  -> [B, Tq, D],
        or with ``return_weights`` (out, f32 weights [B, H, Tq, Tk]), which
        the fused kernels do not give (JAX routes such calls to the plain
        path too).

        Decode steps: ``cache`` {"k", "v": [B, Tmax, H, Dh]} with
        ``cache_index`` (int or 0-d int64 tensor: the write position) and
        optionally ``cache_rows`` (int [B, Tmax] ancestry map: position j of
        logical row b lives in physical row cache_rows[b, j]) -> (out,
        cache), the buffers written in place; ``cross_kv`` {"k", "v": [B /
        G, Tk, H, Dh]} from ``precompute_kv`` -> out (or (out, weights)),
        ``key_valid`` then [B / G, Tk] or tiled [B, Tk]; with
        ``return_max_prob`` (out, the largest f32 attention probability of
        each row, head and query [B, H, Tq]), which the kernel gives from
        the same launch (the TTS decoder's focus rate)."""
        B, Tq, _ = x.shape
        Dh = self.head_dim
        q = self.q_proj(x)
        # the heads this rank holds: all of them, or its share under tensor
        # parallelism (q_proj split by columns)
        H = q.shape[-1] // Dh
        q = q.view(B, Tq, H, Dh) * (Dh ** -0.5)
        if cross_kv is not None:
            return self._cross_step(q, cross_kv, key_valid, return_weights,
                                    return_max_prob)
        src = x if x_kv is None else x_kv
        k = self.k_proj(src).view(B, -1, H, Dh)
        v = self.v_proj(src).view(B, -1, H, Dh)
        if cache is not None:
            if return_weights:
                raise NotImplementedError("weights of a cached self-attention step")
            return self._cached_step(q, k, v, cache, cache_index, cache_rows,
                                     key_valid, causal)
        Tk = k.shape[1]

        # the JAX routing (models/attention.py:225-236): full, non-causal
        # self-attention with a band, up to 1024 keys; the inference kernel
        # when not training, the train kernel when training and asked for
        fused = ((pos_band is not None or pos_table is not None) and x_kv is None
                 and not causal and not return_weights and self.fused(Tk))
        if fused and pos_band is None:
            # the layer's band, row-padded as the kernels read it; gathered
            # from the table as given, cast after (the gather's backward
            # sums in the table's dtype)
            pos_band = band_from_table(pos_table, Tk, pos_table.shape[0] // 2,
                                       dtype=self.dtype, row_multiple=BAND_ROW_MULTIPLE)
        if fused:
            # [B, T, H, Dh] -> [B*H, T, Dh] rows; contiguous() matters at
            # B == 1, where reshape returns a strided view
            N = B * H
            qf, kf, vf = (t.transpose(1, 2).reshape(N, Tq, Dh).contiguous()
                          for t in (q, k, v))
            # the band as the encoder built it (row-padded): no copy
            band = pos_band.to(qf.dtype)
            lengths = None
            if key_valid is not None:
                lengths = torch.repeat_interleave(
                    key_valid.sum(-1, dtype=torch.int32), H)
            if self.training:
                seed = dropout_seed
                if seed is None:
                    if self.dropout > 0.0:
                        raise ValueError("the train kernel's dropout needs "
                                         "dropout_seed (train_seed)")
                    seed = 0
                # the rows' flat (batch x head) place in the global batch
                seed = cuda_kernels.offset_seed(seed, dropout_row_offset(N))
                o = cuda_kernels.banded_attention_train(
                    qf, kf, vf, band, lengths, dropout_rate=self.dropout, seed=seed)
            else:
                o = cuda_kernels.banded_flash_attention(qf, kf, vf, band, lengths)
            o = o.view(B, H, Tq, Dh).transpose(1, 2).reshape(B, Tq, H * Dh)
            return self.out_proj(o)

        mask = None
        if key_valid is not None:
            mask = key_valid[:, None, None, :]
        if causal:
            cm = torch.ones(Tq, Tk, dtype=torch.bool, device=x.device).tril()
            mask = cm if mask is None else mask & cm
        return self._dense(q, k, v, pos_band, mask, return_weights, pos_table)

    def _dense(self, q, k, v, pos_band, mask, return_weights, pos_table=None):
        """The plain path: logits in the score dtype (+ the band's bias, or
        the per-layer table's by ``relative_bias``),
        -1e9 where ``mask`` (broadcast to [B, H, Tq, Tk]) is False, f32
        softmax, probabilities in the compute dtype, dropout, P.V."""
        B, Tq = q.shape[:2]
        score_dtype = torch.float32 if self.scores_f32 else self.dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(score_dtype)
        if pos_band is not None:
            logits = logits + relative_bias_banded(q, pos_band).to(score_dtype)
        elif pos_table is not None:
            logits = logits + relative_bias(q, pos_table).to(score_dtype)
        if mask is not None:
            logits = torch.where(mask, logits,
                                 torch.full((), NEG_INF, dtype=score_dtype,
                                            device=logits.device))
        weights = torch.softmax(logits.float(), dim=-1)
        probs = F.dropout(weights.to(self.dtype), self.dropout, self.training)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(self.dtype))
        out = self.out_proj(out.reshape(B, Tq, -1))
        return (out, weights) if return_weights else out

    def _decode_kernel(self, return_weights: bool) -> bool:
        return self.use_pallas and not self.training and not return_weights

    def _cached_step(self, q, k, v, cache, cache_index, cache_rows, key_valid,
                     causal):
        """Self-attention of a decode step (JAX attention.py:203-221,
        :289-298): write the step's K/V at ``cache_index`` (cast to the cache
        dtype), read the buffers through ``cache_rows`` if given, mask keys
        past the query's position when ``causal``.  One query with the
        kernel on: the kernel reads the buffers and the ancestry map where
        they lie, and the causal limit is a key mask shared by every row."""
        B, Tq, H, Dh = q.shape
        k_c, v_c = cache["k"], cache["v"]
        pos = cache_index + torch.arange(Tq, device=q.device)
        k_c.index_copy_(1, pos, k.to(k_c.dtype))
        v_c.index_copy_(1, pos, v.to(v_c.dtype))
        Tc = k_c.shape[1]
        new_cache = {"k": k_c, "v": v_c}
        cm = None
        if causal:   # key j is visible from the query at position p iff j <= p
            cm = torch.arange(Tc, device=q.device)[None, :] <= pos[:, None]
        if self._decode_kernel(False) and Tq == 1:
            valid = cm if key_valid is None else (key_valid if cm is None
                                                  else key_valid & cm)
            o = cuda_kernels.flash_attention_bias_cached(
                q, k_c.to(q.dtype), v_c.to(q.dtype), valid, cache_rows)
            return self.out_proj(o.reshape(B, Tq, self.d_model)), new_cache
        if cache_rows is not None:
            # the ancestry view: one leading-axis gather of (row, position)
            # pairs, contiguous H*Dh blocks; the buffers stay unpermuted
            flat = (cache_rows.long() * Tc
                    + torch.arange(Tc, device=q.device)[None, :]).reshape(-1)
            k = k_c.reshape(B * Tc, H, Dh)[flat].view(B, Tc, H, Dh)
            v = v_c.reshape(B * Tc, H, Dh)[flat].view(B, Tc, H, Dh)
        else:
            k, v = k_c, v_c
        mask = None if key_valid is None else key_valid[:, None, None, :]
        if cm is not None:
            mask = cm[None, None] if mask is None else mask & cm[None, None]
        return self._dense(q, k.to(q.dtype), v, None, mask, False), new_cache

    def _cross_step(self, q, cross_kv, key_valid, return_weights,
                    return_max_prob=False):
        """Cross-attention against precomputed K/V (JAX attention.py:159-198).
        When the K/V have B / G rows, the queries of each group of G beams
        attend as one row of G * Tq queries (grouped), and the weights come
        back per row; so does the largest probability with
        ``return_max_prob`` ([B, H, Tq])."""
        B, Tq, H, Dh = q.shape
        k, v = cross_kv["k"], cross_kv["v"]
        Bkv, Tk = k.shape[:2]
        G = B // Bkv
        q = q.reshape(Bkv, G * Tq, H, Dh)
        mask = key_valid
        if mask is not None and mask.shape[0] != Bkv:   # a tiled mask
            mask = mask.reshape(Bkv, G, Tk)[:, 0].contiguous()
        if self._decode_kernel(return_weights):
            # the head-major K/V read in place, the output in [B, Tq, H, Dh]
            o = cuda_kernels.flash_attention_bias_cached(
                q, k.to(q.dtype), v.to(q.dtype), mask, return_max_prob=return_max_prob)
            if not return_max_prob:
                return self.out_proj(o.reshape(B, Tq, self.d_model))
            o, maxp = o    # [Bkv * H, G * Tq] -> [B, H, Tq]
            maxp = maxp.view(Bkv, H, G, Tq).transpose(1, 2).reshape(B, H, Tq)
            return self.out_proj(o.reshape(B, Tq, self.d_model)), maxp
        if return_max_prob:
            out, w = self._cross_step(q.reshape(B, Tq, H, Dh), cross_kv, key_valid,
                                      True)
            return out, w.amax(-1)
        if G == 1:
            # untiled K/V: JAX's general path (its score dtype)
            return self._dense(q, k, v, None, None if mask is None else
                               mask[:, None, None, :], return_weights)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.full((), NEG_INF, device=logits.device))
        weights = torch.softmax(logits, dim=-1)
        probs = F.dropout(weights.to(self.dtype), self.dropout, self.training)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(self.dtype))
        out = self.out_proj(out.reshape(B, Tq, self.d_model))
        if not return_weights:
            return out
        # grouped weights back to per-row [B, H, Tq, Tk]
        w = weights.reshape(Bkv, H, G, Tq, Tk).transpose(1, 2).reshape(B, H, Tq, Tk)
        return out, w

    def precompute_kv(self, x_kv):
        """Project the encoder output once for decode-step cross-attention
        (static_kv, reference multihead_attention.py:207-209) -> {"k", "v":
        [B, Tk, H, Dh]}, views of head-major [B, H, Tk, Dh] storage: the
        decode-step kernel reads each (sample, head)'s keys as one
        contiguous block at every step."""
        B, Tk, _ = x_kv.shape
        H, Dh = self.num_heads, self.head_dim
        head_major = lambda t: t.view(B, Tk, H, Dh).transpose(1, 2).contiguous().transpose(1, 2)
        return {"k": head_major(self.k_proj(x_kv)), "v": head_major(self.v_proj(x_kv))}
