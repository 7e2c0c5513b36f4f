"""The twin of the decode-step attention kernel held against the JAX
package's ``flash_attention_bias`` (Pallas, interpret mode on the CPU).

The spec's three cases (tests/test_pallas_kernels.py:114-170, atol 2e-4 /
3e-4), the beam's two decode shapes at a reduced N (one query against a
causal prefix of the cache; five grouped queries against ragged encoder
frames) in f32 at 2e-4 and in bf16 at 3e-2 x max|ref|, a zero bias given as
None, and a row with no valid key, where the port follows the dense
formula (the mean of V over Tk) and the Pallas kernel does not (ROADMAP
C.3).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speecht5_tpu.models.attention import relative_bias
from speecht5_tpu.ops.pallas_kernels import flash_attention_bias as pallas_flash

from speecht5_tpu_torch.ops import cuda_kernels as K

torch.backends.cuda.matmul.allow_tf32 = False


def _case(rng, N, Tq, Tk, D, lengths=None, bias=True):
    q = rng.standard_normal((N, Tq, D)).astype(np.float32) * 0.3
    k = rng.standard_normal((N, Tk, D)).astype(np.float32) * 0.3
    v = rng.standard_normal((N, Tk, D)).astype(np.float32)
    b = (rng.standard_normal((N, Tq, Tk)).astype(np.float32) * 0.5 if bias
         else np.zeros((N, Tq, Tk), np.float32))
    valid = (None if lengths is None
             else np.arange(Tk)[None, :] < np.asarray(lengths)[:, None])
    return q, k, v, b, valid


def _twin(q, k, v, b, valid, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)
    return K.flash_attention_bias(
        t(q), t(k), t(v), None if b is None else torch.from_numpy(b),
        None if valid is None else torch.from_numpy(valid))


def _pallas(q, k, v, b, valid, block, dtype=jnp.float32):
    return np.asarray(pallas_flash(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(b), None if valid is None else jnp.asarray(valid),
        block_q=block, block_k=block), np.float32)


def test_twin_matches_pallas_dense_case():
    """test_matches_dense_attention: N 3, T 64, D 32, a row of 40 keys."""
    q, k, v, b, valid = _case(np.random.default_rng(0), 3, 64, 64, 32, [64, 40, 64])
    K.reset_launch_counts()
    got = _twin(q, k, v, b, valid)
    assert K.flash_attention_bias.launches == 0      # the CPU takes the twin
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, b, valid, 32),
                               atol=2e-4)


def test_twin_matches_pallas_with_relative_position_bias():
    """test_with_relative_position_bias: the SpeechT5 rel-pos term."""
    rng = np.random.default_rng(0)
    B, H, T, Dh, M = 2, 2, 48, 16, 8
    q = jnp.asarray(rng.standard_normal((B, T, H, Dh)), jnp.float32) * 0.2
    k = jnp.asarray(rng.standard_normal((B, T, H, Dh)), jnp.float32) * 0.2
    v = jnp.asarray(rng.standard_normal((B, T, H, Dh)), jnp.float32)
    table = jnp.asarray(rng.standard_normal((2 * M, Dh)), jnp.float32) * 0.1
    pos = jnp.arange(T)
    bias = relative_bias(q, table, pos, pos, M).reshape(B * H, T, T)
    rows = lambda a: np.array(a.transpose(0, 2, 1, 3).reshape(B * H, T, Dh))
    qf, kf, vf, bf = rows(q), rows(k), rows(v), np.array(bias)
    got = _twin(qf, kf, vf, bf, None)
    np.testing.assert_allclose(got.numpy(), _pallas(qf, kf, vf, bf, None, 16),
                               atol=3e-4)


def test_twin_matches_pallas_uneven_lengths():
    """test_uneven_lengths_padding: Tq, Tk not multiples of the blocks; the
    zero bias given as None is the same function."""
    q, k, v, b, valid = _case(np.random.default_rng(0), 2, 37, 53, 16,
                              [30, 53], bias=False)
    got = _twin(q, k, v, None, valid)
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, b, valid, 16),
                               atol=2e-4)
    np.testing.assert_array_equal(got.numpy(), _twin(q, k, v, b, valid).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Tq,Tk,lengths", [
    (6, 1, 41, [17] * 3 + [1] * 3),       # cached self-attention, causal prefix
    (4, 5, 77, [77, 77, 50, 50]),         # grouped cross-attention, G = 5
])
def test_twin_matches_pallas_at_decode_shapes(dtype, N, Tq, Tk, lengths):
    """The beam's decode-step shapes at D 64 (N cut from 60 and 12): f32 at
    2e-4, bf16 at 3e-2 x max|ref| (the twin rounds the normalised
    probabilities to bf16, the Pallas kernel the running ones)."""
    q, k, v, _, valid = _case(np.random.default_rng(N + Tk), N, Tq, Tk, 64, lengths,
                              bias=False)
    zero = np.zeros((N, Tq, Tk), np.float32)
    tdt = getattr(torch, dtype)
    got = _twin(q, k, v, None, valid, tdt)
    assert got.dtype == tdt and got.shape == (N, Tq, 64)
    want = _pallas(q, k, v, zero, valid, 16, getattr(jnp, dtype))
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= 2e-4, err
    else:
        assert err <= 3e-2 * np.abs(want).max(), err


def test_twin_takes_one_mask_row_per_group_of_rows():
    """The decode path hands one mask row per sample to its heads: a
    [N / R, Tk] mask is the [N, Tk] mask with each row repeated R times,
    held against the Pallas kernel given the repeated mask."""
    N, R, Tk = 6, 3, 41
    q, k, v, _, valid = _case(np.random.default_rng(5), N, 1, Tk, 64,
                              [17] * 3 + [1] * 3, bias=False)
    got = _twin(q, k, v, None, np.ascontiguousarray(valid[::R]))
    np.testing.assert_array_equal(got.numpy(), _twin(q, k, v, None, valid).numpy())
    np.testing.assert_allclose(
        got.numpy(), _pallas(q, k, v, np.zeros((N, 1, Tk), np.float32), valid, 16),
        atol=2e-4)


def test_row_without_valid_keys_is_the_mean_of_v():
    """The dense formula: every key at -1e9, a uniform softmax, the mean of
    V over the Tk keys.  The Pallas kernel pads Tk to its block (53 -> 64)
    with zero V rows that also take -1e9, and returns sum(V) / 64 instead
    (ROADMAP C.3); a beam never has such a row."""
    q, k, v, b, valid = _case(np.random.default_rng(3), 2, 3, 53, 16, [53, 0])
    got = _twin(q, k, v, b, valid).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), (3, 16)),
                               atol=1e-6)
    pallas = _pallas(q, k, v, b, valid, 16)
    np.testing.assert_allclose(pallas[0], got[0], atol=2e-4)
    np.testing.assert_allclose(pallas[1], np.broadcast_to(v[1].sum(0) / 64, (3, 16)),
                               atol=1e-5)


# ------------------------------------------------- the cached (in-place) entry


def _cache_case(rng, B, H, Tc, D, dtype=torch.float32):
    """The beam's self step: q [B, 1, H, D] (scaled), a [B, Tc, H, D] cache
    and an ancestry map that repeats and permutes physical rows."""
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32) * 0.3)
    k = torch.from_numpy(rng.standard_normal((B, Tc, H, D)).astype(np.float32) * 0.3)
    v = torch.from_numpy(rng.standard_normal((B, Tc, H, D)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, B, (B, Tc)))
    rows[:, 0] = torch.from_numpy(rng.permutation(B))
    rows[0, 1:4] = rows[1, 1:4] = 2            # two rows share an ancestor
    return q.to(dtype), k.to(dtype), v.to(dtype), rows


def _gather_heads(t4, rows):
    """[B, T, H, D] read through ``rows`` as the plain path gathers it (one
    flat gather of (row, position) pairs), as [B * H, T, D] rows."""
    B, T, H, D = t4.shape
    if rows is not None:
        flat = (rows.long() * T + torch.arange(T)[None, :]).reshape(-1)
        t4 = t4.reshape(B * T, H, D)[flat].view(B, T, H, D)
    return t4.transpose(1, 2).reshape(B * H, T, D)


@pytest.mark.parametrize("case", ["self", "cross"])
def test_cached_twin_matches_pallas_on_the_gathered_keys(case):
    """The cached entry at the beam's step shapes (tiny width) against the
    Pallas kernel on the gathered K/V, f32 at 1e-5.  self: 5 beam rows, one
    query against a 21-position cache read through a repeating, permuting
    row map, causal at position 9 (a [1, Tc] mask for every row); cross:
    2 samples x 5 grouped queries against head-major [B, H, Tk, D] K/V
    viewed as [B, Tk, H, D], ragged frames (a [B, Tk] mask)."""
    rng = np.random.default_rng(11)
    H, D = 2, 16
    if case == "self":
        B, Tq, Tk = 5, 1, 21
        q4, k4, v4, rows = _cache_case(rng, B, H, Tk, D)
        valid = torch.arange(Tk)[None, :] <= 9
        full = valid.expand(B * H, Tk)
    else:
        B, Tq, Tk = 2, 5, 37
        q4 = torch.from_numpy(rng.standard_normal((B, Tq, H, D)).astype(np.float32) * 0.3)
        k4, v4 = (torch.from_numpy(rng.standard_normal((B, H, Tk, D)).astype(np.float32) * s)
                  .transpose(1, 2) for s in (0.3, 1.0))
        rows = None
        valid = torch.arange(Tk)[None, :] < torch.tensor([[37], [20]])
        full = valid.repeat_interleave(H, 0)
    got = K.flash_attention_bias_cached(q4, k4, v4, valid, rows)
    assert got.shape == (B, Tq, H, D) and got.is_contiguous()
    heads = lambda t: t.transpose(1, 2).reshape(B * H, Tq, D).numpy()
    want = _pallas(heads(q4), _gather_heads(k4, rows).numpy(),
                   _gather_heads(v4, rows).numpy(),
                   np.zeros((B * H, Tq, Tk), np.float32), full.numpy(), 16)
    np.testing.assert_allclose(heads(got), want, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_twin_is_the_gather_then_the_plain_twin(dtype):
    """Bit for bit: the cached twin = the decoder's flat gather of the cache
    through the row map + ``flash_attention_bias_plain`` on [B * H, T, D]
    rows, with the mask as one row for all ([1, Tc]) or one per sample."""
    B, H, Tc, D = 5, 3, 17, 32
    q4, k4, v4, rows = _cache_case(np.random.default_rng(12), B, H, Tc, D, dtype)
    for valid in (torch.arange(Tc)[None, :] <= 6,
                  torch.arange(Tc)[None, :] < torch.tensor([[3], [17], [9], [1], [6]])):
        K.reset_launch_counts()
        got = K.flash_attention_bias_cached(q4, k4, v4, valid, rows)
        assert K.flash_attention_bias.launches == 0      # the CPU takes the twin
        ref = K.flash_attention_bias_plain(
            q4.transpose(1, 2).reshape(B * H, 1, D), _gather_heads(k4, rows),
            _gather_heads(v4, rows), None, valid)
        assert got.dtype == dtype
        assert torch.equal(got, ref.view(B, H, 1, D).transpose(1, 2))
    # no row map: the cache read as it is
    got = K.flash_attention_bias_cached(q4, k4, v4, None, None)
    ref = K.flash_attention_bias_plain(q4.transpose(1, 2).reshape(B * H, 1, D),
                                       _gather_heads(k4, None), _gather_heads(v4, None))
    assert torch.equal(got, ref.view(B, H, 1, D).transpose(1, 2))

