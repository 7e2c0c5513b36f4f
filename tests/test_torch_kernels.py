"""The port's kernel twins held against the JAX package's Pallas kernels.

The plain PyTorch twins in ``speecht5_tpu_torch/ops/cuda_kernels.py`` are
what a wrapper runs for CPU tensors and what ``chip_smoke.py`` holds the
CUDA kernels against on the card.  Here they meet the TPU kernels they
replace, run in interpret mode on the CPU, on the same numpy inputs.  The
cases mirror ``tests/test_pallas_kernels.py`` (banded attention :73-103,
conv stack :171-249).

Tolerances: f32 2e-4 absolute, as the JAX kernel tests use (the two sides
sum in different orders); bf16 3e-2 of max |ref| (one bf16 rounding of the
probabilities or activations on either side).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speecht5_tpu.models.attention import band_from_table as jax_band_from_table
from speecht5_tpu.ops import pallas_kernels as PK

from speecht5_tpu_torch.models.attention import band_from_table
from speecht5_tpu_torch.ops import cuda_kernels as K

torch.backends.cuda.matmul.allow_tf32 = False
ATOL_F32 = 2e-4
REL_BF16 = 3e-2


def _attn_inputs(N, T, D, M, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((N, T, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((N, T, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((N, T, D)).astype(np.float32)
    table = (rng.standard_normal((2 * M, D)) * 0.2).astype(np.float32)
    return q, k, v, table


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize("T,M", [(48, 8), (77, 8), (130, 40)])
def test_band_matches_jax_skew(T, M):
    table = _attn_inputs(1, 4, 16, M)[3]
    want = np.asarray(jax_band_from_table(jnp.asarray(table), T, M))
    got = band_from_table(_t(table), T, M).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,lengths,block_q", [
    (48, [48, 48, 30, 17], 16),       # ragged, T a multiple of the block
    (77, [77, 50, 33, 1], 16),        # T not a multiple of the block
    (128, [128, 0, 64, 100], 64),     # a zero-length row
])
def test_attention_twin_matches_pallas_f32(T, lengths, block_q):
    N, D, M = 4, 16, 8
    q, k, v, table = _attn_inputs(N, T, D, M)
    band = jax_band_from_table(jnp.asarray(table), T, M)
    want = np.asarray(PK.banded_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), band,
        jnp.asarray(lengths, jnp.int32), block_q=block_q))
    got = K.banded_flash_attention(
        _t(q), _t(k), _t(v), band_from_table(_t(table), T, M),
        torch.tensor(lengths, dtype=torch.int32))
    assert got.shape == (N, T, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)


def test_attention_twin_matches_pallas_bf16():
    N, T, D, M = 4, 77, 16, 8
    q, k, v, table = _attn_inputs(N, T, D, M, seed=1)
    lengths = [77, 40, 9, 64]
    bf = jnp.bfloat16
    band = jax_band_from_table(jnp.asarray(table, bf), T, M)
    want = np.asarray(PK.banded_flash_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf), band,
        jnp.asarray(lengths, jnp.int32), block_q=16), np.float32)
    b16 = torch.bfloat16
    got = K.banded_flash_attention(
        _t(q, b16), _t(k, b16), _t(v, b16),
        band_from_table(_t(table, b16), T, M),
        torch.tensor(lengths, dtype=torch.int32))
    assert got.dtype == b16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= REL_BF16 * np.abs(want).max(), err


def test_attention_zero_length_row_is_mean_of_v():
    """A row of length 0 sees -1e9 on every key: softmax is uniform and the
    output is the mean of V over the T keys (the dense JAX path's answer),
    never NaN.  The Pallas kernel averages over its padded length instead
    when T is not a multiple of 128 (see ROADMAP.md C)."""
    N, T, D, M = 2, 77, 16, 8
    q, k, v, table = _attn_inputs(N, T, D, M, seed=2)
    got = K.banded_flash_attention(
        _t(q), _t(k), _t(v), band_from_table(_t(table), T, M),
        torch.tensor([0, T], dtype=torch.int32)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), (T, D)),
                               atol=1e-5)


def test_twins_count_no_launches_on_cpu():
    K.reset_launch_counts()
    q, k, v, table = _attn_inputs(1, 8, 4, 2)
    K.banded_flash_attention(_t(q), _t(k), _t(v), band_from_table(_t(table), 8, 2))
    K.conv_stack(torch.zeros(1, 9, 4), [torch.zeros(3, 4, 4)], [(3, 2)])
    q = _t(q).requires_grad_()
    K.banded_attention_train(q, _t(k), _t(v), band_from_table(_t(table), 8, 2),
                             dropout_rate=0.1, seed=1).sum().backward()
    K.fused_log_mel(torch.zeros(1, 2048), n_fft=512, hop=128, n_mels=8)
    K.flash_attention_bias(q.detach(), _t(k), _t(v))
    assert K.launch_counts() == {
        "banded_flash_attention": 0, "conv_stack": 0,
        "banded_attention_train_fwd": 0, "banded_attention_train_bwd_dq": 0,
        "banded_attention_train_bwd_dkv": 0, "fused_log_mel": 0,
        "flash_attention_bias": 0}


SPECS = ((3, 2), (3, 2), (2, 2))
BASE_SPECS = ((3, 2),) * 4 + ((2, 2),) * 2


def _conv_inputs(C, T, specs, B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    ws = [(rng.standard_normal((k, C, C)) * 0.05).astype(np.float32)
          for k, _ in specs]
    return x, ws


@pytest.mark.parametrize("C,T,specs,dtype", [
    (32, 700, SPECS, "float32"),
    (32, 333, SPECS, "float32"),       # T_out not a multiple of the tile
    (32, 333, SPECS, "bfloat16"),
    (512, 400, BASE_SPECS, "float32"),  # Base channels and layer specs
])
def test_conv_stack_twin_matches_pallas(C, T, specs, dtype):
    x, ws = _conv_inputs(C, T, specs)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(PK.conv_stack_pallas(
        jnp.asarray(x, jdt), [jnp.asarray(w) for w in ws], specs, tile=16),
        np.float32)
    got = K.conv_stack(_t(x, tdt), [_t(w) for w in ws], specs)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32)
    else:
        assert np.abs(got - want).max() <= REL_BF16 * np.abs(want).max()


@pytest.mark.parametrize("B", [1, 2])
def test_attention_module_hands_the_kernel_contiguous_rows(monkeypatch, B):
    """The CUDA wrapper refuses strided inputs; at B == 1 a reshape of the
    head-transposed projections is a strided view, so the module must copy."""
    from speecht5_tpu_torch.models.attention import MultiheadAttention

    seen = []

    def spy(q, k, v, band, lengths=None):
        seen.append(all(t.is_contiguous() for t in (q, k, v, band, lengths)))
        return K.banded_flash_attention_plain(q, k, v, band, lengths)

    monkeypatch.setattr(K, "banded_flash_attention", spy)
    attn = MultiheadAttention(32, 4, use_pallas=True).eval()
    T = 9
    band = band_from_table(torch.randn(8, 8), T, 4)
    valid = torch.arange(T)[None, :] < torch.tensor([T, 5][:B])[:, None]
    with torch.no_grad():
        attn(torch.randn(B, T, 32), valid, band)
    assert seen == [True]
