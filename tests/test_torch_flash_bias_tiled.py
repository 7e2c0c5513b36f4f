"""The query-tiled path of the port's ``flash_attention_bias`` on the CPU:
its routing, its twin against the JAX package's Pallas kernel at long
queries, and a model of its rounding points against the twin.

``cuda_kernels.flash_bias_path`` picks the kernel of a call on the card:
the tiled kernel (``csrc/flash_attention_bias_tiled.cu``, 64-query tiles on
wgmma) for WavLM's self-attention, the cluster split for every decode step.
The twin (``flash_attention_bias_plain``) is what the card holds both
kernels against; here it is held against the Pallas ``flash_attention_bias``
in interpret mode at the tiled path's edge shapes (T 77 and 130: multiples
of neither 8 nor 64; a ragged sample; a WavLM-style gated bias), and a model
of the tiled kernel's arithmetic (64-key tiles, tiles without a valid key
skipped, bf16 probabilities at the running max, -inf past Tk) is held
against the twin.

Tolerances: f32 1e-5 absolute (sums in another order); bf16 3e-2 of max
|ref| (one bf16 rounding of each probability on either side).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu.ops.pallas_kernels import flash_attention_bias as pallas_flash

import chip_smoke as S
from speecht5_tpu_torch.models.wavlm import relative_position_buckets
from speecht5_tpu_torch.ops import cuda_kernels as K

REL_BF16 = 3e-2
TILE = 64


def _wavlm_case(T, heads=2, lengths=(None, 0.7), seed=0):
    """q (scaled), k, v [N, T, 64] and WavLM's gated bias [N, T, T] (the
    bucketed position bias of WavLM Base's 320 buckets times a per-(row,
    query) gate in (1, 3)), N = samples x heads, and the samples' key mask
    [samples, T]: each length a share of T, None for every key valid."""
    rng = np.random.default_rng(seed)
    B, D = len(lengths), 64
    N = B * heads
    q = (rng.standard_normal((N, T, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((N, T, D)).astype(np.float32)
    v = rng.standard_normal((N, T, D)).astype(np.float32)
    table = rng.standard_normal((320, heads)).astype(np.float32)
    pos = table[relative_position_buckets(T, 320, 800).numpy()].transpose(2, 0, 1)
    gate = rng.uniform(1.0, 3.0, (B, heads, T, 1)).astype(np.float32)
    bias = (gate * pos[None]).reshape(N, T, T).astype(np.float32)
    valid = np.stack([np.arange(T) < (T if f is None else int(f * T)) for f in lengths])
    return q, k, v, bias, valid


def _pallas(q, k, v, bias, valid, dtype):
    """The TPU kernel in interpret mode, the mask repeated to its [N, Tk]."""
    full = np.repeat(valid, q.shape[0] // valid.shape[0], 0)
    return np.asarray(pallas_flash(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                                   jnp.asarray(v, dtype), jnp.asarray(bias),
                                   jnp.asarray(full)), np.float32)


def _tiled_model(q, k, v, bias, key_valid, p_dtype=torch.bfloat16):
    """The tiled kernel's arithmetic in plain PyTorch: 64-key tiles, the
    keys past Tk at -inf (no part in the sum), an invalid key at -1e9 (its
    bias not added), only the tiles with a valid key visited (every tile
    when the row has none, which then gives the mean of V over its Tk keys),
    an online f32 softmax whose probabilities exp(s - m_running) are rounded
    to ``p_dtype`` for P.V, one division by l at the end."""
    N, Tq, D = q.shape
    Tk = k.shape[1]
    valid = key_valid.repeat_interleave(N // key_valid.shape[0], 0)
    nkt = -(-Tk // TILE)
    pad = nkt * TILE - Tk
    s = q.float() @ k.float().transpose(1, 2) + bias.float()
    s = torch.where(valid[:, None, :], s, torch.full((), K.NEG_INF))
    s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    tiles = torch.nn.functional.pad(valid, (0, pad)).view(N, nkt, TILE).any(-1)
    visit = tiles | ~valid.any(1, keepdim=True)                       # [N, nkt]
    m = torch.full((N, Tq), -torch.inf)
    l = torch.zeros(N, Tq)
    o = torch.zeros(N, Tq, D)
    for t in range(nkt):
        on = visit[:, t, None]
        st = s[:, :, t * TILE:(t + 1) * TILE]
        mn = torch.where(on, torch.maximum(m, st.amax(-1)), m)
        alpha = torch.where(on, torch.exp(m - mn), torch.ones(()))
        p = torch.where(on[..., None], torch.exp(st - mn[..., None]), torch.zeros(()))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(p_dtype).float() @ vf[:, t * TILE:(t + 1) * TILE]
        m = mn
    return (o / l[..., None]).to(q.dtype)


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("T", [499, 1499])
def test_path_is_tiled_at_wavlm_shapes(T):
    """WavLM Base and Large (12 / 16 heads, both Dh 64) at 10 s and 30 s in
    bf16 take the tiled kernel, alone or in a padded batch with its key
    mask: the route reads the shapes (Tq, Tk, D, dtype), not the rows or the
    mask; so do the smoke's tiled cases (the padded batch, T 77, a sample
    with no valid frame)."""
    assert K.flash_bias_path(T, T, 64, torch.bfloat16) == "tiled"
    for case in (f"wavlm_T{T}", *S.WAVLM_TILED_CASES):
        Tc = int(case.split("_T")[-1])
        assert K.flash_bias_path(Tc, Tc, 64, torch.bfloat16) == "tiled", case


@pytest.mark.parametrize("Tq,Tk,D,dtype", [
    (1499, 1499, 64, torch.float32),              # f32: the CUDA-core parity route
    (499, 499, 80, torch.bfloat16),               # D 80: the fusion LM's head size
    (499, 499, 128, torch.bfloat16),              # D 128: LLaMA's
    (K.FLASH_TILED_MIN_TQ - 1, 1499, 64, torch.bfloat16),
    (499, K.FLASH_TILED_MAX_TK + 1, 64, torch.bfloat16),
    (499, 499, 40, torch.bfloat16),               # neither kernel takes D 40
])
def test_path_is_split_elsewhere(Tq, Tk, D, dtype):
    """The route changes only with what the tiled kernel lacks (the
    cached entry's row map, strides and max-probability output never reach
    it: that entry launches the split kernel whatever Tq, a card test)."""
    assert K.flash_bias_path(Tq, Tk, D, dtype) == "split"
    assert K.flash_bias_path(max(Tq, K.FLASH_TILED_MIN_TQ), min(Tk, 1499), 64,
                             torch.bfloat16) == "tiled"


def test_every_decode_shape_of_the_smoke_is_split():
    """Each decode-step case that ``chip_smoke.py`` holds against the twin
    has 1-8 queries and takes the split kernel in both dtypes: through the
    contract entry by its route, through the cached entry always."""
    for dtype in (torch.float32, torch.bfloat16):
        for case in S.FLASH_BIAS_DECODE_CASES:
            q, k, _, _, _ = S.flash_bias_case(case, dtype, device="cpu")
            assert q.shape[1] <= 8
            assert K.flash_bias_path(q.shape[1], k.shape[1], q.shape[2], dtype) == "split"
        for case in S.FLASH_BIAS_CACHED_CASES:
            q4, k4, _, _, _ = S.flash_bias_cache_case(case, dtype, device="cpu")
            assert q4.shape[1] <= 8
            assert K.flash_bias_path(q4.shape[1], k4.shape[1], q4.shape[3], dtype) == "split"


# ------------------------------------------------------- twin against Pallas


@pytest.mark.parametrize("T", [77, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_pallas_at_tiled_edge_shapes(T, dtype):
    """N 4 (two samples of two heads), Tq = Tk = T, D 64, the gated bias,
    the second sample's keys valid up to 0.7 T: the twin (which the card
    holds the tiled kernel against) against the TPU kernel."""
    q, k, v, bias, valid = _wavlm_case(T)
    tdt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(a).to(tdt)
    got = K.flash_attention_bias(t(q), t(k), t(v), torch.from_numpy(bias),
                                 torch.from_numpy(valid))
    want = _pallas(q, k, v, bias, valid, getattr(jnp, dtype))
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= REL_BF16 * np.abs(want).max(), err


# ------------------------------------------- the tiled kernel's rounding


@pytest.mark.parametrize("T,lengths", [
    (77, (None, 0.7)),           # one tile and a 13-key tail
    (130, (None, 0.0)),          # a sample with no valid key: the mean of V
    (200, (None, 0.4, 1.0)),     # a 64-key tile with no valid key is skipped
])
def test_tiled_rounding_model_matches_twin(T, lengths):
    """bf16 inputs: the model of the tiled kernel's rounding points against
    the twin within 3e-2 of max |ref|; a row with no valid key gives the
    mean of V over exactly its Tk keys in both."""
    q, k, v, bias, valid = _wavlm_case(T, lengths=lengths, seed=T)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    args = (bf(q), bf(k), bf(v), torch.from_numpy(bias), torch.from_numpy(valid))
    got, ref = _tiled_model(*args), K.flash_attention_bias_plain(*args)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_BF16 * ref.float().abs().max().item(), err
    for b, f in enumerate(lengths):
        if f == 0.0:
            rows = slice(2 * b, 2 * b + 2)
            mean = args[2][rows].float().mean(1, keepdim=True).expand(-1, T, -1)
            assert (got[rows].float() - mean).abs().max() <= REL_BF16 * mean.abs().max()
            assert (ref[rows].float() - mean).abs().max() <= REL_BF16 * mean.abs().max()


def test_tiled_model_in_f32_is_the_dense_formula():
    """In f32 with P kept in f32, the model's tiles, skips and -inf tail
    change nothing but the order of the sums: equal to the twin to 1e-5."""
    q, k, v, bias, valid = _wavlm_case(130, lengths=(None, 0.3), seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v, bias, valid)]
    got = _tiled_model(*args, p_dtype=torch.float32)
    assert (got - K.flash_attention_bias_plain(*args)).abs().max().item() <= 1e-5
