"""The encoder's row-padded band: built once per forward as a ``[Dh, T, T]``
view of ``[Dh, T, Tp]`` storage (Tp = T rounded up to 8, the 16-byte row
stride the wgmma kernels' TMA maps need), it must give what the contiguous
band gives, and the attention wrappers' layout check must take exactly the
two layouts.

On the CPU the kernels' twins run, so this holds the Python around the
kernels: the band's construction, its layout check and the gradient that
reaches the relative-position table through the view.  Tiny preset, 4000
samples -> T = 49 (T % 8 = 1).  Tolerances: padded against contiguous band
1e-6 absolute plus 1e-5 relative (the same f32 arithmetic; the table's
gradient sums in another order, ~1e-6 relative, as its gather's backward
also runs over the padding); against the JAX package 2e-4 absolute, as
``tests/test_torch_asr_slice.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import speecht5_tpu.config as JC
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from test_torch_asr_slice import ATOL, KERNEL_FLAGS, _init_jax, _port, _state_dict, _wav

import chip_smoke
from speecht5_tpu_torch.models import encoder as penc
from speecht5_tpu_torch.models.attention import band_from_table
from speecht5_tpu_torch.ops import cuda_kernels as K

torch.backends.cuda.matmul.allow_tf32 = False
TIGHT = dict(atol=1e-6, rtol=1e-5)
# the train route of the encoder's attention, every stochastic part at 0
TRAIN_FLAGS = ["encoder.use_pallas_attn_train=True", *chip_smoke.DETERMINISTIC]


@pytest.fixture(scope="module")
def tiny():
    cfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    variables = _init_jax(cfg)
    return cfg, variables, _state_dict(variables)


def _encode(model, wav, lens, grad=False):
    """encoder_out, CTC logits and (with ``grad``) the table's gradient of
    sum(logits ** 2)."""
    with torch.set_grad_enabled(grad):
        enc = model.encode_speech(torch.from_numpy(wav), torch.from_numpy(lens))
        logits = model.ctc_logits(enc)
    table = model.encoder.pos_emb.pe_k.weight
    table.grad = None
    if grad:
        (logits ** 2).sum().backward()
    return enc["encoder_out"].detach(), logits.detach(), table.grad


@pytest.mark.parametrize("flags,train", [(KERNEL_FLAGS, False), (TRAIN_FLAGS, True)],
                         ids=["inference", "train"])
def test_row_padded_band_gives_the_contiguous_bands_encoder(tiny, monkeypatch, flags, train):
    """encoder_out, CTC logits and the table gradient with the band built
    row-padded (the encoder's layout) equal those with a contiguous band;
    inference through the attention kernel's twin, training through the
    train kernel's autograd twin (dropout and masking off)."""
    _, _, sd = tiny
    _, model = _port(flags, **chip_smoke.DICT_CFG)
    model.load_state_dict(sd)
    model.train(train)
    wav, lens = _wav(2, 4000, seed=1), np.array([4000, 1700], np.int32)
    seen = []
    real = band_from_table

    def spy(*args, **kw):
        band = real(*args, **kw)
        seen.append(band.stride())
        return band

    monkeypatch.setattr(penc, "band_from_table", spy)
    padded = _encode(model, wav, lens, grad=train)
    monkeypatch.setattr(penc, "BAND_ROW_MULTIPLE", 1)
    contiguous = _encode(model, wav, lens, grad=train)
    T = padded[0].shape[1]
    assert T % 8 and seen == [(T * 56, 56, 1), (T * T, T, 1)]
    for got, want in zip(padded, contiguous):
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TIGHT)
    if train:
        assert padded[2] is not None and padded[2].abs().max() > 0


def test_row_padded_band_encoder_matches_jax(tiny):
    """The port's encoder (the row-padded band, the attention kernel's
    twin) against the JAX encoder on the same weights at T % 8 != 0."""
    cfg, variables, sd = tiny
    _, model = _port(KERNEL_FLAGS, **chip_smoke.DICT_CFG)
    model.load_state_dict(sd)
    wav, lens = _wav(2, 4000, seed=2), np.array([4000, 2900], np.int32)
    jm = JModel(JC.apply_overrides(cfg, KERNEL_FLAGS))
    jenc = jm.apply(variables, jnp.asarray(wav), jnp.asarray(lens), method="encode_speech")
    jlogits = jm.apply(variables, jenc, method="ctc_logits")
    enc, logits, _ = _encode(model, wav, lens)
    assert enc.shape[1] % 8
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc["encoder_out"]), atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)


@pytest.mark.parametrize("T", [1, 7, 8, 49, 799])
def test_band_from_table_row_padded_view_equals_the_contiguous_band(T):
    """The view holds the contiguous band's values with strides (T Tp, Tp,
    1), and the table's gradient through it is the same."""
    g = torch.Generator().manual_seed(T)
    table = torch.randn(32, 16, generator=g)
    cot = torch.randn(16, T, T, generator=g)
    grads, bands = [], []
    for multiple in (8, 1):
        leaf = table.clone().requires_grad_()
        band = band_from_table(leaf, T, 16, dtype=torch.float32, row_multiple=multiple)
        (band * cot).sum().backward()
        grads.append(leaf.grad)
        bands.append(band.detach())
    Tp = -(-T // 8) * 8
    assert bands[0].shape == (16, T, T) and bands[0].stride() == (T * Tp, Tp, 1)
    assert torch.equal(bands[0], bands[1]) and bands[1].is_contiguous()
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), **TIGHT)
    assert K.band_row_stride(bands[0]) == Tp and K.band_row_stride(bands[1]) == T


@pytest.mark.parametrize("T", [1, 7, 8, 49])
def test_band_layout_check_takes_the_two_layouts_only(T):
    """``band_row_stride``: a contiguous band (row stride T) and the
    row-padded view (Tp) pass; rows padded to another length, a transposed
    band and a strided last axis raise."""
    Dh, Tp = 4, -(-T // 8) * 8
    assert K.band_row_stride(torch.zeros(Dh, T, T)) == T
    assert K.band_row_stride(torch.zeros(Dh, T, Tp)[..., :T]) == Tp
    bad = [torch.zeros(Dh, T, Tp + 8)[..., :T],          # rows of Tp + 8
           torch.zeros(Dh, T, 2 * T)[..., ::2]]           # every other column
    if T > 1:
        bad.append(torch.zeros(Dh, T, T).transpose(1, 2))
    for band in bad:
        with pytest.raises(ValueError, match="strides"):
            K.band_row_stride(band)
    with pytest.raises(ValueError, match=r"\[Dh, T, T\]"):
        K.band_row_stride(torch.zeros(Dh, T, T + 1))
