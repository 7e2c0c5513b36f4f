"""The port's EnCodec (``models/encodec.py``) and its HF converter held
against the JAX package (tests/test_encodec.py is the specification).

- On JAX's weights (``init_encodec`` at ``encodec_tiny``, carried by
  ``utils/convert.encodec_from_jax_params``, strict): ``decode_codes`` at
  full and at lower bandwidth, the encoder's latents, the LSTM stack alone
  (``nn.LSTM`` against JAX's ``lax.scan``) and ``encode``'s RVQ codes.
- ``utils/convert_hf.convert_encodec`` against two oracles: JAX's
  ``convert_encodec`` on the same random-init ``transformers.EncodecModel``
  state dict (every tensor, in the port's layout), and that HF model's own
  decode and encode.
- The causal conv's extra right pad at a length that is not a whole number
  of frames: the port pads as JAX does (zeros), HF reflects (ROADMAP C.2).

Tolerances: waveforms and latents 1e-5 absolute, the LSTM 1e-6, converted
tensors equal, RVQ codes exact (f32; TF32 off, JAX at ``highest``,
tests/conftest.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from speecht5_tpu.models.encodec import (EncodecLSTM as JLSTM, EncodecModel as JEncodec,
                                         encodec_tiny as jencodec_tiny,
                                         init_encodec as jinit_encodec)
from speecht5_tpu.utils.convert_hf import convert_encodec as jconvert_encodec

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.models.encodec import (EncodecModel, encodec_24khz, encodec_tiny,
                                               init_encodec)
from speecht5_tpu_torch.utils.convert import encodec_from_jax_params
from speecht5_tpu_torch.utils.convert_hf import convert_encodec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
WAV_TOL = 1e-5
LSTM_TOL = 1e-6
TINY = encodec_tiny()
JTINY = jencodec_tiny()


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def jax_pair():
    """JAX's model and variables (every direction initialised) and the
    port's model on the same weights."""
    variables = jax.jit(lambda: jinit_encodec(JTINY, jax.random.PRNGKey(0))[1])()
    jm = JEncodec(JTINY)
    model = EncodecModel(TINY)
    model.load_state_dict(encodec_from_jax_params(_flat(variables["params"])))
    return jm, variables, model.eval()


def _codes(n_q, T, seed):
    return np.random.default_rng(seed).integers(0, TINY.codebook_size, (2, n_q, T))


@pytest.mark.parametrize("n_q", [TINY.num_quantizers, 2])
def test_decode_codes_matches_jax(jax_pair, n_q):
    jm, variables, model = jax_pair
    codes = _codes(n_q, 11, seed=n_q)
    want = np.asarray(jm.apply(variables, jnp.asarray(codes, jnp.int32),
                               method="decode_codes"))
    with torch.no_grad():
        got = model.decode_codes(torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, 11 * TINY.hop_length)
    np.testing.assert_allclose(got, want, atol=WAV_TOL)


def test_encoder_latents_lstm_and_codes_match_jax(jax_pair):
    """The SEANet encoder's latents (1e-5), the decoder's LSTM stack alone
    with its residual skip (1e-6) and the RVQ codes of ``encode`` (exact,
    every quantizer)."""
    jm, variables, model = jax_pair
    wav = (0.3 * np.random.default_rng(4).standard_normal((2, 9 * TINY.hop_length))
           ).astype(np.float32)
    z_want = np.asarray(jm.apply(variables, jnp.asarray(wav)[..., None],
                                 method=lambda m, w: m.encoder(w)))
    codes_want = np.asarray(jm.apply(variables, jnp.asarray(wav), method="encode"))
    x = np.random.default_rng(5).standard_normal((2, 6, 4 * TINY.num_filters)
                                                 ).astype(np.float32)
    lstm_want = np.asarray(JLSTM(4 * TINY.num_filters, TINY.num_lstm_layers).apply(
        {"params": variables["params"]["decoder"]["lstm"]}, jnp.asarray(x)))
    with torch.no_grad():
        z = model.encoder(torch.from_numpy(wav)[:, None, :]).transpose(1, 2).numpy()
        codes = model.encode(torch.from_numpy(wav)).numpy()
        lstm = model.decoder.lstm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(z, z_want, atol=WAV_TOL)
    np.testing.assert_allclose(lstm.numpy(), lstm_want, atol=LSTM_TOL)
    assert codes.shape == codes_want.shape == (2, TINY.num_quantizers, 9)
    np.testing.assert_array_equal(codes, codes_want)


def test_extra_right_pad_follows_jax(jax_pair):
    """At 9 frames and 3 samples the causal convs pad on the right: the
    port's encoder equals JAX's (zeros there; HF reflects those samples,
    ROADMAP C.2)."""
    jm, variables, model = jax_pair
    wav = (0.3 * np.random.default_rng(6).standard_normal((1, 9 * TINY.hop_length + 3))
           ).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(wav)[..., None],
                               method=lambda m, w: m.encoder(w)))
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(wav)[:, None, :]).transpose(1, 2).numpy()
    assert got.shape == want.shape == (1, 10, TINY.hidden_size)
    np.testing.assert_allclose(got, want, atol=WAV_TOL)


# ------------------------------------------------------------ HF converter


@pytest.fixture(scope="module")
def hf_model():
    """A random-init ``transformers.EncodecModel`` at ``encodec_tiny``'s
    topology (random codebooks: HF inits them to zero), as
    tests/test_encodec.py builds it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")        # skips importing TensorFlow
        transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.EncodecConfig(
        audio_channels=1, num_filters=TINY.num_filters,
        num_residual_layers=TINY.num_residual_layers,
        upsampling_ratios=list(TINY.upsampling_ratios), codebook_size=TINY.codebook_size,
        codebook_dim=TINY.hidden_size, hidden_size=TINY.hidden_size,
        num_lstm_layers=TINY.num_lstm_layers, sampling_rate=TINY.sampling_rate,
        target_bandwidths=[TINY.num_quantizers * TINY.frame_rate
                           * np.log2(TINY.codebook_size) / 1000.0],
        normalize=False)
    hf = transformers.EncodecModel(hf_cfg).eval()
    assert hf_cfg.num_quantizers == TINY.num_quantizers
    with torch.no_grad():
        for layer in hf.quantizer.layers:
            layer.codebook.embed.normal_()
    return hf


def test_convert_encodec_matches_jax_converter(hf_model):
    """Every tensor of the port's converter equals JAX's converter's (in
    the port's layout), and the two cover the same keys."""
    sd = {k: v.detach() for k, v in hf_model.state_dict().items()}
    got = convert_encodec(sd, TINY)
    want = encodec_from_jax_params(_flat(jconvert_encodec(
        {k: v.numpy() for k, v in sd.items()}, JTINY)["params"]))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = EncodecModel(TINY)
    model.load_state_dict(got)


def test_converted_model_decodes_and_encodes_as_hf(hf_model):
    """HF's own decoder and encoder on the same weights: the waveform
    within 1e-5 (full and 2-codebook bandwidth), the codes exact."""
    model = EncodecModel(TINY)
    model.load_state_dict(convert_encodec(hf_model.state_dict(), TINY))
    model.eval()
    # 12 frames: no conv pads by its input's length, where HF zero-extends
    # and JAX reflects (ROADMAP C.2)
    wav = (0.2 * np.random.default_rng(7).standard_normal((2, 12 * TINY.hop_length))
           ).astype(np.float32)
    with torch.no_grad():
        for n_q in (TINY.num_quantizers, 2):
            codes = torch.from_numpy(_codes(n_q, 12, seed=10 + n_q))
            want = hf_model.decoder(hf_model.quantizer.decode(codes.transpose(0, 1)))
            torch.testing.assert_close(model.decode_codes(codes), want[:, 0],
                                       atol=WAV_TOL, rtol=0)
        emb = hf_model.encoder(torch.from_numpy(wav)[:, None, :])
        want_codes = hf_model.quantizer.encode(emb, bandwidth=None).transpose(0, 1)
        assert torch.equal(model.encode(torch.from_numpy(wav)), want_codes)


def test_hf_pads_ragged_and_short_inputs_otherwise(hf_model):
    """On HF's own weights the port (JAX's padding) and HF differ where a
    causal conv pads past its input: at 9 frames and 3 samples (JAX zeros
    the extra right pad, HF reflects it) and at 6 frames (the encoder's
    conv_out pads 6 on 6 frames: JAX reflects on, HF zero-extends first);
    at 12 frames they agree (ROADMAP C.2)."""
    model = EncodecModel(TINY)
    model.load_state_dict(convert_encodec(hf_model.state_dict(), TINY))
    diffs = {}
    with torch.no_grad():
        for n in (12 * TINY.hop_length, 9 * TINY.hop_length + 3, 6 * TINY.hop_length):
            wav = torch.from_numpy((0.2 * np.random.default_rng(n).standard_normal((1, n))
                                    ).astype(np.float32))[:, None, :]
            diffs[n] = (model.encoder(wav) - hf_model.encoder(wav)).abs().max().item()
    d12, d9, d6 = diffs.values()
    assert d12 < WAV_TOL and d9 > 1e-3 and d6 > 1e-3, diffs


def test_geometry_and_cuda_default(monkeypatch):
    """``encodec_24khz``'s hop 320 at 75 Hz and 32 codebooks; the init
    runs on the card unless the caller asks for the CPU."""
    cfg = encodec_24khz()
    assert cfg.hop_length == 320 and cfg.frame_rate == 75.0 and cfg.num_quantizers == 32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_encodec(TINY)
    model = init_encodec(TINY, device="cpu")
    with torch.no_grad():
        wav = model.decode_codes(torch.zeros((1, TINY.num_quantizers, 5), dtype=torch.int64))
        codes = model.encode(wav)
    assert wav.shape == (1, 5 * TINY.hop_length) and codes.shape == (1, TINY.num_quantizers, 5)
