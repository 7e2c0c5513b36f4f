"""The port's ``CodeHiFiGAN`` (the S2ST chain's unit vocoder) held against
the JAX package's (tests/test_hifigan.py::TestCodeHiFiGAN is the
specification), on JAX's weights carried by
``utils/convert.codehifigan_from_jax_params``.

Both arms: frame-level units (no duration predictor) and reduced units
re-expanded by the predicted durations, with a padded unit.  The duration
projection is scaled so that the durations spread over 1..max_duration
(clipped at both ends).  Tolerances: the predictor's log-durations 1e-5,
the durations and the expansion's indices exact, the waveform 1e-5
absolute (f32; TF32 off, JAX at ``highest``, tests/conftest.py).

``recipes/speech2s_s2st`` (the S2ST chain) against the JAX recipe's steps
on the same weights (JAX's SpeechUT init and unit vocoder, carried
across): its corpus bit-equal, 3 updates' unit losses within 1e-4
relative (optax ``adamw``), the beam's units equal on the updated weights,
and the vocoder's waveform on them within 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import optax

from speecht5_tpu.decode.asr import ASRDecoder as JASRDecoder
from speecht5_tpu.models.hifigan import (CodeHiFiGAN as JCodeHiFiGAN,
                                         CodeHiFiGANConfig as JCfg,
                                         HiFiGANConfig as JGen)
from speecht5_tpu.models.speechut import SpeechUTModel as JSpeechUT, speechut_tiny as jsut_tiny

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.models.hifigan import (CodeHiFiGAN, CodeHiFiGANConfig,
                                               HiFiGANConfig, expand_index,
                                               init_codehifigan)
from speecht5_tpu_torch.models.speechut import SpeechUTModel
from speecht5_tpu_torch.recipes import speech2s_s2st as R
from speecht5_tpu_torch.utils.convert import (codehifigan_from_jax_params,
                                              speechut_from_jax_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
WAV_TOL = 1e-5
DUR_F_TOL = 1e-5
GEN = dict(in_dim=16, upsample_initial_channel=32, upsample_rates=(4, 2),
           upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
           resblock_dilations=((1, 3),), normalize_before=False)
CODE = dict(num_units=12, embed_dim=16, max_duration=3)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _pair(dur):
    """The JAX module and variables (the duration projection scaled: its
    log-durations spread wide, both clips reached) and the port's module on the
    same weights."""
    jm = JCodeHiFiGAN(JCfg(**CODE, dur_predictor=dur, generator=JGen(**GEN)))
    u = jnp.zeros((1, 4), jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), u)["params"])
    if dur:
        params["dur_proj"]["kernel"] = params["dur_proj"]["kernel"] * 30.0
        params["dur_proj"]["bias"] = np.full((1,), 0.7, np.float32)
    model = CodeHiFiGAN(CodeHiFiGANConfig(**CODE, dur_predictor=dur,
                                          generator=HiFiGANConfig(**GEN)))
    model.load_state_dict(codehifigan_from_jax_params(_flat(params)))
    return jm, {"params": params}, model.eval()


def _units(seed=0):
    rng = np.random.default_rng(seed)
    units = rng.integers(0, CODE["num_units"], (2, 7))
    valid = np.ones((2, 7), bool)
    valid[1, 5:] = False
    return units, valid


@pytest.mark.parametrize("dur", [False, True])
def test_waveform_matches_jax(dur):
    """Both arms, a padded row: the waveform within 1e-5 of JAX's, of
    length T * hop (T * max_duration * hop with the predictor)."""
    jm, variables, model = _pair(dur)
    units, valid = _units()
    want = np.asarray(jm.apply(variables, jnp.asarray(units), jnp.asarray(valid)))
    with torch.no_grad():
        got = model(torch.from_numpy(units), torch.from_numpy(valid)).numpy()
    T_out = units.shape[1] * (CODE["max_duration"] if dur else 1)
    assert got.shape == want.shape == (2, T_out * 8)
    np.testing.assert_allclose(got, want, atol=WAV_TOL)


def test_durations_and_expansion_indices_exact():
    """The predictor's log-durations (1e-5), its clipped, half-to-even
    rounded durations and the cumsum gather's indices and valid slots
    (exact) against JAX's formula on JAX's own log-durations (captured
    from its ``dur_proj``)."""
    jm, variables, model = _pair(True)
    units, valid = _units(3)
    _, state = jm.apply(variables, jnp.asarray(units), jnp.asarray(valid),
                        capture_intermediates=True, mutable=["intermediates"])
    jdur_f = np.asarray(state["intermediates"]["dur_proj"]["__call__"][0])[..., 0]
    jdur = jnp.where(jnp.asarray(valid), jnp.clip(jnp.round(jnp.exp(jdur_f)).astype(
        jnp.int32), 1, CODE["max_duration"]), 0)
    ends = jnp.cumsum(jdur, axis=1)
    pos = jnp.arange(units.shape[1] * CODE["max_duration"])[None, :]
    jidx = jnp.minimum((pos[:, :, None] >= ends[:, None, :]).sum(-1), units.shape[1] - 1)
    with torch.no_grad():
        x = model.unit_embed(torch.from_numpy(units))
        dur_f, dur = model.durations(x, torch.from_numpy(valid))
    np.testing.assert_allclose(dur_f.numpy(), jdur_f, atol=DUR_F_TOL)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jdur))
    assert set(np.asarray(jdur)[valid].tolist()) == {1, 2, 3}     # both clips reached
    idx, out_valid = expand_index(dur, CODE["max_duration"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(out_valid.numpy(), np.asarray(pos < ends[:, -1:]))


def test_padding_units_reach_the_durations_as_in_jax():
    """Without the predictor a padded unit's id leaves the waveform as it
    was (tests/test_hifigan.py:236).  With it, the padded unit's embedding
    reaches its valid neighbours' durations through the predictor's two
    k 3 convs (JAX masks the embeddings only after the expansion; ROADMAP
    C.2): here the last valid unit of row 1 takes 2 frames next to padded
    id 0 and 1 frame next to padded id 1, in JAX as in the port (the
    waveform within 1e-5 of JAX's for both)."""
    units, valid = _units()
    pads = []
    for p in (0, 1):
        u = units.copy()
        u[1, 6] = p
        pads.append(u)
    _, _, plain = _pair(False)
    with torch.no_grad():
        a, b = (plain(torch.from_numpy(u), torch.from_numpy(valid)) for u in pads)
    assert torch.equal(a, b)
    jm, variables, model = _pair(True)
    durs = []
    for u in pads:
        want = np.asarray(jm.apply(variables, jnp.asarray(u), jnp.asarray(valid)))
        with torch.no_grad():
            got = model(torch.from_numpy(u), torch.from_numpy(valid)).numpy()
            durs.append(model.durations(model.unit_embed(torch.from_numpy(u)),
                                        torch.from_numpy(valid))[1][1].tolist())
        np.testing.assert_allclose(got, want, atol=WAV_TOL)
    assert durs[0][:4] == durs[1][:4] and (durs[0][4], durs[1][4]) == (2, 1)


def test_init_defaults_to_cuda_and_runs_on_the_cpu(monkeypatch):
    """``init_codehifigan`` runs on the card unless the caller asks for
    the CPU, and refuses without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CodeHiFiGANConfig(**CODE, dur_predictor=True, generator=HiFiGANConfig(**GEN))
    with pytest.raises(RuntimeError, match="cuda"):
        init_codehifigan(cfg)
    voc = init_codehifigan(cfg, device="cpu")
    with torch.no_grad():
        wav = voc(torch.zeros((1, 5), dtype=torch.int64))
    assert wav.shape == (1, 5 * 3 * 8) and torch.isfinite(wav).all()


def _jax_chain(steps):
    """The JAX recipe's model, init and ``steps`` optax updates
    (recipes/speech2s_s2st.py:56-108) -> (the corpus, the initial and the
    updated variables, the losses, the JAX beam's units on the updated
    weights, the JAX vocoder and its variables)."""
    cfg = jsut_tiny(text_vocab_size=R.UNIT0 + R.N_UNITS)
    model = JSpeechUT(cfg)
    corpus = R.phone_corpus(cfg.eos_id, seed=0)
    wav = jnp.asarray(corpus["wav"])
    wlen = jnp.full((R.B,), corpus["wav"].shape[1], jnp.int32)
    prev, tgt = jnp.asarray(corpus["prev_tokens"]), jnp.asarray(corpus["targets"])
    frames = jnp.full((R.B, int(cfg.conv_features.out_length(wav.shape[1]))), 4, jnp.int32)
    init = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0),
                                       "mask": jax.random.PRNGKey(1),
                                       "mix": jax.random.PRNGKey(2)},
                                      wav, wlen, frames, prev, method="init_all"))()

    def loss_fn(p):
        enc = model.apply({"params": p}, wav, wlen, method="encode_speech")
        logits = model.apply({"params": p}, enc, prev, method="decode_text")
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(lp, tgt[..., None], -1)[..., 0].mean()

    tx = optax.adamw(R.LR)

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(loss_fn)(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    params, opt, losses = init["params"], tx.init(init["params"]), []
    for _ in range(steps):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
    res = JASRDecoder(model, {"params": params}, beam_size=2, max_len=R.LP + 2)(wav, wlen)
    toks, lens = np.asarray(res.tokens)[:, 0], np.asarray(res.lengths)[:, 0]
    units = [toks[b, 1:lens[b] - 1].tolist() for b in range(R.B)]
    jvoc = JCodeHiFiGAN(JCfg(num_units=R.UNIT0 + R.N_UNITS, embed_dim=32, dur_predictor=True,
                             max_duration=4, generator=JGen(
                                 in_dim=32, upsample_initial_channel=64,
                                 upsample_rates=(5, 4, 4, 4),
                                 upsample_kernel_sizes=(11, 8, 8, 8),
                                 resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
                                 normalize_before=False)))
    u = jnp.asarray([units[0]], jnp.int32)
    voc_vars = jvoc.init(jax.random.PRNGKey(2), u)
    return corpus, init, params, losses, units, jvoc, voc_vars


def test_s2st_recipe_equals_the_jax_chain():
    steps = 3
    corpus, init, params, want_losses, want_units, jvoc, voc_vars = _jax_chain(steps)
    cfg = R.tiny_config()
    model = SpeechUTModel(cfg)
    model.load_state_dict(speechut_from_jax_params(_flat(init["params"])))
    vocoder = CodeHiFiGAN(R.vocoder_config())
    vocoder.load_state_dict(codehifigan_from_jax_params(_flat(voc_vars["params"])))
    out = R.run(cfg, steps=steps, device="cpu", model=model, vocoder=vocoder.eval(),
                log=lambda s: None)
    np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-4)
    # the beam and the vocoder on JAX's updated weights: exactly JAX's units
    model.load_state_dict(speechut_from_jax_params(_flat(params)))
    units, _, _ = R.decode_units(model.eval(), torch.from_numpy(corpus["wav"]),
                              torch.full((R.B,), corpus["wav"].shape[1]), device="cpu")
    assert units == want_units
    want_wav = np.asarray(jvoc.apply(voc_vars, jnp.asarray([want_units[0]], jnp.int32)))
    with torch.no_grad():
        wav = vocoder(torch.tensor([units[0]]))
    np.testing.assert_allclose(wav.numpy(), want_wav, atol=WAV_TOL)


def test_s2st_recipe_main_runs_on_the_cpu(tmp_path, capsys):
    R.main(["--steps", "2", "--device", "cpu", "--out", str(tmp_path / "s2st.wav")])
    assert '"done": true' in capsys.readouterr().out and (tmp_path / "s2st.wav").exists()


def test_s2st_chain_sends_unsuppressed_special_ids_to_the_vocoder():
    """The beam suppresses pad and <ctc_blank> only (``ASRDecoder``), and
    the chain hands the best hypothesis' ids to the vocoder as they are
    (JAX recipes/speech2s_s2st.py:116-128: no shift from decoder ids to
    units).  With the output projection at 0 every id ties, the lowest
    unsuppressed one wins each step (<s>, 0) and never eos, so the "units"
    are specials, which the vocoder embeds as units (ROADMAP C.2)."""
    from speecht5_tpu_torch.models.speechut import init_speechut

    cfg = R.tiny_config()
    model = init_speechut(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        model.output_projection.weight.zero_()
    wav = torch.from_numpy(R.phone_corpus(cfg.eos_id)["wav"][:1])
    units, _, _ = R.decode_units(model, wav, torch.tensor([wav.shape[1]]), device="cpu")
    assert units[0] and set(units[0]) == {0}
    vocoder = init_codehifigan(R.vocoder_config(), device="cpu")
    with torch.no_grad():
        out = vocoder(torch.tensor(units[:1]))
    assert torch.isfinite(out).all() and out.abs().max() > 0
