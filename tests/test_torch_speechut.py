"""SpeechUT and Speech2C in the port, held against the JAX package.

At ``speechut_tiny`` and at ``speecht5_tiny`` under ``Speech2CModel``
(f32), on JAX's initial weights carried by ``utils/convert.
speechut_from_jax_params`` / ``speech2c_from_jax_params`` (strict loads):
every SpeechUT branch (speech with its HuBERT logits and mixing, masked
unit modeling, paired units -> text, the cached decode step against
teacher forcing), ``speechut_joint_loss`` and the Speech2C pretraining
loss with their metrics and gradients, ``forward_asr``, ``ASRDecoder`` on
both models (the whole token array, lengths and scores at beams 2-5 and
CTC weights 0 / 0.3, the decode-step kernel's twin on), the kernel flags'
twins against the plain route, the two pretraining recipes' first losses,
and the CPU rehearsals of ``chip_smoke.py``'s ``speechut`` and
``speech2c`` phases.  Draws are handed in as in
tests/test_torch_speechlm.py, whose helpers and tolerances these are.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import speecht5_tpu.config as JC
import speecht5_tpu.models.prenets as JPre
import speecht5_tpu.models.speechut as JSUT
from speecht5_tpu.decode.asr import ASRDecoder as JASRDecoder
from speecht5_tpu.models.speech2c import Speech2CModel as JS2C
from speecht5_tpu.train import criterions as JCr
from speecht5_tpu.train import joint as JJ

import torch

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.config as PC
import speecht5_tpu_torch.models.speechut as PSUT
from speecht5_tpu_torch.decode.asr import ASRDecoder
from speecht5_tpu_torch.models.speech2c import Speech2CModel, speech2c_pretrain_loss
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.recipes import speech2c_pretrain as R2C
from speecht5_tpu_torch.recipes import speechut_joint_pretrain as RUT
from speecht5_tpu_torch.train import joint as PJ
from speecht5_tpu_torch.utils.convert import (speech2c_from_jax_params,
                                              speechut_from_jax_params)

from test_torch_speechlm import (ATOL, LENS, RNGS, Draws, close, flat, frames,
                                 grads_close, japply, metrics_close, one_layer,
                                 patch_jax_draws, routes_close, speech_batch, t, unit_tokens)

KERNEL_FLAGS = ["speech_encoder.use_pallas_attn=True",
                "speech_encoder.use_pallas_attn_train=True",
                "unit_encoder.use_pallas_attn=True", "unit_encoder.use_pallas_attn_train=True",
                "decoder.use_pallas_attn=True", "conv_features.impl='pallas'"]
S2C_FLAGS = ["encoder.use_pallas_attn=True", "encoder.use_pallas_attn_train=True",
             "decoder.use_pallas_attn=True", "conv_features.impl='pallas'"]
PREV = np.array([[2, 7, 9, 11, 6], [2, 5, 8, 1, 1]], np.int32)
TGT = np.array([[7, 9, 11, 6, 2], [5, 8, 2, 1, 1]], np.int32)


@pytest.fixture
def draws(monkeypatch):
    d = Draws()
    patch_jax_draws(monkeypatch, JSUT, d)
    return d


def p_long(batch):
    return {k: t(v) if v.dtype == np.float32 else t(v).long() for k, v in batch.items()}


# ------------------------------------------------------------------- SpeechUT


@pytest.fixture(scope="module")
def sut():
    cfg = JSUT.speechut_tiny()
    wav, lens, units = speech_batch(cfg)
    variables = jax.jit(lambda: JSUT.SpeechUTModel(cfg).init(
        RNGS, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(units),
        jnp.asarray(PREV), method="init_all"))()
    return cfg, variables, port_speechut(variables)


def port_speechut(variables, overrides=()):
    model = PSUT.SpeechUTModel(PC.apply_overrides(PSUT.speechut_tiny(), list(overrides)))
    model.load_state_dict(speechut_from_jax_params(flat(variables["params"])), strict=True)
    return model.eval()


def test_speechut_branches_match_jax(sut, draws):
    """forward_speech (HuBERT logits, mixing, the unit encoder, CTC),
    forward_mum, forward_unit_text and decode_text."""
    cfg, variables, model = sut
    jm = JSUT.SpeechUTModel(cfg)
    wav, lens, units = speech_batch(cfg)
    T = units.shape[1]
    fl = frames(cfg, lens)
    masks = draws.port_masks(fl, T)
    toks = unit_tokens(cfg)

    def branches(m, w, n, u, k, p):
        return (m.encode_speech(w, n, mask=True, with_ctc=True, targets=u),
                m.forward_mum(k), m.forward_unit_text(k[:, :8], p))

    jout, jmum, jut = japply(jm, variables, jnp.asarray(wav), jnp.asarray(lens),
                             jnp.asarray(units), jnp.asarray(toks), jnp.asarray(PREV),
                             rngs=RNGS, method=branches)
    with torch.no_grad():
        out = model.encode_speech(t(wav), t(lens), mask=True, with_ctc=True,
                                  targets=t(units).long(), masks=masks,
                                  mix_sel=draws.port_mix(fl, T, masks[0]))
        mum = model.forward_mum(t(toks).long(), masks=draws.port_masks(
            (toks != cfg.pad_id).sum(-1), toks.shape[1]))
        ut = model.forward_unit_text(t(toks[:, :8]).long(), t(PREV).long())
    np.testing.assert_array_equal(out["time_mask"].numpy(), np.asarray(jout["time_mask"]))
    for k in ("encoder_out", "hubert_logits", "ctc_logits", "features_pen"):
        close(out[k], jout[k], msg=k)
    close(mum["mum_logits"], jmum["mum_logits"])
    np.testing.assert_array_equal(mum["time_mask"].numpy(), np.asarray(jmum["time_mask"]))
    for k in ("dec_logits", "ctc_logits"):
        close(ut[k], jut[k], msg=k)


def test_speechut_decode_step_matches_teacher_forcing(sut):
    """``text_decode_step`` (``_TextPrenet.step`` at pad_id + 1 + position)
    step by step equals ``decode_text`` on the same prefix, and JAX's."""
    cfg, variables, model = sut
    wav, lens, _ = speech_batch(cfg)
    prev = PREV[:, :3]                 # no padding in either row
    with torch.no_grad():
        enc = model.encode_speech(t(wav), t(lens))
        full = model.decode_text(enc, t(prev).long())
        cache = model.init_text_cache(enc, 2, 8)
        steps = []
        for i in range(prev.shape[1]):
            logits, cache = model.text_decode_step(t(prev[:, i : i + 1]).long(), cache,
                                                   enc_valid=enc["valid_mask"])
            steps.append(logits)
    close(torch.stack(steps, 1), full.numpy(), atol=1e-4)
    jm = JSUT.SpeechUTModel(cfg)
    jfull = japply(jm, variables, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(prev),
                   method=lambda m, w, n, p: m.decode_text(m.encode_speech(w, n), p))
    close(full, jfull)


def ut_batch(cfg):
    wav, lens, units = speech_batch(cfg)
    toks = unit_tokens(cfg)
    return {"speech": {"wav": wav, "wav_lengths": lens, "units": units},
            "text_paired": {"units": toks[:, :8], "prev_tokens": PREV, "targets": TGT},
            "text_mono": {"units": toks}}


def ut_draws(d: Draws, cfg, batch):
    sp = batch["speech"]
    T = sp["units"].shape[1]
    fl = frames(cfg, sp["wav_lengths"])
    masks = d.port_masks(fl, T)
    toks = batch["text_mono"]["units"]
    return {"speech": {"masks": masks, "mix_sel": d.port_mix(fl, T, masks[0])},
            "text_mono": {"masks": d.port_masks((toks != cfg.pad_id).sum(-1), toks.shape[1])}}


def test_speechut_joint_loss_and_gradients_match_jax(sut, draws):
    """Speech HuBERT + paired CE and CTC + mono MUM, each text term
    rescaled: loss, every metric, every gradient (one layer a stack)."""
    cfg, variables, ovs = one_layer(sut[0], sut[1],
                                    ("speech_encoder", "unit_encoder", "decoder"))
    jcfg = JJ.JointLossConfig(u2t_ed_weight=0.1, u2t_ctc_weight=0.2, text_mum_weight=0.5)
    batch = ut_batch(cfg)
    jfn = JJ.make_speechut_joint_loss(JSUT.SpeechUTModel(cfg), jcfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        variables["params"], jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(5))
    model = port_speechut(variables, ovs).train()
    pb = {k: p_long(v) for k, v in batch.items()}
    loss, m = PJ.speechut_joint_loss(model, pb, PJ.JointLossConfig(
        u2t_ed_weight=0.1, u2t_ctc_weight=0.2, text_mum_weight=0.5),
        draws=ut_draws(draws, cfg, batch))
    loss.backward()
    metrics_close(m, jm)
    assert {"text_dec_loss", "text_dec_acc", "text_ctc_loss", "mum_loss_m_0"} <= set(m)
    grads_close(model, speechut_from_jax_params(flat(jg)))


def test_speechut_kernel_flags_take_the_twins_on_the_cpu(sut, draws):
    cfg, variables, plain = sut
    kern = port_speechut(variables, KERNEL_FLAGS)
    batch = ut_batch(cfg)
    pb = {k: p_long(v) for k, v in batch.items()}
    K.reset_launch_counts()
    losses = []
    for model in (plain, kern):
        model.train()
        loss, _ = PJ.speechut_joint_loss(model, pb, PJ.JointLossConfig(u2t_ctc_weight=0.1),
                                         draws=ut_draws(draws, cfg, batch))
        loss.backward()
        losses.append(loss.item())
        model.eval()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    routes_close(kern, plain)
    assert sum(K.launch_counts().values()) == 0


def test_speechut_recipe_first_loss_matches_the_jax_loss_function(sut, draws):
    """``recipes/speechut_joint_pretrain`` on JAX's weights: its first
    update's loss is JAX ``make_speechut_joint_loss``'s on the loader's
    first joint batch (the recipe's loss weights, the draws handed in)."""
    cfg, variables, _ = sut
    loader = RUT.synthetic_loader(PSUT.speechut_tiny(), 1, "cpu")
    _, first = next(loader.iter_epoch(0))
    batch = {k: {kk: vv.numpy().astype(np.int32) if vv.dtype == torch.int64 else vv.numpy()
                 for kk, vv in v.items()} for k, v in first.items()}
    assert {k: v["units"].shape[0] for k, v in batch.items()} == {
        "speech": 2, "text_paired": 2, "text_mono": 2}
    jfn = JJ.make_speechut_joint_loss(JSUT.SpeechUTModel(cfg), JJ.JointLossConfig(
        u2t_ed_weight=0.1, u2t_ctc_weight=0.1, text_mum_weight=0.5))
    jloss, _ = jax.jit(jfn)(variables["params"], jax.tree_util.tree_map(jnp.asarray, batch),
                            jax.random.PRNGKey(0))
    d = ut_draws(draws, cfg, batch)
    out = RUT.run(steps=2, device="cpu", model=port_speechut(variables), loader=loader,
                  draws=[d, d], log=lambda s: None)
    np.testing.assert_allclose(out["losses"][0], float(jloss), rtol=2e-4)
    assert np.isfinite(out["losses"][1])


# ------------------------------------------------------------------- Speech2C


def s2c_wav(seed=0):
    wav = (np.random.default_rng(seed).standard_normal((2, 4000)) * 0.1).astype(np.float32)
    return wav, LENS


@pytest.fixture(scope="module")
def s2c():
    cfg = JC.speecht5_tiny()
    wav, lens = s2c_wav()
    variables = jax.jit(lambda: JS2C(cfg).init(
        RNGS, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(PREV),
        method="init_all"))()
    return cfg, variables, port_speech2c(variables)


def port_speech2c(variables, overrides=()):
    model = Speech2CModel(PC.apply_overrides(PC.speecht5_tiny(), list(overrides)))
    model.load_state_dict(speech2c_from_jax_params(flat(variables["params"])), strict=True)
    return model.eval()


@pytest.fixture
def prenet_draws(monkeypatch):
    d = Draws()

    def jmasks(rng, x, lengths, mask_emb, **kw):
        B, T, _ = x.shape
        tm = jnp.asarray(d.time_mask(B, T)) & (jnp.arange(T)[None, :] < lengths[:, None])
        return jnp.where(tm[:, :, None], mask_emb.astype(x.dtype)[None, None, :], x), tm

    monkeypatch.setattr(JPre, "apply_feature_masks", jmasks)
    return d


def jax_s2c_loss(cfg, variables, b, grads=True):
    """The JAX recipe's loss (recipes/speech2c_pretrain.py:88-101) and, with
    ``grads``, its gradients."""
    def loss_fn(p):
        out = JS2C(cfg).apply({"params": p}, b["wav"], b["wav_lengths"], b["prev_tokens"],
                              rngs={"mask": jax.random.PRNGKey(0)}, deterministic=False,
                              method="forward_pretrain")
        hub, _ = JCr.hubert_loss(out["hubert_logits"], [b["km_labels"]], out["time_mask"],
                                 out["valid_mask"])
        codes = b["decoder_targets"]
        dec, dec_nll = JCr.label_smoothed_ce(out["dec_logits"], codes, codes != cfg.pad_id,
                                             eps=0.0)
        return hub + dec, {"hubert": hub, "dec_ce": dec_nll}

    if not grads:
        return jax.jit(loss_fn)(variables["params"])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])


def test_speech2c_pretrain_loss_asr_and_gradients_match_jax(s2c, prenet_draws):
    cfg, variables, ovs = one_layer(s2c[0], s2c[1], ("encoder", "decoder"))
    wav, lens = s2c_wav()
    T = cfg.conv_features.out_length(wav.shape[1])
    km = np.random.default_rng(3).integers(0, 16, (2, T)).astype(np.int32)
    batch = {"wav": wav, "wav_lengths": lens, "km_labels": km, "decoder_targets": TGT,
             "prev_tokens": PREV}
    (jloss, jm), jg = jax_s2c_loss(cfg, variables, jax.tree_util.tree_map(jnp.asarray, batch))
    model = port_speech2c(variables, ovs).train()
    pb = p_long(batch)
    masks = prenet_draws.port_masks(frames(cfg, lens), T)
    out = model.forward_pretrain(pb["wav"], pb["wav_lengths"], pb["prev_tokens"], masks=masks)
    loss, m = speech2c_pretrain_loss(out, pb["km_labels"], pb["decoder_targets"], cfg.pad_id)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-4)
    metrics_close({k: v for k, v in m.items() if k != "loss"}, jm)
    grads_close(model, speech2c_from_jax_params(flat(jg)))
    model.zero_grad()
    model.eval()

    jl, jctc, jvalid = japply(JS2C(cfg), variables, jnp.asarray(wav), jnp.asarray(lens),
                              jnp.asarray(PREV), mask=False, deterministic=True,
                              method="forward_asr")
    with torch.no_grad():
        pl, pctc, pvalid = model.forward_asr(t(wav), t(lens), t(PREV).long(), mask=False)
    close(pl, jl)
    close(pctc, jctc)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))


def test_speech2c_recipe_first_loss_matches_the_jax_loss_function(s2c, prenet_draws):
    """``recipes/speech2c_pretrain``: its batch equals the JAX recipe's
    construction (:51-81), and ``--steps 2`` on JAX's weights gives as
    first loss the JAX recipe's loss function's."""
    cfg, variables, _ = s2c
    b = R2C.synthetic_batch(PC.speecht5_tiny(), 0)
    frames_ = cfg.conv_features.out_length(R2C.T_WAV)
    km = np.random.default_rng(0).integers(0, R2C.N_KM, (R2C.B, frames_)).astype(np.int32)
    np.testing.assert_array_equal(b["km_labels"], km)
    for r in range(R2C.B):
        out = [km[r, 0] + 4]
        for x in km[r, 1:] + 4:
            if x != out[-1]:
                out.append(x)
        out = (out + [cfg.eos_id])[:R2C.LC]
        np.testing.assert_array_equal(b["decoder_targets"][r, : len(out)], out)
        assert (b["decoder_targets"][r, len(out):] == cfg.pad_id).all()
        assert b["prev_tokens"][r, 0] == cfg.eos_id
        np.testing.assert_array_equal(b["prev_tokens"][r, 1:], b["decoder_targets"][r, :-1])
    jloss, _ = jax_s2c_loss(cfg, variables, jax.tree_util.tree_map(jnp.asarray, b),
                            grads=False)
    masks = prenet_draws.port_masks(frames(cfg, b["wav_lengths"]), frames_)
    out = R2C.run(steps=2, device="cpu", model=port_speech2c(variables), masks=[masks, masks],
                  log=lambda s: None)
    np.testing.assert_allclose(out["losses"][0], float(jloss), rtol=2e-4)
    assert out["losses"][1] < out["losses"][0]


# ------------------------------------------------------------------ decoding


def _audio(seed=1):
    wav = (np.random.default_rng(seed).standard_normal((2, 4000)) * 0.1).astype(np.float32)
    return wav, LENS


@pytest.mark.parametrize("family,beam,ctc_weight", [
    ("speechut", 2, 0.3), ("speech2c", 5, 0.0)])
def test_asr_decoder_on_the_families_matches_jax(sut, s2c, family, beam, ctc_weight):
    """The beam over SpeechUT (vocabulary 20, blank 4) and Speech2C at the
    ends of the beam range (2 and 5) and CTC weights 0.3 and 0: JAX's whole
    token array and lengths, scores within 1e-5; the port with the
    decode-step kernel's flag on (its twin on the CPU)."""
    if family == "speechut":
        cfg, variables, _ = sut
        jm, model = JSUT.SpeechUTModel(cfg), port_speechut(variables, ["decoder.use_pallas_attn=True"])
    else:
        cfg, variables, _ = s2c
        jm, model = JS2C(cfg), port_speech2c(variables, ["decoder.use_pallas_attn=True"])
    wav, lens = _audio()
    kw = dict(beam_size=beam, max_len=10, ctc_weight=ctc_weight, min_len=2)
    jres = JASRDecoder(jm, variables, **kw)(jnp.asarray(wav), jnp.asarray(lens))
    res = ASRDecoder(model, device="cpu", **kw)(wav, lens)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores), atol=1e-5,
                               rtol=1e-5)


def test_speech2c_kernel_flags_take_the_twins_on_the_cpu(s2c, prenet_draws):
    cfg, variables, plain = s2c
    kern = port_speech2c(variables, S2C_FLAGS)
    wav, lens = s2c_wav()
    T = cfg.conv_features.out_length(wav.shape[1])
    km = np.random.default_rng(3).integers(0, 16, (2, T))
    masks = prenet_draws.port_masks(frames(cfg, lens), T)
    K.reset_launch_counts()
    losses = []
    for model in (plain, kern):
        model.train()
        out = model.forward_pretrain(t(wav), t(lens), t(PREV).long(), masks=masks)
        loss, _ = speech2c_pretrain_loss(out, t(km), t(TGT).long(), cfg.pad_id)
        loss.backward()
        losses.append(loss.item())
        model.eval()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    routes_close(kern, plain)
    assert sum(K.launch_counts().values()) == 0


# ---------------------------------------------------------- smoke rehearsals


@pytest.mark.parametrize("phase", ["speechut", "speech2c", "siblings_parity"])
def test_chip_smoke_sibling_phases_run_on_cpu_with_twins(phase):
    """``chip_smoke.phase_<phase>`` at the tiny presets on the CPU: every
    branch and check of the phase, the twins in place of the kernels."""
    out = getattr(chip_smoke, f"phase_{phase}")(device="cpu", tiny=True)
    assert out["ok"], out
    assert sum(K.launch_counts().values()) == 0


def test_speechut_beam_takes_an_unk_penalty_that_jax_cannot(sut):
    """Reference fault (ROADMAP C.2): JAX's ``SpeechUTConfig`` has no
    ``unk_id``, so JAX's ``ASRDecoder`` with an unk penalty raises on
    SpeechUT; the port's config gives the fairseq dictionary's <unk> (3),
    and the penalty lowers every <unk> score of the beam's first step."""
    cfg, variables, _ = sut
    wav, lens = _audio()
    with pytest.raises(AttributeError, match="unk_id"):
        JASRDecoder(JSUT.SpeechUTModel(cfg), variables, beam_size=2, max_len=4,
                    unk_penalty=1.0)(jnp.asarray(wav), jnp.asarray(lens))
    model = port_speechut(variables)
    assert model.cfg.unk_id == 3
    kw = dict(beam_size=2, max_len=4, device="cpu")
    base = ASRDecoder(model, **kw)
    pen = ASRDecoder(model, unk_penalty=1e4, **kw)
    lp = torch.zeros(2, cfg.text_vocab_size)
    assert (pen._suppress(lp.clone())[:, 3] == -1e4).all()
    assert (base._suppress(lp.clone())[:, 3] == 0).all()
    res = pen(wav, lens)
    assert not (res.tokens == 3).any()
