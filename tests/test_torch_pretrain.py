"""Speech and joint pretraining in the port, held against the JAX package.

The Large-shaped tiny preset of tests/test_torch_large.py (both stacks
pre-LN, the ``layer_norm`` conv extractor, the quantizer on) crosses from
JAX into the port with every sub-net.  Held here: ``cosine_logits``, the
HuBERT head, the Gumbel quantizer at eval and on a training pass with the
noise handed in, the three losses, ``forward_pretrain_speech`` /
``forward_pretrain_text`` with their losses and gradients on both
attention routes, three ``Trainer`` updates of each pretraining task
against JAX ``make_train_step``, BART noising and both datasets'
collation, and ``cli/train.main --task pretrain_speech|pretrain`` on the
CPU with a resume.

The two frameworks cannot draw the same random numbers, so both are handed
the same draws: the HuBERT time masks (JAX's ``apply_feature_masks`` and
the port's ``sample_feature_masks`` replaced by a seeded mask, cut to the
lengths on both sides), the Gumbel noise (the uniform draw of JAX's
quantizer and the port's ``gumbel_noise``) and the codebook permutation
(JAX's ``jax.random.permutation`` in the model module and the port's
``codebook_perm``).  The Tacotron prenet and postnet dropout are off.
Tolerances are those of tests/test_torch_s2t_train.py: activations 2e-4
absolute, losses 2e-4 relative, gradients within 2e-4 of each parameter's
max |g| (the analytically zero k_proj and norm_k biases within 1e-6 of the
largest), parameters after 3 updates within 1e-5; numpy data bit-equal.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import speecht5_tpu.config as JC
import speecht5_tpu.models.prenets as JPre
import speecht5_tpu.models.quantizer as JQmod
import speecht5_tpu.models.speecht5 as JSmod
from speecht5_tpu.data import manifests as JMan
from speecht5_tpu.data import text_noising as JTN
from speecht5_tpu.data.dictionary import load_cli_dictionary as jload_dict
from speecht5_tpu.models.postnets import SpeechEncoderPostnet as JHead
from speecht5_tpu.models.quantizer import GumbelVectorQuantizer as JQuantizer
from speecht5_tpu.ops.heads import cosine_logits as jcosine
from speecht5_tpu.train import criterions as JCr
from speecht5_tpu.train import trainer as JT

import torch

import chip_smoke
import speecht5_tpu_torch.models.prenets as PPre
import speecht5_tpu_torch.models.quantizer as PQmod
import speecht5_tpu_torch.models.speecht5 as PSmod
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.data import manifests as PMan
from speecht5_tpu_torch.data import text_noising as PTN
from speecht5_tpu_torch.data.dictionary import load_cli_dictionary
from speecht5_tpu_torch.models.postnets import SpeechEncoderPostnet
from speecht5_tpu_torch.models.quantizer import GumbelVectorQuantizer
from speecht5_tpu_torch.ops.heads import cosine_logits
from speecht5_tpu_torch.train import criterions as PCr
from speecht5_tpu_torch.train import trainer as PT
from speecht5_tpu_torch.utils.convert import from_jax_params

from test_torch_large import (B, KERNEL_ROUTE, LARGE_SHAPED, STILL, T_WAV, flat,
                              grads_close, jax_grads, port_grads, setup_models)

ATOL, RTOL = 2e-4, 2e-4
N_MELS_R = 5          # r-thinned decoder frames of the speech batches
ONE_LAYER = ["encoder.num_layers=1", "decoder.num_layers=1"]
_JAX = {}             # JAX's results, shared by the two routes' cases


class Draws:
    """The random draws handed to both packages, each seeded by what it is
    and its shape: the uniform of the Gumbel noise, the codebook
    permutation and the HuBERT time mask (before its cut to the lengths)."""

    @staticmethod
    def _rng(kind, *shape):
        return np.random.default_rng([kind, *(int(s) for s in shape)])

    def uniform(self, shape):
        return self._rng(1, *shape).uniform(1e-9, 1.0, tuple(shape)).astype(np.float32)

    def perm(self, T):
        return self._rng(2, T).permutation(int(T))

    def time_mask(self, B, T):
        return self._rng(3, B, T).random((B, T)) < 0.4


class _JaxProxy:
    """``jax`` with some ``jax.random`` functions replaced."""

    def __init__(self, **random):
        self.random = types.SimpleNamespace(**{**vars(jax.random), **random})

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def draws(monkeypatch):
    """Hand the same draws to both packages (module attributes replaced for
    the test)."""
    d = Draws()

    def jmasks(rng, x, lengths, mask_emb, **kw):
        B, T, _ = x.shape
        tm = jnp.asarray(d.time_mask(B, T)) & (jnp.arange(T)[None, :] < lengths[:, None])
        return jnp.where(tm[:, :, None], mask_emb.astype(x.dtype)[None, None, :], x), tm

    def pmasks(lengths, T, C, masking, generator=None):
        lengths = torch.as_tensor(lengths)
        tm = torch.from_numpy(d.time_mask(len(lengths), T))
        return tm & (torch.arange(T)[None, :] < lengths[:, None]), None

    monkeypatch.setattr(JPre, "apply_feature_masks", jmasks)
    monkeypatch.setattr(JQmod, "jax", _JaxProxy(
        uniform=lambda key, shape, minval=0.0, maxval=1.0, **kw: jnp.asarray(d.uniform(shape))))
    monkeypatch.setattr(JSmod, "jax", _JaxProxy(
        permutation=lambda key, n, **kw: jnp.asarray(d.perm(n))))
    monkeypatch.setattr(PPre, "sample_feature_masks", pmasks)
    monkeypatch.setattr(PQmod, "gumbel_noise", lambda shape, generator=None, device=None: (
        -torch.log(-torch.log(torch.from_numpy(d.uniform(shape))))).to(device))
    monkeypatch.setattr(PSmod, "codebook_perm",
                        lambda T, generator=None: torch.from_numpy(d.perm(T)))
    return d


@pytest.fixture(scope="module", params=["plain", "kernel"])
def both_routes(request):
    return request.param, setup_models(KERNEL_ROUTE if request.param == "kernel" else ())


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def pretrain_speech_batch(cfg, seed=0):
    """A host-mel pretrain_speech batch (tiny: 20 mels, r 2)."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((B, T_WAV)) * 0.1).astype(np.float32)
    lens = np.array([T_WAV, 2600], np.int32)
    frames = int(cfg.conv_features.out_length(T_WAV))
    Fm = 2 * N_MELS_R
    dec = np.array([Fm, Fm - 4], np.int32)
    target = rng.standard_normal((B, Fm, cfg.n_mels)).astype(np.float32)
    target[1, dec[1]:] = 0.0
    prev = np.zeros((B, N_MELS_R, cfg.n_mels), np.float32)
    prev[:, 1:] = target[:, 1::2][:, :-1]
    prev[1, dec[1] // 2:] = 0.0
    return {"wav": wav, "wav_lengths": lens,
            "km_labels": rng.integers(0, cfg.hubert.num_classes[0], (B, frames)),
            "target_mel": target, "prev_mel": prev, "dec_lengths": dec,
            "dec_lengths_r": dec // 2,
            "spkembs": rng.standard_normal((B, cfg.spk_embed_dim)).astype(np.float32)}


def pretrain_text_batch(cfg, seed=0, T=9):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(4, cfg.vocab_size - 2, (B, T))
    tgt[:, 0], tgt[0, -1] = 0, 2
    tgt[1, 6], tgt[1, 7:] = 2, 1
    prev = np.full((B, T), 1)
    prev[:, 0] = 2
    prev[0, 1:] = tgt[0, :-1]
    prev[1, 1:7] = tgt[1, :6]
    src = tgt.copy()
    src[:, 3] = cfg.vocab_size - 2          # a <mask>
    return {"tokens": src, "prev_tokens": prev, "targets": tgt}


def test_cosine_logits_and_the_hubert_head_match_jax():
    cfg = JC.speecht5_tiny(hubert=JC.HubertHeadConfig(final_dim=24, num_classes=(16, 9)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    embs = rng.standard_normal((16, 24)).astype(np.float32)
    x[0, 0] = 0.0                            # a zero row: the eps clamp
    np.testing.assert_allclose(cosine_logits(torch.from_numpy(x), torch.from_numpy(embs),
                                             0.1).numpy(),
                               np.asarray(jcosine(x, embs, 0.1)), atol=ATOL)
    h = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    for untie in (True, False):
        c = JC.replace(cfg, hubert=JC.replace(cfg.hubert, untie_final_proj=untie))
        jh = JHead(c)
        v = jh.init(jax.random.PRNGKey(1), jnp.asarray(h))
        head = SpeechEncoderPostnet(c)
        head.load_state_dict({k.split(".", 1)[1]: t for k, t in from_jax_params(
            {f"speech_encoder_postnet/{k}": a for k, a in flat(v["params"]).items()}).items()})
        want = jh.apply(v, jnp.asarray(h))
        got = head(torch.from_numpy(h))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)


def test_quantizer_matches_jax_at_eval_and_with_the_noise_handed_in(draws):
    """Eval: argmax codes; training pass: the hard Gumbel softmax at the
    temperature of update 1000 with the same uniform draw, its
    straight-through gradients; both perplexities."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jq = JQuantizer(dim=32, num_vars=10, groups=2, vq_dim=32, temp=(2.0, 0.5, 0.999))
    v = jq.init(jax.random.PRNGKey(2), jnp.asarray(x))
    q = GumbelVectorQuantizer(32, 10, 2, 32, (2.0, 0.5, 0.999))
    q.load_state_dict({k.split(".", 1)[1]: t for k, t in from_jax_params(
        {f"quantizer/{k}": a for k, a in flat(v["params"]).items()}).items()})
    w = rng.standard_normal((2, 6, 32)).astype(np.float32)
    for train in (False, True):
        def jrun(p, xx):
            out = jq.apply({"params": p}, xx, num_updates=1000, deterministic=not train,
                           rngs={"gumbel": jax.random.PRNGKey(0)})
            return (out["x"] * w).sum() + out["prob_perplexity"], out

        (_, want), (gp, gx) = jax.value_and_grad(jrun, argnums=(0, 1), has_aux=True)(
            v["params"], jnp.asarray(x))
        q.train(train)
        q.zero_grad()
        xt = torch.from_numpy(x).requires_grad_()
        got = q(xt, num_updates=1000)
        assert got["temp"] == pytest.approx(max(2.0 * 0.999 ** 1000, 0.5))
        np.testing.assert_allclose(got["x"].detach().numpy(), np.asarray(want["x"]), atol=ATOL)
        for k in ("prob_perplexity", "code_perplexity"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)
        assert got["num_vars"] == want["num_vars"] == 20.0
        ((got["x"] * torch.from_numpy(w)).sum() + got["prob_perplexity"]).backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=2e-4 * np.abs(np.asarray(gx)).max())
        want_g = {k.split(".", 1)[1]: t.numpy() for k, t in
                  from_jax_params({f"quantizer/{k}": a for k, a in flat(gp).items()}).items()}
        grads_close({n: p.grad.numpy() for n, p in q.named_parameters()}, want_g)


def test_the_three_pretraining_losses_match_jax():
    rng = np.random.default_rng(4)
    T, C = 11, 16
    logits = [rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(2)]
    targets = [rng.integers(0, C, (B, T)) for _ in range(2)]
    tm = rng.random((B, T)) < 0.5
    valid = np.arange(T)[None, :] < np.array([T, 8])[:, None]
    loss, m = PCr.hubert_loss([torch.from_numpy(a) for a in logits],
                              [torch.from_numpy(a) for a in targets],
                              torch.from_numpy(tm), torch.from_numpy(valid),
                              pred_nomask_weight=0.5)
    jloss, jm = JCr.hubert_loss(logits, targets, jnp.asarray(tm), jnp.asarray(valid),
                                pred_nomask_weight=0.5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL, err_msg=k)

    Fm, n_mels = 8, 6
    q = {"prob_perplexity": np.float32(17.5), "code_perplexity": np.float32(12.0),
         "num_vars": 20.0}
    out = {"hubert_logits": logits[:1], "time_mask": tm, "valid_mask": valid,
           "features_pen": np.float32(0.37), "quantizer": q,
           "before": rng.standard_normal((B, Fm, n_mels)).astype(np.float32),
           "after": rng.standard_normal((B, Fm, n_mels)).astype(np.float32),
           "stop_logits": rng.standard_normal((B, Fm)).astype(np.float32),
           "attn": rng.random((2, B, 4, Fm // 2, T)).astype(np.float32)}
    target_mel = rng.standard_normal((B, Fm, n_mels)).astype(np.float32)
    dec, enc = np.array([Fm, 6], np.int32), np.array([T, 8], np.int32)
    conv = lambda v: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
                      else torch.tensor(v) if isinstance(v, np.floating) else v)
    pout = {k: ([conv(a) for a in v] if isinstance(v, list) else
                {kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict) else conv(v))
            for k, v in out.items()}
    loss, m = PCr.speech_pretrain_loss(pout, [torch.from_numpy(targets[0])],
                                       torch.from_numpy(target_mel), torch.from_numpy(dec),
                                       torch.from_numpy(enc))
    jloss, jm = JCr.speech_pretrain_loss(out, targets[:1], target_mel, dec, enc)
    assert set(m) == set(jm) and "dec_enc_dec_attn_loss" in m
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL, err_msg=k)

    tlogits = rng.standard_normal((B, 9, 30)).astype(np.float32)
    ttgt = rng.integers(0, 30, (B, 9))
    ttgt[1, 6:] = 1
    loss, m = PCr.text_pretrain_loss({"logits": torch.from_numpy(tlogits),
                                      "quantizer": pout["quantizer"]},
                                     torch.from_numpy(ttgt), 1)
    jloss, jm = JCr.text_pretrain_loss({"logits": tlogits, "quantizer": q}, ttgt, 1)
    assert set(m) == set(jm)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)


def test_pretrain_forwards_losses_and_gradients_match_jax(both_routes, draws):
    """forward_pretrain_speech (masks, Gumbel noise and codebook
    permutation handed in) and forward_pretrain_text, each through its
    loss, on a training pass: outputs, losses and every gradient (the
    HuBERT head, the quantizer, norm_k and the table included), on the
    plain and the kernel route; the BatchNorm statistics moved alike."""
    route, (jcfg, jm, variables, model) = both_routes
    sb, tb = pretrain_speech_batch(jcfg), pretrain_text_batch(jcfg)
    rngs = {n: jax.random.PRNGKey(i) for i, n in enumerate(
        ("dropout", "mask", "layerdrop", "prenet", "codebook", "gumbel"))}

    def jspeech(p):
        out, upd = jm.apply({**variables, "params": p}, *(jnp.asarray(sb[k]) for k in (
            "wav", "wav_lengths", "prev_mel", "dec_lengths_r", "spkembs")),
            num_updates=3, deterministic=False, rngs=rngs, mutable=["batch_stats"],
            method="forward_pretrain_speech")
        loss, m = JCr.speech_pretrain_loss(
            out, [jnp.asarray(sb["km_labels"])], sb["target_mel"], sb["dec_lengths"],
            out["valid_mask"].sum(-1), reduction_factor=2)
        return loss, (out, m, upd)

    def jtext(p):
        out = jm.apply({**variables, "params": p}, jnp.asarray(tb["tokens"]),
                       jnp.asarray(tb["prev_tokens"]), num_updates=3, deterministic=False,
                       rngs=rngs, method="forward_pretrain_text")
        loss, m = JCr.text_pretrain_loss(out, jnp.asarray(tb["targets"]), jcfg.pad_id)
        return loss, (out, m)

    if not _JAX:
        _JAX["speech"] = jax.jit(jax.value_and_grad(jspeech, has_aux=True))(
            variables["params"])
        _JAX["text"] = jax.jit(jax.value_and_grad(jtext, has_aux=True))(
            variables["params"])
    (jl, (jout, jmet, jupd)), jg = _JAX["speech"]
    (jtl, (jtout, jtmet)), jtg = _JAX["text"]

    model.train()
    stats0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    model.zero_grad(set_to_none=True)
    b = _t(sb)
    out = model.forward_pretrain_speech(b["wav"], b["wav_lengths"], b["prev_mel"],
                                        b["dec_lengths_r"], b["spkembs"], num_updates=3)
    loss, met = PCr.speech_pretrain_loss(out, [b["km_labels"]], b["target_mel"],
                                         b["dec_lengths"], out["valid_mask"].sum(-1))
    assert out["time_mask"].any() and out["quantizer"] is not None
    np.testing.assert_array_equal(out["time_mask"].numpy(), np.asarray(jout["time_mask"]))
    np.testing.assert_allclose(out["hubert_logits"][0].detach().numpy(),
                               np.asarray(jout["hubert_logits"][0]), atol=ATOL)
    for k in ("before", "after", "stop_logits"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=RTOL, err_msg=k)
    loss.backward()
    want = jax_grads(jg)
    assert "quantizer.weight_proj.weight" in want and "encoder.layers.0.norm_k.weight" in want
    grads_close(port_grads(model), want)
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    want_stats = chip_smoke_stats(jupd)
    for k, v in want_stats.items():
        np.testing.assert_allclose(stats[k].numpy(), v, atol=1e-5, err_msg=k)
    model.load_state_dict({**model.state_dict(), **stats0})

    model.zero_grad(set_to_none=True)
    tt = _t(tb)
    tout = model.forward_pretrain_text(tt["tokens"], tt["prev_tokens"], num_updates=3)
    tloss, tmet = PCr.text_pretrain_loss(tout, tt["targets"], jcfg.pad_id)
    np.testing.assert_allclose(tout["logits"].detach().numpy(), np.asarray(jtout["logits"]),
                               atol=ATOL)
    np.testing.assert_allclose(float(tloss), float(jtl), rtol=RTOL)
    tloss.backward()
    grads_close(port_grads(model), jax_grads(jtg))
    model.zero_grad(set_to_none=True)


def chip_smoke_stats(upd):
    from speecht5_tpu_torch.utils.convert import from_jax_batch_stats

    return {k: v.numpy() for k, v in from_jax_batch_stats(
        flat(upd["batch_stats"])).items()}


@pytest.mark.parametrize("task", ["pretrain_speech", "pretrain_text"])
def test_trainer_three_pretrain_updates_match_jax_train_step(task, draws):
    """Three updates (the clip active, the temperature moving with the
    update count) against make_train_step: grad norms and parameters.  One
    layer a stack, which keeps JAX's compile short."""
    jcfg, jm, variables, model = setup_models(ONE_LAYER)
    make = pretrain_speech_batch if task == "pretrain_speech" else pretrain_text_batch
    batches = [make(jcfg, seed=10 + u) for u in range(3)]
    kw = dict(lr=1e-4, warmup_steps=2, clip_norm=1.0, adam_eps=1e-4)
    tcfg = JT.TrainConfig(**kw)
    params = variables["params"]
    state = JT.TrainState(params, JT.make_optimizer(tcfg).init(params),
                          jnp.zeros((), jnp.int32), {"batch_stats": variables["batch_stats"]})
    step = jax.jit(JT.make_train_step(jm, task, tcfg))
    jnorms = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        jnorms.append(float(m["grad_norm"]))
    trainer = PT.Trainer(model, ["pretrain_speech", "pretrain_text"], PT.TrainConfig(**kw))
    norms = [float(trainer.train_step([_t(b)], task)["grad_norm"]) for b in batches]
    assert trainer.step == 3 and min(norms) > 1.0
    np.testing.assert_allclose(norms, jnorms, rtol=RTOL)
    got = model.state_dict()
    for name, w in from_jax_params(flat(state.params)).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def _corpus(tmp_path, n=6, seconds=(0.3, 0.8), seed=0):
    """A speech manifest with 50 Hz km labels (16 classes), a text corpus
    and the letter dictionary."""
    d = str(tmp_path)
    manifest, _, dict_path = chip_smoke.write_corpus(d, n, seconds=seconds, seed=seed)
    rng = np.random.default_rng(seed)
    with open(manifest, encoding="utf-8") as f:
        sizes = [int(l.split("\t")[1]) for l in f.read().splitlines()[1:] if l]
    km = tmp_path / "train.km"
    km.write_text("".join(" ".join(map(str, rng.integers(0, 16, n_s * 50 // 16000))) + "\n"
                          for n_s in sizes))
    text = tmp_path / "text.txt"
    text.write_text("".join(f"HELLO WORLD NUMBER {i} OF THE CORPUS\n" for i in range(12)))
    return manifest, str(km), str(text), dict_path


def test_noising_and_both_datasets_collate_bit_equal_to_jax(tmp_path):
    manifest, km, text, dict_path = _corpus(tmp_path)
    cfg = JTN.NoisingConfig(insert_ratio=0.1, rotate_ratio=0.5)
    toks = np.arange(4, 40)
    for seed in range(5):
        for c in (JTN.NoisingConfig(), cfg):
            a, b = JTN.noise_tokens(toks, c, 79, 81, seed), PTN.noise_tokens(
                toks, PTN.NoisingConfig(**vars(c)), 79, 81, seed)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    jd, _ = jload_dict(dict_path)
    pd, _ = load_cli_dictionary(dict_path)
    kw = dict(tokens_per_sample=16, mask_id=pd.index("<mask>"), seed=3)
    for mode in ("none", "complete", "eos"):
        j = JMan.TextPretrainDataset(text_file=text, dictionary=jd, break_mode=mode, **kw)
        p = PMan.TextPretrainDataset(text_file=text, dictionary=pd, break_mode=mode, **kw)
        assert np.array_equal(j.sizes, p.sizes) and len(p) > 3
        for epoch in (0, 1):
            jb = j.collate([j[i] for i in range(3)], epoch=epoch)
            pb = p.collate([p[i] for i in range(3)], epoch=epoch)
            assert set(jb) == set(pb)
            assert all(np.array_equal(jb[k], pb[k]) for k in jb)
    frames = JC.speecht5_tiny().conv_features.out_length
    for device_mel in (False, True):
        j = JMan.SpeechPretrainDataset(manifest=manifest, km_labels=km, n_mels=20,
                                       device_mel=device_mel)
        p = PMan.SpeechPretrainDataset(manifest=manifest, km_labels=km, n_mels=20,
                                       device_mel=device_mel)
        jb = j.collate([j[i] for i in range(4)], frames)
        pb = p.collate([p[i] for i in range(4)], frames)
        assert set(jb) == set(pb) and jb["km_labels"].any()
        for k in jb:
            np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    # the crop: labels cut with the waveform, at the seeded start
    p = PMan.SpeechPretrainDataset(manifest=manifest, km_labels=km, max_sample_size=3200,
                                   device_mel=True, seed=5)
    start = int(np.random.default_rng(5).integers(0, p.sizes[0] - 3200 + 1))
    it = p[0]
    wav = PMan.read_audio(f"{p.root}/{p.names[0]}")[0]
    labels = np.asarray(p.label_lines[0].split(), np.int64)
    np.testing.assert_array_equal(it["wav"], wav[start:start + 3200].astype(np.float32))
    np.testing.assert_array_equal(it["labels"], labels[start * 50 // 16000:][:10])


def test_cli_train_pretrain_speech_and_joint_run_and_resume_on_cpu(tmp_path):
    """cli/train.main --task pretrain_speech and --task pretrain (text ratio
    1, accum 2) at the Large-shaped tiny preset: 3 updates each, finite,
    modality-pure updates with prefixed metrics, then a resume to 4; and
    --valid-manifest refused with --task pretrain."""
    manifest, km, text, dict_path = _corpus(tmp_path, n=8)
    ov = [a for o in LARGE_SHAPED for a in ("--override", o)]
    base = ["--arch", "speecht5_tiny", "--manifest", manifest, "--labels", km,
            "--dict", dict_path, "--batch-size", "2", "--device", "cpu",
            "--log-interval", "1", "--lr", "1e-3", "--warmup", "1", *ov]
    out = cli_train.main(["--task", "pretrain_speech", "--save-dir", f"{tmp_path}/s",
                          "--max-updates", "3", *base])
    assert out["steps"] == 3 and out["finite"]
    assert "code_perplexity" in out["history"][0] and "dec_l1_loss" in out["history"][0]
    joint = ["--task", "pretrain", "--text-file", str(text), "--tokens-per-sample", "24",
             "--accum", "2", "--save-dir", f"{tmp_path}/j", *base]
    out = cli_train.main(joint + ["--max-updates", "3"])
    assert out["steps"] == 3 and out["finite"]
    tasks = [{k.split("/")[0] for k in row} for row in out["history"]]
    assert all(len(t) == 1 for t in tasks)
    assert {"pretrain_speech", "pretrain_text"} == set().union(*tasks)
    out = cli_train.main(joint + ["--max-updates", "4"])
    assert out["steps"] == 4 and len(out["history"]) == 1
    with pytest.raises(SystemExit, match="valid-manifest"):
        cli_train.main(joint + ["--valid-manifest", manifest])
