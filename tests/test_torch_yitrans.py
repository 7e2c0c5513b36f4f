"""YiTrans in the port, held against the JAX package.

At ``yitrans_tiny`` (f32; and a variant whose conv width 48 is not
d_model, so ``post_extract_proj`` runs), on JAX's initial weights carried
by ``utils/convert.yitrans_from_jax_params`` (strict loads):
``forward_asr`` / ``forward_st`` / ``forward_mt`` / ``forward_pretrain``
(1e-5), the cached decode step against teacher forcing, ``ASRDecoder``
tokens for ASR (``encode_speech``, CTC 0.3) and MT (``encode_text``),
``yitrans_pretrain_loss`` (1e-5) with its metrics and gradients (1e-4 of
max |g|), the kernel flags' twins against the plain route, the recipe's
chain, and both datasets of ``data/yitrans.py`` bit for bit
(``_rotate_prev``, the per-epoch reseed).  The HuBERT masks are handed to
both packages as tests/test_torch_speechlm.py hands them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import speecht5_tpu.config as JC
import speecht5_tpu.data.yitrans as JYD
import speecht5_tpu.models.yitrans as JY
from speecht5_tpu.data.dictionary import Dictionary as JDictionary
from speecht5_tpu.data.text_noising import NoisingConfig as JNoising
from speecht5_tpu.decode.asr import ASRDecoder as JASRDecoder
from speecht5_tpu.train import joint as JJ

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.config as PC
import speecht5_tpu_torch.data.yitrans as PYD
import speecht5_tpu_torch.models.yitrans as PY
from speecht5_tpu_torch.data.dictionary import Dictionary as PDictionary
from speecht5_tpu_torch.data.text_noising import NoisingConfig as PNoising
from speecht5_tpu_torch.decode.asr import ASRDecoder
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.recipes import yitrans_pretrain_finetune as R
from speecht5_tpu_torch.train import joint as PJ
from speecht5_tpu_torch.utils.convert import yitrans_from_jax_params

from test_torch_speechlm import (Draws, close, flat, frames, grads_close, japply,
                                 jinit, metrics_close, one_layer,
                                 routes_close, speech_batch, t)

TOL = 1e-5
KERNEL_FLAGS = ["encoder.use_pallas_attn=True", "encoder.use_pallas_attn_train=True",
                "decoder.use_pallas_attn=True", "conv_features.impl='pallas'"]
RNGS = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(3)}
SRC = np.array([[5, 9, 11, 7, 13, 2], [6, 8, 10, 2, 1, 1]], np.int32)
PREV = np.array([[2, 7, 9, 11, 6], [2, 5, 8, 1, 1]], np.int32)
TGT = np.array([[7, 9, 11, 6, 2], [5, 8, 2, 1, 1]], np.int32)
#: the variant with ``post_extract_proj`` (conv width 48, d_model 64)
PROJ_LAYERS = ((32, 10, 5), (32, 8, 4), (48, 4, 4))


def patch_jax_masks(monkeypatch, module, d: Draws):
    """Replace ``module``'s ``apply_feature_masks`` by the handed-in time
    mask (the module draws no other span)."""
    def jmasks(rng, x, lengths, mask_emb, **kw):
        B, T, _ = x.shape
        tm = jnp.asarray(d.time_mask(B, T)) & (jnp.arange(T)[None, :] < lengths[:, None])
        return jnp.where(tm[:, :, None], mask_emb.astype(x.dtype)[None, None, :], x), tm

    monkeypatch.setattr(module, "apply_feature_masks", jmasks)


@pytest.fixture
def draws(monkeypatch):
    d = Draws()
    patch_jax_masks(monkeypatch, JY, d)
    return d


def _init(cfg):
    wav, lens, _ = speech_batch(cfg)
    return jinit(JY.YiTransModel(cfg), RNGS, jnp.asarray(wav), jnp.asarray(lens),
                 jnp.asarray(SRC), jnp.asarray(PREV), method="init_all")


@pytest.fixture(scope="module")
def yit():
    cfg = JY.yitrans_tiny()
    variables = _init(cfg)
    return cfg, variables, port_yitrans(variables)


def port_yitrans(variables, overrides=(), **kw):
    model = PY.YiTransModel(PC.apply_overrides(PY.yitrans_tiny(**kw), list(overrides)))
    model.load_state_dict(yitrans_from_jax_params(flat(variables["params"])), strict=True)
    return model.eval()


def _forwards(m, w, n, src, prev):
    """Every task forward of a JAX model under one compiled call."""
    return (m.forward_asr(w, n, prev, mask=True, deterministic=True),
            m.forward_st(w, n, prev, deterministic=True),
            m.forward_mt(src, prev, deterministic=True),
            m.forward_pretrain(w, n, src, prev, deterministic=True))


@pytest.mark.parametrize("proj", [False, True])
def test_task_forwards_match_jax(yit, draws, proj):
    """forward_asr (masked, with CTC), forward_st, forward_mt and
    forward_pretrain (HuBERT logits, time mask, features_pen, denoising
    logits), at the tiny preset and with ``post_extract_proj``."""
    if proj:
        conv = JC.ConvFeatureConfig(layers=PROJ_LAYERS)
        cfg = JY.yitrans_tiny(conv_features=conv)
        variables = _init(cfg)
        model = port_yitrans(variables, conv_features=PC.ConvFeatureConfig(layers=PROJ_LAYERS))
        assert model.post_extract_proj is not None
    else:
        cfg, variables, model = yit
        assert model.post_extract_proj is None
    wav, lens, _ = speech_batch(cfg)
    jasr, jst, jmt, jpre = japply(JY.YiTransModel(cfg), variables, jnp.asarray(wav),
                                  jnp.asarray(lens), jnp.asarray(SRC), jnp.asarray(PREV),
                                  rngs=RNGS, method=_forwards)
    T = cfg.conv_features.out_length(wav.shape[1])
    masks = draws.port_masks(frames(cfg, lens), T)
    w, n, src, prev = t(wav), t(lens), t(SRC).long(), t(PREV).long()
    with torch.no_grad():
        asr = model.forward_asr(w, n, prev, masks=masks)
        st = model.forward_st(w, n, prev)
        mt = model.forward_mt(src, prev)
        pre = model.forward_pretrain(w, n, src, prev, masks=masks)
    for got, want, what in zip(asr, jasr, ("asr logits", "asr ctc", "asr valid")):
        close(got, want, atol=TOL, msg=what)
    close(st, jst, atol=TOL)
    close(mt, jmt, atol=TOL)
    np.testing.assert_array_equal(pre["time_mask"].numpy(), np.asarray(jpre["time_mask"]))
    for k in ("speech_logits", "text_logits", "features_pen", "valid_mask"):
        close(pre[k], jpre[k], atol=TOL, msg=k)


def test_decode_step_matches_teacher_forcing_and_jax(yit):
    """``text_decode_step`` (fairseq positions at pad_id + 1 + index)
    step by step equals ``decode_text``, and JAX's decode_text."""
    cfg, variables, model = yit
    wav, lens, _ = speech_batch(cfg)
    prev = PREV[:, :3]
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
    jfull = japply(JY.YiTransModel(cfg), variables, jnp.asarray(wav), jnp.asarray(lens),
                   jnp.asarray(prev),
                   method=lambda m, w, n, p: m.decode_text(m.encode_speech(w, n), p))
    close(full, jfull, atol=TOL)


@pytest.mark.parametrize("task", ["asr", "mt"])
def test_asr_decoder_tokens_match_jax(yit, task):
    """The beam through ``encode_speech`` (ASR, CTC 0.3) and
    ``encode_text`` (MT, no CTC head on text): JAX's whole token array,
    lengths and scores (1e-5), the decode-step kernel's twin on."""
    cfg, variables, _ = yit
    model = port_yitrans(variables, ["decoder.use_pallas_attn=True"])
    if task == "asr":
        wav, lens, _ = speech_batch(cfg, seed=1)
        args, kw = (wav, lens), dict(ctc_weight=0.3)
    else:
        args, kw = (SRC,), dict(encode_method="encode_text")
    kw.update(beam_size=3, max_len=10, min_len=2)
    jres = JASRDecoder(JY.YiTransModel(cfg), variables, **kw)(*map(jnp.asarray, args))
    res = ASRDecoder(model, device="cpu", **kw)(*args)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores), atol=TOL,
                               rtol=TOL)


def pretrain_batch(cfg):
    wav, lens, units = speech_batch(cfg)
    return {"speech": {"wav": wav, "wav_lengths": lens, "units": units},
            "text_mono": {"src_tokens": SRC, "prev_tokens": PREV, "targets": TGT}}


def pretrain_draws(d: Draws, cfg, batch):
    sp = batch["speech"]
    return {"speech": {"masks": d.port_masks(frames(cfg, sp["wav_lengths"]),
                                             sp["units"].shape[1])}}


def p_batch(batch):
    return {k: {kk: t(vv) if vv.dtype == np.float32 or kk == "wav_lengths"
                else t(vv).long() for kk, vv in v.items()} for k, v in batch.items()}


def test_pretrain_loss_metrics_and_gradients_match_jax(yit, draws):
    """``yitrans_pretrain_loss``: HuBERT on the speech stream plus the
    denoising CE scaled by sample_size / tsize; the loss (1e-5), every
    metric, every gradient (1e-4 of max |g|; one layer a stack)."""
    cfg, variables, ovs = one_layer(yit[0], yit[1], ("encoder", "decoder"))
    batch = pretrain_batch(cfg)
    jfn = JJ.make_yitrans_pretrain_loss(JY.YiTransModel(cfg), JJ.JointLossConfig())
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        variables["params"], jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(5))
    model = port_yitrans(variables, ovs).train()
    loss, m = PJ.yitrans_pretrain_loss(model, p_batch(batch), PJ.JointLossConfig(),
                                       draws=pretrain_draws(draws, cfg, batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    metrics_close(m, jm)
    assert {"denoise_loss", "denoise_acc", "speech_loss_m_0"} <= set(m)
    got = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    want = yitrans_from_jax_params(flat(jg))
    gmax = max(np.abs(w.numpy()).max() for w in want.values())
    for name, w in want.items():
        g = got.get(name, np.zeros(w.shape, np.float32))
        tol = 1e-6 * gmax if name.endswith("k_proj.bias") else 1e-4 * np.abs(w.numpy()).max()
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=max(tol, 1e-12), err_msg=name)
    grads_close(model, want)


def test_kernel_flags_take_the_twins_on_the_cpu(yit, draws):
    """Every kernel flag on: on the CPU the wrappers run their twins, the
    pretraining loss and gradients equal the plain route's, no launch."""
    cfg, variables, plain = yit
    kern = port_yitrans(variables, KERNEL_FLAGS)
    batch = pretrain_batch(cfg)
    K.reset_launch_counts()
    losses = []
    for model in (plain, kern):
        model.train()
        loss, _ = PJ.yitrans_pretrain_loss(model, p_batch(batch), PJ.JointLossConfig(),
                                           draws=pretrain_draws(draws, cfg, batch))
        loss.backward()
        losses.append(loss.item())
        model.eval()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    routes_close(kern, plain)
    assert sum(K.launch_counts().values()) == 0


def test_recipe_chain_runs_with_falling_losses():
    """``recipes/yitrans_pretrain_finetune.run`` at tiny on the CPU: stage
    1, the three warm-started fine-tunes and their beams; every loss
    finite, each fine-tune's last loss under its first, and every
    hypothesis starts at EOS and stays in the dictionary."""
    out = R.run(pretrain_steps=4, finetune_steps=4, device="cpu", log=lambda s: None)
    assert len(out["pretrain_losses"]) == 4 and np.isfinite(out["pretrain_losses"]).all()
    assert out["metrics"]["denoise_loss"] > 0
    for task in R.TASKS:
        losses = out["finetune_losses"][task]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], (task, losses)
        hyp = out["hyps"][task]
        assert hyp[0] == PY.yitrans_tiny().eos_id and max(hyp) < out["model"].cfg.vocab_size


# ------------------------------------------------------------------ datasets


def _dicts():
    out = []
    for D in (JDictionary, PDictionary):
        d = D()
        for i in range(30):
            d.add_symbol(f"w{i}")
        out.append(d)
    j_ids = JYD.add_multilingual_symbols(out[0], ["en_XX", "de_DE"])
    p_ids = PYD.add_multilingual_symbols(out[1], ["en_XX", "de_DE"])
    assert j_ids == p_ids and out[0].symbols == out[1].symbols
    return out


def _lines(n, seed):
    r = np.random.default_rng(seed)
    return [" ".join(f"w{i}" for i in r.integers(0, 30, int(r.integers(3, 20))))
            for _ in range(n)]


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("tag", [True, False])
def test_denoising_dataset_bit_equal_to_jax(tag):
    """``MultilingualDenoisingDataset`` items and collates (bucketed and
    not; prev = ``_rotate_prev``: the tag, or EOS, first) for two epochs
    (``set_epoch`` reseeds every item's noise), with and without the
    language tag."""
    jd, pd = _dicts()
    lines = _lines(12, 0)
    kw = dict(seed=3, tokens_per_sample=16, prepend_tgt_lang_tag=tag)
    jds = JYD.MultilingualDenoisingDataset(lines, jd, "de_DE", JNoising(mask_ratio=0.3,
                                                                        insert_ratio=0.1), **kw)
    pds = PYD.MultilingualDenoisingDataset(lines, pd, "de_DE", PNoising(mask_ratio=0.3,
                                                                        insert_ratio=0.1), **kw)
    np.testing.assert_array_equal(jds.sizes, pds.sizes)
    items = {}
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        ji, pi = [jds[i] for i in range(len(jds))], [pds[i] for i in range(len(pds))]
        for a, b in zip(ji, pi):
            _same(a, b)
        items[epoch] = pi
        for bucketed in (True, False):
            _same(jds.collate(ji[:5], bucketed), pds.collate(pi[:5], bucketed))
        b = pds.collate(pi[:2], False)
        last = pi[0]["target"][-1]
        assert b["prev_tokens"][0, 0] == last == (pd.index("[de_DE]") if tag else pd.eos_index)
        np.testing.assert_array_equal(b["prev_tokens"][0, 1: len(pi[0]["target"])],
                                      pi[0]["target"][:-1])
    assert any(not np.array_equal(a["source"], b["source"])
               for a, b in zip(items[0], items[1]))
    np.testing.assert_array_equal(PYD._rotate_prev(np.arange(5)), JYD._rotate_prev(np.arange(5)))


@pytest.mark.parametrize("append_source_id,ratio", [(False, 0.3), (True, 0.3), (False, 0.0)])
def test_lang_pair_dataset_bit_equal_to_jax(append_source_id, ratio):
    """``LangPairDataset``: source masking (BOS, EOS and the source tag
    spared), ``append_source_id``, the eos-to-[tgt] BOS of prev when the
    ids are not appended, over two epochs, bucketed and not."""
    jd, pd = _dicts()
    src, tgt = _lines(10, 1), _lines(10, 2)
    args = ("en_XX", "de_DE")
    kw = dict(append_source_id=append_source_id, mask_text_ratio=ratio, seed=5)
    jds = JYD.LangPairDataset(src, tgt, jd, jd, *args, **kw)
    pds = PYD.LangPairDataset(src, tgt, pd, pd, *args, **kw)
    np.testing.assert_array_equal(jds.sizes, pds.sizes)
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        ji, pi = [jds[i] for i in range(len(jds))], [pds[i] for i in range(len(pds))]
        for a, b in zip(ji, pi):
            _same(a, b)
        for bucketed in (True, False):
            _same(jds.collate(ji[:4], bucketed), pds.collate(pi[:4], bucketed))
    b = pds.collate(pi[:1], False)
    assert b["prev_tokens"][0, 0] == (pd.index("[de_DE]") if append_source_id
                                      else pds.tgt_lang_id)
    if ratio:
        assert any((it["source"] == pd.index("<mask>")).any() for it in pi)


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    """Both families' init functions and recipes run on the card unless the
    caller asks for the CPU; without a card they raise."""
    import inspect

    from speecht5_tpu_torch.models.vatlm import init_vatlm, vatlm_tiny
    from speecht5_tpu_torch.recipes import vatlm_pretrain as RV

    for fn in (PY.init_yitrans, init_vatlm, R.run, RV.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for cuda does not raise here")
    for call in (lambda: PY.init_yitrans(PY.yitrans_tiny()), lambda: init_vatlm(vatlm_tiny()),
                 lambda: R.main(["--pretrain-steps", "1"]), lambda: RV.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
