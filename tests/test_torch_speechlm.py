"""SpeechLM and FastText2Unit in the port, held against the JAX package.

At ``speechlm_tiny`` / ``fastspeech2_tiny`` (f32), weights made by JAX's
init and carried by ``utils/convert.speechlm_from_jax_params`` /
``fastspeech2_from_jax_params`` (strict loads): ``forward_speech`` (both
HuBERT levels, embedding mixing, the l2 tie), ``forward_text`` (masked
units, the character CTC head), ``extract_features`` with the CTC and ST
heads, ``speechlm_joint_loss`` with its metrics and gradients,
``length_regulate`` against ``np.repeat``, ``FastText2Unit`` forward and
``generate``, ``fasttext2unit_loss`` with gradients, the kernel flags'
twins against the plain route, the CTC recipe's first loss against the
JAX recipe's loss function, the recipes' refusal without a card, and the
CPU rehearsal of ``chip_smoke.py``'s ``speechlm`` phase.

The random draws (the HuBERT time masks and the "mix" span selection) are
handed to both packages (``Draws``): JAX's ``apply_feature_masks`` and
``compute_span_mask`` in ``models/speechlm.py`` are replaced for the test,
and the port takes the same masks as arguments.  Tolerances: outputs
2e-4 absolute, losses and metrics 2e-4 relative, every gradient within
2e-4 of its parameter's max |g|.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.models.fastspeech2 as JF2
import speecht5_tpu.models.speechlm as JSLM
from speecht5_tpu.ops.ctc import ctc_loss as jctc_loss
from speecht5_tpu.train import criterions as JCr
from speecht5_tpu.train import joint as JJ

import torch

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.models.fastspeech2 as PF2
import speecht5_tpu_torch.models.speechlm as PSLM
from speecht5_tpu_torch.config import apply_overrides
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.recipes import speechlm_ctc_finetune as R
from speecht5_tpu_torch.train import criterions as PCr
from speecht5_tpu_torch.train import joint as PJ
from speecht5_tpu_torch.utils.convert import (fastspeech2_from_jax_params,
                                              speechlm_from_jax_params)

ATOL, RTOL = 2e-4, 2e-4
B, T_WAV = 2, 4000
LENS = np.array([4000, 3000], np.int32)
KERNEL_FLAGS = ["speech_encoder.use_pallas_attn=True",
                "speech_encoder.use_pallas_attn_train=True",
                "unit_encoder.use_pallas_attn=True", "unit_encoder.use_pallas_attn_train=True",
                "conv_features.impl='pallas'"]


# ------------------------------------------------------------------ helpers


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol=ATOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=msg)


def metrics_close(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(w), rtol=RTOL, atol=1e-6,
                                   err_msg=k)


def grads_close(model, jgrads: dict):
    """Every JAX gradient (by the port's names) against the port's; one the
    loss does not reach is 0 on both sides.  The attention's k_proj biases
    have an analytically zero gradient (softmax is shift-invariant): both
    sides within 1e-6 of the largest gradient, as tests/test_torch_large.py
    holds them."""
    got = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    jgrads = {n: np.asarray(g) for n, g in jgrads.items()}
    assert set(got) <= set(jgrads)
    gmax = max(np.abs(w).max() for w in jgrads.values())
    for name, w in jgrads.items():
        g = got.get(name, np.zeros_like(w))
        if name.endswith("k_proj.bias"):
            assert np.abs(g).max() <= 1e-6 * gmax and np.abs(w).max() <= 1e-6 * gmax, name
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * np.abs(w).max(),
                                       err_msg=name)


def routes_close(kern, plain):
    """The kernel route's gradients against the plain route's (each within
    1e-5 of its max |g|; the k_proj biases' zeros within 1e-6 of the
    largest), then both models' gradients cleared."""
    grads = {n: p.grad.numpy() for n, p in plain.named_parameters() if p.grad is not None}
    gmax = max(np.abs(g).max() for g in grads.values())
    for (n, q) in kern.named_parameters():
        if n not in grads:
            assert q.grad is None, n
        elif n.endswith("k_proj.bias"):
            assert np.abs(q.grad.numpy()).max() <= 1e-6 * gmax, n
        else:
            close(q.grad, grads[n], atol=1e-5 * np.abs(grads[n]).max(), msg=n)
    plain.zero_grad()
    kern.zero_grad()


class Draws:
    """The draws handed to both packages, seeded by their kind and shape:
    the HuBERT time mask and the "mix" span selection, each before its cut
    to the lengths."""

    @staticmethod
    def _rng(kind, *shape):
        return np.random.default_rng([kind, *(int(s) for s in shape)])

    def time_mask(self, B, T):
        return self._rng(3, B, T).random((B, T)) < 0.4

    def mix(self, B, T):
        return self._rng(4, B, T).random((B, T)) < 0.3

    @staticmethod
    def cut(m, lengths):
        lengths = np.asarray(lengths)
        return m & (np.arange(m.shape[1])[None, :] < lengths[:, None])

    def port_masks(self, lengths, T):
        return (t(self.cut(self.time_mask(len(lengths), T), lengths)), None)

    def port_mix(self, lengths, T, time_mask):
        sel = self.cut(self.mix(len(lengths), T), lengths)
        return t(sel & ~np.asarray(time_mask))


def patch_jax_draws(monkeypatch, module, d: Draws):
    """Replace ``module``'s ``apply_feature_masks`` and
    ``compute_span_mask`` by the handed-in draws."""
    def jmasks(rng, x, lengths, mask_emb, **kw):
        B, T, _ = x.shape
        tm = jnp.asarray(d.time_mask(B, T)) & (jnp.arange(T)[None, :] < lengths[:, None])
        return jnp.where(tm[:, :, None], mask_emb.astype(x.dtype)[None, None, :], x), tm

    def jspan(rng, lengths, T, *a, **kw):
        return jnp.asarray(d.mix(lengths.shape[0], T)) & (jnp.arange(T)[None, :]
                                                          < lengths[:, None])

    monkeypatch.setattr(module, "apply_feature_masks", jmasks)
    monkeypatch.setattr(module, "compute_span_mask", jspan)


@pytest.fixture
def draws(monkeypatch):
    d = Draws()
    patch_jax_draws(monkeypatch, JSLM, d)
    return d


def one_layer(jcfg, variables, stacks):
    """A JAX config and variables with one layer in each of ``stacks``
    (the first layer's weights; the gradient tests compile a smaller
    program), and the port overrides that match them."""
    import dataclasses

    jcfg = dataclasses.replace(jcfg, **{s: dataclasses.replace(getattr(jcfg, s), num_layers=1)
                                        for s in stacks})
    params = dict(variables["params"])
    for s in stacks:
        key = "encoder" if s == "speech_encoder" else s      # the JAX tree's name
        params[key] = {k: v for k, v in params[key].items() if k != "layers_1"}
    return jcfg, {"params": params}, [f"{s}.num_layers=1" for s in stacks]


def japply(module, variables, *args, **kw):
    """``module.apply`` jitted (the keyword arguments static): the JAX
    references run compiled, not op by op."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def jinit(module, *args, **kw):
    return jax.jit(lambda *a: module.init(*a, **kw))(*args)


def frames(cfg, lengths):
    return np.array([cfg.conv_features.out_length(int(n)) for n in lengths])


def speech_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((B, T_WAV)) * 0.1).astype(np.float32)
    T = cfg.conv_features.out_length(T_WAV)
    units = rng.integers(2, cfg.unit_vocab_size, (B, T)).astype(np.int32)
    return wav, LENS, units


def unit_tokens(cfg, lengths=(12, 9), seed=1):
    rng = np.random.default_rng(seed)
    toks = np.full((len(lengths), max(lengths)), cfg.pad_id, np.int32)
    for b, n in enumerate(lengths):
        toks[b, :n] = rng.integers(2, cfg.unit_vocab_size, n)
    return toks


RNGS = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1),
        "mix": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}


@pytest.fixture(scope="module")
def slm():
    """JAX SpeechLM at tiny (both branches initialised) and the port's
    model on its weights."""
    cfg = JSLM.speechlm_tiny()
    wav, lens, units = speech_batch(cfg)

    def both(m, wav, lens, units, toks):
        return m.forward_speech(wav, lens, units), m.forward_text(toks)

    variables = jinit(JSLM.SpeechLMModel(cfg), RNGS, jnp.asarray(wav), jnp.asarray(lens),
                      jnp.asarray(units), jnp.asarray(unit_tokens(cfg)), method=both)
    return cfg, variables, port_speechlm(variables)


def port_speechlm(variables, overrides=()):
    pcfg = apply_overrides(PSLM.speechlm_tiny(), list(overrides))
    model = PSLM.SpeechLMModel(pcfg)
    model.load_state_dict(speechlm_from_jax_params(flat(variables["params"])), strict=True)
    return model.eval()


# ------------------------------------------------------------------ SpeechLM


@pytest.fixture(scope="module")
def jax_branches(slm):
    """JAX's ``forward_speech`` (with targets) and ``forward_text`` on the
    test batches under the handed-in draws, in one compiled call."""
    cfg, variables, _ = slm
    wav, lens, units = speech_batch(cfg)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_draws(mp, JSLM, Draws())
        return japply(JSLM.SpeechLMModel(cfg), variables, jnp.asarray(wav), jnp.asarray(lens),
                      jnp.asarray(units), jnp.asarray(unit_tokens(cfg)), rngs=RNGS,
                      method=lambda m, w, n, u, k: (m.forward_speech(w, n, u),
                                                    m.forward_text(k)))


def test_forward_speech_matches_jax(slm, jax_branches, draws):
    cfg, variables, model = slm
    wav, lens, units = speech_batch(cfg)
    jout = jax_branches[0]
    T = units.shape[1]
    fl = frames(cfg, lens)
    masks = draws.port_masks(fl, T)
    with torch.no_grad():
        out = model.forward_speech(t(wav), t(lens), t(units).long(), masks=masks,
                                   mix_sel=draws.port_mix(fl, T, masks[0]))
    np.testing.assert_array_equal(out["time_mask"].numpy(), np.asarray(jout["time_mask"]))
    np.testing.assert_array_equal(out["valid_mask"].numpy(), np.asarray(jout["valid_mask"]))
    for k in ("speech_out", "encoder_out", "logits_0", "logits_1", "features_pen"):
        close(out[k], jout[k], msg=k)
    assert float(out["l2_loss"]) == float(jout["l2_loss"]) == 0.0


def test_l2_tie_and_no_targets_match_jax(slm, draws):
    """``l2_embedding`` on (the tie's loss over the masked frames), and the
    branch without targets (no logits, no mixing)."""
    cfg, variables, _ = slm
    jcfg = JSLM.speechlm_tiny(l2_embedding=True)
    model = port_speechlm(variables, ["l2_embedding=True"])
    wav, lens, units = speech_batch(cfg)
    T = units.shape[1]
    fl = frames(cfg, lens)
    masks = draws.port_masks(fl, T)
    jout, jnot = japply(JSLM.SpeechLMModel(jcfg), variables, jnp.asarray(wav),
                        jnp.asarray(lens), jnp.asarray(units), rngs=RNGS,
                        method=lambda m, w, n, u: (m.forward_speech(w, n, u),
                                                   m.forward_speech(w, n)))
    with torch.no_grad():
        out = model.forward_speech(t(wav), t(lens), t(units).long(), masks=masks,
                                   mix_sel=draws.port_mix(fl, T, masks[0]))
        pnot = model.forward_speech(t(wav), t(lens), masks=masks)
    np.testing.assert_allclose(float(out["l2_loss"]), float(jout["l2_loss"]), rtol=RTOL)
    assert float(jout["l2_loss"]) > 0
    assert "logits_0" not in pnot and "logits_0" not in jnot
    close(pnot["encoder_out"], jnot["encoder_out"])


def test_forward_text_matches_jax(slm, jax_branches, draws):
    cfg, variables, model = slm
    toks = unit_tokens(cfg)
    jout = jax_branches[1]
    valid = toks != cfg.pad_id
    with torch.no_grad():
        out = model.forward_text(t(toks).long(),
                                 masks=draws.port_masks(valid.sum(-1), toks.shape[1]))
    np.testing.assert_array_equal(out["time_mask"].numpy(), np.asarray(jout["time_mask"]))
    for k in ("encoder_out", "mum_logits", "ctc_logits"):
        close(out[k], jout[k], msg=k)


def ctc_variables(variables, vocab: int, seed: int = 7):
    """``SpeechLMCtc``'s JAX variables from a ``SpeechLMModel``'s: its
    stack and label embeddings under ``speechlm`` (the parameters JAX's
    init makes there) and a random ``ctc_proj``."""
    heads = ("unit_embed_tokens", "final_proj_0", "final_proj_1", "unit_encoder_ctc_head")
    p = {k: v for k, v in variables["params"].items() if k not in heads}
    rng = np.random.default_rng(seed)
    d = p["encoder"]["layer_norm"]["scale"].shape[0]
    proj = {"kernel": jnp.asarray(rng.standard_normal((d, vocab)).astype(np.float32) * d ** -0.5),
            "bias": jnp.zeros((vocab,), jnp.float32)}
    return {"params": {"speechlm": p, "ctc_proj": proj}}


def test_ctc_and_st_heads_match_jax(slm):
    """``extract_features`` under ``SpeechLMCtc`` (eval: no head dropout)
    and ``SpeechLMS2T`` with its own decoder."""
    from speecht5_tpu.config import TransformerConfig as JTC
    from speecht5_tpu_torch.config import TransformerConfig as PTC

    cfg = slm[0]
    wav, lens, _ = speech_batch(cfg)
    jm = JSLM.SpeechLMCtc(cfg, ctc_vocab_size=8)
    v = ctc_variables(slm[1], 8)
    jlogits, jvalid = japply(jm, v, jnp.asarray(wav), jnp.asarray(lens))
    pm = PSLM.SpeechLMCtc(PSLM.speechlm_tiny(), 8)
    pm.load_state_dict(speechlm_from_jax_params(flat(v["params"])), strict=True)
    with torch.no_grad():
        logits, valid = pm.eval()(t(wav), t(lens))
    close(logits, jlogits)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))

    kw = dict(d_model=64, ffn_dim=128, num_layers=2, num_heads=4, dropout=0.0,
              attention_dropout=0.0, use_rel_pos_bias=False)
    prev = np.array([[2, 7, 9, 11], [2, 5, 1, 1]], np.int32)
    js = JSLM.SpeechLMS2T(cfg, JTC(**kw), tgt_vocab_size=30)
    # its variables: the stack's, the decoder's own init (a whole-model init
    # would run the stack eagerly once more), random embeddings
    from speecht5_tpu.models.decoder import TransformerDecoder as JDecoder

    T = cfg.conv_features.out_length(wav.shape[1])
    dec = jinit(JDecoder(JTC(**kw)), jax.random.PRNGKey(4), jnp.zeros((2, 4, 64)),
                jnp.zeros((2, T, 64)), enc_valid=jnp.ones((2, T), bool),
                self_valid=jnp.ones((2, 4), bool))["params"]
    rng = np.random.default_rng(8)
    v = {"params": {"speechlm": ctc_variables(slm[1], 8)["params"]["speechlm"],
                    "decoder": dec,
                    "embed_tokens": {"embedding": jnp.asarray(
                        rng.standard_normal((30, 64)).astype(np.float32) * 0.125)},
                    "output_projection": {"kernel": jnp.asarray(
                        rng.standard_normal((64, 30)).astype(np.float32) * 0.125)}}}
    jl, _ = japply(js, v, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(prev))
    ps = PSLM.SpeechLMS2T(PSLM.speechlm_tiny(), PTC(**kw), tgt_vocab_size=30)
    ps.load_state_dict(speechlm_from_jax_params(flat(v["params"])), strict=True)
    with torch.no_grad():
        pl, _ = ps.eval()(t(wav), t(lens), t(prev).long())
    close(pl, jl)


def joint_batch(cfg):
    wav, lens, units = speech_batch(cfg)
    toks = unit_tokens(cfg)
    chars = np.array([[5, 6, 7, 1], [8, 9, 1, 1]], np.int32)
    return {"speech": {"wav": wav, "wav_lengths": lens, "units": units},
            "text": {"units": toks, "char_targets": chars}}


def port_draws(d: Draws, cfg, batch, text_key="text"):
    sp = batch["speech"]
    T = sp["units"].shape[1]
    fl = frames(cfg, sp["wav_lengths"])
    masks = d.port_masks(fl, T)
    toks = batch[text_key]["units"]
    return {"speech": {"masks": masks, "mix_sel": d.port_mix(fl, T, masks[0])},
            text_key: {"masks": d.port_masks((toks != cfg.pad_id).sum(-1), toks.shape[1])}}


def test_speechlm_joint_loss_and_gradients_match_jax(slm, draws):
    """Both HuBERT levels, the masked-unit term rescaled by the sample
    sizes, the character CTC: loss, every metric and every gradient (one
    layer a stack)."""
    cfg, variables, ovs = one_layer(slm[0], slm[1], ("speech_encoder", "unit_encoder"))
    jcfg = JJ.JointLossConfig(u2t_ctc_weight=0.3)
    batch = joint_batch(cfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jfn = JJ.make_speechlm_joint_loss(JSLM.SpeechLMModel(cfg), jcfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        variables["params"], jb, jax.random.PRNGKey(5))
    model = port_speechlm(variables, ovs).train()
    pb = {k: {kk: t(vv).long() if vv.dtype != np.float32 else t(vv) for kk, vv in v.items()}
          for k, v in batch.items()}
    loss, m = PJ.speechlm_joint_loss(model, pb, PJ.JointLossConfig(u2t_ctc_weight=0.3),
                                     draws=port_draws(draws, cfg, batch))
    loss.backward()
    metrics_close(m, jm)
    assert "char_ctc_loss" in m and "mum_loss_m_0" in m and "speech_loss_m_1" in m
    grads_close(model, speechlm_from_jax_params(flat(jg)))


def test_kernel_flags_take_the_twins_on_the_cpu(slm, draws):
    """Every kernel flag on (both encoders' inference and train attention,
    the conv stack): on CPU tensors the wrappers run their plain twins and
    launch nothing, and the outputs, the loss and the gradients equal the
    plain route's."""
    cfg, variables, plain = slm
    kern = port_speechlm(variables, KERNEL_FLAGS)
    wav, lens, units = speech_batch(cfg)
    T = units.shape[1]
    fl = frames(cfg, lens)
    masks = draws.port_masks(fl, T)
    mix = draws.port_mix(fl, T, masks[0])
    K.reset_launch_counts()
    with torch.no_grad():
        a = plain.forward_speech(t(wav), t(lens), t(units).long(), masks=masks, mix_sel=mix)
        b = kern.forward_speech(t(wav), t(lens), t(units).long(), masks=masks, mix_sel=mix)
    for k in ("encoder_out", "logits_0", "logits_1"):
        close(b[k], a[k], atol=1e-5, msg=k)
    batch = joint_batch(cfg)
    pb = {k: {kk: t(vv).long() if vv.dtype != np.float32 else t(vv) for kk, vv in v.items()}
          for k, v in batch.items()}
    losses = []
    for model in (plain, kern):
        model.train().zero_grad()
        loss, _ = PJ.speechlm_joint_loss(model, pb, PJ.JointLossConfig(),
                                         draws=port_draws(draws, cfg, batch))
        loss.backward()
        losses.append(loss.item())
        model.eval()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    routes_close(kern, plain)
    assert sum(K.launch_counts().values()) == 0


def test_ctc_recipe_first_loss_matches_the_jax_loss_function(slm):
    """``recipes/speechlm_ctc_finetune``: the synthetic corpus equals the
    JAX recipe's (its sampling, recipes/speechlm_ctc_finetune.py:49-62),
    and ``--steps 2`` on JAX's weights gives as first loss the JAX loss
    function's (the head's dropout keep mask handed to both), then a lower
    one."""
    rng = np.random.default_rng(0)
    for wav, labels in R.synthetic_corpus(0):
        lab = rng.integers(2, R.V, (R.L,))
        tt = np.arange(R.T_WAV) / 16000.0
        w = np.zeros(R.T_WAV, np.float32)
        seg = R.T_WAV // R.L
        for j, x in enumerate(lab):
            w[j * seg : (j + 1) * seg] = 0.3 * np.sin(2 * np.pi * 150.0 * (1 + int(x)) * tt[:seg])
        w += 0.01 * rng.standard_normal(R.T_WAV).astype(np.float32)
        np.testing.assert_array_equal(wav, w)
        np.testing.assert_array_equal(labels, lab)

    cfg = JSLM.speechlm_tiny()
    data = R.synthetic_corpus(0)
    wav = np.stack([d[0] for d in data])
    labels = np.stack([d[1] for d in data])
    jm = JSLM.SpeechLMCtc(cfg, ctc_vocab_size=R.V)
    v = ctc_variables(slm[1], R.V)
    keep = np.random.default_rng(9).random(
        (R.B, cfg.conv_features.out_length(R.T_WAV), cfg.d_model)) >= 0.1

    def loss(m, w, n, k, y):       # the head's dropout with the keep mask handed in
        h, valid = m.speechlm.extract_features(w, n)
        logits = m.ctc_proj(jnp.where(k, h / 0.9, 0.0))
        return jnp.mean(jctc_loss(jax.nn.log_softmax(logits, -1), valid.sum(-1), y,
                                  jnp.full((R.B,), R.L), blank_id=0))

    jloss = japply(jm, v, jnp.asarray(wav), jnp.full((R.B,), R.T_WAV), jnp.asarray(keep),
                   jnp.asarray(labels), method=loss)

    model = PSLM.SpeechLMCtc(PSLM.speechlm_tiny(), R.V)
    model.load_state_dict(speechlm_from_jax_params(flat(v["params"])), strict=True)
    out = R.run(steps=2, device="cpu", model=model, data=data,
                keep_masks=[t(keep), t(keep)], log=lambda s: None)
    np.testing.assert_allclose(out["losses"][0], float(jloss), rtol=RTOL)
    assert out["losses"][1] < out["losses"][0]


RECIPES = ["speechlm_ctc_finetune", "speechut_joint_pretrain", "speech2c_pretrain"]


@pytest.mark.parametrize("name", RECIPES)
def test_recipes_run_two_steps_on_the_cpu(name, capsys):
    """``--steps 2 --device cpu``: two finite updates and the JAX recipe's
    closing line (the overfit asserts hold only runs of the default
    length)."""
    import importlib

    out = importlib.import_module(f"speecht5_tpu_torch.recipes.{name}").main(
        ["--steps", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    printed = capsys.readouterr()
    assert '"done": true' in printed.out or "done: 2 steps" in printed.err


@pytest.mark.parametrize("name", RECIPES)
def test_recipes_default_to_cuda_and_refuse_without_a_card(name, monkeypatch):
    import importlib

    mod = importlib.import_module(f"speecht5_tpu_torch.recipes.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["--steps", "1"])


# ------------------------------------------------------------- FastText2Unit


@pytest.fixture(scope="module")
def t2u():
    cfg = JF2.fastspeech2_tiny()
    model, variables = JF2.init_fastspeech2(cfg, jax.random.PRNGKey(0))
    pm = PF2.FastText2Unit(PF2.fastspeech2_tiny())
    pm.load_state_dict(fastspeech2_from_jax_params(flat(variables["params"])), strict=True)
    return cfg, model, variables, pm.eval()


def t2u_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    src = np.full((2, 7), cfg.pad_id, np.int32)
    src[0] = rng.integers(2, cfg.src_vocab_size, 7)
    src[1, :5] = rng.integers(2, cfg.src_vocab_size, 5)
    dur = rng.integers(0, 5, (2, 7)).astype(np.int32)
    return src, dur


def test_length_regulate_matches_np_repeat_and_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    dur = rng.integers(0, 4, (3, 6)).astype(np.int32)
    dur[2] = 9                          # overflows the buffer: clamped
    for max_len in (16, 40):
        out, lens, valid = PF2.length_regulate(t(x), t(dur), max_len)
        jout, jlens, jvalid = jax.jit(JF2.length_regulate, static_argnums=2)(
            jnp.asarray(x), jnp.asarray(dur), max_len)
        close(out, jout, atol=0)
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        for b in range(3):
            rep = np.repeat(x[b], dur[b], axis=0)[:max_len]
            np.testing.assert_array_equal(out[b, : len(rep)].numpy(), rep)
            assert int(lens[b]) == len(rep)


def test_fasttext2unit_forward_generate_and_loss_match_jax(t2u):
    cfg, jm, variables, pm = t2u
    src, dur = t2u_batch(cfg)
    targets = np.random.default_rng(2).integers(0, cfg.unit_vocab_size,
                                                (2, cfg.max_target_len)).astype(np.int32)

    def jloss_fn(p):
        lo, lens, ov, ld = jm.apply({"params": p}, jnp.asarray(src), jnp.asarray(dur))
        loss, met = JCr.fasttext2unit_loss(lo, ov, jnp.asarray(targets), ld, jnp.asarray(dur),
                                           jnp.asarray(src != cfg.pad_id), label_smoothing=0.1)
        return loss, (met, (lo, lens, ov, ld))

    (jloss, (jmet, (jl, jlens, jvalid, jld))), jg = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True))(variables["params"])
    with torch.no_grad():
        pl, plens, pvalid, pld = pm(t(src).long(), t(dur))
    close(pl, jl)
    close(pld, jld)
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    # generate with the predicted durations, scaled so that they are not 0
    ju, jn, _ = japply(jm, variables, jnp.asarray(src), d_factor=25.0, method="generate")
    pu, pn, _ = pm.generate(t(src).long(), d_factor=25.0)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    assert int(np.asarray(jn).max()) > 0

    lo, _, ov, ld = pm(t(src).long(), t(dur))
    loss, met = PCr.fasttext2unit_loss(lo, ov, t(targets).long(), ld, t(dur),
                                       t(src != cfg.pad_id), label_smoothing=0.1)
    loss.backward()
    metrics_close(met, jmet)
    grads_close(pm, fastspeech2_from_jax_params(flat(jg)))
    pm.zero_grad()


# ------------------------------------------------------------ smoke rehearsal


def test_chip_smoke_speechlm_phase_runs_on_cpu_with_twins():
    """``chip_smoke.phase_speechlm`` at the tiny presets on the CPU: the
    joint updates over a ``MultiCorpusLoader``, greedy CTC requests and
    FastText2Unit's updates and ``generate``, with every kernel flag on
    (the twins run, nothing launches)."""
    out = chip_smoke.phase_speechlm(device="cpu", tiny=True)
    assert out["ok"], out
    assert sum(K.launch_counts().values()) == 0
