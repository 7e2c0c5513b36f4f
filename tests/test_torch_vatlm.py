"""VATLM in the port, held against the JAX package.

At ``vatlm_tiny`` (f32; and a variant with two label sets (20, 12) and
``modality_fuse="add"``), on JAX's initial parameters and ``batch_stats``
carried by ``utils/convert.vatlm_from_jax_params`` (strict loads):
``fuse_features`` for every modality subset and under both modality
dropout draws, ``VideoFrontend`` in eval mode and in train mode with the
running statistics after the pass (1e-5; at the tiny 16 x 16 crop and the
published 88 x 88, where flax's strided "SAME" pads asymmetrically),
``forward_pretrain`` under ``hubert_loss`` with two label sets,
``forward_asr``, the cached decode step, ``ASRDecoder(encode_method=
"encode_av")`` tokens, the JAX recipe's three-stream loss with its
gradients and the BatchNorm statistics it carries from stream to stream,
the kernel flags' twins, the port's recipe, and the recipe's per-process
mask seed (a reference fault, ROADMAP C.2).  The HuBERT masks and the
modality-dropout draws are handed to both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import speecht5_tpu.models.vatlm as JV
from speecht5_tpu.decode.asr import ASRDecoder as JASRDecoder
from speecht5_tpu.ops.masking import compute_span_mask as jspan_mask
from speecht5_tpu.train.criterions import hubert_loss as jhubert_loss

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.config as PC
import speecht5_tpu_torch.models.vatlm as PV
from speecht5_tpu_torch.decode.asr import ASRDecoder
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.recipes import vatlm_pretrain as R
from speecht5_tpu_torch.train import criterions as PCr
from speecht5_tpu_torch.train import joint as PJ
from speecht5_tpu_torch.utils.convert import vatlm_from_jax_params

from test_torch_speechlm import Draws, close, flat, japply, metrics_close, routes_close, t
from test_torch_yitrans import patch_jax_masks

TOL = 1e-5
B, T = 2, 12
LENS = np.array([T, T - 4], np.int32)
PREV = np.array([[2, 5, 9, 11], [2, 6, 7, 1]], np.int32)
KERNEL_FLAGS = ["encoder.use_pallas_attn=True", "encoder.use_pallas_attn_train=True",
                "decoder.use_pallas_attn=True"]
RNGS = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1),
        "modality": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}
TWO_SETS = dict(num_classes=(20, 12), modality_fuse="add")


def inputs(cfg, seed=0, frames=T, size=None):
    rng = np.random.default_rng(seed)
    size = size or cfg.video_size
    return {"audio": rng.standard_normal((B, frames, cfg.audio_feat_dim)).astype(np.float32),
            "video": rng.standard_normal((B, frames, size, size, 1)).astype(np.float32),
            "phones": rng.integers(4, cfg.phone_vocab_size, (B, frames - 3)).astype(np.int32),
            "targets": [rng.integers(0, c, (B, frames)).astype(np.int32)
                        for c in cfg.num_classes]}


def _init(cfg):
    x = inputs(cfg)
    return jax.jit(lambda: JV.VATLMModel(cfg).init(
        RNGS, jnp.asarray(x["audio"]), jnp.asarray(x["video"]), jnp.asarray(LENS),
        jnp.asarray(x["phones"]), jnp.asarray(PREV), method="init_all"))()


def port_vatlm(variables, overrides=(), **kw):
    model = PV.VATLMModel(PC.apply_overrides(PV.vatlm_tiny(**kw), list(overrides)))
    model.load_state_dict(vatlm_from_jax_params(flat(variables["params"]),
                                                flat(variables["batch_stats"])), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def vt():
    cfg = JV.vatlm_tiny()
    variables = _init(cfg)
    return cfg, variables, port_vatlm(variables)


@pytest.fixture
def draws(monkeypatch):
    d = Draws()
    patch_jax_masks(monkeypatch, JV, d)
    return d


def stats_close(model, jstats, atol=TOL):
    """The port's BatchNorm running statistics against a JAX
    ``batch_stats`` collection."""
    want = vatlm_from_jax_params({}, flat(jstats))
    got = dict(model.named_buffers())
    assert want and set(want) <= set(got)
    for k, w in want.items():
        close(got[k], w.numpy(), atol=atol, msg=k)


SUBSETS = {"av_phone": ("audio", "video", "phones"), "audio": ("audio",),
           "video": ("video",), "phone": ("phones",)}


@pytest.mark.parametrize("case", [*SUBSETS, "drop_audio", "drop_video"])
def test_fuse_features_match_jax(vt, case):
    """Fused features and valid masks: every modality subset in eval mode
    (missing ones zeros; phones cut or padded to T), and in train mode
    under modality dropout 1 with audio dropout 1 (audio zeroed) or 0
    (video zeroed), the video BatchNorm on batch statistics."""
    cfg, variables, _ = vt
    x = inputs(cfg, seed=1)
    train = case.startswith("drop")
    keys = SUBSETS.get(case, ("audio", "video", "phones"))
    kw = {}
    if train:
        kw = dict(modality_dropout=1.0, audio_dropout=1.0 if case == "drop_audio" else 0.0)
    cfg = JV.vatlm_tiny(**kw)
    model = port_vatlm(variables, **kw).train(train)
    args = [x[k] if k in keys else None for k in ("audio", "video")]
    ph = x["phones"] if "phones" in keys else None
    lens = LENS if keys != ("phones",) else None

    def fuse(m, a, v, n, p):
        return m.fuse_features(a, v, n, p, deterministic=not train)

    jargs = [None if a is None else jnp.asarray(a) for a in (*args, lens, ph)]
    if train:
        (jx, jvalid), _ = japply(JV.VATLMModel(cfg), variables, *jargs, rngs=RNGS,
                                 mutable=["batch_stats"], method=fuse)
    else:
        jx, jvalid = japply(JV.VATLMModel(cfg), variables, *jargs, method=fuse)
    pargs = [None if a is None else t(a) for a in (*args, lens)]
    with torch.no_grad():
        px, pvalid = model.fuse_features(*pargs, None if ph is None else t(ph).long(),
                                         modality_drop=(True, case == "drop_audio"))
    close(px, jx, atol=TOL)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("size", [16, 88])
def test_video_frontend_eval_and_train_statistics_match_jax(vt, size):
    """``VideoFrontend`` in eval mode, and in train mode: its output and
    every BatchNorm's running mean / var after the pass (1e-5).  At 88 the
    stem pads (2, 3), the max-pool (0, 1), the stride-2 blocks (0, 1)."""
    cfg, variables, model = vt
    video = inputs(cfg, seed=2, frames=3, size=size)["video"]
    vf = {"params": variables["params"]["video_frontend"],
          "batch_stats": variables["batch_stats"]["video_frontend"]}
    jm = JV.VideoFrontend(JV.vatlm_tiny(video_size=size))
    jeval = japply(jm, vf, jnp.asarray(video), train=False)
    jtrain, mut = japply(jm, vf, jnp.asarray(video), train=True, mutable=["batch_stats"])
    front = port_vatlm(variables).video_frontend
    with torch.no_grad():
        close(front.eval()(t(video)), jeval, atol=TOL)
        close(front.train()(t(video)), jtrain, atol=TOL)
    stats_close(front, mut["batch_stats"])
    assert PV.same_pads(88, 7, 2) == (2, 3) and PV.same_pads(44, 3, 2) == (0, 1)


def test_pretrain_hubert_loss_with_two_label_sets_matches_jax(draws):
    """``forward_pretrain`` at ``num_classes=(20, 12)``, ``modality_fuse=
    "add"`` (no post_extract_proj), the HuBERT masks handed in: each label
    set's logits (the projection split per set over
    ``label_embs_concat``), the time mask, and ``hubert_loss``'s loss and
    metrics over both sets."""
    cfg = JV.vatlm_tiny(**TWO_SETS)
    variables = _init(cfg)
    model = port_vatlm(variables, **TWO_SETS)
    assert model.post_extract_proj is None and model.final_proj.out_features == 32
    x = inputs(cfg, seed=3)

    def fwd(m, a, v, n, p, *tg):
        out = m.forward_pretrain(a, v, n, phone_tokens=p, mask=True, deterministic=True)
        return out, jhubert_loss(out["logits"], list(tg), out["time_mask"], out["valid_mask"])

    jout, (jloss, jm) = japply(JV.VATLMModel(cfg), variables, jnp.asarray(x["audio"]),
                               jnp.asarray(x["video"]), jnp.asarray(LENS),
                               jnp.asarray(x["phones"]),
                               *map(jnp.asarray, x["targets"]), rngs=RNGS, method=fwd)
    masks = draws.port_masks(LENS, T)
    with torch.no_grad():
        out = model.forward_pretrain(t(x["audio"]), t(x["video"]), t(LENS),
                                     phone_tokens=t(x["phones"]).long(), masks=masks)
        loss, m = PCr.hubert_loss(out["logits"], [t(tg).long() for tg in x["targets"]],
                                  out["time_mask"], out["valid_mask"])
    assert [lg.shape[-1] for lg in out["logits"]] == [20, 12]
    for got, want in zip(out["logits"], jout["logits"]):
        close(got, want, atol=TOL)
    np.testing.assert_array_equal(out["time_mask"].numpy(), np.asarray(jout["time_mask"]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    metrics_close(m, jm)
    assert {"loss_m_0", "loss_m_1"} <= set(m)


def test_forward_asr_decode_step_and_beam_match_jax(vt):
    """``forward_asr`` (1e-5), ``text_decode_step`` step by step against
    ``decode_text``, and ``ASRDecoder(encode_method="encode_av")``: JAX's
    whole token array, lengths and scores, the decode-step kernel's twin
    on."""
    cfg, variables, model = vt
    x = inputs(cfg, seed=4)
    a, v = x["audio"], x["video"]
    jl, jvalid = japply(JV.VATLMModel(cfg), variables, jnp.asarray(a), jnp.asarray(v),
                        jnp.asarray(LENS), jnp.asarray(PREV), deterministic=True,
                        method="forward_asr")
    with torch.no_grad():
        pl, pvalid = model.forward_asr(t(a), t(v), t(LENS), t(PREV).long())
        enc = model.encode_av(t(a), t(v), t(LENS))
        cache = model.init_text_cache(enc, B, 8)
        steps = []
        for i in range(PREV.shape[1]):
            lg, cache = model.text_decode_step(t(PREV[:, i : i + 1]).long(), cache,
                                               enc_valid=enc["valid_mask"])
            steps.append(lg)
    close(pl, jl, atol=TOL)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    close(torch.stack(steps, 1)[0], pl.numpy()[0], atol=1e-4)     # row 0 has no padding
    kw = dict(beam_size=3, max_len=8, min_len=2, encode_method="encode_av")
    jres = JASRDecoder(JV.VATLMModel(cfg), variables, **kw)(
        jnp.asarray(a), jnp.asarray(v), jnp.asarray(LENS))
    res = ASRDecoder(port_vatlm(variables, ["decoder.use_pallas_attn=True"]), device="cpu",
                     **kw)(a, v, LENS)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores), atol=TOL, rtol=TOL)


def recipe_batch(cfg, seed=5):
    b = R.synthetic_batch(cfg, seed, batch=B, frames=T)
    b["lengths"] = LENS.copy()
    return b


def jax_recipe_loss(cfg, variables, b):
    """The JAX recipe's loss (recipes/vatlm_pretrain.py:87-104: the three
    streams, batch_stats carried from one to the next), its gradients and
    the statistics after it; the masks from the patched draws."""
    model = JV.VATLMModel(cfg)
    streams = (("av", True, False), ("audio_only", False, False), ("phone", False, True))

    def loss_fn(p, bs):
        total, metrics = 0.0, {}
        for name, video, phone in streams:
            out, mut = model.apply(
                {"params": p, "batch_stats": bs},
                jnp.asarray(b["audio"]) if name != "phone" else None,
                jnp.asarray(b["video"]) if video else None, jnp.asarray(b["lengths"]),
                phone_tokens=jnp.asarray(b["phones"]) if phone else None, mask=True,
                deterministic=False, rngs={"mask": RNGS["mask"], "modality": RNGS["modality"],
                                           "dropout": RNGS["dropout"]},
                mutable=["batch_stats"], method="forward_pretrain")
            bs = mut.get("batch_stats", bs)
            loss, _ = jhubert_loss([out["logits"][0]], [jnp.asarray(b["targets"])],
                                   out["time_mask"], out["valid_mask"])
            total = total + loss
            metrics[name] = loss
        return total, (metrics, bs)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"],
                                                             variables["batch_stats"])


def stream_draws(d: Draws):
    return {name: {"masks": d.port_masks(LENS, T)} for name, _ in PJ.VATLM_STREAMS}


def test_three_stream_loss_gradients_and_statistics_match_the_jax_recipe(vt, draws):
    """``train/joint.vatlm_pretrain_loss`` against the JAX recipe's loss
    function: the summed loss and each stream's (1e-5), every gradient
    (1e-4 of max |g|), and the video BatchNorm statistics after the AV
    stream, the only one with video (1e-5)."""
    cfg, variables, _ = vt
    b = recipe_batch(cfg)
    (jloss, (jm, jstats)), jg = jax_recipe_loss(cfg, variables, b)
    model = port_vatlm(variables).train()
    loss, m = PJ.vatlm_pretrain_loss(model, R.on_device(b, "cpu"), draws=stream_draws(draws))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    for k in jm:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=TOL, err_msg=k)
    stats_close(model, jstats)
    want = {n: g.numpy() for n, g in vatlm_from_jax_params(flat(jg), {}).items()}
    gmax = max(np.abs(w).max() for w in want.values())
    for n, p in model.named_parameters():
        w = want[n]
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        tol = 1e-6 * gmax if n.endswith("k_proj.bias") else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=max(tol, 1e-12), err_msg=n)


def test_kernel_flags_take_the_twins_on_the_cpu(vt, draws):
    cfg, variables, _ = vt
    b = R.on_device(recipe_batch(cfg), "cpu")
    K.reset_launch_counts()
    models = [port_vatlm(variables, flags).train() for flags in ((), KERNEL_FLAGS)]
    losses = []
    for model in models:
        loss, _ = PJ.vatlm_pretrain_loss(model, b, draws=stream_draws(draws))
        loss.backward()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    routes_close(models[1], models[0])
    assert sum(K.launch_counts().values()) == 0


def test_recipe_every_stream_loss_falls():
    """``recipes/vatlm_pretrain.run`` at its default 100 updates on the
    CPU: each stream's last loss under its first (the JAX recipe's closing
    assert)."""
    out = R.run(device="cpu", log=lambda s: None)
    assert len(out["losses"]) == R.DEFAULT_STEPS and np.isfinite(out["losses"]).all()
    for name, _ in PJ.VATLM_STREAMS:
        assert out["last"][name] < out["first"][name], (name, out["first"], out["last"])


def test_recipe_stream_masks_depend_on_the_process_hash_seed(vt, draws):
    """Reference fault (ROADMAP C.2): the JAX recipe keys each stream's
    mask RNG by ``fold_in(rng, hash(name) % 997)`` (:92); Python salts
    ``str`` hashes per process, so two runs with the same ``--seed`` mask
    different frames.  The port takes each stream's masks as arguments:
    the same draws give the same loss."""
    code = "print(hash('av') % 997)"
    salts = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        salts.append(int(subprocess.run([sys.executable, "-c", code], env=env, check=True,
                                         capture_output=True, text=True).stdout))
    assert salts[0] != salts[1]
    key = jax.random.PRNGKey(7)
    # at the recipe's masking (0.8, spans of 10) over 100-frame clips
    m0, m1 = (np.asarray(jspan_mask(jax.random.fold_in(key, s), jnp.asarray([100, 80]), 100,
                                    0.8, 10, 2)) for s in salts)
    assert (m0 != m1).any()
    cfg, variables, _ = vt
    b = R.on_device(recipe_batch(cfg), "cpu")
    losses = [PJ.vatlm_pretrain_loss(port_vatlm(variables).train(), b,
                                     draws=stream_draws(draws))[0].item() for _ in range(2)]
    assert losses[0] == losses[1]
