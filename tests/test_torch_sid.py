"""The port's SID (s2c) task held against the JAX package.

One set of JAX variables (tiny preset with a speaker head: BatchNorm on the
pooled features, a 16-d embedding and its BatchNorm) crosses into the port
through ``utils/convert.from_jax_params`` and ``from_jax_batch_stats``.
The same numpy inputs then go through ``SpeakerDecoderPostnet`` (softmax,
AM and AAM softmax with and without ``easy_margin``, BatchNorm on and off,
train and eval), ``forward_s2c`` under the three poolings and the [CLS]
slot, the frame shuffle's compaction, ``sid_loss``, ``generate_class`` /
``SIDClassifier``, one ``Trainer`` update against ``make_train_step``,
``SpeechToClassDataset`` and ``cli/train.main --task s2c``; the fairseq
speaker-head keys convert exactly, and ``chip_smoke.py``'s s2c phases run
at the tiny preset.

Torch runs with TF32 off; JAX at ``highest`` matmul precision
(tests/conftest.py).  The tiny preset has no dropout or layerdrop.
Tolerances (PERF.md §2): f32 outputs 2e-4 absolute (logits scaled by the
margin softmax's scale: 2e-4 of it), BatchNorm statistics 1e-5 (absolute,
and relative after a forward of the whole model), losses 1e-4
relative, each gradient within 1e-3 of its parameter's max |g|, parameters
after an update within 1e-5.  The AAM softmax's sqrt(1 - cos^2) has an
infinite derivative at |cos| = 1 on both sides, so its gradients are held
at interior cosines only (the test asserts |cos| < 0.999).
"""

import os

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.data import manifests as JMan
from speecht5_tpu.decode.sid import SIDClassifier as JSIDClassifier
from speecht5_tpu.models.postnets import SpeakerDecoderPostnet as JSpeakerPostnet
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from speecht5_tpu.models.speecht5 import init_model as jinit_model
from speecht5_tpu.train import criterions as JCr
from speecht5_tpu.train import trainer as JT
from speecht5_tpu.utils.checkpoint import prune_for_task as jprune
from speecht5_tpu.utils.convert import load_fairseq_checkpoint as jload

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.data import manifests as PMan
from speecht5_tpu_torch.data.audio import read_audio, write_wav
from speecht5_tpu_torch.decode.sid import SIDClassifier
from speecht5_tpu_torch.models.postnets import SpeakerDecoderPostnet
from speecht5_tpu_torch.models.speecht5 import init_model, shuffle_frames
from speecht5_tpu_torch.train import criterions as PCr
from speecht5_tpu_torch.train import trainer as PT
from speecht5_tpu_torch.utils.checkpoint import prune_for_task
from speecht5_tpu_torch.utils.convert import (from_jax_batch_stats, from_jax_params,
                                              load_fairseq_checkpoint)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
N_CLASSES, EMBED, B, T_WAV = 5, 16, 3, 4000
# the head with every part on; poolings and margins change no parameter
SID_FULL = dict(num_classes=N_CLASSES, embed_dim=EMBED, softmax_type="amsoftmax",
                margin=0.2, scale=30.0)
# the SID recipe's head (speecht5_base_sid: no BatchNorm, no embedding),
# with the AM margin on
SID_RECIPE = dict(SID_FULL, no_pooling_bn=True, no_embed_postnet=True)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _state_dict(variables):
    return {**from_jax_params(_flat(variables["params"])),
            **from_jax_batch_stats(_flat(variables["batch_stats"]))}


def _off_init(variables, seed=5):
    """BatchNorm statistics moved off their init, so that eval reads them."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.standard_normal(x.shape)) + 0.5, jnp.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _cfgs(sid=(), **kw):
    s = {**SID_FULL, **dict(sid)}
    return (JC.speecht5_tiny(sid=JC.SIDConfig(**s), **kw),
            PC.speecht5_tiny(sid=PC.SIDConfig(**s), **kw))


def _setup(sid):
    """JAX variables of the tiny preset with the ``sid`` head, and a port
    model loaded from them (strict)."""
    jcfg, pcfg = _cfgs(sid, feature_grad_mult=1.0)
    _, variables = jinit_model(jcfg, jax.random.PRNGKey(0))
    variables = _off_init(variables)
    model = init_model(pcfg, device="cpu")
    model.load_state_dict(_state_dict(variables), strict=True)
    return variables, model


@pytest.fixture(scope="module")
def full():
    return _setup(())


@pytest.fixture(scope="module")
def recipe():
    return _setup(SID_RECIPE)


def _port(variables, pcfg):
    """A port model of ``pcfg`` with the keys it has of ``variables``."""
    model = init_model(pcfg, device="cpu")
    sd = _state_dict(variables)
    model.load_state_dict({k: sd[k] for k in model.state_dict()}, strict=True)
    return model


def _wav(seed=1, rows=B):
    rng = np.random.default_rng(seed)
    lengths = np.array([T_WAV, 3100, 2300, 3700, 2700, 3400][:rows], np.int32)
    wav = (rng.standard_normal((rows, T_WAV)) * 0.1).astype(np.float32)
    for b, n in enumerate(lengths):
        wav[b, n:] = 0.0
    return wav, lengths


# ---------------------------------------------------------------- postnet


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("softmax", ["softmax", "amsoftmax", "aamsoftmax", "aamsoftmax_easy"])
def test_speaker_postnet_matches_jax(softmax, bn, mode):
    """Logits, the embedding, every gradient (input and parameters) and, on
    a training pass with BatchNorm, the updated statistics.  The AAM margin
    of 1.5 puts cos(pi - m) = -0.07 inside the cosines' range, so both of
    phi's branches are taken (asserted), as are easy_margin's (cos > 0)."""
    easy = softmax.endswith("_easy")
    kw = dict(embed_dim=EMBED, class_num=N_CLASSES, softmax_type=softmax.split("_")[0],
              margin=1.5 if softmax.startswith("aam") else 0.3, scale=7.0,
              easy_margin=easy, no_pooling_bn=not bn, no_embed_postnet=not bn)
    jpost = JSpeakerPostnet(**kw)
    rng = np.random.default_rng(3)
    D, n = 24, 16
    x = (rng.standard_normal((n, D)) * 2).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, n)
    onehot = np.eye(N_CLASSES, dtype=np.float32)[targets]
    gout = rng.standard_normal((n, N_CLASSES)).astype(np.float32)
    gemb = rng.standard_normal((n, EMBED if bn else D)).astype(np.float32)
    v = jpost.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(onehot))
    v = {"params": v["params"], **({"batch_stats": jax.tree_util.tree_map(
        lambda a: a + 0.3, v["batch_stats"])} if bn else {})}
    train = mode == "train"

    def jfn(params, xx):
        out, upd = jpost.apply({**v, "params": params}, xx, jnp.asarray(onehot),
                               deterministic=not train, mutable=["batch_stats"])
        (logits, embed) = out
        return (logits * gout).sum() + (embed * gemb).sum(), (logits, embed, upd)

    (_, (jl, je, upd)), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    cfg = PC.SIDConfig(num_classes=N_CLASSES, embed_dim=EMBED, softmax_type=kw["softmax_type"],
                       margin=kw["margin"], scale=kw["scale"], easy_margin=easy,
                       no_pooling_bn=not bn, no_embed_postnet=not bn)
    post = SpeakerDecoderPostnet(D, cfg)
    sd = {k.split("speaker_decoder_postnet.", 1)[1]: t for k, t in
          {**from_jax_params(_flat({"speaker_decoder_postnet": v["params"]})),
           **from_jax_batch_stats(_flat({"speaker_decoder_postnet": v.get("batch_stats", {})}))
           }.items()}
    post.load_state_dict(sd, strict=True)
    post.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    logits, embed = post(xt, torch.from_numpy(onehot))
    ((logits * torch.from_numpy(gout)).sum() + (embed * torch.from_numpy(gemb)).sum()).backward()
    scale = kw["scale"] if train and softmax != "softmax" else 1.0
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=2e-4 * scale)
    np.testing.assert_allclose(embed.detach().numpy(), np.asarray(je), rtol=0, atol=2e-4)
    want = {k.split("speaker_decoder_postnet.", 1)[1]: t for k, t in
            from_jax_params(_flat({"speaker_decoder_postnet": jgp})).items()}
    want["x"] = torch.from_numpy(np.array(jgx))
    got = {**{n: p.grad for n, p in post.named_parameters()}, "x": xt.grad}
    assert set(got) == set(want)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if name == "bn_pooling.bias" and train and bn:
            # a shift before the embedding's batch-statistics BatchNorm:
            # analytically 0, rounding noise on both sides
            assert max(w.abs().max(), got[name].abs().max()) <= 1e-6 * gmax
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * np.abs(w.numpy()).max(), err_msg=name)
    if train and bn:
        stats = from_jax_batch_stats(_flat({"speaker_decoder_postnet": upd["batch_stats"]}))
        psd = post.state_dict()
        for k, w in stats.items():
            np.testing.assert_allclose(psd[k.split("speaker_decoder_postnet.", 1)[1]].numpy(),
                                       w.numpy(), rtol=0, atol=1e-5, err_msg=k)
    if softmax.startswith("aam") and train:
        with torch.no_grad():
            e = embed / embed.norm(dim=-1, keepdim=True)
            w = post.output_projection.weight
            cos = e @ (w / w.norm(dim=-1, keepdim=True)).t()
        tc = cos[torch.arange(n), torch.from_numpy(targets)]
        assert cos.abs().max() < 0.999      # interior cosines: finite gradients
        th = 0.0 if easy else np.cos(np.pi - kw["margin"])
        assert (tc > th).any() and (tc <= th).any()     # both branches of phi


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("pooling,cls", [("encoder", False), ("encoder-cls", True),
                                         ("decoder", False), ("decoder", True)])
def test_forward_s2c_matches_jax(full, pooling, cls):
    """Under each pooling, with and without the [CLS] slot, on padded rows.
    Eval (BatchNorm on running statistics, cosine logits): logits and
    embedding end to end.  A training pass with targets (AM margin,
    BatchNorm on batch statistics, which it then updates): the pooled
    features against JAX's, then the speaker head on JAX's pooled features
    against JAX's logits, embedding and statistics.  (End to end, the two
    batch-statistics BatchNorms over 6 rows would scale the encoder's f32
    rounding by up to 1 / the smallest channel's std across the batch.)"""
    variables, _ = full
    jcfg, pcfg = _cfgs(dict(pooling=pooling, encoder_cls=cls), feature_grad_mult=1.0)
    jm = JModel(jcfg)
    model = _port(variables, pcfg)
    wav, lengths = _wav(rows=6)
    targets = np.array([1, 4, 0, 2, 3, 1])
    jeval = jm.apply(variables, jnp.asarray(wav), jnp.asarray(lengths),
                     deterministic=True, method="forward_s2c")
    seen = {}

    def record_pooled(next_fun, args, kwargs, context):
        if isinstance(context.module, JSpeakerPostnet) and context.method_name == "__call__":
            seen["pooled"] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record_pooled):
        jtrain, upd = jm.apply(variables, jnp.asarray(wav), jnp.asarray(lengths),
                               jnp.asarray(targets), deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(1)},
                               mutable=["batch_stats"], method="forward_s2c")
    args = (torch.from_numpy(wav), torch.from_numpy(lengths))
    model.eval()
    with torch.no_grad():
        pe = model.forward_s2c(*args)
    for got, want in zip(pe, jeval):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    assert np.abs(np.asarray(jeval[0])).max() <= 1.0 + 1e-5
    head = model.speaker_decoder_postnet
    stats0 = {k: v.clone() for k, v in head.state_dict().items()}
    pooled = []
    hook = head.register_forward_pre_hook(lambda mod, a: pooled.append(a[0]))
    model.train()
    with torch.no_grad():
        model.forward_s2c(*args, torch.from_numpy(targets))
    hook.remove()
    np.testing.assert_allclose(pooled[0].float().numpy(), seen["pooled"], rtol=0, atol=2e-4)
    head.load_state_dict(stats0)
    with torch.no_grad():
        logits, embed = head(torch.from_numpy(np.array(seen["pooled"])),
                             torch.eye(N_CLASSES)[torch.from_numpy(targets)])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jtrain[0]), rtol=0, atol=2e-4 * 30)
    np.testing.assert_allclose(embed.numpy(), np.asarray(jtrain[1]), rtol=0, atol=2e-4)
    sd = model.state_dict()
    for k, w in from_jax_batch_stats(_flat(upd["batch_stats"])).items():
        if k.startswith("speaker_decoder_postnet."):
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def _jax_shuffle(x, valid, perm):
    """A numpy copy of JAX speecht5.py:153-156 for a given permutation."""
    x, valid = x[:, perm], valid[:, perm]
    order = np.argsort(~valid, axis=1, kind="stable")
    return (np.take_along_axis(x, order[:, :, None], axis=1),
            np.take_along_axis(valid, order, axis=1))


def test_shuffle_compaction_matches_jax_and_eval_never_shuffles(full):
    rng = np.random.default_rng(6)
    T = 11
    x = rng.standard_normal((3, T, 4)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.array([[11], [7], [0]])
    perm = rng.permutation(T)
    gx, gv = shuffle_frames(torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(perm))
    wx, wv = _jax_shuffle(x, valid, perm)
    np.testing.assert_array_equal(gx.numpy(), wx)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gv.numpy(), valid)        # still a prefix mask
    variables, _ = full
    _, pcfg = _cfgs(dict(pooling="encoder", shuffle_encoder_input=True))
    _, pcfg_off = _cfgs(dict(pooling="encoder"))
    on, off = _port(variables, pcfg), _port(variables, pcfg_off)
    wav, lengths = _wav(2)
    args = (torch.from_numpy(wav), torch.from_numpy(lengths))
    with torch.no_grad():
        assert torch.equal(on.eval().forward_s2c(*args)[0], off.eval().forward_s2c(*args)[0])
        # a training pass permutes with the generator's randperm, then compacts
        g = torch.Generator().manual_seed(3)
        enc = on.train().encode_speech(*args, generator=g, shuffle=True)
        x0, v0 = on.speech_encoder_prenet(*args)
        xs, vs = shuffle_frames(x0, v0, torch.randperm(x0.shape[1],
                                                       generator=torch.Generator().manual_seed(3)))
        want = on.encoder(xs, vs)
    assert torch.equal(enc["encoder_out"], want["encoder_out"])
    assert not torch.equal(enc["encoder_out"], on.encoder(x0, v0)["encoder_out"])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_sid_loss_matches_jax(smoothing):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((6, N_CLASSES)) * 3).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, 6)
    _, jm = JCr.sid_loss(jnp.asarray(logits), jnp.asarray(targets), smoothing)
    _, pm = PCr.sid_loss(torch.from_numpy(logits), torch.from_numpy(targets), smoothing)
    assert set(pm) == set(jm) == {"loss", "nll_loss", "accuracy"}
    for k in pm:
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)


def test_generate_class_and_classifier_match_jax(full):
    variables, model = full
    jcfg, _ = _cfgs(feature_grad_mult=1.0)
    wav, lengths = _wav(8)
    want = np.asarray(JSIDClassifier(JModel(jcfg), variables)(jnp.asarray(wav),
                                                              jnp.asarray(lengths)))
    got = SIDClassifier(model, device="cpu")(wav, lengths)
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    with torch.no_grad():
        assert model.eval().generate_class(torch.from_numpy(wav),
                                           torch.from_numpy(lengths)).tolist() == want.tolist()


# --------------------------------------------------------------- convert


def test_speaker_head_keys_convert_exactly(tmp_path):
    """A fairseq .pt of a SID model: the port's loader takes every
    speaker-head key (output_embedding, output_projection, both
    BatchNorms), tensor for tensor what the file holds and what JAX's
    loader -> from_jax_params / from_jax_batch_stats gives; prune_for_task
    keeps the head for s2c as JAX's does."""
    _, pcfg = _cfgs()
    sd = init_model(pcfg, torch.Generator().manual_seed(3), "cpu").state_dict()
    g = torch.Generator().manual_seed(4)
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
    path = str(tmp_path / "sid.pt")
    chip_smoke.write_fairseq_checkpoint(path, sd, lacked={})
    state, _, unknown = load_fairseq_checkpoint(path)
    jvars, _, junknown = jload(path)
    want = {**from_jax_params(_flat(jvars["params"])),
            **from_jax_batch_stats(_flat(jvars["batch_stats"]))}
    head = sorted(k for k in sd if k.startswith("speaker_decoder_postnet."))
    assert head == sorted(f"speaker_decoder_postnet.{m}.{p}"
                          for m in ("bn_pooling", "bn_embedding")
                          for p in ("weight", "bias", "running_mean", "running_var")) + [
        "speaker_decoder_postnet.output_embedding.weight",
        "speaker_decoder_postnet.output_projection.weight"]
    assert unknown == junknown == [] and set(state) == set(sd) == set(want)
    for k in sd:
        assert torch.equal(state[k], sd[k]) and torch.equal(want[k], sd[k]), k
    pruned = prune_for_task(state, "s2c")
    jpruned = jprune({"params": jvars["params"]}, "s2c")["params"]
    assert set(head) <= set(pruned)
    assert {k.split(".")[0] for k in pruned} == set(jpruned)


# -------------------------------------------------------------- train step


def _batch(seed):
    wav, lengths = _wav(seed)
    return {"wav": wav, "wav_lengths": lengths,
            "targets": np.random.default_rng(seed).integers(0, N_CLASSES, B)}


def _t(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def test_s2c_loss_gradients_and_update_match_jax(recipe):
    """The s2c loss of JAX's train step (forward_s2c with targets, the AM
    margin, no masking; the recipe's head) against Trainer.loss: metrics and
    every gradient, the conv extractor's included (feature_grad_mult 1.0);
    then one update of accum 2 with the clip active against
    make_train_step: grad norm, loss and parameters (adam_eps 1e-4, so that
    the k_proj biases' rounding-noise gradients move nothing)."""
    variables, _ = recipe
    jcfg, pcfg = _cfgs(SID_RECIPE, feature_grad_mult=1.0)
    jm = JModel(jcfg)
    model = _port(variables, pcfg)
    tkw = dict(lr=1e-3, warmup_steps=2, accum_steps=2, clip_norm=1.0, adam_eps=1e-4)
    b0 = _batch(10)
    loss_fn = JT._loss_for_task(jm, "s2c", JT.TrainConfig(**tkw))
    extra = {"batch_stats": variables["batch_stats"]}
    (jloss, (jmet, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, extra, {k: jnp.asarray(v) for k, v in b0.items()},
                          jax.random.PRNGKey(0), 0), has_aux=True))(variables["params"])
    trainer = PT.Trainer(model, "s2c", PT.TrainConfig(**tkw))
    model.train()
    loss, met = trainer.loss(_t(b0))
    loss.backward()
    assert set(met) == set(jmet)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-4, err_msg=k)
    want = from_jax_params(_flat(jg))
    gmax = max(float(np.abs(v.numpy()).max()) for v in want.values())
    conv = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert np.abs(w).max() == 0.0, name
            continue
        conv += ".feature_extractor.conv_" in name
        if name.endswith("k_proj.bias"):    # analytically 0: rounding noise
            assert max(np.abs(w).max(), p.grad.abs().max().item()) <= 1e-6 * gmax, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    assert conv == len(pcfg.conv_features.layers)

    model = _port(variables, pcfg)
    mbs = [_batch(20), _batch(21)]
    params = variables["params"]
    tcfg = JT.TrainConfig(**tkw)
    state = JT.TrainState(params, JT.make_optimizer(tcfg).init(params),
                          jnp.zeros((), jnp.int32), {"batch_stats": variables["batch_stats"]})
    stacked = {k: jnp.stack([jnp.asarray(mb[k]) for mb in mbs]) for k in mbs[0]}
    state, jm_out = jax.jit(JT.make_train_step(jm, "s2c", tcfg))(
        state, stacked, jax.random.PRNGKey(0))
    trainer = PT.Trainer(model, "s2c", PT.TrainConfig(**tkw))
    m = trainer.train_step([_t(mb) for mb in mbs])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm_out["grad_norm"]), rtol=2e-4)
    np.testing.assert_allclose(float(m["loss"]), float(jm_out["loss"]), rtol=1e-4)
    assert float(m["grad_norm"]) > 1.0      # the clip was active
    got = model.state_dict()
    for name, w in _state_dict({"params": state.params, **state.extra}).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------------ data


def _write_sid_corpus(d, speakers):
    rng = np.random.default_rng(0)
    rows = []
    for i, spk in enumerate(speakers):
        n = 3000 + 700 * i
        write_wav(f"{d}/u{i}.wav", rng.standard_normal(n) * 0.1)
        rows.append(f"u{i}.wav\t{n}\t{spk}")
    with open(f"{d}/sid.tsv", "w") as f:
        f.write(d + "\n" + "\n".join(rows) + "\n")
    return f"{d}/sid.tsv"


def test_sid_dataset_and_collation_equal_jax(tmp_path):
    d = str(tmp_path)
    manifest = _write_sid_corpus(d, ["spk_b", "spk_a", "spk_b", "spk_c"])
    ds = PMan.SpeechToClassDataset(manifest=manifest, normalize=True)
    jds = JMan.SpeechToClassDataset(manifest=manifest, normalize=True)
    assert ds.class_map == jds.class_map == {"spk_a": 0, "spk_b": 1, "spk_c": 2}
    assert ds.num_classes == 3 and len(ds) == 4
    np.testing.assert_array_equal(ds.sizes, jds.sizes)
    items, jitems = [ds[i] for i in range(4)], [jds[i] for i in range(4)]
    for bucketed in (False, True):
        got, want = ds.collate(items, bucketed), jds.collate(jitems, bucketed)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ds.save_class_map(f"{d}/map.txt")
    jds.save_class_map(f"{d}/jmap.txt")
    assert open(f"{d}/map.txt").read() == open(f"{d}/jmap.txt").read()
    assert PMan.SpeechToClassDataset.load_class_map(f"{d}/map.txt") == ds.class_map
    with pytest.raises(ValueError, match="spk_c"):
        PMan.SpeechToClassDataset(manifest=manifest, class_map={"spk_a": 0, "spk_b": 1})
    # the crop: a window of max_sample_size drawn from the seeded generator
    crop = [PMan.SpeechToClassDataset(manifest=manifest, max_sample_size=3500, seed=s)
            for s in (1, 1, 2)]
    full_wav = read_audio(f"{d}/u3.wav")[0]
    windows = [c[3]["wav"] for c in crop]
    assert all(len(w) == 3500 for w in windows) and len(crop[0][0]["wav"]) == 3000
    starts = [int(np.flatnonzero([np.array_equal(full_wav[s:s + 3500].astype(np.float32), w)
                                  for s in range(len(full_wav) - 3500 + 1)])[0])
              for w in windows]
    assert starts[0] == starts[1] == int(np.random.default_rng(1).integers(0, 5100 - 3500 + 1))


def test_cli_train_s2c_runs_resumes_and_validates_on_cpu(tmp_path, capsys):
    """--task s2c on the tiny preset: the class count from the manifest,
    class_map.txt in --save-dir, 2 updates and a resume that validates
    against the training map (a validation speaker outside it fails)."""
    d = str(tmp_path)
    manifest = _write_sid_corpus(d, ["b", "a", "c", "a"])
    args = ["--task", "s2c", "--arch", "speecht5_tiny", "--manifest", manifest,
            "--save-dir", f"{d}/ckpt", "--batch-size", "2", "--log-interval", "1",
            "--max-sample-size", "4000", "--device", "cpu",
            "--override", "sid.no_pooling_bn=True", "--override", "sid.no_embed_postnet=True"]
    out = cli_train.main(args + ["--max-updates", "2"])
    assert out["steps"] == 2 and out["finite"]
    assert open(f"{d}/ckpt/class_map.txt").read() == "a\t0\nb\t1\nc\t2\n"
    saved = torch.load(out["checkpoint"], weights_only=True)["model"]
    assert saved["speaker_decoder_postnet.output_projection.weight"].shape == (3, 64)
    out = cli_train.main(args + ["--max-updates", "3", "--valid-manifest", manifest,
                                 "--valid-interval", "1"])
    assert out["steps"] == 3 and len(out["history"]) == 1
    assert set(out["history"][0]) == {"loss", "nll_loss", "accuracy", "grad_norm"}
    assert '"valid_accuracy"' in capsys.readouterr().out
    os.makedirs(f"{d}/x")
    other = _write_sid_corpus(f"{d}/x", ["a", "zz"])
    with pytest.raises(ValueError, match="zz"):
        cli_train.main(args + ["--max-updates", "4", "--valid-manifest", other])


def test_chip_smoke_s2c_phases_run_on_cpu_with_twins():
    """Phases 17 and 18 at the tiny preset on the CPU (the SID recipe's head:
    no BatchNorm, no embedding): the twins run, so no launches; every
    encoder layer runs once per micro-batch."""
    flags = ["--batch-size", "2", "--accum", "2", "--max-sample-size", "8000"]
    trained = chip_smoke.phase_train_s2c("speecht5_tiny", device="cpu", n_utts=4, updates=2,
                                         seconds=(0.3, 0.8), flags=flags)
    assert trained["classes"] == 4 and trained["micro_batches"] == 4
    assert trained["layer_runs"] == 2 * 4 and set(trained["counts"].values()) == {0}
    with pytest.raises(AssertionError, match="s2c path launches wrong"):
        chip_smoke.check_speech_train_counts(trained, PC.speecht5_tiny(), 0, "s2c")
    cfg = PC.speecht5_tiny(sid=PC.SIDConfig(num_classes=4, no_pooling_bn=True,
                                            no_embed_postnet=True))
    parity = chip_smoke.phase_s2c_parity(cfg, device="cpu", batch=2, seconds=(0.3, 0.8),
                                         max_sample_size=8000)
    assert parity["loss_rel_diff"] < 1e-5 and parity["class_ids_kernel"] == parity[
        "class_ids_plain"]
    assert len(parity["inference"]) == 2
