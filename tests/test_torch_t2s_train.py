"""The port's t2s (TTS fine-tune) train step held against the JAX package.

One set of JAX variables (tiny preset, the 81-symbol letter vocabulary,
parameters and BatchNorm statistics) crosses into the port through
``utils/convert.from_jax_params`` and ``from_jax_batch_stats``.  The same
numpy inputs then go through the t2s collation and dataset, the text
encoder and speech decoder prenets (the Tacotron prenet with JAX's keep
masks handed in), the speech postnet's BatchNorm in train and eval mode,
``forward_t2s`` with its cross-attention weights (f32 and bf16),
``tts_loss`` with the guided attention loss and every gradient, three
updates of the port's ``Trainer`` against ``make_train_step`` (accum 2,
the decoder frozen for one update, BatchNorm statistics threaded through
the micro-batches), and ``cli/train.main --task t2s`` on the CPU with a
resume that restores the BatchNorm buffers.

Torch runs with TF32 off; JAX at ``highest`` matmul precision
(tests/conftest.py).  Stochastic parts are off on both sides where the
two frameworks cannot draw the same numbers: the tiny preset has no
dropout or layerdrop; the postnet's dropout and the Tacotron prenet's
(which JAX's step draws from its ``prenet`` rng) are set to 0, and the
Tacotron prenet is held against JAX's draws on its own.  Tolerances are
those of tests/test_torch_s2t_train.py: f32 outputs 2e-4 absolute, losses
2e-4 relative, each gradient within 2e-4 of its parameter's max |g| (the
k_proj biases, analytically 0, within 1e-6 of the largest gradient),
parameters after 3 updates within 1e-5; bf16 outputs within 3e-2 x
max|ref| (ROADMAP C.2).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.data import manifests as JMan
from speecht5_tpu.data.dictionary import Dictionary as JDictionary
from speecht5_tpu.models.postnets import SpeechDecoderPostnet as JSpeechPostnet
from speecht5_tpu.models.prenets import TacotronPrenet as JTacotronPrenet
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from speecht5_tpu.train import criterions as JCr
from speecht5_tpu.train import trainer as JT

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.data import manifests as PMan
from speecht5_tpu_torch.data.audio import write_wav
from speecht5_tpu_torch.data.dictionary import Dictionary
from speecht5_tpu_torch.models.postnets import SpeechDecoderPostnet
from speecht5_tpu_torch.models.prenets import TacotronPrenet
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.train import criterions as PCr
from speecht5_tpu_torch.train import trainer as PT
from speecht5_tpu_torch.utils.checkpoint import restore_latest, save_checkpoint
from speecht5_tpu_torch.utils.convert import from_jax_batch_stats, from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the postnet's dropout, and the Tacotron prenet's (JAX draws it whenever
# it is given a prenet rng, as its train step always is)
NO_DROPOUT = ["speech_postnet.postnet_dropout=0.0", "speech_prenet.dropout=0.0"]
B = 2


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _state_dict(params, batch_stats):
    return {**from_jax_params(_flat(params)),
            **from_jax_batch_stats(_flat(batch_stats))}


def _init_both(m, wav, lens, prev, tokens, prev_mel, tgt_lengths, spk):
    m.forward_t2s(tokens, prev_mel, tgt_lengths, spk, deterministic=True)
    m.hubert_logits(m.encode_speech(wav, lens))      # the HuBERT head the port has
    return m.forward_s2t(wav, lens, prev, mask=False, deterministic=True)


def _setup(overrides=(), dtype="float32", **kw):
    """JAX model + variables of the s2t and t2s forwards and the port model
    with the same parameters and BatchNorm statistics."""
    kw = {**chip_smoke.DICT_CFG, "dtype": dtype, **kw}
    ov = NO_DROPOUT + list(overrides)
    jcfg = JC.apply_overrides(JC.speecht5_tiny(**kw), ov)
    jm = JModel(jcfg)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)),
        jnp.full((1,), 4000, jnp.int32), jnp.full((1, 4), 2, jnp.int32),
        jnp.full((1, 4), 2, jnp.int32), jnp.zeros((1, 2, jcfg.n_mels)),
        jnp.full((1,), 2, jnp.int32), jnp.ones((1, jcfg.spk_embed_dim)),
        method=_init_both))()
    # move the BN statistics off their init so that eval mode reads them
    rng = np.random.default_rng(5)
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.standard_normal(x.shape)) + 0.5, jnp.float32),
        variables["batch_stats"])}
    pcfg = PC.apply_overrides(PC.speecht5_tiny(**kw), ov)
    model = init_model(pcfg, device="cpu")
    model.load_state_dict(_state_dict(variables["params"], variables["batch_stats"]),
                          strict=True)
    return jcfg, jm, variables, pcfg, model


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _inputs(cfg, seed=0):
    """tokens [B, 9] (one row padded), prev_mel [B, 6, n_mels] with a zero
    BOS frame, dec_lengths_r [6, 4], x-vectors [B, spk_dim]."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 30, (B, 9))
    tokens[0, -1] = cfg.eos_id
    tokens[1, 6], tokens[1, 7:] = cfg.eos_id, cfg.pad_id
    prev = (rng.standard_normal((B, 6, cfg.n_mels)) - 4.0).astype(np.float32)
    prev[:, 0] = 0.0
    prev[1, 4:] = 0.0
    return {"tokens": tokens, "prev_mel": prev,
            "dec_lengths_r": np.array([6, 4], np.int32),
            "spkembs": rng.standard_normal((B, cfg.spk_embed_dim)).astype(np.float32)}


def _t(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ------------------------------------------------------------------ data


def _write_t2s_corpus(d, n, seed=0, spk_dim=16):
    """n short WAVs, a manifest, letter transcripts and x-vectors in ``d``."""
    rng = np.random.default_rng(seed)
    rows, labels = [], []
    os.makedirs(f"{d}/xv", exist_ok=True)
    for i in range(n):
        secs = 0.3 + 0.13 * i
        write_wav(f"{d}/t{i}.wav", chip_smoke.synth_audio(secs, seed + i))
        np.save(f"{d}/xv/t{i}.npy", rng.standard_normal(spk_dim).astype(np.float32))
        rows.append(f"t{i}.wav\t{int(secs * 16000)}")
        labels.append(" ".join(rng.choice(list("ABCDE|"), 4 + 3 * i)))
    with open(f"{d}/tts.tsv", "w") as f:
        f.write(d + "\n" + "\n".join(rows) + "\n")
    with open(f"{d}/tts.ltr", "w") as f:
        f.write("\n".join(labels) + "\n")
    return chip_smoke.write_dictionary(d)


@pytest.mark.parametrize("device_mel", [False, True], ids=["host_mel", "device_mel"])
def test_t2s_dataset_and_collation_equal_jax(tmp_path, device_mel):
    d = str(tmp_path)
    dict_path = _write_t2s_corpus(d, 3)
    kw = dict(manifest=f"{d}/tts.tsv", labels=f"{d}/tts.ltr", spkemb_dir=f"{d}/xv",
              reduction_factor=2, n_mels=20, device_mel=device_mel)
    ds = PMan.TextToSpeechDataset(dictionary=Dictionary.load(dict_path), **kw)
    jds = JMan.TextToSpeechDataset(dictionary=JDictionary.load(dict_path), **kw)
    assert len(ds) == len(jds) == 3
    items = [ds[i] for i in range(3)]
    jitems = [jds[i] for i in range(3)]
    for it, jit in zip(items, jitems):
        assert it.keys() == jit.keys()
        for k in it:
            np.testing.assert_array_equal(it[k], jit[k])
    for bucketed in (False, True):
        got = ds.collate(items, 2, 1, bucketed=bucketed)
        want = jds.collate(jitems, 2, 1, bucketed=bucketed)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        mel = PMan.collate_mel_targets(items, 3, 20, bucketed, device_mel)
        jmel = JMan.collate_mel_targets(jitems, 3, 20, bucketed, device_mel)
        for k in mel:
            np.testing.assert_array_equal(mel[k], jmel[k], err_msg=k)
    assert (PMan.TOKEN_BUCKETS, PMan.FRAME_BUCKETS, PMan.MEL_N_FFT, PMan.MEL_HOP) == (
        JMan.TOKEN_BUCKETS, JMan.FRAME_BUCKETS, JMan.MEL_N_FFT, JMan.MEL_HOP)


# --------------------------------------------------------------- modules


def test_text_encoder_and_speech_decoder_prenets_match_jax(tiny):
    jcfg, jm, variables, _, model = tiny
    b = _inputs(jcfg)
    jx, jvalid = jm.apply(variables, jnp.asarray(b["tokens"]),
                          method=lambda m, t: m.text_encoder_prenet(t))
    x, valid = model.text_encoder_prenet(torch.from_numpy(b["tokens"]))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), atol=2e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # rate 0: JAX's draw (if any) and the port's all-kept masks are identity
    jy, jsv = jm.apply(variables, *(jnp.asarray(b[k]) for k in
                                    ("prev_mel", "dec_lengths_r", "spkembs")),
                       method=lambda m, *a: m.speech_decoder_prenet(*a))
    layers, units = jcfg.speech_prenet.layers, jcfg.speech_prenet.units
    ones = [torch.ones(B, 6, units, dtype=torch.bool)] * layers
    y, sv = model.speech_decoder_prenet(
        *(torch.from_numpy(b[k]) for k in ("prev_mel", "dec_lengths_r", "spkembs")),
        keep_masks=ones)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-4)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_tacotron_prenet_with_jax_keep_masks_matches_jax(tiny, rate):
    """JAX's TacotronPrenet draws keep = bernoulli(split(rng)) per block; the
    same masks handed to the port give the same output."""
    jcfg, _, variables, _, model = tiny
    params = variables["params"]["speech_decoder_prenet"]["prenet"]
    layers, units = jcfg.speech_prenet.layers, jcfg.speech_prenet.units
    x = np.random.default_rng(1).standard_normal((B, 7, jcfg.n_mels)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jout = JTacotronPrenet(layers, units, rate).apply({"params": params},
                                                      jnp.asarray(x), key)
    masks, rng = [], key
    for _ in range(layers):
        rng, sub = jax.random.split(rng)
        masks.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 1.0 - rate, (B, 7, units)))))
    pre = TacotronPrenet(jcfg.n_mels, layers, units, rate)
    pre.load_state_dict(model.speech_decoder_prenet.prenet.state_dict())
    out = pre(torch.from_numpy(x), masks)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-4)
    assert 0 < sum(int((~m).sum()) for m in masks)
    pre.eval()      # the port's own draws: on in eval mode too
    torch.manual_seed(0)
    assert not torch.equal(pre(torch.from_numpy(x)), pre(torch.from_numpy(x)))


@pytest.mark.parametrize("use_batch_norm", [True, False])
def test_speech_postnet_batchnorm_train_and_eval_match_jax(use_batch_norm):
    """Train mode: batch statistics in f32 over all B x T positions and the
    running statistics updated with momentum 0.9 and the biased variance;
    eval mode: the running statistics.  Without BatchNorm the convs carry
    biases."""
    jcfg = JC.apply_overrides(JC.speecht5_tiny(), NO_DROPOUT + [
        f"speech_postnet.use_batch_norm={use_batch_norm}"])
    pcfg = PC.apply_overrides(PC.speecht5_tiny(), NO_DROPOUT + [
        f"speech_postnet.use_batch_norm={use_batch_norm}"])
    z = np.random.default_rng(2).standard_normal((B, 5, 64)).astype(np.float32) * 3
    jpost = JSpeechPostnet(jcfg)
    v = jpost.init(jax.random.PRNGKey(3), jnp.asarray(z))
    v = jax.tree_util.tree_map(lambda a: a + 0.1, dict(v))  # nonzero biases / stats
    post = SpeechDecoderPostnet(pcfg)
    post.load_state_dict({k.split("speech_decoder_postnet.", 1)[1]: t for k, t in
                          _state_dict({"speech_decoder_postnet": v["params"]},
                                      {"speech_decoder_postnet": v.get("batch_stats", {})}
                                      ).items()}, strict=True)
    post.train()
    (jb, ja, jl), upd = jpost.apply(v, jnp.asarray(z), deterministic=False,
                                    mutable=["batch_stats"])
    b, a, logits = post(torch.from_numpy(z))
    for got, want in ((b, jb), (a, ja), (logits, jl)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4)
    if use_batch_norm:
        want = from_jax_batch_stats(_flat({"speech_decoder_postnet": upd["batch_stats"]}))
        got = post.state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(got[k.split("speech_decoder_postnet.", 1)[1]].numpy(),
                                       w.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        v = {"params": v["params"], **upd}
    post.eval()
    jb, ja, jl = jpost.apply(v, jnp.asarray(z), deterministic=True)
    with torch.no_grad():
        b, a, logits = post(torch.from_numpy(z))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=2e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_t2s_and_cross_weights_match_jax(dtype):
    """forward_t2s on a training pass (BatchNorm on batch statistics, which
    it then updates): frames before and after the postnet, stop logits,
    every layer's cross-attention weights [L, B, H, T_r, T_tokens] and the
    updated statistics; f32 at 2e-4 (statistics 1e-5), bf16 at 3e-2 x
    max|ref|.  bf16 also holds the port's output after the postnet and its
    statistics to a limit that JAX sets itself: JAX bf16 and JAX f32 on the
    same batch and weights differ by d, and two bf16 runs that are each
    within d of f32 differ by at most 2 d.  Train-mode BatchNorm normalises
    each channel over the batch's 24 frames and so amplifies the decoder's
    bf16 rounding in both frameworks, so d grows several times across the
    postnet; the postnet alone is therefore also held on JAX's own
    frames."""
    jcfg, jm, variables, pcfg, model = _setup(dtype=dtype)
    b = _inputs(jcfg, seed=4)
    args = [jnp.asarray(b[k]) for k in ("tokens", "prev_mel", "dec_lengths_r", "spkembs")]

    def jax_forward(module):
        return jax.jit(lambda v, *a: module.apply(
            v, *a, deterministic=False, mutable=["batch_stats"], method="forward_t2s"))(
            variables, *args)

    jout, upd = jax_forward(jm)
    model.train()
    post = model.speech_decoder_postnet
    stats0 = {k: v.clone() for k, v in post.state_dict().items()}
    ones = [torch.ones(B, 6, jcfg.speech_prenet.units, dtype=torch.bool)] * 2
    out = model.forward_t2s(*(torch.from_numpy(np.asarray(a)) for a in args),
                            keep_masks=ones)
    L, H = jcfg.decoder.num_layers, jcfg.decoder.num_heads
    assert out[3].shape == (L, B, H, 6, 9) and out[3].dtype == torch.float32
    for name, got, want in zip(("before", "after", "stop", "cross"), out, jout):
        got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape, name
        tol = 2e-4 if dtype == "float32" else 3e-2 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
    stats = from_jax_batch_stats(_flat(upd["batch_stats"]))
    sd = model.state_dict()
    for k, w in stats.items():
        tol = 1e-5 if dtype == "float32" else 3e-2 * np.abs(w.numpy()).max()
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=tol, err_msg=k)
    if dtype == "float32":
        return
    f32_out, f32_upd = jax_forward(JModel(JC.replace(jcfg, dtype="float32")))
    want = np.asarray(jout[1], np.float32)
    d = np.abs(want - np.asarray(f32_out[1])).max()
    np.testing.assert_allclose(out[1].detach().float().numpy(), want, rtol=0,
                               atol=2 * d, err_msg="after, against JAX's own d")
    f32_stats = from_jax_batch_stats(_flat(f32_upd["batch_stats"]))
    for k, w in stats.items():
        d = np.abs(w.numpy() - f32_stats[k].numpy()).max()
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=2 * d,
                                   err_msg=f"{k}, against JAX's own d")
    post.load_state_dict(stats0)
    before = torch.from_numpy(np.array(jout[0], np.float32))
    np.testing.assert_allclose((before + post.postnet(before).float()).detach().numpy(),
                               want, rtol=0, atol=3e-2 * np.abs(want).max(),
                               err_msg="the postnet on JAX's frames")


@pytest.mark.parametrize("integration", ["add", "concat"])
def test_model_level_x_vector_integration_matches_jax(integration):
    """spk_embed_integration "add" / "concat": the L2-normalised x-vector
    projected and added to, or concatenated with and projected into, the
    encoder output (``spkembs_projection``), through decode_speech."""
    jcfg, jm, variables, _, model = _setup(spk_embed_integration=integration)
    assert model.spkembs_projection is not None
    assert model.speech_decoder_prenet.spkembs_layer is None
    b = _inputs(jcfg, seed=8)
    args = [b[k] for k in ("tokens", "prev_mel", "dec_lengths_r", "spkembs")]
    jout = jax.jit(lambda v, *a: jm.apply(v, *a, deterministic=True,
                                          method="forward_t2s"))(
        variables, *(jnp.asarray(a) for a in args))
    model.eval()
    with torch.no_grad():
        out = model.forward_t2s(*(torch.from_numpy(a) for a in args))
    for name, got, want in zip(("before", "after", "stop", "cross"), out, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("loss_type", ["L1", "L2", "L1+L2"])
def test_tts_loss_and_guided_attention_match_jax(loss_type):
    rng = np.random.default_rng(6)
    T, n_mels, Te = 12, 20, 7
    before, after, target = (rng.standard_normal((B, T, n_mels)).astype(np.float32)
                             for _ in range(3))
    stop = (rng.standard_normal((B, T)) * 3).astype(np.float32)
    attn = rng.random((2, B, 4, T // 2, Te)).astype(np.float32)
    dec_lengths, enc_lengths = np.array([12, 9], np.int32), np.array([7, 4])
    kw = dict(reduction_factor=2, loss_type=loss_type, use_guided_attn=True)
    jl, jm = JCr.tts_loss(*(jnp.asarray(a) for a in (before, after, stop, target,
                                                    dec_lengths)),
                          attn=jnp.asarray(attn), enc_lengths=jnp.asarray(enc_lengths), **kw)
    pl, pm = PCr.tts_loss(*(torch.from_numpy(a) for a in (before, after, stop, target,
                                                         dec_lengths)),
                          attn=torch.from_numpy(attn),
                          enc_lengths=torch.from_numpy(enc_lengths), **kw)
    assert set(pm) == set(jm) == {"l1_loss", "l2_loss", "bce_loss",
                                  "enc_dec_attn_loss", "loss"}
    for k in pm:
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    ga = PCr.guided_attention_loss(torch.from_numpy(attn), torch.from_numpy(enc_lengths),
                                   torch.from_numpy(dec_lengths // 2))
    np.testing.assert_allclose(ga.item(), float(JCr.guided_attention_loss(
        jnp.asarray(attn), jnp.asarray(enc_lengths), jnp.asarray(dec_lengths // 2))),
        rtol=1e-5)


# ------------------------------------------------------------ train step


def _device_mel_batch(jcfg, seed, lengths=(2900, 2100), bucketed=True):
    """A t2s micro-batch in device-mel mode (tokens, x-vectors, the
    reflect-padded target waveform); the same shapes for every seed."""
    rng = np.random.default_rng(seed)
    items = [{"tgt_wav_raw": chip_smoke.synth_audio(n / 16000, seed + i)[:n]}
             for i, n in enumerate(lengths)]
    b = PMan.collate_mel_targets(items, jcfg.reduction_factor, jcfg.n_mels,
                                 bucketed, True)
    b.update(_inputs(jcfg, seed))
    del b["prev_mel"]
    return b


def _grad_close(name, got, want, gmax):
    if name.endswith("k_proj.bias"):
        assert np.abs(got).max() <= 1e-6 * gmax and np.abs(want).max() <= 1e-6 * gmax
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-4 * np.abs(want).max(), err_msg=name)


def test_t2s_loss_metrics_and_gradients_match_jax():
    """The t2s loss of JAX's train step (device_mel_batch, forward_t2s with
    mutable batch statistics, tts_loss with guided attention) against the
    port's Trainer.loss: metrics and every parameter gradient."""
    jcfg, jm, variables, _, model = _setup()
    b = _device_mel_batch(jcfg, 7)
    tcfg = dict(use_guided_attn=True)
    loss_fn = JT._loss_for_task(jm, "t2s", JT.TrainConfig(**tcfg))
    extra = {"batch_stats": variables["batch_stats"]}
    (_, (jmet, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, extra, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(0), 0), has_aux=True))(variables["params"])
    trainer = PT.Trainer(model, "t2s", PT.TrainConfig(**tcfg))
    model.train()
    loss, met = trainer.loss(_t(b))
    loss.backward()
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=2e-4, err_msg=k)
    want = from_jax_params(_flat(jg))
    gmax = max(float(np.abs(v.numpy()).max()) for v in want.values())
    reached = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:      # not reached by the loss: zero in JAX
            assert np.abs(w).max() == 0.0, name
            continue
        reached += 1
        _grad_close(name, p.grad.numpy(), w, gmax)
    assert reached > 40


@pytest.mark.parametrize("freeze,updates", [(0, 3), (1, 1)],
                         ids=["three_updates", "decoder_frozen"])
def test_trainer_three_t2s_updates_match_jax_train_step(freeze, updates):
    """Updates of accum 2 with the clip active: parameters and BatchNorm
    statistics (threaded through the micro-batches) against
    make_train_step's.  With the decoder and its speech pre/postnets frozen
    the case stops at the frozen update: on release, JAX emulates torch's
    lazily started Adam moments with one debias factor (JAX trainer.py
    :373-391), which is exact only where |g| >> eps, and on this batch moves
    the third update's grad norm by 2.2e-4 relative."""
    jcfg, jm, variables, _, model = _setup()
    kw = dict(lr=1e-4, warmup_steps=2, accum_steps=2, clip_norm=1.0, adam_eps=1e-4,
              freeze_decoder_updates=freeze, use_guided_attn=True)
    batches = [[_device_mel_batch(jcfg, 10 * u + m) for m in range(2)]
               for u in range(updates)]
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if PT.freeze_horizon(n, PT.TrainConfig(**kw))}

    tcfg = JT.TrainConfig(**kw)
    params = variables["params"]
    state = JT.TrainState(params, JT.make_optimizer(tcfg).init(params),
                          jnp.zeros((), jnp.int32),
                          {"batch_stats": variables["batch_stats"]})
    step = jax.jit(JT.make_train_step(jm, "t2s", tcfg))
    jnorms = []
    for mbs in batches:
        stacked = {k: jnp.stack([jnp.asarray(mb[k]) for mb in mbs]) for k in mbs[0]}
        state, m = step(state, stacked, jax.random.PRNGKey(0))
        jnorms.append(float(m["grad_norm"]))

    trainer = PT.Trainer(model, "t2s", PT.TrainConfig(**kw))
    norms = [float(trainer.train_step([_t(mb) for mb in mbs])["grad_norm"])
             for mbs in batches]
    assert trainer.step == updates
    np.testing.assert_allclose(norms, jnorms, rtol=2e-4)
    assert min(norms) > 1.0     # the clip was active in every update
    want = _state_dict(state.params, state.extra["batch_stats"])
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert bool(frozen) == bool(freeze)
    assert any(n.startswith("speech_decoder_postnet.") for n in frozen) == bool(freeze)
    for name, p0 in frozen.items():
        assert torch.equal(got[name], p0), name


def test_decoder_freeze_covers_the_speech_decoder_nets(tiny):
    _, _, variables, _, model = tiny
    cfg = dict(freeze_encoder_updates=5, freeze_decoder_updates=3)
    jh = _flat(JT._freeze_horizons(variables["params"], JT.TrainConfig(**cfg)))
    leaves = _flat(variables["params"])
    want = {}
    for key, h in jh.items():
        want.update({n: int(h) for n in from_jax_params({key: leaves[key]})})
    got = {n: PT.freeze_horizon(n, PT.TrainConfig(**cfg))
           for n, _ in model.named_parameters()}
    assert got == want
    for top in ("speech_decoder_prenet", "speech_decoder_postnet"):
        names = [n for n in got if n.startswith(top + ".")]
        assert names and all(got[n] == 3 for n in names)
    assert got["text_encoder_prenet.alpha"] == 0


# ------------------------------------------------------------------ CLI


def test_bn_buffers_round_trip_through_save_and_restore(tmp_path, tiny):
    _, _, _, pcfg, model = tiny
    trainer = PT.Trainer(model, "t2s", PT.TrainConfig())
    trainer.step = 4
    save_checkpoint(tmp_path, trainer)
    fresh = init_model(pcfg, device="cpu")
    other = PT.Trainer(fresh, "t2s", PT.TrainConfig())
    restore_latest(tmp_path, other)
    want = {k: v for k, v in model.state_dict().items() if "running_" in k}
    assert len(want) == 2 * pcfg.speech_postnet.postnet_layers
    for k, v in want.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert other.step == 4


def test_cli_train_t2s_runs_resumes_and_validates_on_cpu(tmp_path, capsys,
                                                         monkeypatch):
    """2 updates with device mels, then a resume that takes a third and
    validates (the tts_loss metrics, no WER); the resumed run starts from
    the saved BatchNorm statistics; --host-mel trains too."""
    d = str(tmp_path)
    dict_path = _write_t2s_corpus(d, 4)
    args = ["--task", "t2s", "--arch", "speecht5_tiny", "--manifest", f"{d}/tts.tsv",
            "--labels", f"{d}/tts.ltr", "--dict", dict_path, "--spkemb-dir", f"{d}/xv",
            "--save-dir", f"{d}/ckpt", "--batch-size", "2", "--guided-attn",
            "--log-interval", "1",
            "--override", "encoder.use_pallas_attn_train=True", "--device", "cpu"]
    out = cli_train.main(args + ["--max-updates", "2"])
    assert out["steps"] == 2 and out["finite"] and out["checkpoint"].endswith("_2.pt")
    saved = torch.load(out["checkpoint"], weights_only=True)["model"]
    var = saved["speech_decoder_postnet.postnet.bn_0.running_var"]
    assert not torch.equal(var, torch.ones_like(var))      # moved by training

    seen = {}

    def spy(save_dir, trainer):     # what the resumed run starts from
        state = restore_latest(save_dir, trainer)
        seen["var"] = trainer.model.state_dict()[
            "speech_decoder_postnet.postnet.bn_0.running_var"].clone()
        return state

    monkeypatch.setattr("speecht5_tpu_torch.utils.checkpoint.restore_latest", spy)
    out = cli_train.main(args + ["--max-updates", "3", "--valid-manifest",
                                 f"{d}/tts.tsv", "--valid-interval", "1",
                                 "--best-checkpoint-metric", "loss"])
    assert torch.equal(seen["var"], var)
    assert out["steps"] == 3 and len(out["history"]) == 1
    assert set(out["history"][0]) == {"l1_loss", "l2_loss", "bce_loss",
                                      "enc_dec_attn_loss", "loss", "grad_norm"}
    log = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")]
    valid = [r for r in log if "valid_loss" in r]
    assert len(valid) == 1 and valid[0]["new_best"] == "loss"
    assert "valid_l1_loss" in valid[0] and "valid_wer" not in valid[0]
    args[args.index("--save-dir") + 1] = f"{d}/host"
    host = cli_train.main(args + ["--host-mel", "--max-updates", "1"])
    assert host["steps"] == 1 and host["finite"]
