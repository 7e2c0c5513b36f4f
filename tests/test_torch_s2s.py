"""The port's VC / SE (s2s) task held against the JAX package.

One set of JAX variables (tiny preset, the speech prenet's and postnet's
dropout at 0) crosses into the port through ``utils/convert``'s
``from_jax_params`` and ``from_jax_batch_stats``.  The same numpy inputs
then go through ``forward_s2s`` in every ``se_predict`` mode (VC with
``prev_mel``; SE "masking", "delta" and "target" with the source fbank as
the decoder input) and its refusals, ``device_mel_batch`` with the SE
source (``src_wav``), ``SpeechToSpeechDataset``'s collation in both mel
modes, the s2s loss and every gradient, one ``Trainer`` update against
``make_train_step``, ``TTSDecoder.speech_to_speech`` and ``cli/train.main
--task s2s``; ``chip_smoke.py``'s s2s and VC phases run at the tiny
preset.

Torch runs with TF32 off; JAX at ``highest`` matmul precision
(tests/conftest.py).  The tiny preset has no dropout or layerdrop.
Tolerances (PERF.md §2): f32 outputs 2e-4 absolute, BatchNorm statistics
1e-5, mels from the waveform 2e-3 (the log-mel spec's), losses 1e-4
relative, each gradient within 1e-3 of its parameter's max |g| (the k_proj
biases, analytically 0, within 1e-6 of the largest), parameters after an
update 1e-5, the VC decode's mel 1e-4 with equal lengths.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.data import manifests as JMan
from speecht5_tpu.decode.tts import TTSDecoder as JTTSDecoder
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from speecht5_tpu.models.speecht5 import init_model as jinit_model
from speecht5_tpu.train import trainer as JT

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.data import manifests as PMan
from speecht5_tpu_torch.decode.tts import TTSDecoder
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.train import trainer as PT
from speecht5_tpu_torch.utils.convert import from_jax_batch_stats, from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
NO_DROPOUT = ["speech_postnet.postnet_dropout=0.0", "speech_prenet.dropout=0.0"]
SE = dict(reduction_factor=1, se_predict="masking")


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _state_dict(variables):
    return {**from_jax_params(_flat(variables["params"])),
            **from_jax_batch_stats(_flat(variables["batch_stats"]))}


def _cfgs(**kw):
    return (JC.apply_overrides(JC.speecht5_tiny(**kw), NO_DROPOUT),
            PC.apply_overrides(PC.speecht5_tiny(**kw), NO_DROPOUT))


def _setup(**kw):
    """JAX variables (BatchNorm statistics off their init) and a port model
    with the same weights (strict)."""
    jcfg, pcfg = _cfgs(**kw)
    _, variables = jinit_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.standard_normal(x.shape)) + 0.5, jnp.float32),
        variables["batch_stats"])}
    model = init_model(pcfg, device="cpu")
    model.load_state_dict(_state_dict(variables), strict=True)
    return variables, model


@pytest.fixture(scope="module")
def vc():
    return _setup()


@pytest.fixture(scope="module")
def se():
    return _setup(**SE)


def _inputs(cfg, seed=0, L=8):
    """wav [2, 3200] (one row padded), prev_mel / src_mel [2, L, n_mels]
    (zero BOS frame in prev_mel), dec_lengths_r [L, L - 2], x-vectors."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((2, 3200)) * 0.1).astype(np.float32)
    wav[1, 2500:] = 0.0
    prev = (rng.standard_normal((2, L, cfg.n_mels)) - 4.0).astype(np.float32)
    prev[:, 0] = 0.0
    prev[1, L - 2:] = 0.0
    src = (rng.standard_normal((2, L, cfg.n_mels)) - 4.0).astype(np.float32)
    return {"wav": wav, "wav_lengths": np.array([3200, 2500], np.int32), "prev_mel": prev,
            "dec_lengths_r": np.array([L, L - 2], np.int32),
            "spkembs": rng.standard_normal((2, cfg.spk_embed_dim)).astype(np.float32),
            "src_mel": src}


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("mode", [None, "masking", "delta", "target"])
def test_forward_s2s_matches_jax(vc, se, mode):
    """A training pass (the speech postnet's BatchNorm on batch statistics,
    which it then updates): frames before and after the postnet, stop
    logits, every layer's cross weights over the speech frames, enc_valid
    and the statistics.  VC decodes ``prev_mel``; the SE modes (r 1) the
    source fbank."""
    variables, _ = vc if mode is None else se
    kw = {} if mode is None else dict(reduction_factor=1, se_predict=mode)
    jcfg, pcfg = _cfgs(**kw)
    model = init_model(pcfg, device="cpu")
    model.load_state_dict(_state_dict(variables), strict=True)
    b = _inputs(jcfg, seed=3)
    src = None if mode is None else b["src_mel"]
    jout, upd = jax.jit(lambda v, *a: JModel(jcfg).apply(
        v, *a, deterministic=False, mutable=["batch_stats"], method="forward_s2s"))(
        variables, *(jnp.asarray(b[k]) for k in ("wav", "wav_lengths", "prev_mel",
                                                  "dec_lengths_r", "spkembs")),
        None if src is None else jnp.asarray(src))
    model.train()
    ones = [torch.ones(2, 8, jcfg.speech_prenet.units, dtype=torch.bool)] * 2
    out = model.forward_s2s(*(torch.from_numpy(b[k]) for k in (
        "wav", "wav_lengths", "prev_mel", "dec_lengths_r", "spkembs")),
        None if src is None else torch.from_numpy(src), keep_masks=ones)
    L, H = jcfg.decoder.num_layers, jcfg.decoder.num_heads
    assert out[3].shape == (L, 2, H, 8, out[4].shape[1]) and out[4].dtype == torch.bool
    for name, got, want in zip(("before", "after", "stop", "cross"), out, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4, err_msg=name)
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(jout[4]))
    sd = model.state_dict()
    for k, w in from_jax_batch_stats(_flat(upd["batch_stats"])).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=k)
    if mode == "masking":       # |out| <= |src|, the source's sign
        for t in out[:2]:
            assert (t.abs() <= torch.from_numpy(src).abs() + 1e-6).all()


def test_forward_s2s_refusals_match_jax(vc, se):
    """se_predict without r == 1, and without the source fbank: JAX asserts,
    the port raises a ValueError."""
    b = _inputs(_cfgs(**SE)[0])
    args = [b[k] for k in ("wav", "wav_lengths", "prev_mel", "dec_lengths_r", "spkembs")]
    for (variables, _), kw, src in (
            (vc, dict(reduction_factor=2, se_predict="masking"), b["src_mel"]), (se, SE, None)):
        jcfg, pcfg = _cfgs(**kw)
        with pytest.raises(AssertionError, match="se_predict requires"):
            jax.eval_shape(lambda: JModel(jcfg).apply(
                variables, *(jnp.asarray(a) for a in args),
                None if src is None else jnp.asarray(src), deterministic=True,
                method="forward_s2s"))
        with pytest.raises(ValueError, match="se_predict requires"):
            init_model(pcfg, device="cpu").forward_s2s(
                *(torch.from_numpy(a) for a in args),
                None if src is None else torch.from_numpy(src))


# ------------------------------------------------------------------ data


def _write_vc_corpus(d, n=3, spk_dim=16, seed=1):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ns, nt = 3000 + 500 * i, 3900 - 400 * i
        chip_smoke.write_wav(f"{d}/s{i}.wav", chip_smoke.synth_audio(ns / 16000, seed + i))
        chip_smoke.write_wav(f"{d}/t{i}.wav", chip_smoke.synth_audio(nt / 16000, seed + 9 + i))
        np.save(f"{d}/e{i}.npy", rng.standard_normal(spk_dim).astype(np.float32))
        rows.append(f"s{i}.wav\t{ns}\tt{i}.wav\t{nt}\te{i}.npy")
    with open(f"{d}/vc.tsv", "w") as f:
        f.write(d + "\n" + "\n".join(rows) + "\n")
    return f"{d}/vc.tsv"


@pytest.mark.parametrize("se_mode", [False, True], ids=["vc", "se"])
@pytest.mark.parametrize("device_mel", [False, True], ids=["host_mel", "device_mel"])
def test_s2s_dataset_and_collation_equal_jax(tmp_path, device_mel, se_mode):
    manifest = _write_vc_corpus(str(tmp_path))
    kw = dict(manifest=manifest, normalize=True, reduction_factor=2, n_mels=20,
              se_mode=se_mode, device_mel=device_mel)
    ds, jds = PMan.SpeechToSpeechDataset(**kw), JMan.SpeechToSpeechDataset(**kw)
    assert len(ds) == len(jds) == 3
    np.testing.assert_array_equal(ds.sizes, jds.sizes)
    items, jitems = [ds[i] for i in range(3)], [jds[i] for i in range(3)]
    for it, jit in zip(items, jitems):
        assert it.keys() == jit.keys()
        for k in it:
            np.testing.assert_array_equal(it[k], jit[k], err_msg=k)
    for bucketed in (False, True):
        got, want = ds.collate(items, bucketed), jds.collate(jitems, bucketed)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_mel_batch_with_the_se_source_matches_jax(tmp_path):
    """device_mel_batch on an SE device-mode batch: target_mel, prev_mel and
    the source's src_mel against JAX's and against the host collator's
    (2e-3), rows past each length exactly 0."""
    manifest = _write_vc_corpus(str(tmp_path))
    kw = dict(manifest=manifest, reduction_factor=2, n_mels=20, se_mode=True)
    dev = PMan.SpeechToSpeechDataset(device_mel=True, **kw)
    b = dev.collate([dev[i] for i in range(3)])
    assert {"src_wav", "src_frames", "tgt_wav"} <= set(b)
    out = PT.device_mel_batch({k: torch.from_numpy(v) for k, v in b.items()}, 20, 2)
    jout = JT.device_mel_batch({k: jnp.asarray(v) for k, v in b.items()}, 20, 2)
    assert set(out) == set(jout) and not {"src_wav", "src_frames", "tgt_wav"} & set(out)
    host = PMan.SpeechToSpeechDataset(device_mel=False, **kw)
    hb = host.collate([host[i] for i in range(3)])
    for k in ("target_mel", "prev_mel", "src_mel"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-3, atol=2e-3,
                                   err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), hb[k], rtol=1e-3, atol=2e-3, err_msg=k)
    for row, n in enumerate(b["src_frames"] // 2):
        assert (out["src_mel"][row, n:] == 0).all()


# -------------------------------------------------------------- train step


def _device_batch(d, cfg, seed, se_mode=False):
    """An s2s micro-batch in device-mel mode, the same shapes for every seed:
    two pairs written to ``d`` and collated by SpeechToSpeechDataset."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, (ns, nt) in enumerate(((3200, 2900), (2500, 2100))):
        chip_smoke.write_wav(f"{d}/s{seed}_{i}.wav",
                             chip_smoke.synth_audio(ns / 16000, seed + i)[:ns])
        chip_smoke.write_wav(f"{d}/t{seed}_{i}.wav",
                             chip_smoke.synth_audio(nt / 16000, seed + 5 + i)[:nt])
        np.save(f"{d}/e{seed}_{i}.npy", rng.standard_normal(cfg.spk_embed_dim).astype(np.float32))
        rows.append(f"s{seed}_{i}.wav\t{ns}\tt{seed}_{i}.wav\t{nt}\te{seed}_{i}.npy")
    with open(f"{d}/b{seed}.tsv", "w") as f:
        f.write(d + "\n" + "\n".join(rows) + "\n")
    ds = PMan.SpeechToSpeechDataset(f"{d}/b{seed}.tsv", reduction_factor=cfg.reduction_factor,
                                    n_mels=cfg.n_mels, se_mode=se_mode, device_mel=True)
    b = ds.collate([ds[0], ds[1]])
    b.pop("ids")
    return b


def _t(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("mode", ["vc", "se"])
def test_s2s_loss_gradients_and_update_match_jax(tmp_path, vc, se, mode):
    """The s2s loss of JAX's train step (device_mel_batch with the SE
    source, forward_s2s with mutable batch statistics, tts_loss with guided
    attention over the conv frames) against Trainer.loss: metrics and every
    gradient, the conv extractor's included (feature_grad_mult 0.1).  VC
    also one update of accum 2 with the clip active against
    make_train_step: grad norm, parameters and statistics (adam_eps 1e-4,
    so that the k_proj biases' rounding-noise gradients move nothing)."""
    variables, _ = vc if mode == "vc" else se
    jcfg, pcfg = _cfgs(**({} if mode == "vc" else SE))
    jm = JModel(jcfg)
    model = init_model(pcfg, device="cpu")
    model.load_state_dict(_state_dict(variables), strict=True)
    tkw = dict(lr=1e-3, warmup_steps=2, accum_steps=2, clip_norm=1.0, adam_eps=1e-4,
               use_guided_attn=True)
    b0 = _device_batch(str(tmp_path), jcfg, 7, se_mode=mode == "se")
    loss_fn = JT._loss_for_task(jm, "s2s", JT.TrainConfig(**tkw))
    extra = {"batch_stats": variables["batch_stats"]}
    (jloss, (jmet, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, extra, {k: jnp.asarray(v) for k, v in b0.items()},
                          jax.random.PRNGKey(0), 0), has_aux=True))(variables["params"])
    trainer = PT.Trainer(model, "s2s", PT.TrainConfig(**tkw))
    model.train()
    loss, met = trainer.loss(_t(b0))
    loss.backward()
    assert set(met) == set(jmet) and "enc_dec_attn_loss" in met
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
    if mode == "se":
        return
    model.load_state_dict(_state_dict(variables), strict=True)
    mbs = [_device_batch(str(tmp_path), jcfg, s) for s in (20, 21)]
    tcfg = JT.TrainConfig(**tkw)
    params = variables["params"]
    state = JT.TrainState(params, JT.make_optimizer(tcfg).init(params),
                          jnp.zeros((), jnp.int32), extra)
    stacked = {k: jnp.stack([jnp.asarray(mb[k]) for mb in mbs]) for k in mbs[0]}
    state, jm_out = jax.jit(JT.make_train_step(jm, "s2s", tcfg))(
        state, stacked, jax.random.PRNGKey(0))
    m = PT.Trainer(model, "s2s", PT.TrainConfig(**tkw)).train_step([_t(mb) for mb in mbs])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm_out["grad_norm"]), rtol=2e-4)
    np.testing.assert_allclose(float(m["loss"]), float(jm_out["loss"]), rtol=1e-4)
    assert float(m["grad_norm"]) > 1.0      # the clip was active
    got = model.state_dict()
    for name, w in _state_dict({"params": state.params, **state.extra}).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------- decode


def test_speech_to_speech_matches_jax(vc):
    """TTSDecoder.speech_to_speech against JAX's (prenet dropout 0): lengths
    equal, mel 1e-4; the length ratios act on the speech encoder's frames
    (a row of F frames runs at most F * max_len_ratio / r steps)."""
    variables, model = vc
    jcfg, _ = _cfgs()
    b = _inputs(jcfg, seed=11)
    jres = JTTSDecoder(JModel(jcfg), variables, max_frames=64, max_len_ratio=0.5).speech_to_speech(
        jnp.asarray(b["wav"]), jnp.asarray(b["wav_lengths"]), jnp.asarray(b["spkembs"]))
    res = TTSDecoder(model.eval(), max_frames=64, max_len_ratio=0.5,
                     device="cpu").speech_to_speech(b["wav"], b["wav_lengths"], b["spkembs"])
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    for name in ("mel", "mel_before", "stop_probs", "focus_rate"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(jres, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    frames = jcfg.conv_features.out_length(b["wav_lengths"])
    assert (res.lengths.numpy() <= frames * 0.5).all()


# ------------------------------------------------------------------ CLI


def test_cli_train_s2s_runs_and_resumes_on_cpu_and_refuses_se(tmp_path):
    """--task s2s on the tiny preset with neither --labels nor --dict: 2
    updates with device mels, a resume that takes a third and validates,
    --host-mel; --override se_predict=masking is refused with a ValueError,
    since no CLI sets up the SE data path (JAX's fails its assert at the
    first step, test_forward_s2s_refusals_match_jax)."""
    d = str(tmp_path)
    manifest = _write_vc_corpus(d, n=4)
    args = ["--task", "s2s", "--arch", "speecht5_tiny", "--manifest", manifest,
            "--save-dir", f"{d}/ckpt", "--batch-size", "2", "--guided-attn",
            "--log-interval", "1", "--device", "cpu"]
    out = cli_train.main(args + ["--max-updates", "2"])
    assert out["steps"] == 2 and out["finite"]
    out = cli_train.main(args + ["--max-updates", "3", "--valid-manifest", manifest,
                                 "--valid-interval", "1"])
    assert out["steps"] == 3 and len(out["history"]) == 1
    assert set(out["history"][0]) == {"l1_loss", "l2_loss", "bce_loss",
                                      "enc_dec_attn_loss", "loss", "grad_norm"}
    args[args.index("--save-dir") + 1] = f"{d}/host"
    assert cli_train.main(args + ["--host-mel", "--max-updates", "1"])["finite"]
    with pytest.raises(ValueError, match="se_predict='masking'"):
        cli_train.main(args + ["--max-updates", "1", "--override", "se_predict=masking",
                               "--override", "reduction_factor=1"])


def test_chip_smoke_s2s_and_vc_phases_run_on_cpu_with_twins():
    """Phases 14-16 at the tiny preset on the CPU: the twins run, so no
    launches (the card's launch rule then fails, as it must here); every
    encoder layer runs once per micro-batch; the VC requests run to their
    length bound."""
    from speecht5_tpu_torch.models.hifigan import HiFiGANConfig

    tiny = PC.speecht5_tiny()
    trained = chip_smoke.phase_train_s2s("speecht5_tiny", device="cpu", n_utts=4, updates=2,
                                         seconds=(0.3, 0.8), flags=["--guided-attn",
                                                                    "--batch-size", "2"])
    assert trained["micro_batches"] == 2 and trained["layer_runs"] == 2 * 2
    assert set(trained["counts"].values()) == {0} and len(trained["history"]) == 3
    with pytest.raises(AssertionError, match="s2s path launches wrong"):
        chip_smoke.check_speech_train_counts(trained, tiny, 1, "s2s")
    parity = chip_smoke.phase_s2s_parity(tiny, device="cpu", batch=2, seconds=(0.3, 0.8))
    assert parity["vc"]["loss_rel_diff"] < 1e-5 and parity["se"]["loss_rel_diff"] < 1e-5
    assert set(parity["se"]["mel_max_abs_err"]) == {"target_mel", "prev_mel", "src_mel"}
    vc = chip_smoke.phase_vc_decode(tiny, device="cpu", dtype="float32", source_s=0.5,
                                    max_frames=48, vocoder_cfg=HiFiGANConfig(
                                        in_dim=20, upsample_initial_channel=32))
    assert [r["decode_steps"] for r in vc["requests"]] == [24, 24]
    assert vc["parity"]["lengths_kernel"] == [48]
    # the card's rule: 24 attention and 6 conv launches a request, 12 a step
    want = chip_smoke.vc_launches_expected(PC.speecht5_base(dtype="bfloat16"), 10)
    assert (want["banded_flash_attention"], want["conv_stack"],
            want["flash_attention_bias"]) == (24, 6, 120)
