"""The port's s2t train step held against the JAX package.

One set of JAX parameters (tiny preset, the 81-symbol letter vocabulary,
HuBERT masking and layerdrop at 0; the tiny preset has no dropout) crosses
into the port through ``utils/convert.from_jax_params``.  The same numpy
batch then goes through the text decoder prenet, decoder and postnet
(``decode_text``), ``forward_s2t``, ``ctc_loss`` and ``s2t_loss`` in both
packages, with gradients; the schedules, the freeze horizons and three
updates of the port's ``Trainer`` against ``make_train_step`` (``accum_steps``
2, one freeze horizon); and ``cli/train.main`` on a synthetic manifest on
the CPU, with a resume.

Torch runs with TF32 off; JAX at ``highest`` matmul precision
(tests/conftest.py).  Tolerances: logits 2e-4 absolute; losses 2e-4
relative; each parameter gradient within 2e-4 of that parameter's max |g|,
except the k_proj biases, whose gradient is analytically 0 (softmax is
shift-invariant per row) and is rounding noise on both sides, held to
1e-6 of the largest gradient instead; parameters after 3 updates within
1e-5, at the recipe's learning-rate scale (1e-4) and Adam's eps at 1e-4, so
that Adam does not normalise the noise gradients of the k_proj biases into
+-lr steps on either side.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from speecht5_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from speecht5_tpu.ops.masking import apply_feature_masks as jax_apply_masks
from speecht5_tpu.ops.masking import compute_span_mask as jax_span_mask
from speecht5_tpu.train import criterions as JCr
from speecht5_tpu.train import schedules as JS
from speecht5_tpu.train import trainer as JT

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops.ctc import ctc_loss
from speecht5_tpu_torch.ops.masking import apply_feature_masks, compute_span_mask
from speecht5_tpu_torch.train import criterions as PCr
from speecht5_tpu_torch.train import schedules as PS
from speecht5_tpu_torch.train import trainer as PT
from speecht5_tpu_torch.utils.convert import from_jax_batch_stats, from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
DETERMINISTIC = ["masking.mask_prob=0.0", "encoder.layerdrop=0.0",
                 "decoder.layerdrop=0.0"]
B, T_WAV, L = 2, 4000, 7


def _batch(seed=0, vocab=81):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((B, T_WAV)) * 0.1).astype(np.float32)
    lens = np.array([T_WAV, 2600], np.int32)
    tgt = rng.integers(4, vocab - 1, (B, L))
    tgt[0, -1] = 2                       # EOS-terminated, one row padded
    tgt[1, 4], tgt[1, 5:] = 2, 1
    prev = np.full((B, L), 1)
    prev[:, 0] = 2
    prev[0, 1:] = tgt[0, :-1]
    prev[1, 1:5] = tgt[1, :4]
    return {"wav": wav, "wav_lengths": lens, "prev_tokens": prev, "targets": tgt}


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _init_both(m, wav, lens, prev, prev_mel, tgt_lengths, spk):
    """Create the parameters of the t2s and s2t forwards and the HuBERT head
    (every sub-net the port has)."""
    m.forward_t2s(prev, prev_mel, tgt_lengths, spk, deterministic=True)
    m.hubert_logits(m.encode_speech(wav, lens))
    return m.forward_s2t(wav, lens, prev, mask=False, deterministic=True)


def _setup(overrides=(), **kw):
    """JAX model + variables (initialised through forward_s2t and
    forward_t2s) and the port model with the same weights."""
    kw = {**chip_smoke.DICT_CFG, **kw}
    ov = DETERMINISTIC + list(overrides)
    jcfg = JC.apply_overrides(JC.speecht5_tiny(**kw), ov)
    jm = JModel(jcfg)
    variables = jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, T_WAV)),
        jnp.full((1,), T_WAV, jnp.int32), jnp.full((1, 4), 2, jnp.int32),
        jnp.zeros((1, 2, jcfg.n_mels)), jnp.full((1,), 2, jnp.int32),
        jnp.ones((1, jcfg.spk_embed_dim)), method=_init_both)
    pcfg = PC.apply_overrides(PC.speecht5_tiny(**kw), ov)
    model = init_model(pcfg, device="cpu")
    model.load_state_dict({**from_jax_params(_flat(variables["params"])),
                           **from_jax_batch_stats(_flat(variables["batch_stats"]))},
                          strict=True)
    return jcfg, jm, variables, pcfg, model


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _jax_forward(jm, params, b):
    return jm.apply({"params": params}, jnp.asarray(b["wav"]),
                    jnp.asarray(b["wav_lengths"]), jnp.asarray(b["prev_tokens"]),
                    mask=False, deterministic=True, method="forward_s2t")


def _decoder_features(m, wav, lengths, prev):
    """Speech encoder, then the text decoder prenet and the decoder stack
    (JAX and port modules alike)."""
    enc = m.encode_speech(wav, lengths)
    x, self_valid = m.text_decoder_prenet(prev)
    out = m.decoder(x, enc["encoder_out"], enc_valid=enc["valid_mask"],
                    self_valid=self_valid)
    return out[0] if isinstance(out, tuple) else out


def _port_forward(model, b):
    return model.forward_s2t(torch.from_numpy(b["wav"]),
                             torch.from_numpy(b["wav_lengths"]),
                             torch.from_numpy(b["prev_tokens"]), mask=False)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_text_decoder_path_and_forward_s2t_match_jax(tied):
    """TextDecoderPrenet, TransformerDecoder, TextDecoderPostnet (own
    projection or the embedding matrix) and forward_s2t's two heads."""
    jcfg, jm, variables, _, model = _setup(share_input_output_embed=tied)
    b = _batch()
    jlogits, jctc, jvalid = jax.jit(lambda p: _jax_forward(jm, p, b))(
        variables["params"])
    jx, _ = jm.apply(variables, jnp.asarray(b["prev_tokens"]),
                     method=lambda m, t: m.text_decoder_prenet(t))
    inputs = [b[k] for k in ("wav", "wav_lengths", "prev_tokens")]
    jfeats = jax.jit(lambda v, *a: jm.apply(v, *a, method=_decoder_features))(
        variables, *(jnp.asarray(a) for a in inputs))
    model.train()   # tiny: no dropout, and masking/layerdrop are off
    logits, ctc, valid = _port_forward(model, b)
    x, _ = model.text_decoder_prenet(torch.from_numpy(b["prev_tokens"]))
    feats = _decoder_features(model, *(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), atol=2e-4)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats), atol=2e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert logits.shape == (B, L, jcfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=2e-4)
    np.testing.assert_allclose(ctc.detach().numpy(), np.asarray(jctc), atol=2e-4)
    assert (model.text_decoder_postnet.output_projection is None) == tied


def test_forward_s2t_in_bf16_through_the_conv_stack_route_matches_jax():
    """forward_s2t at tiny in eval, bf16, with ``conv_features.impl='pallas'``
    (the port's conv-stack wrapper, its twin on the CPU; JAX's Pallas stack
    in interpret mode) against JAX bf16: decoder and CTC logits within
    3e-2 x max|ref| (one bf16 rounding of activations in each framework,
    rounded at other places).  The CTC argmax equals JAX f32's (same
    weights and batch) on at least 99.5% of the valid frames, and where it
    differs from JAX bf16's, JAX bf16's top two logits lie within that
    tolerance of each other: on this batch JAX bf16 itself differs from JAX
    f32 on 2 of 81 frames, ties of 0.003-0.007 that bf16 rounding decides."""
    jcfg, jm, variables, _, model = _setup(["conv_features.impl='pallas'"],
                                           dtype="bfloat16")
    b = _batch()
    jlogits, jctc, jvalid = jax.jit(lambda p: _jax_forward(jm, p, b))(variables["params"])
    jf32 = JModel(JC.replace(jcfg, dtype="float32"))
    f32_ctc = jax.jit(lambda p: _jax_forward(jf32, p, b))(variables["params"])[1]
    model.eval()
    with torch.no_grad():
        logits, ctc, valid = _port_forward(model, b)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    tol = {}
    for name, got, want in (("decoder", logits, jlogits), ("ctc", ctc, jctc)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape, name
        tol[name] = 3e-2 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol[name], err_msg=name)
    v = np.asarray(jvalid)
    ids = ctc.float().numpy().argmax(-1)
    assert (ids == np.asarray(f32_ctc).argmax(-1))[v].mean() >= 0.995
    ref = np.asarray(jctc, np.float32)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    differ = (ids != ref.argmax(-1)) & v
    assert (top2[..., 1] - top2[..., 0])[differ].max(initial=0.0) <= tol["ctc"]


def _grad_close(name, got, want, gmax):
    if name.endswith("k_proj.bias"):
        assert np.abs(got).max() <= 1e-6 * gmax and np.abs(want).max() <= 1e-6 * gmax
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-4 * np.abs(want).max(), err_msg=name)


def test_s2t_loss_metrics_and_gradients_match_jax(tiny):
    jcfg, jm, variables, _, model = tiny
    b = _batch(1)
    kw = dict(eos_id=2, ctc_weight=0.5, label_smoothing=0.1)

    def jloss(params):
        logits, ctc, valid = _jax_forward(jm, params, b)
        return JCr.s2t_loss(logits, ctc, valid, jnp.asarray(b["targets"]),
                            jcfg.pad_id, jcfg.blank_id, **kw)

    (_, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model.train()
    model.zero_grad(set_to_none=True)
    logits, ctc, valid = _port_forward(model, b)
    loss, met = PCr.s2t_loss(logits, ctc, valid, torch.from_numpy(b["targets"]),
                             jcfg.pad_id, jcfg.blank_id, **kw)
    loss.backward()
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=2e-4, err_msg=k)
    want = from_jax_params(_flat(jg))
    gmax = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:      # not reached by the loss: zero in JAX
            assert np.abs(w).max() == 0.0, name
            continue
        _grad_close(name, p.grad.numpy(), w, gmax)


@pytest.mark.parametrize("zero_infinity", [False, True])
def test_ctc_loss_matches_jax(rng, zero_infinity):
    """tests/test_ctc_loss.py's cases: repeated labels, ragged lengths and,
    with zero_infinity, an infeasible row; loss and gradient w.r.t. the
    logits through log_softmax."""
    Bc, T, V = 3, 12, 7
    logits = rng.standard_normal((Bc, T, V)).astype(np.float32)
    labels = np.array([[2, 2, 3, 3, 1, 1], [1, 4, 4, 4, 5, 6], [3, 1, 2, 5, 5, 5]])
    logit_lengths = np.array([12, 9, 3 if zero_infinity else 8])
    label_lengths = np.array([6, 4, 6 if zero_infinity else 2])

    def jf(x):
        lp = jax.nn.log_softmax(x, axis=-1)
        return jax_ctc_loss(lp, jnp.asarray(logit_lengths), jnp.asarray(labels),
                            jnp.asarray(label_lengths), blank_id=0,
                            zero_infinity=zero_infinity)

    jl, jvjp = jax.vjp(jf, jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(logit_lengths),
                   torch.from_numpy(labels), torch.from_numpy(label_lengths),
                   blank_id=0, zero_infinity=zero_infinity)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jl), rtol=2e-4)
    (jg,) = jvjp(jnp.ones((Bc,), jnp.float32))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=2e-4 * np.abs(np.asarray(jg)).max())
    if zero_infinity:
        assert float(got[2]) == 0.0 and np.abs(x.grad[2].numpy()).max() == 0.0


def test_feature_masks_apply_like_jax():
    """Given the masks that JAX's apply_feature_masks samples from its key
    (split into time and channel keys as it does), the port's apply gives
    the same tensor; the port's own sampler obeys the same constraints."""
    rng = np.random.default_rng(3)
    Bm, T, C = 3, 50, 24
    x = rng.standard_normal((Bm, T, C)).astype(np.float32)
    emb = rng.standard_normal((C,)).astype(np.float32)
    lengths = np.array([50, 31, 12], np.int32)
    key = jax.random.PRNGKey(7)
    kw = dict(mask_prob=0.65, mask_length=5, mask_channel_prob=0.5,
              mask_channel_length=4, min_masks=2)
    jx, jtime = jax_apply_masks(key, jnp.asarray(x), jnp.asarray(lengths),
                                jnp.asarray(emb), **kw)
    r_time, r_chan = jax.random.split(key)
    tm = np.asarray(jax_span_mask(r_time, jnp.asarray(lengths), T, 0.65, 5, 2))
    cm = np.asarray(jax_span_mask(r_chan, jnp.full((Bm,), C, jnp.int32), C, 0.5, 4, 0))
    np.testing.assert_array_equal(tm, np.asarray(jtime))
    got = apply_feature_masks(torch.from_numpy(x), torch.from_numpy(tm),
                              torch.from_numpy(emb), torch.from_numpy(cm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx))

    own = compute_span_mask(lengths, T, 0.65, 5, 2, torch.Generator().manual_seed(0))
    assert own.shape == (Bm, T) and own.dtype == torch.bool
    assert not own[torch.arange(T)[None, :] >= torch.from_numpy(lengths)[:, None]].any()
    assert (own.sum(1) >= 5).all()      # at least min_masks spans in each row


@pytest.mark.parametrize("name,args", [
    ("inverse_sqrt", (1e-3, 4)),
    ("tri_stage", (1e-3, 3, 2, 4)),
    ("polynomial_decay", (1e-3, 3, 8)),
])
def test_schedules_match_jax(name, args):
    jf, pf = getattr(JS, name)(*args), getattr(PS, name)(*args)
    got = [pf(s) for s in range(10)]
    want = [float(jf(jnp.asarray(s))) for s in range(10)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_freeze_horizons_match_jax(tiny):
    _, _, variables, _, model = tiny
    cfg = dict(freeze_encoder_updates=5, freeze_decoder_updates=3,
               no_freeze_encoder_layers=(1,))
    jh = _flat(JT._freeze_horizons(variables["params"], JT.TrainConfig(**cfg)))
    leaves = _flat(variables["params"])
    want = {}
    for key, h in jh.items():   # carry the horizons through the key mapping
        want.update({n: int(h) for n in from_jax_params({key: leaves[key]})})
    got = {n: PT.freeze_horizon(n, PT.TrainConfig(**cfg))
           for n, _ in model.named_parameters()}
    assert got == want
    assert got["encoder.proj.weight"] == 0 and got["encoder.layers.1.ffn.fc1.weight"] == 0
    assert got["encoder.layers.0.ffn.fc1.weight"] == 5 and got["decoder.layers.0.ffn.fc1.bias"] == 3


def test_trainer_three_updates_match_jax_train_step():
    """Three updates of accum_steps 2 with the decoder frozen for the first
    one, clipping active: the port's parameters against make_train_step's."""
    jcfg, jm, variables, _, model = _setup()
    kw = dict(lr=1e-4, warmup_steps=2, accum_steps=2, ctc_weight=0.5,
              clip_norm=1.0, adam_eps=1e-4, freeze_decoder_updates=1)
    batches = [[_batch(10 * u + m) for m in range(2)] for u in range(3)]

    tcfg = JT.TrainConfig(**kw)
    params = variables["params"]
    state = JT.TrainState(params, JT.make_optimizer(tcfg).init(params),
                          jnp.zeros((), jnp.int32), {})
    step = jax.jit(JT.make_train_step(jm, "s2t", tcfg))
    jnorms = []
    for mbs in batches:
        stacked = {k: jnp.stack([jnp.asarray(mb[k]) for mb in mbs]) for k in mbs[0]}
        state, m = step(state, stacked, jax.random.PRNGKey(0))
        jnorms.append(float(m["grad_norm"]))

    trainer = PT.Trainer(model, "s2t", PT.TrainConfig(**kw))
    norms = []
    for mbs in batches:
        m = trainer.train_step([{k: torch.from_numpy(v) for k, v in mb.items()}
                                for mb in mbs])
        norms.append(float(m["grad_norm"]))
    assert trainer.step == 3
    np.testing.assert_allclose(norms, jnorms, rtol=2e-4)
    assert min(norms) > 1.0     # the clip was active in every update
    want = from_jax_params(_flat(state.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def _write_corpus(d, n, seed=0):
    """n short WAVs, a manifest and letter transcripts in ``d``."""
    from speecht5_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    rows, labels = [], []
    for i in range(n):
        secs = 0.3 + 0.1 * i
        write_wav(os.path.join(d, f"u{i}.wav"), chip_smoke.synth_audio(secs, seed + i))
        rows.append(f"u{i}.wav\t{int(secs * 16000)}")
        words = ["".join(rng.choice(list("ABCDE"), 3)) for _ in range(2)]
        labels.append(" ".join(" | ".join(" ".join(w) for w in words).split()) + " |")
    with open(os.path.join(d, "train.tsv"), "w") as f:
        f.write(d + "\n" + "\n".join(rows) + "\n")
    with open(os.path.join(d, "train.ltr"), "w") as f:
        f.write("\n".join(labels) + "\n")
    return chip_smoke.write_dictionary(d)


def test_cli_train_runs_resumes_and_validates_on_cpu(tmp_path, capsys):
    """2 updates, then a resume that takes a third and validates (loss
    metrics, greedy-CTC UER/WER) into a best/ checkpoint; other tasks are
    refused."""
    d = str(tmp_path)
    dict_path = _write_corpus(d, 4)
    args = ["--task", "s2t", "--arch", "speecht5_tiny",
            "--manifest", f"{d}/train.tsv", "--labels", f"{d}/train.ltr",
            "--dict", dict_path, "--save-dir", f"{d}/ckpt", "--batch-size", "2",
            "--ctc-weight", "0.5", "--normalize", "--log-interval", "1",
            "--override", "encoder.use_pallas_attn_train=True",
            "--override", "conv_features.impl='pallas'", "--device", "cpu"]
    out = cli_train.main(args + ["--max-updates", "2"])
    assert out["steps"] == 2 and len(out["history"]) == 2 and out["finite"]
    assert out["checkpoint"].endswith("checkpoint_2.pt")
    out = cli_train.main(args + [
        "--max-updates", "3", "--valid-manifest", f"{d}/train.tsv",
        "--valid-interval", "1", "--best-checkpoint-metric", "uer"])
    assert out["steps"] == 3 and len(out["history"]) == 1
    log = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")]
    assert [r["step"] for r in log if "loss" in r] == [1, 2, 3]
    valid = [r for r in log if "valid_loss" in r]
    assert len(valid) == 1 and valid[0]["step"] == 3
    assert 0.0 <= valid[0]["valid_uer"] and "valid_wer" in valid[0]
    assert valid[0]["new_best"] == "uer"
    assert sorted(os.listdir(f"{d}/ckpt")) == [
        "best", "checkpoint_2.pt", "checkpoint_3.pt"]
    assert sorted(os.listdir(f"{d}/ckpt/best")) == ["best.json", "checkpoint_3.pt"]
    # pretraining trains (tests/test_torch_pretrain.py); the joint task
    # refuses validation, as JAX's CLI does
    with pytest.raises(SystemExit, match="valid-manifest"):
        cli_train.main(["--task", "pretrain", "--manifest", "m", "--labels", "k",
                        "--text-file", "t", "--valid-manifest", "v", "--save-dir", d,
                        "--device", "cpu"])
