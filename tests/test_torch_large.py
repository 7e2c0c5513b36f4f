"""SpeechT5-Large's modules in the port, held against the JAX package.

The Large-shaped tiny preset (``speecht5_tiny`` with both stacks pre-LN,
the ``layer_norm`` conv extractor and the quantizer on; the 81-symbol
letter vocabulary) is initialised once by JAX's ``init_model`` (every
sub-net: the HuBERT head and the quantizer too) and crosses into the port
through ``utils/convert.from_jax_params``.  The same seeded numpy inputs
then go through the pre-LN encoder stack (the per-layer ``norm_k`` on the
shared table) on the plain route and on the kernel route (the inference
and train kernels' CPU twins reading each layer's band), the
``layer_norm`` conv extractor with ``features_pen``, ``encode_speech`` and
``forward_s2t`` with their gradients; ``remat`` is held equal to no remat;
the full-width ``speecht5_large`` state dict (built on the meta device: no
weights) round-trips through the fairseq names, and its shapes are
JAX's; a port checkpoint without the HuBERT head restores.

Torch runs with TF32 off; JAX at ``highest`` matmul precision
(tests/conftest.py).  Tolerances are those of
tests/test_torch_s2t_train.py: activations and losses within 2e-4
absolute, gradients within 2e-4 of each parameter's max |g| (the k_proj
and norm_k biases, analytically 0 -- each adds one constant to a row of
logits, which the softmax ignores -- within 1e-6 of the largest
gradient).
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.models.encoder import TransformerEncoder as JEnc
from speecht5_tpu.models.speecht5 import init_model as jinit_model
from speecht5_tpu.utils.convert import map_speecht5_key

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import serve
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.models.speecht5 import SpeechT5Model, init_model
from speecht5_tpu_torch.utils import checkpoint as PCk
from speecht5_tpu_torch.utils.convert import (from_jax_batch_stats, from_jax_params,
                                              map_fairseq_key)

torch.backends.cuda.matmul.allow_tf32 = False
LARGE_SHAPED = ["encoder.layer_norm_first=True", "decoder.layer_norm_first=True",
                "conv_features.mode='layer_norm'", "quantizer.enabled=True"]
# layerdrop off (the tiny preset has no dropout); the speech decoder's
# Tacotron prenet and conv postnet dropout off (JAX draws them from its
# own rngs)
STILL = ["encoder.layerdrop=0.0", "decoder.layerdrop=0.0",
         "speech_prenet.dropout=0.0", "speech_postnet.postnet_dropout=0.0"]
KERNEL_ROUTE = ["encoder.use_pallas_attn=True", "encoder.use_pallas_attn_train=True"]
B, T_WAV, L = 2, 4000, 7
ATOL = 2e-4


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def setup_models(overrides=(), seed=0, **kw):
    """(JAX config, model, variables, the port's model on the same weights,
    in train mode).  ``overrides`` apply to both; the kernel-route flags to
    the port alone (JAX's pre-LN layers take XLA whatever they say)."""
    kw = {**chip_smoke.DICT_CFG, **kw}
    ov = LARGE_SHAPED + STILL + [o for o in overrides if o not in KERNEL_ROUTE]
    jcfg = JC.apply_overrides(JC.speecht5_tiny(**kw), ov)
    jm, variables = jinit_model(jcfg, jax.random.PRNGKey(seed), wav_len=T_WAV)
    pcfg = PC.apply_overrides(PC.speecht5_tiny(**kw), ov + [
        o for o in overrides if o in KERNEL_ROUTE])
    model = init_model(pcfg, device="cpu")
    model.load_state_dict({**from_jax_params(flat(variables["params"])),
                           **from_jax_batch_stats(flat(variables["batch_stats"]))},
                          strict=True)
    return jcfg, jm, variables, model.train()


@pytest.fixture(scope="module", params=["plain", "kernel"])
def both_routes(request):
    return request.param, setup_models(KERNEL_ROUTE if request.param == "kernel" else ())


def speech_batch(seed=0, vocab=81):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((B, T_WAV)) * 0.1).astype(np.float32)
    lens = np.array([T_WAV, 2600], np.int32)
    tgt = rng.integers(4, vocab - 1, (B, L))
    tgt[0, -1] = 2
    tgt[1, 4], tgt[1, 5:] = 2, 1
    prev = np.full((B, L), 1)
    prev[:, 0] = 2
    prev[0, 1:] = tgt[0, :-1]
    prev[1, 1:5] = tgt[1, :4]
    return {"wav": wav, "wav_lengths": lens, "prev_tokens": prev, "targets": tgt}


def grads_close(got: dict, want: dict):
    """Every JAX gradient against the port's, by the port's names (a
    parameter that the loss does not reach has no port gradient: 0)."""
    gmax = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = got.get(name, np.zeros_like(w))
        if name.endswith(("k_proj.bias", "norm_k.bias")):
            assert np.abs(g).max() <= 1e-6 * gmax and np.abs(w).max() <= 1e-6 * gmax
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * np.abs(w).max(),
                                       err_msg=name)


def port_grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}


def jax_grads(g):
    return {k: v.numpy() for k, v in from_jax_params(flat(g)).items()}


def test_pre_ln_encoder_stack_matches_jax_on_both_routes(both_routes):
    """The pre-LN encoder (no LayerNorm on the input, a final one on the
    output, each layer's norm_k on the shared table) at T 45 (not a
    multiple of 8: the kernel route's row-padded band), ragged lengths: the
    output in eval mode (the inference kernel's route), and in train mode
    (the train kernel's) with the gradients of every layer's norm_k, the
    table and the layers."""
    route, (jcfg, jm, variables, model) = both_routes
    rng = np.random.default_rng(1)
    T, D = 45, jcfg.d_model
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.array([T, 31])[:, None]
    w = rng.standard_normal((B, T, D)).astype(np.float32)
    enc_vars = {"params": variables["params"]["encoder"]}
    jenc = JEnc(jcfg.encoder, ctc_vocab_size=jcfg.vocab_size)

    def jout(p, det):
        return jenc.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid),
                          deterministic=det)["encoder_out"]

    for train in (False, True):
        det = not train
        want, g = jax.jit(lambda p: (jout(p, det), jax.grad(
            lambda q: (jout(q, det) * w).sum())(p)))(enc_vars["params"])
        want = np.asarray(want)
        model.encoder.train(train)
        model.zero_grad(set_to_none=True)
        with torch.set_grad_enabled(train):
            got = model.encoder(torch.from_numpy(x), torch.from_numpy(valid))["encoder_out"]
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                                   err_msg=f"{route} train={train}")
        if not train:
            continue
        (got * torch.from_numpy(w)).sum().backward()
        want_g = jax_grads({"encoder": g})
        grads_close(port_grads(model), want_g)
        assert "encoder.layers.1.norm_k.weight" in want_g
        assert "encoder.pos_emb.pe_k.weight" in want_g
    model.zero_grad(set_to_none=True)


def test_layer_norm_extractor_encode_speech_and_forward_s2t_match_jax(both_routes):
    """The layer_norm conv extractor (conv, ln_i in f32 at flax's 1e-6,
    exact GELU, every layer), features_pen, encode_speech in eval, and
    forward_s2t in train mode (masking off) with every gradient."""
    route, (jcfg, jm, variables, model) = both_routes
    b = speech_batch()
    wav, lens = torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_lengths"])
    jfeats, jenc = jax.jit(lambda v, w, n: (
        jm.apply(v, w, method=lambda m, x: m.speech_encoder_prenet.feature_extractor(x)),
        jm.apply(v, w, n, method="encode_speech")))(
            variables, jnp.asarray(b["wav"]), jnp.asarray(b["wav_lengths"]))
    model.eval()
    with torch.no_grad():
        feats = model.speech_encoder_prenet.feature_extractor(wav)
        enc = model.encode_speech(wav, lens)
    assert model.speech_encoder_prenet.feature_extractor.ln_0.eps == 1e-6
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL)
    np.testing.assert_allclose(enc["encoder_out"].numpy(), np.asarray(jenc["encoder_out"]),
                               atol=ATOL)
    np.testing.assert_allclose(float(enc["features_pen"]), float(jenc["features_pen"]),
                               rtol=ATOL)
    np.testing.assert_array_equal(enc["valid_mask"].numpy(), np.asarray(jenc["valid_mask"]))

    def jfwd(p):
        return jm.apply({**variables, "params": p}, jnp.asarray(b["wav"]),
                        jnp.asarray(b["wav_lengths"]), jnp.asarray(b["prev_tokens"]),
                        mask=False, deterministic=False, method="forward_s2t")

    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(jfwd, variables["params"])
    w1 = rng.standard_normal(shapes[0].shape).astype(np.float32)
    w2 = rng.standard_normal(shapes[1].shape).astype(np.float32)

    def jloss(p):
        logits, ctc, _ = jfwd(p)
        return (logits * w1).sum() + (ctc * w2).sum(), (logits, ctc)

    (_, (jlogits, jctc)), g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model.train()
    model.zero_grad(set_to_none=True)
    logits, ctc, _ = model.forward_s2t(wav, lens, torch.from_numpy(b["prev_tokens"]),
                                       mask=False)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=ATOL)
    np.testing.assert_allclose(ctc.detach().numpy(), np.asarray(jctc), atol=ATOL)
    ((logits * torch.from_numpy(w1)).sum() + (ctc * torch.from_numpy(w2)).sum()).backward()
    want = jax_grads(g)
    assert "speech_encoder_prenet.feature_extractor.ln_2.weight" in want
    grads_close(port_grads(model), want)
    model.zero_grad(set_to_none=True)


def test_remat_equals_no_remat_at_pre_ln():
    """encoder.remat / decoder.remat at pre-LN (the train kernel's twin on,
    so each layer's band is rebuilt in the recompute): forward_s2t's
    outputs and every gradient equal, to 0."""
    cfg = PC.apply_overrides(PC.speecht5_tiny(**chip_smoke.DICT_CFG),
                             LARGE_SHAPED + STILL + KERNEL_ROUTE)
    b = speech_batch(3)
    args = [torch.from_numpy(b[k]) for k in ("wav", "wav_lengths", "prev_tokens")]
    outs = []
    for remat in (False, True):
        c = PC.apply_overrides(cfg, [f"encoder.remat={remat}", f"decoder.remat={remat}"])
        model = init_model(c, torch.Generator().manual_seed(5), "cpu").train()
        logits, ctc, _ = model.forward_s2t(*args, mask=False)
        (logits.sum() + ctc.sum()).backward()
        outs.append((logits.detach(), ctc.detach(), port_grads(model)))
    (l0, c0, g0), (l1, c1, g1) = outs
    assert torch.equal(l0, l1) and torch.equal(c0, c1) and set(g0) == set(g1)
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)


def test_large_state_dict_round_trips_the_fairseq_names_and_has_jax_shapes():
    """The full-width speecht5_large port model (the quantizer on), built
    on the meta device: every key goes to a fairseq name that the port's
    loader maps back to it and JAX's maps to a parameter, none missing or
    extra; and every JAX parameter (``jax.eval_shape`` of its init) has the
    port's shape after from_jax_params."""
    cfg = PC.speecht5_large(**chip_smoke.DICT_CFG, quantizer=PC.QuantizerConfig(enabled=True))
    with torch.device("meta"):
        model = SpeechT5Model(cfg)
    sd = model.state_dict()
    assert cfg.encoder.num_layers == 24 and cfg.encoder.d_model == 1024
    assert sd["encoder.layers.23.norm_k.weight"].shape == (64,)
    assert sd["speech_encoder_prenet.feature_extractor.ln_6.weight"].shape == (512,)
    back = {}
    for key in sd:
        fkey = key
        for pat, rep in chip_smoke.FAIRSEQ_NAMES:
            fkey = re.sub(pat, rep, fkey)
        assert map_speecht5_key(fkey)[0] != ("__unknown__",), fkey
        back[map_fairseq_key(fkey)] = key
    assert all(k == v for k, v in back.items()) and set(back) == set(sd)

    jcfg = JC.speecht5_large(**chip_smoke.DICT_CFG, quantizer=JC.QuantizerConfig(enabled=True))
    shapes = jax.eval_shape(lambda k: jinit_model(jcfg, k, wav_len=8000)[1],
                            jax.random.PRNGKey(0))
    zeros = lambda tree: {k: np.zeros(v.shape, np.float32)
                          for k, v in flatten_dict(tree, sep="/").items()}
    want = {**from_jax_params(zeros(shapes["params"])),
            **from_jax_batch_stats(zeros(shapes["batch_stats"]))}
    assert set(want) == set(sd)
    for key, value in want.items():
        assert tuple(value.shape) == tuple(sd[key].shape), key


def test_checkpoint_without_the_hubert_head_restores(tmp_path):
    """A port checkpoint written before the HuBERT head existed (no
    ``speech_encoder_postnet`` keys) restores in cli/serve.py --ckpt and
    through --finetune-from; the head keeps its initial values there."""
    cfg = PC.speecht5_tiny(**chip_smoke.DICT_CFG)
    src = init_model(cfg, torch.Generator().manual_seed(8), "cpu")
    old = {k: v for k, v in src.state_dict().items()
           if not k.startswith("speech_encoder_postnet.")}
    PCk.save_model_only(tmp_path / "old", old, step=3)
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    args = serve.build_parser().parse_args([
        "--ckpt", str(tmp_path / "old"), "--arch", "speecht5_tiny", "--dict", dict_path,
        "--decoder", "ctc_greedy", "--asr-buckets", "1", "--dtype", "float32"])
    svc = serve.Service(args, device="cpu")
    fresh = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    cli_train.warm_start(fresh, str(tmp_path / "old"))
    for model in (svc.model, fresh):
        for key, value in model.state_dict().items():
            if key.startswith("speech_encoder_postnet."):
                init = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
                assert torch.equal(value, init.state_dict()[key]), key
            else:
                assert torch.equal(value, old[key]), key
    assert svc.transcribe(chip_smoke.synth_audio(0.5, seed=1)) is not None
    with pytest.raises(RuntimeError, match="Missing key"):
        fresh.load_state_dict({k: v for k, v in old.items() if k != "encoder.proj.bias"})


def test_conv_extractor_epsilon_is_flax_not_the_references():
    """JAX's ln_i are flax LayerNorms (epsilon 1e-6), the reference's
    Fp32LayerNorm torch's (1e-5); the port follows JAX.  At the
    Large-shaped tiny preset on a 0.25 s waveform the two epsilons move the
    extractor's output by a measurable amount (ROADMAP C.2 files it)."""
    cfg = PC.apply_overrides(PC.speecht5_tiny(), LARGE_SHAPED)
    fe = init_model(cfg, torch.Generator().manual_seed(0), "cpu").speech_encoder_prenet
    fe = fe.feature_extractor
    wav = torch.from_numpy(chip_smoke.synth_audio(0.25, seed=4))[None]
    with torch.no_grad():
        ours = fe(wav)
        for i in range(len(cfg.conv_features.layers)):
            getattr(fe, f"ln_{i}").eps = 1e-5
        ref = fe(wav)
    diff = float((ours - ref).abs().max())
    print(f"ln_i epsilon 1e-6 vs 1e-5: max |diff| {diff:.3e}, max |out| "
          f"{float(ours.abs().max()):.3e}")
    assert 0.0 < diff < 1e-2
