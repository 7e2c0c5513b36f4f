"""WavLLM in the port, held against the JAX package.

At ``wavllm_tiny(n_mels=80, max_seq_len=512)`` (f32; the recipe's preset:
Whisper-protocol mels and a RoPE table past the chat template's 205-token
left prompt), on JAX's initial weights carried by
``utils/convert.wavllm_from_jax_params`` (strict loads), the LoRA ``B``
drawn from a seeded numpy so that the adapters act (JAX inits them 0):
RMSNorm, RoPE, ``LoRALinear`` (plain and MoE), ``Conv1dSubsampler`` and
``WhisperStyleEncoder`` (1e-5); ``forward_sft``'s logits (1e-5), its
masked cross-entropy and the gradients of every parameter SFT trains (1e-4
of max |g|); ``generate`` and ``generate_beam`` tokens equal to JAX's and
the beam scores within 1e-5, with and without left tokens, with an empty
prompt, and with LoRA-MoE (3 experts); the kernel flags' twins against the
plain route; the recipe's first loss against JAX's loss function on the
same batch, and its refusal without a card.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

import speecht5_tpu.models.wavllm as JW

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.models.wavllm as PW
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.recipes import wavllm_sft as R
from speecht5_tpu_torch.utils.convert import wavllm_from_jax_params

TOL = 1e-5
B, TM, TW = 2, 24, 4000
SEQ = R.TINY_SEQ_LEN
MAX_NEW, BEAM = 5, 3


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol=TOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=msg)


def inputs(cfg, seed=0):
    """mel, mel_lengths, wav, wav_lengths, prompt, target, left: two rows,
    the second shorter, its left segment padded and its prompt empty."""
    rng = np.random.default_rng(seed)
    return dict(
        mel=rng.standard_normal((B, TM, cfg.n_mels)).astype(np.float32),
        mel_lengths=np.array([TM, TM - 8], np.int32),
        wav=(rng.standard_normal((B, TW)) * 0.1).astype(np.float32),
        wav_lengths=np.array([TW, TW // 2], np.int32),
        prompt=np.array([[5, 6, 7], [0, 0, 0]], np.int32),
        target=np.array([[9, 10, 11, 2], [9, 10, 2, 0]], np.int32),
        left=np.array([[1, 3, 4, 8], [1, 3, 0, 0]], np.int32))


def jcfg(**kw):
    return JW.wavllm_tiny(**{"n_mels": 80, "max_seq_len": SEQ, **kw})


def pcfg(**kw):
    return PW.wavllm_tiny(**{"n_mels": 80, "max_seq_len": SEQ, **kw})


def with_lora_b(params: dict, seed=5) -> dict:
    """JAX's params with every ``lora_B`` drawn from N(0, 0.1) (seeded)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat(params).items():
        out[k] = ((rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                  if k.endswith("lora_B") else v)
    return out


def port_model(cfg, flat_params):
    m = PW.WavLLMModel(cfg)
    m.load_state_dict(wavllm_from_jax_params(flat_params), strict=True)
    return m.eval()


def jparams(flat_params):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat_params.items()}))


@pytest.fixture(scope="module")
def base():
    """JAX's init of the tiny WavLLM (LoRA B drawn) and the port's model on
    its weights."""
    cfg = jcfg()
    x = inputs(cfg)
    v = jax.jit(lambda: JW.WavLLMModel(cfg).init(
        {"params": jax.random.PRNGKey(0)}, x["mel"], x["mel_lengths"], x["prompt"],
        x["target"], x["wav"], x["wav_lengths"], x["left"], method="forward_sft"))()
    fp = with_lora_b(v["params"])
    return cfg, fp, port_model(pcfg(), fp)


#: the submodules whose outputs the tests hold, JAX's names
CAPTURED = ("whisper", "whisper_adapter", "wavlm", "wavlm_adapter", "wq")


def sft_loss_jax(model, params, x, capture=False):
    """JAX's masked cross-entropy of ``forward_sft`` (the recipe's loss) ->
    (loss, (logits, gate, the captured submodules' outputs or None))."""
    kw = {}
    if capture:
        kw = dict(capture_intermediates=lambda m, name: name == "__call__" and m.name in CAPTURED,
                  mutable=["intermediates"])
    out = model.apply({"params": params}, x["mel"], x["mel_lengths"], x["prompt"],
                      x["target"], x["wav"], x["wav_lengths"], x["left"],
                      method="forward_sft", **kw)
    (logits, gate), inter = out if capture else (out, None)
    tgt = x["target"]
    mask = (tgt != 0).astype(jnp.float32)
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    ce = -jnp.take_along_axis(lp, tgt[..., None], -1)[..., 0]
    return (ce * mask).sum() / mask.sum(), (logits, gate, inter)


def jax_decodes(model, x, left=True):
    kw = dict(max_new=MAX_NEW, wav=x["wav"], wav_lengths=x["wav_lengths"],
              left_tokens=x["left"] if left else None)
    return (model.generate(x["mel"], x["mel_lengths"], x["prompt"], **kw),
            model.generate_beam(x["mel"], x["mel_lengths"], x["prompt"], beam_size=BEAM, **kw))


def jax_run(cfg, params, x, lefts=(True,)):
    """One compiled JAX program: the SFT loss, its gradients, the logits,
    the gate and the captured submodule outputs, and the decodes with each
    of ``lefts``."""
    jm = JW.WavLLMModel(cfg)

    def run(p):
        sft = jax.value_and_grad(lambda pp: sft_loss_jax(jm, pp, x, True), has_aux=True)(p)
        return sft, [jm.apply({"params": p}, method=lambda m, lf=lf: jax_decodes(m, x, lf))
                     for lf in lefts]

    return jax.jit(run)(params)


def port_captures(model):
    """Forward hooks on the port's counterparts of ``CAPTURED`` (LLaMA layer
    0's ``wq``) -> the dict they fill with each module's last output."""
    got = {}
    mods = {"whisper": model.whisper, "whisper_adapter": model.whisper_adapter,
            "wavlm": model.wavlm, "wavlm_adapter": model.wavlm_adapter,
            "wq": model.llama_layers[0].wq}
    for name, mod in mods.items():
        mod.register_forward_hook(lambda m, a, o, name=name: got.__setitem__(name, o))
    return got


def captures_close(got, inter):
    """Each captured output (and length) against JAX's: the Whisper encoder,
    both adapters, WavLM, and LLaMA layer 0's LoRA wq."""
    inter = inter["intermediates"]
    for name in CAPTURED[:4]:
        (jy, jl), = inter[name]["__call__"]
        close(got[name][0], jy, msg=name)
        np.testing.assert_array_equal(got[name][1].numpy(), np.asarray(jl))
    close(got["wq"], inter["llama_layers_0"]["wq"]["__call__"][0], msg="wq")


def sft_port(model, x):
    tb = port_batch(x)
    R.freeze_for_sft(model)
    loss = R.sft_loss(model, tb)
    loss.backward()
    with torch.no_grad():
        logits, gate = model.forward_sft(tb["mel"], tb["mel_lengths"], tb["prompt_tokens"],
                                         tb["target_tokens"], tb["wav"], tb["wav_lengths"],
                                         tb["left_tokens"])
    return loss, logits, gate


def port_batch(x, left=True):
    return {"mel": t(x["mel"]), "mel_lengths": t(x["mel_lengths"]), "wav": t(x["wav"]),
            "wav_lengths": t(x["wav_lengths"]), "prompt_tokens": t(x["prompt"]).long(),
            "target_tokens": t(x["target"]).long(),
            "left_tokens": t(x["left"]).long() if left else None}


def decodes_port(model, x, left=True):
    tb = port_batch(x, left)
    kw = dict(max_new=MAX_NEW, wav=tb["wav"], wav_lengths=tb["wav_lengths"],
              left_tokens=tb["left_tokens"])
    return (model.generate(tb["mel"], tb["mel_lengths"], tb["prompt_tokens"], **kw),
            model.generate_beam(tb["mel"], tb["mel_lengths"], tb["prompt_tokens"],
                                beam_size=BEAM, **kw))


def decodes_equal(port, jx):
    (g, (bt, bs)), (jg, (jbt, jbs)) = port, jx
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))
    np.testing.assert_allclose(bs.numpy(), np.asarray(jbs), rtol=TOL, atol=0)


def grads_close(model, jgrads: dict):
    """The trained parameters' gradients (by the port's names) within 1e-4
    of each one's max |g|."""
    want = {n: np.asarray(g) for n, g in wavllm_from_jax_params(flat(jgrads)).items()
            if PW.lora_param_filter(n)}
    got = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    assert set(got) == set(want)
    for n, w in want.items():
        assert np.abs(w).max() > 0, n
        close(got[n], w, atol=1e-4 * np.abs(w).max(), msg=n)


# ----------------------------------------------------------------- modules


@pytest.fixture(scope="module")
def jref(base):
    """JAX on the base weights, one program: the SFT loss, gradients,
    logits and captured outputs on ``inputs(seed=0)``, the decodes with and
    without the left segment on ``inputs(seed=1)``."""
    cfg, fp, _ = base
    x, xd = inputs(cfg), inputs(cfg, seed=1)
    jm = JW.WavLLMModel(cfg)

    def run(p):
        sft = jax.value_and_grad(lambda pp: sft_loss_jax(jm, pp, x, True), has_aux=True)(p)
        return sft, [jm.apply({"params": p}, method=lambda m, lf=lf: jax_decodes(m, xd, lf))
                     for lf in (True, False)]

    return jax.jit(run)(jparams(fp))


def test_norm_and_rope_match_jax():
    """RMSNorm (a non-unit scale) and the RoPE tables and rotation at
    positions up to 300."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    norm = PW.RMSNorm(32)
    norm.weight.data = t(w)
    close(norm(t(x)), JW.RMSNorm(32).apply({"params": {"weight": w}}, x))
    jc, js = JW.rope_tables(8, SEQ, 10000.0)
    pc, ps = PW.rope_tables(8, SEQ, 10000.0)
    close(pc, jc, atol=1e-6)
    close(ps, js, atol=1e-6)
    pos = rng.integers(0, 300, (2, 6))
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    close(PW.apply_rope(t(q), pc, ps, t(pos)), JW.apply_rope(q, jc, js, pos))


def test_lora_param_filter_names_what_jax_trains(base):
    fp = base[1]
    trained = {n: fp[n] for n in fp if JW.lora_param_filter(tuple(n.split("/")))}
    port = {n for n, _ in base[2].named_parameters() if PW.lora_param_filter(n)}
    assert port == set(wavllm_from_jax_params(trained))
    assert any("lora_A" in n for n in port) and not any("tok_embeddings" in n for n in port)


def test_forward_sft_loss_and_gradients_match_jax(base, jref):
    """Logits (1e-5), the masked cross-entropy, the trained parameters'
    gradients (1e-4 of max |g|), and on the way the Whisper encoder, the
    subsamplers, WavLM and the LoRA wq of layer 0 (1e-5, lengths equal);
    the packed prefix covers a padded left segment and an empty prompt
    (the first target from the last audio frame)."""
    cfg, fp, _ = base
    (jloss, (jlogits, jgate, inter)), jg = jref[0]
    pm = port_model(pcfg(), fp)
    got = port_captures(pm)
    loss, logits, gate = sft_port(pm, inputs(cfg))
    assert gate is None and jgate is None
    captures_close(got, inter)
    close(logits, jlogits)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    grads_close(pm, jg)


@pytest.mark.parametrize("left", [True, False], ids=["left", "no_left"])
def test_generate_and_beam_match_jax(base, jref, left):
    """Greedy and beam tokens equal to JAX's, beam scores within 1e-5 (the
    second row's prompt is empty)."""
    cfg, _, pm = base
    decodes_equal(decodes_port(pm, inputs(cfg, seed=1), left), jref[1][0 if left else 1])


def test_lora_moe_matches_jax(base):
    """LoRA-MoE (3 experts): the gate, the LoRA wq of layer 0 (the experts
    mixed by each example's gate), ``forward_sft``'s logits, the loss and
    gradients, greedy and beam decodes.  The tree is JAX's init of the MoE
    model (its abstract shapes): the shared weights the base init's, the
    expert pairs and the gate drawn seeded."""
    cfg, fp, _ = base
    mcfg = jcfg(lora_moe=True, n_experts=3)
    x = inputs(mcfg, seed=2)
    shapes = flatten_dict(jax.eval_shape(lambda: JW.WavLLMModel(mcfg).init(
        {"params": jax.random.PRNGKey(0)}, x["mel"], x["mel_lengths"], x["prompt"],
        x["target"], x["wav"], x["wav_lengths"], x["left"],
        method="forward_sft"))["params"], sep="/")
    rng = np.random.default_rng(11)
    mp = {k: fp[k] if k in fp and fp[k].shape == tuple(s.shape)
          else (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
          for k, s in shapes.items()}
    assert {k for k in mp if k not in fp or fp[k].shape != mp[k].shape} >= {
        "moe_gate/kernel", "llama_layers_0/wq/lora_A", "llama_layers_1/wo/lora_B"}
    ((jloss, (jlogits, jgate, inter)), jg), (jdec,) = jax_run(mcfg, jparams(mp), x)
    pm = port_model(pcfg(lora_moe=True, n_experts=3), mp)
    got = port_captures(pm)
    loss, logits, gate = sft_port(pm, x)
    close(gate, jgate)
    captures_close(got, inter)
    close(logits, jlogits)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    grads_close(pm, jg)
    decodes_equal(decodes_port(pm, x), jdec)


def test_kernel_flags_take_the_twins_on_the_cpu(base):
    """Every kernel flag on (WavLM's attention and the LLaMA decode step on
    ``flash_attention_bias``, the extractor on the conv stack): on CPU
    tensors the wrappers run their twins and launch nothing, and the
    logits, loss, gradients and decodes equal the plain route's."""
    cfg, fp, plain = base
    kcfg = pcfg(use_pallas_attn=True)
    kcfg = dataclasses.replace(kcfg, wavlm=dataclasses.replace(
        kcfg.wavlm, use_pallas_attn=True,
        conv=dataclasses.replace(kcfg.wavlm.conv, impl="pallas")))
    kern = port_model(kcfg, fp)
    x = inputs(cfg, seed=3)
    K.reset_launch_counts()
    runs = []
    for m in (port_model(pcfg(), fp), kern):
        loss, logits, _ = sft_port(m, x)
        runs.append((loss.item(), logits, {n: p.grad for n, p in m.named_parameters()
                                           if p.grad is not None}, decodes_port(m, x)))
    (lp, gp_logits, gp, dp), (lk, gk_logits, gk, dk) = runs
    np.testing.assert_allclose(lk, lp, rtol=1e-6)
    close(gk_logits, gp_logits, atol=1e-5)
    for n, g in gp.items():
        close(gk[n], g, atol=1e-5 * g.abs().max().item(), msg=n)
    decodes_equal(dk, (dp[0].numpy(), (dp[1][0].numpy(), dp[1][1].numpy())))
    assert sum(K.launch_counts().values()) == 0


def test_rope_past_the_table_is_refused_where_jax_clamps(base):
    """JAX's ``apply_rope`` reads a position past its ``max_seq_len`` table
    as the last row, silently (positions 200 and 269 of a 128-row table
    rotate as 127: off by up to 3.1 against a 512-row table, where 127
    agrees); the port's ``forward_sft`` and ``generate`` refuse such a
    sequence."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 3, 4, 8)).astype(np.float32)
    pos = np.array([[127, 200, 269]])
    short, full = (np.asarray(JW.apply_rope(q, *JW.rope_tables(8, n, 10000.0), pos))
                   for n in (128, 512))
    diff = np.abs(short - full).max(axis=(0, 2, 3))
    assert diff[0] == 0.0 and diff[1:].min() > 1.0
    np.testing.assert_array_equal(short[:, 1], np.asarray(JW.apply_rope(
        q[:, 1:2], *JW.rope_tables(8, 128, 10000.0), np.array([[127]])))[:, 0])
    cfg = pcfg(max_seq_len=8)
    m = PW.WavLLMModel(cfg)
    m.load_state_dict(base[2].state_dict())
    x = inputs(cfg)
    tb = port_batch(x)
    with pytest.raises(ValueError, match="max_seq_len"):
        m.forward_sft(tb["mel"], tb["mel_lengths"], tb["prompt_tokens"], tb["target_tokens"],
                      tb["wav"], tb["wav_lengths"], tb["left_tokens"])
    with pytest.raises(ValueError, match="max_seq_len"):
        m.generate(tb["mel"], tb["mel_lengths"], tb["prompt_tokens"], max_new=8)


def test_init_wavllm_draws_in_place_with_bf16_matrices():
    """``init_wavllm`` builds on the device asked for, the frozen matrices
    in the dtype asked for, the vectors and the trained parameters f32,
    LoRA B zero unless asked, Whisper's table from the espnet sinusoids."""
    m = PW.init_wavllm(pcfg(), torch.Generator().manual_seed(0), "cpu",
                       param_dtype=torch.bfloat16)
    for n, p in m.named_parameters():
        want = (torch.bfloat16 if p.dim() >= 2 and not PW.lora_param_filter(n)
                else torch.float32)
        assert p.dtype == want and p.device.type == "cpu", n
        assert torch.isfinite(p.float()).all(), n
    assert float(m.llama_layers[0].wq.lora_B.detach().abs().max()) == 0.0
    close(m.whisper.embed_positions.float()[:4, :6],
          PW.espnet_sinusoidal_table(64, 32)[:4, :6], atol=1e-2)
    m2 = PW.init_wavllm(pcfg(), torch.Generator().manual_seed(0), "cpu", lora_b_std=0.02)
    assert float(m2.llama_layers[0].wq.lora_B.detach().abs().max()) > 0.0


# ------------------------------------------------------------------ recipe


def test_recipe_first_loss_matches_the_jax_loss_function(base, tmp_path):
    """``recipes/wavllm_sft``'s steps as ``run`` takes them, on JAX's
    weights over a written corpus: the batch through ``WavLLMDataset``
    (chat template, byte tokens, the Whisper mel), the LoRA-only AdamW, its
    first loss the JAX loss function's on that batch, then lower losses and
    greedy tokens."""
    cfg, fp, _ = base
    tsv = R.write_corpus(str(tmp_path), 2, seed=3)
    batch = R.load_batch(tsv, R.byte_tokenizer(cfg.vocab_size), pcfg(), max_frames=60,
                         max_target=6)
    x = dict(mel=batch["mel"], mel_lengths=batch["mel_lengths"], wav=batch["wav"],
             wav_lengths=batch["wav_lengths"], prompt=batch["prompt_tokens"],
             target=batch["target_tokens"], left=batch["left_tokens"])
    jloss, _ = jax.jit(lambda pp: sft_loss_jax(JW.WavLLMModel(cfg), pp, x))(jparams(fp))
    model = port_model(pcfg(), fp)
    params = R.freeze_for_sft(model)
    opt = R.make_optimizer(params, 1e-3)
    b = R.to_device(batch, "cpu")
    losses = [R.sft_update(model, opt, b) for _ in range(3)]
    np.testing.assert_allclose(losses[0], float(jloss), rtol=TOL)
    assert losses[2] < losses[0]
    assert R.greedy(model, b, 4).shape == (2, 4)
    assert 0 < sum(p.numel() for p in params) < sum(p.numel() for p in model.parameters())


def test_recipe_runs_two_steps_on_the_cpu(capsys):
    out = R.main(["--steps", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "done: 2 steps" in capsys.readouterr().err


def test_recipe_defaults_to_cuda_and_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        R.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        PW.init_wavllm(pcfg())
