"""The port's VioLA (``models/viola.py``) held against the JAX package
(tests/test_viola.py is the specification), at ``viola_tiny`` in f32 on
JAX's weights (``init_viola``, carried by
``utils/convert.viola_from_jax_params``, strict).

- ``build_example``'s rows and masks bit-equal for the three tasks.
- The trunk's logits (1e-4 of max |logit|) and ``lm_loss`` (1e-5
  relative) on a batch of ASR, MT and TTS rows.
- ``generate``: the ASR, MT and TTS (``allowed_range``: the code block)
  continuations' tokens and lengths equal to JAX's, on the plain route and
  on the decode-step kernel's route (its twin on the CPU), also with an
  ``eos_id`` that stops one row early (the rest of a finished row is
  ``pad_id``).
- ``nar_logits`` at every stage (1e-4 of max |logit|).
- A right-padded prefix row: JAX continues it after its pads, so its tokens
  are not the row's own (ROADMAP C.2); the port gives JAX's.
- ``recipes/viola_multitask``: its rows bit-equal to the JAX recipe's, 3
  updates' losses against JAX's under optax ``adamw`` on the same weights
  (1e-4 relative), every task's greedy tokens on JAX's updated weights
  equal, and the one-codebook EnCodec decode within 1e-5 of JAX's codec.

Torch runs with TF32 off, JAX at ``highest`` matmul precision
(tests/conftest.py).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import optax

from speecht5_tpu.models.encodec import init_encodec as jinit_encodec
from speecht5_tpu.models.viola import (build_example as jbuild_example,
                                       init_viola as jinit_viola, viola_tiny as jviola_tiny)

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.models.viola import (TASKS, VioLAModel, build_example, init_viola,
                                             viola_tiny)
from speecht5_tpu_torch.models.encodec import EncodecModel
from speecht5_tpu_torch.recipes import viola_multitask as R
from speecht5_tpu_torch.utils.convert import encodec_from_jax_params, viola_from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
LOGIT_RTOL = 1e-4      # of max |logit|
LOSS_RTOL = 1e-5
MAX_NEW = 8
L = 14


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def jax_model():
    return jinit_viola(jviola_tiny(), jax.random.PRNGKey(0))


def _port(variables, kernels=False):
    cfg = viola_tiny()
    if kernels:
        cfg = dataclasses.replace(cfg, trunk=dataclasses.replace(cfg.trunk,
                                                                 use_pallas_attn=True))
    model = VioLAModel(cfg)
    model.load_state_dict(viola_from_jax_params(_flat(variables["params"])))
    return model.eval()


def _rows(seed=0):
    """Three rows a task (ASR units -> text, MT text -> text, TTS text ->
    codes), random ids of the shared space, as (task, src, tgt)."""
    cfg = viola_tiny()
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(3):
        n = int(rng.integers(2, 5))
        rows.append(("asr", [cfg.unit0 + int(u) for u in rng.integers(0, cfg.unit_vocab, n)],
                     [cfg.text0 + int(t) for t in rng.integers(0, cfg.text_vocab, 3)]))
        rows.append(("mt", [cfg.text0 + int(t) for t in rng.integers(0, cfg.text_vocab, n)],
                     [cfg.text0 + int(t) for t in rng.integers(0, cfg.text_vocab, 2)]))
        rows.append(("tts", [cfg.text0 + int(t) for t in rng.integers(0, cfg.text_vocab, n)],
                     [cfg.code0 + int(c) for c in rng.integers(0, cfg.codebook_size, 4)]))
    return rows


def _batch(rows):
    cfg, jcfg = viola_tiny(), jviola_tiny()
    got = [build_example(cfg, task, i % 2, src, tgt, L) for i, (task, src, tgt) in
           enumerate(rows)]
    want = [jbuild_example(jcfg, task, i % 2, src, tgt, L) for i, (task, src, tgt) in
            enumerate(rows)]
    for (gt, gm), (wt, wm) in zip(got, want):
        assert gt.dtype == wt.dtype and np.array_equal(gt, wt) and np.array_equal(gm, wm)
    return np.stack([t for t, _ in got]), np.stack([m for _, m in got])


def test_build_example_logits_and_loss_match_jax(jax_model):
    jm, variables = jax_model
    model = _port(variables)
    tokens, mask = _batch(_rows())
    want_logits = np.asarray(jm.apply(variables, jnp.asarray(tokens)))
    want_loss = float(jm.apply(variables, jnp.asarray(tokens), jnp.asarray(mask),
                               method="lm_loss"))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens)).numpy()
        loss = float(model.lm_loss(torch.from_numpy(tokens), torch.from_numpy(mask)))
    assert logits.shape == want_logits.shape
    assert np.abs(logits - want_logits).max() / np.abs(want_logits).max() < LOGIT_RTOL
    assert abs(loss - want_loss) / abs(want_loss) < LOSS_RTOL


def _prefix(cfg, task, src):
    return np.asarray([[cfg.lang_id(0), cfg.task_id(task), *src, cfg.sep_id]], np.int64)


@pytest.mark.parametrize("kernels", [False, True])
def test_three_tasks_greedy_tokens_equal_jax(jax_model, kernels):
    """Each task's prefix (a batch of its three rows, the same length);
    TTS constrained to the code block; then, with the eos id set to the
    token row 0 emits at step 2, that row stops there."""
    jm, variables = jax_model
    cfg = viola_tiny()
    model = _port(variables, kernels)
    rows = _rows(1)
    jgen = jax.jit(lambda v, x, eos_id, allowed_range: jm.apply(
        v, x, max_new=MAX_NEW, eos_id=eos_id, allowed_range=allowed_range,
        method="generate"), static_argnums=(2, 3))
    for task in TASKS:
        srcs = [src[:2] for t, src, _ in rows if t == task]
        prefix = np.concatenate([_prefix(cfg, task, s) for s in srcs])
        kw = {"allowed_range": (cfg.code0, cfg.total_vocab)} if task == "tts" else {}
        want_t, want_l = jgen(variables, jnp.asarray(prefix), None, kw.get("allowed_range"))
        got_t, got_l = model.generate(torch.from_numpy(prefix), max_new=MAX_NEW, **kw)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t), err_msg=task)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l), err_msg=task)
        eos = int(np.asarray(want_t)[0, 2])
        want_t, want_l = jgen(variables, jnp.asarray(prefix), eos, kw.get("allowed_range"))
        got_t, got_l = model.generate(torch.from_numpy(prefix), max_new=MAX_NEW, eos_id=eos,
                                      **kw)
        assert int(np.asarray(want_l)[0]) <= 2
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t), err_msg=task)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l), err_msg=task)


def test_nar_logits_match_jax(jax_model):
    jm, variables = jax_model
    cfg = viola_tiny()
    model = _port(variables)
    tokens, _ = _batch(_rows(2)[:4])
    codes = np.random.default_rng(3).integers(0, cfg.codebook_size, (4, cfg.n_codebooks, 6))
    code_valid = np.ones((4, 6), bool)
    code_valid[1, 4:] = False
    for stage in range(1, cfg.n_codebooks):
        want = np.asarray(jm.apply(variables, jnp.asarray(tokens), jnp.asarray(codes), stage,
                                   code_valid=jnp.asarray(code_valid), method="nar_logits"))
        with torch.no_grad():
            got = model.nar_logits(torch.from_numpy(tokens), torch.from_numpy(codes), stage,
                                   code_valid=torch.from_numpy(code_valid)).numpy()
        assert got.shape == want.shape == (4, 6, cfg.codebook_size)
        assert np.abs(got - want).max() / np.abs(want).max() < LOGIT_RTOL, stage


def test_padded_prefix_row_continues_after_its_pads_as_in_jax(jax_model):
    """Row 1's prefix is one token shorter, right-padded: JAX predicts its
    first token at the pad slot and its tokens differ from the row's own
    (ROADMAP C.2); the port's batch gives JAX's batch tokens."""
    jm, variables = jax_model
    cfg = viola_tiny()
    a = _prefix(cfg, "mt", [cfg.text0 + 1, cfg.text0 + 2, cfg.text0 + 3])
    b = _prefix(cfg, "mt", [cfg.text0 + 4, cfg.text0 + 5])
    batch = np.concatenate([a, np.concatenate([b, [[cfg.pad_id]]], 1)])
    want, _ = jm.apply(variables, jnp.asarray(batch), max_new=MAX_NEW, method="generate")
    alone, _ = jm.apply(variables, jnp.asarray(b), max_new=MAX_NEW, method="generate")
    assert not np.array_equal(np.asarray(want)[1], np.asarray(alone)[0])
    got, _ = _port(variables).generate(torch.from_numpy(batch), max_new=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_viola(viola_tiny())
    model = init_viola(viola_tiny(), device="cpu")
    cfg = model.cfg
    out, lengths = model.generate(torch.from_numpy(_prefix(cfg, "asr", [cfg.unit0])),
                                  max_new=4)
    assert out.shape == (1, 4) and lengths.shape == (1,)


def test_recipe_equals_jax(jax_model):
    jm, variables = jax_model
    cfg = viola_tiny()
    steps = 3
    tokens, mask = R.corpus(cfg, seed=0)
    # the JAX recipe's rows (recipes/viola_multitask.py:53-87), drawn anew
    rng, jcfg = np.random.default_rng(0), jviola_tiny()
    rows = []
    for _ in range(12):
        us = rng.integers(0, jcfg.unit_vocab, 3)
        rows.append(jbuild_example(jcfg, "asr", 0, [jcfg.unit0 + int(u) for u in us],
                                   [jcfg.text0 + int(u) % jcfg.text_vocab for u in us], R.L))
        ts = rng.integers(0, jcfg.text_vocab, 3)
        rows.append(jbuild_example(jcfg, "mt", 1, [jcfg.text0 + int(t) for t in ts],
                                   [jcfg.text0 + (int(t) + 1) % jcfg.text_vocab for t in ts],
                                   R.L))
        ts = rng.integers(0, jcfg.text_vocab, 2)
        rows.append(jbuild_example(jcfg, "tts", 0, [jcfg.text0 + int(t) for t in ts],
                                   [jcfg.code0 + int(t) % jcfg.codebook_size for t in ts],
                                   R.L))
    np.testing.assert_array_equal(tokens[:36], np.stack([r[0] for r in rows]))
    np.testing.assert_array_equal(mask[:36], np.stack([r[1] for r in rows]))
    tb, mb = jnp.asarray(tokens), jnp.asarray(mask)
    tx = optax.adamw(R.LR)

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(
            lambda pp: jm.apply({"params": pp}, tb, mb, method="lm_loss"))(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    params, opt, want = variables["params"], tx.init(variables["params"]), []
    for _ in range(steps):
        params, opt, loss = step(params, opt)
        want.append(float(loss))
    ccfg = R.codec_config(cfg)
    jcodec, codec_vars = jinit_encodec(ccfg, jax.random.PRNGKey(11))
    codec = EncodecModel(ccfg)
    codec.load_state_dict(encodec_from_jax_params(_flat(codec_vars["params"])))
    out = R.run(cfg, steps=steps, device="cpu", model=_port(variables), codec=codec.eval(),
                log=lambda s: None)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    model = _port({"params": params})
    gen = jax.jit(lambda p, x: jm.apply({"params": p}, x, max_new=4, method="generate"))
    for r in (0, 1, 2):
        prefix, _ = R.continuation(cfg, tokens[r])
        want_t, want_l = gen(params, jnp.asarray(prefix))
        got_t, got_l = model.generate(torch.from_numpy(prefix), max_new=4)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    codes = np.random.default_rng(4).integers(0, cfg.codebook_size, (1, 1, 5))
    want_wav = np.asarray(jcodec.apply(codec_vars, jnp.asarray(codes, jnp.int32),
                                       method="decode_codes"))
    with torch.no_grad():
        wav = codec.decode_codes(torch.from_numpy(codes))
    np.testing.assert_allclose(wav.numpy(), want_wav, atol=1e-5)


def test_recipe_main_runs_on_the_cpu(tmp_path, capsys):
    R.main(["--steps", "3", "--device", "cpu", "--out", str(tmp_path / "vi.wav")])
    assert '"done": true' in capsys.readouterr().out and (tmp_path / "vi.wav").exists()
