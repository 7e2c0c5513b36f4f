"""The port's VALL-E X (``models/vallex.py``) held against the JAX package
(tests/test_vallex.py is the specification), at ``vallex_tiny`` in f32 on
JAX's weights (``init_vallex``, carried by
``utils/convert.vallex_from_jax_params``, strict).

- The AR stage's teacher-forced logits on a batch with a padded phoneme
  row, and the NAR stage's at every stage with a code mask: within 1e-4
  of max |logit|.
- ``VALLEX_AR.generate`` at temperature 0: codes and lengths equal to
  JAX's, with the eos logit's bias raised so that rows stop at different
  steps (and one case where every row stops before max_new, so JAX's loop
  ends early and leaves zeros), on the plain route and on the decode-step
  kernel's route (its twin on the CPU).
- ``VALLEX.synthesize``: every codebook and the lengths equal.
- A step position past the sinusoid table: JAX reads the table's last row
  (ROADMAP C.2), the port raises.
- ``recipes/vallex_tts``: 2 updates' AR and NAR losses against the JAX
  recipe's under optax ``adamw`` on the same weights (1e-4 relative), then
  the synthesis' codes on JAX's updated weights equal, and the EnCodec
  decode of prompt + codes within 1e-5 of JAX's codec on its weights.

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
from speecht5_tpu.models.vallex import init_vallex as jinit_vallex, vallex_tiny as jvallex_tiny

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.models.vallex import VALLEX, init_vallex, vallex_tiny
from speecht5_tpu_torch.models.encodec import EncodecModel
from speecht5_tpu_torch.recipes import vallex_tts as R
from speecht5_tpu_torch.utils.convert import encodec_from_jax_params, vallex_from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
LOGIT_RTOL = 1e-4      # of max |logit|
# eos logit biases: none (every row runs to max_new), rows stopping at
# different steps, every row stopping early
EOS_BIASES = (0.0, 0.7, 0.8)
MAX_NEW = 10


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def jax_model():
    return jinit_vallex(jvallex_tiny(), jax.random.PRNGKey(0))


def _port(variables, kernels=False):
    cfg = vallex_tiny()
    if kernels:
        cfg = dataclasses.replace(cfg, ar=dataclasses.replace(cfg.ar, use_pallas_attn=True))
    model = VALLEX(cfg)
    model.load_state_dict(vallex_from_jax_params(_flat(variables["params"])))
    return model.eval()


def _with_eos_bias(variables, bias):
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    b = params["ar"]["out_proj"]["bias"].copy()
    b[jvallex_tiny().code_eos] += bias
    params["ar"]["out_proj"]["bias"] = b
    return {"params": params}


def _inputs(seed=0):
    cfg = vallex_tiny()
    rng = np.random.default_rng(seed)
    phonemes = rng.integers(1, cfg.phoneme_vocab, (3, 6))
    phonemes[1, 4:] = cfg.pad_id
    codes = rng.integers(0, cfg.codebook_size, (3, cfg.n_codebooks, 5))
    return phonemes, codes


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_ar_and_nar_logits_match_jax(jax_model):
    jm, variables = jax_model
    model = _port(variables)
    phonemes, codes = _inputs()
    cfg = vallex_tiny()
    prev = np.concatenate([np.full((3, 1), cfg.code_bos), codes[:, 0, :-1]], 1)
    want = np.asarray(jm.apply(variables, jnp.asarray(phonemes), jnp.asarray(prev),
                               method="forward_ar"))
    with torch.no_grad():
        got = model.forward_ar(torch.from_numpy(phonemes), torch.from_numpy(prev)).numpy()
    assert got.shape == want.shape == (3, 5, cfg.codebook_size + 1)
    assert _rel(got, want) < LOGIT_RTOL
    code_valid = np.ones((3, 5), bool)
    code_valid[2, 3:] = False
    for stage in range(1, cfg.n_codebooks):
        want = np.asarray(jm.apply(variables, jnp.asarray(phonemes), jnp.asarray(codes), stage,
                                   code_valid=jnp.asarray(code_valid), method="forward_nar"))
        with torch.no_grad():
            got = model.forward_nar(torch.from_numpy(phonemes), torch.from_numpy(codes), stage,
                                    code_valid=torch.from_numpy(code_valid)).numpy()
        assert got.shape == want.shape == (3, 5, cfg.codebook_size)
        assert _rel(got, want) < LOGIT_RTOL, stage


@pytest.mark.parametrize("kernels", [False, True])
def test_generate_codes_and_lengths_equal_jax(jax_model, kernels):
    jm, variables = jax_model
    phonemes, codes = _inputs(1)
    lengths_seen = []
    generate = jax.jit(lambda v, ph, pr: jm.apply(v, ph, pr, max_new=MAX_NEW,
                                                  method=lambda m, *a, **k:
                                                  m.ar.generate(*a, **k)))
    for bias in EOS_BIASES:
        v = _with_eos_bias(variables, bias)
        want_c, want_l = generate(v, jnp.asarray(phonemes), jnp.asarray(codes[:, 0]))
        model = _port(v, kernels)
        got_c, got_l = model.ar.generate(torch.from_numpy(phonemes),
                                         torch.from_numpy(codes[:, 0]), max_new=MAX_NEW)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c), err_msg=str(bias))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l), err_msg=str(bias))
        lengths_seen.append(np.asarray(want_l).tolist())
    # the cases reach every branch: no stop, rows stopping apart, all stopped
    assert lengths_seen[0] == [MAX_NEW] * 3
    assert len(set(lengths_seen[1])) > 1
    assert max(lengths_seen[2]) < MAX_NEW - 1


def test_synthesize_equals_jax(jax_model):
    jm, variables = jax_model
    v = _with_eos_bias(variables, EOS_BIASES[1])
    phonemes, codes = _inputs(2)
    want_c, want_l = jm.apply(v, jnp.asarray(phonemes), jnp.asarray(codes), max_new=MAX_NEW,
                              method="synthesize")
    got_c, got_l = _port(v).synthesize(torch.from_numpy(phonemes), torch.from_numpy(codes),
                                       max_new=MAX_NEW)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_steps_past_the_sinusoid_table_raise(jax_model):
    """With prompt + max_new past ``max_len`` JAX's steps read the table's
    last row over and over (ROADMAP C.2); the port refuses."""
    jm, variables = jax_model
    cfg = vallex_tiny()
    phonemes, codes = _inputs()
    prompt = np.zeros((3, cfg.max_len - 4), np.int64)
    jm.apply(variables, jnp.asarray(phonemes), jnp.asarray(prompt), max_new=8,
             method=lambda m, *a, **k: m.ar.generate(*a, **k))
    with pytest.raises(ValueError, match="positions past the table"):
        _port(variables).ar.generate(torch.from_numpy(phonemes), torch.from_numpy(prompt),
                                     max_new=8)


def test_init_defaults_to_cuda_and_samples_with_a_generator(monkeypatch):
    """``init_vallex`` runs on the card unless asked for the CPU; at
    temperature > 0 the codes come from the caller's generator (the same
    seed, the same codes)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_vallex(vallex_tiny())
    model = init_vallex(vallex_tiny(), torch.Generator().manual_seed(0), device="cpu")
    phonemes, codes = _inputs()
    runs = [model.synthesize(torch.from_numpy(phonemes), torch.from_numpy(codes), max_new=6,
                             temperature=1.0, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])


def test_recipe_equals_jax(jax_model):
    jm, variables = jax_model
    cfg = vallex_tiny()
    steps = 2
    phonemes, codes = R.code_corpus(cfg, seed=0)
    ph, cd = jnp.asarray(phonemes), jnp.asarray(codes)
    prev = jnp.concatenate([jnp.full((R.B, 1), cfg.code_bos), cd[:, 0, :-1]], axis=1)

    def loss_fn(p, stage):
        lp = jax.nn.log_softmax(jm.apply({"params": p}, ph, prev, method="forward_ar"), -1)
        ar = -jnp.take_along_axis(lp, cd[:, 0][..., None], -1).mean()
        lp2 = jax.nn.log_softmax(jm.apply({"params": p}, ph, cd, stage, method="forward_nar"),
                                 -1)
        nar = -jnp.take_along_axis(lp2, cd[:, stage][..., None], -1).mean()
        return ar + nar, (ar, nar)

    tx = optax.adamw(R.LR)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=1)
    params, opt, want = variables["params"], tx.init(variables["params"]), []
    for step in range(steps):
        (_, (ar, nar)), g = grad_fn(params, 1 + step % (cfg.n_codebooks - 1))
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        want.append((float(ar), float(nar)))
    ccfg = R.codec_config(cfg)
    _, codec_vars = jinit_encodec(ccfg, jax.random.PRNGKey(7))
    codec = EncodecModel(ccfg)
    codec.load_state_dict(encodec_from_jax_params(_flat(codec_vars["params"])))
    out = R.run(cfg, steps=steps, device="cpu", model=_port(variables), codec=codec.eval(),
                log=lambda s: None)
    np.testing.assert_allclose(np.stack([out["ar_nll"], out["nar_nll"]], 1), want, rtol=1e-4)
    prompt = codes[:1, :, :R.PROMPT]
    want_c, want_l = jax.jit(lambda p, x, y: jm.apply(
        {"params": p}, x, y, max_new=R.LC - R.PROMPT, method="synthesize"))(
        params, ph[:1], jnp.asarray(prompt))
    got_c, got_l = _port({"params": params}).synthesize(
        torch.from_numpy(phonemes[:1]), torch.from_numpy(prompt), max_new=R.LC - R.PROMPT)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    full = np.concatenate([prompt, np.asarray(want_c)], -1)
    want_wav = np.asarray(jinit_encodec(ccfg, jax.random.PRNGKey(7))[0].apply(
        codec_vars, jnp.asarray(full, jnp.int32), method="decode_codes"))
    with torch.no_grad():
        wav = codec.decode_codes(torch.from_numpy(full))
    np.testing.assert_allclose(wav.numpy(), want_wav, atol=1e-5)


def test_recipe_main_runs_on_the_cpu(tmp_path, capsys):
    R.main(["--steps", "3", "--device", "cpu", "--out", str(tmp_path / "v.wav")])
    assert '"done": true' in capsys.readouterr().out and (tmp_path / "v.wav").exists()
