"""The port's Prosody-SpeechT5 (``models/prosody.py``) held against the JAX
package (tests/test_prosody.py is the specification), at ``speecht5_tiny``
with a small ``ProsodyConfig`` in f32, on JAX's weights
(``init_prosody_speecht5``, carried with its BatchNorm statistics by
``utils/convert.prosody_from_jax_params``; the backbone's sub-nets that
JAX's init never touches, the speech encoder side and the text decoder,
stay out of both).  The Tacotron prenet's and the postnet's dropout are 0
on both sides (their draws cannot match, ROADMAP C.4).

- ``forward_t2s``: mels, stop logits and cross weights within 1e-4, the
  distillation loss 1e-5 relative; a padded token row and a mel shorter
  than the batch (odd lengths: the stride-2 "SAME" convs pad asymmetrically
  and the pooling mask follows ``(n + 1) // 2``).
- ``encode_text`` and ``encode_text_ref``: the conditioned encoder output
  and the prosody embeddings within 1e-5.
- ``TTSDecoder.text_to_speech`` under both modes (the predictor's
  prosody, and transfer from a reference mel through ``ProsodyTransfer``,
  held against a JAX model whose ``encode_text`` is ``encode_text_ref``):
  lengths equal, mel and stop probabilities within 1e-4.
- ``recipes/prosody_tts``: its first updates' losses against JAX's loss
  and optax updates on the same weights and batch (1e-4 relative).

Torch runs with TF32 off, JAX at ``highest`` matmul precision
(tests/conftest.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.decode.tts import TTSDecoder as JTTSDecoder
from speecht5_tpu.models.prosody import (ProsodyConfig as JProsodyConfig,
                                         ProsodySpeechT5 as JProsody,
                                         init_prosody_speecht5 as jinit_prosody)
from speecht5_tpu.train import criterions as jcriterions

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.decode.tts import TTSDecoder
from speecht5_tpu_torch.models.prosody import (ProsodyConfig, ProsodySpeechT5,
                                               ProsodyTransfer, init_prosody_speecht5)
from speecht5_tpu_torch.recipes import prosody_tts as R
from speecht5_tpu_torch.utils.convert import prosody_from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
TOL = 1e-4
EMB_TOL = 1e-5
LOSS_RTOL = 1e-5
PCFG = dict(dim=8, conv_channels=16, n_convs=2, predictor_hidden=16)
# the prenet's and the postnet's dropout off, so that the recipe's train-mode
# updates (BatchNorm on batch statistics) compare with JAX's
NO_DROPOUT = ["speech_prenet.dropout=0.0", "speech_postnet.postnet_dropout=0.0"]
# the backbone's sub-nets that JAX's init (forward_t2s, encode_text) never builds
UNTOUCHED = ("backbone.speech_encoder_prenet", "backbone.encoder.proj",
             "backbone.text_decoder_prenet", "backbone.text_decoder_postnet",
             "backbone.speech_encoder_postnet")


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _load(model, variables):
    missing = model.load_state_dict(prosody_from_jax_params(
        _flat(variables["params"]), _flat(variables["batch_stats"])), strict=False)
    assert not missing.unexpected_keys
    assert all(k.startswith(UNTOUCHED) for k in missing.missing_keys), missing.missing_keys
    return model.eval()


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.apply_overrides(JC.speecht5_tiny(), NO_DROPOUT)
    jm = JProsody(jcfg, JProsodyConfig(**PCFG))
    variables = jax.jit(lambda: jinit_prosody(jcfg, jax.random.PRNGKey(0),
                                              JProsodyConfig(**PCFG))[1])()
    cfg = PC.apply_overrides(PC.speecht5_tiny(), NO_DROPOUT)
    model = _load(ProsodySpeechT5(cfg, ProsodyConfig(**PCFG)), variables)
    return jcfg, jm, variables, cfg, model


def _batch(cfg, seed=0):
    """2 rows: tokens (the second padded), r-thinned prev mels, targets of
    15 and 11 frames in a 16-frame buffer (odd lengths), x-vectors."""
    rng = np.random.default_rng(seed)
    r = cfg.reduction_factor
    tokens = rng.integers(5, cfg.vocab_size, (2, 7))
    tokens[0, -1] = cfg.eos_id
    tokens[1, 5], tokens[1, 6:] = cfg.eos_id, cfg.pad_id
    target = rng.standard_normal((2, 16, cfg.n_mels)).astype(np.float32)
    thin = target[:, r - 1::r]
    prev = np.concatenate([np.zeros_like(thin[:, :1]), thin[:, :-1]], 1)
    return {"tokens": tokens, "prev_mel": prev, "tgt_lengths": np.asarray([8, 6]),
            "target_mel": target, "dec_lengths": np.asarray([15, 11]),
            "spk": rng.standard_normal((2, cfg.spk_embed_dim)).astype(np.float32)}


def test_forward_t2s_matches_jax(pair):
    jcfg, jm, variables, cfg, model = pair
    b = _batch(cfg)
    args = ("tokens", "prev_mel", "tgt_lengths", "spk", "target_mel", "dec_lengths")
    want = jax.jit(lambda v, *a: jm.apply(v, *a, deterministic=True, method="forward_t2s",
                                          rngs={"prenet": jax.random.PRNGKey(1)}))(
        variables, *(jnp.asarray(b[k]) for k in args))
    with torch.no_grad():
        got = model.forward_t2s(*(torch.from_numpy(b[k]) for k in args))
    for name, g, w in zip(("before", "after", "stop", "attn"), got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, err_msg=name)
    assert abs(float(got[4]) - float(want[4])) <= LOSS_RTOL * abs(float(want[4]))


def test_encode_text_and_ref_match_jax(pair):
    jcfg, jm, variables, cfg, model = pair
    b = _batch(cfg, 1)
    tokens, ref = jnp.asarray(b["tokens"]), jnp.asarray(b["target_mel"])
    ref_len = jnp.asarray(b["dec_lengths"])
    want_p = jm.apply(variables, tokens, method="encode_text")
    want_r = jm.apply(variables, tokens, ref, ref_len, method="encode_text_ref")
    want_e = jm.apply(variables, ref, ref_len, method="prosody_embedding")
    t = torch.from_numpy(b["tokens"])
    with torch.no_grad():
        got_p = model.encode_text(t)
        got_r = model.encode_text_ref(t, torch.from_numpy(b["target_mel"]),
                                      torch.from_numpy(b["dec_lengths"]))
        got_e = model.prosody_embedding(torch.from_numpy(b["target_mel"]),
                                        torch.from_numpy(b["dec_lengths"]))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=EMB_TOL)
    for got, want in ((got_p, want_p), (got_r, want_r)):
        np.testing.assert_allclose(got["encoder_out"].numpy(), np.asarray(want["encoder_out"]),
                                   atol=EMB_TOL)
        np.testing.assert_array_equal(got["valid_mask"].numpy(),
                                      np.asarray(want["valid_mask"]))


def _jax_transfer(ref, ref_len):
    class JTransfer(JProsody):
        """JAX's model with encode_text on a fixed reference (TTSDecoder
        calls ``encode_text``)."""

        def encode_text(self, tokens, *, deterministic=True):
            return self.encode_text_ref(tokens, ref, ref_len, deterministic=deterministic)

    return JTransfer


@pytest.mark.parametrize("mode", ["predicted", "transfer"])
def test_tts_decoder_drives_both_modes_as_jax(pair, mode):
    jcfg, jm, variables, cfg, model = pair
    b = _batch(cfg, 2)
    kw = dict(max_frames=24, threshold=0.5)
    ref, ref_len = b["target_mel"][:1], b["dec_lengths"][:1]
    if mode == "transfer":
        jm = _jax_transfer(jnp.asarray(ref), jnp.asarray(ref_len))(jcfg, JProsodyConfig(**PCFG))
        model = ProsodyTransfer(model, torch.from_numpy(ref), torch.from_numpy(ref_len))
    j = JTTSDecoder(jm, variables, **kw).text_to_speech(jnp.asarray(b["tokens"]),
                                                        jnp.asarray(b["spk"]))
    p = TTSDecoder(model, device="cpu", **kw).text_to_speech(torch.from_numpy(b["tokens"]),
                                                            torch.from_numpy(b["spk"]))
    np.testing.assert_array_equal(p.lengths.numpy(), np.asarray(j.lengths))
    for field in ("mel", "mel_before", "stop_probs"):
        np.testing.assert_allclose(getattr(p, field).numpy(), np.asarray(getattr(j, field)),
                                   atol=TOL, err_msg=field)


def test_recipe_updates_match_jax(pair):
    """``recipes/prosody_tts.run``'s first updates on JAX's weights and the
    recipe's batch against the JAX recipe's loss (TTS L1 + stop BCE +
    distillation, train mode: BatchNorm on batch statistics) under optax
    ``adamw``: the losses within 1e-4 relative."""
    jcfg, jm, variables, cfg, _ = pair
    steps = 3
    batch = R.style_batch(cfg, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    r = cfg.reduction_factor

    def loss_fn(p):
        out, _ = jm.apply({**variables, "params": p}, jb["tokens"], jb["prev_mel"],
                          jb["dec_lengths"] // r, jb["spk"], jb["target_mel"],
                          jb["dec_lengths"], deterministic=False, method="forward_t2s",
                          rngs={"prenet": jax.random.PRNGKey(1),
                                "dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        tts, _ = jcriterions.tts_loss(out[0], out[1], out[2], jb["target_mel"],
                                      jb["dec_lengths"], reduction_factor=r)
        return tts + out[4]

    tx = optax.adamw(R.LR)

    @jax.jit
    def train_step(p, o):
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(g, o, p)
        return optax.apply_updates(p, upd), o, loss

    params = variables["params"]
    opt = tx.init(params)
    want = []
    for _ in range(steps):
        params, opt, loss = train_step(params, opt)
        want.append(float(loss))
    model = _load(ProsodySpeechT5(cfg, ProsodyConfig(**PCFG)), variables)
    got = R.run(cfg, ProsodyConfig(**PCFG), steps=steps, device="cpu", model=model,
                batch=batch, log=lambda s: None)["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_recipe_runs_and_defaults_to_cuda(monkeypatch, capsys):
    R.main(["--steps", "2", "--device", "cpu"])
    assert '"done": true' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_prosody_speecht5(PC.speecht5_tiny(), ProsodyConfig(**PCFG))
