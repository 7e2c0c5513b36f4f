"""The pre-LN decoder stack, the fusion LM and the LM-fused beam held
against the JAX package (tests/test_beam.py:260 ``TestLMFusion`` is the
specification).

- The pre-LN ``TransformerDecoder`` (cross-attention, the final
  ``layer_norm``): teacher-forced and decode steps within 1e-5, at the
  ``lm_tiny`` trunk's geometry and at Dh 80 (d 160, 2 heads).
- ``TransformerLM``: ``forward`` on padded tokens and ``decode_step`` within
  1e-5 in f32, tied and untied output projections, weights carried by
  ``utils/convert.lm_from_jax_params`` (every key); the kernel route's
  decode step (the decode-step kernel's twin on the CPU, through an
  ancestry map) equal to the plain one.
- ``ASRDecoder(lm=...)``: every token of every beam equal to JAX's and the
  scores within 1e-5 on both ``TestLMFusion`` cases (LM weight 0.5 with CTC
  0.3; a dominant LM at beam 1), under the ancestry and the gather cache
  reorders, ``steps_per_iter`` 1 and 4, the decode-step flag on and off,
  and with an ensemble.

Torch runs with TF32 off, JAX at ``highest`` matmul precision
(tests/conftest.py).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict
import torch

import speecht5_tpu.config as JC
from speecht5_tpu.decode.asr import ASRDecoder as JASRDecoder
from speecht5_tpu.models.decoder import TransformerDecoder as JDecoder
from speecht5_tpu.models.lm import TransformerLM as JLM, lm_tiny as jlm_tiny
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.decode.asr import ASRDecoder
from speecht5_tpu_torch.models.decoder import TransformerDecoder
from speecht5_tpu_torch.models.lm import TransformerLM, lm_tiny
from speecht5_tpu_torch.utils.convert import from_jax_params, lm_from_jax_params
from test_torch_beam import DECODE_FLAG, _init_jax, _port

torch.backends.cuda.matmul.allow_tf32 = False


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _trunks(d, heads, ffn):
    kw = dict(d_model=d, ffn_dim=ffn, num_layers=2, num_heads=heads, layer_norm_first=True,
              use_rel_pos_bias=False, dropout=0.0, attention_dropout=0.0)
    return (JC.TransformerConfig(rel_pos=JC.RelPosConfig(enabled=False), **kw),
            PC.TransformerConfig(rel_pos=PC.RelPosConfig(enabled=False), **kw))


GEOMETRIES = {"lm_tiny": (64, 4, 128), "dh80": (160, 2, 320)}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_pre_ln_decoder_matches_jax(geometry):
    """Teacher-forced with padding and cross-attention, then 4 cached steps
    against the encoder output: features within 1e-5."""
    jcfg, pcfg = _trunks(*GEOMETRIES[geometry])
    rng = np.random.default_rng(0)
    B, T, S, D = 2, 6, 9, jcfg.d_model
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    enc = rng.standard_normal((B, S, D)).astype(np.float32)
    enc_valid = np.arange(S)[None, :] < np.array([[9], [5]])
    self_valid = np.arange(T)[None, :] < np.array([[6], [4]])
    jdec = JDecoder(jcfg)
    v = jdec.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(enc),
                  enc_valid=jnp.asarray(enc_valid), self_valid=jnp.asarray(self_valid))
    sd = {k[len("decoder."):]: t for k, t in
          from_jax_params({"decoder/" + k: a for k, a in _flat(v["params"]).items()}).items()}
    dec = TransformerDecoder(pcfg)
    dec.load_state_dict(sd)
    assert "layer_norm.weight" in sd
    want, _ = jdec.apply(v, jnp.asarray(x), jnp.asarray(enc),
                         enc_valid=jnp.asarray(enc_valid), self_valid=jnp.asarray(self_valid))
    with torch.no_grad():
        got = dec(torch.from_numpy(x), torch.from_numpy(enc),
                  enc_valid=torch.from_numpy(enc_valid),
                  self_valid=torch.from_numpy(self_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jcache = jdec.apply(v, jnp.asarray(enc), B, 4, method="init_cache")
    jstep = jax.jit(lambda c, xt: jdec.apply(v, xt, c, enc_valid=jnp.asarray(enc_valid),
                                             method="decode_step"))
    with torch.no_grad():
        cache = dec.init_cache(torch.from_numpy(enc), B, 4)
        for t in range(4):
            want, jcache, _ = jstep(jcache, jnp.asarray(x[:, t : t + 1]))
            got, cache = dec.decode_step(torch.from_numpy(x[:, t : t + 1]), cache,
                                         enc_valid=torch.from_numpy(enc_valid))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                       rtol=1e-5)


def _lm_pair(geometry, share_embed=True, vocab=40, seed=3, use_kernel=False):
    d, heads, ffn = GEOMETRIES[geometry]
    jt, pt = _trunks(d, heads, ffn)
    jcfg = dataclasses.replace(jlm_tiny(), vocab_size=vocab, trunk=jt,
                               share_embed=share_embed)
    pcfg = dataclasses.replace(lm_tiny(), vocab_size=vocab, share_embed=share_embed,
                               trunk=dataclasses.replace(pt, use_pallas_attn=use_kernel))
    jlm = JLM(jcfg)
    v = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    lm = TransformerLM(pcfg)
    missing, unexpected = lm.load_state_dict(lm_from_jax_params(_flat(v["params"])),
                                             strict=True)
    assert not missing and not unexpected
    return jlm, v, lm.eval()


@pytest.mark.parametrize("geometry,share_embed", [("lm_tiny", True), ("dh80", True),
                                                  ("lm_tiny", False)])
def test_lm_forward_and_decode_step_match_jax(geometry, share_embed):
    jlm, v, lm = _lm_pair(geometry, share_embed)
    rng = np.random.default_rng(4)
    toks = rng.integers(4, 40, (3, 7))
    toks[1, 5:] = 1                                    # pad_id
    want = jlm.apply(v, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got = lm(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jcache = jlm.apply(v, 3, 6, method="init_cache")
    jstep = jax.jit(lambda c, tt: jlm.apply(v, tt, c, method="decode_step"))
    with torch.no_grad():
        cache = lm.init_cache(3, 6)
        for t in range(6):
            want, jcache = jstep(jcache, jnp.asarray(toks[:, t : t + 1], jnp.int32))
            got, cache = lm.decode_step(torch.from_numpy(toks[:, t : t + 1]), cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                       rtol=1e-5)
    assert int(cache["index"]) == 6


def test_lm_kernel_route_decode_step_through_ancestry_map_equals_plain():
    """use_pallas_attn on (the cached entry's twin on the CPU) reading an
    ancestry map that sends rows to other physical rows, against the plain
    route on caches gathered into row order: the same logits (the twin
    gathers, then the dense formula)."""
    _, _, lm_k = _lm_pair("dh80", use_kernel=True)
    _, _, lm_p = _lm_pair("dh80")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(4, 40, (4, 5)))
    with torch.no_grad():
        c_k, c_p = lm_k.init_cache(4, 5), lm_p.init_cache(4, 5)
        for t in range(3):   # fill three positions, rows in order
            _, c_k = lm_k.decode_step(toks[:, t : t + 1], c_k)
            _, c_p = lm_p.decode_step(toks[:, t : t + 1], c_p)
        rows = torch.tensor([[2, 2, 2, 3, 4], [0, 0, 0, 1, 4], [3, 1, 1, 2, 4],
                             [1, 1, 0, 3, 4]])
        rows[:, 3:] = torch.arange(4)[:, None]         # the step's own rows
        idx = (rows[:, :3], torch.arange(3))
        for c in c_p["layers"]:                        # the gathered history
            c["k"][:, :3], c["v"][:, :3] = c["k"][idx].clone(), c["v"][idx].clone()
        got, _ = lm_k.decode_step(toks[:, 3:4], c_k, cache_rows=rows)
        want, _ = lm_p.decode_step(toks[:, 3:4], c_p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ LM-fused beam


@pytest.fixture(scope="module")
def fusion():
    """test_beam.py's TestLMFusion setup at the letter vocabulary: the tiny
    model's s2t weights and an ``lm_tiny`` LM (seed 3) over the model's
    vocabulary and pad id."""
    cfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    variables = _init_jax(cfg)
    jlmcfg = dataclasses.replace(jlm_tiny(), vocab_size=cfg.vocab_size, pad_id=cfg.pad_id)
    jlm = JLM(jlmcfg)
    lm_v = jlm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    return cfg, variables, jlm, lm_v


def _port_lm(cfg, lm_v, use_kernel):
    pcfg = dataclasses.replace(lm_tiny(), vocab_size=cfg.vocab_size, pad_id=cfg.pad_id)
    pcfg = dataclasses.replace(pcfg, trunk=dataclasses.replace(
        pcfg.trunk, use_pallas_attn=use_kernel))
    lm = TransformerLM(pcfg)
    lm.load_state_dict(lm_from_jax_params(_flat(lm_v["params"])))
    return lm


CASES = {   # TestLMFusion's two cases
    "fused": dict(seed=0, B=2, kw=dict(beam_size=3, max_len=8, ctc_weight=0.3,
                                       lm_weight=0.5)),
    "dominant": dict(seed=1, B=1, kw=dict(beam_size=1, max_len=6, ctc_weight=0.0,
                                          lm_weight=50.0, min_len=5)),
}


def _wav(seed, B):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((B, 4000)) * 0.1).astype(np.float32)
    return wav, np.array([4000, 2500][:B], np.int32)


@pytest.fixture(scope="module")
def jax_fused(fusion):
    cfg, variables, jlm, lm_v = fusion
    out = {}
    for name, case in CASES.items():
        wav, lens = _wav(case["seed"], case["B"])
        dec = JASRDecoder(JModel(cfg), variables, lm=jlm, lm_variables=lm_v, **case["kw"])
        out[name] = dec(jnp.asarray(wav), jnp.asarray(lens))
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cache_reorder,steps_per_iter,kernel", [
    ("ancestry", 4, False), ("ancestry", 1, True), ("gather", 4, True),
])
def test_lm_fused_beam_matches_jax(fusion, jax_fused, case, cache_reorder,
                                   steps_per_iter, kernel):
    cfg, variables, _, lm_v = fusion
    _, model = _port(variables, DECODE_FLAG if kernel else [])
    dec = ASRDecoder(model, lm=_port_lm(cfg, lm_v, kernel), cache_reorder=cache_reorder,
                     steps_per_iter=steps_per_iter, device="cpu", **CASES[case]["kw"])
    res = dec(*_wav(CASES[case]["seed"], CASES[case]["B"]))
    jres = jax_fused[case]
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores), atol=1e-5,
                               rtol=1e-5)
    if case == "fused":   # the LM changes the decode (TestLMFusion.test_lm_changes_decode)
        base = ASRDecoder(model, device="cpu", **{**CASES[case]["kw"], "lm_weight": 0.0})
        assert not torch.equal(base(*_wav(0, 2)).tokens, res.tokens)


def test_lm_fused_ensemble_matches_jax(fusion):
    cfg, variables, jlm, lm_v = fusion
    other = jax.tree_util.tree_map(lambda a: a * 0.9, variables)
    kw = dict(beam_size=3, max_len=6, ctc_weight=0.3, lm_weight=0.5)
    wav, lens = _wav(6, 2)
    jres = JASRDecoder(JModel(cfg), [variables, other], lm=jlm, lm_variables=lm_v,
                       **kw)(jnp.asarray(wav), jnp.asarray(lens))
    models = [_port(v)[1] for v in (variables, other)]
    res = ASRDecoder(models, lm=_port_lm(cfg, lm_v, False), device="cpu", **kw)(wav, lens)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores), atol=1e-5,
                               rtol=1e-5)


def test_chip_smoke_beam_lm_phases_run_on_cpu_with_twins():
    """Phases 22 and 23 at the tiny preset with ``lm_tiny`` on the CPU: the
    twins run, so no launches; every request runs its decode steps; the
    kernel route's twin and the plain route agree."""
    from speecht5_tpu_torch import config as C

    out = chip_smoke.phase_beam_lm(C.speecht5_tiny(), device="cpu", dtype="float32",
                                   requests_s=(0.3, 0.8), max_len=8, lm_tiny=True)
    assert [r["decode_steps"] for r in out["requests"]] == [8, 8]
    assert set(out["counts"].values()) == {0}
    parity = chip_smoke.phase_beam_lm_parity(C.speecht5_tiny(), device="cpu",
                                             request_s=0.5, max_len=8, lm_tiny=True)
    assert parity["equal_best"] and parity["score_rel_diff"] < 1e-5
    cfg = C.speecht5_tiny()
    want = chip_smoke.beam_lm_launches_expected(cfg, 20, 10)
    assert want["flash_attention_bias"] == (2 * cfg.decoder.num_layers + 20) * 10


def test_fusion_lm_past_its_positions_is_refused_where_jax_clamps(fusion):
    """JAX reads LM positions past ``max_positions`` clamped to the table's
    last row (step 70 of ``lm_tiny``, 64 positions, embeds as step 65); the
    port refuses a beam whose ``max_len`` exceeds the LM's positions, and a
    longer teacher-forced input."""
    from speecht5_tpu.ops.positional import fairseq_sinusoidal_table

    cfg, variables, jlm, lm_v = fusion
    table = fairseq_sinusoidal_table(jlm.cfg.pad_id + 2 + 64, 64, jlm.cfg.pad_id)
    assert np.array_equal(np.asarray(jnp.asarray(table)[jnp.asarray(70)]), table[-1])
    _, model = _port(variables)
    lm = _port_lm(cfg, lm_v, False)
    with pytest.raises(ValueError, match="64 positions"):
        ASRDecoder(model, lm=lm, lm_weight=0.5, max_len=65, device="cpu")
    ASRDecoder(model, lm=lm, lm_weight=0.5, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="64 positions"):
        lm(torch.full((1, 65), 5))
