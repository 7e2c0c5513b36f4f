"""The beam arm's parts held against the JAX package: the CTC prefix
scorer (tests/test_ctc_prefix.py; 1e-5), the beam search with a table step
function (tests/test_beam.py:14-110; equal tokens, lengths and scores, one
and three steps per read of the loop condition), the grouped
cross-attention (tests/test_beam.py:112-142), five cached decode steps
through a shuffled ancestry map and the "gather" cache reorder (f32 2e-4;
bf16 3e-2 x max|ref|), and ``chip_smoke.py``'s serve-beam and beam-parity
phases at ``tiny`` on the CPU.  Kept apart from ``test_torch_beam.py`` (the
decoders and serving) so that the two run on different workers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import speecht5_tpu.config as JC
from speecht5_tpu.decode import ctc_prefix as jctc
from speecht5_tpu.decode.beam_search import beam_search as jbeam_search
from speecht5_tpu.models.attention import MultiheadAttention as JMHA
from speecht5_tpu.models.decoder import reorder_cache as jreorder_cache
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.decode import ctc_prefix
from speecht5_tpu_torch.decode.beam_search import beam_search
from speecht5_tpu_torch.models.attention import MultiheadAttention
from speecht5_tpu_torch.models.decoder import reorder_cache
from speecht5_tpu_torch.utils.convert import from_jax_params
from test_torch_asr_slice import _flat
from test_torch_beam import DECODE_FLAG, _port, tiny  # noqa: F401 (fixture)

torch.backends.cuda.matmul.allow_tf32 = False
V, EOS = 6, 2


# ------------------------------------------------------------------ CTC prefix


def _lprobs(rng, N, T, V_):
    x = rng.standard_normal((N, T, V_))
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _close_state(got, want, atol=1e-5):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("grouped", [False, True])
def test_ctc_prefix_matches_jax(grouped):
    """init_state, two extensions (a repeat of the last token among the
    candidates), eos_score and select, per-row and grouped posteriors, a
    row shorter than T."""
    rng = np.random.default_rng(0)
    B, G, T, V_, blank, eos = 2, 3, 12, 7, 0, 6
    N = B * G
    lp = _lprobs(rng, B, T, V_)
    lengths = np.array([12, 12, 12, 9, 9, 9], np.int32)
    lp_rows = np.repeat(lp, G, axis=0)
    post = lp if grouped else lp_rows
    init = jax.jit(jctc.init_state, static_argnums=(2, 3))
    score = jax.jit(jctc.score_candidates, static_argnums=(4,))
    j = init(jnp.asarray(lp_rows), jnp.asarray(lengths), blank, eos)
    p = ctc_prefix.init_state(torch.from_numpy(lp_rows), torch.from_numpy(lengths),
                              blank, eos)
    _close_state(p, j)
    empty = np.ones(N, bool)
    for cands in (np.array([[1, 2, 3]] * N), np.array([[3, 4, 1]] * N)):
        jpsi, jc = score(j, jnp.asarray(post), jnp.asarray(lengths),
                         jnp.asarray(cands), blank, jnp.asarray(empty))
        ppsi, pc = ctc_prefix.score_candidates(
            p, torch.from_numpy(post), torch.from_numpy(lengths),
            torch.from_numpy(cands), blank, torch.from_numpy(empty))
        np.testing.assert_allclose(ppsi.numpy(), np.asarray(jpsi), atol=1e-5, rtol=1e-5)
        _close_state(pc, jc)
        np.testing.assert_allclose(ctc_prefix.eos_score(p, torch.from_numpy(lengths)).numpy(),
                                   np.asarray(jctc.eos_score(j, jnp.asarray(lengths))),
                                   atol=1e-5, rtol=1e-5)
        pick = np.arange(N) % 3
        j = jctc.select(jc, jnp.arange(N), jnp.asarray(pick))
        p = ctc_prefix.select(pc, torch.arange(N), torch.from_numpy(pick))
        _close_state(p, j)
        empty = np.zeros(N, bool)


def test_logcumsumexp_matches_the_associative_scan():
    x = np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32) * 30
    x[0, :5] = ctc_prefix.NEG
    np.testing.assert_allclose(ctc_prefix._logcumsumexp(torch.from_numpy(x), 1).numpy(),
                               np.asarray(jax.jit(jctc._logcumsumexp, static_argnums=1)(
                                   jnp.asarray(x), 1)),
                               atol=1e-5, rtol=1e-6)


# ------------------------------------------------------------------ beam core


def _table_steps(table):
    """Step functions whose log probs depend on the step only (test_beam.py
    :14) in both packages."""
    jt, pt = jnp.asarray(table), torch.from_numpy(table)
    jfn = lambda toks, step, st: (jnp.broadcast_to(jt[step][None], (toks.shape[0], V)), st)
    pfn = lambda toks, step, st: (pt[step][None].expand(toks.shape[0], V), st)
    return jfn, pfn


def _same_result(res, jres):
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores), atol=1e-6)


def _log_softmax_table(rng, L):
    t = rng.standard_normal((L, V)).astype(np.float32)
    return t - np.log(np.exp(t).sum(-1, keepdims=True))


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, beam_size=3, max_len=4),                           # greedy
    dict(batch_size=1, beam_size=5, max_len=3),                           # exhaustive
    dict(batch_size=1, beam_size=2, max_len=4, min_len=3),                # min_len
    dict(batch_size=2, beam_size=3, max_len=7, no_repeat_ngram_size=2),
    dict(batch_size=2, beam_size=4, max_len=6, length_penalty=0.0),
])
def test_beam_search_with_a_table_matches_jax(kw):
    """The whole [B, K, L+1] token array, lengths and scores of the JAX
    search, with one and with three steps per read of the loop condition;
    ties at -1e9 go to the lower index."""
    L = kw["max_len"]
    table = _log_softmax_table(np.random.default_rng(L + kw["beam_size"]), L)
    if kw.get("min_len"):
        table[:, EOS] = -0.01
    jfn, pfn = _table_steps(table)
    jres = jbeam_search(jfn, {}, vocab_size=V, eos_id=EOS, **kw)
    for steps_per_iter in (1, 3):
        res, runs = beam_search(pfn, {}, vocab_size=V, eos_id=EOS,
                                steps_per_iter=steps_per_iter, **kw)
        _same_result(res, jres)
        assert 1 <= runs <= L


def test_beam_state_follows_its_rows_through_the_reorder():
    """test_state_reorder: per-row state picks the favoured token."""
    fav = np.array([3, 4, 5, 3, 4, 5])

    def jfn(toks, step, st):
        lp = jnp.full((toks.shape[0], V), -8.0)
        lp = lp.at[jnp.arange(toks.shape[0]), st["fav"]].set(-0.5)
        return lp.at[:, EOS].set(-2.0), st

    def pfn(toks, step, st):
        lp = torch.full((toks.shape[0], V), -8.0)
        lp[torch.arange(toks.shape[0]), st["fav"]] = -0.5
        lp[:, EOS] = -2.0
        return lp, st

    kw = dict(batch_size=2, beam_size=3, vocab_size=V, max_len=3, eos_id=EOS)
    jres = jbeam_search(jfn, {"fav": jnp.asarray(fav)}, **kw)
    res, _ = beam_search(pfn, {"fav": torch.from_numpy(fav)}, **kw)
    _same_result(res, jres)


# ---------------------------------------------------- attention and decode step


def test_grouped_cross_attention_matches_tiled_and_jax():
    """test_grouped_matches_tiled: untiled K/V against the tiled computation,
    outputs and per-row weights, and both against JAX."""
    rng = np.random.default_rng(0)
    B, G, Tk, D, H = 2, 3, 7, 16, 4
    x = rng.standard_normal((B * G, 1, D)).astype(np.float32)
    enc = rng.standard_normal((B, Tk, D)).astype(np.float32)
    valid = np.array([[True] * 7, [True] * 4 + [False] * 3])
    jmod = JMHA(D, H)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    kv = jmod.apply(variables, jnp.asarray(enc), method="precompute_kv")
    jout, jw, _ = jmod.apply(variables, jnp.asarray(x), cross_kv=kv,
                             key_valid=jnp.asarray(valid), return_weights=True)
    mod = MultiheadAttention(D, H)
    mod.load_state_dict({k[len("encoder."):]: v for k, v in from_jax_params(
        {f"encoder/{k}": v for k, v in _flat(variables).items()}).items()})
    with torch.no_grad():
        kv_p = mod.precompute_kv(torch.from_numpy(enc))
        out, w = mod(torch.from_numpy(x), torch.from_numpy(valid), cross_kv=kv_p,
                     return_weights=True)
        tiled = {k: t.repeat_interleave(G, 0) for k, t in kv_p.items()}
        out_t, w_t = mod(torch.from_numpy(x), torch.from_numpy(valid).repeat_interleave(G, 0),
                         cross_kv=tiled, return_weights=True)
    np.testing.assert_allclose(out.numpy(), out_t.numpy(), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), w_t.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


def _decode_inputs(cfg, rng, B=2, G=3, Tsrc=11, steps=5):
    N = B * G
    enc = {"encoder_out": (rng.standard_normal((B, Tsrc, cfg.d_model)) * 0.5).astype(np.float32),
           "valid_mask": np.arange(Tsrc)[None, :] < np.array([[Tsrc], [7]])}
    toks = rng.integers(4, cfg.vocab_size - 1, (N, steps)).astype(np.int32)
    rows = [rng.integers(0, N, (N, steps + 1)).astype(np.int32) for _ in range(steps)]
    return enc, toks, rows


@pytest.mark.parametrize("dtype,flags", [("float32", []), ("float32", DECODE_FLAG),
                                         ("bfloat16", DECODE_FLAG)])
def test_text_decode_steps_match_jax(tiny, dtype, flags):
    """Five cached steps with a new shuffled ancestry map each step and
    grouped cross-attention (6 rows against 2 samples' K/V): logits per
    step, f32 2e-4 (the decode-step kernel's twin on the flag's route), bf16
    3e-2 x max|ref| (ROADMAP C.2's model-level bf16 case)."""
    cfg, variables = tiny
    jcfg = JC.replace(cfg, dtype=dtype)
    _, model = _port(variables, flags, dtype=dtype)
    enc, toks, rows = _decode_inputs(cfg, np.random.default_rng(7))
    N, steps = toks.shape
    jm = JModel(jcfg)
    jenc = {k: jnp.asarray(v) for k, v in enc.items()}
    jcache = jm.apply(variables, jenc, N, steps + 1, method="init_text_cache")
    jstep = jax.jit(lambda tok, cache, valid, rows: jm.apply(
        variables, tok, cache, enc_valid=valid, cache_rows=rows,
        method="text_decode_step"))
    with torch.no_grad():
        cache = model.init_text_cache({k: torch.from_numpy(v) for k, v in enc.items()},
                                      N, steps + 1)
        for t in range(steps):
            jl, jcache = jstep(jnp.asarray(toks[:, t : t + 1]), jcache,
                               jenc["valid_mask"], jnp.asarray(rows[t]))
            pl, cache = model.text_decode_step(
                torch.from_numpy(toks[:, t : t + 1]).long(), cache,
                enc_valid=torch.from_numpy(enc["valid_mask"]),
                cache_rows=torch.from_numpy(rows[t]))
            want = np.asarray(jl, np.float32)
            err = np.abs(pl.float().numpy() - want).max()
            assert err <= (2e-4 if dtype == "float32" else 3e-2 * np.abs(want).max()), (t, err)
            assert int(cache["index"]) == t + 1
    # the "gather" reorder of every cache tensor (an order valid for the
    # 2-row cross K/V as well)
    order = np.array([1, 0, 1, 0, 0, 1])
    cache = reorder_cache(cache, torch.from_numpy(order))
    jcache = jreorder_cache(jcache, jnp.asarray(order))
    for part in ("layers", "cross"):
        for layer, jlayer in zip(cache[part], jcache[part]):
            for key in ("k", "v"):
                got = layer[key].float().numpy()
                want = np.asarray(jlayer[key], np.float32)
                assert np.abs(got - want).max() <= (2e-4 if dtype == "float32"
                                                     else 3e-2 * np.abs(want).max())



def test_chip_smoke_beam_phases_run_on_cpu_with_twins():
    """The serve-beam phase (per request: chunks, decode steps, no launch on
    the CPU) and the beam parity phase at the tiny preset, one 2 s bucket."""
    base = PC.speecht5_tiny()
    served = chip_smoke.phase_serve_beam(base, device="cpu", dtype="float32",
                                         requests_s=(0.3, 2.1), buckets="2",
                                         max_len=6)
    assert [r["chunks"] for r in served["requests"]] == [1, 2]
    assert all(0 < r["decode_steps"] <= 6 * r["chunks"] for r in served["requests"])
    assert set(served["counts"].values()) == {0}
    want = chip_smoke.beam_launches_expected(PC.speecht5_base_asr(), chunks=2, steps=7)
    assert (want["banded_flash_attention"], want["conv_stack"],
            want["flash_attention_bias"]) == (24, 12, 84)
    # bf16 (the served dtype): the attention's bias pass and main loop
    want = chip_smoke.beam_launches_expected(PC.speecht5_base_asr(dtype="bfloat16"),
                                             chunks=2, steps=7)
    assert want["banded_flash_attention"] == 48
    parity = chip_smoke.phase_beam_parity(base, device="cpu", requests_s=(0.3,),
                                          buckets="2", max_len=6)
    assert parity["equal_best"] == parity["chunks"] == 1
