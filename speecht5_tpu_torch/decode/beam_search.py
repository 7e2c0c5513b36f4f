"""Batched beam search, the loop on the host over device tensors.

Port of ``speecht5_tpu/decode/beam_search.py`` (:1-300), which replaces the
reference's fairseq SequenceGenerator (reference sequence_generator.py:
26-818) for any batch size.  Scoring follows fairseq: cumulative log-prob
beams, candidates expanded to 2 * beam, EOS candidates finalized with their
score normalized by (step + 1) ** length_penalty, min/max length, n-gram
blocking.

The model is a pair of functions over an opaque state (dicts, tuples and
tensors whose leading dim is N = batch * beam):
  step_fn(tokens_t [N, 1], step, state) -> (lprobs [N, V] f32, state)
  select_fn(state, tok [N])             -> state   (after the reorder)

The JAX package runs the whole search as one ``lax.while_loop``.  Here the
host runs the loop: each iteration evaluates JAX's loop condition on the
card, reads that one boolean, and then runs ``steps_per_iter`` steps, each
guarded by the same condition computed on the card (a step whose guard is
false leaves the state as it was), so the tokens do not depend on
``steps_per_iter`` (the JAX contract, beam_search.py:116-120) and the host
syncs once per iteration.  Selections sort stably, so ties go to the lower
index as ``jax.lax.top_k`` and ``jnp.argsort`` have them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

NEG_INF = -1e9


class BeamState(NamedTuple):
    step: torch.Tensor           # 0-d int64: steps taken
    alive_tokens: torch.Tensor   # [B, K, L+1]
    alive_lprob: torch.Tensor    # [B, K] cumulative log prob
    model_state: object          # leading dim N = B*K
    fin_tokens: torch.Tensor     # [B, K, L+1]
    fin_scores: torch.Tensor     # [B, K] length-normalized
    fin_lens: torch.Tensor       # [B, K] hypothesis length (tokens incl. eos)


class BeamResult(NamedTuple):
    tokens: torch.Tensor         # [B, K, L+1] (position 0 = bos)
    scores: torch.Tensor         # [B, K] normalized, sorted descending
    lengths: torch.Tensor        # [B, K]


def _tree_map(fn, *trees):
    """Apply ``fn`` to the matching tensor leaves of dicts, lists and
    (named) tuples; other leaves come from the first tree."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    if torch.is_tensor(t):
        return fn(*trees)
    return t


def _gather_rows(state, rows):
    return _tree_map(lambda x: x[rows] if x.dim() >= 1 else x, state)


def _where(keep_new, new, old):
    """The state after a guarded step: ``new`` where the 0-d bool
    ``keep_new`` holds, else ``old`` (buffers written in place are the same
    tensor in both and are left alone)."""
    return _tree_map(lambda a, b: a if a is b else torch.where(keep_new, a, b),
                     new, old)


def _top(x, k: int):
    """Top ``k`` along dim 1, ties to the lower index (jax.lax.top_k)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def ngram_repeat_mask(tokens, step: int, n: int, vocab_size: int):
    """Tokens banned at ``step + 1`` because they would repeat an n-gram
    (fairseq ``ngram_repeat_block``, reference sequence_generator.py:23,
    111-114): v is banned iff the (n-1)-gram ending at ``step`` occurred
    earlier, its window fully generated, followed by v.  tokens: [N, L+1]
    (position 0 = bos) -> bool [N, V]."""
    N, L1 = tokens.shape
    dev = tokens.device
    ctx_idx = step + torch.arange(-(n - 2), 1, device=dev)
    ctx = tokens[:, ctx_idx.clamp(0, L1 - 1)]                        # [N, n-1]
    p = torch.arange(L1, device=dev)
    win_idx = p[:, None] + torch.arange(n - 1, device=dev)[None, :]
    win = tokens[:, win_idx.clamp(0, L1 - 1)]                        # [N, L1, n-1]
    nxt = tokens[:, (p + n - 1).clamp(0, L1 - 1)]                    # [N, L1]
    match = (win == ctx[:, None, :]).all(dim=-1)
    match = match & (p + n - 1 <= step)[None, :] & (step >= n - 2)
    hits = torch.zeros(N, vocab_size, dtype=torch.int32, device=dev)
    return hits.scatter_add_(1, nxt.long(), match.int()) > 0


def beam_search(step_fn: Callable, init_model_state, *, batch_size: int,
                beam_size: int, vocab_size: int, max_len: int, eos_id: int,
                bos_id: Optional[int] = None, length_penalty: float = 1.0,
                min_len: int = 1, select_fn: Optional[Callable] = None,
                no_repeat_ngram_size: int = 0, gather_exempt_keys: tuple = (),
                ancestry_key: Optional[str] = None, steps_per_iter: int = 1,
                device=None):
    """Run the search; returns (BeamResult, steps run).  ``steps run``
    counts the step functions called, guarded-out ones included.

    ``gather_exempt_keys``: top-level keys of a dict ``init_model_state``
    whose leaves are not gathered on the beam reorder (caches whose rows
    stay physical).  ``ancestry_key``: when set, the search inserts and
    keeps ``model_state[ancestry_key]``, an int64 [N, L+1] map whose entry
    (row, pos) names the physical row holding logical row ``row``'s cached
    position ``pos`` (JAX beam_search.py:103-114).  ``steps_per_iter``:
    guarded steps per read of the loop condition (see the module
    docstring)."""
    B, K, V = batch_size, beam_size, vocab_size
    N, L = B * K, max_len
    bos = eos_id if bos_id is None else bos_id
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)

    row_ids = torch.arange(N, **i64)
    is_eos_col = torch.arange(V, device=device) == eos_id
    if ancestry_key is not None:
        init_model_state = dict(init_model_state, **{
            ancestry_key: row_ids[:, None].expand(N, L + 1).contiguous()})
        gather_exempt_keys = tuple(gather_exempt_keys) + (ancestry_key,)
    first = torch.full((K,), NEG_INF, **f32)
    first[0] = 0.0
    s = BeamState(
        step=torch.zeros((), **i64),
        alive_tokens=torch.full((B, K, L + 1), bos, **i64),
        alive_lprob=first[None, :].repeat(B, 1),
        model_state=init_model_state,
        fin_tokens=torch.full((B, K, L + 1), eos_id, **i64),
        fin_scores=torch.full((B, K), NEG_INF, **f32),
        fin_lens=torch.zeros((B, K), **i64),
    )

    def cond(s: BeamState):
        # an upper bound on any alive beam's final normalized score: the
        # cumulative log probs only fall, so the best case is a free
        # continuation, whose normalized score is largest at the largest
        # denominator for lp > 0 (finishing at max length) and at the next
        # step for lp <= 0
        if length_penalty > 0.0:
            denom = float(L) ** length_penalty
        else:
            denom = torch.clamp_min(s.step + 1, 1).float() ** length_penalty
        best_alive = s.alive_lprob.max(dim=1).values / denom
        worst_fin = s.fin_scores.min(dim=1).values
        return (s.step < L) & (best_alive > worst_fin).any()

    def body(s: BeamState, step: int) -> BeamState:
        toks_t = s.alive_tokens.reshape(N, L + 1)[:, step : step + 1]
        lprobs, model_state = step_fn(toks_t, step, s.model_state)
        lprobs = lprobs.float()

        # EOS is banned until min_len real tokens were emitted (an EOS
        # chosen at ``step`` closes a hypothesis of ``step`` real tokens,
        # fairseq's `step < min_len` gate)
        if step < min_len:
            lprobs = lprobs.masked_fill(is_eos_col, NEG_INF)
        if no_repeat_ngram_size > 0:
            banned = ngram_repeat_mask(s.alive_tokens.reshape(N, L + 1), step,
                                       no_repeat_ngram_size, V)
            lprobs = lprobs.masked_fill(banned, NEG_INF)
        if step >= L - 1:   # at the last step only EOS may be chosen
            only = torch.where(is_eos_col, 0.0, NEG_INF)
            lprobs = only[None, :] + lprobs[:, eos_id : eos_id + 1]

        total = (s.alive_lprob.reshape(N, 1) + lprobs).reshape(B, K * V)
        cand_scores, cand_idx = _top(total, 2 * K)                   # [B, 2K]
        parent_k = cand_idx // V
        cand_tok = cand_idx % V
        is_eos = cand_tok == eos_id

        # ---- finished update
        norm = cand_scores / ((step + 1.0) ** length_penalty)
        eos_scores = torch.where(is_eos, norm, NEG_INF)
        base = torch.arange(B, **i64)[:, None] * K
        cand_fin_tokens = s.alive_tokens.reshape(N, L + 1)[(base + parent_k).reshape(-1)]
        cand_fin_tokens = cand_fin_tokens.reshape(B, 2 * K, L + 1)
        cand_fin_tokens[:, :, step + 1] = eos_id
        cand_fin_lens = torch.full((B, 2 * K), step + 2, **i64)
        top_fin, fin_idx = _top(torch.cat([s.fin_scores, eos_scores], dim=1), K)
        fin_tokens = torch.gather(torch.cat([s.fin_tokens, cand_fin_tokens], dim=1), 1,
                                  fin_idx[:, :, None].expand(B, K, L + 1))
        fin_lens = torch.gather(torch.cat([s.fin_lens, cand_fin_lens], dim=1), 1, fin_idx)

        # ---- alive update: the top K among the non-EOS candidates
        new_alive_lprob, alive_idx = _top(torch.where(is_eos, NEG_INF, cand_scores), K)
        new_parent_k = torch.gather(parent_k, 1, alive_idx)
        new_tok = torch.gather(cand_tok, 1, alive_idx)
        parent_rows = (base + new_parent_k).reshape(-1)
        new_tokens = s.alive_tokens.reshape(N, L + 1)[parent_rows]
        new_tokens[:, step + 1] = new_tok.reshape(N)

        if gather_exempt_keys:
            exempt = {k: model_state[k] for k in gather_exempt_keys
                      if k in model_state}
            rest = {k: v for k, v in model_state.items() if k not in exempt}
            model_state = {**_gather_rows(rest, parent_rows), **exempt}
            if ancestry_key is not None:
                # logical row r' inherits its parent's history map; the
                # positions after ``step`` belong to the physical row itself
                # (its next write), and position ``step`` keeps anc[p, step]
                anc = model_state[ancestry_key][parent_rows]
                cols = torch.arange(L + 1, **i64)[None, :]
                model_state[ancestry_key] = torch.where(cols > step, row_ids[:, None], anc)
        else:
            model_state = _gather_rows(model_state, parent_rows)
        if select_fn is not None:
            model_state = select_fn(model_state, new_tok.reshape(N))
        return BeamState(step=s.step + 1,
                         alive_tokens=new_tokens.reshape(B, K, L + 1),
                         alive_lprob=new_alive_lprob, model_state=model_state,
                         fin_tokens=fin_tokens, fin_scores=top_fin,
                         fin_lens=fin_lens)

    step = runs = 0
    while step < L and bool(cond(s)):        # one host read per iteration
        for j in range(min(steps_per_iter, L - step)):
            if j == 0:
                s = body(s, step)
            else:
                # once a guard is false the state stops changing, so every
                # later guard is false too and the host's step count, which
                # indexes only the discarded steps, need not stop
                s = _where(cond(s), body(s, step), s)
            step += 1
            runs += 1

    # nothing finished (degenerate): fall back to the alive beams
    denom = torch.clamp_min(s.step, 1).float() ** length_penalty
    none_fin = s.fin_scores <= NEG_INF / 2
    scores = torch.where(none_fin, s.alive_lprob / denom, s.fin_scores)
    tokens = torch.where(none_fin[:, :, None], s.alive_tokens, s.fin_tokens)
    lens = torch.where(none_fin, torch.clamp_max(s.step + 1, L + 1), s.fin_lens)
    _, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return BeamResult(
        tokens=torch.gather(tokens, 1, order[:, :, None].expand_as(tokens)),
        scores=torch.gather(scores, 1, order),
        lengths=torch.gather(lens, 1, order),
    ), runs
