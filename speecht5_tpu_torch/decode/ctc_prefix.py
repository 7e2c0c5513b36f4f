"""Vectorized CTC prefix scoring on the device.

Port of ``speecht5_tpu/decode/ctc_prefix.py`` (:1-173).  The reference's
joint CTC/attention decoding scores prefixes with espnet's
``CTCPrefixScore`` on the CPU, one hypothesis at a time (reference
sequence_generator.py:273-284, 370-418).  Here, as in the JAX package, the
prefix recursion is reformulated so that it runs for every row and
candidate at once: for an extension c of prefix g the non-blank forward
variable

    r_nb[t] = (r_nb[t-1] + phi[t-1]) * x_c[t]

is a first-order linear recurrence with a known input, i.e. a cumulative
log-sum-exp:

    log r_nb[t] = cx[t] + logcumsumexp_{tau<=t}(log phi[tau-1] - cx[tau-1]),
    cx[t] = cumsum_{s<=t} log x_c[s],

and the prefix score is the reduction psi = logsumexp_t(phi[t-1] + x_c[t]).
Everything is f32 with ``NEG = -1e30`` for log 0.  ``torch.logcumsumexp``
sums in another order than JAX's associative scan, so scores agree to f32
rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e30


def _logcumsumexp(x, dim: int):
    """Numerically stable cumulative log-sum-exp along ``dim``."""
    return torch.logcumsumexp(x, dim=dim)


class CTCPrefixState(NamedTuple):
    """Per-row (batch * beam) prefix state."""

    r_b: torch.Tensor    # [N, T] log prob of the prefix ending in blank at t
    r_nb: torch.Tensor   # [N, T] log prob of the prefix ending in non-blank
    psi: torch.Tensor    # [N] prefix score so far
    last: torch.Tensor   # [N] last emitted token (eos for the empty prefix)


def init_state(ctc_lprobs, lengths, blank_id: int, eos_id: int) -> CTCPrefixState:
    """ctc_lprobs: [N, T, V] f32 log-softmax over encoder frames; lengths:
    [N] valid frames."""
    N, T, _ = ctc_lprobs.shape
    dev = ctc_lprobs.device
    in_range = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    # pad frames emit blank with probability 1 (log 0): transparent
    blank_lp = torch.where(in_range, ctc_lprobs[:, :, blank_id], 0.0)
    return CTCPrefixState(
        r_b=torch.cumsum(blank_lp, dim=1),
        r_nb=torch.full((N, T), NEG, device=dev),
        psi=torch.zeros(N, device=dev),
        last=torch.full((N,), eos_id, dtype=torch.int64, device=dev),
    )


def score_candidates(state: CTCPrefixState, ctc_lprobs, lengths, cand_ids,
                     blank_id: int, is_empty):
    """Score extending each row's prefix with each of its candidates.

    ``ctc_lprobs`` is [N, T, V] (per row) or untiled [B, T, V] with N = B *
    beam: the beams of a sample share its posteriors, read once per sample.
    lengths: [N]; cand_ids: [N, K]; is_empty: bool [N] (the prefix is
    empty).  Returns (psi [N, K] new prefix scores, the candidates' state
    with r_b / r_nb [N, K, T])."""
    N, K = cand_ids.shape
    NB, T, _ = ctc_lprobs.shape
    dev = ctc_lprobs.device
    in_range = (torch.arange(T, device=dev)[None, None, :]
                < lengths[:, None, None])                           # [N, 1, T]

    # x_c[t]: the candidates' emission log probs
    if NB == N:
        xc = torch.gather(ctc_lprobs, 2, cand_ids[:, None, :].expand(N, T, K))
        xc = xc.transpose(1, 2)                                     # [N, K, T]
        blank_col = ctc_lprobs[:, :, blank_id]                      # [N, T]
    else:
        G = N // NB
        ids = cand_ids.reshape(NB, G * K)
        xc = torch.gather(ctc_lprobs, 2, ids[:, None, :].expand(NB, T, G * K))
        xc = xc.transpose(1, 2).reshape(N, K, T)
        blank_col = ctc_lprobs[:, :, blank_id].repeat_interleave(G, dim=0)
    xc = torch.where(in_range, xc, NEG)
    blank_lp = torch.where(in_range[:, 0, :], blank_col, 0.0)       # [N, T]

    # phi[t] from the PREFIX state: r_b + r_nb unless c repeats the last token
    same = cand_ids == state.last[:, None]                          # [N, K]
    r_sum = torch.logaddexp(state.r_b, state.r_nb)                  # [N, T]
    phi = torch.where(same[:, :, None], state.r_b[:, None, :], r_sum[:, None, :])

    # phi_shift[t] = phi[t-1]; at t = 0: log 1 for the empty prefix, else log 0
    first = torch.where(is_empty, 0.0, NEG)                         # [N]
    phi_shift = torch.cat([first[:, None, None].expand(N, K, 1), phi[:, :, :-1]],
                          dim=2)

    # log r_nb[t] = CX[t] + logcumsumexp(phi_shift - CX[tau-1]),
    # CX[tau-1] = CX[tau] - xc[tau]
    cx = torch.cumsum(torch.where(in_range, xc, 0.0), dim=2)        # [N, K, T]
    z = torch.where(in_range, phi_shift - cx + xc, NEG)
    r_nb = cx + _logcumsumexp(torch.clamp_min(z, NEG), dim=2)
    r_nb = torch.where(in_range, torch.clamp_min(r_nb, NEG), NEG)

    # log r_b[t] = CB[t] + logcumsumexp(r_nb[tau-1] - CB[tau-1])
    cb = torch.cumsum(blank_lp, dim=1)[:, None, :]                  # [N, 1, T]
    cb_prev = torch.cat([torch.zeros(N, 1, 1, device=dev), cb[:, :, :-1]], dim=2)
    r_nb_prev = torch.cat([torch.full((N, K, 1), NEG, device=dev), r_nb[:, :, :-1]],
                          dim=2)
    u = torch.clamp_min(r_nb_prev - cb_prev, NEG)
    r_b = torch.clamp_min(cb + _logcumsumexp(u, dim=2), NEG)

    # psi = logsumexp_t(phi_shift[t] + xc[t]) over the in-range frames
    psi = torch.logsumexp(torch.where(in_range, phi_shift + xc, NEG), dim=2)
    psi = torch.clamp_min(psi, NEG)
    return psi, CTCPrefixState(r_b=r_b, r_nb=r_nb, psi=psi, last=cand_ids)


def eos_score(state: CTCPrefixState, lengths):
    """Score of ending the prefix: log p_ctc(prefix) over the valid frames
    (espnet: r_sum at the last frame)."""
    T = state.r_b.shape[1]
    idx = torch.clamp(lengths - 1, 0, T - 1).long()
    r_sum = torch.logaddexp(state.r_b, state.r_nb)
    return torch.gather(r_sum, 1, idx[:, None])[:, 0]


def select(cand_state: CTCPrefixState, row_idx, cand_idx) -> CTCPrefixState:
    """The chosen candidates' states after the beam's selection; row_idx,
    cand_idx: [N'] indices into the N rows and K candidates."""
    return CTCPrefixState(*(t[row_idx, cand_idx] for t in cand_state))
