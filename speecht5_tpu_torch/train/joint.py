"""Joint speech + text pretraining losses of SpeechLM and SpeechUT.

Port of ``speecht5_tpu/train/joint.py`` :1-229 (reference SpeechUT/
speechut/criterions/speechut_criterion.py:166-265 and SpeechLM/speechlm/
criterions/speechlm_criterion.py:66-200): one update consumes a
heterogeneous sample ``{speech, text_*}`` (``data/multicorpus.py``) and
runs one forward per modality; the speech branch's masked-frame count is
the base sample size, and every text term is rescaled by ``sample_size /
text_sample_size`` (denominators clamped to 1), so one backward covers all
modalities.  Metric names are JAX's.

The losses are plain functions of the model (in train mode for training
passes), the batch and a CPU ``torch.Generator`` for the draws, or the
draws handed in (``draws``: ``{"speech": {"masks", "mix_sel"}, "text" |
"text_mono": {"masks"}}``, each entry optional).  The YiTrans loss
(JAX :232-289) waits for its family.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.ctc import ctc_loss
from . import criterions


@dataclass(frozen=True)
class JointLossConfig:
    """Weights mirror the reference flags (speechut_criterion.py:46-50)."""

    u2t_ed_weight: float = 0.1
    u2t_ctc_weight: float = 0.0
    text_mum_weight: float = 0.5
    label_smoothing: float = 0.1
    pred_masked_weight: float = 1.0
    pred_nomask_weight: float = 0.0
    zero_infinity: bool = False


def _draw(draws, branch: str) -> dict:
    return (draws or {}).get(branch) or {}


def _hubert(jcfg, logits, targets, time_mask, valid):
    return criterions.hubert_loss(logits, targets, time_mask, valid,
                                  pred_masked_weight=jcfg.pred_masked_weight,
                                  pred_nomask_weight=jcfg.pred_nomask_weight)


def _masked_count(time_mask, valid):
    return (time_mask & valid).sum()


def speechlm_joint_loss(model, batch, jcfg: JointLossConfig, *, generator=None,
                        draws=None):
    """SpeechLM's joint step (JAX :39-126): the speech branch's dual HuBERT
    losses (level 0 before the mix, level 1 after the unit encoder) and the
    l2 tie; the text branch's masked-unit loss and, with ``char_targets``,
    the character CTC (blank 0).  batch = {"speech": {wav, wav_lengths,
    units}, "text": {units[, char_targets]} or None} -> (loss, metrics)."""
    mcfg = model.cfg
    metrics = {}
    sp = batch["speech"]
    d = _draw(draws, "speech")
    out = model.forward_speech(sp["wav"], sp["wav_lengths"], sp["units"], mask=True,
                               generator=generator, masks=d.get("masks"),
                               mix_sel=d.get("mix_sel"))
    loss, m = _hubert(jcfg, [out["logits_0"], out["logits_1"]], [sp["units"], sp["units"]],
                      out["time_mask"], out["valid_mask"])
    metrics.update({f"speech_{k}": v for k, v in m.items()})
    loss = loss + out["l2_loss"]
    metrics["l2_loss"] = out["l2_loss"]
    sample_size = _masked_count(out["time_mask"], out["valid_mask"])

    tx = batch.get("text")
    if tx is not None:
        t_out = model.forward_text(tx["units"], mask=True, generator=generator,
                                   masks=_draw(draws, "text").get("masks"))
        if jcfg.text_mum_weight > 0 and "mum_logits" in t_out:
            mum_loss, mm = _hubert(jcfg, [t_out["mum_logits"]], [tx["units"]],
                                   t_out["time_mask"], t_out["valid_mask"])
            msize = _masked_count(t_out["time_mask"], t_out["valid_mask"]).clamp_min(1)
            loss = loss + jcfg.text_mum_weight * mum_loss * (sample_size / msize)
            metrics.update({f"mum_{k}": v for k, v in mm.items()})
        if jcfg.u2t_ctc_weight > 0 and "ctc_logits" in t_out and "char_targets" in tx:
            lp = torch.log_softmax(t_out["ctc_logits"].float(), dim=-1)
            ct = tx["char_targets"]
            ct_lengths = (ct != mcfg.pad_id).sum(-1)
            nll = ctc_loss(lp, t_out["valid_mask"].sum(-1), ct, ct_lengths, 0,
                           zero_infinity=jcfg.zero_infinity)
            tsize = ct_lengths.sum().clamp_min(1)
            ctc = nll.sum() / tsize
            loss = loss + jcfg.u2t_ctc_weight * ctc * (sample_size / tsize)
            metrics["char_ctc_loss"] = ctc

    metrics["loss"] = loss
    metrics["sample_size"] = sample_size
    return loss, metrics


def speechut_joint_loss(model, batch, jcfg: JointLossConfig, *, generator=None,
                        draws=None):
    """SpeechUT's joint step (JAX :129-229): the speech branch's HuBERT
    loss, paired units -> text (decoder CE and CTC over the unit encoder),
    mono-unit masked unit modeling.  batch = {"speech": {wav, wav_lengths,
    units}, "text_paired": {units, prev_tokens, targets} or None,
    "text_mono": {units} or None} -> (loss, metrics)."""
    mcfg = model.cfg
    metrics = {}
    sp = batch["speech"]
    d = _draw(draws, "speech")
    out = model.forward_speech(sp["wav"], sp["wav_lengths"], sp["units"], mask=True,
                               generator=generator, masks=d.get("masks"),
                               mix_sel=d.get("mix_sel"))
    loss, m = _hubert(jcfg, [out["hubert_logits"]], [sp["units"]], out["time_mask"],
                      out["valid_mask"])
    metrics.update({f"speech_{k}": v for k, v in m.items()})
    sample_size = _masked_count(out["time_mask"], out["valid_mask"])

    tp = batch.get("text_paired")
    if tp is not None and (jcfg.u2t_ed_weight + jcfg.u2t_ctc_weight) > 0:
        t_out = model.forward_unit_text(tp["units"], tp["prev_tokens"], generator=generator)
        targets = tp["targets"]
        tgt_valid = targets != mcfg.pad_id
        text_sample_size = tgt_valid.sum().clamp_min(1)
        scale = sample_size / text_sample_size
        if jcfg.u2t_ed_weight > 0:
            ce, _ = criterions.label_smoothed_ce(t_out["dec_logits"].float(), targets,
                                                 tgt_valid, jcfg.label_smoothing)
            loss = loss + jcfg.u2t_ed_weight * ce * scale
            metrics["text_dec_loss"] = ce
            metrics["text_dec_acc"] = (((t_out["dec_logits"].argmax(-1) == targets)
                                        & tgt_valid).sum() / text_sample_size)
        if jcfg.u2t_ctc_weight > 0 and "ctc_logits" in t_out:
            lp = torch.log_softmax(t_out["ctc_logits"].float(), dim=-1)
            tgt_lengths = (tgt_valid & (targets != mcfg.eos_id)).sum(-1)
            nll = ctc_loss(lp, t_out["valid_mask"].sum(-1), targets, tgt_lengths,
                           mcfg.blank_id, zero_infinity=jcfg.zero_infinity)
            ctc = nll.sum() / text_sample_size
            loss = loss + jcfg.u2t_ctc_weight * ctc * scale
            metrics["text_ctc_loss"] = ctc

    tm = batch.get("text_mono")
    if tm is not None and jcfg.text_mum_weight > 0:
        m_out = model.forward_mum(tm["units"], generator=generator,
                                  masks=_draw(draws, "text_mono").get("masks"))
        mum_loss, mm = _hubert(jcfg, [m_out["mum_logits"]], [tm["units"]],
                               m_out["time_mask"], m_out["valid_mask"])
        mum_size = _masked_count(m_out["time_mask"], m_out["valid_mask"]).clamp_min(1)
        loss = loss + jcfg.text_mum_weight * mum_loss * (sample_size / mum_size)
        metrics.update({f"mum_{k}": v for k, v in mm.items()})

    metrics["loss"] = loss
    metrics["sample_size"] = sample_size
    return loss, metrics
