"""Joint speech + text pretraining losses of SpeechLM, SpeechUT, YiTrans
and VATLM.

Port of ``speecht5_tpu/train/joint.py`` (reference SpeechUT/
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
"text_mono": {"masks"}}``, each entry optional).  ``yitrans_pretrain_loss``
is JAX ``make_yitrans_pretrain_loss`` (:232-289); ``vatlm_pretrain_loss``
is the loss of JAX ``recipes/vatlm_pretrain.py`` (:70-104), which the JAX
package keeps in the recipe.
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


def yitrans_pretrain_loss(model, batch, jcfg: JointLossConfig, *, text_weight: float = 1.0,
                          generator=None, draws=None):
    """YiTrans stage 1 (JAX :232-289; reference YiTrans/yitrans_iwslt22/
    models/pretrain_ed.py:200): masked speech prediction over km units
    plus multilingual BART denoising CE, scaled by sample_size / tsize.
    batch = {"speech": {wav, wav_lengths, units}, "text_mono": {src_tokens,
    prev_tokens, targets} or None} -> (loss, metrics)."""
    mcfg = model.cfg
    metrics = {}
    sp = batch["speech"]
    enc = model.encode_speech(sp["wav"], sp["wav_lengths"], mask=True, generator=generator,
                              masks=_draw(draws, "speech").get("masks"))
    loss, m = _hubert(jcfg, [model.hubert_logits(enc)], [sp["units"]], enc["time_mask"],
                      enc["valid_mask"])
    metrics.update({f"speech_{k}": v for k, v in m.items()})
    sample_size = _masked_count(enc["time_mask"], enc["valid_mask"])

    tm = batch.get("text_mono")
    if tm is not None and text_weight > 0:
        logits = model.forward_mt(tm["src_tokens"], tm["prev_tokens"], generator=generator)
        tgt_valid = tm["targets"] != mcfg.pad_id
        tsize = tgt_valid.sum().clamp_min(1)
        ce, _ = criterions.label_smoothed_ce(logits.float(), tm["targets"], tgt_valid,
                                             jcfg.label_smoothing)
        loss = loss + text_weight * ce * (sample_size / tsize)
        metrics["denoise_loss"] = ce
        metrics["denoise_acc"] = ((logits.argmax(-1) == tm["targets"]) & tgt_valid).sum() / tsize
    metrics["loss"] = loss
    metrics["sample_size"] = sample_size
    return loss, metrics


#: the modality streams of one VATLM update (JAX recipes/vatlm_pretrain.py
#: :81-85): audio+video, audio alone, phones alone
VATLM_STREAMS = (("av", dict(audio=True, video=True, phone=False)),
                 ("audio_only", dict(audio=True, video=False, phone=False)),
                 ("phone", dict(audio=False, video=False, phone=True)))


def vatlm_pretrain_loss(model, batch, *, generator=None, draws=None):
    """One VATLM update (JAX recipes/vatlm_pretrain.py:87-104; reference
    vathubert_criterion.py:45): ``hubert_loss`` over the first label set
    on each stream of ``VATLM_STREAMS``, summed.  The video BatchNorm's
    running statistics, updated in place in training mode, carry from one
    stream to the next.  batch = {audio [B, T, F], video [B, T, H, W, 1],
    lengths, phones [B, T'], targets [B, T]}; ``draws``: {stream: {"masks",
    "modality_drop"}}, each entry optional (the JAX recipe draws a stream's
    masks from ``fold_in(rng, hash(name) % 997)``, which Python's salted
    string hash makes differ from process to process) -> (loss, metrics:
    each stream's loss by name).  Labels past a clip's length
    (``VATLMDataset.collate`` pads them with -1) lie outside the valid mask
    and count nowhere; they are clamped to 0 so that the gather stays in
    range."""
    targets = batch["targets"].clamp_min(0)
    total = 0.0
    metrics = {}
    for name, spec in VATLM_STREAMS:
        d = _draw(draws, name)
        out = model.forward_pretrain(
            batch["audio"] if spec["audio"] else None,
            batch["video"] if spec["video"] else None, batch["lengths"],
            phone_tokens=batch["phones"] if spec["phone"] else None, mask=True,
            masks=d.get("masks"), modality_drop=d.get("modality_drop"), generator=generator)
        tm = out["time_mask"]
        if tm is None:
            tm = torch.ones_like(out["valid_mask"])
        loss, _ = criterions.hubert_loss([out["logits"][0]], [targets], tm,
                                         out["valid_mask"])
        total = total + loss
        metrics[name] = loss
    return total, metrics
