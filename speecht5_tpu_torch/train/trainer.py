"""The train steps of the four SpeechT5 fine-tune tasks and of
pretraining (port of ``speecht5_tpu/train/trainer.py`` :31-434): s2t
(ASR), t2s (TTS), s2s (VC / SE), s2c (SID), pretrain_speech and
pretrain_text.

One update = ``accum_steps`` micro-batches (fairseq --update-freq), each a
forward and backward of the task's loss: s2t ``forward_s2t`` +
``s2t_loss``; t2s ``device_mel_batch`` (the mel targets from the waveform,
through the log-mel kernel on the card) + ``forward_t2s`` + ``tts_loss``;
s2s ``device_mel_batch`` (the target's mels and, for SE, the source's) +
``forward_s2s`` + ``tts_loss``; s2c ``forward_s2c`` + ``sid_loss``;
pretrain_speech ``device_mel_batch`` + ``forward_pretrain_speech`` +
``speech_pretrain_loss`` (the km labels as the one label set);
pretrain_text ``forward_pretrain_text`` + ``text_pretrain_loss``.  Joint
pretraining gives one ``Trainer`` both pretraining tasks: one optimizer
and one update count over modality-pure batches, each update naming its
task (JAX runs one step program per task on one state); the update count
drives the quantizer's temperature.  The gradients are averaged, then
(as the JAX optax chain) clipped by their global norm and applied by
AdamW:

- clipping as ``optax.clip_by_global_norm``: g unchanged when norm < c,
  else g * c / norm (no epsilon);
- ``torch.optim.AdamW`` over every parameter is ``optax.adamw``: decoupled
  weight decay, eps outside the square root, per-step learning rate from
  the schedule at the update count;
- freeze horizons (--freeze-encoder-updates / --freeze-decoder-updates):
  while step < N a frozen parameter's gradient is None, so it adds nothing
  to the norm and AdamW leaves it and its moments alone; its step count
  starts lazily at release, which is what the JAX debias (trainer.py
  :373-391) emulates.  A parameter that the loss does not reach gets a zero
  gradient, as in JAX, so weight decay still applies to it;
- ``grad_norm`` is the norm before clipping, the JAX metric;
- the BatchNorm statistics (the speech postnet's, the speaker head's) move
  on every training micro-batch, in order, as JAX threads its mutable
  ``batch_stats`` through the micro-batches.

The host-side random draws of a rank's rows (HuBERT masks, the SID frame
shuffle, the Gumbel noise and the codebook permutation) come from one CPU
``torch.Generator``; the layer-wide draws (layerdrop, the train kernel's
dropout seeds) from a CPU generator seeded by ``layer_seed`` and the
update count, the same on every rank; dropout of activations draws from
the device's generator.

Parallelism (JAX ``Trainer(..., mesh, fsdp)``, trainer.py:444): with a
``('data', 'model')`` mesh (``parallel/sharding.make_mesh``) each rank
computes the losses of its rows as its share of the global-batch loss
(``criterions``), so the gradients are summed across the data ranks:

- data parallel: one flat, bucketed all-reduce (SUM) of every gradient
  over the data ranks after the update's last micro-batch.  Our own rather
  than DDP's: DDP averages, and its reducer has to be told which
  parameters the loss skipped; here an untouched parameter has a zero
  gradient, as in JAX, and the sum is JAX's global-batch gradient;
- FSDP (``fsdp=True``): ``fully_shard`` per encoder and decoder layer and
  at the root, parameters split as ``param_specs(fsdp=True)`` places them,
  gradients reduce-scattered as sums (synced on the last micro-batch
  only); the parameters it keeps whole are summed as above;
- tensor parallel (``n_model`` > 1): ``parallelize_module`` by the
  sharding rules; the attention modules run their local heads.  With
  ``fsdp`` too, FSDP then shards over the data ranks an axis that the
  model split left whole (JAX's 2-D placement).

The clip norm is the global norm over the sharded gradients (each shard's
squares summed over the mesh dims it is split on), and AdamW and the
freeze horizons work on the sharded parameters.  The initial weights are
made from one seed on every rank and checked to agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops.cuda_kernels import fused_log_mel
from ..parallel import distributed as D
from ..parallel.sharding import (apply_fsdp, apply_tensor_parallel, mesh_shape,
                                 redistribute)
from . import criterions
from .schedules import inverse_sqrt, polynomial_decay, tri_stage

TASKS = ("s2t", "t2s", "s2s", "s2c", "pretrain_speech", "pretrain_text")


def device_mel_batch(batch, n_mels: int, r: int):
    """The t2s / s2s mel targets from the collator's reflect-padded target
    waveform (JAX trainer.py:31-72): ``fused_log_mel`` with center=False
    (each utterance was reflect-padded on the host, so valid frames equal
    the per-utterance transform), frames past ``dec_lengths`` set to exact
    zeros, then the r-thinned frames shifted by a zero BOS frame and masked
    by ``dec_lengths_r``.  Returns a new dict with ``target_mel`` [B, F,
    n_mels] and ``prev_mel`` [B, F // r, n_mels] in place of ``tgt_wav``.
    With ``src_wav`` (SE: the source reflect-padded onto the target's grid)
    also ``src_mel`` [B, F // r, n_mels]: the source's mels, r-thinned
    (unshifted), rows past ``src_frames // r`` zeroed, in place of
    ``src_wav`` and ``src_frames``.  A batch without ``tgt_wav`` (host
    mels) is returned as it is."""
    if "tgt_wav" not in batch:
        return batch
    batch = dict(batch)
    mel = fused_log_mel(batch.pop("tgt_wav"), n_mels=n_mels, center=False)
    dev = mel.device
    zero = torch.zeros((), device=dev)
    frames = torch.arange(mel.shape[1], device=dev)[None, :]
    valid = frames < batch["dec_lengths"].to(dev)[:, None]
    mel = torch.where(valid[:, :, None], mel, zero)
    thin = mel[:, r - 1::r]
    prev = torch.cat([torch.zeros_like(thin[:, :1]), thin[:, :-1]], dim=1)
    valid_r = (torch.arange(prev.shape[1], device=dev)[None, :]
               < batch["dec_lengths_r"].to(dev)[:, None])
    batch["target_mel"] = mel
    batch["prev_mel"] = torch.where(valid_r[:, :, None], prev, zero)
    if "src_wav" in batch:
        src = fused_log_mel(batch.pop("src_wav"), n_mels=n_mels, center=False)
        sthin = src[:, r - 1::r]
        n_thin = batch.pop("src_frames").to(dev) // r
        valid_s = torch.arange(sthin.shape[1], device=dev)[None, :] < n_thin[:, None]
        batch["src_mel"] = torch.where(valid_s[:, :, None], sthin, zero)
    return batch


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    warmup_steps: int = 25000
    schedule: str = "inverse_sqrt"   # inverse_sqrt | tri_stage | polynomial
    total_steps: int = 800000
    hold_steps: int = 0
    betas: tuple = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 5.0
    accum_steps: int = 1             # fairseq --update-freq
    ce_weight: float = 1.0
    ctc_weight: float = 0.0
    zero_infinity: bool = False
    label_smoothing: float = 0.1
    dec_weight: float = 1.0          # pretrain_speech: the decoder's loss
    use_guided_attn: bool = False
    freeze_encoder_updates: int = 0
    freeze_decoder_updates: int = 0
    no_freeze_encoder_layers: tuple = ()


def make_schedule(cfg: TrainConfig):
    if cfg.schedule == "inverse_sqrt":
        return inverse_sqrt(cfg.lr, cfg.warmup_steps)
    if cfg.schedule == "tri_stage":
        return tri_stage(
            cfg.lr, cfg.warmup_steps, cfg.hold_steps,
            max(cfg.total_steps - cfg.warmup_steps - cfg.hold_steps, 1),
        )
    return polynomial_decay(cfg.lr, cfg.warmup_steps, cfg.total_steps)


# sub-nets covered by the reference freeze flags (JAX trainer.py:286-292)
_ENC_FREEZE_TOPS = ("speech_encoder_prenet",)
_DEC_FREEZE_TOPS = (
    "decoder", "speech_decoder_prenet", "speech_decoder_postnet",
    "text_decoder_prenet", "text_decoder_postnet",
)


def freeze_horizon(name: str, cfg: TrainConfig) -> int:
    """Freeze horizon N of a parameter (0 = never frozen).  The encoder
    freeze covers the speech prenet and the encoder except its CTC
    projection and the exempt layers; the decoder freeze covers the decoder
    and its four pre/postnets (JAX trainer.py:304-328)."""
    parts = name.split(".")
    top = parts[0]
    if cfg.freeze_encoder_updates:
        if top in _ENC_FREEZE_TOPS:
            return cfg.freeze_encoder_updates
        if top == "encoder" and len(parts) >= 2:
            exempt = {f"layers.{i}" for i in cfg.no_freeze_encoder_layers}
            second = ".".join(parts[1:3]) if parts[1] == "layers" else parts[1]
            if second != "proj" and second not in exempt:
                return cfg.freeze_encoder_updates
    if cfg.freeze_decoder_updates and top in _DEC_FREEZE_TOPS:
        return cfg.freeze_decoder_updates
    return 0


class Trainer:
    """The model, its AdamW and the update count, for one task or, given a
    list (joint pretraining), for each of them: ``train_step`` then names
    the task of its batches."""

    def __init__(self, model, task, cfg: TrainConfig, *, generator=None,
                 mesh=None, fsdp: bool = False, layer_seed: int = 0):
        self.tasks = [task] if isinstance(task, str) else list(task)
        for t in self.tasks:
            if t not in TASKS:
                raise ValueError(f"task {t!r} is not ported; only {TASKS} are")
        self.model = model
        self.cfg = cfg
        self.task = self.tasks[0]
        self.mesh = mesh
        self.layer_seed = layer_seed
        shape = mesh_shape(mesh)
        # with a mesh the data-parallel sums run even over one data rank
        self.data_group = None if mesh is None else mesh.get_group("data")
        D.set_data_group(self.data_group)
        if mesh is not None:
            D.check_replicated([t.detach() for t in model.state_dict().values()],
                               "initial model state")
        if shape["model"] > 1:
            apply_tensor_parallel(model, mesh)
        # the gradients this trainer sums over the data ranks itself
        self.fsdp = fsdp and shape["data"] > 1
        if self.fsdp:
            self.summed = apply_fsdp(model, mesh)
        else:
            self.summed = list(model.parameters()) if self.data_group is not None else []
        self.named = list(model.named_parameters())
        self.horizons = [freeze_horizon(n, cfg) for n, _ in self.named]
        # the whole tensors in one group; split ones by placement, updated
        # one at a time: an update then never moves a tensor between ranks
        # (DTensor's collectives do not run over gloo on a card's tensors)
        groups = {}
        for _, p in self.named:
            key = (p.device_mesh, p.placements) if _is_dtensor(p) else None
            groups.setdefault(key, []).append(p)
        self.optimizer = torch.optim.AdamW(
            [{"params": g} if key is None else {"params": g, "foreach": False}
             for key, g in groups.items()],
            lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay)
        self.schedule = make_schedule(cfg)
        self.step = 0
        self.generator = (generator if generator is not None
                          else torch.Generator().manual_seed(0))

    def loss(self, batch):
        """(loss, metrics) of one micro-batch.  s2t: wav [B, T] f32,
        wav_lengths [B] (CPU is best: the masks are drawn on the host),
        prev_tokens and targets [B, L].  t2s: tokens [B, L], dec_lengths and
        dec_lengths_r [B], spkembs [B, spk_dim] or absent, and either
        tgt_wav [B, (F - 1) * hop + n_fft] (device mels) or target_mel /
        prev_mel (host mels).  s2s: wav and wav_lengths as s2t, the t2s
        targets and spkembs, and for SE src_wav / src_frames (device mels)
        or src_mel (host mels).  s2c: wav, wav_lengths and targets [B]
        class ids.  pretrain_speech: the s2t waveform, ``km_labels`` [B,
        frames] and the t2s mel targets; pretrain_text: tokens, targets and
        prev_tokens [B, L]."""
        if self.task in ("t2s", "s2s"):
            return self._tts_loss(batch)
        if self.task == "s2c":
            return self._sid_loss(batch)
        if self.task == "pretrain_speech":
            return self._speech_pretrain_loss(batch)
        if self.task == "pretrain_text":
            mcfg = self.model.cfg
            out = self.model.forward_pretrain_text(
                batch["tokens"], batch["prev_tokens"], num_updates=self.step,
                generator=self.generator)
            return criterions.text_pretrain_loss(out, batch["targets"], mcfg.pad_id,
                                                 label_smoothing=self.cfg.label_smoothing)
        mcfg = self.model.cfg
        cfg = self.cfg
        logits, ctc_logits, enc_valid = self.model.forward_s2t(
            batch["wav"], batch["wav_lengths"], batch["prev_tokens"],
            mask=True, generator=self.generator)
        return criterions.s2t_loss(
            logits, ctc_logits, enc_valid, batch["targets"], mcfg.pad_id,
            mcfg.blank_id, eos_id=mcfg.eos_id, ce_weight=cfg.ce_weight,
            ctc_weight=cfg.ctc_weight, label_smoothing=cfg.label_smoothing,
            zero_infinity=cfg.zero_infinity)

    def _tts_loss(self, batch):
        """The t2s and s2s losses (JAX trainer.py:182-202, :227-248); the
        s2s encoder lengths are counted in conv frames."""
        mcfg = self.model.cfg
        batch = device_mel_batch(batch, mcfg.n_mels, mcfg.reduction_factor)
        if self.task == "s2s":
            before, after, stop_logits, attn, enc_valid = self.model.forward_s2s(
                batch["wav"], batch["wav_lengths"], batch["prev_mel"],
                batch["dec_lengths_r"], batch.get("spkembs"), batch.get("src_mel"),
                generator=self.generator)
            enc_lengths = enc_valid.sum(-1)
        else:
            before, after, stop_logits, attn = self.model.forward_t2s(
                batch["tokens"], batch["prev_mel"], batch["dec_lengths_r"],
                batch.get("spkembs"), generator=self.generator)
            enc_lengths = (batch["tokens"] != mcfg.pad_id).sum(-1)
        return criterions.tts_loss(
            before, after, stop_logits, batch["target_mel"], batch["dec_lengths"],
            reduction_factor=mcfg.reduction_factor, attn=attn,
            enc_lengths=enc_lengths, use_guided_attn=self.cfg.use_guided_attn)

    def _sid_loss(self, batch):
        """The s2c loss (JAX trainer.py:250-263): no masking, the margin
        softmax on training passes, the speaker head's BatchNorm statistics
        updated on them."""
        logits, _ = self.model.forward_s2c(batch["wav"], batch["wav_lengths"],
                                           batch["targets"], mask=False,
                                           generator=self.generator)
        return criterions.sid_loss(logits, batch["targets"],
                                   label_smoothing=self.cfg.label_smoothing)

    def _speech_pretrain_loss(self, batch):
        """The speech pretraining loss (JAX trainer.py:204-225); the encoder
        lengths counted in conv frames."""
        mcfg = self.model.cfg
        batch = device_mel_batch(batch, mcfg.n_mels, mcfg.reduction_factor)
        out = self.model.forward_pretrain_speech(
            batch["wav"], batch["wav_lengths"], batch["prev_mel"],
            batch["dec_lengths_r"], batch.get("spkembs"), num_updates=self.step,
            generator=self.generator)
        return criterions.speech_pretrain_loss(
            out, [batch["km_labels"]], batch["target_mel"], batch["dec_lengths"],
            out["valid_mask"].sum(-1), reduction_factor=mcfg.reduction_factor,
            dec_weight=self.cfg.dec_weight, use_guided_attn=self.cfg.use_guided_attn)

    @torch.no_grad()
    def eval_step(self, batch):
        """Validation forward (no masking, dropout, layerdrop or frame
        shuffle; the BatchNorm reads its running statistics; the Tacotron
        prenet's dropout stays on, as in JAX).  t2s / s2s: the ``tts_loss``
        metrics; s2c: the ``sid_loss`` metrics (no margin).  s2t: the s2t
        metrics with CTC always on, and the greedy CTC frame ids and frame
        lengths for the caller's error rates (JAX trainer.py :505-575)."""
        mcfg, cfg = self.model.cfg, self.cfg
        self.model.eval()
        if self.task != "s2t":
            return self._global_metrics(self.loss(batch)[1])
        logits, ctc_logits, enc_valid = self.model.forward_s2t(
            batch["wav"], batch["wav_lengths"], batch["prev_tokens"], mask=False)
        _, metrics = criterions.s2t_loss(
            logits, ctc_logits, enc_valid, batch["targets"], mcfg.pad_id,
            mcfg.blank_id, eos_id=mcfg.eos_id, ce_weight=cfg.ce_weight,
            ctc_weight=max(cfg.ctc_weight, 1e-9),
            label_smoothing=cfg.label_smoothing)
        metrics = self._global_metrics(metrics)
        metrics["_ctc_ids"] = ctc_logits.argmax(-1)
        metrics["_enc_lengths"] = enc_valid.sum(-1)
        return metrics

    def _global_metrics(self, metrics):
        """Each metric summed over the data ranks (every one is a rank's
        share of the global-batch value): one all-reduce."""
        if self.data_group is None or not metrics:
            return metrics
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(vec, group=self.data_group)
        return dict(zip(keys, vec.unbind()))

    def train_step(self, micro_batches, task=None):
        """One update over ``accum_steps`` micro-batches of ``task`` (one of
        the trainer's; the first when None) -> metrics (0-dim tensors on the
        model's device, averaged over the micro-batches, and
        ``grad_norm``)."""
        if task is not None:
            if task not in self.tasks:
                raise ValueError(f"task {task!r} is not one of {self.tasks}")
            self.task = task
        if len(micro_batches) != self.cfg.accum_steps:
            raise ValueError(f"expected {self.cfg.accum_steps} micro-batches, "
                             f"got {len(micro_batches)}")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        self.model.encoder.layer_generator = torch.Generator().manual_seed(
            self.layer_seed * 1_000_003 + self.step)
        sums = {}
        for i, mb in enumerate(micro_batches):
            if self.fsdp:   # reduce-scatter after the last micro-batch only
                self.model.set_requires_gradient_sync(i == len(micro_batches) - 1)
            loss, metrics = self.loss(mb)
            (loss / len(micro_batches)).backward()
            for k, v in metrics.items():
                v = v.detach()
                sums[k] = v if k not in sums else sums[k] + v
        metrics = self._global_metrics(
            {k: v / len(micro_batches) for k, v in sums.items()})

        grads = []
        for (_, p), horizon in zip(self.named, self.horizons):
            if self.step < horizon:
                p.grad = None
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif _is_dtensor(p):
                p.grad = redistribute(p.grad, p)
            grads.append(p.grad)
        if self.summed:
            sum_gradients([p.grad for p in self.summed], self.data_group)
        norm = global_norm(grads)
        if self.cfg.clip_norm > 0 and grads:
            c = self.cfg.clip_norm
            scale = torch.where(norm < c, torch.ones_like(norm), c / norm)
            torch._foreach_mul_([_local(g) for g in grads], scale.to(_local(grads[0])))
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        metrics["grad_norm"] = norm
        return metrics


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t):
    """The rank's part of a (possibly split) tensor."""
    return t.to_local() if _is_dtensor(t) else t


BUCKET_BYTES = 25 * 2 ** 20


def sum_gradients(grads, group) -> None:
    """Sum ``grads`` (each rank's local parts) over ``group`` in place, in
    flat buckets of about ``BUCKET_BYTES``, one all-reduce each."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    bucket, size = [], 0
    tensors = [_local(g) for g in grads if g is not None]
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel() * t.element_size()
        last = i == len(tensors) - 1
        if size >= BUCKET_BYTES or last or tensors[i + 1].dtype != t.dtype \
                or tensors[i + 1].device != t.device:
            flat = _flatten_dense_tensors(bucket)
            dist.all_reduce(flat, group=group)
            for dst, src in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                dst.copy_(src)
            bucket, size = [], 0


def global_norm(grads):
    """The L2 norm over every element of ``grads``, split or whole: a split
    gradient's squares are summed over the mesh dims it is split on, a
    whole one (the same on every rank) is counted once."""
    if not grads:
        return torch.zeros(())
    plain = [g for g in grads if not _is_dtensor(g)]
    norms = list(torch._foreach_norm(plain)) if plain else []
    split = {}
    for g in grads:
        if _is_dtensor(g):
            dims = tuple(i for i, pl in enumerate(g.placements) if pl.is_shard())
            split.setdefault((g.device_mesh, dims), []).append(g.to_local())
    for (mesh, dims), tensors in split.items():
        sq = torch.stack(torch._foreach_norm(tensors)).square().sum()
        for d in dims:
            dist.all_reduce(sq, group=mesh.get_group(d))
        norms.append(sq.sqrt())
    return torch.linalg.vector_norm(torch.stack(norms))
