"""Training entry point of the port: preset -> dataset -> Trainer ->
checkpoints, for the four fine-tune tasks and pretraining (the s2t, t2s,
s2s, s2c, pretrain_speech and pretrain paths of
``speecht5_tpu/cli/train.py``, with the same flag names and defaults).

Usage (the TTS fine-tune recipe, recipes/tts_finetune.sh; the mel targets
are computed on the card from the waveform unless --host-mel):
    python -m speecht5_tpu_torch.cli.train --task t2s --arch speecht5_base \\
        --manifest train.tsv --labels train.txt --dict dict.txt \\
        --spkemb-dir xvectors/ --save-dir ckpt/ --guided-attn --lr 1e-4 \\
        --warmup 10000 --batch-size 16 --dtype bfloat16 \\
        --override encoder.use_pallas_attn_train=True

Usage (the ASR fine-tune recipe, recipes/asr_finetune.sh):
    python -m speecht5_tpu_torch.cli.train --task s2t \\
        --arch speecht5_base_asr --manifest train.tsv --labels train.ltr \\
        --dict dict.ltr.txt --save-dir ckpt/ --ctc-weight 0.5 \\
        --label-smoothing 0.1 --accum 2 --batch-size 16 --normalize \\
        --dtype bfloat16 --override encoder.use_pallas_attn_train=True \\
        --override conv_features.impl=pallas

Usage (the VC fine-tune recipe, recipes/vc_finetune.sh; manifest rows
"src.wav<TAB>n<TAB>tgt.wav<TAB>n<TAB>tgt_xvector.npy"; no --labels or
--dict):
    python -m speecht5_tpu_torch.cli.train --task s2s --arch speecht5_base \\
        --manifest bdl_to_slt.tsv --guided-attn --lr 1e-4 --warmup 6000 \\
        --batch-size 8 --dtype bfloat16 --save-dir ckpt/vc

Usage (the SID fine-tune recipe, recipes/sid_finetune.sh; manifest rows
"file.wav<TAB>n<TAB>speaker"; the class map, sorted labels, is written to
``<save-dir>/class_map.txt`` and validation scores against it):
    python -m speecht5_tpu_torch.cli.train --task s2c \\
        --arch speecht5_base_sid --manifest train.tsv --lr 2e-4 --warmup 2000 \\
        --accum 2 --batch-size 8 --max-sample-size 128000 --dtype bfloat16 \\
        --save-dir ckpt/sid

Usage (joint speech + text pretraining, recipes/joint_pretrain.sh;
``--labels`` holds one line of 50 Hz km labels per utterance, ``--text-file``
a raw text corpus; at Large add ``--arch speecht5_large``):
    python -m speecht5_tpu_torch.cli.train --task pretrain --arch speecht5_base \
        --manifest speech_train.tsv --labels speech_train.km \
        --text-file text_train.txt --dict dict.txt --tokens-per-sample 512 \
        --text-ratio 1.0 --lr 2e-4 --warmup 25000 --accum 2 --batch-size 16 \
        --normalize --dtype bfloat16 --save-dir ckpt/pretrained

``--task pretrain_speech`` trains the speech half alone.  Joint
pretraining interleaves modality-pure updates, ``--text-ratio`` text
updates per speech update, in an order drawn from the seed and the epoch
(JAX cli/train.py:404-420); with ``--accum`` N an update is N batches of
one task.  Its metrics carry the task as a prefix
(``pretrain_speech/loss``); ``--valid-manifest`` is refused with it, as
JAX refuses it.

Speech enhancement (``se_predict``) needs the source fbank as the decoder
input, which only ``SpeechToSpeechDataset(se_mode=True)`` gives; this CLI,
like JAX's, has no flag for it, so ``--task s2s --override se_predict=...``
is refused with a ValueError.

One update consumes ``--accum`` consecutive batches of ``--batch-size``
(fairseq --update-freq).  ``--valid-manifest`` runs validation every
``--valid-interval`` updates (loss metrics, and for s2t greedy-CTC
UER/WER) and, with
``--best-checkpoint-metric``, keeps the best checkpoint under
``<save-dir>/best/``.  Runs on the card unless ``--device cpu``.

Warm start: ``--finetune-from`` takes a port checkpoint directory (the
newest ``checkpoint_<step>.pt``, train or model-only: ``cli/convert.py``
writes one from a released fairseq or HF checkpoint, the top-level
``convert_jax_checkpoint.py`` from a JAX one) or a fairseq ``.pt`` file,
and loads its model state into the fresh model before the optimizer is
built, key by key: a key it lacks or whose shape differs (a text head at
another vocabulary size) keeps its initial value.  A resumable checkpoint
in ``--save-dir`` takes precedence (the run resumes).

SIGTERM or SIGINT (a preempted job) lets the update in progress finish,
every ``--accum`` micro-batch of it, then saves a resumable checkpoint at
that update (the data position included), prints ``{"preempted": true,
"step": N}`` and returns; a rerun resumes from it.  ``--profile-dir``
writes a ``torch.profiler`` trace of updates 10-14 there
(``utils/profiling.trace``).  Multi-process training is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import time

import numpy as np
import torch

TASKS = ("s2t", "t2s", "s2s", "s2c", "pretrain_speech", "pretrain")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", required=True, choices=TASKS)
    p.add_argument("--arch", default="speecht5_base",
                   help="config preset name in speecht5_tpu_torch.config")
    p.add_argument("--manifest", required=True)
    p.add_argument("--labels", default=None,
                   help="transcripts (s2t, t2s) or km labels (pretraining)")
    p.add_argument("--text-file", default=None,
                   help="raw text corpus for --task pretrain")
    p.add_argument("--tokens-per-sample", type=int, default=512)
    p.add_argument("--text-ratio", type=float, default=1.0,
                   help="text updates per speech update in joint pretraining")
    p.add_argument("--dict", dest="dict_path", default=None)
    p.add_argument("--spkemb-dir", default=None,
                   help="t2s: x-vector .npy files named by utterance basename "
                        "(s2s rows name their own)")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--max-updates", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-tokens", type=int, default=0)
    p.add_argument("--max-sample-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--schedule", default="inverse_sqrt",
                   choices=("inverse_sqrt", "tri_stage", "polynomial"))
    p.add_argument("--hold-steps", type=int, default=0,
                   help="tri_stage hold phase length")
    p.add_argument("--clip-norm", type=float, default=5.0)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--ce-weight", type=float, default=1.0)
    p.add_argument("--ctc-weight", type=float, default=0.0)
    p.add_argument("--zero-infinity", action="store_true",
                   help="zero CTC loss for infeasible alignments")
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--guided-attn", action="store_true",
                   help="t2s: add the guided attention loss")
    p.add_argument("--freeze-encoder-updates", type=int, default=0)
    p.add_argument("--freeze-decoder-updates", type=int, default=0)
    p.add_argument("--no-freeze-encoder-layers", default="",
                   help="comma-separated encoder layer indices exempt from "
                        "the encoder freeze")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--device-mel", dest="device_mel", action="store_true",
                   default=True,
                   help="t2s/s2s/pretraining: compute the log-mel targets on "
                        "the device "
                        "from the waveform (the CUDA log-mel kernel on the "
                        "card); the default")
    p.add_argument("--host-mel", dest="device_mel", action="store_false",
                   help="t2s/s2s: compute the log-mel targets per utterance "
                        "on the host (numpy)")
    p.add_argument("--mask-prob", type=float, default=None,
                   help="override HuBERT masking prob (e.g. 0 to disable)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save-interval", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--keep-last", type=int, default=10)
    p.add_argument("--valid-manifest", default=None)
    p.add_argument("--valid-labels", default=None)
    p.add_argument("--valid-interval", type=int, default=1000)
    p.add_argument("--best-checkpoint-metric", default=None,
                   help="validation metric (e.g. wer, loss) that selects the "
                        "best/ checkpoint")
    p.add_argument("--maximize-best-checkpoint-metric", action="store_true")
    p.add_argument("--finetune-from", default=None,
                   help="warm start (non-strict): a port checkpoint dir "
                        "(cli/convert.py's output) or a fairseq .pt file")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of updates 10-14 here")
    p.add_argument("--vocab-size", type=int, default=None,
                   help="override vocab (tasks without a dictionary)")
    p.add_argument("--override", action="append", default=[],
                   help="config field override, dotted path = literal, repeatable")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p


def make_batches(sizes, args, seed):
    from ..data.manifests import batch_by_size

    if args.max_tokens:
        return batch_by_size(sizes, args.max_tokens, args.batch_size or None,
                             shuffle_seed=seed)
    order = np.random.default_rng(seed).permutation(len(sizes))
    B = args.batch_size or 8
    if len(order) < B:
        raise SystemExit(
            f"dataset has {len(sizes)} items < --batch-size {B}: no full "
            "batch can be formed (the trailing partial batch is dropped)")
    return [order[i : i + B] for i in range(0, len(order) - B + 1, B)]


def run_validation(trainer, ds, args, cfg, dictionary, device):
    """Average eval-step metrics over the full batches of ``ds``, and for
    s2t the greedy-CTC UER (tokens) and WER (words) when CTC is trained (the
    reference's valid-time WER, speech_to_text_loss.py:232-297)."""
    from ..data.dictionary import letters_to_text
    from ..utils.metrics import edit_distance

    sums, n_batches = {}, 0
    uer_err = uer_tot = wer_err = wer_tot = 0
    B = args.batch_size
    for s in range(0, len(ds) - len(ds) % B, B):
        items = [ds[i] for i in range(s, s + B)]
        out = trainer.eval_step(_to_device(collate(args, ds, items, cfg), device))
        ids = out.pop("_ctc_ids", None)
        lens = out.pop("_enc_lengths", None)
        for k, v in out.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n_batches += 1
        if ids is None or args.ctc_weight <= 0:
            continue
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        for b, it in enumerate(items):
            seq = ids[b, : lens[b]]
            if len(seq):
                seq = seq[np.concatenate([[True], seq[1:] != seq[:-1]])]
            seq = seq[(seq != cfg.blank_id) & (seq != cfg.pad_id)].tolist()
            ref = [t for t in it["tokens"].tolist() if t not in (cfg.pad_id, cfg.eos_id)]
            uer_err += edit_distance(seq, ref)
            uer_tot += max(len(ref), 1)
            if dictionary is not None:
                hyp_w = letters_to_text(dictionary.string(seq)).split()
                ref_w = letters_to_text(dictionary.string(ref)).split()
                wer_err += edit_distance(ref_w, hyp_w)
                wer_tot += len(ref_w)
    result = {k: v / max(n_batches, 1) for k, v in sums.items()}
    if uer_tot:
        result["uer"] = uer_err / uer_tot
        if wer_tot:
            result["wer"] = wer_err / wer_tot
    return result


def _best_state(save_dir):
    """The incumbent best ({"metric", "value", "step"}) of a resumed run."""
    path = os.path.join(save_dir, "best", "best.json")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _to_device(batch, device):
    """Model inputs on the card; a batch's wav_lengths stays on the host so
    that the masks are drawn there without a device sync."""
    out = {}
    for k, v in batch.items():
        if k == "ids":
            continue
        t = torch.from_numpy(v)
        out[k] = t if k == "wav_lengths" else t.to(device, non_blocking=True)
    return out


def build_dataset(args, dictionary, cfg, manifest, labels):
    """The task's dataset; for --task pretrain {"pretrain_speech": speech,
    "pretrain_text": text} (JAX cli/train.py:55-74)."""
    from ..data.manifests import (SpeechPretrainDataset, SpeechToClassDataset,
                                  SpeechToSpeechDataset, SpeechToTextDataset,
                                  TextPretrainDataset, TextToSpeechDataset)

    if args.task in ("pretrain_speech", "pretrain"):
        speech = SpeechPretrainDataset(
            manifest=manifest, km_labels=labels, n_mels=cfg.n_mels,
            reduction_factor=cfg.reduction_factor, normalize=args.normalize,
            device_mel=args.device_mel, seed=args.seed)
        if args.task == "pretrain_speech":
            return speech
        text = TextPretrainDataset(
            text_file=args.text_file, dictionary=dictionary,
            tokens_per_sample=args.tokens_per_sample, bos_id=cfg.bos_id,
            eos_id=cfg.eos_id, pad_id=cfg.pad_id, mask_id=dictionary.index("<mask>"),
            seed=args.seed)
        return {"pretrain_speech": speech, "pretrain_text": text}
    if args.task == "s2s":
        return SpeechToSpeechDataset(
            manifest=manifest, normalize=args.normalize,
            reduction_factor=cfg.reduction_factor, n_mels=cfg.n_mels,
            device_mel=args.device_mel)
    if args.task == "s2c":
        return SpeechToClassDataset(manifest=manifest, normalize=args.normalize,
                                    max_sample_size=args.max_sample_size,
                                    seed=args.seed)
    if args.task == "t2s":
        return TextToSpeechDataset(
            manifest=manifest, labels=labels, dictionary=dictionary,
            spkemb_dir=args.spkemb_dir, reduction_factor=cfg.reduction_factor,
            n_mels=cfg.n_mels, device_mel=args.device_mel)
    return SpeechToTextDataset(manifest=manifest, labels=labels,
                               dictionary=dictionary, normalize=args.normalize,
                               max_sample_size=args.max_sample_size)


def collate(args, ds, items, cfg, task=None, epoch=0):
    """A batch of ``items`` of ``task`` (the CLI's when None)."""
    task = task or args.task
    if task == "pretrain_speech":
        return ds.collate(items, cfg.conv_features.out_length)
    if task == "pretrain_text":
        return ds.collate(items, epoch=epoch)
    if task in ("s2s", "s2c"):
        return ds.collate(items)
    return ds.collate(items, cfg.eos_id, cfg.pad_id)


def epoch_units(ds, args, epoch):
    """[(task, [batch indices, ...]), ...]: the epoch's updates.  One task:
    each batch its own unit (``--accum`` consecutive units make an
    update).  Joint pretraining (``ds`` a dict): modality-pure units of
    ``--accum`` batches, each task's batches repeated round-robin to its
    share (``--text-ratio`` for the text), shuffled by the seed and the
    epoch (JAX cli/train.py:404-420, whose units are single batches)."""
    if not isinstance(ds, dict):
        return [(args.task, [idxs])
                for idxs in make_batches(ds.sizes, args, args.seed + epoch)]
    units = []
    for name, d in ds.items():
        bs = make_batches(d.sizes, args, args.seed + epoch)
        reps = args.text_ratio if name == "pretrain_text" else 1.0
        n = max(int(round(len(bs) / args.accum * reps)), 1)
        units += [(name, [bs[(i * args.accum + a) % len(bs)] for a in range(args.accum)])
                  for i in range(n)]
    np.random.default_rng(args.seed + 31 * epoch).shuffle(units)
    return units


def main(argv=None):
    """Run the training loop; returns {"steps", "history": [per-update
    metrics as floats], "final_loss", "checkpoint"}."""
    args = build_parser().parse_args(argv)
    if args.labels is None and args.task in ("s2t", "t2s", "pretrain_speech", "pretrain"):
        raise SystemExit(f"--task {args.task} needs --labels")
    if args.task == "pretrain":
        if args.text_file is None:
            raise SystemExit("--task pretrain needs --text-file")
        if args.valid_manifest:
            raise SystemExit("--valid-manifest is not supported with --task pretrain "
                             "(run a separate eval of the fine-tune task instead)")

    from .. import config as C
    from ..data.dictionary import load_cli_dictionary
    from ..data.prefetch import prefetch
    from ..models.speecht5 import init_model
    from ..train.trainer import Trainer, TrainConfig
    from ..utils.checkpoint import restore_latest, save_checkpoint
    from ..utils.device import resolve_device
    from ..utils.profiling import PhaseTimer, trace

    t_start = time.time()
    device = resolve_device(args.device)
    dictionary, cfg_kw = load_cli_dictionary(args.dict_path, args.vocab_size)
    cfg_kw["dtype"] = args.dtype
    cfg = getattr(C, args.arch)(**cfg_kw)
    cfg = C.apply_overrides(cfg, args.override)
    if args.mask_prob is not None:
        cfg = C.replace(cfg, masking=C.replace(
            cfg.masking, mask_prob=args.mask_prob,
            mask_channel_prob=min(cfg.masking.mask_channel_prob, args.mask_prob)))

    if args.task == "s2s" and cfg.se_predict is not None:
        raise ValueError(
            f"se_predict={cfg.se_predict!r} needs the source fbank as the decoder "
            "input (SpeechToSpeechDataset(se_mode=True)), which this CLI, like "
            "JAX's, never sets up")

    ds = build_dataset(args, dictionary, cfg, args.manifest, args.labels)
    if args.task == "s2c":
        if cfg.sid.num_classes != ds.num_classes:
            cfg = C.replace(cfg, sid=C.replace(cfg.sid, num_classes=ds.num_classes))
        # the label -> id map, so that eval manifests reuse the training one
        os.makedirs(args.save_dir, exist_ok=True)
        ds.save_class_map(os.path.join(args.save_dir, "class_map.txt"))
    torch.manual_seed(args.seed)   # the device generator: activation dropout
    model = init_model(cfg, torch.Generator().manual_seed(args.seed), device)
    if args.finetune_from:
        warm_start(model, args.finetune_from)
    tcfg = TrainConfig(
        lr=args.lr, warmup_steps=args.warmup, clip_norm=args.clip_norm,
        schedule=args.schedule, hold_steps=args.hold_steps,
        accum_steps=args.accum, ce_weight=args.ce_weight,
        ctc_weight=args.ctc_weight, zero_infinity=args.zero_infinity,
        label_smoothing=args.label_smoothing, use_guided_attn=args.guided_attn,
        total_steps=args.max_updates,
        freeze_encoder_updates=args.freeze_encoder_updates,
        freeze_decoder_updates=args.freeze_decoder_updates,
        no_freeze_encoder_layers=tuple(
            int(i) for i in args.no_freeze_encoder_layers.split(",") if i),
    )
    multitask = isinstance(ds, dict)
    trainer = Trainer(model, list(ds) if multitask else args.task, tcfg,
                      generator=torch.Generator().manual_seed(args.seed + 7))

    valid_ds = None
    if args.valid_manifest:
        valid_ds = build_dataset(args, dictionary, cfg, args.valid_manifest,
                                 args.valid_labels or args.labels)
        if args.task == "s2c":      # scored against the training map
            valid_ds.class_map = dict(ds.class_map)
            valid_ds.check_labels()
    best = _best_state(args.save_dir)
    if best is not None and best.get("metric") != args.best_checkpoint_metric:
        best = None

    epoch0 = batch0 = 0
    data_state = restore_latest(args.save_dir, trainer)
    if data_state is not None:
        epoch0, batch0 = data_state.get("epoch", 0), data_state.get("batch", 0)
        print(f"resumed at step {trainer.step}", flush=True)

    def batch_stream():
        """(epoch, unit index, task, collated batch) from the saved position
        on, epoch after epoch; runs on the prefetch thread."""
        epoch, start = epoch0, batch0
        while True:
            for bi, (task, group) in enumerate(epoch_units(ds, args, epoch)):
                if bi < start:
                    continue
                d = ds[task] if multitask else ds
                for idxs in group:
                    items = [d[int(i)] for i in idxs]
                    yield epoch, bi, task, collate(args, d, items, cfg, task, epoch)
            epoch, start = epoch + 1, 0

    # preemption: SIGTERM / SIGINT set a flag, read between updates (JAX
    # cli/train.py:445-462); handlers are set only from the main thread
    stop = {"flag": False}
    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(
                sig, lambda signum, frame: stop.update(flag=True))
        except ValueError:      # not the main thread
            pass

    history, micro = [], []
    final = None
    log_sums, log_n = {}, 0
    last_path = None
    preempted = False
    profiler = None
    timer = PhaseTimer("train", verbose=False)
    timer.phase("data")
    stream = prefetch(batch_stream())
    try:
        for epoch, bi, task, batch in stream:
            if trainer.step >= args.max_updates:   # resumed at the end
                break
            if not micro:   # between updates
                if stop["flag"]:
                    last_path = save_checkpoint(
                        args.save_dir, trainer,
                        data_state={"epoch": epoch, "batch": bi},
                        keep_last=args.keep_last)
                    print(json.dumps({"preempted": True, "step": trainer.step}),
                          flush=True)
                    preempted = True
                    break
                if args.profile_dir and trainer.step == 10 and profiler is None:
                    profiler = trace(args.profile_dir)
                    profiler.__enter__()
            micro.append(_to_device(batch, device))
            if len(micro) < args.accum:
                continue
            timer.phase("step")
            metrics = (trainer.train_step(micro, task) if multitask
                       else trainer.train_step(micro))
            micro = []
            timer.phase("log", fence=metrics["loss"])
            if profiler is not None and trainer.step >= 15:
                profiler.__exit__(None, None, None)
                profiler = None
            prefix = f"{task}/" if multitask else ""
            row = {prefix + k: float(v) for k, v in metrics.items()}
            final = row[prefix + "loss"]
            history.append(row)
            for k, v in row.items():
                log_sums[k] = log_sums.get(k, 0.0) + v
            log_n += 1
            step = trainer.step
            if step % args.log_interval == 0 or step >= args.max_updates:
                print(json.dumps({"step": step, **{
                    k: round(v / log_n, 4) for k, v in log_sums.items()}}),
                    flush=True)
                log_sums, log_n = {}, 0
            if valid_ds is not None and step % args.valid_interval == 0:
                vm = run_validation(trainer, valid_ds, args, cfg, dictionary, device)
                line = {"step": step, **{f"valid_{k}": round(v, 4) for k, v in vm.items()}}
                metric = args.best_checkpoint_metric
                if metric and metric in vm and (
                        best is None or (vm[metric] > best["value"]
                                         if args.maximize_best_checkpoint_metric
                                         else vm[metric] < best["value"])):
                    best_dir = os.path.join(args.save_dir, "best")
                    save_checkpoint(best_dir, trainer,
                                    data_state={"epoch": epoch, "batch": bi + 1},
                                    keep_last=1)
                    best = {"metric": metric, "value": vm[metric], "step": step}
                    with open(os.path.join(best_dir, "best.json"), "w",
                              encoding="utf-8") as f:
                        json.dump(best, f)
                    line["new_best"] = metric
                print(json.dumps(line), flush=True)
            if step % args.save_interval == 0 or step >= args.max_updates:
                last_path = save_checkpoint(
                    args.save_dir, trainer,
                    data_state={"epoch": epoch, "batch": bi + 1},
                    keep_last=args.keep_last)
            if step >= args.max_updates:
                break
            timer.phase("data")
    finally:
        stream.close()
        if profiler is not None:
            profiler.__exit__(None, None, None)
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    print(f"phases: {timer.summary()}", flush=True)
    print(json.dumps({"done": True, "steps": trainer.step, "final_loss": final,
                      "wall": round(time.time() - t_start, 1)}), flush=True)
    return {"steps": trainer.step, "history": history, "final_loss": final,
            "checkpoint": None if last_path is None else str(last_path),
            "preempted": preempted,
            "finite": all(math.isfinite(v) for r in history for v in r.values())}


def warm_start(model, source):
    """Load the model state of ``source`` into ``model`` key by key
    (``utils/checkpoint.partial_load``; JAX cli/train.py:356-364): a port
    checkpoint directory (its newest checkpoint, train or model-only) or a
    fairseq ``.pt`` file.  Raises SystemExit when there is nothing to load."""
    from ..utils.checkpoint import partial_load, restore_model
    from ..utils.convert import load_fairseq_checkpoint

    if os.path.isfile(source):
        state, _, _ = load_fairseq_checkpoint(source)
    else:
        state, _ = restore_model(source)
        if state is None:
            raise SystemExit(f"--finetune-from {source}: no checkpoint_<step>.pt there")
    model.load_state_dict(partial_load(model.state_dict(), state))
    print(f"warm start from {source}", flush=True)


if __name__ == "__main__":
    main()
