"""Evaluation entry point of the port: checkpoint -> decoder -> WER / BLEU /
accuracy / MCD (port of ``speecht5_tpu/cli/evaluate.py`` :29-421).

- s2t: the joint CTC/attention beam (``--decoder beam``, with an optional
  neural fusion LM, ``--lm-ckpt``, and ``--ensemble-last``), CTC greedy,
  the native lexicon + word n-gram LM CTC beam (``ctc_lexicon``) or the
  two-pass CTC N-best + attention rescore (``ctc_rescore``, open-vocabulary
  or with ``--lexicon``) -> corpus WER (letter labels) or BLEU;
- s2c: batched speaker classification -> accuracy;
- t2s / s2s: AR mel decode -> MCD against the reference mel and the focus
  rate; with ``--results-path`` the mels as ``.npy`` and, with
  ``--griffin-lim``, Griffin-Lim WAVs.

Checkpoints are the port's ``checkpoint_<step>.pt`` files in ``--ckpt``: the
newest, the average of the last ``--avg-last``, the best one
(``--use-best``: ``<ckpt>/best``, which ``cli/train.py
--best-checkpoint-metric`` keeps) or an ensemble of the last
``--ensemble-last``.  ``--lm-ckpt`` names a model-only checkpoint of
``models/lm.TransformerLM`` weights (``utils/checkpoint.save_model_only``);
the LM runs in the model's dtype and takes the decode-step kernel when the
model's decoder does (``--override decoder.use_pallas_attn=True``).  Runs on
the card unless ``--device cpu``.

``--data-parallel`` (s2t): each batch's rows are shared out over the ranks
of the process group (``--distributed-*``, as ``cli/train.py`` takes them,
or torchrun's variables), each rank decodes its block and rank 0 gathers
the hypotheses and scores them.  The batch must be a multiple of the ranks;
the tail batch is padded with its last utterance, whose extra decodes are
never read.  JAX shards each batch over the devices of one process; the
port runs one process per card, so the launch topology differs and the
result does not.  In one process it is the plain path.

Usage:
    python -m speecht5_tpu_torch.cli.evaluate --task s2t \\
        --arch speecht5_base_asr --manifest test.tsv --labels test.ltr \\
        --dict dict.ltr.txt --ckpt ckpt/ --beam 5 --ctc-weight 0.3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", required=True, choices=["s2t", "t2s", "s2s", "s2c"])
    p.add_argument("--arch", default="speecht5_base")
    p.add_argument("--manifest", required=True)
    p.add_argument("--labels", default=None)
    p.add_argument("--dict", dest="dict_path", default=None)
    p.add_argument("--spkemb-dir", default=None)
    p.add_argument("--ckpt", required=True, help="directory of port checkpoints")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--ctc-weight", type=float, default=0.0)
    p.add_argument("--lm-weight", type=float, default=0.0)
    p.add_argument("--lm-ckpt", default=None,
                   help="directory of a model-only TransformerLM checkpoint for "
                        "shallow fusion in the beam (reference --lm-path, "
                        "SpeechT5/README.md:241-244)")
    p.add_argument("--lm-arch", default="t5", choices=("t5", "tiny"),
                   help="fusion LM geometry: 't5' = the reference's 20-layer "
                        "transformer_lm_t5, 'tiny' for tests")
    p.add_argument("--max-sample-size", type=int, default=None)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--results-path", default=None)
    p.add_argument("--max-frames", type=int, default=1600,
                   help="t2s/s2s: most mel frames a decode may produce")
    p.add_argument("--griffin-lim", action="store_true",
                   help="t2s/s2s: also write Griffin-Lim waveforms next to the "
                        "mel dumps in --results-path (ops/mel.mel_to_audio)")
    p.add_argument("--vocab-size", type=int, default=None)
    p.add_argument("--ensemble-last", type=int, default=0,
                   help="s2t beam: decode with the last N checkpoints as an "
                        "ensemble (per-step probability averaging)")
    p.add_argument("--use-best", action="store_true",
                   help="load the best checkpoint kept under <ckpt>/best")
    p.add_argument("--avg-last", type=int, default=0,
                   help="average the last N checkpoints' weights")
    p.add_argument("--metric", default="wer", choices=["wer", "bleu"],
                   help="s2t scoring: WER for ASR, corpus BLEU for ST")
    p.add_argument("--decoder", default="beam",
                   choices=["beam", "ctc_greedy", "ctc_lexicon", "ctc_rescore"],
                   help="s2t: the joint CTC/attention beam, CTC viterbi, the "
                        "native lexicon + word LM CTC beam, or CTC N-best + "
                        "one teacher-forced rescoring pass")
    p.add_argument("--rescore-nbest", type=int, default=8,
                   help="ctc_rescore: hypotheses per utterance")
    p.add_argument("--ctc-topk", type=int, default=0,
                   help="ctc_rescore: per-frame candidate pruning of the prefix "
                        "beam (0 = every token)")
    p.add_argument("--lexicon", default=None,
                   help="ctc_lexicon / ctc_rescore: 'word<TAB>tok1 tok2 ...' lines")
    p.add_argument("--lm-path", default=None,
                   help="word n-gram LM for the lexicon decoder: ARPA "
                        "(.arpa.gz too) or a binary (decode.lexicon.build_binary_lm)")
    p.add_argument("--word-score", type=float, default=0.0,
                   help="per-word insertion bonus of the lexicon decoder")
    p.add_argument("--ctc-beam-size", type=int, default=50,
                   help="beam width of the lexicon / N-best CTC decoder")
    p.add_argument("--override", action="append", default=[],
                   help="config field override, dotted path = literal, repeatable")
    p.add_argument("--data-parallel", action="store_true",
                   help="s2t: share each decode batch's rows over the ranks of the "
                        "process group (batch size a multiple of the ranks; the "
                        "tail batch is padded)")
    p.add_argument("--distributed-coordinator", default=None,
                   help="host:port of process 0 (or a file:// store)")
    p.add_argument("--distributed-num-processes", type=int, default=None)
    p.add_argument("--distributed-process-id", type=int, default=None)
    p.add_argument("--distributed-platform", default=None,
                   help="force a backend (cpu / gloo: gloo; nccl, the default on "
                        "a card)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p


def _build_model(cfg, state, device, arch="speecht5_base"):
    from ..models.registry import init_for_arch

    model = init_for_arch(arch, cfg, device=device)
    model.load_state_dict(state)
    return model


def load_models(args, cfg, device):
    """The model (or the ensemble's list of models) the flags select, and
    a message naming the checkpoints."""
    from ..utils.checkpoint import average_checkpoints, checkpoints, restore_model

    if args.ensemble_last > 1 or args.avg_last > 1:
        n = args.ensemble_last if args.ensemble_last > 1 else args.avg_last
        steps = [s for s, _ in checkpoints(args.ckpt)][-n:]
        if not steps:
            raise SystemExit(f"no checkpoints found in {args.ckpt}")
        states = [restore_model(args.ckpt, step=s)[0] for s in steps]
        if args.ensemble_last > 1:
            return ([_build_model(cfg, s, device, args.arch) for s in states],
                    f"ensemble of {len(states)} checkpoints {steps}")
        return (_build_model(cfg, average_checkpoints(states), device, args.arch),
                f"averaged {len(states)} checkpoints {steps}")
    if args.use_best:
        state, step = restore_model(os.path.join(args.ckpt, "best"))
        if state is None:
            raise SystemExit(f"no best checkpoint under {args.ckpt}/best "
                             f"(train with --best-checkpoint-metric)")
        return (_build_model(cfg, state, device, args.arch),
                f"loaded BEST checkpoint step {step}")
    state, step = restore_model(args.ckpt)
    if state is None:
        raise SystemExit(f"no checkpoint found in {args.ckpt}")
    return _build_model(cfg, state, device, args.arch), f"loaded checkpoint step {step}"


def load_lm(args, cfg, device):
    """The fusion LM of ``--lm-ckpt`` at the model's vocabulary, pad id,
    dtype and decode-step kernel flag."""
    from ..models.lm import TransformerLM, TransformerLMConfig, lm_tiny
    from ..utils.checkpoint import restore_model

    lmcfg = lm_tiny() if args.lm_arch == "tiny" else TransformerLMConfig()
    lmcfg = dataclasses.replace(
        lmcfg, vocab_size=cfg.vocab_size, pad_id=cfg.pad_id,
        trunk=dataclasses.replace(lmcfg.trunk,
                                  use_pallas_attn=cfg.decoder.use_pallas_attn))
    state, step = restore_model(args.lm_ckpt)
    if state is None:
        raise SystemExit(f"no LM checkpoint found in {args.lm_ckpt}")
    lm = TransformerLM(lmcfg, cfg.compute_dtype)
    lm.load_state_dict(state)
    print(f"fusion LM loaded (step {step}), weight {args.lm_weight}", flush=True)
    return lm.to(device).eval()


def _lexicon(args, dictionary, cfg):
    from ..decode.lexicon import letter_lexicon_decoder

    return letter_lexicon_decoder(args.lexicon, dictionary, blank=cfg.blank_id,
                                  arpa_path=args.lm_path, lm_weight=args.lm_weight,
                                  word_score=args.word_score, beam=args.ctc_beam_size)


def s2t_decoder(args, model, cfg, dictionary, device):
    """A function (wav [B, T], wav_lengths [B]) -> B token-id rows for
    ``--decoder``."""
    from ..decode.asr import ASRDecoder, CTCDecoder, RescoreDecoder

    ensemble = isinstance(model, list)
    if ensemble and args.decoder != "beam":
        raise SystemExit("--ensemble-last requires --decoder beam")
    if args.decoder == "beam":
        lm = load_lm(args, cfg, device) if args.lm_ckpt else None
        dec = ASRDecoder(model, beam_size=args.beam, max_len=args.max_len,
                         ctc_weight=args.ctc_weight, lm=lm, lm_weight=args.lm_weight,
                         device=device)

        def decode_rows(wav, wlen):
            res = dec(wav, wlen)
            toks = res.tokens[:, 0].cpu().numpy()
            lens = res.lengths[:, 0].cpu().numpy()
            return [toks[b, 1 : max(int(lens[b]) - 1, 1)] for b in range(toks.shape[0])]

        return decode_rows
    if args.decoder == "ctc_rescore":
        lexicon = _lexicon(args, dictionary, cfg) if args.lexicon else None
        return RescoreDecoder(model, blank_id=cfg.blank_id, eos_id=cfg.eos_id,
                              pad_id=cfg.pad_id, nbest=args.rescore_nbest,
                              beam=args.ctc_beam_size, topk=args.ctc_topk,
                              ctc_weight=args.ctc_weight, max_len=args.max_len,
                              lexicon=lexicon, device=device)
    lexicon = None
    if args.decoder == "ctc_lexicon":
        if not args.lexicon:
            raise SystemExit("--decoder ctc_lexicon needs --lexicon")
        lexicon = _lexicon(args, dictionary, cfg)
    return CTCDecoder(model, blank_id=cfg.blank_id, lexicon=lexicon, device=device)


def evaluate_s2t(args, model, cfg, dictionary, device) -> dict:
    from ..data.dictionary import letters_to_text
    from ..data.manifests import SpeechToTextDataset
    from ..parallel import distributed as D
    from ..parallel.sharding import shard_decode_batch
    from ..utils.metrics import corpus_bleu, corpus_wer

    if args.labels is None:
        raise SystemExit("--task s2t needs --labels")
    ds = SpeechToTextDataset(manifest=args.manifest, labels=args.labels,
                             dictionary=dictionary, normalize=args.normalize,
                             max_sample_size=args.max_sample_size)
    decode_rows = s2t_decoder(args, model, cfg, dictionary, device)
    n_ranks = D.process_count() if args.data_parallel else 1
    if args.batch_size % n_ranks:
        raise SystemExit(f"--batch-size {args.batch_size} must be a multiple of "
                         f"the {n_ranks} ranks")
    if args.data_parallel:
        log(f"data-parallel decode over {n_ranks} ranks")
    refs, hyps = [], []
    for s in range(0, len(ds), args.batch_size):
        idxs = list(range(s, min(s + args.batch_size, len(ds))))
        items = [ds[i] for i in idxs]
        if args.data_parallel:
            items += [items[-1]] * (args.batch_size - len(items))
        batch = ds.collate(items, cfg.eos_id, cfg.pad_id)
        wav, wlen = batch["wav"], batch["wav_lengths"]
        if args.data_parallel:
            wav, wlen = shard_decode_batch((wav, wlen), None)
        rows = decode_rows(wav, wlen)
        if args.data_parallel:
            gathered = D.gather_objects([np.asarray(r) for r in rows])
            if gathered is None:
                continue
            rows = [r for part in gathered for r in part]
        for b, i in enumerate(idxs):
            hyps.append(letters_to_text(dictionary.string(rows[b])))
            refs.append(letters_to_text(ds.label_lines[i]))
    if not D.is_primary():
        return {"process": D.process_index(), "n_utts": len(ds)}
    scorer = corpus_bleu if args.metric == "bleu" else corpus_wer
    result = {"metric": args.metric, "value": scorer(refs, hyps), "n_utts": len(ds)}
    if args.decoder != "beam":
        result["decoder"] = args.decoder
    if args.results_path:
        for name, lines in (("hyps.txt", hyps), ("refs.txt", refs)):
            with open(os.path.join(args.results_path, name), "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
    return result


def evaluate_s2c(args, model, ds, device) -> dict:
    from ..decode.sid import SIDClassifier

    clf = SIDClassifier(model, device=device)
    correct = 0
    for s in range(0, len(ds), args.batch_size):
        batch = ds.collate([ds[i] for i in range(s, min(s + args.batch_size, len(ds)))])
        pred = clf(batch["wav"], batch["wav_lengths"]).cpu().numpy()
        correct += int((pred == batch["targets"]).sum())
    return {"metric": "accuracy", "value": correct / max(len(ds), 1), "n_utts": len(ds)}


def evaluate_tts(args, model, cfg, dictionary, device) -> dict:
    """t2s / s2s: MCD of the decoded mel against the reference log-mel (the
    host's), the mean focus rate; mels and Griffin-Lim WAVs on request."""
    from ..data.audio import write_wav
    from ..data.manifests import SpeechToSpeechDataset, TextToSpeechDataset
    from ..decode.tts import TTSDecoder
    from ..ops.mel import mel_to_audio
    from ..utils.metrics import mcd

    if args.task == "t2s":
        ds = TextToSpeechDataset(manifest=args.manifest, labels=args.labels,
                                 dictionary=dictionary, spkemb_dir=args.spkemb_dir,
                                 reduction_factor=cfg.reduction_factor,
                                 n_mels=cfg.n_mels, device_mel=False)
    else:
        ds = SpeechToSpeechDataset(manifest=args.manifest, normalize=args.normalize,
                                   reduction_factor=cfg.reduction_factor,
                                   n_mels=cfg.n_mels, device_mel=False)
    tts = TTSDecoder(model, max_frames=args.max_frames, device=device)
    mcds, focus_rates = [], []
    for s in range(0, len(ds), args.batch_size):
        idxs = list(range(s, min(s + args.batch_size, len(ds))))
        items = [ds[i] for i in idxs]
        if args.task == "t2s":
            batch = ds.collate(items, cfg.eos_id, cfg.pad_id)
            out = tts.text_to_speech(batch["tokens"], batch.get("spkembs"))
        else:
            batch = ds.collate(items)
            out = tts.speech_to_speech(batch["wav"], batch["wav_lengths"],
                                       batch["spkembs"])
        mel = out.mel.float().cpu().numpy()
        lens = out.lengths.cpu().numpy()
        focus = None if out.focus_rate is None else out.focus_rate.float().cpu().numpy()
        for b, i in enumerate(idxs):
            hyp_mel = mel[b, : int(lens[b])]
            mcds.append(mcd(items[b]["mel"], hyp_mel))
            if focus is not None:
                focus_rates.append(float(focus[b]))
            if args.results_path:
                np.save(os.path.join(args.results_path, f"{i}.npy"), hyp_mel)
                if args.griffin_lim:
                    wav = mel_to_audio(hyp_mel, n_mels=cfg.n_mels)
                    write_wav(os.path.join(args.results_path, f"{i}.wav"),
                              wav.float().cpu().numpy())
    result = {"metric": "mcd", "value": float(np.mean(mcds)), "n_utts": len(ds)}
    if focus_rates:
        result["focus_rate"] = float(np.mean(focus_rates))
    return result


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.lm_path and not args.lexicon:
        p.error("--lm-path requires --lexicon (the word n-gram LM scores "
                "lexicon words; without a lexicon it would be silently "
                "ignored — for neural-LM beam fusion use --lm-ckpt)")
    if args.data_parallel and args.task != "s2t":
        raise SystemExit("--data-parallel decodes s2t only (JAX shards the s2t decoders only)")
    if args.ensemble_last > 1 and args.task != "s2t":
        raise SystemExit("--ensemble-last is only supported for --task s2t "
                         "(use --avg-last for weight-space averaging instead)")

    from .. import config as C
    from ..data.dictionary import load_cli_dictionary
    from ..data.manifests import SpeechToClassDataset
    from ..models.registry import arch_config
    from ..parallel import distributed as D
    from ..parallel.sharding import shard_decode_variables
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if args.data_parallel and args.distributed_num_processes:
        D.initialize(args.distributed_coordinator, args.distributed_num_processes,
                     args.distributed_process_id, args.distributed_platform, device)
        device = D.local_device(device)
    dictionary, cfg_kw = load_cli_dictionary(args.dict_path, args.vocab_size)
    cfg_kw["dtype"] = args.dtype
    cfg = C.apply_overrides(arch_config(args.arch, **cfg_kw), args.override)
    if args.task == "s2t" and dictionary is None:
        raise SystemExit("--dict is required for --task s2t (hypotheses are "
                         "detokenized through the dictionary)")
    ds = None
    if args.task == "s2c":
        cm_path = os.path.join(args.ckpt, "class_map.txt")
        class_map = (SpeechToClassDataset.load_class_map(cm_path)
                     if os.path.exists(cm_path) else None)
        ds = SpeechToClassDataset(manifest=args.manifest, class_map=class_map,
                                  normalize=args.normalize,
                                  max_sample_size=args.max_sample_size)
        if cfg.sid.num_classes != ds.num_classes:
            cfg = C.replace(cfg, sid=C.replace(cfg.sid, num_classes=ds.num_classes))

    model, note = load_models(args, cfg, device)
    log(note)
    if args.data_parallel:
        for m in model if isinstance(model, list) else [model]:
            shard_decode_variables(m, None)
    if args.results_path:
        os.makedirs(args.results_path, exist_ok=True)

    t0 = time.time()
    with torch.inference_mode():
        if args.task == "s2t":
            result = evaluate_s2t(args, model, cfg, dictionary, device)
        elif args.task == "s2c":
            result = evaluate_s2c(args, model, ds, device)
        else:
            result = evaluate_tts(args, model, cfg, dictionary, device)
    result["wall_s"] = round(time.time() - t0, 2)
    log(json.dumps(result))
    D.shutdown()
    return result


def log(line: str) -> None:
    """Print on rank 0 (every process is rank 0 outside a process group)."""
    from ..parallel import distributed as D

    if D.is_primary():
        print(line, flush=True)


if __name__ == "__main__":
    main()
