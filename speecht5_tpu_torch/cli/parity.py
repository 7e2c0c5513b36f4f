"""Turnkey released-checkpoint parity harness: the checkpoint-day sweep
(the port's copy of ``speecht5_tpu/cli/parity.py``).

The moment the released checkpoints are at hand, reproducing the
BASELINE.md table is ONE command (the --dry-run mode proves the whole
convert->evaluate->diff plumbing on random-init fixtures).  Evaluation runs
on the card unless ``--device cpu``; ``--dtype`` and ``--override`` go to
every ``cli/evaluate.py`` run (``--override encoder.use_pallas_attn=True``
and the like turn the kernels on).

    python -m speecht5_tpu_torch.cli.parity --ckpt-dir ckpts/ --data-dir data/ \
        [--rows speecht5_base_asr,...] [--results out.json]
    python -m speecht5_tpu_torch.cli.parity --ckpt-dir /tmp/c --data-dir /tmp/d \
        --dry-run [--dry-run-arch speecht5_base_asr] [--device cpu]

Expected artifact layout (skipped rows report what is missing):
    ckpt-dir/speecht5_base_asr.pt      released fairseq checkpoints
    ckpt-dir/speecht5_vc.pt            (SpeechT5/README.md model zoo)
    ckpt-dir/speech2c_100h.pt ...
    data-dir/dict.ltr.txt              fine-tune dictionaries
    data-dir/test_clean.tsv/.ltr       LibriSpeech eval manifests
    data-dir/arctic_bdl_slt.tsv ...    per-row manifests (see MATRIX)

Each row: convert (cli.convert) -> evaluate (cli.evaluate) -> diff against
the published number (BASELINE.md; tolerance per row).  Rows whose metric
upstream publishes only as MOS/CMOS run report-only.  Two faults of the
JAX harness are repaired here (ROADMAP C.2): its ST, VC and TTS rows name
presets no config defines (here: ``speecht5_base`` at the dictionary's
vocabulary), and its speech2c row names a preset outside ``config`` (here:
``models/registry`` resolves it to ``models/speech2c.py``); its decoder-arm
sweep kept the lexicon and word LM flags while dropping their weight
(here the arms drop every LM flag).
"""

from __future__ import annotations

import argparse
import json
import os

# One declarative row per BASELINE.md anchor.  fields:
#   ckpt: released .pt filename   arch/task/dict/manifest/labels: eval wiring
#   extra: additional evaluate argv
#   published: (metric_name, value) from BASELINE.md   tol: |ours - pub| gate
#   report_only: no published machine-checkable number (MOS rows)
#   family: a model family the port does not have yet (UNPORTED_FAMILIES)
MATRIX = [
    {
        "name": "speecht5_base_asr_test_clean",
        "ckpt": "speecht5_base_asr.pt", "arch": "speecht5_base_asr",
        "task": "s2t", "dict": "dict.ltr.txt",
        "manifest": "test_clean.tsv", "labels": "test_clean.ltr",
        "extra": ["--beam", "5", "--ctc-weight", "0.3", "--max-len", "620"],
        "published": ("wer", 0.044), "tol": 0.004,
        "source": "README.md:113-130 (4.4 test-clean, no LM)",
    },
    {
        "name": "speecht5_base_asr_test_other",
        "ckpt": "speecht5_base_asr.pt", "arch": "speecht5_base_asr",
        "task": "s2t", "dict": "dict.ltr.txt",
        "manifest": "test_other.tsv", "labels": "test_other.ltr",
        "extra": ["--beam", "5", "--ctc-weight", "0.3", "--max-len", "620"],
        "published": ("wer", 0.104), "tol": 0.006,
        "source": "README.md:113-130 (10.4 test-other, no LM)",
    },
    {
        "name": "speecht5_base_asr_test_clean_lm",
        "ckpt": "speecht5_base_asr.pt", "arch": "speecht5_base_asr",
        "task": "s2t", "dict": "dict.ltr.txt",
        "manifest": "test_clean.tsv", "labels": "test_clean.ltr",
        "extra": ["--beam", "30", "--ctc-weight", "0.3", "--max-len", "620",
                  "--lm-ckpt", "{ckpt_dir}/lm_converted", "--lm-weight", "0.7"],
        "requires": ["lm_converted"],
        "published": ("wer", 0.024), "tol": 0.004,
        "source": "README.md:127-130 (2.4 test-clean, +LM)",
    },
    {
        "name": "speecht5_st_mustc_ende",
        "ckpt": "speecht5_st_ende.pt", "arch": "speecht5_base",
        "task": "s2t", "dict": "dict.spm.txt",
        "manifest": "mustc_ende_tst.tsv", "labels": "mustc_ende_tst.spm",
        "extra": ["--beam", "5", "--metric", "bleu", "--max-len", "512"],
        "published": ("bleu", 25.18), "tol": 0.5,
        "source": "README.md:143-155 (MuST-C EN-DE)",
    },
    {
        "name": "speecht5_vc_bdl_slt",
        "ckpt": "speecht5_vc.pt", "arch": "speecht5_base",
        "task": "s2s", "dict": None,
        "manifest": "arctic_bdl_slt.tsv", "labels": None,
        "extra": [],
        "published": ("mcd", 5.93), "tol": 0.2,
        "source": "README.md:157-171 (VC MCD bdl->slt)",
    },
    {
        "name": "speecht5_sid_voxceleb1",
        "ckpt": "speecht5_sid.pt", "arch": "speecht5_base_sid",
        "task": "s2c", "dict": None,
        "manifest": "voxceleb1_test.tsv", "labels": None,
        "extra": [],
        "published": ("accuracy", 0.9649), "tol": 0.005,
        "source": "README.md:186-208 (SID VoxCeleb1)",
    },
    {
        "name": "speech2c_100h_test_clean",
        "ckpt": "speech2c_100h.pt", "arch": "speech2c_base", "family": "speech2c",
        "task": "s2t", "dict": "dict.ltr.txt",
        "manifest": "test_clean.tsv", "labels": "test_clean.ltr",
        "extra": ["--beam", "5", "--ctc-weight", "0.3", "--max-len", "620"],
        "published": ("wer", 0.043), "tol": 0.004,
        "source": "Speech2C/README.md:108-124 (4.3 test-clean, no LM)",
    },
    {
        "name": "speecht5_tts_mel_dump",
        "ckpt": "speecht5_tts.pt", "arch": "speecht5_base",
        "task": "t2s", "dict": "dict.txt",
        "manifest": "libritts_test.tsv", "labels": "libritts_test.txt",
        "extra": [],
        "published": ("mcd", None), "tol": None, "report_only": True,
        "source": "README.md:132-141 (MOS/CMOS only; MCD reported for trend)",
    },
]


# families whose model the port lacks, and the ROADMAP item that ports them
# (none since Speech2C arrived: its preset resolves through
# ``models/registry``)
UNPORTED_FAMILIES = {}
# evaluate flags of the fusion LM and the lexicon decoder's word LM, each
# with its value: the decoder-arm sweep runs without them
LM_FLAGS = ("--lm-ckpt", "--lm-weight", "--lm-arch", "--lm-path", "--lexicon",
            "--word-score")


def arm_argv(argv):
    """``argv`` without the LM flags and their values (LM_FLAGS)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in LM_FLAGS:
            skip = True
        else:
            out.append(a)
    return out


def run_row(row, args):
    """convert (once per ckpt) + evaluate; returns the result record."""
    from .convert import main as convert_main
    from .evaluate import main as eval_main

    if row.get("family") in UNPORTED_FAMILIES:
        return {"row": row["name"], "status": "skipped_unported_family",
                "family": row["family"], "ported_by": UNPORTED_FAMILIES[row["family"]]}
    ckpt_pt = os.path.join(args.ckpt_dir, row["ckpt"])
    missing = []
    if not os.path.exists(ckpt_pt):
        missing.append(ckpt_pt)
    data = lambda f: os.path.join(args.data_dir, f) if f else None
    for f in (row["manifest"], row["labels"], row["dict"]):
        if f and not os.path.exists(data(f)):
            missing.append(data(f))
    for req in row.get("requires", []):
        p = req.format(ckpt_dir=args.ckpt_dir) if "{" in req else os.path.join(
            args.ckpt_dir, req)
        if not os.path.exists(p):
            missing.append(p)
    if missing:
        return {"row": row["name"], "status": "skipped_missing_artifacts",
                "missing": missing}

    out_dir = os.path.join(args.work_dir, row["ckpt"].replace(".pt", ""))
    if not os.path.exists(out_dir):
        argv = ["--pt", ckpt_pt, "--arch", row["arch"], "--out", out_dir]
        if row["dict"]:
            argv += ["--dict", data(row["dict"])]
        convert_main(argv)

    argv = ["--task", row["task"], "--arch", row["arch"],
            "--manifest", data(row["manifest"]), "--ckpt", out_dir,
            "--batch-size", str(args.batch_size), "--device", args.device,
            "--dtype", args.dtype, *[a for ov in args.override for a in ("--override", ov)]]
    if row["labels"]:
        argv += ["--labels", data(row["labels"])]
    if row["dict"]:
        argv += ["--dict", data(row["dict"])]
    argv += [a.format(ckpt_dir=args.ckpt_dir) for a in row["extra"]]
    result = eval_main(argv)

    metric, published = row["published"]
    rec = {"row": row["name"], "status": "ok", "metric": metric,
           "ours": result["value"], "published": published,
           "source": row["source"]}

    # operating-point sweep (ASR rows): the fast decode arms next to the
    # joint beam, so checkpoint day gives a quality-speed frontier in one
    # command; the arms run without any LM
    if args.arms and row["task"] == "s2t" and metric == "wer":
        base = arm_argv(argv)
        rec["arms"] = {}
        for arm in ("ctc_greedy", "ctc_rescore"):
            arm_res = eval_main(base + ["--decoder", arm])
            rec["arms"][arm] = {
                "wer": arm_res["value"],
                "delta_vs_beam": round(arm_res["value"] - result["value"], 5),
            }
    if row.get("report_only") or published is None:
        rec["status"] = "report_only"
    else:
        delta = abs(result["value"] - published)
        rec["delta"] = round(delta, 5)
        rec["pass"] = bool(delta <= row["tol"])
        if not rec["pass"]:
            rec["status"] = "regression"
    return rec


def _make_dry_fixtures(args):
    """Random-init fixtures at --dry-run-arch + synthetic manifests: proves the full
    convert->evaluate->diff plumbing without released artifacts."""
    import numpy as np

    from ..data.audio import write_wav

    os.makedirs(args.ckpt_dir, exist_ok=True)
    os.makedirs(args.data_dir, exist_ok=True)
    root = os.path.join(args.data_dir, "audio")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        wav = 0.1 * rng.standard_normal(4000).astype(np.float32)
        write_wav(os.path.join(root, f"u{i}.wav"), wav)
        rows.append(f"u{i}.wav\t4000")
    with open(os.path.join(args.data_dir, "test_clean.tsv"), "w") as f:
        f.write(root + "\n" + "\n".join(rows) + "\n")
    with open(os.path.join(args.data_dir, "test_clean.ltr"), "w") as f:
        f.write("\n".join(["H I |"] * 4) + "\n")
    with open(os.path.join(args.data_dir, "dict.ltr.txt"), "w") as f:
        f.write("| 1\nH 1\nI 1\n")

    # a random-init model (seed 0) saved model-only as an ALREADY-CONVERTED
    # checkpoint in work_dir (run_row skips cli.convert when the converted
    # dir exists; the converters are held by tests/test_torch_convert.py)
    # + a marker .pt so the artifact check passes
    import torch

    from .. import config as C
    from ..data.dictionary import load_cli_dictionary
    from ..models.speecht5 import init_model
    from ..utils.checkpoint import save_model_only

    _, cfg_kw = load_cli_dictionary(
        os.path.join(args.data_dir, "dict.ltr.txt"), None)
    cfg = getattr(C, args.dry_run_arch)(**cfg_kw)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    save_model_only(os.path.join(args.work_dir, "speecht5_base_asr"), model.state_dict(), 0)
    with open(os.path.join(args.ckpt_dir, "speecht5_base_asr.pt"), "wb") as f:
        f.write(b"dry-run marker; converted checkpoint pre-populated\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt-dir", required=True,
                   help="released .pt checkpoints (model zoo layout above)")
    p.add_argument("--data-dir", required=True,
                   help="dictionaries + eval manifests")
    p.add_argument("--work-dir", default=None,
                   help="converted-checkpoint cache (default ckpt-dir/converted)")
    p.add_argument("--rows", default=None,
                   help="comma-separated row names (default: all)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--results", default=None, help="write JSON records here")
    p.add_argument("--dry-run", action="store_true",
                   help="generate random-init fixtures + synthetic manifests "
                        "in --ckpt-dir/--data-dir and run the ASR row: "
                        "validates the plumbing end to end")
    p.add_argument("--dry-run-arch", default="speecht5_tiny",
                   help="arch preset for --dry-run fixtures; pass "
                        "'speecht5_base_asr' to exercise the whole "
                        "convert->evaluate->diff chain at the released "
                        "geometry")
    p.add_argument("--arms", dest="arms", action="store_true", default=True,
                   help="ASR rows also run ctc_greedy/ctc_rescore and "
                        "report the WER delta vs the joint beam (the "
                        "quality-speed frontier in one command)")
    p.add_argument("--no-arms", dest="arms", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="torch device of every evaluate run; the CPU only when asked for")
    p.add_argument("--dtype", default="float32", help="evaluate's --dtype")
    p.add_argument("--override", action="append", default=[],
                   help="evaluate's config override, dotted path = literal, repeatable")
    return p


def main(argv=None):
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)     # no card: raise before any fixture is made
    args.work_dir = args.work_dir or os.path.join(args.ckpt_dir, "converted")
    os.makedirs(args.work_dir, exist_ok=True)

    matrix = MATRIX
    if args.dry_run:
        _make_dry_fixtures(args)
        matrix = [dict(MATRIX[0])]
        matrix[0]["arch"] = args.dry_run_arch
        matrix[0]["extra"] = ["--beam", "2", "--ctc-weight", "0.3",
                              "--max-len", "8"]
        matrix[0]["published"] = ("wer", None)
        matrix[0]["report_only"] = True
    if args.rows:
        want = set(args.rows.split(","))
        matrix = [r for r in matrix if r["name"] in want]

    records = []
    for row in matrix:
        rec = run_row(row, args)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    n_pass = sum(1 for r in records if r.get("pass"))
    n_fail = sum(1 for r in records if r.get("status") == "regression")
    n_skip = sum(1 for r in records if r["status"].startswith("skipped_"))
    summary = {"rows": len(records), "pass": n_pass, "regressions": n_fail,
               "skipped": n_skip,
               "report_only": sum(1 for r in records
                                  if r["status"] == "report_only")}
    print(json.dumps({"summary": summary}), flush=True)
    if args.results:
        with open(args.results, "w") as f:
            json.dump({"records": records, "summary": summary}, f, indent=1)
    return records


if __name__ == "__main__":
    main()
