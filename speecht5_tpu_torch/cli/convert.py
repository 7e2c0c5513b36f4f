"""Convert a released SpeechT5 checkpoint into a model-only port checkpoint
(``<out>/checkpoint_0.pt``) for ``cli/train.py --finetune-from`` and
``cli/serve.py --ckpt`` (port of ``speecht5_tpu/cli/convert.py``).

Two source formats:
  fairseq -- the original ``.pt`` files (read without fairseq or omegaconf,
             ``utils/convert.load_fairseq_checkpoint``); the model's
             geometry is ``--arch`` at the dictionary's vocabulary;
  hf      -- a transformers checkpoint directory (``config.json`` and
             ``pytorch_model.bin``; the geometry comes from its config), or
             a bare ``pytorch_model.bin`` state-dict file (``--arch``).

Usage:
    python -m speecht5_tpu_torch.cli.convert --pt speecht5_base.pt \\
        --arch speecht5_base_asr --dict dict.ltr.txt --out ckpt/pretrained

    python -m speecht5_tpu_torch.cli.convert --format hf --pt ./speecht5_asr/ \\
        --out ckpt/converted

Every key of the model is written: a key the source lacks, or whose shape
differs from the model's (a text head at another vocabulary size), keeps
the initial value of a model seeded 0, as ``--finetune-from`` would.
Unknown keys, missing keys and shape mismatches are printed; ``--strict``
makes any of them an error.

WavLLM's pretrained components convert one at a time with ``--component
wavlm|whisper|llama`` (``utils/convert_components.py``) from an HF
directory (``config.json`` and ``pytorch_model.bin``) or a bare
state-dict file; the checkpoint holds the component's keys as they sit in
``models/wavllm.WavLLMModel`` (WavLM under ``wavlm.``, Whisper under
``whisper.``, LLaMA at the top level), for ``utils/checkpoint.
partial_load`` into it.  A bare LLaMA file needs ``--llama-heads`` (the
RoPE un-permutation needs the head count):

    python -m speecht5_tpu_torch.cli.convert --format hf --component wavlm \
        --pt ./wavlm-base-plus/ --out ckpt/wavlm

Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pt", required=True,
                   help="fairseq .pt checkpoint, or HF model dir / state-dict file")
    p.add_argument("--format", choices=("fairseq", "hf"), default="fairseq")
    p.add_argument("--component", choices=("wavlm", "whisper", "llama"), default=None,
                   help="convert one of WavLLM's pretrained components (HF layout) "
                        "instead of a SpeechT5 checkpoint")
    p.add_argument("--llama-heads", type=int, default=None,
                   help="attention heads of --component llama from a bare "
                        "state-dict file")
    p.add_argument("--arch", default="speecht5_base_asr",
                   help="config preset (fairseq, or a bare HF state-dict file)")
    p.add_argument("--dict", dest="dict_path", default=None)
    p.add_argument("--vocab-size", type=int, default=None)
    p.add_argument("--out", required=True, help="port checkpoint dir")
    p.add_argument("--strict", action="store_true",
                   help="fail on any unknown or missing key or shape mismatch")
    return p


def convert_component(path: str, component: str, llama_heads=None) -> tuple:
    """One WavLLM component -> (its keys as they sit in ``WavLLMModel``,
    unknown keys)."""
    import torch

    from ..utils import convert_components as cc
    from ..utils.convert_hf import read_hf_dir

    if os.path.isdir(path):
        hf_cfg, sd = read_hf_dir(path)
    else:                                       # a bare state-dict file
        hf_cfg, sd = None, torch.load(path, map_location="cpu", weights_only=True)
    if component == "wavlm":
        state, unknown = cc.convert_wavlm_state_dict(sd)
        state = {f"wavlm.{k}": v for k, v in state.items()}
    elif component == "whisper":
        state, unknown = cc.convert_whisper_encoder_state_dict(sd)
        state = {f"whisper.{k}": v for k, v in state.items()}
    else:
        heads = llama_heads or (hf_cfg or {}).get("num_attention_heads")
        if not heads:
            raise SystemExit("--llama-heads is required to convert a bare LLaMA "
                             "state-dict file (the RoPE un-permutation needs the "
                             "head count)")
        state, unknown = cc.convert_llama_state_dict(sd, num_heads=heads)
    return state, unknown


def main(argv=None):
    """Returns the report {"unknown_keys", "missing", "shape_mismatches",
    "checkpoint"} ({"unknown_keys", "checkpoint", "component"} with
    ``--component``)."""
    import torch

    from ..data.dictionary import load_cli_dictionary
    from ..models.registry import arch_config, init_for_arch
    from ..utils.checkpoint import partial_load, save_model_only
    from ..utils.convert import load_fairseq_checkpoint
    from ..utils.convert_hf import convert_hf_state_dict, load_hf_checkpoint

    args = build_parser().parse_args(argv)
    if args.component is not None:
        state, unknown = convert_component(args.pt, args.component, args.llama_heads)
        if args.strict and unknown:
            raise SystemExit(json.dumps({"unknown_keys": unknown}, indent=2))
        path = save_model_only(args.out, state, step=0)
        print(json.dumps({"out": args.out, "component": args.component,
                          "n_converted": len(state), "n_unknown": len(unknown),
                          "unknown_keys": unknown[:20]}), flush=True)
        return {"unknown_keys": unknown, "checkpoint": str(path), "component": args.component}
    _, cfg_kw = load_cli_dictionary(args.dict_path, args.vocab_size)
    cfg = None
    if args.format == "hf":
        if os.path.isdir(args.pt):
            cfg, converted, unknown = load_hf_checkpoint(args.pt)
        else:
            sd = torch.load(args.pt, map_location="cpu", weights_only=True)
            converted, unknown = convert_hf_state_dict(sd)
    else:
        converted, _, unknown = load_fairseq_checkpoint(args.pt)
    if cfg is None:
        cfg = arch_config(args.arch, **cfg_kw)

    model = init_for_arch(args.arch, cfg, torch.Generator().manual_seed(0), "cpu")
    target = model.state_dict()
    missing = sorted(set(target) - set(converted))
    extra = sorted(set(converted) - set(target))
    mism = sorted(k for k in set(target) & set(converted)
                  if tuple(target[k].shape) != tuple(converted[k].shape))
    report = {"unknown_keys": unknown + extra, "missing": missing,
              "shape_mismatches": mism}
    if args.strict and (report["unknown_keys"] or missing or mism):
        raise SystemExit(json.dumps(report, indent=2))
    path = save_model_only(args.out, partial_load(target, converted), step=0)
    report["checkpoint"] = str(path)
    print(json.dumps({"out": args.out, "n_converted": len(converted) - len(extra),
                      "n_unknown": len(report["unknown_keys"]),
                      "n_missing": len(missing), "n_mismatched": len(mism),
                      **{k: v[:20] for k, v in report.items()
                         if k != "checkpoint" and v}}), flush=True)
    return report


if __name__ == "__main__":
    main()
