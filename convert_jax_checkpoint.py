#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (``speecht5_tpu``, orbax) into a
model-only checkpoint of the PyTorch port (``speecht5_tpu_torch``).

    python convert_jax_checkpoint.py --ckpt jax_ckpt/ --arch speecht5_base_asr \\
        --dict dict.ltr.txt --out torch_ckpt/ [--step N]

It restores the weights item of the newest (or ``--step``) checkpoint that
the JAX trainer or converter wrote (``CheckpointManager.restore_model``
against ``init_model``'s template), flattens ``params`` and
``batch_stats``, carries them into the port's layouts with
``speecht5_tpu_torch.utils.convert.from_jax_params`` /
``from_jax_batch_stats`` and writes ``<out>/checkpoint_<step>.pt`` with
``utils/checkpoint.save_model_only``: what ``cli/train.py
--finetune-from`` and ``cli/serve.py --ckpt`` of the port read.

It imports JAX, flax and orbax, so it runs where the JAX package runs (the
port and its card machine have none of them), and lives outside the port
package, which never imports JAX.  Sub-nets the port does not have yet
(``PORTED_SUBTREES``) are left out and listed.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="the JAX package's orbax checkpoint dir")
    p.add_argument("--arch", default="speecht5_base_asr")
    p.add_argument("--dict", dest="dict_path", default=None)
    p.add_argument("--vocab-size", type=int, default=None)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", required=True, help="the port's checkpoint dir")
    args = p.parse_args(argv)

    import jax
    import numpy as np
    from flax.traverse_util import flatten_dict

    from speecht5_tpu import config as C
    from speecht5_tpu.data.dictionary import load_cli_dictionary
    from speecht5_tpu.models.speecht5 import init_model
    from speecht5_tpu.utils.checkpoint import CheckpointManager
    from speecht5_tpu_torch.utils.checkpoint import save_model_only
    from speecht5_tpu_torch.utils.convert import (PORTED_SUBTREES, from_jax_batch_stats,
                                                  from_jax_params)

    _, cfg_kw = load_cli_dictionary(args.dict_path, args.vocab_size)
    cfg = getattr(C, args.arch)(**cfg_kw)
    _, template = init_model(cfg, jax.random.PRNGKey(0))
    restored, step = CheckpointManager(args.ckpt).restore_model(template, step=args.step)
    if restored is None:
        raise SystemExit(f"no checkpoint in {args.ckpt}")
    flat = lambda tree: {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}
    params = flat(restored["params"])
    state = from_jax_params(params)
    if "batch_stats" in restored:
        state.update(from_jax_batch_stats(flat(restored["batch_stats"])))
    left_out = sorted({k.split("/")[0] for k in params} - set(PORTED_SUBTREES))
    path = save_model_only(args.out, state, step=int(step))
    print(json.dumps({"out": str(path), "step": int(step), "tensors": len(state),
                      "left_out": left_out}), flush=True)
    return path


if __name__ == "__main__":
    main()
