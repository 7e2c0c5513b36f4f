"""Activation checkpointing (``remat``) in the port: it changes which
activations are kept and no number.

The JAX package wraps each encoder and decoder layer in ``nn.remat``
(speecht5_tpu/models/encoder.py:51-56, decoder.py:37-40); the port wraps
each layer call of a training forward in ``torch.utils.checkpoint``.  At
the tiny preset in f32, with dropout, attention dropout, activation
dropout and (in some cases) layerdrop on, and the train-attention route
(``use_pallas_attn_train``: the kernel's twin on the CPU, with its
counter-hash dropout seeded from the CPU generator) on and off,
``forward_s2t``'s outputs and every parameter's gradient with
``encoder.remat`` and ``decoder.remat`` equal those without, to 0: the
recompute runs the same CPU operations on the same inputs, the
checkpoint restores the global RNG state of the dropout draws, and the
train kernel's seed is drawn once, before the checkpointed call.  A
forward-call counter shows each layer that ran running twice under
backward, and once in an evaluation forward.
"""

import numpy as np
import pytest
import torch

import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.models.speecht5 import init_model

torch.backends.cuda.matmul.allow_tf32 = False
B, T_WAV, L = 2, 4000, 6
DROPOUTS = [f"{s}.{f}=0.1" for s in ("encoder", "decoder")
            for f in ("dropout", "attention_dropout", "activation_dropout")]


def _model(remat: bool, pallas_train: bool, layerdrop: float):
    cfg = PC.apply_overrides(PC.speecht5_tiny(), DROPOUTS + [
        f"encoder.remat={remat}", f"decoder.remat={remat}",
        f"encoder.use_pallas_attn_train={pallas_train}",
        f"encoder.layerdrop={layerdrop}"])
    return init_model(cfg, torch.Generator().manual_seed(0), "cpu").train()


def _batch():
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((B, T_WAV)) * 0.1).astype(np.float32))
    lens = torch.tensor([T_WAV, 2600], dtype=torch.int32)
    prev = torch.from_numpy(rng.integers(4, 30, (B, L)))
    return wav, lens, prev


def _count_layer_calls(model):
    counts = {}
    layers = [("encoder", i, m) for i, m in enumerate(model.encoder.layers)]
    layers += [("decoder", i, m) for i, m in enumerate(model.decoder.layers)]
    for stack, i, m in layers:
        key = f"{stack}.{i}"
        counts[key] = 0

        # a pre-hook: the recompute stops once it has what backward needs,
        # before a forward hook would fire
        def hook(module, args, key=key):
            counts[key] += 1
        m.register_forward_pre_hook(hook)
    return counts


def _run(remat: bool, pallas_train: bool, layerdrop: float):
    """forward_s2t with HuBERT masking, a scalar of both heads, backward ->
    (outputs, {name: grad}, layer calls)."""
    model = _model(remat, pallas_train, layerdrop)
    counts = _count_layer_calls(model)
    wav, lens, prev = _batch()
    torch.manual_seed(1)
    g = torch.Generator().manual_seed(2)
    logits, ctc, valid = model.forward_s2t(wav, lens, prev, mask=True, generator=g)
    loss = (logits.float().square().mean() + ctc.float().square().mean()
            + logits.float()[..., 5].sum() * 0.1)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return (logits.detach(), ctc.detach(), valid), grads, counts


@pytest.mark.parametrize("layerdrop", [0.0, 0.5])
@pytest.mark.parametrize("pallas_train", [False, True])
def test_remat_gradients_equal_and_layers_recompute(pallas_train, layerdrop):
    (lo, co, vo), g_off, n_off = _run(False, pallas_train, layerdrop)
    (lr, cr, vr), g_on, n_on = _run(True, pallas_train, layerdrop)
    assert torch.equal(lo, lr) and torch.equal(co, cr) and torch.equal(vo, vr)
    assert g_off.keys() == g_on.keys() and len(g_off) > 0
    for name in g_off:
        assert torch.equal(g_off[name], g_on[name]), name
    # every layer that ran once without remat ran twice with it
    assert all(n_off[k] in (0, 1) for k in n_off), n_off
    assert {k: 2 * v for k, v in n_off.items()} == n_on
    assert all(n_off[f"decoder.{i}"] == 1 for i in range(2))
    if layerdrop == 0.0:
        assert all(v == 2 for v in n_on.values()), n_on


def test_remat_seed_is_drawn_once_per_layer_run():
    """The train kernel's dropout seed comes from the CPU generator once per
    encoder layer run, remat or not: the generator ends in the same state,
    and the attention dropout is on (the seed is not 0)."""
    ends = []
    for remat in (False, True):
        model = _model(remat, True, 0.0)
        wav, lens, prev = _batch()
        torch.manual_seed(1)
        g = torch.Generator().manual_seed(2)
        logits, ctc, _ = model.forward_s2t(wav, lens, prev, mask=True, generator=g)
        (logits.float().sum() + ctc.float().sum()).backward()
        ends.append(g.get_state())
    assert torch.equal(ends[0], ends[1])
    attn = _model(False, True, 0.0).encoder.layers[0].self_attn
    assert attn.train_seed(torch.zeros(16, 4, 4), 4, torch.Generator()) is not None
    assert attn.eval().train_seed(torch.zeros(16, 4, 4), 4) is None


def test_remat_does_not_checkpoint_outside_training():
    """An evaluation forward runs each layer once (decode steps call
    ``DecoderLayer.step``, outside the checkpointed loop)."""
    model = _model(True, True, 0.0).eval()
    counts = _count_layer_calls(model)
    wav, lens, prev = _batch()
    model.forward_s2t(wav, lens, prev, mask=False)
    assert all(v == 1 for v in counts.values()), counts
