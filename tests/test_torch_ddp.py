"""The port's trainer across processes held against JAX's ``Trainer`` on
the conftest's 8-device CPU mesh: the same global batch of 8 rows, 3
updates, the port as 2 gloo ranks of 4 rows each (children started with the
conftest's hermetic environment, one launch per case started by its test,
rendezvous through a file store in ``tmp_path``).  Losses and grad norms
must agree within 1e-4 relative for

- s2t (CTC + CE, 2 micro-batches an update), whose label lengths differ
  between the two halves of the batch, so a per-rank mean would fail;
- t2s (the speech postnet's BatchNorm over the global batch, the guided
  attention loss);
- pretrain_speech (the Gumbel quantizer's code probabilities averaged over
  the global B x T; masks, Gumbel noise and codebook permutation handed to
  both packages as tests/test_torch_pretrain.py hands them);
- s2t under ``fsdp=True`` (port: ``fully_shard``);

and within 2e-3 (JAX's own tolerance for tensor parallelism,
tests/test_distributed.py:106-113) for s2t at ``n_model`` 2 (port mesh 1 x
2, JAX 4 x 2), also with ``fsdp=True`` (port mesh 2 x 2 on 4 ranks: FSDP
over tensor parallelism, against the same JAX run; the losses; the grad norms against JAX's 8 x 1 run, since
JAX's 4 x 2 mesh gets the pos conv's gradients wrong, ROADMAP C.2).  With
attention dropout on, the train kernel's twin keys each row's mask by its
global (batch x head) row: the two data ranks draw the one-process run's
rows, the two model ranks different masks.  One encoder
and one decoder layer keep JAX's compiles short; dropout, layerdrop and
masking are off except where stated.
"""

import numpy as np
import pytest

import jax
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
import speecht5_tpu.models.prenets as JPre
import speecht5_tpu.models.quantizer as JQmod
import speecht5_tpu.models.speecht5 as JSmod
from speecht5_tpu.models.speecht5 import init_model as jinit_model
from speecht5_tpu.parallel.sharding import make_mesh as jax_mesh
from speecht5_tpu.train import trainer as JT

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.train import trainer as PT
from speecht5_tpu_torch.utils.convert import from_jax_batch_stats, from_jax_params

from test_torch_large import LARGE_SHAPED
from test_torch_pretrain import Draws, _JaxProxy
from torch_parallel_worker import run_jobs

B, T_WAV, UPDATES = 8, 4000, 3
RTOL, RTOL_TP = 1e-4, 2e-3
STILL = ["encoder.num_layers=1", "decoder.num_layers=1", "encoder.layerdrop=0.0",
         "decoder.layerdrop=0.0", "speech_prenet.dropout=0.0",
         "speech_postnet.postnet_dropout=0.0"]
S2T = STILL + ["masking.mask_prob=0.0"]
PRETRAIN = LARGE_SHAPED + STILL
TCFG = dict(lr=1e-4, warmup_steps=2, clip_norm=5.0, adam_eps=1e-4)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def s2t_batch(seed):
    """8 rows; the first half's labels 8 tokens long, the second half's 2-4."""
    rng = np.random.default_rng(seed)
    lens = np.array([4000, 3800, 3500, 3000, 2600, 4000, 2200, 3300], np.int32)
    wav = (rng.standard_normal((B, T_WAV)) * 0.1).astype(np.float32)
    wav[np.arange(T_WAV)[None, :] >= lens[:, None]] = 0.0
    n_tok = np.array([8, 8, 7, 8, 2, 4, 3, 2])
    tgt = np.full((B, 9), 1)
    prev = np.full((B, 9), 1)
    for b, n in enumerate(n_tok):
        toks = rng.integers(4, 79, n)
        tgt[b, :n], tgt[b, n] = toks, 2
        prev[b, 0], prev[b, 1 : n + 1] = 2, toks
    return {"wav": wav, "wav_lengths": lens, "prev_tokens": prev, "targets": tgt}


def t2s_batch(cfg, seed):
    """Host mels: 8 rows of up to 12 frames (r 2), ragged texts."""
    rng = np.random.default_rng(seed)
    n_tok = np.array([9, 7, 9, 5, 3, 8, 4, 6])
    tokens = np.full((B, 10), cfg.pad_id)
    for b, n in enumerate(n_tok):
        tokens[b, :n], tokens[b, n] = rng.integers(4, 79, n), cfg.eos_id
    dec = np.array([12, 10, 12, 8, 6, 12, 4, 10], np.int32)
    target = (rng.standard_normal((B, 12, cfg.n_mels)) - 4.0).astype(np.float32)
    target[np.arange(12)[None, :] >= dec[:, None]] = 0.0
    prev = np.zeros((B, 6, cfg.n_mels), np.float32)
    prev[:, 1:] = target[:, 1::2][:, :-1]
    prev[np.arange(6)[None, :] >= (dec // 2)[:, None]] = 0.0
    return {"tokens": tokens, "target_mel": target, "prev_mel": prev, "dec_lengths": dec,
            "dec_lengths_r": dec // 2,
            "spkembs": rng.standard_normal((B, cfg.spk_embed_dim)).astype(np.float32)}


def pretrain_batch(cfg, seed):
    b = s2t_batch(seed)
    t = t2s_batch(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    frames = int(cfg.conv_features.out_length(T_WAV))
    return {"wav": b["wav"], "wav_lengths": b["wav_lengths"],
            "km_labels": rng.integers(0, cfg.hubert.num_classes[0], (B, frames)),
            **{k: t[k] for k in ("target_mel", "prev_mel", "dec_lengths",
                                 "dec_lengths_r", "spkembs")}}


CASES = {
    # name: (task, overrides, tcfg extras, micro-batches an update, mesh, fsdp)
    "s2t": ("s2t", S2T, dict(ctc_weight=0.5, accum_steps=2), 2, (8, 1), False),
    "t2s": ("t2s", STILL, dict(use_guided_attn=True), 1, (8, 1), False),
    "pretrain_speech": ("pretrain_speech", PRETRAIN, {}, 1, (8, 1), False),
    "s2t_fsdp": ("s2t", S2T, dict(ctc_weight=0.5, accum_steps=2), 2, (8, 1), True),
    "s2t_tp": ("s2t", S2T, dict(ctc_weight=0.5, accum_steps=2), 2, (4, 2), False),
    "s2t_fsdp_tp": ("s2t", S2T, dict(ctc_weight=0.5, accum_steps=2), 2, (4, 2), True),
}
# the cases run on 4 ranks (a 2 x 2 port mesh); the others on 2
FOUR_RANKS = ("s2t_fsdp_tp",)
# cases held against another case's JAX run: JAX's own tests hold its
# FSDP placement to its plain one (tests/test_distributed.py:93-101)
JAX_AS = {"s2t_fsdp_tp": "s2t_tp"}


def _updates(name, cfg):
    task, _, _, accum, _, _ = CASES[name]
    make = {"s2t": lambda s: s2t_batch(s), "t2s": lambda s: t2s_batch(cfg, s),
            "pretrain_speech": lambda s: pretrain_batch(cfg, s)}[task]
    return [[make(10 * u + m) for m in range(accum)] for u in range(UPDATES)]


def _jax_run(name):
    """JAX's Trainer on the 8-device mesh -> (losses, grad norms), and the
    port's job."""
    task, overrides, extra, accum, (n_data, n_model), fsdp = CASES[name]
    cfg = JC.apply_overrides(JC.speecht5_tiny(**chip_smoke.DICT_CFG), overrides)
    jm, variables = jinit_model(cfg, jax.random.PRNGKey(0), wav_len=T_WAV)
    updates = _updates(name, cfg)
    trainer = JT.Trainer(jm, variables, task, JT.TrainConfig(**TCFG, **extra),
                         mesh=jax_mesh(n_data, n_model), fsdp=fsdp)
    losses, norms = [], []
    for micro in updates:
        batch = (micro[0] if accum == 1 else
                 {k: np.stack([mb[k] for mb in micro]) for k in micro[0]})
        m = trainer.train_step(batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    state = {**from_jax_params(_flat(variables["params"])),
             **from_jax_batch_stats(_flat(variables.get("batch_stats", {})))}
    job = {"kind": "train", "cfg_kw": chip_smoke.DICT_CFG, "overrides": overrides,
           "state": state, "tasks": [task], "tcfg": {**TCFG, **extra},
           "updates": [(task, micro) for micro in updates], "fsdp": fsdp,
           "n_model": n_model, "draws": task == "pretrain_speech"}
    return {"loss": losses, "grad_norm": norms}, job


def _mask_job(n_model):
    cfg = PC.speecht5_tiny(**chip_smoke.DICT_CFG)
    model = init_model(PC.apply_overrides(cfg, S2T), torch.Generator().manual_seed(3), "cpu")
    return {"kind": "masks", "cfg_kw": chip_smoke.DICT_CFG, "overrides": MASK_OVERRIDES,
            "state": model.state_dict(), "tasks": ["s2t"], "tcfg": dict(TCFG),
            "updates": [("s2t", [s2t_batch(0)])], "n_model": n_model}


MASK_OVERRIDES = S2T + ["encoder.attention_dropout=0.1",
                        "encoder.use_pallas_attn_train=True"]


_JAX = {}      # JAX's results and the port's job, by case


def _jax_case(name):
    """JAX's results and the port's job for ``name`` (computed once; the
    pretraining case with the draws handed to JAX)."""
    if name in JAX_AS:
        want, job = _jax_case(JAX_AS[name])
        return want, {**job, "fsdp": CASES[name][5]}
    if name not in _JAX:
        with pytest.MonkeyPatch.context() as mp:
            d = Draws()

            def jmasks(rng, x, lengths, mask_emb, **kw):
                import jax.numpy as jnp

                Bx, T, _ = x.shape
                tm = jnp.asarray(d.time_mask(Bx, T)) & (jnp.arange(T)[None, :]
                                                        < lengths[:, None])
                return jnp.where(tm[:, :, None], mask_emb.astype(x.dtype)[None, None, :],
                                 x), tm

            mp.setattr(JPre, "apply_feature_masks", jmasks)
            mp.setattr(JQmod, "jax", _JaxProxy(
                uniform=lambda key, shape, minval=0.0, maxval=1.0, **kw:
                jax.numpy.asarray(d.uniform(shape))))
            mp.setattr(JSmod, "jax", _JaxProxy(
                permutation=lambda key, n, **kw: jax.numpy.asarray(d.perm(n))))
            _JAX[name] = _jax_run(name)
    return _JAX[name]


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_jax_global_batch(tmp_path, name):
    """Each case's ranks are started by its own case (``run_jobs``, bounded
    by ``LAUNCH_S``).  Under tensor parallelism the grad norm is held
    against JAX's data parallel run of the same batches: JAX's 4 x 2 mesh
    gives the weight-norm pos conv other gradients than its 8 x 1 mesh
    (ROADMAP C.2), while its losses agree with both."""
    want, job = _jax_case(name)
    (got,) = run_jobs(tmp_path, [job], world=4 if name in FOUR_RANKS else 2)
    rtol = RTOL_TP if name.endswith("_tp") else RTOL
    assert len(got) == (4 if name in FOUR_RANKS else 2)
    for rank in got:            # every rank reports the global metrics
        for key in ("loss", "grad_norm"):
            ref = _jax_case("s2t")[0] if key == "grad_norm" and name.endswith("_tp") else want
            np.testing.assert_allclose(rank[key], ref[key], rtol=rtol,
                                       err_msg=f"{name} {key}")
    assert len(want["loss"]) == UPDATES


def test_a_per_rank_mean_would_differ_from_the_global_batch():
    """The s2t batch's halves hold 31 and 11 target tokens: the mean of the
    two halves' mean losses is not the global mean, so the s2t case tells
    the two apart."""
    tgt = s2t_batch(0)["targets"]
    counts = [(tgt[h * 4:(h + 1) * 4] != 1).sum() for h in range(2)]
    assert counts[0] != counts[1]


def test_dropout_masks_are_the_global_rows_and_differ_across_model_ranks(tmp_path):
    """Data ranks: each rank's first train-kernel keep mask is its rows of
    the one-process run's (the same layer generator draws the seed, the
    row offset places the rows); model ranks: the two halves of the heads
    draw different masks."""
    got = dict(zip(("masks_dp", "masks_tp"),
                   run_jobs(tmp_path, [_mask_job(1), _mask_job(2)])))
    record, plain = [], K.dropout_keep_plain

    def spy(*args, **kw):
        keep = plain(*args, **kw)
        record.append(keep)
        return keep

    job = _mask_job(1)
    model = init_model(PC.apply_overrides(PC.speecht5_tiny(**chip_smoke.DICT_CFG),
                                          MASK_OVERRIDES), device="cpu")
    model.load_state_dict(job["state"])
    trainer = PT.Trainer(model, "s2t", PT.TrainConfig(**TCFG))
    K.dropout_keep_plain = spy
    try:
        trainer.train_step([{k: torch.from_numpy(v) for k, v in s2t_batch(0).items()}])
    finally:
        K.dropout_keep_plain = plain
    one = record[0].numpy()
    ranks = [np.asarray(r["mask"]) for r in got["masks_dp"]]
    n = one.shape[0] // 2
    assert one.shape[0] == B * 4 and 0.8 < one.mean() < 0.99
    np.testing.assert_array_equal(np.concatenate(ranks), one)
    assert ranks[0].shape[0] == n
    tp = [np.asarray(r["mask"]) for r in got["masks_tp"]]
    assert tp[0].shape == tp[1].shape == (B * 2,) + one.shape[1:]
    assert (tp[0] != tp[1]).mean() > 0.05
