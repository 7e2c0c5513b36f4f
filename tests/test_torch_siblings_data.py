"""The sibling families' data layer in the port, held bit for bit against
the JAX package: ``data/multitask.MultitaskLoader`` (the schedule for
every seed, epoch and resume point), ``data/multicorpus.MultiCorpusLoader``
(the epoch plan: streams, batch order, the merged speech streams, the grid
rounding and inner-bucket shuffle, and the collated joint batches, resumed
at a step) for 3 seeds x 2 epochs, and Speech2C's decoder targets of
``SpeechPretrainDataset(add_decoder_target=True)`` (pretraining and
``fine_tuning``, bucketed and not)."""

import numpy as np
import pytest

from speecht5_tpu.data import manifests as JMan
from speecht5_tpu.data import multicorpus as JMC
from speecht5_tpu.data import multitask as JMT

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.config import speecht5_tiny
from speecht5_tpu_torch.data import manifests as PMan
from speecht5_tpu_torch.data import multicorpus as PMC
from speecht5_tpu_torch.data import multitask as PMT

SEEDS, EPOCHS = (1, 7, 123), (0, 1)


class ListDataset:
    def __init__(self, items, sizes=None):
        self.items = items
        self.sizes = sizes

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _ids(items):
    return {"ids": np.stack([np.asarray(i) for i in items])}


def _corpora():
    rng = np.random.default_rng(0)
    return {
        "speech_a": (ListDataset([np.full(1, i) for i in range(40)]), rng.integers(80, 320, 40)),
        "speech_b": (ListDataset([np.full(1, 500 + i) for i in range(17)]),
                     rng.integers(100, 200, 17)),
        "text_mono": (ListDataset([np.full(1, 1000 + i) for i in range(60)]),
                      rng.integers(8, 32, 60)),
        "text_paired": (ListDataset([np.full(1, 2000 + i) for i in range(25)]),
                        rng.integers(5, 20, 25)),
    }


def _loader(mod, seed, **kw):
    ratios = {"speech_a": 0.3, "speech_b": 0.15, "text_mono": 0.4, "text_paired": 0.15}
    mt = {"speech_a": 1.0, "speech_b": 1.0, "text_mono": 0.1, "text_paired": 0.07}
    specs = [mod.TokenCorpusSpec(name, ds, _ids, sizes, sample_ratio=ratios[name],
                                 max_tokens_ratio=mt[name])
             for name, (ds, sizes) in _corpora().items()]
    return mod.MultiCorpusLoader(specs, max_tokens=1200, seed=seed, **kw)


@pytest.mark.parametrize("kw", [{}, {"batch_size_grid": None, "inner_bucket": 3},
                                {"max_sentences": 5}])
def test_multicorpus_plan_and_batches_bit_equal_to_jax(kw):
    for seed in SEEDS:
        j, p = _loader(JMC, seed, **kw), _loader(PMC, seed, **kw)
        for epoch in EPOCHS:
            js, jn = j.epoch_plan(epoch)
            ps, pn = p.epoch_plan(epoch)
            assert jn == pn and sorted(js) == sorted(ps)
            assert sorted(ps) == ["speech", "text_mono", "text_paired"]
            for name in js:
                assert [s.name for s, _ in js[name]] == [s.name for s, _ in ps[name]]
                for (_, a), (_, b) in zip(js[name], ps[name]):
                    np.testing.assert_array_equal(a, b)
            # the speech stream merges both speech corpora
            assert {s.name for s, _ in ps["speech"]} == {"speech_a", "speech_b"}
            start = pn // 2
            jit = list(j.iter_epoch(epoch, start_step=start))
            pit = list(p.iter_epoch(epoch, start_step=start))
            assert [s for s, _ in pit] == list(range(start, pn))
            for (_, a), (_, b) in zip(jit, pit):
                assert sorted(a) == sorted(b)
                for name in a:
                    np.testing.assert_array_equal(a[name]["ids"], b[name]["ids"])
            assert p.steps_per_epoch(epoch) == pn


def test_grid_floor_and_inner_bucket_shuffle_bit_equal_to_jax():
    for n in (0, 1, 3, 5, 7, 100, 300):
        assert PMC._grid_floor(n, PMC.BATCH_SIZE_GRID) == JMC._grid_floor(n, JMC.BATCH_SIZE_GRID)
    assert PMC.BATCH_SIZE_GRID == JMC.BATCH_SIZE_GRID
    batches = [np.arange(i * 10, i * 10 + k) for i, k in enumerate([4, 4, 2, 6, 3, 8, 1])]
    for bucket in (1, 3, 10):
        a = JMC._inner_bucket_shuffle(batches, np.random.default_rng(3), bucket)
        b = PMC._inner_bucket_shuffle(batches, np.random.default_rng(3), bucket)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_multitask_schedule_bit_equal_to_jax():
    corpora = _corpora()
    for seed in SEEDS:
        loaders = []
        for mod in (JMT, PMT):
            specs = [mod.TaskSpec(name, ListDataset(ds.items, sizes), _ids, max_tokens=600,
                                  sample_ratio=r)
                     for (name, (ds, sizes)), r in zip(corpora.items(), (1.0, 2.5, 0.5, 1.0))]
            loaders.append(mod.MultitaskLoader(specs, seed=seed, max_sentences=6))
        j, p = loaders
        assert len(j) == len(p)
        for epoch in EPOCHS:
            for (si, a), (sj, b) in zip(j.epoch_schedule(epoch), p.epoch_schedule(epoch)):
                assert si == sj
                np.testing.assert_array_equal(a, b)
            start = len(p) // 3
            ja = list(j.iter_epoch(epoch, start_batch=start))
            pa = list(p.iter_epoch(epoch, start_batch=start))
            assert len(pa) == len(p) - start
            for (n1, b1), (n2, b2) in zip(ja, pa):
                assert n1 == n2
                np.testing.assert_array_equal(b1["ids"], b2["ids"])


def test_speech2c_decoder_targets_collate_bit_equal_to_jax(tmp_path):
    """Speech2C's code targets: km labels cut to the frames, collapsed by
    unique-consecutive (or frame-level with ``fine_tuning``), +4, EOS,
    padded to a token bucket (or not), the EOS-shifted prev, the lengths."""
    d = str(tmp_path)
    manifest, _, _ = chip_smoke.write_corpus(d, 5, seconds=(0.3, 0.9), seed=2)
    rng = np.random.default_rng(2)
    with open(manifest, encoding="utf-8") as f:
        sizes = [int(l.split("\t")[1]) for l in f.read().splitlines()[1:] if l]
    km = tmp_path / "train.km"
    # runs of repeated labels, so the collapse has work to do
    km.write_text("".join(" ".join(map(str, np.repeat(rng.integers(0, 16, n // 640 + 1),
                                                      rng.integers(1, 4, n // 640 + 1))
                                       [: n * 50 // 16000])) + "\n" for n in sizes))
    frames = speecht5_tiny().conv_features.out_length
    for fine_tuning in (False, True):
        kw = dict(manifest=manifest, km_labels=str(km), n_mels=20, device_mel=True,
                  add_decoder_target=True, fine_tuning=fine_tuning)
        j, p = JMan.SpeechPretrainDataset(**kw), PMan.SpeechPretrainDataset(**kw)
        for bucketed in (True, False):
            jb = j.collate([j[i] for i in range(5)], frames, bucketed=bucketed)
            pb = p.collate([p[i] for i in range(5)], frames, bucketed=bucketed)
            assert set(jb) == set(pb) and "decoder_targets" in pb
            for k in jb:
                np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
        assert (pb["prev_tokens"][:, 0] == 2).all()
    # pretraining collapses repeats: its targets are shorter than fine-tuning's
    p = PMan.SpeechPretrainDataset(manifest=manifest, km_labels=str(km), n_mels=20,
                                   device_mel=True, add_decoder_target=True)
    short = p.collate([p[i] for i in range(5)], frames, bucketed=False)
    assert (short["decoder_target_lengths"] < pb["decoder_target_lengths"]).all()
