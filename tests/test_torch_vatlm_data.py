"""VATLM's data layer in the port, held bit for bit against the JAX
package: ``data/video.py`` (the crops and flip from an explicit
generator, the train and eval transforms, YUV4MPEG2 written and read in
both chroma layouts, ``load_video`` on ``.npy`` and ``.y4m``) and
``data/vatlm.py`` (``stack_frames``, ``audio_fbank``, the AV manifest,
``VATLMDataset`` items over two epochs of train-time augmentation, every
modality subset, and ``collate`` padded or cropped)."""

import numpy as np
import pytest

from speecht5_tpu.data import vatlm as JD
from speecht5_tpu.data import video as JVid

import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.data import vatlm as PD
from speecht5_tpu_torch.data import video as PVid
from speecht5_tpu_torch.data.audio import write_wav


def _frames(seed=0, t=5, h=24, w=20):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w)).astype(np.uint8)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_video_transforms_bit_equal_to_jax(seed):
    f = _frames(seed).astype(np.float32)
    _equal(PVid.center_crop(f, (16, 12)), JVid.center_crop(f, (16, 12)))
    for fn, args in ((PVid.random_crop, ((16, 12),)), (PVid.horizontal_flip, (0.5,))):
        got = fn(f, *args, np.random.default_rng(seed))
        want = getattr(JVid, fn.__name__)(f, *args, np.random.default_rng(seed))
        _equal(got, want)
    _equal(PVid.train_transform(f, np.random.default_rng(seed), 16),
           JVid.train_transform(f, np.random.default_rng(seed), 16))
    _equal(PVid.eval_transform(f, 16, 0.5, 0.2), JVid.eval_transform(f, 16, 0.5, 0.2))
    with pytest.raises(ValueError):
        PVid.center_crop(f, (32, 12))


@pytest.mark.parametrize("chroma", ["mono", "420jpeg", "444"])
def test_y4m_round_trip_and_load_video_equal_jax(tmp_path, chroma):
    frames = _frames(4, t=6, h=16, w=12)
    PVid.write_y4m(str(tmp_path / "p.y4m"), frames, chroma)
    JVid.write_y4m(str(tmp_path / "j.y4m"), frames, chroma)
    assert (tmp_path / "p.y4m").read_bytes() == (tmp_path / "j.y4m").read_bytes()
    got = PVid.read_y4m(str(tmp_path / "j.y4m"))
    _equal(got, frames)
    _equal(PVid.read_y4m(str(tmp_path / "p.y4m"), max_frames=4),
           JVid.read_y4m(str(tmp_path / "p.y4m"), max_frames=4))
    _equal(PVid.load_video(str(tmp_path / "p.y4m")), JVid.load_video(str(tmp_path / "p.y4m")))
    np.save(str(tmp_path / "v.npy"), frames[..., None])
    _equal(PVid.load_video(str(tmp_path / "v.npy")), JVid.load_video(str(tmp_path / "v.npy")))
    (tmp_path / "bad.y4m").write_bytes(b"NOTY4M W4 H4\n")
    for mod in (PVid, JVid):
        with pytest.raises(ValueError, match="not a YUV4MPEG2"):
            mod.read_y4m(str(tmp_path / "bad.y4m"))


def test_stacking_and_fbank_equal_jax():
    x = np.random.default_rng(0).standard_normal((13, 3)).astype(np.float32)
    for order in (1, 4, 5):
        _equal(PD.stack_frames(x, order), JD.stack_frames(x, order))
    wav = np.random.default_rng(1).standard_normal(16000).astype(np.float32) * 0.1
    fb = PD.audio_fbank(wav)
    _equal(fb, JD.audio_fbank(wav))
    assert fb.shape == (26, 104)


@pytest.fixture
def corpus(tmp_path):
    """4 AV utterances: 16 kHz wav, raw 0-255 lip ROIs (``.npy`` with and
    without the channel axis, and ``.y4m``), 2 km streams at 25 Hz."""
    rng = np.random.default_rng(0)
    lines, labs = [str(tmp_path)], ([], [])
    for i, tv in enumerate([10, 14, 6, 9]):
        n = tv * 640 + (0 if i % 2 else 300)     # audio a little longer on some rows
        write_wav(str(tmp_path / f"u{i}.wav"), rng.standard_normal(n) * 0.1)
        video = rng.integers(0, 256, (tv, 24, 24)).astype(np.uint8)
        if i == 3:
            PVid.write_y4m(str(tmp_path / f"u{i}.y4m"), video, "420jpeg")
            vname = f"u{i}.y4m"
        else:
            np.save(str(tmp_path / f"u{i}.npy"),
                    video[..., None].astype(np.float32) if i == 1 else video)
            vname = f"u{i}.npy"
        lines.append(f"u{i}\t{vname}\tu{i}.wav\t{n}\textra")
        for lab in labs:
            lab.append(" ".join(str(x) for x in rng.integers(0, 20, tv)))
    (tmp_path / "train.tsv").write_text("\n".join(lines) + "\n")
    for k, lab in enumerate(labs):
        (tmp_path / f"train.km{k}").write_text("\n".join(lab) + "\n")
    return tmp_path


def _datasets(corpus, **kw):
    args = dict(label_paths=[str(corpus / "train.km0"), str(corpus / "train.km1")],
                image_crop_size=16, **kw)
    return (JD.VATLMDataset(str(corpus / "train.tsv"), **args),
            PD.VATLMDataset(str(corpus / "train.tsv"), **args))


def _same_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            _equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(image_aug=True), dict(image_aug=False), dict(image_transform=False),
    dict(modalities=("audio",), normalize=False), dict(modalities=("video",), image_aug=True)])
def test_vatlm_dataset_items_and_collate_bit_equal_to_jax(corpus, kw):
    """Items over two epochs (``set_epoch`` reseeds the crop and flip),
    then ``collate``: padded to the batch, and cropped to 8 frames at
    random starts from one generator seed."""
    jds, pds = _datasets(corpus, **kw)
    assert pds.root == jds.root and pds.rows == jds.rows
    _equal(pds.sizes, jds.sizes)
    by_epoch = []
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        ji, pi = [jds[i] for i in range(len(jds))], [pds[i] for i in range(len(pds))]
        for a, b in zip(ji, pi):
            _same_items(a, b)
        by_epoch.append(pi)
        for kwc in ({}, dict(max_frames=8, random_crop=True)):
            jb = jds.collate(ji, rng=np.random.default_rng(3), **kwc)
            pb = pds.collate(pi, rng=np.random.default_rng(3), **kwc)
            assert jb.keys() == pb.keys()
            for k in jb:
                if k == "targets":
                    for x, y in zip(jb[k], pb[k]):
                        _equal(x, y)
                elif jb[k] is None:
                    assert pb[k] is None
                else:
                    _equal(jb[k], pb[k])
    if kw.get("image_aug") and "video" in kw.get("modalities", ("video",)):
        assert any(not np.array_equal(a["video"], b["video"]) for a, b in zip(*by_epoch))
