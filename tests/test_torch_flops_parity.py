"""The port's FLOP counts (``utils/flops.py``) and checkpoint-day sweep
(``cli/parity.py``) held against the JAX package.

Every count equals JAX's for the tiny, Base ASR and Large presets (each
package's own config of the preset); the peak is one H100's dense bf16
989e12 FLOP/s, and no environment variable moves it.  The sweep's dry run
at the tiny preset on the CPU gives the records and summary JAX's harness
gives when its evaluate returns the same WERs.  The two faults of the JAX
harness that the port repairs (ROADMAP C.2) each have a test: the decoder
arms drop every LM flag, and every ``MATRIX`` row's arch resolves or the
row is skipped as an unported family.
"""

import json
import math

import pytest

import speecht5_tpu.cli.evaluate as JEval
import speecht5_tpu.cli.parity as JPar
import speecht5_tpu.config as JC
import speecht5_tpu.utils.flops as JF
import speecht5_tpu_torch.cli.evaluate as PEval
import speecht5_tpu_torch.cli.parity as PPar
import speecht5_tpu_torch.config as PC
import speecht5_tpu_torch.utils.flops as PF

PRESETS = ["speecht5_tiny", "speecht5_base_asr", "speecht5_large"]


@pytest.mark.parametrize("preset", PRESETS)
def test_flop_counts_equal_jax(preset):
    jc, pc = getattr(JC, preset)(vocab_size=81), getattr(PC, preset)(vocab_size=81)
    for B, T_wav in ((1, 48000), (4, 160000), (16, 256000)):
        assert PF.conv_frontend_flops(pc, B, T_wav) == JF.conv_frontend_flops(jc, B, T_wav)
        T = pc.conv_features.out_length(T_wav)
        assert PF.encoder_flops(pc.encoder, B, T) == JF.encoder_flops(jc.encoder, B, T)
        for L in (16, 192):
            assert PF.decoder_teacher_flops(pc.decoder, B, L, T) == \
                JF.decoder_teacher_flops(jc.decoder, B, L, T)
            for mult in (2.0, 1.5):
                assert PF.s2t_train_flops(pc, B, T_wav, L, mult) == \
                    JF.s2t_train_flops(jc, B, T_wav, L, mult)
        for beam, steps, ctc in ((5, 200, True), (2, 8, False)):
            assert PF.asr_decode_flops(pc, B, beam, T_wav, steps, ctc) == \
                JF.asr_decode_flops(jc, B, beam, T_wav, steps, ctc)
    for args in ((2, 7, 9, 64, False, True), (3, 1, 50, 768, True, False)):
        assert PF.attention_flops(*args) == JF.attention_flops(*args)
    assert PF.ffn_flops(2, 5, 768, 3072) == JF.ffn_flops(2, 5, 768, 3072)
    assert PF.s2t_train_flops(pc, 16, 256000, 192) > 0


def test_mfu_divides_by_the_h100_bf16_peak(monkeypatch):
    monkeypatch.setenv("SPEECHT5_TPU_PEAK_FLOPS", "1e12")
    assert PF.chip_peak_flops() == 989e12
    assert PF.mfu(989e12, 1.0) == 1.0 and PF.mfu(989e12, 4.0) == 0.25
    assert JF.chip_peak_flops() == 1e12          # JAX's reads the variable; the port's not


def _stub_evaluate(values, calls):
    """An evaluate ``main`` that records its argv and returns the WER of
    its ``--decoder`` from ``values``."""
    def main(argv):
        calls.append(list(argv))
        dec = argv[argv.index("--decoder") + 1] if "--decoder" in argv else "beam"
        return {"metric": "wer", "value": values[dec], "n_utts": 4}
    return main


def test_dry_run_gives_jax_records_and_summary(tmp_path, monkeypatch, capsys):
    """The port's dry run at the tiny preset on the CPU (random init, the
    three evaluate runs for real); then JAX's harness over the same
    fixtures with its evaluate returning the port's WERs (and its fixture
    maker, which inits a JAX model, not called): the same records and
    summary."""
    ckpt, data = str(tmp_path / "ckpt"), str(tmp_path / "data")
    values, real = {}, PEval.main

    def recording(argv):
        res = real(argv)
        dec = argv[argv.index("--decoder") + 1] if "--decoder" in argv else "beam"
        values[dec] = res["value"]
        return res
    monkeypatch.setattr(PEval, "main", recording)
    records = PPar.main(["--ckpt-dir", ckpt, "--data-dir", data, "--dry-run", "--device", "cpu",
                         "--results", str(tmp_path / "p.json"), "--batch-size", "4"])
    assert len(records) == 1 and records[0]["status"] == "report_only"
    assert set(values) == {"beam", "ctc_greedy", "ctc_rescore"}
    assert all(math.isfinite(v) and v >= 0 for v in values.values())
    calls = []
    monkeypatch.setattr(JEval, "main", _stub_evaluate(values, calls))
    monkeypatch.setattr(JPar, "_make_dry_fixtures", lambda args: None)
    jrecords = JPar.main(["--ckpt-dir", ckpt, "--data-dir", data, "--dry-run",
                          "--results", str(tmp_path / "j.json"), "--batch-size", "4"])
    assert len(calls) == 3
    assert records == jrecords
    p, j = (json.loads((tmp_path / f"{s}.json").read_text()) for s in "pj")
    assert p == j and p["summary"]["report_only"] == 1


LM_ROW = {
    "name": "lm_row", "ckpt": "m.pt", "arch": "speecht5_base_asr", "task": "s2t",
    "dict": "dict.ltr.txt", "manifest": "t.tsv", "labels": "t.ltr",
    "extra": ["--beam", "5", "--lm-ckpt", "{ckpt_dir}/lm", "--lm-weight", "0.7", "--lm-arch",
              "t5", "--lexicon", "lex.txt", "--lm-path", "lm.arpa", "--word-score", "1.5",
              "--max-len", "620"],
    "published": ("wer", 0.1), "tol": 0.01, "source": "test",
}


def _argvs(parity, evaluate, row, tmp_path, monkeypatch, extra=()):
    import argparse

    for name in ("m.pt", "dict.ltr.txt", "t.tsv", "t.ltr"):
        (tmp_path / name).write_text("x")
    (tmp_path / "work" / "m").mkdir(parents=True, exist_ok=True)
    calls = []
    monkeypatch.setattr(evaluate, "main", _stub_evaluate(
        {"beam": 0.1, "ctc_greedy": 0.2, "ctc_rescore": 0.15}, calls))
    args = argparse.Namespace(ckpt_dir=str(tmp_path), data_dir=str(tmp_path),
                              work_dir=str(tmp_path / "work"), batch_size=8, arms=True,
                              device="cpu", dtype="float32", override=list(extra))
    rec = parity.run_row(row, args)
    return rec, calls


def test_arms_drop_every_lm_flag(tmp_path, monkeypatch):
    """C.2 repair: JAX's arms drop --lm-ckpt/--lm-weight/--lm-arch but keep
    --lexicon, --lm-path and --word-score, so a lexicon arm would load the
    word LM at weight 0; the port's arms drop all six with their values."""
    rec, calls = _argvs(PPar, PEval, LM_ROW, tmp_path, monkeypatch)
    jrec, jcalls = _argvs(JPar, JEval, LM_ROW, tmp_path, monkeypatch)
    assert rec["status"] == jrec["status"] == "ok" and rec["arms"] == jrec["arms"]
    beam, arms = calls[0], calls[1:]
    assert "--lm-path" in beam and "--lexicon" in beam and len(arms) == 2
    lm_values = {"lex.txt", "lm.arpa", "1.5", "0.7", "t5", f"{tmp_path}/lm"}
    for argv, jargv in zip(arms, jcalls[1:]):
        assert not set(argv) & (set(PPar.LM_FLAGS) | lm_values)
        assert "--lexicon" in jargv and "--lm-path" in jargv and "--word-score" in jargv
        i, j = argv.index("--device"), argv.index("--dtype")
        assert argv[i + 1] == "cpu" and argv[j + 1] == "float32" and j == i + 2
        # the port's evaluate flags aside, the JAX arm's argv without the LM flags
        assert argv[:i] + argv[j + 2:] == PPar.arm_argv(jargv)
        assert argv[-2:] == jargv[-2:] == ["--decoder", argv[-1]] and "--max-len" in argv


def test_every_matrix_arch_resolves_or_is_an_unported_family(tmp_path, monkeypatch):
    """C.2 repair: JAX's MATRIX names speecht5_base_st/_vc/_tts (no config
    has them) and speech2c_base (models/speech2c.py, not config), so
    evaluate's getattr(C, arch) would raise on those rows.  The port's rows
    resolve to its presets at the dictionary's vocabulary, and since the
    family is ported no row is skipped as unported: speech2c_base resolves
    through ``models/registry`` to a ``Speech2CModel``, and its row runs
    convert -> evaluate like the others."""
    from speecht5_tpu_torch.models.registry import arch_config, init_for_arch
    from speecht5_tpu_torch.models.speech2c import Speech2CModel

    unresolved = sorted(r["arch"] for r in JPar.MATRIX if not hasattr(JC, r["arch"]))
    assert unresolved == ["speech2c_base", "speecht5_base_st", "speecht5_base_tts",
                          "speecht5_base_vc"]
    assert [r["name"] for r in PPar.MATRIX] == [r["name"] for r in JPar.MATRIX]
    assert PPar.UNPORTED_FAMILIES == {}
    for row in PPar.MATRIX:
        cfg = arch_config(row["arch"], vocab_size=81, blank_id=80)
        assert cfg.vocab_size == 81
    (row,) = [r for r in PPar.MATRIX if r.get("family") == "speech2c"]
    rec, calls = _argvs(PPar, PEval, {**row, "ckpt": "m.pt", "manifest": "t.tsv",
                                      "labels": "t.ltr"}, tmp_path, monkeypatch)
    assert not rec["status"].startswith("skipped") and rec["ours"] == 0.1
    assert calls and "speech2c_base" in calls[0]
    tiny = arch_config("speech2c_base", vocab_size=81, blank_id=80,
                       encoder=PC.TransformerConfig(num_layers=1),
                       decoder=PC.TransformerConfig(num_layers=1, use_rel_pos_bias=False))
    assert isinstance(init_for_arch("speech2c_base", tiny, device="cpu"), Speech2CModel)
