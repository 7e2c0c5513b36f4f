"""The CPU rehearsal of ``chip_smoke.py``'s parallel train, evaluate and
wrapper phases (29-30) at the tiny preset, in a file of its own so that
``--dist loadfile`` runs it on a worker of its own (moved from
tests/test_torch_hygiene.py, names kept)."""

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)


def test_chip_smoke_parallel_phases_run_on_cpu_with_twins(tmp_path):
    """Phases 29-30 at the tiny preset on the CPU: the parallel train
    modes of the fixed table as spawned gloo ranks against the one-process
    run, data-parallel evaluate against the one-process
    evaluate, and the wrapper's cost at world size 1 (gloo here: NCCL needs
    the card)."""
    from conftest import cpu_subprocess_env

    env = {**cpu_subprocess_env(), "OMP_NUM_THREADS": "1"}
    out = chip_smoke.phase_parallel_train(device="cpu", arch="speecht5_tiny",
                                          seconds=(0.3, 0.6), env=env)
    assert set(out["modes"]) == {"dp", "fsdp", "tp"}
    assert out["modes"]["tp"]["mesh"] == {"data": 1, "model": 2}
    trained = chip_smoke.phase_train(str(tmp_path), "speecht5_tiny", device="cpu", n_utts=4,
                                     updates=1, seconds=(0.3, 0.6),
                                     flags=["--batch-size", "2", "--ctc-weight", "0.5"])
    ev = chip_smoke.phase_parallel_evaluate(str(tmp_path), device="cpu", arch="speecht5_tiny",
                                            seconds=0.5, max_len=8, dtype="float32", env=env)
    assert ev["hypotheses_equal"] and ev["n_utts"] == 8
    wrap = chip_smoke.phase_parallel_wrapper(trained["args"], str(tmp_path), device="cpu",
                                             mode=("dp_gloo", 1, "gloo", []), env=env)
    assert wrap["losses_wrapped"] == wrap["losses_one_process"]
    assert len(wrap["update_ms_wrapped"]) == 2
