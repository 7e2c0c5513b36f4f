"""One rank of the port's multi-process CPU tests (not a test module).

    python tests/torch_parallel_worker.py JOBS.pt RANK WORLD STORE OUT.json

joins a gloo group of WORLD processes through the file store STORE, runs
every job of JOBS.pt (a list of dicts written by the tests) in order and
writes, from rank 0, one entry per job: the list of every rank's result.
It imports torch and the port, never JAX, so a rank starts in seconds.

Jobs (``kind``):
- ``helpers``: ``process_rows``, ``local_rows``, ``unify_batch_shapes`` and
  ``allsum_scalars`` on this rank's inputs;
- ``train``: a tiny model from ``state`` on a ``('data', 'model')`` mesh
  (``n_model``, ``fsdp``), ``Trainer`` updates over this rank's rows of
  each global micro-batch -> per-update loss and grad norm (and the model
  state after them with ``return_state``);
- ``masks``: one ``train`` update with the train kernel's twin recording
  the dropout keep mask of its first call.
With ``draws`` the pretraining draws are those of
tests/test_torch_pretrain.py's ``Draws`` at the global batch's shapes, this
rank's rows of them.
"""

import json
import sys
import time

import numpy as np
import torch


class GlobalDraws:
    """tests/test_torch_pretrain.py's ``Draws`` drawn at the global
    batch's shapes, cut to this rank's rows."""

    def __init__(self, index, n):
        self.index, self.n = index, n

    @staticmethod
    def _rng(kind, *shape):
        return np.random.default_rng([kind, *(int(s) for s in shape)])

    def uniform(self, shape):
        rows, V = shape
        g = self._rng(1, rows * self.n, V).uniform(1e-9, 1.0, (rows * self.n, V))
        return g.astype(np.float32).reshape(self.n, rows, V)[self.index]

    def perm(self, T):
        return self._rng(2, T).permutation(int(T))

    def time_mask(self, B, T):
        g = self._rng(3, B * self.n, T).random((B * self.n, T)) < 0.4
        return g[self.index * B : (self.index + 1) * B]


def install_draws(index, n):
    import speecht5_tpu_torch.models.prenets as PPre
    import speecht5_tpu_torch.models.quantizer as PQmod
    import speecht5_tpu_torch.models.speecht5 as PSmod

    d = GlobalDraws(index, n)

    def pmasks(lengths, T, C, masking, generator=None):
        lengths = torch.as_tensor(lengths)
        tm = torch.from_numpy(d.time_mask(len(lengths), T))
        return tm & (torch.arange(T)[None, :] < lengths[:, None]), None

    PPre.sample_feature_masks = pmasks
    PQmod.gumbel_noise = lambda shape, generator=None, device=None: (
        -torch.log(-torch.log(torch.from_numpy(d.uniform(shape))))).to(device)
    PSmod.codebook_perm = lambda T, generator=None: torch.from_numpy(d.perm(T))


def helpers(job):
    from speecht5_tpu_torch.parallel import distributed as D

    r = D.process_index()
    batch = {"wav": np.ones((2, 5 + 3 * r), np.float32),
             "targets": np.full((2, 4 - r), 7, np.int64)}
    unified = D.unify_batch_shapes(batch, {"targets": 1})
    return {"rows": [D.process_rows(8).start, D.process_rows(8).stop],
            "local_rows": D.local_rows(np.arange(8)).tolist(),
            "unified": {k: v.tolist() for k, v in unified.items()},
            "allsum": D.allsum_scalars({"a": 1.5 + r, "n": 2})}


def train(job, record=None):
    import speecht5_tpu_torch.config as PC
    from speecht5_tpu_torch.models.speecht5 import init_model
    from speecht5_tpu_torch.parallel import distributed as D
    from speecht5_tpu_torch.parallel.sharding import make_mesh
    from speecht5_tpu_torch.train.trainer import Trainer, TrainConfig
    from speecht5_tpu_torch.utils.checkpoint import model_state

    cfg = PC.apply_overrides(PC.speecht5_tiny(**job["cfg_kw"]), job["overrides"])
    model = init_model(cfg, device="cpu")
    model.load_state_dict(job["state"])
    mesh = make_mesh(n_model=job.get("n_model", 1), device_type="cpu")
    index, n = D.data_coords(mesh)
    if job.get("draws"):
        install_draws(index, n)
    trainer = Trainer(model, job["tasks"], TrainConfig(**job["tcfg"]), mesh=mesh,
                      fsdp=job.get("fsdp", False), layer_seed=job.get("layer_seed", 0))
    out = {"loss": [], "grad_norm": []}
    for task, micro in job["updates"]:
        rows = D.process_rows(len(next(iter(micro[0].values()))), mesh)
        m = trainer.train_step([{k: torch.from_numpy(np.asarray(v)[rows])
                                 for k, v in mb.items()} for mb in micro], task)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out.setdefault("metrics", []).append({k: float(v) for k, v in m.items()})
    if record is not None:
        out["mask"] = record[0].numpy().tolist()
    if job.get("return_state"):
        out["state"] = {k: v.numpy().tolist() for k, v in model_state(model).items()}
    return out


def masks(job):
    from speecht5_tpu_torch.ops import cuda_kernels as K

    record, plain = [], K.dropout_keep_plain

    def spy(*args, **kw):
        keep = plain(*args, **kw)
        record.append(keep)
        return keep

    K.dropout_keep_plain = spy
    try:
        return train(job, record)
    finally:
        K.dropout_keep_plain = plain


def child_env():
    """The CPU tests' hermetic child environment (conftest), one thread a
    rank so that two ranks do not contend for the cores."""
    from conftest import cpu_subprocess_env

    return {**cpu_subprocess_env(), "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}


# a launch's bound: well under the suite's time limit, so that a stuck rank
# fails its test instead of ending the run
LAUNCH_S = 240


def launch(argv_of_rank, world, timeout=LAUNCH_S, cwd=None):
    """Start ``world`` processes (``argv_of_rank(rank)``), wait for all of
    them for ``timeout`` seconds in all, kill the rest when one fails or the
    time runs out -> their outputs; raise on a non-zero exit."""
    import subprocess

    procs = [subprocess.Popen(argv_of_rank(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=child_env(),
                              cwd=cwd) for r in range(world)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def run_jobs(tmp_path, jobs, world=2, timeout=LAUNCH_S):
    """Run ``jobs`` on ``world`` gloo ranks -> per job, every rank's result."""
    import os

    path, out = tmp_path / "jobs.pt", tmp_path / "results.json"
    torch.save(jobs, path)
    launch(lambda r: [sys.executable, os.path.abspath(__file__), str(path), str(r),
                      str(world), str(tmp_path / "store"), str(out)], world, timeout)
    with open(out, encoding="utf-8") as f:
        return json.load(f)


def main():
    jobs_path, rank, world, store, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    from speecht5_tpu_torch.parallel import distributed as D

    D.initialize(f"file://{store}", int(world), int(rank), "cpu", "cpu")
    jobs = torch.load(jobs_path, weights_only=False)
    run = {"helpers": helpers, "train": train, "masks": masks}
    results = [D.gather_objects(run[job["kind"]](job)) for job in jobs]
    if D.is_primary():
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(results, f)
    D.barrier()


if __name__ == "__main__":
    main()
