"""The multi-process runtime (port of ``speecht5_tpu/parallel/distributed.py``).

The reference trains SpeechT5 with multi-node DDP at
``--distributed-world-size 32`` over NCCL (SURVEY.md §2.8).  The JAX
package joins every host into one global device view and lets ``jit`` see
one global array.  The port follows the torch idiom instead: one process
per card, joined by ``torch.distributed``; each rank holds local tensors.

What the JAX functions become here:

- ``initialize``: ``init_process_group``.  The coordinator is the store's
  address (``host:port``, or a ``file://`` path); ``platform`` picks the
  backend (``cpu`` / ``gloo``: gloo, ``nccl`` / ``cuda`` / ``gpu``: NCCL, none:
  NCCL when the device is a card, else gloo).  gloo may carry a card's
  tensors, which is how two ranks share one card (NCCL refuses that).  With
  no coordinator the torchrun variables (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``) are read, as JAX auto-detects a pod.
- ``process_rows``: the same contiguous row block per process (per data
  rank when a model axis shares rows).
- ``make_global_batch`` and ``host_to_global`` have no analogue: a rank's
  rows stay local, the trainer reduces over the mesh's data ranks where
  JAX reduces over the global array (``data_allreduce``), and the initial
  state is made from the same seed on every rank and checked
  (``check_replicated``).
- ``unify_batch_shapes``, ``allsum_scalars``, ``barrier``: collectives on
  the host, over a gloo group (the default group when it is gloo).
- ``local_rows``: this rank's rows of a global batch, in global order.

``data_allreduce`` sums over the data ranks of the current mesh (set by the
trainer through ``set_data_group``), never over the world: tensor-parallel
ranks share rows.  It is differentiable (the gradient of a sum is the sum
of the gradients) and the identity in one process.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP = None
_DATA_GROUP = None
_NCCL_NAMES = ("nccl", "cuda", "gpu")
_GLOO_NAMES = ("gloo", "cpu")


def backend_for(platform: Optional[str], device="cuda") -> str:
    """The process group's backend for ``--distributed-platform``."""
    if platform is None:
        return "nccl" if torch.device(device).type == "cuda" else "gloo"
    if platform in _NCCL_NAMES:
        return "nccl"
    if platform in _GLOO_NAMES:
        return "gloo"
    raise ValueError(f"--distributed-platform {platform!r}: expected one of "
                     f"{_NCCL_NAMES + _GLOO_NAMES}")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               platform: Optional[str] = None, device="cuda") -> None:
    """Join this process into the process group (JAX ``initialize``).  NCCL
    without a card raises: there is no CPU fallback."""
    global _HOST_GROUP
    backend = backend_for(platform, device)
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a card, and "
                           "torch.cuda.is_available() is False; pass "
                           "--distributed-platform cpu to run over gloo")
    if coordinator_address is None:
        init, world, rank = "env://", None, None
    else:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    dist.init_process_group(backend, init_method=init, world_size=world or -1,
                            rank=-1 if rank is None else rank)
    _HOST_GROUP = None if backend == "gloo" else dist.new_group(backend="gloo")


def shutdown() -> None:
    """Leave the process group at the run's end, after every rank has
    reached it (a rank that exits first with gloo's threads alive aborts)."""
    global _HOST_GROUP, _DATA_GROUP
    if dist.is_initialized():
        barrier()
        dist.destroy_process_group()
    _HOST_GROUP = _DATA_GROUP = None


def local_device(device="cuda") -> torch.device:
    """This rank's device: a bare ``cuda`` becomes ``cuda:<LOCAL_RANK>``
    (the rank modulo the cards when that is unset), so that ranks of one
    host share its cards one to one; several ranks on one card share it."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Gate for rank-0-only side effects (log lines, checkpoint files)."""
    return process_index() == 0


def data_coords(mesh=None) -> tuple:
    """(this rank's data index, the number of data ranks) on ``mesh`` (the
    world without one)."""
    if mesh is None or "data" not in (mesh.mesh_dim_names or ()):
        return process_index(), process_count()
    return mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data"))


def process_rows(global_batch_size: int, mesh=None) -> slice:
    """This process's contiguous row block of a global batch: block i of
    the data axis (the ranks of one model group share it)."""
    index, n = data_coords(mesh)
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{n} data ranks")
    per = global_batch_size // n
    return slice(index * per, (index + 1) * per)


def local_rows(global_rows, mesh=None):
    """This rank's rows of a batch-axis array held whole on every rank, in
    global row order (``process_rows`` of its length)."""
    return global_rows[process_rows(len(global_rows), mesh)]


def unify_batch_shapes(batch: dict, pad_values: Optional[dict] = None) -> dict:
    """Pad this rank's collated numpy arrays to the elementwise-max shape
    across processes (JAX :151): one all-gather of the shape vector.  Axis
    0 (local rows) is never padded; ``pad_values`` maps keys to their pad
    id (default 0: token keys must pass theirs)."""
    if process_count() == 1:
        return batch
    pad_values = pad_values or {}
    keys = sorted(batch)
    vec = torch.from_numpy(np.concatenate(
        [np.asarray(np.shape(batch[k]), np.int64) for k in keys]))
    gathered = [torch.empty_like(vec) for _ in range(process_count())]
    dist.all_gather(gathered, vec, group=_HOST_GROUP)
    maxv = torch.stack(gathered).amax(0).tolist()
    out, off = {}, 0
    for k in keys:
        arr = np.asarray(batch[k])
        tgt = tuple(int(x) for x in maxv[off : off + arr.ndim])
        off += arr.ndim
        if tgt[0] != arr.shape[0]:
            raise ValueError(f"{k}: local row count differs across processes "
                             f"({arr.shape[0]} vs {tgt[0]})")
        if tgt != arr.shape:
            arr = np.pad(arr, [(0, t - s) for s, t in zip(arr.shape, tgt)],
                         constant_values=pad_values.get(k, 0))
        out[k] = arr
    return out


def allsum_scalars(values: dict) -> dict:
    """Sum python-scalar metrics across processes (JAX :184)."""
    if process_count() == 1:
        return dict(values)
    keys = sorted(values)
    vec = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(vec, group=_HOST_GROUP)
    return {k: float(v) for k, v in zip(keys, vec.tolist())}


def gather_objects(obj) -> Optional[list]:
    """Every rank's ``obj`` in rank order on rank 0 (None elsewhere)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count() if is_primary() else None
    dist.gather_object(obj, out, dst=0, group=_HOST_GROUP)
    return out


def gather_data_objects(obj, mesh=None) -> list:
    """Every data rank's ``obj`` in data-rank order, on every rank (the
    ranks of one model group hold the same)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    index, n = data_coords(mesh)
    per = process_count() // n
    return out[::per]


def barrier(name: str = "barrier") -> None:
    if process_count() > 1:
        dist.barrier(group=_HOST_GROUP)


def check_replicated(tensors, what: str = "initial state") -> None:
    """Raise unless every rank holds the same values (a sum of each
    tensor's float64 sum and its squares' compared across ranks): the
    check that stands in for JAX's ``host_to_global``."""
    if process_count() == 1:
        return
    sums = torch.tensor([[float(t.double().sum()), float(t.double().square().sum())]
                         for t in tensors], dtype=torch.float64)
    gathered = [torch.empty_like(sums) for _ in range(process_count())]
    dist.all_gather(gathered, sums, group=_HOST_GROUP)
    if any(not torch.equal(g, gathered[0]) for g in gathered):
        raise RuntimeError(f"{what} differs across ranks")


# ------------------------------------------------------ global-batch sums


def set_data_group(group) -> None:
    """The group ``data_allreduce`` sums over (the mesh's data ranks; None:
    one data rank)."""
    global _DATA_GROUP
    _DATA_GROUP = group


def data_size() -> int:
    """The number of data ranks whose rows make up the global batch."""
    return 1 if _DATA_GROUP is None else dist.get_world_size(_DATA_GROUP)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def data_allreduce(x):
    """The sum of ``x`` over the data ranks (differentiable); ``x`` itself
    with one data rank."""
    if data_size() == 1:
        return x
    if not torch.is_tensor(x):
        x = torch.as_tensor(x)
    return _AllReduceSum.apply(x, _DATA_GROUP)


def data_mean(x, dims=None):
    """The mean of ``x`` over ``dims`` (all when None) and over the rows of
    every data rank (differentiable), the same on every rank:
    ``x.mean(dims)`` with one data rank, else the summed sums over the
    summed counts.  A loss term that is such a value enters divided by
    ``data_size`` (or use ``mean_share``)."""
    dims = tuple(range(x.dim())) if dims is None else tuple(dims)
    if data_size() == 1:
        return x.mean(dim=dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    total = data_allreduce(torch.tensor(float(count), device=x.device, dtype=x.dtype))
    return data_allreduce(x.sum(dim=dims)) / total


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n, ctx.index = dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        # every rank of the group holds the same downstream graph, so the
        # gradient of its own columns is its slice of g
        return g.chunk(ctx.n, dim=-1)[ctx.index].contiguous(), None


def gather_last_dim(x, group):
    """The ranks' ``x`` concatenated along the last dim (differentiable):
    a tensor-parallel split gathered whole with one all-gather that gloo
    also carries for a card's tensors."""
    return _GatherLastDim.apply(x, group)


def mean_share(x):
    """This rank's share of the mean of ``x`` over every data rank's rows:
    its sum over the global count (the shares sum to the global mean);
    ``x.mean()`` with one data rank."""
    if data_size() == 1:
        return x.mean()
    total = data_allreduce(torch.tensor(float(x.numel()), device=x.device, dtype=x.dtype))
    return x.sum() / total


def dropout_row_offset(rows: int) -> int:
    """The first flat (batch x head) row index of this rank's ``rows`` rows
    of the train kernel's dropout hash: the rank's place in the mesh times
    its row count.  Under data parallelism that is the rank's first batch
    row times the heads, so each row draws the mask of the one-process run;
    under tensor parallelism the model ranks of one data rank take
    consecutive disjoint blocks, so no two ranks draw the same mask."""
    return rows * process_index()
