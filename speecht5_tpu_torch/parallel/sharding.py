"""Device mesh and parameter placement (port of
``speecht5_tpu/parallel/sharding.py``).

One ``('data', 'model')`` mesh: the batch is split over 'data', the big
matmul dimensions over 'model' (Megatron's column / row split of the
attention heads and the FFN).  The rules are JAX's ``_RULES``, matched on
the JAX path of each parameter (``jax_layout`` names it from the port's
module types, as ``utils/convert.py`` maps the two), and ``param_spec`` is
JAX's, so a placement is JAX's placement read in the port's axis order: a
flax ``kernel`` is ``[in, out]``, a torch ``weight`` ``[out, in]``, so
JAX's ``P(None, 'model')`` on ``q_proj`` is the torch weight split on dim 0
(``ColwiseParallel``), ``out_proj`` / ``fc2`` split on their input dim
(``RowwiseParallel``), and ``embed_tokens`` on its embedding dim.  The
'model' split is dropped where an axis does not divide ``n_model`` (the
81-letter CTC ``proj`` stays replicated at ``n_model`` 2).

``fsdp=True`` (ZeRO) places each parameter's first unsplit axis that
divides the data ranks, in JAX's axis order, on 'data'; a parameter with
no such axis stays replicated and its gradient is summed as data
parallelism sums it.  ``apply_tensor_parallel`` and ``apply_fsdp`` realise
these placements with ``parallelize_module`` and ``fully_shard``.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from . import distributed as D


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type="cuda"):
    """``init_device_mesh`` over the world as ``(n_data, n_model)``, row-major
    over the ranks (a model group is ``n_model`` consecutive ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = D.process_count()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"{n_data}x{n_model} != {n} processes")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict:
    """{"data": n, "model": m} of ``mesh`` (both 1 without one)."""
    if mesh is None:
        return {"data": 1, "model": 1}
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


# JAX's rules verbatim, on JAX paths.  Column-parallel (output dim split):
# the qkv projections, fc1; row-parallel (input dim split): out_proj, fc2.
_RULES = (
    (r"(q_proj|k_proj|v_proj)/kernel$",        (None, "model")),
    (r"(q_proj|k_proj|v_proj)/bias$",          ("model",)),
    (r"out_proj/kernel$",                      ("model", None)),
    (r"fc1/kernel$",                           (None, "model")),
    (r"fc1/bias$",                             ("model",)),
    (r"fc2/kernel$",                           ("model", None)),
    (r"embed_tokens/embedding$",               (None, "model")),
    (r"output_projection/kernel$",             (None, "model")),
    (r"proj/kernel$",                          (None, "model")),   # CTC head
    (r"label_embs_concat$",                    (None, None)),
)


def param_spec(path: str, shape: tuple, fsdp: bool = False,
               n_data: int = 1, n_model: int = 1) -> tuple:
    """JAX's spec of one parameter at its JAX ``path`` and ``shape``: a
    tuple of 'data' / 'model' / None per axis (JAX :52-83)."""
    ndim = len(shape)

    def zero_extend(parts):
        parts = list(parts) + [None] * (ndim - len(parts))
        if fsdp:
            for i, p in enumerate(parts):
                if p is None and shape[i] % n_data == 0 and shape[i] >= n_data:
                    parts[i] = "data"
                    break
        return tuple(parts)

    for pattern, spec in _RULES:
        if re.search(pattern, path):
            parts = list(spec) + [None] * (ndim - len(spec))
            for i, p in enumerate(parts):
                if p == "model" and (i >= ndim or shape[i] % n_model != 0):
                    parts[i] = None
            return zero_extend(parts[:ndim])
    return zero_extend(())


def _jax_leaf(module, pname: str, p) -> tuple:
    """(JAX leaf name, JAX axis -> torch axis) of parameter ``pname`` of
    ``module``: the inverse of ``utils/convert._leaf``."""
    if isinstance(module, nn.Embedding):
        return "embedding", tuple(range(p.dim()))
    if pname == "weight" and isinstance(module, nn.Linear):
        return "kernel", (1, 0)
    if pname in ("weight", "weight_v", "weight_g") and p.dim() == 3:
        return ("kernel" if pname == "weight" else pname), (2, 1, 0)
    if pname == "weight" and p.dim() == 1:
        return "scale", (0,)
    return pname, tuple(range(p.dim()))


def jax_layout(model: nn.Module) -> dict:
    """{torch name: (JAX path, JAX axis -> torch axis)} of every parameter."""
    out = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            leaf, axes = _jax_leaf(module, pname, p)
            path = re.sub(r"(^|/)layers/(\d+)(?=/|$)", r"\1layers_\2",
                          mname.replace(".", "/"))
            name = f"{mname}.{pname}" if mname else pname
            if name.endswith("output_projection.weight") and not isinstance(
                    module, nn.Linear):
                leaf = "projection_weight"    # the speaker head's, [C, E]
                path = path.rsplit("/", 1)[0]
            out[name] = (f"{path}/{leaf}" if path else leaf, axes)
    return out


def param_specs(model: nn.Module, fsdp: bool = False, n_data: int = 1,
                n_model: int = 1) -> dict:
    """{torch name: spec in the torch parameter's axis order}."""
    shapes = dict(model.named_parameters())
    out = {}
    for name, (path, axes) in jax_layout(model).items():
        shape = tuple(shapes[name].shape)
        spec = param_spec(path, tuple(shape[a] for a in axes), fsdp, n_data, n_model)
        torch_spec = [None] * len(shape)
        for jax_axis, torch_axis in enumerate(axes):
            torch_spec[torch_axis] = spec[jax_axis]
        out[name] = tuple(torch_spec)
    return out


# Column-parallel modules whose output the next layer reads split by heads
# or FFN columns; the other column-parallel ones (vocabulary projections,
# embeddings) gather their output.
_LOCAL_OUTPUT = re.compile(r"(q_proj|k_proj|v_proj|fc1)$")


def tensor_parallel_plan(model: nn.Module, n_model: int) -> dict:
    """{module name: ParallelStyle} of the 'model' splits of ``param_specs``:
    column splits (embeddings' too: their embedding dim) and row splits."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    specs = param_specs(model, n_model=n_model)
    plan = {}
    for mname, module in model.named_modules():
        spec = specs.get(f"{mname}.weight")
        if spec is None or "model" not in spec:
            continue
        col = isinstance(module, nn.Embedding) or spec[0] == "model"
        plan[mname] = ColwiseParallel() if col else RowwiseParallel()
    return plan


def apply_tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Split ``model`` over ``mesh['model']`` by the rules.  A column split
    that the next layer does not read by heads or FFN columns (embeddings,
    vocabulary projections) gathers its output with ``gather_last_dim``
    (one all-gather: DTensor's own gathers crash over gloo on a card's
    tensors); a parameter of a split module that the rules keep whole (the
    CTC ``proj``'s bias) is placed replicated from the value every rank
    holds.  The attention modules then run their local heads."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.parallel import parallelize_module

    n_model = mesh_shape(mesh)["model"]
    if n_model == 1:
        return model
    sub = mesh["model"]
    plan = tensor_parallel_plan(model, n_model)
    specs = param_specs(model, n_model=n_model)
    whole = {mname: {pname: p.detach().clone()
                     for pname, p in model.get_submodule(mname).named_parameters(
                         recurse=False)
                     if "model" not in specs[f"{mname}.{pname}"]} for mname in plan}
    parallelize_module(model, sub, plan)
    group = sub.get_group()
    for mname, style in plan.items():
        module = model.get_submodule(mname)
        for pname, value in whole[mname].items():
            rep = DTensor.from_local(value, sub, [Replicate()], run_check=False)
            module.register_parameter(pname, nn.Parameter(rep))
        if isinstance(module, nn.Embedding) or (
                type(style).__name__ == "ColwiseParallel" and not _LOCAL_OUTPUT.search(mname)):
            module.register_forward_hook(
                lambda m, args, out: D.gather_last_dim(out, group))
    return model


def redistribute(t, like):
    """``t`` (a split tensor, a gradient) in the placements of ``like`` (its
    parameter), moved with c10d collectives on the local parts: a partial
    sum all-reduced, a split gathered (chunks padded to one size) or cut.
    DTensor's own redistribution runs collectives that gloo does not carry
    for a card's tensors, and an optimizer step would otherwise call it
    wherever autograd left a gradient in another placement."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if t.placements == like.placements:
        return t
    mesh, local = like.device_mesh, t.to_local()
    coords = mesh.get_coordinate()
    for i, (have, want) in enumerate(zip(t.placements, like.placements)):
        if have == want:
            continue
        group, n = mesh.get_group(i), mesh.size(i)
        if have.is_partial():
            local = local.clone()
            dist.all_reduce(local, group=group)
        elif have.is_shard():
            dim, size = have.dim, t.shape[have.dim]
            chunk = -(-size // n)
            if local.shape[dim] < chunk:
                pad = list(local.shape)
                pad[dim] = chunk - local.shape[dim]
                local = torch.cat([local, local.new_zeros(pad)], dim)
            parts = [torch.empty_like(local) for _ in range(n)]
            dist.all_gather(parts, local.contiguous(), group=group)
            local = torch.cat(parts, dim).narrow(dim, 0, size)
        if want.is_shard():
            chunks = torch.chunk(local, n, dim=want.dim)
            local = (chunks[coords[i]] if coords[i] < len(chunks)
                     else local.narrow(want.dim, 0, 0)).contiguous()
    return DTensor.from_local(local, mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


# methods through which the trainer and the decoders enter the model; FSDP
# gathers the root's parameters around each
FORWARD_METHODS = ("forward_s2t", "forward_t2s", "forward_s2s", "forward_s2c",
                   "forward_pretrain_speech", "forward_pretrain_text")


def apply_fsdp(model: nn.Module, mesh) -> list:
    """ZeRO over ``mesh['data']``: ``fully_shard`` on every encoder and
    decoder layer and at the root, each parameter split on the dim that
    ``param_specs(fsdp=True)`` gives 'data' (after ``apply_tensor_parallel``
    on a mesh with a model axis: an axis the 'model' split left whole).
    Gradients are summed, not averaged (the losses are this rank's share of
    the global-batch loss).  Returns the parameters kept whole over the
    data ranks (no free axis divides them), whose gradients the caller
    sums."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    shape = mesh_shape(mesh)
    dmesh = mesh["data"]
    specs = param_specs(model, fsdp=True, n_data=shape["data"], n_model=shape["model"])
    by_param = {p: specs[n] for n, p in model.named_parameters()}
    whole = {p for p, s in by_param.items() if "data" not in s}

    def placement(p):
        return Shard(by_param[p].index("data"))

    kw = dict(mesh=dmesh, shard_placement_fn=placement, ignored_params=whole)
    for stack in (model.encoder, model.decoder):
        if stack is None:
            continue
        for layer in stack.layers:
            fully_shard(layer, **kw)
    fully_shard(model, **kw)
    for m in model.modules():
        if hasattr(m, "set_gradient_divide_factor"):
            m.set_gradient_divide_factor(1.0)
            # a plain SUM, which gloo carries (a scaled sum it does not)
            m.set_force_sum_reduction_for_comms(True)
    for name in FORWARD_METHODS:
        register_fsdp_forward_method(model, name)
    return [p for p in model.parameters() if p in whole]


def shard_decode_variables(model: nn.Module, mesh, tensor_parallel: bool = False):
    """The model placed for multi-rank inference: replicated for
    data-parallel decode (every rank holds the same weights, checked), or
    split by the rules with ``tensor_parallel`` (JAX :120)."""
    if tensor_parallel:
        return apply_tensor_parallel(model, mesh)
    D.check_replicated([p.detach() for p in model.parameters()], "decode weights")
    return model


def shard_decode_batch(args, mesh):
    """This rank's rows of each positional decode input (JAX :140-156 puts
    the batch axis on 'data').  The batch must be a multiple of the data
    ranks (pad the tail batch)."""
    index, n = D.data_coords(mesh)
    out = []
    for a in args:
        if a.shape[0] % n:
            raise ValueError(f"batch {a.shape[0]} not divisible by data axis {n}")
        per = a.shape[0] // n
        out.append(a[index * per : (index + 1) * per])
    return tuple(out)
