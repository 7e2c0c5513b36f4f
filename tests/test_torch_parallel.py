"""The port's ``parallel/`` package held against the JAX package's
(``speecht5_tpu/parallel/``): the row blocks, shape unification, scalar
sums and local rows at one process and at two gloo ranks (children started
with the conftest's hermetic environment, rendezvous through a file store
in ``tmp_path``), the placement rules for every parameter of the tiny
model, and the decode batch split.

Parameters are paired through the JAX tree: JAX's ``init_model`` leaves,
each filled with its own element indices, carried into the port's layout by
``utils/convert.from_jax_params`` (the fairseq converter
``speecht5_tpu/utils/convert.py:convert_state_dict`` names 82 of the
tiny model's 126 tensors: the port's names follow JAX's tree where fairseq
names differ), so each port parameter knows its JAX path and the axis
permutation between the two layouts.
"""

import itertools
import types

import numpy as np
import pytest

import jax
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.models.speecht5 import init_model as jinit_model
from speecht5_tpu.parallel import distributed as JD
from speecht5_tpu.parallel.sharding import param_spec as jax_param_spec

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.parallel import distributed as D
from speecht5_tpu_torch.parallel.sharding import (param_spec, param_specs,
                                                  shard_decode_batch,
                                                  tensor_parallel_plan)
from speecht5_tpu_torch.utils.convert import from_jax_params

from torch_parallel_worker import run_jobs


def test_helpers_in_one_process_equal_jax():
    assert D.process_rows(8) == JD.process_rows(8) == slice(0, 8)
    b = {"x": np.zeros((2, 3))}
    assert D.unify_batch_shapes(b) is b and JD.unify_batch_shapes(b) is b
    assert D.allsum_scalars({"a": 2.0}) == JD.allsum_scalars({"a": 2.0})
    assert D.local_rows(np.arange(8)).tolist() == list(range(8))
    assert D.data_allreduce(torch.tensor(3.0)).item() == 3.0 and D.data_size() == 1
    assert D.dropout_row_offset(48) == 0 and D.is_primary()


def test_helpers_at_two_gloo_ranks_match_the_formulas(tmp_path):
    """Each rank's contiguous block, the elementwise-max shapes padded with
    each key's pad id, the scalar sums, this rank's rows in global order."""
    res = run_jobs(tmp_path, [{"kind": "helpers"}])[0]
    for r, got in enumerate(res):
        assert got["rows"] == [4 * r, 4 * r + 4]
        assert got["local_rows"] == list(range(4 * r, 4 * r + 4))
        assert got["allsum"] == {"a": 4.0, "n": 4.0}
        wav, tgt = (np.asarray(got["unified"][k]) for k in ("wav", "targets"))
        assert wav.shape == (2, 8) and tgt.shape == (2, 4)
        assert (wav[:, : 5 + 3 * r] == 1).all() and (wav[:, 5 + 3 * r:] == 0).all()
        assert (tgt[:, : 4 - r] == 7).all() and (tgt[:, 4 - r:] == 1).all()


@pytest.fixture(scope="module")
def paired():
    """{port name: (JAX path, JAX shape, JAX axis -> port axis)} for every
    parameter of the tiny model, and the port model."""
    cfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    _, variables = jinit_model(cfg, jax.random.PRNGKey(0), wav_len=4000)
    flat = flatten_dict(variables["params"], sep="/")
    indexed, off = {}, 0
    for path, leaf in flat.items():
        n = int(np.prod(leaf.shape))
        indexed[path] = np.arange(off, off + n, dtype=np.float64).reshape(leaf.shape)
        off += n
    port = {k: v.double().numpy() for k, v in from_jax_params(
        {k: v.astype(np.float64) for k, v in indexed.items()}).items()}
    first = {int(v.min()): k for k, v in indexed.items() if v.size}
    pairs = {}
    for name, t in port.items():
        path = first[int(t.min())]
        arr = indexed[path]
        perm = next(p for p in itertools.permutations(range(arr.ndim))
                    if arr.transpose(p).shape == t.shape and np.array_equal(
                        arr.transpose(p), t))
        pairs[name] = (path, arr.shape, perm)
    model = init_model(PC.speecht5_tiny(**chip_smoke.DICT_CFG), device="cpu")
    return pairs, model


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("mesh", [(8, 1), (4, 2)], ids=["8x1", "4x2"])
def test_param_specs_equal_jax_for_every_parameter(paired, mesh, fsdp):
    """The port's spec of each tiny-model parameter, in its own axis
    order, is JAX's ``param_spec`` of the paired leaf read through the
    layout permutation."""
    pairs, model = paired
    n_data, n_model = mesh
    got = param_specs(model, fsdp, n_data, n_model)
    assert set(got) == set(pairs) == {n for n, _ in model.named_parameters()}
    split = 0
    for name, (path, shape, perm) in pairs.items():
        spec = tuple(jax_param_spec(path, shape, fsdp, n_data, n_model))
        spec += (None,) * (len(shape) - len(spec))
        want = [None] * len(shape)
        for port_axis, jax_axis in enumerate(perm):
            want[port_axis] = spec[jax_axis]
        assert got[name] == tuple(want), name
        assert param_spec(path, shape, fsdp, n_data, n_model) == spec, path
        split += any(s is not None for s in spec)
    assert split > (40 if fsdp or n_model > 1 else -1)


def test_tensor_parallel_plan_follows_the_rules(paired):
    """n_model 2: the qkv and fc1 column splits with local outputs, out_proj
    and fc2 row splits, embeddings gathered; the 81-letter CTC ``proj`` and
    output projection stay whole."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    _, model = paired
    plan = tensor_parallel_plan(model, 2)
    assert isinstance(plan["encoder.layers.0.self_attn.q_proj"], ColwiseParallel)
    assert isinstance(plan["encoder.layers.0.ffn.fc2"], RowwiseParallel)
    assert isinstance(plan["decoder.layers.1.encoder_attn.out_proj"], RowwiseParallel)
    assert "text_encoder_prenet.embed_tokens" in plan
    assert "encoder.proj" not in plan and "text_decoder_postnet.output_projection" not in plan
    layer = sum(1 for k in plan if k.startswith("encoder.layers.0."))
    assert layer == 6      # q, k, v, out_proj, fc1, fc2


def _mesh(n_data, index=0):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 get_local_rank=lambda dim: index,
                                 size=lambda i: n_data if i == 0 else 1)


def test_shard_decode_batch_refuses_a_batch_the_data_ranks_do_not_divide():
    wav, wlen = torch.zeros(6, 10), torch.arange(6)
    with pytest.raises(ValueError, match="not divisible by data axis 8"):
        shard_decode_batch((wav, wlen), _mesh(8))
    a, b = shard_decode_batch((torch.arange(16).view(8, 2), wlen.repeat(2)[:8]),
                              _mesh(4, index=2))
    assert a.tolist() == [[8, 9], [10, 11]] and b.tolist() == [4, 5]


@pytest.mark.parametrize("offset", [0, 5, 96, 2 ** 32 + 7])
def test_offset_seed_places_rows_in_the_global_dropout_hash(offset):
    """The train kernels key row n by seed + n * 0x27D4EB2F (mod 2**32), so
    a seed moved by ``offset_seed`` keys the call's rows as rows ``offset +
    n`` of the global batch: the kernels' arithmetic is unchanged."""
    from speecht5_tpu_torch.ops import cuda_kernels as K

    got = K.dropout_keep_plain(K.offset_seed(1234, offset), 0.3, 6, 5, 7)
    assert torch.equal(got, K.dropout_keep_plain(1234, 0.3, 6, 5, 7, n_offset=offset))
    if offset < 2 ** 32:
        whole = K.dropout_keep_plain(1234, 0.3, offset + 6, 5, 7)
        assert torch.equal(got, whole[offset:])
