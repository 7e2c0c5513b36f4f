"""The port's train-attention twins held against the JAX package's Pallas
train kernels (``banded_attention_train``, pallas_kernels.py:517), run in
interpret mode on the CPU, on the same numpy inputs.

``speecht5_tpu_torch.ops.cuda_kernels.banded_attention_train`` is an
autograd function; on CPU tensors its forward and its two backward steps
run the plain twins (``banded_attention_train_fwd_plain``,
``..._bwd_dq_plain``, ``..._bwd_dkv_plain``) that ``chip_smoke.py`` holds
the CUDA kernels against.  Output and dq, dk, dv, dband are compared
through ``jax.vjp`` against ``.backward`` with the same cotangent.

Tolerances: f32 atol 5e-5 / rtol 1e-3 (sums in other orders, as
tests/test_pallas_train_attn.py uses); bf16 3e-2 of max |ref| (one bf16
rounding of p, ds or the outputs on either side).  The dropout keep mask is
compared bit for bit with the numpy replica of the TPU hash.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speecht5_tpu.models.attention import band_from_table as jax_band_from_table
from speecht5_tpu.models.encoder import TransformerEncoder as JEncoder
from speecht5_tpu.config import TransformerConfig as JTransformerConfig
from speecht5_tpu.ops.pallas_kernels import banded_attention_train as jax_bat
from test_pallas_train_attn import _np_keep_mask

import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.models.attention import MultiheadAttention, band_from_table
from speecht5_tpu_torch.models.encoder import TransformerEncoder
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.utils.convert import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
REL_BF16 = 3e-2
NAMES = ("o", "dq", "dk", "dv", "dband")


def _inputs(N, T, D, M, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((N, T, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((N, T, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((N, T, D)).astype(np.float32)
    table = (rng.standard_normal((2 * M, D)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((N, T, D)).astype(np.float32)
    return q, k, v, table, cot


def _jax_pallas(q, k, v, table, cot, T, M, lengths, rate, seed, jdt):
    """(o, dq, dk, dv, dband) of the Pallas train kernel as f32 numpy."""
    band = jax_band_from_table(jnp.asarray(table, jdt), T, M)
    L = jnp.asarray(lengths, jnp.int32)
    out, vjp = jax.vjp(
        lambda q, k, v, b: jax_bat(q, k, v, b, L, dropout_rate=rate, seed=seed),
        *(jnp.asarray(x, jdt) for x in (q, k, v)), band)
    return [np.asarray(x, np.float32)
            for x in (out, *vjp(jnp.asarray(cot, jdt)))]


def _jax_dense(q, k, v, table, cot, T, M, lengths):
    """(o, dq, dk, dv, dband) of the dense JAX formula (autodiff through
    where-masking), rate 0, f32."""
    band = jax_band_from_table(jnp.asarray(table), T, M)
    ok = jnp.arange(T)[None, None, :] < jnp.asarray(lengths)[:, None, None]

    def f(q, k, v, b):
        s = jnp.einsum("nqd,nkd->nqk", q, k) + jnp.einsum("nqd,dqk->nqk", q, b)
        p = jax.nn.softmax(jnp.where(ok, s, -1e9), axis=-1)
        return jnp.einsum("nqk,nkd->nqd", p, v)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)), band)
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(cot)))]


def _port(q, k, v, table, cot, T, M, lengths, rate, seed, tdt):
    """(o, dq, dk, dv, dband) of the port's autograd function as f32 numpy."""
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    band = band_from_table(torch.from_numpy(table).to(tdt), T, M)
    band = band.detach().requires_grad_()
    out = K.banded_attention_train(tq, tk, tv, band,
                                   torch.tensor(lengths, dtype=torch.int32),
                                   dropout_rate=rate, seed=seed)
    out.backward(torch.from_numpy(cot).to(tdt))
    assert out.dtype == tdt and band.grad.dtype == tdt
    return [x.detach().float().numpy()
            for x in (out, tq.grad, tk.grad, tv.grad, band.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("N,T,D,M,lengths", [
    (4, 40, 8, 5, [40, 33, 39, 9]),           # the Pallas test's geometry
    (3, 128, 16, 8, [128, 100, 61]),          # a whole 128-key tile, ragged
])
def test_train_twins_match_pallas(N, T, D, M, lengths, rate, dtype):
    seed = 11
    args = _inputs(N, T, D, M, seed=T)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = _jax_pallas(*args, T, M, lengths, rate, seed, jdt)
    got = _port(*args, T, M, lengths, rate, seed, tdt)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-3, err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= REL_BF16 * np.abs(w).max(), (name, err)


def _wgmma_bwd_model(q, k, v, band, lengths, o, do, stats, rate, seed):
    """The bf16 backward as the wgmma kernels round it
    (csrc/banded_attention_train_bwd.cu): the twin's f32 ds, rounded to
    bf16 once, feeds all four of its products (ds.k, ds.band, q^T.ds and
    ds^T.q); p keep is rounded to bf16 for dv; dq's two terms are summed in
    f32 and rounded once.  Returns (dq, dk, dv) in bf16 and dband in f32."""
    p, ks, ds = K._train_ds(q, k, v, band, lengths, o, do, stats, rate, seed)
    ds = ds.to(torch.bfloat16).float()
    dq = ds @ k.float() + torch.einsum("nqk,dqk->nqd", ds, band.float())
    dband = torch.einsum("nqd,nqk->dqk", q.float(), ds)
    pd = p if ks is None else p * ks
    dv = pd.to(torch.bfloat16).float().transpose(1, 2) @ do.float()
    dk = ds.transpose(1, 2) @ q.float()
    return [t.to(torch.bfloat16) for t in (dq, dk, dv)] + [dband]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("N,T,D,M,lengths", [
    (4, 40, 8, 5, [40, 33, 39, 9]),
    (3, 128, 16, 8, [128, 100, 61]),
])
def test_wgmma_backward_rounding_matches_pallas(N, T, D, M, lengths, rate):
    """bf16: the forward's twin, then the backward with ds rounded to bf16
    at exactly the wgmma kernels' rounding points, against the Pallas
    kernels (interpret mode) within REL_BF16 of max |ref|: the design's
    error budget, checked before the card sees it."""
    seed = 11
    q, k, v, table, cot = _inputs(N, T, D, M, seed=T)
    want = _jax_pallas(q, k, v, table, cot, T, M, lengths, rate, seed, jnp.bfloat16)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, cot))
    band = band_from_table(torch.from_numpy(table).to(torch.bfloat16), T, M)
    L = torch.tensor(lengths, dtype=torch.int32)
    o, stats = K.banded_attention_train_fwd_plain(tq, tk, tv, band, L, rate, seed)
    dq, dk, dv, dband = _wgmma_bwd_model(tq, tk, tv, band, L, o, tdo, stats, rate, seed)
    got = [x.float().numpy() for x in (o, dq, dk, dv, dband)]
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= REL_BF16 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (11, 0.3), (2 ** 31 - 2, 0.5)])
def test_dropout_keep_mask_is_the_tpu_hash(seed, rate):
    N, Tq, Tk = 5, 37, 130
    got = K.dropout_keep_plain(seed, rate, N, Tq, Tk).numpy()
    np.testing.assert_array_equal(got, _np_keep_mask(seed, rate, N, Tq, Tk) > 0)
    assert abs(got.mean() - (1 - rate)) < 0.02


def test_zero_length_row_follows_the_dense_path():
    """A row of length 0 attends uniformly to all T keys.  Its output and dv
    equal the Pallas kernel's at T = 128 (no padded keys there); dq, dk and
    dband follow the dense JAX formula, whose masked keys carry no gradient,
    while the Pallas kernel lets that row leak into all three (ROADMAP.md
    C)."""
    N, T, D, M = 3, 128, 16, 8
    lengths = [128, 100, 0]
    args = _inputs(N, T, D, M, seed=5)
    got = _port(*args, T, M, lengths, 0.0, 0, torch.float32)
    pallas = _jax_pallas(*args, T, M, lengths, 0.0, 0, jnp.float32)
    dense = _jax_dense(*args, T, M, lengths)
    for name, g, p, d in zip(NAMES, got, pallas, dense):
        np.testing.assert_allclose(g, d, atol=5e-5, rtol=1e-3, err_msg=name)
        if name in ("o", "dv"):
            np.testing.assert_allclose(g, p, atol=5e-5, rtol=1e-3, err_msg=name)
    assert np.abs(got[1][2]).max() == 0.0 and np.abs(pallas[1][2]).max() > 1e-2


def test_encoder_train_route_matches_jax_pallas_encoder():
    """Two post-LN layers in training mode with the train-kernel flag: the
    port's encoder (twins) against the JAX encoder (Pallas train kernel,
    interpret mode), attention dropout at 0 so both are deterministic;
    output and every parameter gradient of sum(out**2)."""
    kw = dict(d_model=32, ffn_dim=48, num_layers=2, num_heads=2, dropout=0.0,
              attention_dropout=0.0, use_pallas_attn_train=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    valid = np.arange(24)[None, :] < np.array([[24], [17]])
    jenc = JEncoder(JTransformerConfig(**kw))
    variables = jenc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                          jnp.asarray(valid), deterministic=True)

    def loss(params):
        out = jenc.apply({"params": params}, jnp.asarray(x), jnp.asarray(valid),
                         deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out["encoder_out"] ** 2), out["encoder_out"]

    (jl, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    def flat(tree):
        return {"encoder/" + "/".join(k): np.asarray(v)
                for k, v in _flatten(tree).items()}

    enc = TransformerEncoder(PC.TransformerConfig(**kw))
    enc.load_state_dict({k[len("encoder."):]: v for k, v in
                         from_jax_params(flat(variables["params"])).items()})
    enc.train()
    K.reset_launch_counts()
    out = enc(torch.from_numpy(x), torch.from_numpy(valid))["encoder_out"]
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=3e-5, rtol=1e-4)
    want = from_jax_params(flat(jg))
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want["encoder." + name].numpy(),
                                   atol=1e-4, rtol=5e-3, err_msg=name)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_attention_module_routes_by_training_mode(monkeypatch):
    """Training passes with use_pallas_train take the train kernel and never
    the inference kernel; eval passes take the inference kernel; training
    without the flag takes the plain path (the JAX routing,
    models/attention.py:225-236)."""
    calls = []

    def inference(q, k, v, band, lengths=None):
        calls.append("inference")
        return K.banded_flash_attention_plain(q, k, v, band, lengths)

    def train(q, k, v, band, lengths=None, *, dropout_rate=0.0, seed=0):
        calls.append(("train", dropout_rate, seed))
        return K.banded_attention_train_fwd_plain(q, k, v, band, lengths,
                                                  dropout_rate, seed)[0]

    monkeypatch.setattr(K, "banded_flash_attention", inference)
    monkeypatch.setattr(K, "banded_attention_train", train)
    T = 9
    band = band_from_table(torch.randn(8, 8), T, 4)
    valid = torch.arange(T)[None, :] < torch.tensor([T, 5])[:, None]
    x = torch.randn(2, T, 32)
    gen = torch.Generator().manual_seed(3)
    attn = MultiheadAttention(32, 4, 0.1, use_pallas=True, use_pallas_train=True)
    attn.train()
    seed = attn.train_seed(band, T, gen)
    attn(x, valid, band, dropout_seed=seed)
    assert calls == [("train", 0.1, seed)] and 0 <= seed < 2 ** 31 - 1
    with pytest.raises(ValueError, match="dropout_seed"):   # no seed drawn inside
        attn(x, valid, band)
    attn.eval()
    with torch.no_grad():
        attn(x, valid, band)
    assert calls[-1] == "inference"
    calls.clear()
    attn.use_pallas_train = False
    attn.train()
    attn(x, valid, band)
    assert calls == []


def test_inference_kernel_refuses_to_drop_a_gradient():
    q = torch.randn(2, 8, 4, requires_grad=True)
    band = torch.zeros(4, 8, 8)
    with pytest.raises(RuntimeError, match="inference-only"):
        K.banded_flash_attention(q, q.detach(), q.detach(), band)
    with torch.no_grad():
        assert K.banded_flash_attention(q, q, q, band).shape == q.shape


def test_conv_stack_gradient_is_the_twin_vjp():
    """The conv stack's autograd function (forward: the kernel, here its
    twin) differentiates through the plain twin, as conv_stack_fused
    differentiates through _conv_stack_ref."""
    rng = np.random.default_rng(0)
    specs = ((3, 2), (2, 2))
    x = torch.from_numpy(rng.standard_normal((2, 41, 8)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((k, 8, 8)) * 0.3).astype(np.float32))
          for k, _ in specs]
    g = torch.from_numpy(rng.standard_normal((2, 10, 8)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, *ws)]
    K.conv_stack(leaves[0], leaves[1:], specs).backward(g)
    refs = [t.clone().requires_grad_() for t in (x, *ws)]
    K.conv_stack_plain(refs[0], refs[1:], specs).backward(g)
    for a, b in zip(leaves, refs):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)
