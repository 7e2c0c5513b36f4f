"""WavLM in the port, held against the JAX package.

At ``wavlm_tiny`` (f32), on JAX's initial weights carried by
``utils/convert.wavllm_from_jax_params`` (strict loads): the bucketed
relative positions (float64, as JAX's numpy) at lengths up to WavLM Base's
30 s; the encoder in the Base topology (post-LN, "default" extractor) and
the Large one (pre-LN, ``layer_norm`` extractor with a conv bias), padded
rows included (1e-5); the extractor's kernel route (``impl="pallas"``: the
port's conv-stack twin against JAX's ``conv_stack_fused`` in interpret
mode); and the attention's kernel route: JAX's ``WavLMAttention`` against
JAX's own ``flash_attention_bias`` (the Pallas kernel in interpret mode)
fed the same scaled q, k, v and gated bias, and the port's kernel route
(the twin of ``cuda_kernels.flash_attention_bias``) against both, with no
launch.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.models.wavlm as JWL
from speecht5_tpu.config import ConvFeatureConfig as JConv
from speecht5_tpu.ops.pallas_kernels import flash_attention_bias as pallas_flash_bias

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.models.wavlm as PWL
from speecht5_tpu_torch.config import ConvFeatureConfig as PConv
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.utils.convert import wavllm_from_jax_params

TOL = 1e-5
T_WAV = 1000
LENS = np.array([1000, 640], np.int32)
TINY_LAYERS = ((16, 10, 5), (16, 3, 2), (16, 2, 2))


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=TOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=msg)


def wav_batch(seed=0):
    return (np.random.default_rng(seed).standard_normal((2, T_WAV)) * 0.1).astype(np.float32)


TOPOLOGIES = {
    # name: (JAX config, port config)
    "base": (JWL.wavlm_tiny(), PWL.wavlm_tiny()),
    "large_bias": (JWL.wavlm_tiny(stable_layer_norm=True,
                                  conv=JConv(layers=TINY_LAYERS, mode="layer_norm", bias=True)),
                   PWL.wavlm_tiny(stable_layer_norm=True,
                                  conv=PConv(layers=TINY_LAYERS, mode="layer_norm", bias=True))),
}


@pytest.fixture(scope="module", params=sorted(TOPOLOGIES))
def wavlm(request):
    """JAX's init and output for the topology (the non-zero biases drawn
    seeded: JAX inits them 0) and the port's model on those weights."""
    jcfg, pcfg = TOPOLOGIES[request.param]
    wav = wav_batch()
    jm = JWL.WavLMEncoderModel(jcfg)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), wav, LENS))()
    rng = np.random.default_rng(1)
    fp = {k: (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
          if k.endswith("/bias") else a for k, a in flat(v["params"]).items()}
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(fp["/".join(k.key for k in p)]), params)
    out, valid = jax.jit(lambda p: jm.apply({"params": p}, wav, LENS))(params)
    pm = PWL.WavLMEncoderModel(pcfg)
    pm.load_state_dict(wavllm_from_jax_params(fp), strict=True)
    return request.param, (jcfg, pcfg), params, fp, pm.eval(), (out, valid)


def test_relative_position_buckets_match_jax():
    for T, nb, md in ((40, 16, 40), (499, 320, 800), (1499, 320, 800)):
        np.testing.assert_array_equal(PWL.relative_position_buckets(T, nb, md).numpy(),
                                      np.asarray(JWL.relative_position_buckets(T, nb, md)))


def test_encoder_matches_jax(wavlm):
    """Base (post-LN, GroupNorm extractor) and Large (pre-LN, a LayerNorm
    after each conv, conv biases), with a padded row."""
    name, cfgs, _, _, pm, (jout, jvalid) = wavlm
    if name == "large_bias":
        assert pm.feature_extractor.conv_1.bias is not None
    with torch.no_grad():
        out, valid = pm(t(wav_batch()), t(LENS))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not valid[1].all()
    close(out, jout)


def test_extractor_kernel_route_matches_jax_conv_stack_fused(wavlm):
    """``conv.impl="pallas"``: JAX runs ``conv_stack_fused`` (interpret
    mode) on layers 1..; the port's route runs the conv stack's twin on CPU
    tensors (no launch).  With a conv bias both keep the kernel off."""
    name, (jcfg, pcfg), params, fp, _, (jout, _) = wavlm
    jk = dataclasses.replace(jcfg, conv=dataclasses.replace(jcfg.conv, impl="pallas"))
    pk = dataclasses.replace(pcfg, conv=dataclasses.replace(pcfg.conv, impl="pallas"))
    jy, _ = jax.jit(lambda p: JWL.WavLMEncoderModel(jk).apply({"params": p}, wav_batch(),
                                                               LENS))(params)
    close(jy, jout)       # JAX's kernel route against its XLA route
    pm = PWL.WavLMEncoderModel(pk)
    pm.load_state_dict(wavllm_from_jax_params(fp), strict=True)
    K.reset_launch_counts()
    with torch.no_grad():
        y, _ = pm.eval()(t(wav_batch()), t(LENS))
    close(y, jy)
    assert sum(K.launch_counts().values()) == 0


def gated_bias_jax(p, x, cfg, position_bias):
    """JAX's gated bias, the formula of WavLMAttention (wavlm.py:136-146)."""
    B, T, D = x.shape
    H = cfg.num_heads
    g = x.reshape(B, T, H, D // H).transpose(0, 2, 1, 3)
    proj = g @ p["gru_rel_pos_linear"]["kernel"] + p["gru_rel_pos_linear"]["bias"]
    a, b = jnp.split(jax.nn.sigmoid(proj.reshape(B, H, T, 2, 4).sum(-1)), 2, axis=-1)
    gate = a * (b * p["gru_rel_pos_const"] - 1.0) + 2.0
    return gate * position_bias[None]


def test_attention_kernel_route_is_the_pallas_contract():
    """One ``WavLMAttention`` (layer 0: it builds the bucket bias) with a
    padded key row: JAX's module, JAX's Pallas ``flash_attention_bias`` on
    the scaled q, k, v and the gated bias (then ``out_proj``), and the
    port's kernel route all agree (1e-5)."""
    jcfg, pcfg = JWL.wavlm_tiny(), PWL.wavlm_tiny(use_pallas_attn=True)
    rng = np.random.default_rng(2)
    B, T, D, H = 2, 37, jcfg.hidden_size, jcfg.num_heads
    Dh = D // H
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.array([[T], [23]])
    att = JWL.WavLMAttention(jcfg, True)
    v = jax.jit(lambda: att.init(jax.random.PRNGKey(3), x, valid))()
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    p["gru_rel_pos_const"] = (1.0 + rng.standard_normal(p["gru_rel_pos_const"].shape) * 0.3
                              ).astype(np.float32)
    p["rel_attn_embed"] = (rng.standard_normal(p["rel_attn_embed"].shape) * 0.5
                           ).astype(np.float32)
    jy, jpb = att.apply({"params": p}, x, valid)

    dense = lambda n, a: a @ p[n]["kernel"] + p[n]["bias"]
    rows = lambda a: a.reshape(B, T, H, Dh).transpose(0, 2, 1, 3).reshape(B * H, T, Dh)
    q = rows(dense("q_proj", x) * Dh ** -0.5)
    bias = np.asarray(gated_bias_jax(p, x, jcfg, jpb)).reshape(B * H, T, T)
    o = pallas_flash_bias(q, rows(dense("k_proj", x)), rows(dense("v_proj", x)), bias,
                          jnp.repeat(valid, H, axis=0))
    o = np.asarray(o).reshape(B, H, T, Dh).transpose(0, 2, 1, 3).reshape(B, T, D)
    close(dense("out_proj", o), jy)

    pa = PWL.WavLMAttention(pcfg, True)
    pa.load_state_dict(wavllm_from_jax_params(flat(p)), strict=True)
    K.reset_launch_counts()
    with torch.no_grad():
        y, pb = pa.eval()(t(x), t(valid))
    assert pa.kernel_route()
    close(pb, jpb)
    close(y, jy)
    close(y, dense("out_proj", o))
    assert sum(K.launch_counts().values()) == 0
    # a training pass takes the plain route, the kernel being forward-only
    assert not pa.train().kernel_route()
