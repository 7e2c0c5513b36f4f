"""The joint CTC/attention beam at SpeechT5-Base ASR width against the JAX
package: ``speecht5_base_asr`` (d 768, 12 heads, FFN 3072, rel-pos distance
160, 512-channel conv stack) cut to one encoder and one decoder layer, 0.4 s
of audio, beam 5, CTC weight 0.3, every kernel flag on (the twins run on the
CPU).  The whole [B, K, L+1] token array and lengths equal, scores 1e-5.
Kept apart from ``test_torch_beam.py`` so that the two run on different
workers.
"""

import numpy as np

import jax.numpy as jnp

import speecht5_tpu.config as JC
from speecht5_tpu.decode.asr import ASRDecoder as JASRDecoder
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.decode.asr import ASRDecoder
from speecht5_tpu_torch.models.speecht5 import init_model
from test_torch_beam import _init_jax, _load, _same_result_tol


def test_base_width_beam_matches_jax():
    """speecht5_base_asr at full width (d 768, 12 heads, FFN 3072, rel-pos
    distance 160) with one encoder and one decoder layer, 0.4 s of audio,
    beam 5, CTC weight 0.3, max_len 6, every kernel flag on (twins)."""
    flags = chip_smoke.BEAM_OVERRIDES + ["encoder.num_layers=1", "decoder.num_layers=1"]
    jcfg = JC.apply_overrides(JC.speecht5_base_asr(**chip_smoke.DICT_CFG), flags)
    variables = _init_jax(jcfg, T=6400)
    pcfg = PC.apply_overrides(PC.speecht5_base_asr(**chip_smoke.DICT_CFG), flags)
    model = _load(init_model(pcfg, device="cpu"), variables)
    wav = (np.random.default_rng(3).standard_normal((1, 6400)) * 0.1).astype(np.float32)
    lens = np.array([6400], np.int32)
    kw = dict(beam_size=5, max_len=6, ctc_weight=0.3)
    jres = JASRDecoder(JModel(jcfg), variables, **kw)(jnp.asarray(wav), jnp.asarray(lens))
    res = ASRDecoder(model, device="cpu", **kw)(wav, lens)
    _same_result_tol(res, jres)
