#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``speecht5_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each timed; any failure raises and the exit code is non-zero:

1. build    -- compile the seven CUDA sources with nvcc for sm_90a from this
               checkout, one nvcc each, all started together.
2. kernels  -- hold each of the seven kernels against its plain PyTorch twin
               on the card and time kernel, twin and one PyTorch library call
               that computes the same function (a yardstick only; for the
               conv stack and the log-mel also the share of the bound
               reached and the TFLOP/s of the work the function needs):
               the inference attention and the conv stack at SpeechT5-Base
               shapes (batch 1, as a served 16 s chunk gives them, and batch
               2), f32 and bf16, the band row-padded as the encoder builds
               it, and for bf16 the time of each launch of the wgmma forward
               (bias pass, main loop); the inference attention also as the
               /tts text encoder runs it ("tts_text": N 12, T 128, every row
               the longer text's 58 valid keys); the three train-attention kernels at
               the train step's shapes (N = 16 x 12, T = 799, Dh = 64, ragged
               lengths with a row of length 0), f32 and bf16, dropout 0 and
               0.1 at a fixed seed, and for bf16 the time of each launch of
               the wgmma forward (bias pass, main loop) and backward (bias
               pass, dq's main loop and band pass, dk/dv's main loop); the
               log-mel kernel at the t2s step's
               batch ([16, 197376] reflect-padded rows, center=False, 80
               mels: 768 frames) and at [2, 48000] with center=True, f32,
               atol 2e-3 (the JAX spec's, tests/test_pallas_kernels.py:23);
               the decode-step attention at the beam's two shapes (grouped
               cross-attention N 12, Tq 5, Tk 799; cached self-attention
               N 60, Tq 1, Tk 201), each through the contract entry on
               [N, T, D] rows and through the cached entry as the decoder
               calls it ("cross_cached": the head-major K/V of
               ``precompute_kv``; "self_cache": the cache [5, 201, 12, 64]
               and an ancestry row map, as ``_cached_step``) and at the TTS
               decoder's two ("tts_self": the cache [1, 513, 12, 64] at step
               200; "tts_cross": a 128-token text, 58 valid, with the
               max-probability output held against the twin's, f32 1e-4,
               bf16 3e-2 of max |ref|, and timed with and without it), f32
               and bf16, timed back to back on the stream and, with its
               SDPA yardstick, as the card runs it (calls captured in one
               CUDA graph and replayed).  The shapes of the s2s / s2c
               paths, bf16: the inference attention on a 3 s VC source (T
               149) and an 8 s SID crop (T 399), the train kernels at N 96,
               T 299 and 400, the decode-step kernel against the VC source
               ("vc_cross": Tq 1, Tk 149, with the max-probability output),
               the conv stack at batch 8 on 6 s and 8 s, and its backward
               (the library conv's vjp, recomputing through cuDNN) at 8 s
               beside cuDNN's autograd.grad through conv1d + GELU.  The fusion LM's step, f32 and bf16: the
               decode-step kernel at D 80 ("lm_self": N 80 = 5 x 16, Tq 1,
               Tk 201, 101 valid; "lm_self_cache": the cache [5, 201, 16,
               80] through an int64 ancestry map).  The evaluate path's
               batch (phase 19: 8 clips, up to 5 s), bf16: the inference
               attention at N 96, T 249 with ragged lengths, the conv stack
               at batch 8 on 5 s, and the cached decode steps of its beam
               (8 x 5 rows, a 61-position cache) in f32 and bf16: the
               decoder's self step (N 480, D 64) and grouped cross step
               (N 96, Tq 5, Tk 249, each sample's own valid frames), and
               the tiny fusion LM's self step (N 160, D 16).  SpeechT5-
               Large's shapes: the inference attention at 16 heads (N 16,
               T 799, f32 and bf16), the train kernels at the pretraining
               micro-batch (N 64 = 4 x 16, T 781: the 250000-sample crop,
               bf16, dropout 0) and the beam's decode steps at 16 heads
               ("large_cross_cached": N 16, Tq 5, Tk 799;
               "large_self_cache": N 80, Tk 201; f32 and bf16).
3. serve    -- the serving path: the port's ASR Service (ctc_greedy, bf16,
               both inference kernels on) at full speecht5_base_asr width
               with random weights, answering 3 s, 11 s and 21 s requests in
               process (the 21 s one is chunked).
4. parity   -- the same f32 weights through the Service path with the
               kernels and with the flags off: the CTC frame ids must agree
               (a differing frame is tolerated only where the top-2 logit gap
               is < 1e-4, and on under 0.1% of frames).
5. serve beam -- the beam arm, Service(--decoder beam: beam 5, max_len
               200, CTC weight 0.3) at speecht5_base_asr, bf16, batch 1,
               every kernel on (decoder.use_pallas_attn too), warming each
               bucket (random weights: every warm-up and chunk runs all 200
               steps) and serving the 3 s, 11 s and 21 s requests; per
               request the decode steps and each kernel's launches: the
               decode-step kernel 12 a step (6 layers x self + cross), the
               inference attention 24 (12 layers x bias pass and main loop)
               and the conv stack 6 a chunk.  Then one more request under
               ``torch.profiler``: every device launch (kernels, copies,
               fills) over its decode steps.
6. beam parity -- f32 weights through Service(--decoder beam) with every
               kernel flag on and off, chunk by chunk (see
               ``phase_beam_parity``).
7. train    -- the training path: ``cli/train.main`` with the ASR fine-tune
               recipe's flags (recipes/asr_finetune.sh: CTC weight 0.5,
               label smoothing 0.1, accum 2, batch 16, bf16, --normalize,
               the train-attention kernel and the conv kernel on) on
               speecht5_base_asr at full width with random weights, over a
               synthetic corpus of 32 seeded 8-16 s utterances written to a
               temporary directory: 3 updates, then a resume that takes one
               more.  Every loss and grad norm must be finite; each train
               wrapper must launch its kernels once per encoder layer run
               (layerdrop skips some; bf16: the forward two launches, bias
               pass and main loop, dq/dband three, bias pass, main loop and
               band pass), and the inference kernel never.
8. train parity -- one micro-batch in f32 with dropout, layerdrop and
               masking at 0, same weights, kernel route against the plain
               route: loss within 1e-4 relative, every parameter gradient
               within 1e-3 of that parameter's max |g| (the k_proj biases,
               whose gradient is analytically 0, within 1e-6 of the largest
               gradient).
9. train t2s -- the TTS fine-tune path: ``cli/train.main --task t2s`` with
               the recipe's flags (recipes/tts_finetune.sh: guided
               attention, lr 1e-4, warmup 10000, batch 16, bf16, x-vectors,
               mel targets on the card, the train-attention kernel on) on
               speecht5_base at full width with random weights, over a
               synthetic corpus of 32 seeded 2-10 s utterances with letter
               transcripts (~14 a second) and a 512-d x-vector each: 3
               updates, then a resume that takes one more.  Every metric
               must be finite; the log-mel kernel must launch once per
               micro-batch, the train kernels once per text-encoder layer
               run (as in 7), the inference and conv kernels never.
10. t2s parity -- one f32 micro-batch with every dropout, the Tacotron
               prenet's and layerdrop at 0, same weights, kernel route (log
               mel and train attention on the card) against the plain route
               (the twins' mels, plain attention): target_mel within 2e-3,
               loss within 1e-4 relative, every parameter gradient within
               1e-3 of that parameter's max |g| (k_proj biases as in 6).
11. warm start -- the fine-tune recipe from a released checkpoint at
               speecht5_base_asr: a fairseq ``.pt`` written here (fairseq's
               key names, an ``args`` namespace, keys of the HuBERT head and
               the quantizer, text and CTC heads at another vocabulary),
               ``cli/convert.py --format fairseq``, every warm-started tensor
               bit-equal to the file's (the mismatched heads keep their
               fresh values), ``cli/train.py --finetune-from`` with the
               recipe's flags for 3 updates (the train kernels' launches as
               in 7), one greedy request served from the converted
               checkpoint (24 attention launches, 6 conv), and a train
               subprocess sent SIGTERM after its first update: it exits 0
               with a checkpoint at the update it reports, and a resume
               reaches --max-updates.
12. serve tts -- /tts in process: Service(--task t2s) at speecht5_base,
               bf16, every kernel on (the beam's overrides), the stop
               logits' bias at -8 so that a random model runs to its length
               bound, once with a HiFi-GAN vocoder at the released config
               (seeded HF-named weights through
               ``convert_hifigan_state_dict``) and once with
               ``--griffin-lim``, for two texts; per request wall ms, decode
               steps, seconds of audio and each kernel's launches, which
               must be the encoder's 24 and 12 decode-step launches a step;
               then one request under ``torch.profiler``: device launches
               per step, device busy and idle share.
13. tts parity -- f32, the same weights and prenet-dropout generator seed:
               the kernel path against the plain path on a padded batch of
               the two texts: lengths equal, mel and stop probabilities
               within 2e-3, focus rate within 1e-4, the HiFi-GAN waveform
               within 2e-3; once at the -8 stop bias (every row to its
               bound) and once with min_len_ratio 2.5 and a stop bias under
               which the longer text stops by threshold between its minimum
               and the middle of its range: every row at the step the first
               run's stop logits foretell.
14. train s2s -- the VC fine-tune path: ``cli/train.main --task s2s`` with
               the recipe's flags (recipes/vc_finetune.sh: guided
               attention, lr 1e-4, warmup 6000, batch 8, bf16, mel targets
               on the card, the train-attention and conv kernels on) on
               speecht5_base at full width with random weights, over 32
               seeded pairs of 2-6 s source and target audio with a 512-d
               x-vector each: 3 updates, then a resume that takes one more.
               Every metric must be finite; per micro-batch the log-mel
               kernel must launch once and the conv kernel 6 times (its
               backward, the twin's vjp, under feature_grad_mult 0.1), the
               train kernels once per encoder layer run, the inference and
               decode-step kernels never.
15. s2s parity -- one f32 micro-batch with every dropout, the prenet's and
               layerdrop at 0: the kernel route against the plain route,
               mels within 2e-3, loss within 1e-4 relative, every gradient
               within 1e-3 of its max |g| (or, where the plain route's own
               gradient moves by more than half that when its waveform is
               scaled by 1 + 2^-22, within twice that move), the conv_1..6
               weights' through the kernel's backward included; once as VC
               and once as SE
               (r 1, se_predict masking, SpeechToSpeechDataset(se_mode,
               device_mel): 2 log-mel launches, src_mel within 2e-3).
16. VC decode -- ``TTSDecoder.speech_to_speech`` at speecht5_base, bf16,
               batch 1, every kernel on, a 3 s source and a 512-d x-vector,
               HiFi-GAN at the released config, the stop bias at -8: per
               request wall ms, decode steps, audio seconds and launches
               (24 inference attention and 6 conv a request, 12 decode-step
               a step); then the f32 kernel path against the plain path:
               lengths equal, mel and stop probabilities within 2e-3, focus
               rate within 1e-4, waveform within 2e-3.
17. train s2c -- the SID fine-tune path: ``cli/train.main --task s2c`` at
               speecht5_base_sid with the recipe's flags
               (recipes/sid_finetune.sh: lr 2e-4, warmup 2000, accum 2,
               batch 8, --max-sample-size 128000, bf16) over 32 seeded 4-10
               s utterances of 8 speakers: class_map.txt written, 3 updates
               and a resume, metrics finite, the conv and train kernels'
               launches as in 14 (conv under feature_grad_mult 1.0), no
               log-mel.
18. s2c parity -- f32, dropout and layerdrop at 0: loss within 1e-4
               relative, gradients as in 15 (the conv weights' included);
               in eval the logits within 1e-4 of max |logit| and
               SIDClassifier's class ids equal (a difference only where the
               top-2 logit gap is < 1e-4); then one 8 s SID inference at
               bf16, twice: wall ms, 24 inference-attention and 6 conv
               launches.

19. evaluate -- in the train phase's directory, right after it: one more
               update of its run keeps two checkpoints; then
               ``cli/evaluate.py --task s2t`` (bf16, every kernel on, at the
               shapes phase 2 holds) on 8 seeded 2-5 s utterances: the beam
               (max_len 60) with ``--ensemble-last 2`` and a fusion LM from
               ``--lm-ckpt`` (a seeded lm_tiny, model-only), CTC greedy with
               ``--avg-last 2``, ``ctc_lexicon`` and ``ctc_rescore``, each
               printing its JSON line (a finite WER over 8 utterances); the
               three inference kernels must launch.
20. serve rescore -- Service(--decoder ctc_rescore) at speecht5_base_asr,
               bf16, batch 1, buckets 4/8/16 s, both inference kernels on,
               the 3 s, 11 s and 21 s requests served open-vocabulary, then
               with a lexicon of 2000 seeded words and a 3-gram ARPA over
               them (--lm-weight 0.5 --word-score 1): per request wall ms,
               pass 1's encoder and host (N-best) ms, pass 2 ms, and
               launches: 24 inference attention and 6 conv a chunk, no
               decode-step launch (pass 2 is teacher-forced); lexicon
               transcripts hold lexicon words only.
21. rescore parity -- f32, kernel route against plain route: pass 1 once (on
               the kernel route's posteriors, no length cap), pass 2 on
               each route's encoder output: scores within 1e-4 relative,
               the chosen hypotheses equal (unless a near tie of the plain
               route's top two totals, < 1e-4).
22. beam lm -- ``ASRDecoder`` with a fusion LM (the reference's geometry:
               d 1280, 20 pre-LN layers, 16 heads of Dh 80, ~0.45 B
               parameters, random seeded, bf16) at beam 5, max_len 200, CTC
               weight 0.3, LM weight 0.3, every kernel on, a 3 s and an 11 s
               request: wall ms, decode steps, and 12 + 20 decode-step
               launches a step (the decoder's self and cross, the LM's self
               at D 80), 24 inference attention and 6 conv a request; then
               one 20-step request under ``torch.profiler``: device
               launches a step, busy time and idle share.
23. beam lm parity -- f32, one 3 s request, max_len 60: the LM-fused beam
               with every kernel on against the plain route: the best score
               within 1e-4 relative, the best hypothesis equal (unless a
               near tie, as in 6).
24. train pretrain large -- joint pretraining at speecht5_large (24 + 6
               pre-LN layers, d 1024, the layer_norm conv extractor, the
               quantizer on): ``cli/train.main --task pretrain`` with
               recipes/joint_pretrain.sh's flags at batch 4 (text ratio 1,
               512 tokens a block, bf16, --normalize, mels on the card, the
               train-attention kernel on) over 16 seeded 8-15.6 s
               utterances with 500-class km labels and a seeded text
               corpus, the run seed the first whose first 3 updates hold
               both tasks: 3 updates and a resume, every metric finite; the
               log-mel kernel once per speech update, the train kernels
               once per encoder layer run (24 an update), the conv,
               inference and decode-step kernels never.  Then one bf16
               pretrain_speech and one s2t update (batch 4, 8-15.6 s) on
               each attention route under ``torch.profiler``: wall, device
               busy, idle share, peak memory, top device times.
25. pretrain parity -- f32 speecht5_large, one speech and one text batch
               of 2 with the HuBERT masks, Gumbel noise and codebook
               permutation handed to both routes: the kernel route against
               the plain route, losses within 1e-4 relative, gradients
               through ``grad_gate`` (norm_k's, the table's, the HuBERT
               head's and the quantizer's included).
26. serve large -- Service at speecht5_large, bf16, buckets 4/8/16 s, the
               3 s and 11 s requests: greedy (24 x 2 inference attention
               launches a request, no conv launch: the layer_norm mode has
               no kernel) and the beam (beam 5, max_len 200, CTC weight
               0.3; 12 decode-step launches a step), then one profiled
               beam request.
27. large parity -- f32, kernel route against plain route, buckets 4/16:
               greedy CTC ids (as 4) and the beam (as 6).

The launch counts are zeroed just before each driven path (serve, serve
beam, train, train t2s, the warm-started train and request, serve tts,
train s2s, the VC requests, train s2c, the SID inference, evaluate, the
two rescore runs, the LM-fused beam, Large's pretraining, greedy and beam
requests) and read just after; a kernel of that
path that was never launched fails.
Output: an early line with the card's name and power limit as nvidia-smi
gives them, one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  A watchdog ends a hung run with a
traceback after 1100 s.  Phases 24-27 take ``arch`` / ``overrides`` (or a
config) so that they rehearse on the CPU at a Large-shaped tiny preset.  The script opens no socket; the training loop's
data prefetch thread ends with each run, and the one train subprocess it
starts (phase 11) is waited for, or killed on a failure.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from speecht5_tpu_torch import config as C
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.cli.serve import SR, Service, build_parser
from speecht5_tpu_torch.data.audio import layer_norm_wav, write_wav
from speecht5_tpu_torch.decode.tts import CHECK_EVERY
from speecht5_tpu_torch.data.manifests import (TOKEN_BUCKETS, SpeechToTextDataset,
                                               bucket_length, collate_mel_targets)
from speecht5_tpu_torch.models.attention import band_from_table
from speecht5_tpu_torch.models.encoder import BAND_ROW_MULTIPLE
from speecht5_tpu_torch.models.layers import EncoderLayer
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.ops.mel import mel_filterbank
from speecht5_tpu_torch.train.trainer import Trainer, TrainConfig, device_mel_batch

WATCHDOG_S = 1100
# published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
KERNELS = {
    # the path's bf16 route; f32 keeps the CUDA-core kernels of source_f32
    "banded_flash_attention": {
        "source": "speecht5_tpu_torch/csrc/banded_attention_fwd.cu",
        "source_f32": "speecht5_tpu_torch/csrc/banded_attention.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:253",
    },
    "conv_stack": {
        "source": "speecht5_tpu_torch/csrc/conv_stack.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:753",
    },
    "banded_attention_train_fwd": {
        "source": "speecht5_tpu_torch/csrc/banded_attention_fwd.cu",
        "source_f32": "speecht5_tpu_torch/csrc/banded_attention_train.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:427",
    },
    "banded_attention_train_bwd_dq": {
        "source": "speecht5_tpu_torch/csrc/banded_attention_train_bwd.cu",
        "source_f32": "speecht5_tpu_torch/csrc/banded_attention_train.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:446",
    },
    "banded_attention_train_bwd_dkv": {
        "source": "speecht5_tpu_torch/csrc/banded_attention_train_bwd.cu",
        "source_f32": "speecht5_tpu_torch/csrc/banded_attention_train.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:456",
    },
    "fused_log_mel": {
        "source": "speecht5_tpu_torch/csrc/log_mel.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:154",
    },
    "flash_attention_bias": {
        "source": "speecht5_tpu_torch/csrc/flash_attention_bias.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:624",
    },
}
TRAIN_KERNELS = ("banded_attention_train_fwd", "banded_attention_train_bwd_dq",
                 "banded_attention_train_bwd_dkv")
# the case of each kernel that its path runs: the served chunk (bf16, batch
# 1), the recipe's train step (bf16, attention dropout 0.1), the t2s step's
# mel targets (f32, 16 rows of 768 frames) and the beam's grouped
# cross-attention step through the cached entry (bf16, batch 1, beam 5)
MAIN_CASE = {"banded_flash_attention": "bfloat16/b1", "conv_stack": "bfloat16/b1",
             **{n: "bfloat16/r0.1" for n in TRAIN_KERNELS},
             "fused_log_mel": "float32/b16", "flash_attention_bias": "bfloat16/cross_cached"}
KERNEL_OVERRIDES = ["encoder.use_pallas_attn=True", "conv_features.impl='pallas'"]
# the beam arm's decode steps through flash_attention_bias as well
BEAM_OVERRIDES = KERNEL_OVERRIDES + ["decoder.use_pallas_attn=True"]
# cli/serve.py's beam defaults (JAX cli/serve.py:549-551)
BEAM, BEAM_MAX_LEN = 5, 200
# the fusion LM (models/lm.TransformerLMConfig(): d 1280, 16 heads, 20
# pre-LN layers): its head size is the decode-step kernel's D 80
LM_HEADS, LM_DH = 16, 80
# the evaluate phase's s2t batch: 8 clips of 2-5 s in one batch (encoder
# frames up to those of 5 s), the beam's 8 x 5 rows at max_len 60 (a
# 61-position cache) and the tiny fusion LM's 4 heads of Dh 16
EVAL_BATCH, EVAL_MAX_S, EVAL_MAX_LEN = 8, 5.0, 60
EVAL_FRAMES = C.ConvFeatureConfig().out_length(int(EVAL_MAX_S * 16000))
EVAL_CONV_T = (int(EVAL_MAX_S * 16000) - 10) // 5 + 1    # after conv 0 (k 10, s 5)
EVAL_LM_HEADS, EVAL_LM_DH = 4, 16
TRAIN_OVERRIDES = ["encoder.use_pallas_attn_train=True", "conv_features.impl='pallas'"]
# recipes/asr_finetune.sh (the flags of the s2t path; its lr/warmup/updates
# and --finetune-from are the run's, not the step's)
RECIPE_FLAGS = ["--ctc-weight", "0.5", "--label-smoothing", "0.1", "--accum", "2",
                "--batch-size", "16", "--normalize", "--dtype", "bfloat16"]
# zero every stochastic part of the train step, for the parity phase
DETERMINISTIC = [f"{s}.{f}=0.0" for s in ("encoder", "decoder")
                 for f in ("dropout", "attention_dropout", "activation_dropout",
                           "layerdrop")] + ["masking.mask_prob=0.0"]
# letter dictionary: 4 specials + 75 symbols + <mask> + <ctc_blank> = 81
DICT_SYMBOLS = (["|", "'"] + [chr(ord("A") + i) for i in range(26)]
                + [f"x{i}" for i in range(47)])
DICT_CFG = {"vocab_size": 81, "blank_id": 80}
TOL_F32 = 1e-4          # absolute
TOL_BF16_REL = 3e-2     # max |diff| / max |ref|
TOL_MEL = 2e-3          # absolute, on log10-mel
# recipes/tts_finetune.sh (the flags of the t2s step; its data, updates and
# --finetune-from are the run's)
T2S_FLAGS = ["--guided-attn", "--lr", "1e-4", "--warmup", "10000",
             "--batch-size", "16", "--dtype", "bfloat16"]
T2S_OVERRIDES = ["encoder.use_pallas_attn_train=True"]
# every stochastic part of the t2s step at 0, for its parity phase
T2S_DETERMINISTIC = DETERMINISTIC + ["speech_prenet.dropout=0.0",
                                     "speech_postnet.postnet_dropout=0.0"]
# recipes/vc_finetune.sh and recipes/sid_finetune.sh (the flags of the s2s
# and s2c steps; their data, updates and --finetune-from are the run's)
S2S_FLAGS = ["--guided-attn", "--lr", "1e-4", "--warmup", "6000", "--batch-size", "8",
             "--dtype", "bfloat16"]
S2C_FLAGS = ["--lr", "2e-4", "--warmup", "2000", "--accum", "2", "--batch-size", "8",
             "--max-sample-size", "128000", "--dtype", "bfloat16"]
SID_SPEAKERS = 8
# encoder frames at Base: a 3 s VC source, the 6 s s2s audio bucket, the
# 8 s s2c crop (--max-sample-size 128000)
VC_SOURCE_S = 3.0
VC_SOURCE_FRAMES = C.ConvFeatureConfig().out_length(int(VC_SOURCE_S * 16000))
S2S_SOURCE_FRAMES = C.ConvFeatureConfig().out_length(6 * 16000)
SID_FRAMES = C.ConvFeatureConfig().out_length(128000)


def log(msg):
    print(msg, flush=True)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def environment_line() -> str:
    drv = _run(["nvidia-smi", "--query-gpu=driver_version",
                "--format=csv,noheader"]).stdout.strip().splitlines()[0]
    try:
        nvcc = K.find_nvcc()
        nvcc_ver = _run([nvcc, "--version"]).stdout.strip().splitlines()[-1]
    except RuntimeError as e:
        nvcc, nvcc_ver = None, str(e)
    return json.dumps({
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "driver": drv, "nvcc": nvcc, "nvcc_version": nvcc_ver,
        "python": sys.version.split()[0],
    })


def write_dictionary(directory: str) -> str:
    path = os.path.join(directory, "dict.ltr.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i, sym in enumerate(DICT_SYMBOLS):
            f.write(f"{sym} {1000 - i}\n")
    return path


def write_lexicon_lm(directory: str, n_words: int = 2000, seed: int = 0,
                     gz: bool = False):
    """A seeded lexicon of ``n_words`` distinct words of 2-8 of the
    dictionary's letters ("WORD<TAB>W O R D" lines) and a 3-gram ARPA
    (natural backoff structure: every bigram's words and every trigram's
    leading bigram are listed, so backoff weights are read) over them:
    2 bigrams and 1 trigram a word, log10 probabilities and backoffs drawn
    from ``seed``; ``gz`` writes ``lm.arpa.gz``.  Returns (lexicon path,
    ARPA path)."""
    import gzip

    rng = np.random.default_rng(seed)
    letters = np.array([chr(ord("A") + i) for i in range(26)])
    words = set()
    while len(words) < n_words:
        words.add("".join(rng.choice(letters, int(rng.integers(2, 9)))))
    words = sorted(words)
    lexicon = os.path.join(directory, "lexicon.txt")
    with open(lexicon, "w", encoding="utf-8") as f:
        f.writelines(f"{w}\t{' '.join(w)}\n" for w in words)
    uni = [f"{rng.uniform(-5.0, -1.5):.4f}\t{w}\t{rng.uniform(-0.8, 0.0):.4f}"
           for w in ["<s>", "</s>", *words]]
    pairs = sorted({(words[i], words[j]) for i, j in
                    rng.integers(0, n_words, (2 * n_words, 2))})
    bi = [f"{rng.uniform(-3.0, -0.2):.4f}\t{a} {b}\t{rng.uniform(-0.6, 0.0):.4f}"
          for a, b in pairs]
    tri = sorted({(*pairs[i], words[j]) for i, j in
                  zip(rng.integers(0, len(pairs), n_words),
                      rng.integers(0, n_words, n_words))})
    tri = [f"{rng.uniform(-2.0, -0.1):.4f}\t{' '.join(t)}" for t in tri]
    text = ("\\data\\\n" + f"ngram 1={len(uni)}\nngram 2={len(bi)}\nngram 3={len(tri)}\n"
            + "\n\\1-grams:\n" + "\n".join(uni) + "\n\n\\2-grams:\n" + "\n".join(bi)
            + "\n\n\\3-grams:\n" + "\n".join(tri) + "\n\n\\end\\\n")
    arpa = os.path.join(directory, "lm.arpa.gz" if gz else "lm.arpa")
    with (gzip.open(arpa, "wt", encoding="utf-8") if gz
          else open(arpa, "w", encoding="utf-8")) as f:
        f.write(text)
    return lexicon, arpa


def serve_config(base: C.SpeechT5Config, dtype: str, kernels: bool,
                 overrides=KERNEL_OVERRIDES):
    cfg = C.replace(base, dtype=dtype, **DICT_CFG)
    return C.apply_overrides(cfg, overrides) if kernels else cfg


def make_service(cfg, model, dict_path, device, buckets, decoder="ctc_greedy",
                 max_len=BEAM_MAX_LEN, extra=()):
    args = build_parser().parse_args([
        "--ckpt", "random-init", "--dict", dict_path,
        "--decoder", decoder, "--max-batch", "1", "--max-len", str(max_len),
        "--asr-buckets", buckets, "--dtype", cfg.dtype, *extra,
    ])
    return Service(args, model=model, cfg=cfg, device=device)


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Deterministic speech-like test signal: a few gliding tones + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    wav = 0.02 * rng.standard_normal(t.shape)
    for _ in range(4):
        f0, f1 = rng.uniform(100, 3000, size=2)
        wav += 0.1 * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * t[-1])))
    return wav.astype(np.float32)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------ build


def phase_build():
    t0 = time.perf_counter()
    libs = K.build_all()
    secs = time.perf_counter() - t0
    log(json.dumps({"phase": "build", "seconds": secs,
                    "libraries": {n: str(p) for n, p in libs.items()}}))
    return secs


# ---------------------------------------------------------------- kernels


def time_ms(fn, reps: int = 20) -> float:
    """Per-call time: the median over ``reps`` samples, each a run of
    back-to-back calls between one pair of CUDA events, divided by the
    calls.  The calls per sample are set from a timed warm-up so that a
    sample lasts about 2 ms: a call of tens of microseconds is then timed
    as the card runs it in a stream, not with one event pair's and one
    host round trip's overhead on top."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    calls = int(min(200, max(1, 2.0 // max(a.elapsed_time(b), 1e-3))))
    times = []
    for _ in range(reps):
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def graph_ms(fn, calls: int = 100, reps: int = 10) -> float:
    """Device time a call: ``calls`` calls captured in one CUDA graph,
    replayed between one pair of CUDA events, the median over ``reps``
    replays divided by the calls.  The card runs the launches back to back
    with no host enqueue between them, so a call of a few microseconds is
    timed as the card runs it, not as fast as the host can issue it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):      # warm-up off the capture, as capture wants
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def _bound(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _achieved(flops: float, bound_ms: float, ms: float) -> dict:
    """The share of the bound a kernel reaches (bound_ms / ms) and its
    rate in TFLOP/s, both over the work the function needs (the flops the
    bound counts), not the kernel's own."""
    return {"bound_share": bound_ms / ms, "achieved_tflops": flops / (ms * 1e-3) / 1e12}


def _check(dtype, got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        ok, tol = err <= TOL_F32, f"atol {TOL_F32}"
    else:
        scale = ref.float().abs().max().item()
        ok, tol = err <= TOL_BF16_REL * scale, f"{TOL_BF16_REL} x max|ref| = {TOL_BF16_REL * scale:.4g}"
    if not torch.isfinite(got.float()).all():
        ok = False
    return err, tol, ok


def path_band(table, T, M, device):
    """The band as the encoder hands it to the kernels: a [Dh, T, T] view of
    rows padded to a multiple of 8, built on ``device``."""
    return band_from_table(table.to(device), T, M, row_multiple=BAND_ROW_MULTIPLE)


def attention_case(batch, dtype, device="cuda", seed=0, T=799, valid=None, heads=12):
    """Base encoder shapes: batch x 12 heads (Large: 16), T=799 (16 s bucket), Dh=64,
    max distance 160, ragged lengths including a row of length 0; the band
    row-padded, as the encoder builds it.  With ``valid`` every row holds
    that many valid keys, as one request's heads do (the text encoder of
    /tts: T = --tts-bucket-tokens, valid = the text's ids)."""
    g = torch.Generator().manual_seed(seed)
    N, Dh, M = heads * batch, 64, 160
    q = (torch.randn(N, T, Dh, generator=g) * Dh ** -0.5).to(dtype)
    k = torch.randn(N, T, Dh, generator=g).to(dtype)
    v = torch.randn(N, T, Dh, generator=g).to(dtype)
    table = (torch.randn(2 * M, Dh, generator=g) * 0.125).to(dtype)
    band = path_band(table, T, M, device)
    if valid is None:
        lengths = torch.randint(1, T + 1, (N,), generator=g, dtype=torch.int32)
        lengths[0], lengths[1], lengths[5] = 0, T, min(613, T)
    else:
        lengths = torch.full((N,), valid, dtype=torch.int32)
    return [t.to(device) for t in (q, k, v)] + [band, lengths.to(device)]


def conv_case(batch, dtype, device="cuda", seed=1, T=51199):
    """Base feature-extractor layers 1-6 after conv 0, by default on the 16
    s bucket: x [batch, T, 512], (k, s) = (3, 2) x 4, (2, 2) x 2."""
    g = torch.Generator().manual_seed(seed)
    specs = ((3, 2),) * 4 + ((2, 2),) * 2
    x = torch.randn(batch, T, 512, generator=g).to(dtype)
    ws = [(torch.randn(k, 512, 512, generator=g) / (k * 512) ** 0.5).to(dtype)
          for k, _ in specs]
    return x.to(device), [w.to(device) for w in ws], specs


def _attention_record(batch, dtype, T=799, valid=None, heads=12):
    q, k, v, band, lengths = attention_case(batch, dtype, T=T, valid=valid, heads=heads)
    N, T, Dh = q.shape
    got = K.banded_flash_attention(q, k, v, band, lengths)
    ref = K.banded_flash_attention_plain(q, k, v, band, lengths)
    torch.cuda.synchronize()
    err, tol, ok = _check(dtype, got, ref)
    keep = torch.arange(T, device=q.device)[None, None, :] < lengths[:, None, None]
    bias = torch.einsum("nqd,dqk->nqk", q.float(), band.float())
    mask = torch.where(keep, bias, torch.full((), K.NEG_INF, device=q.device)).to(dtype)
    # bytes: q, k, v, out and the band once; flops: q.k, q.band and p.v
    # over the valid keys
    nbytes = (4 * N * T * Dh + Dh * T * T) * q.element_size() + 4 * N
    flops = 6.0 * T * Dh * lengths.double().sum().item()
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    rec = {
        "max_abs_err": err, "tolerance": tol,
        "errors_over_max_ref": err / max(ref.float().abs().max().item(), 1e-30),
        "ms": time_ms(lambda: K.banded_flash_attention(q, k, v, band, lengths)),
        "plain_ms": time_ms(lambda: K.banded_flash_attention_plain(q, k, v, band, lengths)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0)),
        "library_call": "F.scaled_dot_product_attention(attn_mask=bias+mask)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": {"N": N, "T": T, "Dh": Dh},
    }
    if dtype == torch.bfloat16:
        rec["parts_ms"] = _fwd_parts_ms(q, k, v, band, lengths, K.banded_flash_attention)
    return ok, rec


def _fwd_parts_ms(q, k, v, band, lengths, count, train=False, rate=0.0, seed=0) -> dict:
    """The time of each launch of a bf16 (wgmma) forward on one case, each
    counted on ``count``: the bias pass and the main loop."""
    bias = K.fwd_bias(q, band, count)
    return {"bias_pass": time_ms(lambda: K.fwd_bias(q, band, count), reps=10),
            "main_loop": time_ms(lambda: K.fwd_main(q, k, v, lengths, bias, count, train,
                                                    rate, seed), reps=10)}


def _conv_flops(x, ws, specs) -> float:
    """The forward's flops: per layer 2 x B x T_out x k x Cin x Cout."""
    B, t, _ = x.shape
    flops = 0.0
    for (k, s), w in zip(specs, ws):
        t = (t - k) // s + 1
        flops += 2.0 * B * t * k * w.shape[1] * w.shape[2]
    return flops


def _conv_library(x, ws, specs):
    """cuDNN's route for the same function: channels-first ``F.conv1d`` +
    exact GELU per layer, on [B, C, T] copies of x and [Cout, Cin, k]
    copies of the weights -> (x copy, weight copies, fn(x, ws) -> y)."""
    xt = x.transpose(1, 2).contiguous()
    wt = [w.permute(2, 1, 0).contiguous() for w in ws]

    def library(y, weights):
        for (_, s), w in zip(specs, weights):
            y = F.gelu(F.conv1d(y, w, stride=s))
        return y

    return xt, wt, library


def _conv_record(batch, dtype, T=51199):
    x, ws, specs = conv_case(batch, dtype, T=T)
    got = K.conv_stack(x, ws, specs)
    ref = K.conv_stack_plain(x, ws, specs)
    torch.cuda.synchronize()
    err, tol, ok = _check(dtype, got, ref)
    B = x.shape[0]
    flops = _conv_flops(x, ws, specs)
    # bytes: x, the weights and the final output once (not the intermediates)
    nbytes = (x.numel() + sum(w.numel() for w in ws) + got.numel()) * x.element_size()
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    xt, wt, library = _conv_library(x, ws, specs)
    ms = time_ms(lambda: K.conv_stack(x, ws, specs))
    return ok, {
        "max_abs_err": err, "tolerance": tol, "ms": ms,
        "plain_ms": time_ms(lambda: K.conv_stack_plain(x, ws, specs)),
        "library_ms": time_ms(lambda: library(xt, wt)),
        "library_call": "F.conv1d + F.gelu per layer",
        "bound_ms": bound_ms, "bound_by": bound_by,
        **_achieved(flops, bound_ms, ms),
        "shape": {"B": B, "T_in": x.shape[1], "C": x.shape[2], "T_out": got.shape[1]},
    }


def _conv_bwd_record(batch, dtype, T):
    """The conv stack under a gradient, as the s2s / s2c train steps run it:
    the backward of ``K.conv_stack`` (the vjp of ``K.conv_stack_library``,
    recomputing the forward through cuDNN's conv1d) for a random output
    gradient, held against autograd through ``K.conv_stack_plain`` (dx and
    every dw); timed beside ``torch.autograd.grad`` through cuDNN's conv1d
    + GELU (which keeps the forward's activations: no recompute).  Its work: the
    data and weight gradients, twice the forward's products; its bytes: x,
    the weights, the output gradient, dx and the dw once."""
    x, ws, specs = conv_case(batch, dtype, T=T)
    leaves = [t.detach().requires_grad_() for t in (x, *ws)]
    y = K.conv_stack(leaves[0], leaves[1:], specs)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)).to(y)
    y_ref = K.conv_stack_plain(leaves[0], leaves[1:], specs)
    got = torch.autograd.grad(y, leaves, g, retain_graph=True)
    ref = torch.autograd.grad(y_ref, leaves, g, retain_graph=True)
    torch.cuda.synchronize()
    ok, errs = True, {}
    for name, a, b in zip(["dx"] + [f"dw{i + 1}" for i in range(len(ws))], got, ref):
        errs[name], _, good = _check(dtype, a, b)
        ok = ok and good
    flops = 2 * _conv_flops(x, ws, specs)
    nbytes = (2 * x.numel() + 2 * sum(w.numel() for w in ws) + g.numel()) * x.element_size()
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    xt, wt, library = _conv_library(x, ws, specs)
    lib_leaves = [t.requires_grad_() for t in (xt, *wt)]
    y_lib = library(lib_leaves[0], lib_leaves[1:])
    g_lib = g.transpose(1, 2).contiguous()
    ms = time_ms(lambda: torch.autograd.grad(y, leaves, g, retain_graph=True), reps=5)
    return ok, {
        "max_abs_err": max(errs.values()), "errors": errs,
        "tolerance": (f"atol {TOL_F32}" if dtype == torch.float32
                      else f"{TOL_BF16_REL} x max|ref| of each gradient"),
        "ms": ms,
        "plain_ms": time_ms(lambda: torch.autograd.grad(y_ref, leaves, g, retain_graph=True),
                            reps=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(y_lib, lib_leaves, g_lib,
                                                          retain_graph=True), reps=5),
        "library_call": "torch.autograd.grad through F.conv1d + F.gelu per layer",
        "bound_ms": bound_ms, "bound_by": bound_by, **_achieved(flops, bound_ms, ms),
        "shape": {"B": x.shape[0], "T_in": T, "C": x.shape[2], "T_out": y.shape[1]},
    }


def train_attention_case(dtype, device="cuda", batch=16, T=799, seed=2, heads=12):
    """The train step's attention shapes: batch x 12 heads (Large: 16), T = 799 (16 s),
    Dh = 64, max distance 160; ragged lengths with a row of length 0 and a
    full one; a random output gradient."""
    g = torch.Generator().manual_seed(seed)
    N, Dh, M = heads * batch, 64, 160
    q = (torch.randn(N, T, Dh, generator=g) * Dh ** -0.5).to(dtype)
    k, v, do = (torch.randn(N, T, Dh, generator=g).to(dtype) for _ in range(3))
    table = (torch.randn(2 * M, Dh, generator=g) * 0.125).to(dtype)
    band = path_band(table, T, M, device)
    lengths = torch.randint(1, T + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0], lengths[1] = 0, T
    return [t.to(device) for t in (q, k, v)] + [band] + [t.to(device) for t in (lengths, do)]


def _train_bwd_parts_ms(args) -> dict:
    """The time of each launch of the bf16 (wgmma) backward on one case:
    the bias pass (with delta; the band comes row-padded, so no copy), dq's
    main loop and band pass, dk/dv's main loop."""
    q, k, v, band, lengths, o, do, stats, rate, seed = args
    count = K.banded_attention_train_bwd_dq
    padded, bias, delta = K.train_bwd_bias(q, band, o, do, count)
    main = (q, k, v, do, lengths, stats, bias, delta, rate, seed)
    ds, dq_acc = K.train_bwd_dq_main(*main)
    return {"bias_pass": time_ms(lambda: K.train_bwd_bias(q, band, o, do, count), reps=10),
            "dq_main": time_ms(lambda: K.train_bwd_dq_main(*main), reps=10),
            "dq_band_pass": time_ms(lambda: K.train_bwd_band(q, padded, ds, dq_acc), reps=10),
            "dkv_main": time_ms(lambda: K.train_bwd_dkv_main(*main), reps=10)}


def _train_records(dtype, rate, seed=1234, batch=16, T=799, heads=12):
    """The three train kernels against their twins on one case, with the
    twin's forward outputs feeding both backward versions."""
    q, k, v, band, lengths, do = train_attention_case(dtype, batch=batch, T=T, heads=heads)
    N, T, Dh = q.shape
    o, stats = K.banded_attention_train_fwd(q, k, v, band, lengths, rate, seed)
    o_ref, stats_ref = K.banded_attention_train_fwd_plain(q, k, v, band, lengths,
                                                          rate, seed)
    args = (q, k, v, band, lengths, o_ref, do, stats_ref, rate, seed)
    outs = {"banded_attention_train_fwd": ((o,), (o_ref,), ("o",)),
            "banded_attention_train_bwd_dq": (
                K.banded_attention_train_bwd_dq(*args),
                K.banded_attention_train_bwd_dq_plain(*args), ("dq", "dband")),
            "banded_attention_train_bwd_dkv": (
                K.banded_attention_train_bwd_dkv(*args),
                K.banded_attention_train_bwd_dkv_plain(*args), ("dk", "dv"))}
    torch.cuda.synchronize()

    # SDPA with the float bias (q.band + the key mask) as the yardstick:
    # forward, and one autograd.grad call for the backward
    keep = torch.arange(T, device=q.device)[None, None, :] < lengths[:, None, None]
    bias = torch.einsum("nqd,dqk->nqk", q.float(), band.float())
    bias = torch.where(keep, bias, torch.full((), K.NEG_INF, device=q.device)).to(dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    sdpa_out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                              dropout_p=rate, scale=1.0)
    library = {
        "banded_attention_train_fwd": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, dropout_p=rate, scale=1.0),
        "banded_attention_train_bwd_dq": lambda: torch.autograd.grad(
            sdpa_out, leaves, do, retain_graph=True),
    }
    library["banded_attention_train_bwd_dkv"] = library["banded_attention_train_bwd_dq"]
    fns = {"banded_attention_train_fwd": (
               lambda: K.banded_attention_train_fwd(q, k, v, band, lengths, rate, seed),
               lambda: K.banded_attention_train_fwd_plain(q, k, v, band, lengths, rate, seed)),
           "banded_attention_train_bwd_dq": (
               lambda: K.banded_attention_train_bwd_dq(*args),
               lambda: K.banded_attention_train_bwd_dq_plain(*args)),
           "banded_attention_train_bwd_dkv": (
               lambda: K.banded_attention_train_bwd_dkv(*args),
               lambda: K.banded_attention_train_bwd_dkv_plain(*args))}

    # the work these inputs need: keys past a row's length only for a row
    # of length 0 (it attends to all T); flops per (n, i, j) pair over the
    # valid keys -- fwd q.k, q.band, p.v; dq adds dO.v, ds.k, ds.band and
    # q.ds; dkv dO.v, p.dO and ds.q
    eff = torch.where(lengths > 0, lengths, T).double().sum().item()
    pairs, e = T * eff, q.element_size()
    big, band_b, small = N * T * Dh * e, Dh * T * T * e, 2 * N * T * 4 + 4 * N
    work = {"banded_attention_train_fwd": (4 * big + band_b + small, 6 * Dh * pairs),
            "banded_attention_train_bwd_dq": (6 * big + band_b + Dh * T * T * 4 + small,
                                              12 * Dh * pairs),
            "banded_attention_train_bwd_dkv": (7 * big + band_b + small, 10 * Dh * pairs)}
    parts = _train_bwd_parts_ms(args) if dtype == torch.bfloat16 else None
    fwd_parts = (_fwd_parts_ms(q, k, v, band, lengths, K.banded_attention_train_fwd,
                               True, rate, seed) if dtype == torch.bfloat16 else None)
    records, ok = {}, True
    for name, (got, ref, labels) in outs.items():
        errs, rel = {}, {}
        for lab, a, b in zip(labels, got, ref):
            err, _, good = _check(dtype, a, b)
            errs[lab] = err
            rel[lab] = err / max(b.float().abs().max().item(), 1e-30)
            ok = ok and good
        bound_ms, bound_by = _bound(*work[name], dtype)
        kern, twin = fns[name]
        records[name] = {
            "max_abs_err": max(errs.values()), "errors": errs,
            "errors_over_max_ref": rel,
            "tolerance": (f"atol {TOL_F32}" if dtype == torch.float32 else
                          f"{TOL_BF16_REL} x max|ref| of each output"),
            "ms": time_ms(kern, reps=10), "plain_ms": time_ms(twin, reps=5),
            "library_ms": time_ms(library[name], reps=10),
            "library_call": ("F.scaled_dot_product_attention(attn_mask=bias+mask)"
                             + ("" if name.endswith("fwd") else
                                " backward (dq, dk, dv, dbias in one call)")),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": {"N": N, "T": T, "Dh": Dh, "rate": rate},
        }
    if parts is not None:
        records["banded_attention_train_fwd"]["parts_ms"] = fwd_parts
        records["banded_attention_train_bwd_dq"]["parts_ms"] = {
            k: parts[k] for k in ("bias_pass", "dq_main", "dq_band_pass")}
        records["banded_attention_train_bwd_dkv"]["parts_ms"] = {
            k: parts[k] for k in ("bias_pass", "dkv_main")}
    return ok, records


def mel_case(batch, samples, center, device="cuda", seed=3):
    """Seeded speech-like rows as the t2s collator hands them to the
    kernel: with ``center`` False each row an utterance of 2 s up to the
    row length, reflect-padded by n_fft / 2 and zero-padded to ``samples``
    (the first row fills it); with ``center`` True plain utterances of
    ``samples`` samples."""
    rng = np.random.default_rng(seed)
    wav = np.zeros((batch, samples), np.float32)
    for b in range(batch):
        if center:
            wav[b] = synth_audio(samples / SR, seed=seed + 10 * b)[:samples]
            continue
        n = samples - 1024 if b == 0 else int(rng.integers(2 * SR, samples - 1024))
        x = np.pad(synth_audio(n / SR, seed=seed + 10 * b), (512, 512), mode="reflect")
        wav[b, : len(x)] = x
    return torch.from_numpy(wav).to(device)


def _mel_record(batch, samples, center, n_mels=80, n_fft=1024, hop=256):
    wav = mel_case(batch, samples, center)
    kw = dict(n_fft=n_fft, hop=hop, n_mels=n_mels, center=center)
    got = K.fused_log_mel(wav, **kw)
    ref = K.fused_log_mel_plain(wav, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    ok = err <= TOL_MEL and bool(torch.isfinite(got).all())
    B, frames, _ = got.shape
    n_bins = n_fft // 2 + 1
    # the operations the function needs, not the twin's O(n^2) DFT: per
    # frame the window, one real FFT (2.5 n log2 n flops, the usual count),
    # the magnitudes (two products, two sums and a root per bin), a
    # multiply-add for each non-zero filterbank entry and a log per mel;
    # bytes: the waveform read once and the output written once
    fb_np = mel_filterbank(16000, n_fft, n_mels, 80.0, 7600.0)
    per_frame = (n_fft + 2.5 * n_fft * math.log2(n_fft) + 5 * n_bins
                 + 2 * np.count_nonzero(fb_np) + n_mels)
    flops = B * frames * per_frame
    nbytes = 4 * (wav.numel() + got.numel())
    bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
    win = torch.hann_window(n_fft, periodic=True, device=wav.device)
    fb = torch.from_numpy(fb_np).to(wav.device)

    def library():
        spec = torch.stft(wav, n_fft, hop, window=win, center=center,
                          pad_mode="reflect", return_complex=True)
        return torch.log10(torch.clamp_min(spec.abs().transpose(1, 2) @ fb.t(), 1e-10))

    ms = time_ms(lambda: K.fused_log_mel(wav, **kw))
    return ok, {
        "max_abs_err": err, "tolerance": f"atol {TOL_MEL}", "ms": ms,
        **_achieved(flops, bound_ms, ms),
        "plain_ms": time_ms(lambda: K.fused_log_mel_plain(wav, **kw), reps=10),
        "library_ms": time_ms(library),
        "library_call": "torch.stft(return_complex) -> abs -> f32 matmul with the "
                        "filterbank -> log10",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": {"B": B, "T": wav.shape[1], "frames": frames, "n_fft": n_fft,
                  "hop": hop, "n_mels": n_mels, "center": center},
    }


def flash_bias_case(case, dtype, device="cuda", seed=4):
    """The beam's decode-step shapes at batch 1, beam 5, Dh 64: "cross",
    the grouped cross-attention of a 16 s chunk (N = 12 heads, G = 5 beam
    queries, Tk = 799 frames, the 11 s request's 549 valid); "self", the
    cached self-attention at step 100 of max_len 200 (N = 5 x 12 rows, one
    query, Tk = 201 cache positions, the causal 101 valid), as [N, T, D]
    rows; "lm_self", the fusion LM's cached self-attention at the same
    step (N = 5 x 16 rows, Dh 80).  The key mask comes as the path gives
    it: one row per sample (cross, [1, Tk]) or per beam row (self, [5,
    Tk]), each serving its heads.  -> q, k, v, key_valid."""
    g = torch.Generator().manual_seed(seed)
    N, Tq, Tk, valid, mask_rows, D = {"cross": (12, 5, 799, 549, 1, 64),
                                      "self": (60, 1, 201, 101, 5, 64),
                                      "lm_self": (5 * LM_HEADS, 1, 201, 101, 5, LM_DH)}[case]
    q = (torch.randn(N, Tq, D, generator=g) * D ** -0.5).to(dtype)
    k, v = (torch.randn(N, Tk, D, generator=g).to(dtype) for _ in range(2))
    key_valid = (torch.arange(Tk) < valid)[None, :].expand(mask_rows, Tk).contiguous()
    return [t.to(device) for t in (q, k, v, key_valid)]


def flash_bias_cache_case(case, dtype, device="cuda", seed=4):
    """The decode-step shapes as the decoder hands them to the cached entry.
    "self_cache": ``MultiheadAttention._cached_step`` at step 100: q [5, 1,
    12, 64], the cache buffers [5, 201, 12, 64] as they lie, the int64
    ancestry map [5, 201] (beams that share and swap ancestors) and the
    causal mask [1, 201] of position 100 (101 valid).  "cross_cached":
    ``_cross_step``, the 5 beams' queries grouped as q [1, 5, 12, 64]
    against the head-major K/V of ``precompute_kv`` ([1, 12, 799, 64]
    storage viewed as [1, 799, 12, 64]) and the sample's mask [1, 799]
    (549 valid), no row map.  The TTS decoder's steps at batch 1:
    "tts_self", the cached self-attention at step 200 of a 513-position
    cache (``--max-frames`` 1024 / r + 1; 201 valid), no row map;
    "tts_cross", the cross-attention against the 128-token text bucket (the
    longer served text's 58 valid), head-major K/V, asked for the
    max-probability output as the decoder asks; "vc_cross", the same
    against a 3 s VC source's 149 encoder frames, all valid;
    "lm_self_cache", the fusion LM's step as "self_cache" at its 16 heads
    of Dh 80 (the cache [5, 201, 16, 80]).  The evaluate phase's beam at
    batch 8 x beam 5, step 30 of max_len 60: "eval_self_cache" (q [40, 1,
    12, 64], the cache [40, 61, 12, 64], each row's ancestors within its
    sample's 5 rows), "eval_lm_self_cache" (the tiny LM's 4 heads of Dh 16)
    and "eval_cross_cached" (q [8, 5, 12, 64] against 5 s of encoder
    frames, each sample's own 2-5 s of them valid).  -> q4, k4, v4,
    key_valid, rows."""
    g = torch.Generator().manual_seed(seed)
    H, D = {"lm_self_cache": (LM_HEADS, LM_DH),
            "eval_lm_self_cache": (EVAL_LM_HEADS, EVAL_LM_DH)}.get(case, (12, 64))
    if case.startswith("large_"):       # SpeechT5-Large's decoder: 16 heads
        H, case = LARGE_HEADS, case[len("large_"):]
    if case in ("tts_self", "tts_cross", "vc_cross"):
        Tk, valid = {"tts_self": (513, 201), "tts_cross": (TTS_BUCKET_TOKENS, TTS_TEXT_IDS),
                     "vc_cross": (VC_SOURCE_FRAMES, VC_SOURCE_FRAMES)}[case]
        q4 = (torch.randn(1, 1, H, 64, generator=g) * 64 ** -0.5).to(dtype)
        if case == "tts_self":
            k4, v4 = (torch.randn(1, Tk, H, 64, generator=g).to(dtype) for _ in range(2))
        else:
            k4, v4 = (torch.randn(1, H, Tk, 64, generator=g).to(dtype).transpose(1, 2)
                      for _ in range(2))
        rows = None
        key_valid = torch.arange(Tk)[None, :] < valid
    elif case in ("self_cache", "lm_self_cache", "eval_self_cache", "eval_lm_self_cache"):
        B, Tc, pos = ((EVAL_BATCH * BEAM, EVAL_MAX_LEN + 1, 30) if case.startswith("eval")
                      else (BEAM, BEAM_MAX_LEN + 1, 100))
        q4 = (torch.randn(B, 1, H, D, generator=g) * D ** -0.5).to(dtype)
        k4, v4 = (torch.randn(B, Tc, H, D, generator=g).to(dtype) for _ in range(2))
        rows = (torch.arange(B) // BEAM * BEAM)[:, None] + torch.randint(
            0, BEAM, (B, Tc), generator=g)
        rows[:, pos + 1:] = torch.arange(B)[:, None]     # the rows' own next writes
        key_valid = torch.arange(Tc)[None, :] <= pos
    else:
        Bs, Tk = (EVAL_BATCH, EVAL_FRAMES) if case == "eval_cross_cached" else (1, 799)
        q4 = (torch.randn(Bs, BEAM, H, 64, generator=g) * 64 ** -0.5).to(dtype)
        k4, v4 = (torch.randn(Bs, H, Tk, 64, generator=g).to(dtype).transpose(1, 2)
                  for _ in range(2))
        rows = None
        if case == "eval_cross_cached":
            valid = torch.randint(2 * Tk // 5, Tk + 1, (Bs,), generator=g)
            valid[0] = Tk                                  # the batch's longest clip
        else:
            valid = torch.tensor([549])
        key_valid = torch.arange(Tk)[None, :] < valid[:, None]
    out = [t.to(device) for t in (q4, k4, v4, key_valid)]
    return (*out, None if rows is None else rows.to(device))


def _flash_bias_record(case, dtype):
    """The decode-step kernel at one shape against its twin, timed back to
    back on the stream (``ms``) and as the card runs it (``graph_ms``), with
    SDPA (an f32 0/-1e9 mask, scale 1) on the same K/V as the yardstick,
    timed both ways.  "cross", "self" and "lm_self" call the contract entry
    on [N, T, D] rows, "cross_cached", "self_cache", "lm_self_cache",
    the three "eval_" cases, "tts_self", "tts_cross" and "vc_cross" the
    cached entry on the decoder's layouts; the last two with
    the max-probability output, held against the twin's (f32 1e-4, bf16
    3e-2 of max |ref|) and timed with and without it."""
    maxp_call = None
    if case in ("self_cache", "cross_cached", "tts_self", "tts_cross", "vc_cross",
                "lm_self_cache", "eval_self_cache", "eval_lm_self_cache",
                "eval_cross_cached", "large_cross_cached", "large_self_cache"):
        q4, k4, v4, key_valid, rows = flash_bias_cache_case(case, dtype)
        B, Tq, H, D = q4.shape
        N, Tk = B * H, k4.shape[1]
        call = lambda: K.flash_attention_bias_cached(q4, k4, v4, key_valid, rows)
        plain = lambda: K.flash_attention_bias_cached_plain(q4, k4, v4, key_valid, rows)
        if case in ("tts_cross", "vc_cross"):
            maxp_call = lambda: K.flash_attention_bias_cached(
                q4, k4, v4, key_valid, rows, return_max_prob=True)
            maxp_plain = lambda: K.flash_attention_bias_cached_plain(
                q4, k4, v4, key_valid, rows, return_max_prob=True)
        # SDPA on the gathered, head-major K/V (the gather not timed)
        pos = torch.arange(Tk, device=q4.device)
        kg, vg = (k4, v4) if rows is None else (k4[rows, pos], v4[rows, pos])
        q, k, v = (t.transpose(1, 2).reshape(N, -1, D).contiguous()
                   for t in (q4, kg, vg))
    else:
        q, k, v, key_valid = flash_bias_case(case, dtype)
        N, Tq, D = q.shape
        B, H, Tk, rows = N, 1, k.shape[1], None
        call = lambda: K.flash_attention_bias(q, k, v, None, key_valid)
        plain = lambda: K.flash_attention_bias_plain(q, k, v, None, key_valid)
    got, ref = call(), plain()
    torch.cuda.synchronize()
    err, tol, ok = _check(dtype, got, ref)
    ok = ok and torch.equal(got, call())       # two calls, the same bits
    # what the function needs: q and out, the K and V of the valid keys
    # (an invalid key's weight is exp(-1e9 - m) = 0 once a row has a valid
    # key, so its K and V are never needed), each distinct (physical row,
    # position, head) once however many beams share it through the row
    # map, the mask and the row map's entries of the valid keys; flops: q.k
    # and p.v over the valid keys of every row
    full_mask = key_valid.repeat_interleave(N // key_valid.shape[0], 0)
    valid_keys = full_mask.sum().item()
    phys = (torch.arange(B, device=q.device)[:, None].expand(B, Tk)
            if rows is None else rows)
    kv_index = ((phys * Tk + torch.arange(Tk, device=q.device))[:, None, :] * H
                + torch.arange(H, device=q.device)[None, :, None])
    kv_keys = torch.unique(kv_index[full_mask.view(B, H, Tk)]).numel()
    nbytes = ((2 * N * Tq * D + 2 * D * kv_keys) * q.element_size()
              + key_valid.numel())
    if rows is not None:
        nbytes += key_valid.sum().item() * B * rows.element_size()
    flops = 4.0 * Tq * D * valid_keys
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    mask = torch.where(full_mask[:, None, :], 0.0, K.NEG_INF).expand(N, Tq, Tk)
    library_call = "F.scaled_dot_product_attention(attn_mask=f32 0/-1e9, scale=1)"
    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    except RuntimeError:    # a backend that wants the mask in q's dtype
        mask = mask.to(dtype)
        library_call = library_call.replace("f32", str(dtype).split(".")[-1])
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    ms, graph = time_ms(call), graph_ms(call)
    library_ms, library_graph = time_ms(library), graph_ms(library)
    extra = {}
    if maxp_call is not None:
        (o, m), (o_ref, m_ref) = maxp_call(), maxp_plain()
        torch.cuda.synchronize()
        m_err, m_tol, m_ok = _check(dtype, m, m_ref)
        ok = ok and m_ok and torch.equal(o, got)    # the output's bits stay
        # the path's call (this output on) is the timed one; the time
        # without it stays beside it
        extra = {"max_prob_err": m_err, "max_prob_tolerance": m_tol,
                 "without_max_prob_ms": ms, "without_max_prob_graph_ms": graph}
        ms, graph = time_ms(maxp_call), graph_ms(maxp_call)
        nbytes += N * Tq * 4
        bound_ms, bound_by = _bound(nbytes, flops, dtype)
    return ok, {**extra,
        "max_abs_err": err, "tolerance": tol, "ms": ms, "graph_ms": graph,
        "plain_ms": time_ms(plain), "library_ms": library_ms,
        "library_graph_ms": library_graph, "library_call": library_call,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share_graph": bound_ms / graph,
        "shape": {"N": N, "Tq": Tq, "Tk": Tk, "D": D,
                  "valid_keys": int(key_valid[0].sum().item()),
                  "distinct_kv_keys": kv_keys, "row_map": rows is not None},
    }


def phase_kernels():
    """The inference kernels against their twins at batch 1 (what a served
    16 s chunk gives them) and batch 2, in f32 and bf16 (keys
    "<dtype>/b<batch>"); the train kernels at the train step's shapes in f32
    and bf16 with dropout 0 and 0.1 (keys "<dtype>/r<rate>"); the log-mel
    kernel at the t2s batch and a centred case (keys "float32/b<batch>");
    the inference attention at the /tts text encoder's shape (keys
    "<dtype>/tts_text");
    the decode-step kernel at the beam's cross and self shapes through the
    contract entry and through the cached entry in f32 and bf16 (keys
    "<dtype>/cross", "<dtype>/self", "<dtype>/cross_cached",
    "<dtype>/self_cache", "<dtype>/tts_self", "<dtype>/tts_cross",
    "<dtype>/vc_cross", and the fusion LM's step at Dh 80, "<dtype>/lm_self",
    "<dtype>/lm_self_cache").  The shapes of the s2s / s2c / VC / SID paths, bf16:
    the inference attention on one VC source ("bfloat16/vc_src", T 149) and
    one SID utterance ("bfloat16/sid", T 399); the train kernels at batch 8
    ("bfloat16/r0.1/T299", the s2s source; "bfloat16/r0.1/T400", the s2c
    crop with a [CLS] slot); the conv stack forward at batch 8 on 6 s and
    8 s ("bfloat16/b8_T19199", "bfloat16/b8_T25599") and its backward at
    8 s ("bfloat16/bwd_b8_T25599").  The evaluate phase's batch of 8 at its
    5 s bound: the inference attention with ragged lengths
    ("bfloat16/eval_b8", T 249), the conv stack ("bfloat16/b8_T15999") and
    the decode steps of its beam and tiny LM ("<dtype>/eval_cross_cached",
    "<dtype>/eval_self_cache", "<dtype>/eval_lm_self_cache", D 16)."""
    records = {name: {} for name in KERNELS}
    failures = []
    for batch in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{str(dtype).split('.')[-1]}/b{batch}"
            for name, fn in (("banded_flash_attention", _attention_record),
                             ("conv_stack", _conv_record)):
                ok, rec = fn(batch, dtype)
                records[name][key] = rec
                if not ok:
                    failures.append(f"{name} {key}: max|diff| {rec['max_abs_err']} "
                                    f"> {rec['tolerance']}")
                torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        # the /tts text encoder: one request at the token bucket
        key = f"{str(dtype).split('.')[-1]}/tts_text"
        ok, rec = _attention_record(1, dtype, T=TTS_BUCKET_TOKENS, valid=TTS_TEXT_IDS)
        records["banded_flash_attention"][key] = rec
        if not ok:
            failures.append(f"banded_flash_attention {key}: max|diff| "
                            f"{rec['max_abs_err']} > {rec['tolerance']}")
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            key = f"{str(dtype).split('.')[-1]}/r{rate}"
            ok, recs = _train_records(dtype, rate)
            for name, rec in recs.items():
                records[name][key] = rec
            if not ok:
                failures.append(f"train kernels {key}: "
                                + json.dumps({n: r["errors"] for n, r in recs.items()}))
            torch.cuda.empty_cache()
    for key, T in (("vc_src", VC_SOURCE_FRAMES), ("sid", SID_FRAMES)):
        ok, rec = _attention_record(1, torch.bfloat16, T=T, valid=T)
        records["banded_flash_attention"][f"bfloat16/{key}"] = rec
        if not ok:
            failures.append(f"banded_flash_attention {key}: max|diff| "
                            f"{rec['max_abs_err']} > {rec['tolerance']}")
    for T in (S2S_SOURCE_FRAMES, SID_FRAMES + 1):
        key = f"bfloat16/r0.1/T{T}"
        ok, recs = _train_records(torch.bfloat16, 0.1, batch=8, T=T)
        for name, rec in recs.items():
            records[name][key] = rec
        if not ok:
            failures.append(f"train kernels {key}: "
                            + json.dumps({n: r["errors"] for n, r in recs.items()}))
        torch.cuda.empty_cache()
    ok, rec = _attention_record(EVAL_BATCH, torch.bfloat16, T=EVAL_FRAMES)
    records["banded_flash_attention"]["bfloat16/eval_b8"] = rec
    if not ok:
        failures.append(f"banded_flash_attention eval_b8: max|diff| "
                        f"{rec['max_abs_err']} > {rec['tolerance']}")
    for T in (EVAL_CONV_T, 19199, 25599):
        ok, rec = _conv_record(8, torch.bfloat16, T=T)
        records["conv_stack"][f"bfloat16/b8_T{T}"] = rec
        if not ok:
            failures.append(f"conv_stack b8 T{T}: max|diff| {rec['max_abs_err']} "
                            f"> {rec['tolerance']}")
    ok, rec = _conv_bwd_record(8, torch.bfloat16, T=25599)
    records["conv_stack"]["bfloat16/bwd_b8_T25599"] = rec
    if not ok:
        failures.append(f"conv_stack backward: {rec['errors']} > {rec['tolerance']}")
    torch.cuda.empty_cache()
    # SpeechT5-Large: a served 16 s chunk's 16 heads, and the pretraining
    # micro-batch of 4 at the 250000-sample crop, Large's dropout 0
    for dtype in (torch.float32, torch.bfloat16):
        key = f"{str(dtype).split('.')[-1]}/large_b1"
        ok, rec = _attention_record(1, dtype, heads=LARGE_HEADS)
        records["banded_flash_attention"][key] = rec
        if not ok:
            failures.append(f"banded_flash_attention {key}: max|diff| "
                            f"{rec['max_abs_err']} > {rec['tolerance']}")
    ok, recs = _train_records(torch.bfloat16, 0.0, batch=4, T=LARGE_TRAIN_T,
                              heads=LARGE_HEADS)
    for name, rec in recs.items():
        records[name][f"bfloat16/r0.0/large_T{LARGE_TRAIN_T}"] = rec
    if not ok:
        failures.append("train kernels large: "
                        + json.dumps({n: r["errors"] for n, r in recs.items()}))
    torch.cuda.empty_cache()
    for batch, samples, center in ((16, 767 * 256 + 1024, False), (2, 48000, True)):
        ok, rec = _mel_record(batch, samples, center)
        records["fused_log_mel"][f"float32/b{batch}"] = rec
        if not ok:
            failures.append(f"fused_log_mel b{batch}: max|diff| {rec['max_abs_err']} "
                            f"> {rec['tolerance']}")
    for case in ("cross", "self", "cross_cached", "self_cache", "tts_self", "tts_cross",
                 "vc_cross", "lm_self", "lm_self_cache", "eval_cross_cached",
                 "eval_self_cache", "eval_lm_self_cache", "large_cross_cached",
                 "large_self_cache"):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{str(dtype).split('.')[-1]}/{case}"
            ok, rec = _flash_bias_record(case, dtype)
            records["flash_attention_bias"][key] = rec
            if not ok:
                failures.append(f"flash_attention_bias {key}: max|diff| "
                                f"{rec['max_abs_err']} (tolerance {rec['tolerance']}), "
                                "or two calls differ")
    log(json.dumps({"phase": "kernels", "records": records}))
    if failures:
        raise AssertionError("kernel disagrees with its twin: " + "; ".join(failures))
    return records


# ------------------------------------------------------------------ serve


def phase_serve(base_cfg, device="cuda", dtype="bfloat16",
                requests_s=(3, 11, 21), buckets="4,8,16", seed=0, chunked=True):
    """The main path: Service(ctc_greedy) with both kernels on (one request
    chunked when ``chunked``).  Returns the launch counts of the request
    window and the per-request times."""
    cfg = serve_config(base_cfg, dtype, kernels=True)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device)
    with tempfile.TemporaryDirectory() as d:
        svc = make_service(cfg, model, write_dictionary(d), device, buckets)
    wavs = [synth_audio(s, seed=100 + i) for i, s in enumerate(requests_s)]
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    _sync(device)
    K.reset_launch_counts()
    results = []
    for secs, wav in zip(requests_s, wavs):
        t0 = time.perf_counter()
        text = svc.transcribe(wav)
        _sync(device)
        results.append({"request_s": secs, "chunks": len(svc._chunk(wav)),
                        "wall_ms": (time.perf_counter() - t0) * 1e3,
                        "chars": len(text), "card": card})
    counts = K.launch_counts()
    for r in results:
        log(json.dumps({"served": r}))
    n_chunks = sum(r["chunks"] for r in results)
    if svc.asr_requests != n_chunks or (chunked and max(r["chunks"] for r in results) < 2):
        raise AssertionError(f"expected {n_chunks} chunks incl. one chunked "
                             f"request, Service counted {svc.asr_requests}")
    # the served output is well formed: finite CTC logits of the right shape
    wav = np.zeros((1, svc.buckets()[0] * SR), np.float32)
    wav[0, : len(wavs[0])] = wavs[0][: wav.shape[1]]
    logits, frames = svc.asr.dec.logits(wav, [min(len(wavs[0]), wav.shape[1])])
    want = (1, cfg.conv_features.out_length(wav.shape[1]), cfg.vocab_size)
    if tuple(logits.shape) != want or not torch.isfinite(logits).all():
        raise AssertionError(f"CTC logits {tuple(logits.shape)} (want {want}) "
                             "or not finite")
    return {"counts": counts, "requests": results}


# ----------------------------------------------------------------- parity


def phase_parity(base_cfg, device="cuda", requests_s=(3, 11, 21),
                 buckets="4,8,16", seed=0, gap_tol=1e-4, max_frac=1e-3):
    """f32 weights through the Service path with the kernels and with the
    flags off; CTC frame ids must agree (see module docstring)."""
    cfg_k = serve_config(base_cfg, "float32", kernels=True)
    cfg_t = serve_config(base_cfg, "float32", kernels=False)
    model_k = init_model(cfg_k, torch.Generator().manual_seed(seed), device)
    model_t = init_model(cfg_t, torch.Generator().manual_seed(seed + 1), device)
    model_t.load_state_dict(model_k.state_dict())
    with tempfile.TemporaryDirectory() as d:
        path = write_dictionary(d)
        svc_k = make_service(cfg_k, model_k, path, device, buckets)
        svc_t = make_service(cfg_t, model_t, path, device, buckets)
    frames = differ = 0
    worst_gap = 0.0
    for i, secs in enumerate(requests_s):
        wav = synth_audio(secs, seed=200 + i)
        for chunk in svc_k._chunk(wav):
            T = svc_k._bucket_for(len(chunk))
            padded = np.zeros((1, T), np.float32)
            padded[0, : len(chunk)] = chunk
            n = [len(chunk)]
            ids_k, len_k = svc_k.asr.dec.frame_ids(padded, n)
            logits_t, len_t = svc_t.asr.dec.logits(padded, n)
            ids_t = torch.argmax(logits_t, -1).to(torch.int32).cpu().numpy()
            L = int(len_t[0])
            if int(len_k[0]) != L:
                raise AssertionError(f"frame lengths differ: {len_k} vs {L}")
            bad = np.nonzero(ids_k[0, :L] != ids_t[0, :L])[0]
            frames += L
            differ += len(bad)
            if len(bad):
                top2 = torch.topk(logits_t[0, bad], 2, dim=-1).values
                worst_gap = max(worst_gap, (top2[:, 0] - top2[:, 1]).max().item())
        if svc_k.transcribe(wav) != svc_t.transcribe(wav) and differ == 0:
            raise AssertionError("transcripts differ with equal frame ids")
    result = {"frames": frames, "differing_frames": differ,
              "max_top2_gap_at_differing": worst_gap}
    log(json.dumps({"phase": "parity", **result}))
    if differ > max_frac * frames or worst_gap >= gap_tol:
        raise AssertionError(f"CTC ids of the kernel path differ: {result}")
    return result


# ------------------------------------------------------------- serve beam


def beam_launches_expected(cfg, chunks: int, steps: int) -> dict:
    """The beam path's launches: per chunk ``K.fwd_launches`` inference-
    attention launches per encoder layer (bf16: bias pass and main loop)
    and one conv launch per strided FE layer (1..n), as
    in the greedy phase; per decode step one decode-step launch per decoder
    layer for self- and one for cross-attention; nothing else."""
    want = dict.fromkeys(KERNELS, 0)
    want["banded_flash_attention"] = (chunks * cfg.encoder.num_layers
                                      * K.fwd_launches(cfg.compute_dtype))
    want["conv_stack"] = conv_launches(cfg, chunks)
    want["flash_attention_bias"] = 2 * cfg.decoder.num_layers * steps
    return want


def conv_launches(cfg, chunks: int) -> int:
    """The conv kernel's launches for ``chunks`` encodes: one per strided
    layer (1..n) in the "default" mode; none in Large's "layer_norm" mode,
    whose layers run as conv1d (as JAX's do)."""
    return chunks * (len(cfg.conv_features.layers) - 1) if cfg.conv_features.mode == "default" else 0


def phase_serve_beam(base_cfg, device="cuda", dtype="bfloat16",
                     requests_s=(3, 11, 21), buckets="4,8,16", seed=0,
                     max_len=BEAM_MAX_LEN):
    """The beam arm: Service(--decoder beam, beam 5, CTC weight 0.3) with
    every kernel on, answering the requests one at a time.  Per request:
    wall ms, decode steps and each kernel's launches, which must be
    ``beam_launches_expected`` on a card.  Returns the launches of the
    request window and the per-request records."""
    cfg = serve_config(base_cfg, dtype, kernels=True, overrides=BEAM_OVERRIDES)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device)
    with tempfile.TemporaryDirectory() as d:
        svc = make_service(cfg, model, write_dictionary(d), device, buckets,
                           decoder="beam", max_len=max_len)
    wavs = [synth_audio(s, seed=100 + i) for i, s in enumerate(requests_s)]
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    on_card = torch.device(device).type == "cuda"
    _sync(device)
    K.reset_launch_counts()
    results = []
    for secs, wav in zip(requests_s, wavs):
        before, steps0 = K.launch_counts(), svc.asr.steps_run
        t0 = time.perf_counter()
        text = svc.transcribe(wav)
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        launches = {n: c - before[n] for n, c in K.launch_counts().items()}
        chunks, steps = len(svc._chunk(wav)), svc.asr.steps_run - steps0
        results.append({"request_s": secs, "chunks": chunks, "decode_steps": steps,
                        "wall_ms": wall, "launches": launches, "chars": len(text),
                        "card": card})
        want = (beam_launches_expected(cfg, chunks, steps) if on_card
                else dict.fromkeys(KERNELS, 0))
        if launches != want or not 0 < steps <= chunks * max_len:
            raise AssertionError(f"beam request of {secs} s: launches {launches}, "
                                 f"want {want}, steps {steps}")
    counts = K.launch_counts()
    for r in results:
        log(json.dumps({"served_beam": r}))
    if svc.asr_requests != sum(r["chunks"] for r in results):
        raise AssertionError(f"Service counted {svc.asr_requests} chunks")
    if on_card:
        log(json.dumps({"beam_device_launches": beam_device_launches(svc, wavs[0])}))
    # well formed: per sample K hypotheses framed BOS ... EOS, finite
    # scores sorted best first
    wav = np.zeros((1, svc.buckets()[0] * SR), np.float32)
    wav[0, : len(wavs[0])] = wavs[0][: wav.shape[1]]
    res = svc.asr(wav, [min(len(wavs[0]), wav.shape[1])])
    toks, scores, lens = (t.cpu() for t in res)
    best = toks[0, 0, : int(lens[0, 0])]
    if (tuple(toks.shape) != (1, BEAM, max_len + 1) or not torch.isfinite(scores).all()
            or (scores[:, :-1] < scores[:, 1:]).any() or best[0] != cfg.eos_id
            or best[-1] != cfg.eos_id or (best[1:-1] == cfg.eos_id).any()):
        raise AssertionError(f"beam result malformed: {tuple(toks.shape)} {scores} "
                             f"{best.tolist()}")
    return {"counts": counts, "requests": results}


def beam_device_launches(svc, wav) -> dict:
    """Every launch the card runs for one beam request (kernels, copies and
    fills, from ``torch.profiler``'s device events), and per decode step:
    the encoder's few hundred launches a chunk are in the total too."""
    from torch.profiler import ProfilerActivity, profile

    steps0 = svc.asr.steps_run
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.transcribe(wav)
        torch.cuda.synchronize()
    steps = svc.asr.steps_run - steps0
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))
    return {"device_launches": n, "decode_steps": steps,
            "per_step": n / steps if steps else None}


def phase_beam_parity(base_cfg, device="cuda", requests_s=(3, 11, 21),
                      buckets="4,8,16", seed=0, max_len=BEAM_MAX_LEN,
                      gap_tol=1e-4, score_rtol=1e-4):
    """f32 weights through Service(--decoder beam) with every kernel flag on
    and with them off, chunk by chunk: the best scores within
    ``score_rtol`` relative and the best hypotheses equal, unless the plain
    path's top two were a near tie (the kernel path's best is the plain
    path's second, scored within ``gap_tol`` of its best).  Such
    differences are printed."""
    cfg_k = serve_config(base_cfg, "float32", kernels=True, overrides=BEAM_OVERRIDES)
    cfg_t = serve_config(base_cfg, "float32", kernels=False)
    model_k = init_model(cfg_k, torch.Generator().manual_seed(seed), device)
    model_t = init_model(cfg_t, torch.Generator().manual_seed(seed + 1), device)
    model_t.load_state_dict(model_k.state_dict())
    with tempfile.TemporaryDirectory() as d:
        path = write_dictionary(d)
        svc_k, svc_t = (make_service(c, m, path, device, buckets, decoder="beam",
                                     max_len=max_len)
                        for c, m in ((cfg_k, model_k), (cfg_t, model_t)))
    chunks = equal = 0
    worst_rel, near_ties = 0.0, []
    for i, secs in enumerate(requests_s):
        wav = synth_audio(secs, seed=200 + i)
        for chunk in svc_k._chunk(wav):
            T = svc_k._bucket_for(len(chunk))
            padded = np.zeros((1, T), np.float32)
            padded[0, : len(chunk)] = chunk
            res_k = svc_k.asr(padded, [len(chunk)])
            res_t = svc_t.asr(padded, [len(chunk)])
            hyps_t = [res_t.tokens[0, j, : int(res_t.lengths[0, j])].tolist()
                      for j in range(BEAM)]
            a = res_k.tokens[0, 0, : int(res_k.lengths[0, 0])].tolist()
            scores_t = res_t.scores[0].tolist()
            sk = res_k.scores[0, 0].item()
            chunks += 1
            worst_rel = max(worst_rel, abs(sk - scores_t[0]) / abs(scores_t[0]))
            if a == hyps_t[0]:
                equal += 1
                continue
            first = next((j for j, (x, y) in enumerate(zip(a, hyps_t[0])) if x != y),
                         min(len(a), len(hyps_t[0])))
            top2_gap = scores_t[0] - scores_t[1] if a == hyps_t[1] else float("inf")
            log(json.dumps({"beam_parity_difference": {
                "request_s": secs, "first_position": first, "kernel": a,
                "plain": hyps_t[0], "kernel_score": sk, "plain_scores": scores_t,
                "plain_top2_gap": top2_gap}}))
            if top2_gap >= gap_tol:
                raise AssertionError(f"beam tokens of the kernel path differ at "
                                     f"position {first} with no near tie of the "
                                     f"plain path's top two")
            near_ties.append(first)
    result = {"chunks": chunks, "equal_best": equal, "near_tie_differences": near_ties,
              "worst_score_rel_diff": worst_rel,
              "decode_steps": {"kernel": svc_k.asr.steps_run, "plain": svc_t.asr.steps_run}}
    log(json.dumps({"phase": "beam_parity", **result}))
    if worst_rel > score_rtol:
        raise AssertionError(f"beam scores of the kernel path differ: {result}")
    return result


# ------------------------------------------------------------------ train


def write_corpus(directory: str, n: int, seconds=(8.0, 16.0), seed: int = 0):
    """``n`` seeded 16 kHz utterances of ``seconds`` (min, max) with random
    letter transcripts (fairseq .ltr: letters with '|' word ends): a WAV
    each, a manifest and a label file.  Returns (manifest, labels, dict)."""
    rng = np.random.default_rng(seed)
    letters = [chr(ord("A") + i) for i in range(26)]
    rows, lines = [], []
    for i in range(n):
        secs = float(rng.uniform(*seconds))
        wav = synth_audio(secs, seed=seed + 1000 + i)
        write_wav(os.path.join(directory, f"utt{i}.wav"), wav)
        rows.append(f"utt{i}.wav\t{len(wav)}")
        words = ["".join(rng.choice(letters, int(rng.integers(2, 8))))
                 for _ in range(max(1, int(secs * 2.5)))]
        lines.append(" ".join(" ".join(w) + " |" for w in words))
    manifest = os.path.join(directory, "train.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write(directory + "\n" + "\n".join(rows) + "\n")
    labels = os.path.join(directory, "train.ltr")
    with open(labels, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return manifest, labels, write_dictionary(directory)


class _LayerRuns:
    """Counts training forwards of encoder layers (layerdrop skips some)."""

    def __enter__(self):
        self.n = 0

        def hook(module, args, output):
            if isinstance(module, EncoderLayer) and module.training:
                self.n += 1

        self.handle = torch.nn.modules.module.register_module_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def phase_train(work_dir, arch="speecht5_base_asr", device="cuda", n_utts=32, updates=3,
                seconds=(8.0, 16.0), flags=RECIPE_FLAGS, seed=0):
    """The training path through ``cli/train.main`` in ``work_dir``:
    ``updates`` updates, then a resume that takes one more; only the newest
    checkpoint (1.8 GB at Base with the Adam moments) is kept, in
    ``work_dir``/ckpt.  Returns the launch counts of the first run, the
    encoder layer runs, the per-update metrics and wall times, and the
    run's arguments ("args")."""
    manifest, labels, dict_path = write_corpus(work_dir, n_utts, seconds, seed)
    args = ["--task", "s2t", "--arch", arch, "--manifest", manifest,
            "--labels", labels, "--dict", dict_path,
            "--save-dir", os.path.join(work_dir, "ckpt"), *flags, "--keep-last", "1",
            "--log-interval", "1", "--seed", str(seed + 1), "--device", device]
    for ov in TRAIN_OVERRIDES:
        args += ["--override", ov]
    result = train_and_resume(args, os.path.join(work_dir, "ckpt"), updates, device, "s2t")
    log(json.dumps({"phase": "train", **result}))
    return {**result, "args": args}


def train_and_resume(args, save_dir, updates, device, what, accum=1):
    """``cli/train.main(args)`` for ``updates`` updates, the launch counts
    zeroed just before and read just after and each update timed, then a
    resume that takes one more, keeping only the newest checkpoint.  Fails
    unless both runs reach their steps with finite metrics.  -> {"counts",
    "layer_runs" (training forwards of encoder layers), "micro_batches",
    "wall_s", "update_ms", "history" (both runs), "metrics" (the first
    update's names)}."""
    _sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with _LayerRuns() as runs, _UpdateTimes(device) as update_ms:
        first = cli_train.main(args + ["--max-updates", str(updates)])
    _sync(device)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    resumed = cli_train.main(args + ["--max-updates", str(updates + 1)])
    saved = sorted(f for f in os.listdir(save_dir) if f.startswith("checkpoint_"))
    if not (first["steps"] == updates and len(first["history"]) == updates
            and resumed["steps"] == updates + 1 and len(resumed["history"]) == 1):
        raise AssertionError(f"{what} train/resume steps wrong: {first['steps']}, "
                             f"{resumed['steps']}, {len(resumed['history'])}")
    if not (first["finite"] and resumed["finite"]):
        raise AssertionError(f"non-finite {what} metrics: {first['history']} "
                             f"{resumed['history']}")
    if saved != [f"checkpoint_{updates + 1}.pt"]:
        raise AssertionError(f"{what} checkpoints saved: {saved}")
    return {"counts": counts, "layer_runs": runs.n, "micro_batches": updates * accum,
            "wall_s": wall, "update_ms": update_ms,
            "history": first["history"] + resumed["history"],
            "metrics": sorted(first["history"][0])}


def synthetic_batch(cfg, batch, seconds=(8.0, 16.0), seed=0, device="cuda"):
    """One collated s2t micro-batch as ``cli/train.py`` hands it to the
    trainer: seeded audio of ``seconds`` (min, max), layer-normed as
    ``--normalize`` does and padded to its audio bucket; random token
    targets (12 a second) ending in EOS with the EOS-shifted decoder input;
    wav_lengths on the host."""
    rng = np.random.default_rng(seed)
    wavs = [synth_audio(float(rng.uniform(*seconds)), seed=500 + seed + i)
            for i in range(batch)]
    items = []
    for w in wavs:
        tokens = np.append(rng.integers(4, 80, int(len(w) / SR * 12)), cfg.eos_id)
        items.append({"id": 0, "wav": layer_norm_wav(w), "tokens": tokens})
    b = SpeechToTextDataset.collate(items, cfg.eos_id, cfg.pad_id)
    return {"wav_lengths": torch.from_numpy(b["wav_lengths"]),
            **{k: torch.from_numpy(b[k]).to(device)
               for k in ("wav", "prev_tokens", "targets")}}


def route_grads(task, routes, tcfg, seed, device, after=None):
    """One training micro-batch's loss and every parameter gradient on each
    route, ``routes`` = ((cfg, batch), ...), every model with the weights
    of the first (seeded ``seed + 7``).  ``after(model)``, called once the
    gradients are taken, adds what it returns to the route's result.  ->
    [(loss, {name: grad}, after's result or None), ...]."""
    results, state = [], None
    for cfg, mb in routes:
        model = init_model(cfg, torch.Generator().manual_seed(seed + 7), device)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        trainer = Trainer(model, task, tcfg)
        model.train()
        loss, _ = trainer.loss(mb)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        results.append((loss.item(), grads, None if after is None else after(model)))
        del model, trainer
    return results


def grad_rel_diffs(g_k, g_p) -> dict:
    """Each parameter's max |g_kernel - g_plain| / max |g_plain|.  A
    gradient present on one route only fails; the k_proj biases and the
    pre-LN layers' norm_k biases, whose gradient is analytically 0 (each
    adds one constant to a row of logits), must be within 1e-6 of the
    largest gradient on both routes (rounding noise) and are left out."""
    gmax = max(g.abs().max().item() for g in g_p.values() if g is not None)
    out = {}
    for name, gp in g_p.items():
        gk = g_k[name]
        if gp is None or gk is None:
            if (gp is None) != (gk is None):
                raise AssertionError(f"gradient of {name} present on one route only")
            continue
        if name.endswith(("k_proj.bias", "norm_k.bias")):
            if max(gk.abs().max().item(), gp.abs().max().item()) > 1e-6 * gmax:
                raise AssertionError(f"{name}: gradient not ~0")
            continue
        out[name] = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
    return out


def grad_diff(g_k, g_p):
    """The largest of ``grad_rel_diffs`` and its name."""
    diffs = grad_rel_diffs(g_k, g_p)
    name = max(diffs, key=diffs.get)
    return diffs[name], name


# a relative scaling of the plain route's input waveform: 2^-22 is one or
# two ulps of f32, the size of the differences the kernel route makes
ULP_SCALE = 1 + 2.0 ** -22


def grad_gate(g_k, g_p, g_p_ulp, grad_rtol):
    """The kernel route's gradients against the plain route's, each within
    ``grad_rtol`` of its max |g|, or, where the plain route's own gradient
    moves by more than half that when its input waveform is scaled by
    ``ULP_SCALE`` (``g_p_ulp``: a near-zero gradient summed with
    cancellation, which f32 cannot resolve to ``grad_rtol``), within twice
    that move.  -> (worst difference, its name, the parameters held to
    their own move and those over the gate, each {name: [difference, move,
    max |g| over the largest of all]})."""
    diffs = grad_rel_diffs(g_k, g_p)
    moves = grad_rel_diffs(g_p_ulp, g_p)
    gmax = max(g.abs().max().item() for g in g_p.values() if g is not None)
    floored, over = {}, {}
    for name, rel in diffs.items():
        tol = grad_rtol
        record = [rel, moves[name], g_p[name].abs().max().item() / gmax]
        if moves[name] > grad_rtol / 2:
            tol = 2 * moves[name]
            floored[name] = record
        if rel > tol:
            over[name] = record
    name = max(diffs, key=diffs.get)
    return diffs[name], name, floored, over


def phase_train_parity(base_cfg, device="cuda", batch=16, seconds=(8.0, 16.0),
                       seed=0, loss_rtol=1e-4, grad_rtol=1e-3):
    """One micro-batch in f32, every stochastic part at 0, the same weights:
    the train-kernel route against the plain route (see the docstring)."""
    cfg_k = C.apply_overrides(C.replace(base_cfg, dtype="float32", **DICT_CFG),
                              DETERMINISTIC + TRAIN_OVERRIDES)
    cfg_p = C.apply_overrides(C.replace(base_cfg, dtype="float32", **DICT_CFG),
                              DETERMINISTIC)
    b = synthetic_batch(base_cfg, batch, seconds, seed, device)
    results = route_grads("s2t", ((cfg_k, b), (cfg_p, b)), TrainConfig(ctc_weight=0.5),
                          seed, device)
    (loss_k, g_k, _), (loss_p, g_p, _) = results
    worst, worst_name = grad_diff(g_k, g_p)
    result = {"loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
              "worst_grad_rel_diff": worst, "worst_grad_param": worst_name}
    log(json.dumps({"phase": "train_parity", **result}))
    if result["loss_rel_diff"] > loss_rtol or worst > grad_rtol:
        raise AssertionError(f"train routes differ: {result}")
    return result


# -------------------------------------------------------------- train t2s


def write_t2s_corpus(directory: str, n: int, seconds=(2.0, 10.0), spk_dim: int = 512,
                     seed: int = 0):
    """``n`` seeded 16 kHz utterances of ``seconds`` (min, max), letter
    transcripts of about 14 symbols a second (letters and '|' word ends)
    and a seeded ``spk_dim`` x-vector per utterance (``<name>.npy`` in
    ``<directory>/xvectors``).  Returns (manifest, labels, dict, spkemb dir)."""
    rng = np.random.default_rng(seed)
    letters = [chr(ord("A") + i) for i in range(26)]
    spk_dir = os.path.join(directory, "xvectors")
    os.makedirs(spk_dir, exist_ok=True)
    rows, lines = [], []
    for i in range(n):
        secs = float(rng.uniform(*seconds))
        wav = synth_audio(secs, seed=seed + 3000 + i)
        write_wav(os.path.join(directory, f"tts{i}.wav"), wav)
        np.save(os.path.join(spk_dir, f"tts{i}.npy"),
                rng.standard_normal(spk_dim).astype(np.float32))
        rows.append(f"tts{i}.wav\t{len(wav)}")
        symbols = []
        while len(symbols) < int(secs * 14):
            symbols += list(rng.choice(letters, int(rng.integers(2, 8)))) + ["|"]
        lines.append(" ".join(symbols[: max(2, int(secs * 14))]))
    manifest = os.path.join(directory, "tts.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write(directory + "\n" + "\n".join(rows) + "\n")
    labels = os.path.join(directory, "tts.ltr")
    with open(labels, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return manifest, labels, write_dictionary(directory), spk_dir


def phase_train_t2s(arch="speecht5_base", device="cuda", n_utts=32, updates=3,
                    seconds=(2.0, 10.0), flags=T2S_FLAGS, seed=0):
    """The t2s path through ``cli/train.main``: ``updates`` updates, then a
    resume that takes one more, keeping only the newest checkpoint, in a
    temporary directory removed at the end.  Returns the launch counts of
    the first run, its text-encoder layer runs and micro-batches, and the
    per-update metrics."""
    with tempfile.TemporaryDirectory() as d:
        manifest, labels, dict_path, spk_dir = write_t2s_corpus(
            d, n_utts, seconds, getattr(C, arch)().spk_embed_dim, seed)
        args = ["--task", "t2s", "--arch", arch, "--manifest", manifest,
                "--labels", labels, "--dict", dict_path, "--spkemb-dir", spk_dir,
                "--save-dir", os.path.join(d, "ckpt"), *flags, "--keep-last", "1",
                "--log-interval", "1", "--seed", str(seed + 1), "--device", device]
        for ov in T2S_OVERRIDES:
            args += ["--override", ov]
        result = train_and_resume(args, os.path.join(d, "ckpt"), updates, device, "t2s",
                                  accum=_accum(flags))
    check_tts_metrics(result, flags, "t2s")
    log(json.dumps({"phase": "train_t2s", **result}))
    return result


def _accum(flags) -> int:
    return int(flags[flags.index("--accum") + 1]) if "--accum" in flags else 1


def check_tts_metrics(result, flags, what):
    """The t2s / s2s updates' metrics: tts_loss's, with the guided
    attention loss under --guided-attn, and the grad norm."""
    want = {"l1_loss", "l2_loss", "bce_loss", "loss", "grad_norm"}
    if "--guided-attn" in flags:
        want.add("enc_dec_attn_loss")
    if set(result["metrics"]) != want:
        raise AssertionError(f"{what} metrics {result['metrics']}")


def synthetic_t2s_batch(cfg, batch, seconds=(2.0, 10.0), seed=0, device="cuda"):
    """One collated t2s micro-batch in device-mel mode as ``cli/train.py``
    hands it to the trainer (the collation of ``TextToSpeechDataset``):
    seeded audio, random letter tokens (~14 a second) ending in EOS padded
    to their bucket, seeded x-vectors; everything on ``device``."""
    rng = np.random.default_rng(seed)
    items = [{"tgt_wav_raw": synth_audio(float(rng.uniform(*seconds)), seed=700 + seed + i)}
             for i in range(batch)]
    lengths = [max(2, int(len(it["tgt_wav_raw"]) / SR * 14)) + 1 for it in items]
    tokens = np.full((batch, bucket_length(max(lengths), TOKEN_BUCKETS)), cfg.pad_id)
    for i, n in enumerate(lengths):
        tokens[i, :n] = np.append(rng.integers(4, 30, n - 1), cfg.eos_id)
    b = collate_mel_targets(items, cfg.reduction_factor, cfg.n_mels, bucketed=True,
                            device_mel=True)
    b["tokens"] = tokens
    b["spkembs"] = rng.standard_normal((batch, cfg.spk_embed_dim)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def phase_t2s_parity(base_cfg, device="cuda", batch=16, seconds=(2.0, 10.0), seed=0,
                     mel_atol=TOL_MEL, loss_rtol=1e-4, grad_rtol=1e-3):
    """One f32 t2s micro-batch, every stochastic part at 0, the same
    weights: the kernel route (mels by the log-mel kernel, the train
    attention kernel) against the plain route (the twin's mels computed on
    the CPU, plain attention); see the module docstring."""
    base = C.replace(base_cfg, dtype="float32", **DICT_CFG)
    cfg_k = C.apply_overrides(base, T2S_DETERMINISTIC + T2S_OVERRIDES)
    cfg_p = C.apply_overrides(base, T2S_DETERMINISTIC)
    b = synthetic_t2s_batch(base, batch, seconds, seed, device)
    r = base.reduction_factor
    mel_k = device_mel_batch(b, base.n_mels, r)
    mel_p = device_mel_batch({k: v.cpu() for k, v in b.items()}, base.n_mels, r)
    mel_err = max((mel_k[k].cpu() - mel_p[k]).abs().max().item()
                  for k in ("target_mel", "prev_mel"))
    b_plain = {k: v.to(device) for k, v in mel_p.items()}
    results = route_grads("t2s", ((cfg_k, b), (cfg_p, b_plain)),
                          TrainConfig(use_guided_attn=True), seed, device)
    (loss_k, g_k, _), (loss_p, g_p, _) = results
    worst, worst_name = grad_diff(g_k, g_p)
    result = {"mel_max_abs_err": mel_err, "loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
              "worst_grad_rel_diff": worst, "worst_grad_param": worst_name}
    log(json.dumps({"phase": "t2s_parity", **result}))
    if mel_err > mel_atol or result["loss_rel_diff"] > loss_rtol or worst > grad_rtol:
        raise AssertionError(f"t2s routes differ: {result}")
    return result


# ------------------------------------------------------------ warm start

# port module name -> fairseq module name, where they differ (the inverse of
# utils/convert.map_fairseq_key)
FAIRSEQ_NAMES = [
    (r"feature_extractor\.conv_(\d+)\.", r"feature_extractor.conv_layers.\1.0."),
    (r"feature_extractor\.group_norm\.", "feature_extractor.conv_layers.0.2."),
    (r"feature_extractor\.ln_(\d+)\.", r"feature_extractor.conv_layers.\1.2.1."),
    (r"^speech_encoder_postnet\.", "hubert_layer."),
    (r"pos_conv\.", "pos_conv.0."),
    (r"(layers\.\d+)\.ffn\.", r"\1."),
    (r"text_encoder_prenet\.embed_tokens\.", "text_encoder_prenet.encoder_prenet.0."),
    (r"text_encoder_prenet\.alpha", "text_encoder_prenet.encoder_prenet.1.alpha"),
    (r"speech_decoder_prenet\.prenet\.layer_(\d+)\.",
     r"speech_decoder_prenet.decoder_prenet.0.0.prenet.\1.0."),
    (r"speech_decoder_prenet\.proj\.", "speech_decoder_prenet.decoder_prenet.0.1."),
    (r"speech_decoder_prenet\.alpha", "speech_decoder_prenet.decoder_prenet.1.alpha"),
    (r"speech_decoder_prenet\.spkembs_layer\.", "speech_decoder_prenet.spkembs_layer.0."),
    (r"postnet\.conv_(\d+)\.", r"postnet.postnet.\1.0."),
    (r"postnet\.bn_(\d+)\.", r"postnet.postnet.\1.1."),
]
# keys of a module that the fine-tune presets leave out, as a released
# pretraining checkpoint has them: the quantizer (converted, taken by no
# fine-tune model)
LACKED_KEYS = {"quantizer.vars": (1, 640, 256), "quantizer.weight_proj.weight": (640, 768)}


def write_fairseq_checkpoint(path: str, state: dict, seed: int = 0, lacked=LACKED_KEYS):
    """A fairseq-format SpeechT5 ``.pt`` of ``state`` (a port state dict):
    fairseq's key names (0-d ``alpha`` scales), an ``argparse.Namespace``
    ``args`` entry, seeded keys of modules the model lacks (``lacked``:
    name -> shape), a ``version`` buffer and an optimizer history, as the
    released files have them."""
    import argparse
    import re

    g = torch.Generator().manual_seed(seed)
    model = {}
    for key, value in state.items():
        fkey = key
        for pat, rep in FAIRSEQ_NAMES:
            fkey = re.sub(pat, rep, fkey)
        model[fkey] = value.reshape(()) if key.endswith(".alpha") else value.clone()
    for key, shape in lacked.items():
        model[key] = torch.randn(shape, generator=g)
    model["encoder.version"] = torch.tensor([3.0])
    args = argparse.Namespace(arch="t5_transformer_base_asr", task="speecht5",
                              max_update=800000, encoder_layers=12)
    torch.save({"args": args, "model": model,
                "optimizer_history": [{"num_updates": 800000}]}, path)
    return path


def phase_warm_start(arch="speecht5_base_asr", device="cuda", n_utts=32, updates=3,
                     seconds=(8.0, 16.0), flags=RECIPE_FLAGS, seed=0, src_vocab=100,
                     request_s=11.0, buckets="16", preempt=True):
    """The fine-tune recipe from a released checkpoint: a fairseq ``.pt``
    written here (another seed, a text head and CTC head at ``src_vocab``),
    ``cli/convert.py --format fairseq`` to a model-only checkpoint, the
    loaded weights held bit for bit against the file's (the mismatched heads
    keep their fresh initial values), ``cli/train.py --task s2t
    --finetune-from`` with the recipe's flags for ``updates`` updates, one
    greedy request served from the converted checkpoint, and a train
    subprocess sent SIGTERM after its first update: it must exit 0 with a
    checkpoint at the update it reports, and a resume must reach its
    --max-updates.  Returns the launch counts of the train run and of the
    request, and the timings."""
    from speecht5_tpu_torch.cli import convert as cli_convert
    from speecht5_tpu_torch.utils.checkpoint import checkpoints
    from speecht5_tpu_torch.utils.convert import load_fairseq_checkpoint

    result = {}
    with tempfile.TemporaryDirectory() as d:
        manifest, labels, dict_path = write_corpus(d, n_utts, seconds, seed)
        src_cfg = getattr(C, arch)(vocab_size=src_vocab, blank_id=src_vocab - 1)
        src = init_model(src_cfg, torch.Generator().manual_seed(seed + 50), "cpu")
        pt = write_fairseq_checkpoint(os.path.join(d, "pretrained.pt"), src.state_dict())
        del src
        conv_dir = os.path.join(d, "pretrained")
        t0 = time.perf_counter()
        report = cli_convert.main(["--pt", pt, "--format", "fairseq", "--arch", arch,
                                   "--dict", dict_path, "--out", conv_dir])
        result["convert_s"] = time.perf_counter() - t0
        heads = {"text_encoder_prenet.embed_tokens.weight",
                 "text_decoder_prenet.embed_tokens.weight", "encoder.proj.weight",
                 "encoder.proj.bias", "text_decoder_postnet.output_projection.weight"}
        if (set(report["shape_mismatches"]) != heads or report["missing"]
                or set(report["unknown_keys"]) != set(LACKED_KEYS)):
            raise AssertionError(f"conversion report: {report}")
        # what --finetune-from loads: the file's tensors, bit for bit, and
        # where the shape differs the fresh initial value the converter
        # wrote (a model seeded 0)
        file_sd, _, _ = load_fairseq_checkpoint(pt)
        cfg = getattr(C, arch)(dtype="bfloat16", **DICT_CFG)
        fresh = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        init_sd = {k: v.clone() for k, v in fresh.state_dict().items()}
        cli_train.warm_start(fresh, conv_dir)
        loaded = kept = 0
        for key, value in fresh.state_dict().items():
            if key in heads:
                kept += 1
                same = torch.equal(value, init_sd[key])
            else:
                loaded += 1
                same = torch.equal(value, file_sd[key])
            if not same:
                raise AssertionError(f"warm start: {key} differs")
        result["loaded_tensors"], result["fresh_tensors"] = loaded, kept
        del fresh, init_sd, file_sd

        def train_args(save_dir):
            args = ["--task", "s2t", "--arch", arch, "--manifest", manifest,
                    "--labels", labels, "--dict", dict_path, "--save-dir", save_dir,
                    *flags, "--keep-last", "1", "--log-interval", "1",
                    "--seed", str(seed + 1), "--device", device,
                    "--finetune-from", conv_dir]
            for ov in TRAIN_OVERRIDES:
                args += ["--override", ov]
            return args

        _sync(device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with _LayerRuns() as runs, _UpdateTimes(device) as update_ms:
            first = cli_train.main(train_args(os.path.join(d, "ckpt"))
                                   + ["--max-updates", str(updates)])
        _sync(device)
        result["train_wall_s"] = time.perf_counter() - t0
        result["update_ms"] = update_ms
        result["train_counts"] = K.launch_counts()
        result["layer_runs"] = runs.n
        result["history"] = first["history"]
        if first["steps"] != updates or not first["finite"]:
            raise AssertionError(f"warm-started train: {first}")

        # one greedy request from the converted checkpoint, as cli/serve.py
        # restores it
        args = build_parser().parse_args([
            "--ckpt", conv_dir, "--arch", arch, "--dict", dict_path,
            "--decoder", "ctc_greedy", "--max-batch", "1", "--asr-buckets", buckets,
            "--dtype", "bfloat16", "--device", device,
            *[a for ov in KERNEL_OVERRIDES for a in ("--override", ov)]])
        svc = Service(args, device=device)
        wav = synth_audio(request_s, seed=300)
        _sync(device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        text = svc.transcribe(wav)
        _sync(device)
        result["request"] = {"request_s": request_s, "wall_ms": (time.perf_counter() - t0) * 1e3,
                             "chars": len(text)}
        result["serve_counts"] = K.launch_counts()
        del svc

        if preempt:
            result["preempt"] = _preempt_and_resume(train_args, d, updates + 1)
    log(json.dumps({"phase": "warm_start", **result}))
    return result


class _UpdateTimes:
    """The wall ms of each ``Trainer.train_step`` (one update, every
    micro-batch), ending in a synchronize on the card; a list."""

    def __init__(self, device):
        self.device, self.times = device, []

    def __enter__(self):
        self.real = Trainer.train_step
        real, times, device = self.real, self.times, self.device

        def timed(trainer, micro, *task):
            _sync(device)
            t0 = time.perf_counter()
            out = real(trainer, micro, *task)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        Trainer.train_step = timed
        return self.times

    def __exit__(self, *exc):
        Trainer.train_step = self.real


def _preempt_and_resume(train_args, d, max_updates):
    """A train subprocess sent SIGTERM once it logs its first update: exit
    0, a checkpoint at the update it reports, then a resume to
    ``max_updates``."""
    import signal

    from speecht5_tpu_torch.utils.checkpoint import checkpoints

    save_dir = os.path.join(d, "ckpt_preempted")
    cmd = [sys.executable, "-m", "speecht5_tpu_torch.cli.train",
           *train_args(save_dir), "--max-updates", str(max_updates)]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(os.path.join(d, "preempt.err"), "w+") as err:
        proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        lines, signalled = [], None
        try:
            for line in proc.stdout:
                lines.append(line.strip())
                if signalled is None and line.startswith('{"step": 1,'):
                    proc.send_signal(signal.SIGTERM)
                    signalled = time.perf_counter()
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        tail = err.read()[-3000:]
    pre = [json.loads(l) for l in lines if l.startswith('{"preempted"')]
    saved = [s for s, _ in checkpoints(save_dir)]
    if rc != 0 or signalled is None or len(pre) != 1 or saved != [pre[0]["step"]] \
            or not 1 <= pre[0]["step"] < max_updates:
        raise AssertionError(f"preempted run: rc {rc}, stdout {lines[-5:]}, saved "
                             f"{saved}, stderr {tail}")
    resumed = cli_train.main(train_args(save_dir) + ["--max-updates", str(max_updates)])
    if (resumed["steps"] != max_updates or resumed["preempted"]
            or len(resumed["history"]) != max_updates - pre[0]["step"]):
        raise AssertionError(f"resume after preemption: {resumed}")
    return {"preempted_at": pre[0]["step"], "exit_after_signal_s":
            time.perf_counter() - signalled, "resumed_to": resumed["steps"]}


# -------------------------------------------------------------------- TTS

TTS_TEXTS = ("hello world", "the quick brown fox jumps over the lazy dog near the bank")
# cli/serve.py's --tts-bucket-tokens default, and the ids of the longer
# text (its letters and EOS)
TTS_BUCKET_TOKENS = 128
TTS_TEXT_IDS = len(TTS_TEXTS[-1]) + 1
# a random model's stop logits are ~N(0, 1): without this bias on
# prob_out it would stop at its first steps; at -8 every request runs to
# its max_len_ratio bound (10 frames a token)
TTS_STOP_BIAS = -8.0
# tts_parity's early-stop run: a quarter of the 10 frames a token bound
TTS_MIN_LEN_RATIO = 2.5


def hifigan_hf_state_dict(cfg, seed=0):
    """Seeded weights of the released HiFi-GAN generator's geometry in the
    HF naming (``upsampler.<i>``, parametrized weight norm with torch's
    gains: per output channel for Conv1d, per input channel for
    ConvTranspose1d; ``mean`` / ``scale``), for
    ``utils/convert.convert_hifigan_state_dict``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, c_out, c_in, k, transposed=False):
        v = torch.randn((c_in, c_out, k) if transposed else (c_out, c_in, k),
                        generator=g) * 0.05
        sd[f"{name}.parametrizations.weight.original0"] = \
            v.pow(2).sum((1, 2), keepdim=True).sqrt() * (1 + 0.1 * torch.rand(
                (v.shape[0], 1, 1), generator=g))
        sd[f"{name}.parametrizations.weight.original1"] = v
        sd[f"{name}.bias"] = torch.randn(c_out, generator=g) * 0.01

    ch = cfg.upsample_initial_channel
    conv("conv_pre", ch, cfg.in_dim, 7)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        conv(f"upsampler.{i}", ch // 2, ch, k, transposed=True)
        ch //= 2
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)):
            for n in range(len(rd)):
                conv(f"resblocks.{i * nk + j}.convs1.{n}", ch, ch, rk)
                conv(f"resblocks.{i * nk + j}.convs2.{n}", ch, ch, rk)
    conv("conv_post", 1, ch, 7)
    sd["mean"] = torch.randn(cfg.in_dim, generator=g) - 5.0
    sd["scale"] = torch.rand(cfg.in_dim, generator=g) + 0.5
    return sd


def tts_model(base_cfg, dtype, kernels, device, seed=0):
    """The served TTS model: ``base_cfg`` at the letter vocabulary, every
    kernel on when ``kernels`` (the beam's overrides: the encoder's
    inference attention and the decode-step kernel), seeded weights, the
    stop logits' bias at ``TTS_STOP_BIAS``."""
    cfg = serve_config(base_cfg, dtype, kernels=kernels, overrides=BEAM_OVERRIDES)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device)
    with torch.no_grad():
        model.speech_decoder_postnet.prob_out.bias.fill_(TTS_STOP_BIAS)
    return cfg, model


def tts_vocoder(n_mels, device, seed=0, cfg=None):
    """The released HiFi-GAN config at ``n_mels`` (or ``cfg``), seeded
    weights in the HF naming put through ``convert_hifigan_state_dict``."""
    from speecht5_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from speecht5_tpu_torch.utils.convert import convert_hifigan_state_dict

    cfg = cfg or HiFiGANConfig(in_dim=n_mels)
    voc = HiFiGANGenerator(cfg)
    voc.load_state_dict(convert_hifigan_state_dict(hifigan_hf_state_dict(cfg, seed)))
    return voc.to(device).eval()


def tts_launches_expected(cfg, steps: int) -> dict:
    """The TTS path's launches for one request: the text encoder's inference
    attention per layer (bf16: bias pass and main loop) once, and per decode
    step one decode-step launch per decoder layer for the self- and one for
    the cross-attention (the latter with the max-probability output);
    nothing else."""
    want = dict.fromkeys(KERNELS, 0)
    want["banded_flash_attention"] = cfg.encoder.num_layers * K.fwd_launches(cfg.compute_dtype)
    want["flash_attention_bias"] = 2 * cfg.decoder.num_layers * steps
    return want


def make_tts_service(cfg, model, dict_path, device, vocoder=None, griffin_lim=False,
                     max_frames=1024, bucket_tokens=TTS_BUCKET_TOKENS):
    argv = ["--task", "t2s", "--ckpt", "random-init", "--dict", dict_path,
            "--max-batch", "1", "--dtype", cfg.dtype, "--max-frames", str(max_frames),
            "--tts-bucket-tokens", str(bucket_tokens)]
    args = build_parser().parse_args(argv + (["--griffin-lim"] if griffin_lim else []))
    return Service(args, model=model, cfg=cfg, vocoder=vocoder, device=device)


def phase_serve_tts(base_cfg, device="cuda", dtype="bfloat16", texts=TTS_TEXTS, seed=0,
                    max_frames=1024, bucket_tokens=TTS_BUCKET_TOKENS, vocoder_cfg=None):
    """``/tts`` in process: Service(--task t2s) at ``base_cfg`` with every
    kernel on, once with a HiFi-GAN vocoder (the released config, seeded
    weights through ``convert_hifigan_state_dict``) and once with
    ``--griffin-lim``, each answering ``texts``.  Per request: wall ms,
    decode steps, the waveform's seconds and each kernel's launches, which
    must be ``tts_launches_expected`` on a card; then one more request
    under ``torch.profiler``: every device launch per decode step."""
    cfg, model = tts_model(base_cfg, dtype, True, device, seed)
    on_card = torch.device(device).type == "cuda"
    card = card_line() if on_card else "cpu"
    results, counts = [], dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as d:
        dict_path = write_dictionary(d)
        services = (("hifigan", make_tts_service(
                        cfg, model, dict_path, device, max_frames=max_frames,
                        bucket_tokens=bucket_tokens,
                        vocoder=tts_vocoder(cfg.n_mels, device, seed, vocoder_cfg))),
                    ("griffin_lim", make_tts_service(
                        cfg, model, dict_path, device, griffin_lim=True,
                        max_frames=max_frames, bucket_tokens=bucket_tokens)))
    for name, svc in services:
        hop = 256
        for text in texts:
            _sync(device)
            before, steps0 = K.launch_counts(), svc.tts.steps_run
            t0 = time.perf_counter()
            wav = svc.synthesize(text)
            _sync(device)
            wall = (time.perf_counter() - t0) * 1e3
            launches = {n: c - before[n] for n, c in K.launch_counts().items()}
            for n, c in launches.items():
                counts[n] += c
            steps = svc.tts.steps_run - steps0
            tokens = len(text) + 1
            want = tts_launches_expected(cfg, steps) if on_card else dict.fromkeys(KERNELS, 0)
            max_steps = min(int(tokens * svc.tts.max_len_ratio / cfg.reduction_factor),
                            svc.tts.max_steps)
            results.append({"vocoder": name, "text_chars": len(text), "tokens": tokens,
                            "decode_steps": steps, "wall_ms": wall,
                            "ms_per_step": wall / max(steps, 1), "wav_s": len(wav) / SR,
                            "launches": launches, "card": card})
            if (launches != want or not 0 < steps <= max_steps + CHECK_EVERY
                    or len(wav) != max_steps * cfg.reduction_factor * hop
                    or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0):
                raise AssertionError(f"TTS request {results[-1]}: want launches {want}, "
                                     f"{max_steps} steps, {len(wav)} samples")
        if svc.tts_requests != len(texts) or svc.tts_calls != len(texts):
            raise AssertionError(f"Service counted {svc.tts_requests} TTS requests")
    for r in results:
        log(json.dumps({"served_tts": r}))
    out = {"counts": counts, "requests": results}
    if on_card:
        out["device_launches"] = tts_device_launches(services[0][1], texts[-1])
        log(json.dumps({"tts_device_launches": out["device_launches"]}))
    return out


def tts_device_launches(svc, text) -> dict:
    """Every launch the card runs for one /tts request (kernels, copies and
    fills, from ``torch.profiler``'s device events), per decode step too."""
    return device_profile(lambda: svc.synthesize(text), lambda: svc.tts.steps_run)


def device_profile(run, steps_run) -> dict:
    """Every launch the card runs for ``run()`` (kernels, copies and fills,
    from ``torch.profiler``'s device events), per decode step too
    (``steps_run()``, a decoder's step count, read before and after), the
    device's busy time (the union of the launches' intervals), the idle
    share of the profiled wall and the largest device times by name."""
    from torch.profiler import ProfilerActivity, profile

    steps0 = steps_run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    steps = steps_run() - steps0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = _union_ms([(e.time_range.start, e.time_range.end) for e in events])
    by_name = {}     # summed under the name's first 60 characters
    for e in events:
        key = e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_launches": len(events), "decode_steps": steps,
            "per_step": len(events) / steps if steps else None, "device_busy_ms": busy,
            "wall_ms_profiled": wall, "idle_share": 1.0 - busy / wall,
            "top_device_ms": {n: round(t, 3) for n, t in top}}


def _union_ms(intervals) -> float:
    """Total length in ms of the union of [start, end) intervals in us."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def decode_diff(k, p, mel_atol, focus_atol, wav_atol, what):
    """Two ``TTSResult``s, the kernel path's and the plain path's: lengths
    equal, mel, mel_before and stop probabilities within ``mel_atol``, the
    focus rate within ``focus_atol``, waveforms within ``wav_atol``, the
    kernel path's finite; else raises.  -> the differences."""
    diff = lambda a, b: (a.float() - b.float()).abs().max().item()
    res = {"lengths_kernel": k.lengths.tolist(), "lengths_plain": p.lengths.tolist(),
           "mel_max_abs_err": diff(k.mel, p.mel),
           "mel_before_max_abs_err": diff(k.mel_before, p.mel_before),
           "focus_rate_max_abs_err": diff(k.focus_rate, p.focus_rate),
           "focus_rate": k.focus_rate.tolist(),
           "wav_max_abs_err": diff(k.wav, p.wav),
           "stop_probs_max_abs_err": diff(k.stop_probs, p.stop_probs)}
    if (not torch.equal(k.lengths, p.lengths) or res["mel_max_abs_err"] > mel_atol
            or res["mel_before_max_abs_err"] > mel_atol
            or res["stop_probs_max_abs_err"] > mel_atol
            or res["focus_rate_max_abs_err"] > focus_atol
            or res["wav_max_abs_err"] > wav_atol
            or not all(torch.isfinite(t).all() for t in (k.mel, k.wav, k.focus_rate))):
        raise AssertionError(f"{what} paths differ: {res}")
    return res


def phase_tts_parity(base_cfg, device="cuda", texts=TTS_TEXTS, seed=0, max_frames=1024,
                     bucket_tokens=TTS_BUCKET_TOKENS, mel_atol=TOL_MEL, focus_atol=1e-4,
                     wav_atol=2e-3, vocoder_cfg=None):
    """f32, the same weights and the same prenet dropout generator seed: the
    kernel path (the text encoder's inference attention, the decode-step
    kernel with its max-probability output) against the plain path, the
    texts as one padded batch, twice.  First at ``TTS_STOP_BIAS``, where
    every row runs to its length bound.  Then at ``TTS_MIN_LEN_RATIO`` and a
    stop bias chosen from the first run's stop logits, so that the longest
    row's stop probability first reaches the threshold between its minimum
    length and the middle of its allowed range.  The stop logits do not
    feed back into the decode, so the frames stay the same and each row's
    stop step follows from the first run: both paths must stop every row
    there, the longest row early.  Each run: lengths equal, mel, mel_before
    and stop_probs within ``mel_atol`` (absolute), focus rate within
    ``focus_atol``, HiFi-GAN waveforms within ``wav_atol``."""
    from speecht5_tpu_torch.data.dictionary import load_cli_dictionary
    from speecht5_tpu_torch.decode.tts import TTSDecoder

    with tempfile.TemporaryDirectory() as d:
        dictionary, _ = load_cli_dictionary(write_dictionary(d), None)
    toks = np.full((len(texts), bucket_tokens), base_cfg.pad_id, np.int64)
    for b, text in enumerate(texts):
        ids = dictionary.encode_line(" ".join(list(text.upper().replace(" ", "|"))))
        toks[b, : len(ids)] = ids
    voc = tts_vocoder(base_cfg.n_mels, device, seed, vocoder_cfg)
    state, r = None, base_cfg.reduction_factor

    def run_pair(stop_bias, min_ratio):
        results = []
        for kernels in (True, False):
            nonlocal state
            cfg, model = tts_model(base_cfg, "float32", kernels, device, seed)
            if state is None:
                state = model.state_dict()
            model.load_state_dict(state)
            with torch.no_grad():
                model.speech_decoder_postnet.prob_out.bias.fill_(stop_bias)
            dec = TTSDecoder(model, max_frames=max_frames, vocoder=voc, device=device,
                             min_len_ratio=min_ratio)
            gen = torch.Generator(device=device).manual_seed(seed + 5)
            spk = torch.zeros(len(texts), cfg.spk_embed_dim, device=device)
            K.reset_launch_counts()
            results.append(dec.text_to_speech(toks, spk, generator=gen))
            counts = K.launch_counts()
            if torch.device(device).type == "cuda" and kernels != bool(
                    counts["flash_attention_bias"]):
                raise AssertionError(f"TTS parity: launches {counts} on the "
                                     f"{'kernel' if kernels else 'plain'} path")
            threshold = dec.threshold
            del model, dec
        k, p = results
        res = {"stop_bias": stop_bias, "threshold": threshold, "min_len_ratio": min_ratio,
               **decode_diff(k, p, mel_atol, focus_atol, wav_atol, "TTS")}
        return res, k

    result, k = run_pair(TTS_STOP_BIAS, 0.0)
    # each row's stop logits per step (the largest of its r frames) and its
    # step bound, from the first run; TTSDecoder's minimum steps
    bounds = (k.lengths // r).cpu()
    steps = int(bounds.max())
    probs = k.stop_probs[:, : steps * r].double().clamp(1e-300, 1 - 1e-16).cpu()
    logits = (torch.logit(probs) - TTS_STOP_BIAS).view(len(texts), steps, r).amax(-1)
    enc_len = torch.from_numpy(toks != base_cfg.pad_id).sum(-1).to(torch.float32)
    mins = (enc_len * TTS_MIN_LEN_RATIO / r).to(torch.int32)
    # a level 0.05 under the longest row's largest logit between its
    # minimum and the middle of its range makes its first step at or over
    # the level unambiguous on both paths
    row = int(bounds.argmax())
    lo = max(int(mins[row]), 1)
    level = logits[row, lo - 1: (lo + int(bounds[row])) // 2].max().item() - 0.05
    stop_bias = math.log(result["threshold"] / (1 - result["threshold"])) - level
    want = []
    for b in range(len(texts)):
        first = max(int(mins[b]), 1)
        hits = (logits[b, first - 1: int(bounds[b])] >= level).nonzero()
        want.append(r * (first + int(hits[0]) if len(hits) else int(bounds[b])))
    early, _ = run_pair(stop_bias, TTS_MIN_LEN_RATIO)
    early["row"], early["expected_lengths"] = row, want
    result["early_stop"] = early
    log(json.dumps({"phase": "tts_parity", **result}))
    if early["lengths_kernel"] != want or not want[row] < int(k.lengths[row]):
        raise AssertionError(f"TTS parity: the stop rule should give {want} frames, "
                             f"row {row} stopping early by threshold: {early}")
    return result


# ------------------------------------------------------------ VC / SE (s2s)


def write_vc_corpus(directory: str, n: int, seconds=(2.0, 6.0), spk_dim: int = 512,
                    seed: int = 0) -> str:
    """``n`` seeded source / target pairs of ``seconds`` (min, max) each, as
    WAVs, and a seeded ``spk_dim`` x-vector of the target speaker per pair,
    in ``directory``, with the s2s manifest ("src\\tn\\ttgt\\tn\\tspk.npy"
    rows under the directory).  Returns the manifest's path."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        src = synth_audio(float(rng.uniform(*seconds)), seed=seed + 5000 + i)
        tgt = synth_audio(float(rng.uniform(*seconds)), seed=seed + 6000 + i)
        write_wav(os.path.join(directory, f"src{i}.wav"), src)
        write_wav(os.path.join(directory, f"tgt{i}.wav"), tgt)
        np.save(os.path.join(directory, f"spk{i}.npy"),
                rng.standard_normal(spk_dim).astype(np.float32))
        rows.append(f"src{i}.wav\t{len(src)}\ttgt{i}.wav\t{len(tgt)}\tspk{i}.npy")
    manifest = os.path.join(directory, "vc.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write(directory + "\n" + "\n".join(rows) + "\n")
    return manifest


def synthetic_s2s_batch(cfg, batch, seconds=(2.0, 6.0), seed=0, se_mode=False):
    """One collated s2s micro-batch in device-mel mode, as ``cli/train.py``
    hands it to the trainer: ``batch`` pairs of ``write_vc_corpus`` read and
    collated by ``SpeechToSpeechDataset`` (with ``se_mode`` the source on the
    target's mel grid too); numpy arrays."""
    from speecht5_tpu_torch.data.manifests import SpeechToSpeechDataset

    with tempfile.TemporaryDirectory() as d:
        ds = SpeechToSpeechDataset(write_vc_corpus(d, batch, seconds, cfg.spk_embed_dim, seed),
                                   reduction_factor=cfg.reduction_factor, n_mels=cfg.n_mels,
                                   se_mode=se_mode, device_mel=True)
        b = ds.collate([ds[i] for i in range(batch)])
    b.pop("ids")
    return b


def _on(batch, device):
    """A collated batch on ``device``, wav_lengths on the host (as
    ``cli/train.py`` hands it over)."""
    return {k: torch.from_numpy(v) if k == "wav_lengths" else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


def phase_train_s2s(arch="speecht5_base", device="cuda", n_utts=32, updates=3,
                    seconds=(2.0, 6.0), flags=S2S_FLAGS, seed=0):
    """The VC fine-tune path through ``cli/train.main --task s2s`` (no labels,
    no dictionary): ``updates`` updates, then a resume that takes one more,
    over ``write_vc_corpus``'s pairs in a temporary directory removed at the
    end.  The mels come from the log-mel kernel, the source through the
    conv kernel under a gradient (``feature_grad_mult``) and the train
    attention kernel."""
    with tempfile.TemporaryDirectory() as d:
        manifest = write_vc_corpus(d, n_utts, seconds, getattr(C, arch)().spk_embed_dim, seed)
        args = ["--task", "s2s", "--arch", arch, "--manifest", manifest,
                "--save-dir", os.path.join(d, "ckpt"), *flags, "--keep-last", "1",
                "--log-interval", "1", "--seed", str(seed + 1), "--device", device]
        for ov in TRAIN_OVERRIDES:
            args += ["--override", ov]
        result = train_and_resume(args, os.path.join(d, "ckpt"), updates, device, "s2s",
                                  accum=_accum(flags))
    check_tts_metrics(result, flags, "s2s")
    log(json.dumps({"phase": "train_s2s", **result}))
    return result


def check_speech_train_counts(result, cfg, mels_per_micro_batch, what):
    """A speech-input train path's launches: the log-mel kernel
    ``mels_per_micro_batch`` times a micro-batch, the conv kernel once per
    strided feature-extractor layer (1..n) a micro-batch, the train kernels
    once per encoder layer run (``check_train_counts``), the inference
    attention and the decode-step kernel never."""
    c, n = result["counts"], result["micro_batches"]
    if (c["fused_log_mel"] != mels_per_micro_batch * n
            or c["conv_stack"] != (len(cfg.conv_features.layers) - 1) * n
            or c["banded_flash_attention"] or c["flash_attention_bias"]):
        raise AssertionError(f"{what} path launches wrong: {c}, {n} micro-batches")
    check_train_counts(c, result["layer_runs"], f"{what} encoder")


def phase_s2s_parity(base_cfg, device="cuda", batch=8, seconds=(2.0, 6.0), seed=0,
                     mel_atol=TOL_MEL, loss_rtol=1e-4, grad_rtol=1e-3):
    """One f32 s2s micro-batch, every dropout (the Tacotron prenet's too)
    and layerdrop at 0, the same weights: the kernel route (mels by the
    log-mel kernel, the conv kernel with its backward, the train attention)
    against the plain route (the twin's mels computed on the CPU, cuDNN's
    conv, plain attention): mels within ``mel_atol``, loss within
    ``loss_rtol`` relative, every parameter gradient within ``grad_rtol`` of
    its max |g| (``grad_gate``: or within twice its own move under a one-ulp
    input scaling, where that move is over half the gate), the conv
    weights' included.  Once as VC (r
    of the preset, ``prev_mel``), once as SE (r 1, ``se_predict``
    "masking", the source's mels the decoder input: 2 log-mel launches)."""
    out = {}
    for mode in ("vc", "se"):
        base = C.replace(base_cfg, dtype="float32")
        if mode == "se":
            base = C.replace(base, reduction_factor=1, se_predict="masking")
        cfg_k = C.apply_overrides(base, T2S_DETERMINISTIC + TRAIN_OVERRIDES)
        cfg_p = C.apply_overrides(base, T2S_DETERMINISTIC)
        b = synthetic_s2s_batch(base, batch, seconds, seed, se_mode=mode == "se")
        r = base.reduction_factor
        K.reset_launch_counts()
        mel_k = device_mel_batch(_on(b, device), base.n_mels, r)
        mel_launches = K.launch_counts()["fused_log_mel"]
        mel_p = device_mel_batch({k: torch.from_numpy(v) for k, v in b.items()},
                                 base.n_mels, r)
        mel_keys = ("target_mel", "prev_mel") + (("src_mel",) if mode == "se" else ())
        mel_err = {k: (mel_k[k].cpu() - mel_p[k]).abs().max().item() for k in mel_keys}
        b_plain = {k: v if k == "wav_lengths" else v.to(device) for k, v in mel_p.items()}
        b_ulp = {**b_plain, "wav": b_plain["wav"] * ULP_SCALE}
        (loss_k, g_k, _), (loss_p, g_p, _), (_, g_ulp, _) = route_grads(
            "s2s", ((cfg_k, mel_k), (cfg_p, b_plain), (cfg_p, b_ulp)),
            TrainConfig(use_guided_attn=True), seed, device)
        worst, worst_name, floored, over = grad_gate(g_k, g_p, g_ulp, grad_rtol)
        conv_worst, conv_live = conv_grads(g_k, g_p)
        res = {"mel_max_abs_err": mel_err, "mel_launches": mel_launches,
               "loss_kernel": loss_k, "loss_plain": loss_p,
               "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
               "worst_grad_rel_diff": worst, "worst_grad_param": worst_name,
               "grads_held_to_their_ulp_move": floored, "grads_over": over,
               "conv_grad_rel_diff": conv_worst}
        out[mode] = res
        want_mels = len(mel_keys) - 1 if torch.device(device).type == "cuda" else 0
        if (max(mel_err.values()) > mel_atol or res["loss_rel_diff"] > loss_rtol
                or over or mel_launches != want_mels or not conv_live):
            raise AssertionError(f"s2s routes differ ({mode}): {res}")
    log(json.dumps({"phase": "s2s_parity", **out}))
    return out


def conv_grads(g_k, g_p):
    """The conv kernel's weights (feature-extractor layers 1..n, whose
    gradient comes through the kernel's backward): the largest relative
    difference of their gradients between the routes, and whether every
    one is nonzero on the kernel route."""
    names = [n for n in g_k if ".feature_extractor.conv_" in n
             and not n.endswith("conv_0.weight")]
    worst = max((g_k[n] - g_p[n]).abs().max().item()
                / max(g_p[n].abs().max().item(), 1e-30) for n in names)
    return worst, all(g_k[n].abs().max() > 0 for n in names)


def vc_launches_expected(cfg, steps: int) -> dict:
    """The VC decode's launches for one request: the speech encoder's conv
    kernel per strided layer and its inference attention per layer (bf16:
    bias pass and main loop) once, and per decode step one decode-step
    launch per decoder layer for the self- and one for the
    cross-attention."""
    want = tts_launches_expected(cfg, steps)
    want["conv_stack"] = len(cfg.conv_features.layers) - 1
    return want


def phase_vc_decode(base_cfg, device="cuda", dtype="bfloat16", source_s=VC_SOURCE_S,
                    seed=0, max_frames=1024, vocoder_cfg=None, requests=2,
                    mel_atol=TOL_MEL, focus_atol=1e-4, wav_atol=2e-3):
    """VC decoding: ``TTSDecoder.speech_to_speech`` at ``base_cfg`` with
    every kernel on (the beam's overrides), batch 1, a seeded source of
    ``source_s`` and x-vector, HiFi-GAN at the released config, the stop
    bias at ``TTS_STOP_BIAS`` (every request runs to its length bound, 10
    frames an encoder frame).  Per request: wall ms, decode steps, audio
    seconds and launches, which must be ``vc_launches_expected`` on a card.
    Then the f32 kernel path against the plain path (``decode_diff``)."""
    from speecht5_tpu_torch.decode.tts import TTSDecoder

    wav = synth_audio(source_s, seed=400)[None]
    lengths = np.array([wav.shape[1]])
    spk = np.random.default_rng(seed + 9).standard_normal((1, base_cfg.spk_embed_dim))
    voc = tts_vocoder(base_cfg.n_mels, device, seed, vocoder_cfg)
    on_card = torch.device(device).type == "cuda"
    card = card_line() if on_card else "cpu"
    cfg, model = tts_model(base_cfg, dtype, True, device, seed)
    dec = TTSDecoder(model, max_frames=max_frames, vocoder=voc, device=device)
    frames = cfg.conv_features.out_length(wav.shape[1])
    max_steps = min(int(frames * dec.max_len_ratio / cfg.reduction_factor), dec.max_steps)
    results, counts = [], dict.fromkeys(KERNELS, 0)
    for _ in range(requests):
        _sync(device)
        before, steps0 = K.launch_counts(), dec.steps_run
        t0 = time.perf_counter()
        out = dec.speech_to_speech(wav, lengths, spk)
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        launches = {n: c - before[n] for n, c in K.launch_counts().items()}
        for n, c in launches.items():
            counts[n] += c
        steps = dec.steps_run - steps0
        audio_s = int(out.wav_lengths[0]) / SR
        results.append({"source_s": source_s, "encoder_frames": frames,
                        "decode_steps": steps, "wall_ms": wall,
                        "ms_per_step": wall / max(steps, 1), "wav_s": audio_s,
                        "launches": launches, "card": card})
        want = vc_launches_expected(cfg, steps) if on_card else dict.fromkeys(KERNELS, 0)
        if (launches != want or not 0 < steps <= max_steps + CHECK_EVERY
                or int(out.lengths[0]) != max_steps * cfg.reduction_factor
                or not torch.isfinite(out.wav).all()):
            raise AssertionError(f"VC request {results[-1]}: want launches {want}, "
                                 f"{max_steps} steps")
    del model, dec
    for r in results:
        log(json.dumps({"vc_decoded": r}))
    decoded, state = [], None
    for kernels in (True, False):
        cfg, model = tts_model(base_cfg, "float32", kernels, device, seed)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        dec = TTSDecoder(model, max_frames=max_frames, vocoder=voc, device=device)
        gen = torch.Generator(device=device).manual_seed(seed + 5)
        decoded.append(dec.speech_to_speech(wav, lengths, spk, generator=gen))
        del model, dec
    parity = decode_diff(*decoded, mel_atol, focus_atol, wav_atol, "VC")
    log(json.dumps({"phase": "vc_parity", **parity}))
    return {"counts": counts, "requests": results, "parity": parity}


# -------------------------------------------------------------- SID (s2c)


def write_sid_corpus(directory: str, n: int, seconds=(4.0, 10.0),
                     speakers: int = SID_SPEAKERS, seed: int = 0) -> str:
    """``n`` seeded utterances of ``seconds`` (min, max) over ``speakers``
    labels (utterance i is speaker i mod ``speakers``), with the s2c
    manifest ("file\\tn\\tspeaker" rows).  Returns the manifest's path."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        wav = synth_audio(float(rng.uniform(*seconds)), seed=seed + 7000 + i)
        write_wav(os.path.join(directory, f"sid{i}.wav"), wav)
        rows.append(f"sid{i}.wav\t{len(wav)}\tspk{i % speakers:02d}")
    manifest = os.path.join(directory, "sid.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write(directory + "\n" + "\n".join(rows) + "\n")
    return manifest


def synthetic_s2c_batch(batch, seconds=(4.0, 10.0), seed=0, max_sample_size=128000):
    """One collated s2c micro-batch as ``cli/train.py`` hands it to the
    trainer: ``batch`` utterances of ``write_sid_corpus`` read, cropped to
    ``max_sample_size`` and collated by ``SpeechToClassDataset``; numpy."""
    from speecht5_tpu_torch.data.manifests import SpeechToClassDataset

    with tempfile.TemporaryDirectory() as d:
        ds = SpeechToClassDataset(write_sid_corpus(d, batch, seconds, seed=seed),
                                  max_sample_size=max_sample_size, seed=seed)
        b = ds.collate([ds[i] for i in range(batch)])
    b.pop("ids")
    return b


def phase_train_s2c(arch="speecht5_base_sid", device="cuda", n_utts=32, updates=3,
                    seconds=(4.0, 10.0), flags=S2C_FLAGS, seed=0):
    """The SID fine-tune path through ``cli/train.main --task s2c``: the
    number of classes from the corpus' ``SID_SPEAKERS`` labels,
    ``class_map.txt`` written to the save dir, ``updates`` updates and a
    resume that takes one more.  The conv kernel runs under a gradient
    (``feature_grad_mult`` 1.0), the train attention on the crop."""
    with tempfile.TemporaryDirectory() as d:
        manifest = write_sid_corpus(d, n_utts, seconds, seed=seed)
        save_dir = os.path.join(d, "ckpt")
        args = ["--task", "s2c", "--arch", arch, "--manifest", manifest,
                "--save-dir", save_dir, *flags, "--keep-last", "1",
                "--log-interval", "1", "--seed", str(seed + 1), "--device", device]
        for ov in TRAIN_OVERRIDES:
            args += ["--override", ov]
        result = train_and_resume(args, save_dir, updates, device, "s2c",
                                  accum=_accum(flags))
        with open(os.path.join(save_dir, "class_map.txt"), encoding="utf-8") as f:
            class_map = [line.split("\t") for line in f.read().splitlines()]
    want = [[f"spk{i:02d}", str(i)] for i in range(min(SID_SPEAKERS, n_utts))]
    if class_map != want:
        raise AssertionError(f"class_map.txt: {class_map}")
    if result["metrics"] != ["accuracy", "grad_norm", "loss", "nll_loss"]:
        raise AssertionError(f"s2c metrics {result['metrics']}")
    result["classes"] = len(class_map)
    log(json.dumps({"phase": "train_s2c", **result}))
    return result


def phase_s2c_parity(base_cfg, device="cuda", batch=8, seconds=(4.0, 10.0), seed=0,
                     logit_rtol=1e-4, loss_rtol=1e-4, grad_rtol=1e-3, gap_tol=1e-4,
                     requests=2, max_sample_size=128000):
    """One f32 s2c micro-batch, dropout and layerdrop at 0, the same
    weights: the kernel route (the conv kernel with its backward, the train
    attention; in eval the inference attention) against the plain route:
    loss within ``loss_rtol`` relative, every gradient within ``grad_rtol``
    of its max |g| as ``grad_gate`` holds it (the conv weights' included;
    at random weights the decoder's cross-attention q / k gradients of the
    pooling query are ~1e-6 of the largest and move by ~1.5e-3 under a
    one-ulp input scaling), then in eval mode the
    logits within ``logit_rtol`` of max |logit| and ``SIDClassifier``'s
    class ids equal, a difference tolerated only where the plain route's
    top-2 logit gap is under ``gap_tol``.  Then one SID inference of a full
    ``max_sample_size`` crop at bf16 with the kernels, ``requests`` times:
    wall ms and launches (the inference attention per layer, bf16 two, and
    the conv per strided layer)."""
    from speecht5_tpu_torch.decode.sid import SIDClassifier

    base = C.replace(base_cfg, dtype="float32")
    cfg_k = C.apply_overrides(base, DETERMINISTIC + TRAIN_OVERRIDES + KERNEL_OVERRIDES)
    cfg_p = C.apply_overrides(base, DETERMINISTIC)
    b = _on(synthetic_s2c_batch(batch, seconds, seed, max_sample_size), device)

    def classify(model):
        with torch.no_grad():
            model.eval()
            logits, _ = model.forward_s2c(b["wav"], b["wav_lengths"])
            ids = SIDClassifier(model, device)(b["wav"], b["wav_lengths"])
        return logits, ids

    b_ulp = {**b, "wav": b["wav"] * ULP_SCALE}
    (loss_k, g_k, (lk, ids_k)), (loss_p, g_p, (lp, ids_p)), (_, g_ulp, _) = route_grads(
        "s2c", ((cfg_k, b), (cfg_p, b), (cfg_p, b_ulp)), TrainConfig(), seed, device,
        after=classify)
    worst, worst_name, floored, over = grad_gate(g_k, g_p, g_ulp, grad_rtol)
    conv_worst, conv_live = conv_grads(g_k, g_p)
    top2 = torch.topk(lp, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1])[ids_k != ids_p]
    res = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "worst_grad_rel_diff": worst, "worst_grad_param": worst_name,
           "grads_held_to_their_ulp_move": floored, "grads_over": over,
           "conv_grad_rel_diff": conv_worst,
           "logits_rel_diff": (lk - lp).abs().max().item() / lp.abs().max().item(),
           "class_ids_kernel": ids_k.tolist(), "class_ids_plain": ids_p.tolist(),
           "differing_ids_top2_gaps": gaps.tolist()}
    if (res["loss_rel_diff"] > loss_rtol or over
            or res["logits_rel_diff"] > logit_rtol or (gaps >= gap_tol).any()
            or not conv_live):
        raise AssertionError(f"s2c routes differ: {res}")
    log(json.dumps({"phase": "s2c_parity", **res}))

    cfg = C.apply_overrides(C.replace(base_cfg, dtype="bfloat16"), KERNEL_OVERRIDES)
    clf = SIDClassifier(init_model(cfg, torch.Generator().manual_seed(seed), device), device)
    wav = synth_audio(max_sample_size / SR, seed=500)[None]     # one full crop
    on_card = torch.device(device).type == "cuda"
    want = dict.fromkeys(KERNELS, 0)
    if on_card:
        want["banded_flash_attention"] = cfg.encoder.num_layers * K.fwd_launches(torch.bfloat16)
        want["conv_stack"] = len(cfg.conv_features.layers) - 1
    inference = []
    for _ in range(requests):
        _sync(device)
        before = K.launch_counts()
        t0 = time.perf_counter()
        ids = clf(wav, [wav.shape[1]])
        _sync(device)
        launches = {n: c - before[n] for n, c in K.launch_counts().items()}
        inference.append({"audio_s": wav.shape[1] / SR, "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "class_id": int(ids[0]), "launches": launches,
                          "card": card_line() if on_card else "cpu"})
        if launches != want or not 0 <= int(ids[0]) < cfg.sid.num_classes:
            raise AssertionError(f"SID inference {inference[-1]}: want launches {want}")
    log(json.dumps({"sid_inference": inference}))
    res["inference"] = inference
    res["counts"] = {n: sum(r["launches"][n] for r in inference) for n in KERNELS}
    return res


# ------------------------------------------------------------------- main


# ------------------------------------------------------- rescore, LM beam

RESCORE_LEX_FLAGS = ["--lm-weight", "0.5", "--word-score", "1"]
LEXICON_WORDS = 2000
LM_WEIGHT = 0.3


def rescore_launches_expected(cfg, chunks: int) -> dict:
    """ctc_rescore's launches: per chunk the encoder's (as the greedy arm's)
    and the conv stack's; pass 2 is one teacher-forced decoder forward, so
    no decode-step launch."""
    want = dict.fromkeys(KERNELS, 0)
    want["banded_flash_attention"] = (chunks * cfg.encoder.num_layers
                                      * K.fwd_launches(cfg.compute_dtype))
    want["conv_stack"] = chunks * (len(cfg.conv_features.layers) - 1)
    return want


class _PassTimes:
    """Stands in for the Service adapter's RescoreDecoder and keeps each
    call's pass times (``RescoreDecoder.last_ms``)."""

    def __init__(self, dec):
        self.dec, self.calls = dec, []

    def __call__(self, wav, lengths):
        rows = self.dec(wav, lengths)
        self.calls.append(dict(self.dec.last_ms))
        return rows


def phase_serve_rescore(base_cfg, device="cuda", dtype="bfloat16",
                        requests_s=(3, 11, 21), buckets="4,8,16", seed=0,
                        n_words=LEXICON_WORDS):
    """Service(--decoder ctc_rescore) with both inference kernels on, its
    buckets warmed, the requests served twice: open-vocabulary, then with a
    lexicon of ``n_words`` seeded words and a 3-gram ARPA over them
    (``write_lexicon_lm``; --lm-weight 0.5 --word-score 1).  Per request:
    wall ms, pass 1's device part ("encode") and host part ("pass1_host_ms",
    the N-best), pass 2 ("pass2_ms"), and each kernel's launches, which must
    be ``rescore_launches_expected`` on a card; a lexicon transcript holds
    lexicon words only.  Returns {run: {"counts", "requests"}}."""
    cfg = serve_config(base_cfg, dtype, kernels=True)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device)
    wavs = [synth_audio(s, seed=100 + i) for i, s in enumerate(requests_s)]
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    on_card = torch.device(device).type == "cuda"
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        dict_path = write_dictionary(d)
        lexicon, arpa = write_lexicon_lm(d, n_words, seed)
        words = {line.split("\t")[0] for line in open(lexicon, encoding="utf-8")}
        for name, extra in (("open", []), ("lexicon", ["--lexicon", lexicon, "--lm-path",
                                                       arpa, *RESCORE_LEX_FLAGS])):
            svc = make_service(cfg, model, dict_path, device, buckets,
                               decoder="ctc_rescore", extra=extra)
            svc.asr.dec = times = _PassTimes(svc.asr.dec)
            _sync(device)
            K.reset_launch_counts()
            results = []
            for secs, wav in zip(requests_s, wavs):
                before, n0 = K.launch_counts(), len(times.calls)
                t0 = time.perf_counter()
                text = svc.transcribe(wav)
                _sync(device)
                wall = (time.perf_counter() - t0) * 1e3
                launches = {n: c - before[n] for n, c in K.launch_counts().items()}
                chunks, calls = len(svc._chunk(wav)), times.calls[n0:]
                results.append({
                    "run": name, "request_s": secs, "chunks": chunks, "wall_ms": wall,
                    **{f"{k}_ms": sum(c[part] for c in calls) for k, part in
                       (("encode", "encode"), ("pass1_host", "nbest"),
                        ("pass2", "rescore"))},
                    "launches": launches, "words": len(text.split()), "card": card})
                want = (rescore_launches_expected(cfg, chunks) if on_card
                        else dict.fromkeys(KERNELS, 0))
                if launches != want or len(calls) != chunks:
                    raise AssertionError(f"rescore request of {secs} s ({name}): "
                                         f"launches {launches}, want {want}")
                if name == "lexicon" and not set(text.split()) <= words:
                    raise AssertionError(f"lexicon transcript holds non-words: {text!r}")
            counts = K.launch_counts()
            for r in results:
                log(json.dumps({"served_rescore": r}))
            runs[name] = {"counts": counts, "requests": results}
    return runs


def phase_rescore_parity(base_cfg, device="cuda", requests_s=(3, 11), buckets="4,8,16",
                         seed=0, nbest=8, score_rtol=1e-4, gap_tol=1e-4):
    """f32 weights, the kernel route (both inference kernels) against the
    plain route: pass 1 (host code) runs once, on the kernel route's
    posteriors, open-vocabulary and with no length cap, so the N
    hypotheses differ; pass 2 scores them on each route's encoder output:
    the scores within ``score_rtol`` relative, the chosen hypotheses equal
    unless the plain route's top two totals are within ``gap_tol``.  Also
    recorded: the routes' largest posterior difference and whether pass 1
    on the plain route's posteriors gives the same N-best lists."""
    from speecht5_tpu_torch.decode.asr import RescoreDecoder

    cfgs = [serve_config(base_cfg, "float32", kernels=k) for k in (True, False)]
    model_k = init_model(cfgs[0], torch.Generator().manual_seed(seed), device)
    model_t = init_model(cfgs[1], torch.Generator().manual_seed(seed + 1), device)
    model_t.load_state_dict(model_k.state_dict())
    cfg = cfgs[0]
    kw = dict(blank_id=cfg.blank_id, eos_id=cfg.eos_id, pad_id=cfg.pad_id, nbest=nbest,
              beam=50, ctc_weight=0.3, max_len=None, device=device)
    dec_k, dec_t = RescoreDecoder(model_k, **kw), RescoreDecoder(model_t, **kw)
    grid = [int(b) * SR for b in buckets.split(",")]
    worst_rel, lp_diff, equal, near_ties, nbest_equal = 0.0, 0.0, 0, [], 0
    for i, secs in enumerate(requests_s):
        wav = synth_audio(secs, seed=200 + i)
        T = next(b for b in grid if b >= len(wav))
        padded = np.zeros((1, T), np.float32)
        padded[0, : len(wav)] = wav
        enc_k, lp_k, fl_k = dec_k.encode(padded, [len(wav)])
        enc_t, lp_t, fl_t = dec_t.encode(padded, [len(wav)])
        if not np.array_equal(fl_k, fl_t):
            raise AssertionError(f"frame lengths differ: {fl_k} {fl_t}")
        lp_diff = max(lp_diff, float(np.abs(lp_k - lp_t)[0, : fl_k[0]].max()))
        lists = dec_k.nbest_lists(lp_k, fl_k)
        nbest_equal += int(lists == dec_t.nbest_lists(lp_t, fl_t))
        hyps, ctc = dec_k.candidates(lists)
        tf = [torch.from_numpy(a).to(device) for a in dec_k.teacher_forcing(hyps)]
        att_k = dec_k.score(enc_k, *tf).cpu().numpy()
        att_t = dec_t.score(enc_t, *tf).cpu().numpy()
        worst_rel = max(worst_rel, float((np.abs(att_k - att_t) / np.abs(att_t)).max()))
        tot_k, tot_t = (0.7 * a + 0.3 * np.asarray(ctc) for a in (att_k, att_t))
        bk, bt = int(tot_k[0].argmax()), int(tot_t[0].argmax())
        if hyps[0][bk] == hyps[0][bt]:
            equal += 1
            continue
        gap = np.sort(tot_t[0])[-1] - np.sort(tot_t[0])[-2]
        log(json.dumps({"rescore_parity_difference": {
            "request_s": secs, "kernel_pick": bk, "plain_pick": bt, "plain_top2_gap": gap}}))
        if gap >= gap_tol:
            raise AssertionError(f"rescore picks differ at {secs} s with no near tie")
        near_ties.append(secs)
    result = {"requests": len(requests_s), "equal_picks": equal, "near_ties": near_ties,
              "worst_pass2_rel_diff": worst_rel, "posterior_max_abs_diff": lp_diff,
              "nbest_lists_equal": nbest_equal,
              "hypothesis_tokens": [len(h) for h in hyps[0][:2]]}
    log(json.dumps({"phase": "rescore_parity", **result}))
    if worst_rel > score_rtol:
        raise AssertionError(f"pass 2 scores of the kernel route differ: {result}")
    return result


def lm_config(cfg, kernels: bool, tiny: bool = False):
    """The fusion LM at the model's vocabulary and pad id: the reference's
    geometry (``TransformerLMConfig()``: d 1280, 20 pre-LN layers, 16 heads
    of Dh 80) or ``lm_tiny``; its decode steps take the decode-step kernel
    when ``kernels``."""
    import dataclasses

    from speecht5_tpu_torch.models.lm import TransformerLMConfig, lm_tiny

    lmcfg = lm_tiny() if tiny else TransformerLMConfig()
    return dataclasses.replace(lmcfg, vocab_size=cfg.vocab_size, pad_id=cfg.pad_id,
                               trunk=dataclasses.replace(lmcfg.trunk,
                                                         use_pallas_attn=kernels))


def beam_lm_launches_expected(cfg, lm_layers: int, steps: int) -> dict:
    """An LM-fused beam request (one chunk): the encoder's and the conv
    stack's launches as the beam arm's, and per decode step one decode-step
    launch per decoder layer for self- and one for cross-attention, plus
    one per LM layer (its cached self-attention)."""
    want = beam_launches_expected(cfg, 1, steps)
    want["flash_attention_bias"] += lm_layers * steps
    return want


def _best(res):
    return res.tokens[0, 0, : int(res.lengths[0, 0])].tolist(), res.scores[0].tolist()


def phase_beam_lm(base_cfg, device="cuda", dtype="bfloat16", requests_s=(3, 11), seed=0,
                  max_len=BEAM_MAX_LEN, lm_weight=LM_WEIGHT, lm_tiny=False):
    """The LM-fused beam (``cli/evaluate.py --lm-ckpt``'s decoder):
    ``ASRDecoder`` at beam 5, CTC weight 0.3, ``lm_weight``, with every
    kernel on, over the model and a random seeded ``TransformerLMConfig()``
    LM (0.45 B parameters) in ``dtype``; one short warm-up decode, then the
    requests one at a time at their own length.  Per request: wall ms,
    decode steps and launches, which must be ``beam_lm_launches_expected``
    on a card (12 decoder and 20 LM decode-step launches a step at Base).
    On a card, then one 20-step request under ``torch.profiler``: device
    launches a step, busy time and idle share (``device_profile``).
    Returns the launches of the request window and the records."""
    from speecht5_tpu_torch.decode.asr import ASRDecoder
    from speecht5_tpu_torch.models.lm import init_lm

    cfg = serve_config(base_cfg, dtype, kernels=True, overrides=BEAM_OVERRIDES)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device)
    lmcfg = lm_config(cfg, kernels=True, tiny=lm_tiny)
    lm = init_lm(lmcfg, torch.Generator().manual_seed(seed + 2), device, cfg.compute_dtype)
    kw = dict(beam_size=BEAM, ctc_weight=0.3, lm=lm, lm_weight=lm_weight, device=device)
    ASRDecoder(model, max_len=4, **kw)(synth_audio(1.0, seed=99)[None], [SR])
    dec = ASRDecoder(model, max_len=max_len, **kw)
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    on_card = torch.device(device).type == "cuda"
    wavs = [synth_audio(s, seed=100 + i) for i, s in enumerate(requests_s)]
    _sync(device)
    K.reset_launch_counts()
    results = []
    for secs, wav in zip(requests_s, wavs):
        before, steps0 = K.launch_counts(), dec.steps_run
        t0 = time.perf_counter()
        res = dec(wav[None], [len(wav)])
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        launches = {n: c - before[n] for n, c in K.launch_counts().items()}
        steps = dec.steps_run - steps0
        best, scores = _best(res)
        results.append({"request_s": secs, "decode_steps": steps, "wall_ms": wall,
                        "ms_per_step": wall / max(steps, 1), "launches": launches,
                        "decode_step_launches_per_step":
                            launches["flash_attention_bias"] / max(steps, 1),
                        "hyp_tokens": len(best), "card": card})
        want = (beam_lm_launches_expected(cfg, lmcfg.trunk.num_layers, steps) if on_card
                else dict.fromkeys(KERNELS, 0))
        if launches != want or not 0 < steps <= max_len:
            raise AssertionError(f"LM beam request of {secs} s: launches {launches}, "
                                 f"want {want}, steps {steps}")
        if (not all(math.isfinite(x) for x in scores) or scores != sorted(scores)[::-1]
                or best[0] != cfg.eos_id or best[-1] != cfg.eos_id):
            raise AssertionError(f"LM beam result malformed: {scores} {best}")
    counts = K.launch_counts()
    for r in results:
        log(json.dumps({"beam_lm": r}))
    out = {"counts": counts, "requests": results,
           "lm_params": sum(p.numel() for p in lm.parameters())}
    if on_card:   # one more request, 20 steps, under torch.profiler
        short = ASRDecoder(model, max_len=20, **kw)
        out["device"] = device_profile(lambda: short(wavs[0][None], [len(wavs[0])]),
                                       lambda: short.steps_run)
        log(json.dumps({"beam_lm_device": out["device"]}))
    return out


def phase_beam_lm_parity(base_cfg, device="cuda", request_s=3, seed=0, max_len=60,
                         lm_weight=LM_WEIGHT, lm_tiny=False, score_rtol=1e-4,
                         gap_tol=1e-4):
    """f32, one request: the LM-fused beam with every kernel on (the LM's
    steps at Dh 80 through the decode-step kernel) against the plain route
    on the same model and LM weights: the best scores within ``score_rtol``
    relative and the best hypotheses equal, unless the plain route's top two
    were a near tie (as ``phase_beam_parity``)."""
    from speecht5_tpu_torch.decode.asr import ASRDecoder
    from speecht5_tpu_torch.models.lm import init_lm

    cfg_k = serve_config(base_cfg, "float32", kernels=True, overrides=BEAM_OVERRIDES)
    cfg_t = serve_config(base_cfg, "float32", kernels=False)
    model_k = init_model(cfg_k, torch.Generator().manual_seed(seed), device)
    model_t = init_model(cfg_t, torch.Generator().manual_seed(seed + 1), device)
    model_t.load_state_dict(model_k.state_dict())
    lm_k = init_lm(lm_config(cfg_k, True, lm_tiny), torch.Generator().manual_seed(seed + 2),
                   device)
    lm_t = init_lm(lm_config(cfg_t, False, lm_tiny), torch.Generator().manual_seed(seed + 3),
                   device)
    lm_t.load_state_dict(lm_k.state_dict())
    wav = synth_audio(request_s, seed=300)
    out = []
    for model, lm in ((model_k, lm_k), (model_t, lm_t)):
        dec = ASRDecoder(model, beam_size=BEAM, max_len=max_len, ctc_weight=0.3, lm=lm,
                         lm_weight=lm_weight, device=device)
        res = dec(wav[None], [len(wav)])
        out.append((res, dec.steps_run))
    (res_k, steps_k), (res_t, steps_t) = out
    (best_k, scores_k), (best_t, scores_t) = _best(res_k), _best(res_t)
    rel = abs(scores_k[0] - scores_t[0]) / abs(scores_t[0])
    hyps_t = [res_t.tokens[0, j, : int(res_t.lengths[0, j])].tolist() for j in range(BEAM)]
    result = {"equal_best": best_k == best_t, "score_rel_diff": rel,
              "decode_steps": {"kernel": steps_k, "plain": steps_t},
              "best_tokens": len(best_k)}
    if best_k != best_t:
        gap = scores_t[0] - scores_t[1] if best_k == hyps_t[1] else float("inf")
        result["plain_top2_gap"] = gap
        if gap >= gap_tol:
            raise AssertionError(f"LM beam tokens of the kernel path differ: {result}")
    log(json.dumps({"phase": "beam_lm_parity", **result}))
    if rel > score_rtol:
        raise AssertionError(f"LM beam scores of the kernel path differ: {result}")
    return result


def phase_evaluate(work_dir, train_args, updates, device="cuda",
                   arch="speecht5_base_asr", n_utts=EVAL_BATCH, seconds=(2.0, EVAL_MAX_S),
                   seed=0, max_len=EVAL_MAX_LEN, n_words=LEXICON_WORDS):
    """``cli/evaluate.py --task s2t`` on a checkpoint that the train phase
    saved in ``work_dir``/ckpt after ``updates`` + 1 updates: one more
    update of that run (``train_args``, ``--keep-last 2``) keeps two
    checkpoints; then on ``n_utts`` seeded utterances (``write_corpus``),
    one batch, bf16 with every kernel on: the beam with
    ``--ensemble-last 2`` and a fusion LM from ``--lm-ckpt`` (a seeded
    ``lm_tiny`` saved model-only here: 64 positions, so ``max_len`` 60),
    CTC greedy with ``--avg-last 2``, ``ctc_lexicon`` (a ``n_words``
    lexicon and 3-gram ARPA) and ``ctc_rescore``; each prints its JSON
    line, a WER over the corpus.  The kernels phase holds the kernels at
    this batch's shapes (EVAL_*).  Returns {"counts" (every run's
    launches), "results"}."""
    from speecht5_tpu_torch.cli import evaluate
    from speecht5_tpu_torch.models.lm import init_lm
    from speecht5_tpu_torch.utils.checkpoint import checkpoints, save_model_only

    ckpt_dir = os.path.join(work_dir, "ckpt")
    cli_train.main(train_args + ["--max-updates", str(updates + 2), "--keep-last", "2"])
    steps = [s for s, _ in checkpoints(ckpt_dir)]
    if steps != [updates + 1, updates + 2]:
        raise AssertionError(f"expected checkpoints {[updates + 1, updates + 2]}: {steps}")
    d = os.path.join(work_dir, "evaluate")
    os.makedirs(d)
    manifest, labels, dict_path = write_corpus(d, n_utts, seconds, seed + 7)
    lexicon, arpa = write_lexicon_lm(d, n_words, seed)
    cfg = C.apply_overrides(getattr(C, arch)(**DICT_CFG), BEAM_OVERRIDES)
    lmcfg = lm_config(cfg, True, tiny=True)
    if lmcfg.trunk.d_model // lmcfg.trunk.num_heads != EVAL_LM_DH:
        raise AssertionError("the kernels phase holds the evaluate LM's steps at "
                             f"D {EVAL_LM_DH}: {lmcfg.trunk}")
    lm = init_lm(lmcfg, torch.Generator().manual_seed(5), "cpu")
    save_model_only(os.path.join(d, "lm"), lm.state_dict(), 1)
    common = ["--task", "s2t", "--arch", arch, "--manifest", manifest, "--labels", labels,
              "--dict", dict_path, "--ckpt", ckpt_dir, "--batch-size", str(n_utts),
              "--dtype", "bfloat16", "--normalize", "--device", device,
              *[a for ov in BEAM_OVERRIDES for a in ("--override", ov)]]
    runs = {
        "beam": ["--beam", str(BEAM), "--max-len", str(max_len), "--ctc-weight", "0.3",
                 "--ensemble-last", "2", "--lm-ckpt", os.path.join(d, "lm"),
                 "--lm-arch", "tiny",
                 "--lm-weight", str(LM_WEIGHT)],
        "ctc_greedy": ["--decoder", "ctc_greedy", "--avg-last", "2"],
        "ctc_lexicon": ["--decoder", "ctc_lexicon", "--lexicon", lexicon, "--lm-path", arpa,
                        *RESCORE_LEX_FLAGS],
        "ctc_rescore": ["--decoder", "ctc_rescore", "--ctc-weight", "0.3", "--max-len",
                        str(max_len)],
    }
    _sync(device)
    K.reset_launch_counts()
    results = {}
    for name, flags in runs.items():
        res = evaluate.main(common + flags)
        if (res["metric"] != "wer" or res["n_utts"] != n_utts
                or not math.isfinite(res["value"])):
            raise AssertionError(f"evaluate {name}: {res}")
        results[name] = res
    _sync(device)
    counts = K.launch_counts()
    result = {"counts": counts, "results": results}
    log(json.dumps({"phase": "evaluate", **result}))
    return result


# ------------------------------------------------------------------ Large

# recipes/joint_pretrain.sh's flags at the smoke's batch (4 utterances of up
# to 15.6 s a card, accum 1); its lr, warmup and updates are the run's
PRETRAIN_FLAGS = ["--text-ratio", "1.0", "--tokens-per-sample", "512", "--lr", "2e-4",
                  "--warmup", "25000", "--accum", "1", "--batch-size", "4", "--normalize",
                  "--dtype", "bfloat16"]
# Large trains with the codebook mixing on and the train-attention kernel
LARGE_TRAIN_OVERRIDES = ["encoder.use_pallas_attn_train=True", "quantizer.enabled=True"]
# pretraining with every draw but the HuBERT masks, the Gumbel noise and the
# codebook permutation (handed in) at 0: Large has no dropout of its own
LARGE_STILL = ["encoder.layerdrop=0.0", "decoder.layerdrop=0.0",
               "speech_prenet.dropout=0.0", "speech_postnet.postnet_dropout=0.0"]
LARGE_SPEECH_S = (8.0, 15.6)
KM_CLASSES = 500
LARGE_HEADS = 16
LARGE_TRAIN_T = C.ConvFeatureConfig().out_length(250000)    # 781: the pretraining crop
# the Large serve phases' requests; the parity phases warm two buckets only
LARGE_REQUESTS_S = (3, 11)
LARGE_PARITY_BUCKETS = "4,16"


def large_config(dtype, overrides=(), arch="speecht5_large"):
    """The preset ``arch`` (Large; a smaller one with Large's overrides to
    rehearse on the CPU) at the letter vocabulary."""
    return C.apply_overrides(getattr(C, arch)(dtype=dtype, **DICT_CFG), list(overrides))


def write_pretrain_corpus(directory: str, n: int, seconds=LARGE_SPEECH_S,
                          text_lines: int = 400, seed: int = 0):
    """``write_corpus``'s ``n`` utterances with 50 Hz km labels of
    ``KM_CLASSES`` classes (one line an utterance) and a text corpus of
    ``text_lines`` lines of random letter words (fairseq .ltr tokens).
    -> (manifest, km labels, text file, dictionary)."""
    manifest, _, dict_path = write_corpus(directory, n, seconds, seed)
    rng = np.random.default_rng(seed + 1)
    with open(manifest, encoding="utf-8") as f:
        sizes = [int(l.split("\t")[1]) for l in f.read().splitlines()[1:] if l]
    km = os.path.join(directory, "train.km")
    with open(km, "w", encoding="utf-8") as f:
        for n_s in sizes:
            f.write(" ".join(map(str, rng.integers(0, KM_CLASSES, n_s * 50 // SR))) + "\n")
    letters = [chr(ord("A") + i) for i in range(26)]
    text = os.path.join(directory, "text.txt")
    with open(text, "w", encoding="utf-8") as f:
        for _ in range(text_lines):
            words = ["".join(rng.choice(letters, int(rng.integers(2, 8))))
                     for _ in range(int(rng.integers(3, 9)))]
            f.write(" ".join(" ".join(w) + " |" for w in words) + "\n")
    return manifest, km, text, dict_path


def pretrain_datasets(cfg, manifest, km, text, dict_path, seed=0):
    """The joint task's two datasets as ``cli/train.py`` builds them
    (device mels, --normalize, --tokens-per-sample 512)."""
    from speecht5_tpu_torch.data.dictionary import load_cli_dictionary
    from speecht5_tpu_torch.data.manifests import SpeechPretrainDataset, TextPretrainDataset

    dictionary, _ = load_cli_dictionary(dict_path)
    speech = SpeechPretrainDataset(manifest, km, n_mels=cfg.n_mels,
                                   reduction_factor=cfg.reduction_factor, normalize=True,
                                   device_mel=True, seed=seed)
    text = TextPretrainDataset(text, dictionary, 512, bos_id=cfg.bos_id, eos_id=cfg.eos_id,
                               pad_id=cfg.pad_id, mask_id=dictionary.index("<mask>"),
                               seed=seed)
    return speech, text


def mixed_seed(speech, text, updates, batch=4):
    """The first run seed whose epoch-0 order of modality-pure updates
    (``cli/train.epoch_units`` at text ratio 1) holds both tasks within its
    first ``updates``: the smoke's run must drive both."""
    import types

    ds = {"pretrain_speech": speech, "pretrain_text": text}
    for seed in range(1, 100):
        args = types.SimpleNamespace(max_tokens=0, batch_size=batch, accum=1,
                                     text_ratio=1.0, seed=seed, task="pretrain")
        if len({t for t, _ in cli_train.epoch_units(ds, args, 0)[:updates]}) == 2:
            return seed
    raise AssertionError("no seed mixes the tasks")


def phase_train_pretrain_large(device="cuda", n_utts=16, updates=3, seed=0,
                               seconds=LARGE_SPEECH_S, arch="speecht5_large", overrides=()):
    """Joint pretraining at speecht5_large through ``cli/train.main --task
    pretrain`` (recipes/joint_pretrain.sh's flags, batch 4, bf16, the
    quantizer on, the train-attention kernel on, mels on the card) over 16
    seeded 8-15.6 s utterances with 500-class km labels and a seeded text
    corpus: ``updates`` updates of both tasks, then a resume.  Checks: every
    metric finite; the log-mel kernel once per speech update, the train
    kernels once per encoder layer run (24 an update, speech or text), the
    conv, inference and decode-step kernels never.  Then
    ``large_update_profile``."""
    ovs = LARGE_TRAIN_OVERRIDES + list(overrides)
    cfg = large_config("bfloat16", ovs, arch)
    with tempfile.TemporaryDirectory() as d:
        manifest, km, text, dict_path = write_pretrain_corpus(d, n_utts, seconds, seed=seed)
        run_seed = mixed_seed(*pretrain_datasets(cfg, manifest, km, text, dict_path), updates)
        args = ["--task", "pretrain", "--arch", arch, "--manifest", manifest,
                "--labels", km, "--text-file", text, "--dict", dict_path,
                "--save-dir", os.path.join(d, "ckpt"), *PRETRAIN_FLAGS, "--keep-last", "1",
                "--log-interval", "1", "--seed", str(run_seed), "--device", device]
        for ov in ovs:
            args += ["--override", ov]
        result = train_and_resume(args, os.path.join(d, "ckpt"), updates, device, "pretrain")
    tasks = [next(iter(row)).split("/")[0] for row in result["history"]]
    speech = tasks[:updates].count("pretrain_speech")
    result.update(tasks=tasks, speech_updates=speech, run_seed=run_seed)
    c = result["counts"]
    if not 0 < speech < updates or result["layer_runs"] != cfg.encoder.num_layers * updates:
        raise AssertionError(f"pretrain updates {tasks}, {result['layer_runs']} layer runs")
    if torch.device(device).type == "cuda" and (
            c["fused_log_mel"] != speech or c["conv_stack"] or c["banded_flash_attention"]
            or c["flash_attention_bias"]):
        raise AssertionError(f"pretrain path launches wrong: {c}, tasks {tasks}, "
                             f"{result['layer_runs']} layer runs")
    if torch.device(device).type == "cuda":
        check_train_counts(c, result["layer_runs"], "Large encoder")
    log(json.dumps({"phase": "train_pretrain_large", **result}))
    if torch.device(device).type == "cuda":
        result["profile"] = large_update_profile(device, seed=seed)
    return result


def _attention_route(model, kernels: bool):
    """Every self-attention's train-kernel flag: the config flag, set on a
    built model (one model serves both routes)."""
    from speecht5_tpu_torch.models.attention import MultiheadAttention

    for m in model.modules():
        if isinstance(m, MultiheadAttention):
            m.use_pallas_train = kernels


def large_batches(cfg, batch, seconds, seed, device):
    """One pretrain_speech micro-batch (device mels), one s2t micro-batch of
    the same audio length and one pretrain_text micro-batch, as
    ``cli/train.py`` hands them to the trainer."""
    with tempfile.TemporaryDirectory() as d:
        speech, text = pretrain_datasets(
            cfg, *write_pretrain_corpus(d, batch, seconds, text_lines=150, seed=seed))
        sb = speech.collate([speech[i] for i in range(batch)], cfg.conv_features.out_length)
        tb = text.collate([text[i] for i in range(batch)])
    sb.pop("ids"), tb.pop("ids")
    return (_on(sb, device), synthetic_batch(cfg, batch, seconds, seed, device),
            _on(tb, device))


def large_update_profile(device="cuda", batch=4, seconds=LARGE_SPEECH_S, seed=0):
    """One bf16 speecht5_large update of pretrain_speech (the pretrain
    phase's batch) and of s2t (CTC weight 0.5) on each attention route (the
    train kernels, or plain attention with each layer's rel-pos bias by
    ``relative_bias``), after one warm-up update each: wall ms, device
    busy ms, idle share, the largest device times by kernel name and the
    peak device memory (``torch.cuda.max_memory_allocated``)."""
    cfg = large_config("bfloat16", LARGE_TRAIN_OVERRIDES)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device)
    trainer = Trainer(model, ["pretrain_speech", "s2t"], TrainConfig(ctc_weight=0.5))
    speech, s2t, _ = large_batches(cfg, batch, seconds, seed, device)
    out = {"card": card_line(), "batch": batch,
           "frames": {"pretrain_speech": int(speech["km_labels"].shape[1]),
                      "s2t": int(cfg.conv_features.out_length(s2t["wav"].shape[1]))}}
    for route in ("kernel", "plain"):
        _attention_route(model, route == "kernel")
        for task, b in (("pretrain_speech", speech), ("s2t", s2t)):
            trainer.train_step([b], task)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = device_profile(lambda: trainer.train_step([b], task), lambda: 0)
            rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            for k in ("decode_steps", "per_step"):
                rec.pop(k)
            out[f"{task}/{route}"] = rec
    log(json.dumps({"phase": "large_update_profile", **out}))
    del model, trainer
    torch.cuda.empty_cache()
    return out


def phase_pretrain_parity(device="cuda", batch=2, seconds=LARGE_SPEECH_S, seed=0,
                          loss_rtol=1e-4, grad_rtol=1e-3, arch="speecht5_large",
                          overrides=()):
    """f32 speecht5_large (the quantizer on, layerdrop and the speech
    decoder's dropout at 0), one speech micro-batch of 2 and one text
    micro-batch of 2 with the HuBERT masks, the Gumbel noise and the
    codebook permutations drawn once and handed to both routes: the kernel
    route (the train kernels reading each layer's band) against the plain
    route, each task's loss within ``loss_rtol`` relative and every
    gradient through ``grad_gate`` (the plain route once more on the
    waveform, or for text the token embeddings, scaled by ``ULP_SCALE``):
    norm_k's, the table's, the HuBERT head's and the quantizer's
    included."""
    from speecht5_tpu_torch.models.quantizer import gumbel_noise
    from speecht5_tpu_torch.models.speecht5 import codebook_perm
    from speecht5_tpu_torch.ops.masking import sample_feature_masks
    from speecht5_tpu_torch.train import criterions

    cfg = large_config("float32", ["quantizer.enabled=True"] + LARGE_STILL + list(overrides),
                       arch)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device).train()
    speech, _, text = large_batches(cfg, batch, seconds, seed, device)
    speech = device_mel_batch(speech, cfg.n_mels, cfg.reduction_factor)
    g = torch.Generator().manual_seed(seed + 3)
    G, V = cfg.quantizer.latent_groups, cfg.quantizer.latent_vars
    frames = speech["km_labels"].shape[1]
    masks = sample_feature_masks(cfg.conv_features.out_length(speech["wav_lengths"]),
                                 frames, cfg.d_model, cfg.masking, g)
    draws = {"speech": (gumbel_noise((batch * frames * G, V), g, device),
                        codebook_perm(frames, g)),
             "text": (gumbel_noise((batch * text["tokens"].shape[1] * G, V), g, device),
                      codebook_perm(text["tokens"].shape[1], g))}
    emb = model.text_encoder_prenet.embed_tokens.weight

    def run(task, kernels, ulp=False):
        _attention_route(model, kernels)
        model.zero_grad(set_to_none=True)
        gumbel, perm = draws[task]
        if task == "speech":
            b = dict(speech, wav=speech["wav"] * ULP_SCALE) if ulp else speech
            out = model.forward_pretrain_speech(
                b["wav"], b["wav_lengths"], b["prev_mel"], b["dec_lengths_r"],
                masks=masks, gumbel=gumbel, perm=perm)
            loss, _ = criterions.speech_pretrain_loss(
                out, [b["km_labels"]], b["target_mel"], b["dec_lengths"],
                out["valid_mask"].sum(-1), reduction_factor=cfg.reduction_factor)
        else:
            if ulp:
                with torch.no_grad():
                    emb.mul_(ULP_SCALE)
            out = model.forward_pretrain_text(text["tokens"], text["prev_tokens"],
                                              gumbel=gumbel, perm=perm)
            loss, _ = criterions.text_pretrain_loss(out, text["targets"], cfg.pad_id)
        loss.backward()
        if ulp and task == "text":
            with torch.no_grad():
                emb.div_(ULP_SCALE)
        return loss.item(), {n: None if p.grad is None else p.grad.clone()
                             for n, p in model.named_parameters()}

    result = {"card": card_line() if torch.device(device).type == "cuda" else "cpu"}
    for task in ("speech", "text"):
        K.reset_launch_counts()
        loss_k, g_k = run(task, True)
        launches = K.launch_counts()["banded_attention_train_fwd"]
        loss_p, g_p = run(task, False)
        _, g_ulp = run(task, False, ulp=True)
        worst, worst_name, floored, over = grad_gate(g_k, g_p, g_ulp, grad_rtol)
        res = {"loss_kernel": loss_k, "loss_plain": loss_p,
               "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
               "train_fwd_launches": launches,
               "worst_grad_rel_diff": worst, "worst_grad_param": worst_name,
               "grads_held_to_their_ulp_move": floored, "grads_over": over,
               "checked": {k: k in g_k and g_k[k] is not None for k in (
                   "encoder.layers.0.norm_k.weight", "encoder.pos_emb.pe_k.weight",
                   "speech_encoder_postnet.final_proj.weight",
                   "quantizer.weight_proj.weight")}}
        result[task] = res
        del g_k, g_p, g_ulp
        on_card = torch.device(device).type == "cuda"
        if (res["loss_rel_diff"] > loss_rtol or over or (on_card and not launches)
                or not all(res["checked"][k] for k in res["checked"]
                           if task == "speech" or "final_proj" not in k)):
            raise AssertionError(f"pretrain routes differ ({task}): {res}")
    log(json.dumps({"phase": "pretrain_parity", **result}))
    del model
    torch.cuda.empty_cache()
    return result


def kernels_line(records, counts, by_path=None):
    """The contract line: each kernel's path case (MAIN_CASE) in the named
    keys, the other cases under "other"; ``launches`` from the runs of the
    paths that drive the kernel (``counts``, summed over the paths), and
    per path under "launches_by_path"."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tolerance")
    rates = ("bound_share", "achieved_tflops",      # the redesigned kernels'
             "parts_ms", "graph_ms", "library_graph_ms", "bound_share_graph",
             "max_prob_err", "max_prob_tolerance",   # the TTS cross step's output
             "without_max_prob_ms", "without_max_prob_graph_ms")
    out = []
    for name, meta in KERNELS.items():
        main = records[name][MAIN_CASE[name]]
        out.append({
            "name": name, "route": "cuda", "impl": "cuda", **meta,
            "launches": counts[name], **{k: main[k] for k in keys},
            **{k: main[k] for k in rates if k in main},
            "launches_by_path": {p: c[name] for p, c in (by_path or {}).items()},
            "dtype": MAIN_CASE[name].split("/")[0], "case": MAIN_CASE[name],
            "shape": main["shape"],
            "other": {case: {k: rec[k] for k in keys + rates + ("shape",) if k in rec}
                      for case, rec in records[name].items()
                      if case != MAIN_CASE[name]},
        })
    return {"kernels": out}


def check_train_counts(counts, runs, what):
    """Each train wrapper launched its kernels once per attention layer run
    at the train paths' bf16 (``K.train_launches_per_layer``: the forward 2,
    dq/dband 3, dk/dv 1)."""
    per = K.train_launches_per_layer(torch.bfloat16)
    if not runs or any(counts[n] != runs * per[n] for n in TRAIN_KERNELS):
        raise AssertionError(f"train kernels launched {counts}, {what} layers ran "
                             f"{runs}, expected {per} a run")


def check_t2s_counts(result):
    """The t2s path's launches: the log-mel kernel once per micro-batch,
    the train kernels once per text-encoder layer run (bf16: the forward
    twice, dq/dband three times), the inference attention and conv kernels
    never."""
    c, runs = result["counts"], result["layer_runs"]
    if (c["fused_log_mel"] != result["micro_batches"] or c["banded_flash_attention"]
            or c["conv_stack"]):
        raise AssertionError(f"t2s path launches wrong: {c}")
    check_train_counts(c, runs, "text-encoder")


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(card_line())
    log(environment_line())

    walls = {}
    t0 = time.perf_counter()
    phase_build()
    walls["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    records = phase_kernels()
    walls["kernels"] = time.perf_counter() - t0

    base = C.speecht5_base_asr()
    t0 = time.perf_counter()
    served = phase_serve(base)
    walls["serve"] = time.perf_counter() - t0
    log(json.dumps({"phase": "serve", "launches": served["counts"]}))
    missing = [n for n in ("banded_flash_attention", "conv_stack")
               if served["counts"][n] == 0]
    if missing:
        raise AssertionError(f"serving path never launched {missing}")

    t0 = time.perf_counter()
    phase_parity(base)
    walls["parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    beam = phase_serve_beam(base)
    walls["serve_beam"] = time.perf_counter() - t0
    log(json.dumps({"phase": "serve_beam", "launches": beam["counts"]}))

    t0 = time.perf_counter()
    phase_beam_parity(base)
    walls["beam_parity"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        trained = phase_train(d)
        walls["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = phase_evaluate(d, trained["args"], updates=3)["counts"]
        walls["evaluate"] = time.perf_counter() - t0
    missing = [n for n in ("banded_flash_attention", "conv_stack", "flash_attention_bias")
               if ev[n] == 0]
    if missing:
        raise AssertionError(f"evaluate never launched {missing}: {ev}")
    tc = trained["counts"]
    if tc["banded_flash_attention"] != 0 or tc["conv_stack"] == 0:
        raise AssertionError(f"train path launches wrong: {tc}")
    check_train_counts(tc, trained["layer_runs"], "encoder")
    if not all(math.isfinite(v) for r in trained["history"] for v in r.values()):
        raise AssertionError("non-finite train metrics")

    t0 = time.perf_counter()
    phase_train_parity(base)
    walls["train_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    t2s = phase_train_t2s()
    walls["train_t2s"] = time.perf_counter() - t0
    check_t2s_counts(t2s)

    t0 = time.perf_counter()
    phase_t2s_parity(C.speecht5_base())
    walls["t2s_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    warm = phase_warm_start()
    walls["warm_start"] = time.perf_counter() - t0
    check_train_counts(warm["train_counts"], warm["layer_runs"], "warm-started encoder")
    wsc = warm["serve_counts"]
    if wsc["banded_flash_attention"] != base.encoder.num_layers * K.fwd_launches(
            torch.bfloat16) or wsc["conv_stack"] != len(base.conv_features.layers) - 1:
        raise AssertionError(f"greedy request from the converted checkpoint: {wsc}")

    t0 = time.perf_counter()
    tts = phase_serve_tts(C.speecht5_base())
    walls["serve_tts"] = time.perf_counter() - t0
    log(json.dumps({"phase": "serve_tts", "launches": tts["counts"]}))

    t0 = time.perf_counter()
    phase_tts_parity(C.speecht5_base())
    walls["tts_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    s2s = phase_train_s2s()
    walls["train_s2s"] = time.perf_counter() - t0
    check_speech_train_counts(s2s, C.speecht5_base(), 1, "s2s")

    t0 = time.perf_counter()
    phase_s2s_parity(C.speecht5_base())
    walls["s2s_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vc = phase_vc_decode(C.speecht5_base())
    walls["vc_decode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    s2c = phase_train_s2c()
    walls["train_s2c"] = time.perf_counter() - t0
    check_speech_train_counts(s2c, C.speecht5_base_sid(), 0, "s2c")

    t0 = time.perf_counter()
    sid = phase_s2c_parity(C.speecht5_base_sid(num_classes=SID_SPEAKERS))
    walls["s2c_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rescore = phase_serve_rescore(base)
    walls["serve_rescore"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase_rescore_parity(base)
    walls["rescore_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    beam_lm = phase_beam_lm(base)
    walls["beam_lm"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase_beam_lm_parity(base)
    walls["beam_lm_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pre = phase_train_pretrain_large()
    walls["train_pretrain_large"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase_pretrain_parity()
    walls["pretrain_parity"] = time.perf_counter() - t0

    large = C.speecht5_large()
    t0 = time.perf_counter()
    served_large = phase_serve(large, requests_s=LARGE_REQUESTS_S, chunked=False)
    log(json.dumps({"phase": "serve_large", "launches": served_large["counts"]}))
    want = {**dict.fromkeys(KERNELS, 0), "banded_flash_attention": len(LARGE_REQUESTS_S)
            * large.encoder.num_layers * K.fwd_launches(torch.bfloat16)}
    if served_large["counts"] != want:
        raise AssertionError(f"Large greedy launches {served_large['counts']}, want {want}")
    beam_large = phase_serve_beam(large, requests_s=LARGE_REQUESTS_S)
    log(json.dumps({"phase": "serve_beam_large", "launches": beam_large["counts"]}))
    walls["serve_large"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase_parity(large, requests_s=LARGE_REQUESTS_S, buckets=LARGE_PARITY_BUCKETS)
    phase_beam_parity(large, requests_s=LARGE_REQUESTS_S, buckets=LARGE_PARITY_BUCKETS)
    walls["large_parity"] = time.perf_counter() - t0

    walls["total"] = time.perf_counter() - t_start
    log(json.dumps({"phase_seconds": walls, "card": card_line()}))
    by_path = {"serve": served["counts"], "serve_beam": beam["counts"],
               "train_s2t": tc, "train_t2s": t2s["counts"],
               "warm_start_train": warm["train_counts"],
               "warm_start_serve": wsc, "serve_tts": tts["counts"],
               "train_s2s": s2s["counts"], "vc_decode": vc["counts"],
               "train_s2c": s2c["counts"], "sid_inference": sid["counts"],
               "evaluate": ev, "serve_rescore": rescore["open"]["counts"],
               "serve_rescore_lexicon": rescore["lexicon"]["counts"],
               "beam_lm": beam_lm["counts"], "train_pretrain_large": pre["counts"],
               "serve_large": served_large["counts"],
               "serve_beam_large": beam_large["counts"]}
    counts = {n: sum(c[n] for c in by_path.values()) for n in KERNELS}
    log(json.dumps(kernels_line(records, counts, by_path)))
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
