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
               "large_self_cache": N 80, Tk 201; f32 and bf16).  The
               parity sweep's batch (phase 28: 4 clips of 4000 samples,
               beam 2, max_len 8), bf16: the inference attention at N 48,
               T 12 ("sweep_b4"), the conv stack at batch 4
               ("b4_T799"), and its beam's decode steps in f32 and bf16
               ("sweep_cross_cached": q [4, 2, 12, 64], Tk 12;
               "sweep_self_cache": the cache [8, 9, 12, 64]).  The
               sibling families' shapes (phases 31-33), bf16: the inference
               attention at T 549 ("slm_T549", SpeechLM's 11 s request),
               the train kernels at N 48 (4 x 12), T 512 and 149
               ("r0.1/b4_T512", the unit encoder on mono units;
               "r0.1/b4_T149", the CTC recipe's 3 s utterances), the conv
               stack at batch 4 on 16 s ("b4"), and the 3 s beam's grouped
               cross step in f32 and bf16 ("sib_cross_cached": q [1, 5, 12,
               64], Tk 149).
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
               steps) and serving the 3 s request (a depth cut); per
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
               temporary directory as a recipe's raw data and made ready by
               ``cli/prep.py``: 28 as 16 kHz FLAC, 4 as 48 kHz FLAC that
               ``prep resample --sr 16000`` turns into 16 kHz WAV (FLAC
               written by ``write_flac``: VERBATIM subframes, a CONSTANT
               one for each leading block of silence, the samples' MD5),
               ``prep manifest --ext .wav .flac`` and ``prep wrd2ltr``
               (every row's length checked against its decoded audio): 3
               updates, then a resume that takes one more; each update's
               ``utils/flops.s2t_train_flops`` and MFU against 989e12.
               Every loss and grad norm must be finite; each train
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
               HiFi-GAN at the released config, the stop bias at -8: one
               request, its wall ms, decode steps, audio seconds and launches
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
               three inference kernels must launch; the beam's
               ``asr_decode_flops`` (per model of its ensemble) and MFU.
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
               parameters, random seeded, bf16) at beam 5, max_len 100, CTC
               weight 0.3, LM weight 0.3, every kernel on, a 3 s
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
               corpus (read from its fairseq-binarized ``.bin/.idx``,
               written by the port's ``MMapIndexedDatasetWriter``, whose
               blocks must equal the raw text's), the run seed the first
               whose first 3 updates hold both tasks: 3 updates and a
               resume, every metric finite; the log-mel kernel once per speech update, the train kernels
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
26. serve large -- Service at speecht5_large, bf16, buckets 4/8/16 s:
               greedy on the 3 s and 11 s requests (24 x 2 inference
               attention launches a request, no conv launch: the layer_norm
               mode has no kernel) and the beam on the 3 s one (its service
               warms the 4 s bucket; beam 5, max_len 200, CTC weight 0.3;
               12 decode-step launches a step), then one profiled beam
               request.
27. large parity -- f32, kernel route against plain route: greedy CTC
               ids (as 4, buckets 4/16) on the 3 s request and the beam
               (as 6, the 4 s bucket) on the 3 s one.
28. parity sweep -- right after 19: the checkpoint-day sweep's dry run,
               ``cli/parity.py --dry-run --dry-run-arch speecht5_base_asr
               --arms --device cuda`` (bf16, every kernel on): a random-init
               Base model saved model-only, 4 clips of 4000 samples, the
               beam (beam 2, max_len 8, CTC weight 0.3), CTC greedy and the
               rescore arm; every WER finite, and the inference attention,
               conv and decode-step kernels must launch.
29. parallel train -- ``cli/train.py --task s2t --arch speecht5_base_asr``
               at full width, f32, the kernel route, dropout, layerdrop and
               masking off, a global batch of 8 seeded 2-4 s clips (ragged
               transcripts), 3 updates at a fixed seed: once in this process,
               then by the fixed table ``PARALLEL_MODES``, every mode's
               ranks sharing the card over gloo (spawned, a file store in a
               temporary directory, gloo on loopback), all modes at once:
               data parallel, ``--fsdp`` and ``--n-model-shards 2``, 2
               ranks each.  Each mode prints
               its backend, world size, mesh, per-update losses and grad
               norms and the launch counts of its ranks; its losses must be
               within 1e-4 (tensor parallel 2e-3) of the one-process run's,
               and the train attention kernels and the conv kernel must
               launch on every rank.  Then, right after 19 in its directory,
               the wrapper's cost: 2 bf16 updates at the recipe's flags in
               this process and as data parallelism at world size 1 over
               NCCL (``PARALLEL_WRAPPER``), each update's wall side by side.
30. parallel evaluate -- right after 19, on its checkpoint:
               ``cli/evaluate.py --decoder beam --data-parallel`` (bf16,
               every kernel on, beam 5, max_len 60, CTC weight 0.3) over 2
               gloo ranks sharing the card, batch 8 of 8 seeded 4 s clips
               (one length, so each rank's 4 rows are bit for bit the
               one-process run's batch of 4: a random-weight beam's near
               ties cannot flip between the two), hypotheses gathered on
               rank 0: its hypotheses and WER must equal ``cli/evaluate.py
               --batch-size 4`` in this process, and the inference
               attention, conv and decode-step kernels must launch on both
               ranks.
31. speechlm -- SpeechLM-P Base (``models/speechlm.SpeechLMConfig()``: 6 + 6
               post-LN layers, d 768, 504 units, bf16, every kernel flag
               on): 3 updates of ``train/joint.speechlm_joint_loss`` at
               batch 4 over a ``MultiCorpusLoader`` of a speech corpus (8-16
               s, km units at 50 Hz) and a mono-unit corpus (256-511
               units); ``recipes/speechlm_ctc_finetune.run`` for 2 updates
               on the joint model's stack (3 s utterances); greedy CTC
               (``CTCDecoder``) on a 3 s and an 11 s request; FastText2Unit
               at ``fastspeech2_s()``: 3 updates and ``generate`` (no kernel).
32. speechut -- SpeechUT Base: 3 updates of
               ``recipes/speechut_joint_pretrain.run`` at batch 4 (speech,
               paired and mono streams), then the beam (beam 5, max_len 200,
               CTC 0.3) on a 3 s request through ``ASRDecoder``.
33. speech2c -- ``speech2c_base()``: 3 updates of
               ``recipes/speech2c_pretrain.run`` on a
               ``SpeechPretrainDataset(add_decoder_target=True)`` corpus of 8
               utterances of 8-16 s (batch 4), then the beam on a 3 s request.
34. siblings parity -- f32, the draws handed in, each family's kernel route
               against its plain route: the joint / pretraining losses
               (1e-4) and gradients (1e-3 of max |g|), SpeechLM's greedy CTC
               ids, SpeechUT's and Speech2C's best beam hypotheses (max_len
               60).  31-33 check every launch count exactly (the unit
               encoder's pass over SpeechUT's speech frames feeds no loss
               term: forward kernel only); the kernels phase adds their
               shapes (attention T 549, the train kernels at N 48, T 512
               and 149, the conv stack at batch 4, the 3 s beam's cross
               step).
35. yitrans -- YiTrans Base (``models/yitrans.YiTransConfig()``: 12 + 12
               layers, d 768, vocab 32000 (a dictionary of 31993 words, two
               language tags and <mask>), bf16, every kernel flag on)
               through ``recipes/yitrans_pretrain_finetune``: 3 stage-1
               updates at batch 4 (8-16 s speech with km units, denoised
               [en_XX] / [de_DE] text of 128-256 tokens), one update each
               of the ASR, MT and ST fine-tunes, then the beam (beam 5,
               max_len 200) on a 3 s ASR request (CTC 0.3) and on a 51-71
               token MT source through ``encode_text``.
36. vatlm   -- VATLM Base (``models/vatlm.VATLMConfig(phone_vocab_size=
               50)``: 12 + 6 layers, 88 x 88 video through the 3-D stem and
               ResNet-18, 104-d stacked fbank, 1000 km classes; bf16, every
               kernel flag on): 3 updates of ``recipes/vatlm_pretrain.run``
               at batch 4 on 2-4 s clips read by ``VATLMDataset`` (the
               train crop of 96 x 96 ROIs, flips), the three streams
               (audio+video, audio, phones) an update, BatchNorm in train
               mode; then the AVSR beam (``encode_method="encode_av"``) on
               a 3 s clip.
37. yitrans vatlm parity -- f32, the masks handed in, kernel route against
               plain route: YiTrans' stage-1 loss and gradients, its ASR
               and MT beams; VATLM's three-stream loss and gradients and
               the AVSR beam (max_len 60).  35-36 check every launch count
               exactly; the kernels phase adds their shapes (attention T
               61 and 75, the train kernels at N 48, T 258 and 100, the
               MT and AVSR beams' cross steps).
38. wavllm  -- WavLLM at ``WavLLMConfig()``'s released geometry (Whisper
               32 x 1280, WavLM Base, LLaMA 32 x 4096, LoRA r 8; bf16, the
               random seeded weights drawn on the card, every kernel flag
               on: WavLM's attention and the LLaMA decode step on
               ``flash_attention_bias``, the extractor on the conv stack):
               2 updates of ``recipes/wavllm_sft`` at batch 2 (8-16 s clips
               through ``WavLLMDataset``, 20-40 byte target tokens), then
               per request (10 s, 30 s) a prefill, ``generate`` and
               ``generate_beam`` (beam 4), max_new 32.  Launches checked
               exactly: 6 conv launches a WavLM forward, no attention
               launch in an update (its WavLM trains with dropout), 12
               attention launches a prefill (on the tiled kernel,
               ``flash_attention_bias_tiled``), 32 decode-step launches a
               step.
39. wavllm parity -- f32, Whisper 4 and LLaMA 4 layers at full width
               (WavLM's 12), kernel route against plain route, LoRA and
               LoRA-MoE: ``forward_sft`` logits (1e-4 of max), the SFT loss
               (1e-4), every trained parameter's gradient (``grad_gate``),
               greedy tokens and the beam's best equal (score 1e-4).  The
               kernels phase adds the decode-step kernel as WavLM's
               attention (T 499 / 1499 with the f32 bias) and as the LLaMA
               step (the cache [4, 675, 32, 128], the ancestry map), and the
               conv stack on 30 s.

40. s2st    -- Speech2S's S2ST chain (``recipes/speech2s_s2st``'s entry
               points) at ``SpeechUTConfig()``'s Base geometry with a
               1000-id unit vocabulary (bf16, every kernel flag on): one 3 s
               request through the speech encoder (conv stack, inference
               attention), the beam over units (beam 5, max_len 100), then
               ``CodeHiFiGANConfig()`` with the duration predictor and
               ``write_wav``.  Launches exact: 6 conv, 12 x 2 attention,
               12 decode-step launches a step.
41. encodec  -- EnCodec 24 kHz (f32, the LSTM on cuDNN): 10 s encoded at 8
               and 32 codebooks, each decoded back; no kernel on the path
               (every count 0).
42. vallex   -- VALL-E X at ``VALLEXConfig()`` (12 + 12 layers, d 1024, 16
               heads, 8 codebooks of 1024; bf16): 40 phonemes and a 3 s
               prompt (225 codes), ``synthesize`` (AR greedy to max_new
               150: the prefix prefilled on the dense route, then 12
               decode-step launches a step; 7 NAR passes), EnCodec decodes
               the 8 codebooks.
43. viola    -- VioLA at ``VioLAConfig()`` (24-layer trunk, 12-layer NAR;
               bf16): greedy ASR, MT and TTS to max_new 64 (24 decode-step
               launches a step), the NAR fill of the TTS codes and an
               EnCodec decode.
44. prosody  -- Prosody-SpeechT5 on ``speecht5_base`` with
               ``ProsodyConfig()`` (bf16): ``TTSDecoder.text_to_speech`` of a
               60-token text, 60 steps and HiFi-GAN, under the predicted
               prosody and under transfer from a 3 s reference mel;
               launches as a /tts request.
45. codec families parity -- f32, full width at 2 layers a stack, kernel
               route against plain route: the S2ST beam's units (score
               1e-4) and waveform (2e-3); VALL-E X's codes, AR step logits
               and NAR logits (1e-4 of max); VioLA's three tasks' tokens
               and step logits (1e-4); Prosody's TTS in both modes
               (lengths, mels, stop probabilities, waveforms 2e-3).  The
               kernels phase adds the decode-step kernel at the codec LMs'
               steps ("vallex_self_cache", "viola_self_cache").

Depth cut to make room for 29-30 (PR 17): the train phase resamples 4 of
its 32 utterances from 48 kHz (16 before), serve beam and beam parity take
the 3 s and 11 s requests (the 21 s chunked request stays in serve and
parity), the VC phase decodes one request, the LM-fused beam one 3 s
request, and Large's beam serving and beam parity the 3 s request.  For
31-34: Base's beam parity and Large's greedy parity take the 3 s
request alone, so does serve beam (the 11 s request stays in serve and
serve Large), and phase 34's f32 beams stop at max_len 60.
For 35-37: the profiled beam requests of serve beam and serve
Large stop at 50 decode steps (``PROFILED_STEPS``; 200 before: reading
the trace took ~15 s each; a second cut at 10 steps takes the encoder's
launches out of the launches a step), the profiled /tts request takes the shorter
text (60 steps, not 292), Base's and Large's f32 beam parity stop at
max_len 60, as phase 34's, VC decodes to 512 frames (256 steps, 512
before) and the LM-fused beam's request to max_len 100.  For 38-39: the
beam services of serve beam, beam parity, serve Large and Large parity
warm the 4 s bucket alone (``BEAM_BUCKETS``; 4/8/16 and 4/16 before:
each bucket's warm-up is a whole max_len decode), the profiled beam
requests stop at 20 decode steps (50 before).  So no beam decode at the
8 s or 16 s bucket's encoder lengths runs on the card any more (the
compared and counted beam requests are 3 s, in the 4 s bucket).  For
40-45: the parallel modes and the one-process run of phase 29 take 2
updates (3 before), and so does phase 11's warm-started fine-tune (its
preempted run resumes to 3, not 4).

The launch counts are zeroed just before each driven path (serve, serve
beam, train, train t2s, the warm-started train and request, serve tts,
train s2s, the VC requests, train s2c, the SID inference, evaluate, the
parity sweep, the two rescore runs, the LM-fused beam, Large's
pretraining, greedy and beam requests, each parallel rank's run, each
sibling family's updates, CTC recipe, requests and beam, WavLLM's
updates, prefills, greedy and beam requests, and the codec families' S2ST
request, EnCodec round trips, VALL-E X synthesis, VioLA tasks and Prosody
requests) and read just after; a kernel of that path that was never launched fails.
Output: an early line with the card's name and power limit as nvidia-smi
gives them, one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  A watchdog ends a hung run with a
traceback after 1100 s.  Phases 24-27 take ``arch`` / ``overrides`` (or a
config) so that they rehearse on the CPU at a Large-shaped tiny preset.
The script opens sockets on loopback only: gloo's (and NCCL's) between the
ranks of phases 29-30, which meet through a file store.  The training
loop's data prefetch thread ends with each run; the train subprocess of
phase 11 and the ranks of phases 29-30 are waited for, or killed on a
failure or after ``PARALLEL_RANK_S``, and a rank's non-zero exit fails the
run.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import math
import os
import shutil
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
from speecht5_tpu_torch.data.vatlm import VATLMDataset
from speecht5_tpu_torch.data.wavllm import WHISPER_HOP, prompt_strings
from speecht5_tpu_torch.data.manifests import (AUDIO_BUCKETS, TOKEN_BUCKETS,
                                               SpeechPretrainDataset, SpeechToTextDataset,
                                               bucket_length, collate_mel_targets)
from speecht5_tpu_torch.data.multicorpus import MultiCorpusLoader, TokenCorpusSpec
from speecht5_tpu_torch.decode.asr import ASRDecoder, CTCDecoder
from speecht5_tpu_torch.models.attention import band_from_table
from speecht5_tpu_torch.models.common import init_weights
from speecht5_tpu_torch.models.encoder import BAND_ROW_MULTIPLE
from speecht5_tpu_torch.models.fastspeech2 import (fastspeech2_s, fastspeech2_tiny,
                                                   init_fastspeech2)
from speecht5_tpu_torch.models.layers import EncoderLayer
from speecht5_tpu_torch.models.speech2c import (init_speech2c, speech2c_base,
                                                speech2c_pretrain_loss)
from speecht5_tpu_torch.models.speechlm import (SpeechLMConfig, SpeechLMCtc, init_speechlm,
                                                mix_selection, speechlm_tiny, text_masking)
from speecht5_tpu_torch.models.speechut import SpeechUTConfig, init_speechut, speechut_tiny
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.models.vatlm import VATLMConfig, init_vatlm, vatlm_tiny
from speecht5_tpu_torch.models.wavllm import WavLLMConfig, init_wavllm, wavllm_tiny
from speecht5_tpu_torch.models.yitrans import YiTransConfig, init_yitrans, yitrans_tiny
from speecht5_tpu_torch.models.encodec import encodec_24khz, encodec_tiny, init_encodec
from speecht5_tpu_torch.models.hifigan import (CodeHiFiGANConfig, HiFiGANConfig,
                                               init_codehifigan)
from speecht5_tpu_torch.models.prosody import (ProsodyConfig, ProsodyTransfer,
                                               init_prosody_speecht5)
from speecht5_tpu_torch.models.vallex import VALLEXConfig, init_vallex, vallex_tiny
from speecht5_tpu_torch.models.viola import VioLAConfig, init_viola, viola_tiny
from speecht5_tpu_torch.decode.tts import TTSDecoder
from speecht5_tpu_torch.ops.mel import log_mel_numpy
from speecht5_tpu_torch.recipes import speech2s_s2st as s2st_recipe
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.ops.masking import sample_feature_masks
from speecht5_tpu_torch.ops.mel import mel_filterbank
from speecht5_tpu_torch.recipes import speech2c_pretrain as s2c_recipe
from speecht5_tpu_torch.recipes import speechlm_ctc_finetune as slm_recipe
from speecht5_tpu_torch.recipes import speechut_joint_pretrain as sut_recipe
from speecht5_tpu_torch.recipes import vatlm_pretrain as vat_recipe
from speecht5_tpu_torch.recipes import wavllm_sft as wavllm_recipe
from speecht5_tpu_torch.recipes import yitrans_pretrain_finetune as yit_recipe
from speecht5_tpu_torch.recipes.common import adamw as recipe_adamw
from speecht5_tpu_torch.train.criterions import fasttext2unit_loss
from speecht5_tpu_torch.train.joint import (VATLM_STREAMS, JointLossConfig,
                                            speechlm_joint_loss, speechut_joint_loss,
                                            vatlm_pretrain_loss, yitrans_pretrain_loss)
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
    # the same wrapper's query-tiled kernel (K.flash_bias_path): WavLM's
    # self-attention; its launches are also counted in flash_attention_bias's
    "flash_attention_bias_tiled": {
        "source": "speecht5_tpu_torch/csrc/flash_attention_bias_tiled.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:624",
    },
}
TRAIN_KERNELS = ("banded_attention_train_fwd", "banded_attention_train_bwd_dq",
                 "banded_attention_train_bwd_dkv")
# the case of each kernel that its path runs: the served chunk (bf16, batch
# 1), the recipe's train step (bf16, attention dropout 0.1), the t2s step's
# mel targets (f32, 16 rows of 768 frames), the beam's grouped
# cross-attention step through the cached entry (bf16, batch 1, beam 5), and
# WavLM's self-attention on the 30 s WavLLM request (bf16, the tiled kernel)
MAIN_CASE = {"banded_flash_attention": "bfloat16/b1", "conv_stack": "bfloat16/b1",
             **{n: "bfloat16/r0.1" for n in TRAIN_KERNELS},
             "fused_log_mel": "float32/b16", "flash_attention_bias": "bfloat16/cross_cached",
             "flash_attention_bias_tiled": "bfloat16/wavlm_T1499"}
KERNEL_OVERRIDES = ["encoder.use_pallas_attn=True", "conv_features.impl='pallas'"]
# the beam arm's decode steps through flash_attention_bias as well
BEAM_OVERRIDES = KERNEL_OVERRIDES + ["decoder.use_pallas_attn=True"]
# cli/serve.py's beam defaults (JAX cli/serve.py:549-551)
BEAM, BEAM_MAX_LEN = 5, 200
PROFILED_STEPS = 20         # the profiled beam request's decode steps
PROFILED_SHORT_STEPS = 10   # its short cut: the difference is per step
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
# the parity sweep's dry run (cli/parity.py --dry-run): 4 clips of 4000
# samples (the 0.25 s audio bucket) in one batch, beam 2, max_len 8
SWEEP_BATCH, SWEEP_SAMPLES, SWEEP_BEAM, SWEEP_MAX_LEN = 4, 4000, 2, 8
SWEEP_FRAMES = C.ConvFeatureConfig().out_length(SWEEP_SAMPLES)
SWEEP_CONV_T = (SWEEP_SAMPLES - 10) // 5 + 1
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
# phase 29: the modes of the parallel train path, a fixed table (name, ranks,
# backend, flags); every rank of a mode shares the one card, which NCCL
# refuses and gloo carries (its collectives on the card's tensors staged
# through the host)
# (FSDP over tensor parallelism is not in it: on the card over gloo,
# FSDP's post-backward moves the split gradients with DTensor's functional
# collectives, which crash over gloo on a card's tensors; the CPU tests
# hold that mode on 4 gloo ranks)
PARALLEL_MODES = (("dp", 2, "gloo", []),
                  ("fsdp", 2, "gloo", ["--fsdp"]),
                  ("tp", 2, "gloo", ["--n-model-shards", "2"]))
PARALLEL_TOL = {"dp": 1e-4, "fsdp": 1e-4, "tp": 2e-3}   # relative, on the losses
# the wrapper's cost: data parallelism at world size 1 over NCCL
PARALLEL_WRAPPER = ("dp_nccl", 1, "nccl", [])
PARALLEL_RANK_S = 300       # a rank's watchdog
# depth cut for phases 40-45: the parallel modes' and the warm start's
# updates (3 before)
PARALLEL_UPDATES, WARM_UPDATES = 2, 2
PARALLEL_BATCH, PARALLEL_SECONDS = 8, (2.0, 4.0)
PARALLEL_EVAL_SECONDS = 4.0
# depth cut for phases 29-30: the train phase resamples every 8th utterance
# from 48 kHz, the beam phases skip the 21 s request, and so on (main())
RESAMPLED_EVERY = 8
BEAM_REQUESTS_S = (3, 11)
# the bucket of the 3 s beam requests: a beam Service warms each of its
# buckets with a whole max_len decode (random weights never stop early),
# so the beam phases warm only the one their requests use
BEAM_BUCKETS = "4"
# encoder frames at Base: a 3 s VC source, the 6 s s2s audio bucket, the
# 8 s s2c crop (--max-sample-size 128000)
VC_SOURCE_S = 3.0
VC_MAX_FRAMES = 512          # the VC phase's bound: 256 decode steps at r 2
BEAM_LM_MAX_LEN = 100        # the LM-fused beam's request
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


def synth_audio(seconds: float, seed: int, sr: int = SR) -> np.ndarray:
    """Deterministic speech-like test signal at ``sr`` Hz: a few gliding
    tones + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.02 * rng.standard_normal(t.shape)
    for _ in range(4):
        f0, f1 = rng.uniform(100, 3000, size=2)
        wav += 0.1 * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * t[-1])))
    return wav.astype(np.float32)


def card_generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded ``seed``: ``init_model`` draws the
    weights there (milliseconds on the card, seconds on the host CPU)."""
    return torch.Generator(device=device).manual_seed(seed)


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
    Tk]), each serving its heads.  "wavlm_T<T>": WavLM's self-attention on
    one request of T frames (499: 10 s, 1499: 30 s) as its kernel route
    calls the contract entry: N = 12 heads, Tq = Tk = T, D 64, the f32
    gated bias [12, T, T], the sample's mask [1, T] (every frame valid);
    T 77 is a multiple of neither 8 nor 64.  "wavlm_b2_T<T>": WavLM's padded
    batch of two, N = 24, the mask [2, T] with the second sample's first
    1000 frames valid.  "wavlm_b2_empty_T<T>": the same with a second sample
    that has no valid frame (its 12 rows return the mean of V).  -> q, k,
    v, key_valid, bias (None: a zero bias)."""
    g = torch.Generator().manual_seed(seed)
    if case.startswith("wavlm_"):
        T = int(case.split("_T")[-1])
        N, Tq, Tk, D = 12, T, T, 64
        valid = ([T] if "_b2_" not in case else
                 [T, 0] if "_empty_" in case else [T, min(1000, T)])
        N *= len(valid)
    else:
        N, Tq, Tk, valid, mask_rows, D = {"cross": (12, 5, 799, 549, 1, 64),
                                          "self": (60, 1, 201, 101, 5, 64),
                                          "lm_self": (5 * LM_HEADS, 1, 201, 101, 5, LM_DH)}[case]
        valid = [valid] * mask_rows
    q = (torch.randn(N, Tq, D, generator=g) * D ** -0.5).to(dtype)
    k, v = (torch.randn(N, Tk, D, generator=g).to(dtype) for _ in range(2))
    key_valid = torch.arange(Tk)[None, :] < torch.tensor(valid)[:, None]
    bias = (torch.randn(N, Tq, Tk, generator=g) * 0.5).to(device) if case.startswith(
        "wavlm_") else None
    return [t.to(device) for t in (q, k, v, key_valid)] + [bias]


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
    frames, each sample's own 2-5 s of them valid).  The parity sweep's
    beam at batch 4 x beam 2 over 4000-sample clips: "sweep_self_cache"
    (the cache [8, 9, 12, 64] at step 4 of max_len 8) and
    "sweep_cross_cached" (q [4, 2, 12, 64] against the clips' 12 encoder
    frames, all valid).  The SpeechUT / Speech2C beam on a 3 s request:
    "sib_cross_cached" (q [1, 5, 12, 64] against its 149 encoder frames, all
    valid).  YiTrans' MT beam and VATLM's AVSR beam: "yit_mt_cross_cached"
    (q [1, 5, 12, 64] against the 61-token source) and "vat_cross_cached"
    (against the 3 s clip's 75 frames at 25 Hz), all valid.  WavLLM's LLaMA
    decode step in the 30 s request's beam: "llama_self_cache" (q [4, 1, 32,
    128], the cache [4, 675, 32, 128] at step 16 of 32 (slot 658), the int64
    ancestry map within the 4 lanes, the lanes' own masks [4, 675] as
    ``WavLLMModel._decode_step`` builds them).  The codec LMs' steps at
    their half-way step, 16 heads of Dh 64, batch 1, no row map:
    "vallex_self_cache" (VALL-E X's AR stage, the cache [1, 416, 16, 64]
    of a 266-slot prefix and 150 codes) and "viola_self_cache" (VioLA's
    trunk in the ASR task, the cache [1, 217, 16, 64] of a 153-slot
    prefix and 64 tokens), the causal mask [1, Tc].  -> q4, k4, v4,
    key_valid, rows."""
    g = torch.Generator().manual_seed(seed)
    if case in ("vallex_self_cache", "viola_self_cache"):
        L0, n = ((VALLEX_PHONEMES + 1 + VALLEX_PROMPT, VALLEX_MAX_NEW)
                 if case.startswith("vallex") else (VIOLA_UNITS + 3, VIOLA_MAX_NEW))
        Tc, pos, H = L0 + n, L0 + n // 2 - 1, 16
        q4 = (torch.randn(1, 1, H, 64, generator=g) * 64 ** -0.5).to(dtype)
        k4, v4 = (torch.randn(1, Tc, H, 64, generator=g).to(dtype) for _ in range(2))
        key_valid = torch.arange(Tc)[None, :] <= pos
        return (*(t.to(device) for t in (q4, k4, v4, key_valid)), None)
    if case == "llama_self_cache":
        L0 = wavllm_prefix_len(WAVLLM_REQUESTS_S[-1])
        Tc, pos, B, H, D = L0 + WAVLLM_MAX_NEW, L0 + WAVLLM_MAX_NEW // 2 - 1, WAVLLM_BEAM, 32, 128
        q4 = (torch.randn(B, 1, H, D, generator=g) * D ** -0.5).to(dtype)
        k4, v4 = (torch.randn(B, Tc, H, D, generator=g).to(dtype) for _ in range(2))
        rows = torch.randint(0, B, (B, Tc), generator=g)
        rows[:, pos + 1:] = torch.arange(B)[:, None]     # the lanes' own next writes
        key_valid = (torch.arange(Tc)[None, :] <= pos).expand(B, Tc).contiguous()
        return (*(t.to(device) for t in (q4, k4, v4, key_valid)), rows.to(device))
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
    elif case in ("self_cache", "lm_self_cache", "eval_self_cache", "eval_lm_self_cache",
                  "sweep_self_cache"):
        Bs, beam, Tc, pos = {"eval": (EVAL_BATCH, BEAM, EVAL_MAX_LEN + 1, 30),
                             "sweep": (SWEEP_BATCH, SWEEP_BEAM, SWEEP_MAX_LEN + 1, 4)}.get(
            case.split("_")[0], (1, BEAM, BEAM_MAX_LEN + 1, 100))
        B = Bs * beam
        q4 = (torch.randn(B, 1, H, D, generator=g) * D ** -0.5).to(dtype)
        k4, v4 = (torch.randn(B, Tc, H, D, generator=g).to(dtype) for _ in range(2))
        rows = (torch.arange(B) // beam * beam)[:, None] + torch.randint(
            0, beam, (B, Tc), generator=g)
        rows[:, pos + 1:] = torch.arange(B)[:, None]     # the rows' own next writes
        key_valid = torch.arange(Tc)[None, :] <= pos
    else:
        Bs, beam, Tk = {"eval_cross_cached": (EVAL_BATCH, BEAM, EVAL_FRAMES),
                        "sweep_cross_cached": (SWEEP_BATCH, SWEEP_BEAM, SWEEP_FRAMES),
                        "sib_cross_cached": (1, BEAM, VC_SOURCE_FRAMES),
                        "yit_mt_cross_cached": (1, BEAM, YIT_MT_T),
                        "vat_cross_cached": (1, BEAM, VAT_BEAM_T)
                        }.get(case, (1, BEAM, 799))
        q4 = (torch.randn(Bs, beam, H, 64, generator=g) * 64 ** -0.5).to(dtype)
        k4, v4 = (torch.randn(Bs, H, Tk, 64, generator=g).to(dtype).transpose(1, 2)
                  for _ in range(2))
        rows = None
        if case == "eval_cross_cached":
            valid = torch.randint(2 * Tk // 5, Tk + 1, (Bs,), generator=g)
            valid[0] = Tk                                  # the batch's longest clip
        elif case in ("sweep_cross_cached", "sib_cross_cached", "yit_mt_cross_cached",
                      "vat_cross_cached"):
            valid = torch.full((Bs,), Tk)                  # every frame valid
        else:
            valid = torch.tensor([549])
        key_valid = torch.arange(Tk)[None, :] < valid[:, None]
    out = [t.to(device) for t in (q4, k4, v4, key_valid)]
    return (*out, None if rows is None else rows.to(device))


# the decode steps through the cached entry (flash_bias_cache_case), and
# through the contract entry on [N, T, D] rows (flash_bias_case)
FLASH_BIAS_CACHED_CASES = (
    "cross_cached", "self_cache", "tts_self", "tts_cross", "vc_cross", "lm_self_cache",
    "eval_cross_cached", "eval_self_cache", "eval_lm_self_cache", "large_cross_cached",
    "large_self_cache", "sweep_cross_cached", "sweep_self_cache", "sib_cross_cached",
    "yit_mt_cross_cached", "vat_cross_cached", "llama_self_cache", "vallex_self_cache",
    "viola_self_cache")
FLASH_BIAS_DECODE_CASES = ("cross", "self", "lm_self")


def _flash_bias_record(case, dtype):
    """The decode-step kernel at one shape against its twin, timed back to
    back on the stream (``ms``) and as the card runs it (``graph_ms``), with
    SDPA (an f32 0/-1e9 mask, scale 1) on the same K/V as the yardstick,
    timed both ways.  "cross", "self" and "lm_self" call the contract entry
    on [N, T, D] rows, "cross_cached", "self_cache", "lm_self_cache",
    the "eval_", "large_", "sweep_", "sib_", "yit_" and "vat_" cases,
    "tts_self", "tts_cross", "vc_cross" and "llama_self_cache" the
    cached entry on the decoder's layouts; "tts_cross" and "vc_cross" with
    the max-probability output, held against the twin's (f32 1e-4, bf16
    3e-2 of max |ref|) and timed with and without it.  The "wavlm_" cases
    call the contract entry with their f32 bias, which SDPA's mask then
    carries.  "path" names the kernel that served the call
    (``K.flash_bias_path``: the cached entry always "split"); the call must
    be one launch of that kernel."""
    maxp_call = None
    bias = None
    if case in FLASH_BIAS_CACHED_CASES:
        q4, k4, v4, key_valid, rows = flash_bias_cache_case(case, dtype)
        B, Tq, H, D = q4.shape
        N, Tk = B * H, k4.shape[1]
        call = lambda: K.flash_attention_bias_cached(q4, k4, v4, key_valid, rows)
        plain = lambda: K.flash_attention_bias_cached_plain(q4, k4, v4, key_valid, rows)
        path = "split"
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
        q, k, v, key_valid, bias = flash_bias_case(case, dtype)
        N, Tq, D = q.shape
        B, H, Tk, rows = N, 1, k.shape[1], None
        call = lambda: K.flash_attention_bias(q, k, v, bias, key_valid)
        plain = lambda: K.flash_attention_bias_plain(q, k, v, bias, key_valid)
        path = K.flash_bias_path(Tq, Tk, D, dtype)
    before = K.launch_counts()
    got = call()
    after = K.launch_counts()
    ref = plain()
    torch.cuda.synchronize()
    err, tol, ok = _check(dtype, got, ref)
    ok = ok and torch.equal(got, call())       # two calls, the same bits
    launched = {n: after[n] - before[n]
                for n in ("flash_attention_bias", "flash_attention_bias_tiled")}
    ok = ok and launched == {"flash_attention_bias": 1,
                             "flash_attention_bias_tiled": int(path == "tiled")}
    # what the function needs: q and out, the K and V of the valid keys
    # (an invalid key's weight is exp(-1e9 - m) = 0 once a row has a valid
    # key, so its K and V are never needed), each distinct (physical row,
    # position, head) once however many beams share it through the row
    # map, the mask, the row map's entries of the valid keys and the bias
    # of the valid keys; a row with no valid key needs only its V (the
    # mean); flops: q.k and p.v over the valid keys of every row, p.v over
    # every key of a row with none
    full_mask = key_valid.repeat_interleave(N // key_valid.shape[0], 0)
    empty_rows = int((~full_mask.any(1)).sum().item())
    valid_keys = full_mask.sum().item()
    phys = (torch.arange(B, device=q.device)[:, None].expand(B, Tk)
            if rows is None else rows)
    kv_index = ((phys * Tk + torch.arange(Tk, device=q.device))[:, None, :] * H
                + torch.arange(H, device=q.device)[None, :, None])
    kv_keys = torch.unique(kv_index[full_mask.view(B, H, Tk)]).numel()
    nbytes = ((2 * N * Tq * D + 2 * D * kv_keys + D * Tk * empty_rows) * q.element_size()
              + key_valid.numel() + (0 if bias is None else Tq * valid_keys * 4))
    if rows is not None:
        nbytes += key_valid.sum().item() * B * rows.element_size()
    flops = 4.0 * Tq * D * valid_keys + 2.0 * Tq * D * Tk * empty_rows
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    mask = torch.where(full_mask[:, None, :], 0.0, K.NEG_INF).expand(N, Tq, Tk)
    library_call = "F.scaled_dot_product_attention(attn_mask=f32 0/-1e9, scale=1)"
    if bias is not None:
        mask = mask + bias
        library_call = "F.scaled_dot_product_attention(attn_mask=f32 bias + 0/-1e9, scale=1)"
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
        "bound_share_graph": bound_ms / graph, "path": path,
        "shape": {"N": N, "Tq": Tq, "Tk": Tk, "D": D,
                  "valid_keys": int(key_valid[0].sum().item()),
                  "valid_keys_by_mask_row": key_valid.sum(1).tolist(),
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
    "<dtype>/eval_self_cache", "<dtype>/eval_lm_self_cache", D 16).  The
    parity sweep's batch of 4 clips of 4000 samples: the inference attention
    ("bfloat16/sweep_b4", T 12), the conv stack ("bfloat16/b4_T799") and
    its beam's decode steps ("<dtype>/sweep_cross_cached",
    "<dtype>/sweep_self_cache").  The sibling families: the inference
    attention at T 549 ("bfloat16/slm_T549"), the train kernels at N 48, T
    512 and 149 ("bfloat16/r0.1/b4_T512", "bfloat16/r0.1/b4_T149"), the
    conv stack at batch 4 on 16 s ("bfloat16/b4") and the 3 s beam's cross
    step ("<dtype>/sib_cross_cached").  YiTrans and VATLM: the inference
    attention at the MT source's T 61 and the AVSR request's T 75
    ("bfloat16/yit_mt_T61", "bfloat16/vat_T75"), the train kernels at N 48,
    T 258 (stage 1's text) and T 100 (VATLM's 4 s clips)
    ("bfloat16/r0.1/b4_T258", "bfloat16/r0.1/b4_T100"), and the two beams'
    cross steps ("<dtype>/yit_mt_cross_cached", "<dtype>/vat_cross_cached").
    WavLLM: the decode-step kernel as WavLM's self-attention at T 499 and
    1499 with its f32 bias ("<dtype>/wavlm_T499", "<dtype>/wavlm_T1499";
    bf16 on the tiled kernel) and as the LLaMA step of the 30 s beam
    ("<dtype>/llama_self_cache"), and the conv stack on the 30 s request
    ("bfloat16/b1_T95999").  The tiled kernel's edge cases, bf16
    (``WAVLM_TILED_CASES``): the padded batch of two at T 1499, T 77 and a
    sample with no valid frame.  Each "flash_attention_bias" record names
    its kernel ("path") and is filed under that kernel's name."""
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
    ok, rec = _attention_record(SWEEP_BATCH, torch.bfloat16, T=SWEEP_FRAMES, valid=SWEEP_FRAMES)
    records["banded_flash_attention"]["bfloat16/sweep_b4"] = rec
    if not ok:
        failures.append(f"banded_flash_attention sweep_b4: max|diff| "
                        f"{rec['max_abs_err']} > {rec['tolerance']}")
    ok, rec = _conv_record(SWEEP_BATCH, torch.bfloat16, T=SWEEP_CONV_T)
    records["conv_stack"][f"bfloat16/b4_T{SWEEP_CONV_T}"] = rec
    if not ok:
        failures.append(f"conv_stack b4 T{SWEEP_CONV_T}: max|diff| {rec['max_abs_err']} "
                        f"> {rec['tolerance']}")
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
    # the sibling families (phases 31-33): SpeechLM's 11 s CTC request, the
    # unit encoder on a batch of 4 mono-unit rows (T 512) and the CTC
    # recipe's 3 s utterances (T 149), the speech batch of 4 at 16 s
    ok, rec = _attention_record(1, torch.bfloat16, T=SIB_CTC_T, valid=SIB_CTC_T)
    records["banded_flash_attention"][f"bfloat16/slm_T{SIB_CTC_T}"] = rec
    if not ok:
        failures.append(f"banded_flash_attention slm_T{SIB_CTC_T}: max|diff| "
                        f"{rec['max_abs_err']} > {rec['tolerance']}")
    for T in (SIB_MONO_UNITS[1], SIB_RECIPE_T):
        key = f"bfloat16/r0.1/b4_T{T}"
        ok, recs = _train_records(torch.bfloat16, 0.1, batch=SIB_BATCH, T=T)
        for name, rec in recs.items():
            records[name][key] = rec
        if not ok:
            failures.append(f"train kernels {key}: "
                            + json.dumps({n: r["errors"] for n, r in recs.items()}))
    ok, rec = _conv_record(SIB_BATCH, torch.bfloat16)
    records["conv_stack"]["bfloat16/b4"] = rec
    if not ok:
        failures.append(f"conv_stack b4: max|diff| {rec['max_abs_err']} > {rec['tolerance']}")
    torch.cuda.empty_cache()
    # YiTrans and VATLM (phases 35-36): the MT beam's 61-token source and
    # the AVSR request's 75 frames through the inference attention; stage
    # 1's denoised text (4 rows of up to 258) and VATLM's 4 clips of up to
    # 100 frames through the train kernels
    for key, T in ((f"yit_mt_T{YIT_MT_T}", YIT_MT_T), (f"vat_T{VAT_BEAM_T}", VAT_BEAM_T)):
        ok, rec = _attention_record(1, torch.bfloat16, T=T, valid=T)
        records["banded_flash_attention"][f"bfloat16/{key}"] = rec
        if not ok:
            failures.append(f"banded_flash_attention {key}: max|diff| "
                            f"{rec['max_abs_err']} > {rec['tolerance']}")
    for T in (YIT_TEXT_TOKENS[1] + 2, VAT_TRAIN_T):
        key = f"bfloat16/r0.1/b4_T{T}"
        ok, recs = _train_records(torch.bfloat16, 0.1, batch=SIB_BATCH, T=T)
        for name, rec in recs.items():
            records[name][key] = rec
        if not ok:
            failures.append(f"train kernels {key}: "
                            + json.dumps({n: r["errors"] for n, r in recs.items()}))
    torch.cuda.empty_cache()
    # WavLLM (phase 38): WavLM's extractor on the 30 s request (layers 1-6
    # after conv 0)
    ok, rec = _conv_record(1, torch.bfloat16, T=WAVLM_CONV_T)
    records["conv_stack"][f"bfloat16/b1_T{WAVLM_CONV_T}"] = rec
    if not ok:
        failures.append(f"conv_stack b1 T{WAVLM_CONV_T}: max|diff| {rec['max_abs_err']} "
                        f"> {rec['tolerance']}")
    torch.cuda.empty_cache()
    for batch, samples, center in ((16, 767 * 256 + 1024, False), (2, 48000, True)):
        ok, rec = _mel_record(batch, samples, center)
        records["fused_log_mel"][f"float32/b{batch}"] = rec
        if not ok:
            failures.append(f"fused_log_mel b{batch}: max|diff| {rec['max_abs_err']} "
                            f"> {rec['tolerance']}")
    for case in (*FLASH_BIAS_DECODE_CASES, *FLASH_BIAS_CACHED_CASES,
                 *(f"wavlm_T{t}" for t in WAVLM_T), *WAVLM_TILED_CASES):
        # the tiled kernel's edge cases in its dtype alone
        dtypes = ((torch.bfloat16,) if case in WAVLM_TILED_CASES
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            key = f"{str(dtype).split('.')[-1]}/{case}"
            ok, rec = _flash_bias_record(case, dtype)
            name = ("flash_attention_bias_tiled" if rec["path"] == "tiled"
                    else "flash_attention_bias")
            records[name][key] = rec
            if not ok:
                failures.append(f"{name} {key}: max|diff| "
                                f"{rec['max_abs_err']} (tolerance {rec['tolerance']}), "
                                "or two calls differ, or not one launch of its path")
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
    model = init_model(cfg, card_generator(device, seed), device)
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
    model_k = init_model(cfg_k, card_generator(device, seed), device)
    model_t = init_model(cfg_t, card_generator(device, seed + 1), device)
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
    model = init_model(cfg, card_generator(device, seed), device)
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


def beam_device_launches(svc, wav, max_steps=PROFILED_STEPS,
                         short_steps=PROFILED_SHORT_STEPS) -> dict:
    """Every launch the card runs for one beam request cut at ``max_steps``
    decode steps (kernels, copies and fills, from ``torch.profiler``'s
    device events), and again cut at ``short_steps``: ``per_step`` is the
    difference over the steps between, so the encoder's few hundred
    launches a chunk, in both, stay out of it (``fixed_launches``: the
    long cut's launches less its steps').  Only the device is traced:
    reading a 200-step request's host events as well took ~50 s, its device
    events alone ~15 s."""
    from torch.profiler import ProfilerActivity, profile

    def count(cut):
        steps0, full = svc.asr.steps_run, svc.asr.max_len
        torch.cuda.synchronize()
        svc.asr.max_len = cut
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:   # device events only
                svc.transcribe(wav)
                torch.cuda.synchronize()
        finally:
            svc.asr.max_len = full
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
        return n, svc.asr.steps_run - steps0

    t0 = time.perf_counter()
    (n, steps), (n_short, steps_short) = count(max_steps), count(short_steps)
    per_step = (n - n_short) / (steps - steps_short) if steps > steps_short else None
    return {"device_launches": n, "decode_steps": steps, "per_step": per_step,
            "fixed_launches": None if per_step is None else n - per_step * steps,
            "short_cut": {"device_launches": n_short, "decode_steps": steps_short},
            "profile_s": time.perf_counter() - t0}


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
    model_k = init_model(cfg_k, card_generator(device, seed), device)
    model_t = init_model(cfg_t, card_generator(device, seed + 1), device)
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


# ------------------------------------------------------------------ FLAC

FLAC_BLOCK = 4096
FLAC_SAMPLE_SIZE_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def _crc_table(poly: int, width: int) -> np.ndarray:
    """The byte table of a CRC of ``width`` bits, MSB first, no reflection."""
    top, mask, table = 1 << (width - 1), (1 << width) - 1, []
    for b in range(256):
        c = b << (width - 8)
        for _ in range(8):
            c = (c << 1) ^ poly if c & top else c << 1
        table.append(c & mask)
    return np.asarray(table, np.int64)


CRC8 = _crc_table(0x07, 8)          # FLAC frame header
CRC16 = _crc_table(0x8005, 16)      # FLAC frame


def _crc16_frames(frames) -> np.ndarray:
    """CRC-16 of each byte string, all at once: with init 0 a leading zero
    byte leaves a CRC unchanged, so the frames are left-padded to one
    length and stepped together."""
    n = max(len(f) for f in frames)
    cols = np.zeros((n, len(frames)), np.int64)
    for i, f in enumerate(frames):
        cols[n - len(f):, i] = np.frombuffer(f, np.uint8)
    crc = np.zeros(len(frames), np.int64)
    for col in cols:
        crc = ((crc << 8) & 0xFFFF) ^ CRC16[(crc >> 8) ^ col]
    return crc


def _pack(fields) -> bytes:
    """[(values, widths)] -> the bits of each value, its width of them MSB
    first, in order, zero-padded to a byte (a value and its width each a
    number or an array).  Whole-byte widths take a byte path."""
    pairs = [np.broadcast_arrays(np.atleast_1d(np.asarray(v, np.int64)),
                                 np.asarray(w, np.int64)) for v, w in fields]
    if all(np.ndim(w) == 0 and w % 8 == 0 for _, w in fields):
        out = []
        for v, w in pairs:
            nb = int(w[0]) // 8
            out.append(np.stack([(v >> (8 * (nb - 1 - i))) & 0xFF for i in range(nb)],
                                1).astype(np.uint8).tobytes())
        return b"".join(out)
    vals = np.concatenate([v for v, _ in pairs])
    widths = np.concatenate([w for _, w in pairs])
    field = np.repeat(np.arange(len(widths)), widths)
    start = np.cumsum(widths) - widths
    shift = widths[field] - 1 - (np.arange(len(field)) - start[field])
    bits = (vals[field] >> np.minimum(shift, 62)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def _utf8_number(v: int) -> bytes:
    """FLAC's UTF-8-style coding of a frame number (up to 36 bits)."""
    if v < 0x80:
        return bytes([v])
    n = next(n for n in range(2, 8) if v < 1 << (5 * n + 1))
    out = [0x80 | ((v >> (6 * i)) & 0x3F) for i in range(n - 1)][::-1]
    return bytes([((0xFF << (8 - n)) & 0xFF) | (v >> (6 * (n - 1)))] + out)


def _rice_fields(residual: np.ndarray):
    """One partition of Rice-coded ``residual``: the coding method (4-bit
    parameters, or 5-bit ones where the best parameter passes 14), the
    partition order 0, the parameter that makes the fewest bits, then each
    value zigzagged, as a unary quotient and the parameter's low bits."""
    u = np.where(residual >= 0, 2 * residual, -2 * residual - 1).astype(np.int64)
    k = int(np.argmin([(u >> k).sum() + len(u) * (k + 1) for k in range(31)]))
    method = 0 if k < 15 else 1
    codes = np.stack([np.ones_like(u), u & ((1 << k) - 1)], 1).ravel()
    widths = np.stack([(u >> k) + 1, np.full_like(u, k)], 1).ravel()
    return [(method, 2), (0, 4), (k, 4 + method), (codes, widths)]


def _subframe_fields(x: np.ndarray, bps: int, order):
    """CONSTANT where the block holds one value; else VERBATIM (``order``
    None) or FIXED of ``order`` (0-4: the order-th difference, Rice coded)."""
    if (x == x[0]).all():
        return [(0x00, 8), (x[:1], bps)]
    if order is None:
        return [(0x02, 8), (x, bps)]
    return [((8 + order) << 1, 8), (x[:order], bps)] + _rice_fields(np.diff(x, n=order))


def write_flac(path: str, samples: np.ndarray, sr: int, bps: int = 16, order=None,
               block: int = FLAC_BLOCK, total_samples: bool = True) -> bytes:
    """Encode integer ``samples`` ([n] mono or [n, channels], each within
    ``bps`` signed bits) as a FLAC file: STREAMINFO with the samples' MD5
    (0 total samples when not ``total_samples``), then fixed-size frames of
    independent channels with their CRC-8 and CRC-16, each subframe
    CONSTANT, VERBATIM or FIXED (``_subframe_fields``).  Returns the MD5
    (of the interleaved samples as little-endian whole bytes)."""
    x = np.asarray(samples, np.int64)
    x = x[:, None] if x.ndim == 1 else x
    n, ch = x.shape
    le = np.stack([(x >> (8 * b)) & 0xFF for b in range(-(-bps // 8))], -1)
    md5 = hashlib.md5(le.astype(np.uint8).tobytes()).digest()
    bs = min(block, n)
    info = _pack([(bs, 16), (bs, 16), (0, 24), (0, 24), (sr, 20), (ch - 1, 3),
                  (bps - 1, 5), (n if total_samples else 0, 36)]) + md5
    frames = []
    for f, s0 in enumerate(range(0, n, block)):
        blk = x[s0:s0 + block]
        head = (bytes([0xFF, 0xF8, (7 << 4) | 0, ((ch - 1) << 4)
                       | (FLAC_SAMPLE_SIZE_CODE.get(bps, 0) << 1)])
                + _utf8_number(f) + _pack([(len(blk) - 1, 16)]))
        crc8 = 0
        for b in head:
            crc8 = int(CRC8[crc8 ^ b])
        frames.append(head + bytes([crc8]) + _pack(
            [fl for c in range(ch) for fl in _subframe_fields(blk[:, c], bps, order)]))
    crcs = _crc16_frames(frames)
    with open(path, "wb") as fh:
        fh.write(b"fLaC" + bytes([0x80, 0, 0, len(info)]) + info)
        for fr, crc in zip(frames, crcs):
            fh.write(fr + int(crc).to_bytes(2, "big"))
    return md5


def write_flac_corpus(directory: str, n: int, seconds=(8.0, 16.0), seed: int = 0,
                      resampled_every: int = 2):
    """``write_corpus``'s ``n`` utterances and transcripts as a recipe's raw
    data, made ready by ``cli/prep.py``: utterance i is 48 kHz FLAC under
    ``raw48k/`` when i % ``resampled_every`` == 1, else 16 kHz FLAC under
    ``audio/`` (the default: the even ones 16 kHz, the odd ones 48 kHz); the 48 kHz ones
    ``prep resample --sr 16000`` turns into 16 kHz WAV under ``audio/``;
    each starts with one block of silence (a CONSTANT subframe, the rest
    VERBATIM); ``prep manifest --ext .wav .flac`` lists ``audio/``, and
    ``prep wrd2ltr`` turns the word transcripts, in the manifest's order,
    into letter labels.  Every row's length is checked against its decoded
    audio.  -> (manifest, labels, dictionary, {seconds of each step})."""
    from speecht5_tpu_torch.cli import prep
    from speecht5_tpu_torch.data.audio import read_audio

    rng = np.random.default_rng(seed)
    letters = [chr(ord("A") + i) for i in range(26)]
    audio, raw = os.path.join(directory, "audio"), os.path.join(directory, "raw48k")
    os.makedirs(audio)
    os.makedirs(raw)
    secs_of = {}
    t0 = time.perf_counter()
    words = {}
    for i in range(n):
        secs = float(rng.uniform(*seconds))
        sr = 3 * SR if i % resampled_every == 1 else SR
        wav = synth_audio(secs, seed=seed + 1000 + i, sr=sr)
        wav[:FLAC_BLOCK] = 0.0
        pcm = np.clip(np.round(wav * 32767.0), -32768, 32767).astype(np.int64)
        write_flac(os.path.join(audio if sr == SR else raw, f"utt{i}.flac"), pcm, sr)
        words[f"utt{i}"] = " ".join("".join(rng.choice(letters, int(rng.integers(2, 8))))
                                    for _ in range(max(1, int(secs * 2.5))))
    secs_of["write_flac"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep.main(["resample", "--input", raw, "--output", audio, "--sr", str(SR)])
    secs_of["resample"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    manifest = os.path.join(directory, "train.tsv")
    prep.main(["manifest", "--audio-root", audio, "--out", manifest, "--ext", ".wav", ".flac"])
    with open(manifest, encoding="utf-8") as f:
        rows = [l.split("\t") for l in f.read().splitlines()[1:]]
    wrd, labels = os.path.join(directory, "train.wrd"), os.path.join(directory, "train.ltr")
    with open(wrd, "w", encoding="utf-8") as f:
        f.write("".join(words[os.path.splitext(r)[0]] + "\n" for r, _ in rows))
    prep.main(["wrd2ltr", "--input", wrd, "--output", labels])
    secs_of["manifest_wrd2ltr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kinds = sorted(os.path.splitext(r)[1] for r, _ in rows)
    n48 = sum(1 for i in range(n) if i % resampled_every == 1)
    if kinds != [".flac"] * (n - n48) + [".wav"] * n48:
        raise AssertionError(f"manifest rows {rows}")
    for r, size in rows:
        wav, sr = read_audio(os.path.join(audio, r))
        if sr != SR or len(wav) != int(size) or not np.isfinite(wav).all():
            raise AssertionError(f"{r}: {sr} Hz, {len(wav)} samples, manifest {size}")
    secs_of["decode_check"] = time.perf_counter() - t0
    return manifest, labels, write_dictionary(directory), secs_of


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
    run's arguments ("args").  The corpus is FLAC, made ready by
    ``cli/prep.py`` (``write_flac_corpus``); each update's
    ``s2t_train_flops`` and its MFU against the bf16 peak are logged."""
    manifest, labels, dict_path, prep = write_flac_corpus(work_dir, n_utts, seconds, seed,
                                                          RESAMPLED_EVERY)
    args = ["--task", "s2t", "--arch", arch, "--manifest", manifest,
            "--labels", labels, "--dict", dict_path,
            "--save-dir", os.path.join(work_dir, "ckpt"), *flags, "--keep-last", "1",
            "--log-interval", "1", "--seed", str(seed + 1), "--device", device]
    for ov in TRAIN_OVERRIDES:
        args += ["--override", ov]
    result = train_and_resume(args, os.path.join(work_dir, "ckpt"), updates, device, "s2t")
    result["prep"] = prep
    result["mfu"] = train_mfu(getattr(C, arch)(**DICT_CFG), result, device)
    log(json.dumps({"phase": "train", **result}))
    log(json.dumps({"phase": "train_mfu", **result["mfu"]}))
    return {**result, "args": args}


def train_mfu(cfg, result, device) -> dict:
    """``utils/flops.s2t_train_flops`` of each update of the first run (its
    micro-batches' padded shapes: batch, waveform samples, target tokens)
    and, on the card, the MFU of its wall time against
    ``flops.chip_peak_flops()`` (989e12: one H100 SXM, dense bf16) beside
    the card's name and power limit."""
    from speecht5_tpu_torch.utils import flops

    per = [sum(flops.s2t_train_flops(cfg, mb["wav"][0], mb["wav"][1], mb["targets"][1])
               for mb in micro) for micro in result["update_shapes"]]
    if torch.device(device).type != "cuda":
        return {"update_flops": per, "mfu": "not measured (no card)"}
    return {"update_flops": per, "update_ms": result["update_ms"],
            "peak_flops": flops.chip_peak_flops(),
            "mfu": [flops.mfu(f, ms / 1e3) for f, ms in zip(per, result["update_ms"])],
            "card": card_line()}


def train_and_resume(args, save_dir, updates, device, what, accum=1):
    """``cli/train.main(args)`` for ``updates`` updates, the launch counts
    zeroed just before and read just after and each update timed, then a
    resume that takes one more, keeping only the newest checkpoint.  Fails
    unless both runs reach their steps with finite metrics.  -> {"counts",
    "layer_runs" (training forwards of encoder layers), "micro_batches",
    "wall_s", "update_ms", "update_shapes" (each update's micro-batches'
    tensor shapes), "history" (both runs), "metrics" (the first update's
    names)}."""
    _sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    timer = _UpdateTimes(device)
    with _LayerRuns() as runs, timer as update_ms:
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
            "wall_s": wall, "update_ms": update_ms, "update_shapes": timer.shapes,
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
        model = init_model(cfg, card_generator(device, seed + 7), device)
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
    micro-batch), ending in a synchronize on the card; a list.  ``shapes``:
    each update's micro-batches as {key: tensor shape}."""

    def __init__(self, device):
        self.device, self.times, self.shapes = device, [], []

    def __enter__(self):
        self.real = Trainer.train_step
        real, times, device = self.real, self.times, self.device

        def timed(trainer, micro, *task):
            self.shapes.append([{k: tuple(v.shape) for k, v in mb.items()
                                 if isinstance(v, torch.Tensor)} for mb in micro])
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


class _DecodeTimes:
    """Each ``ASRDecoder`` call: its wall ms (ending in a synchronize on the
    card), batch, waveform samples, decode steps, models and beam; a
    list."""

    def __init__(self, device):
        self.device, self.calls = device, []

    def __enter__(self):
        from speecht5_tpu_torch.decode.asr import ASRDecoder

        self.cls, self.real = ASRDecoder, ASRDecoder.__call__
        real, calls, device = self.real, self.calls, self.device

        def timed(dec, *args):
            _sync(device)
            t0, before = time.perf_counter(), dec.steps_run
            out = real(dec, *args)
            _sync(device)
            calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "batch": int(args[0].shape[0]), "samples": int(args[0].shape[1]),
                          "steps": dec.steps_run - before, "models": len(dec.models),
                          "beam": dec.beam_size})
            return out

        ASRDecoder.__call__ = timed
        return self.calls

    def __exit__(self, *exc):
        self.cls.__call__ = self.real


def decode_mfu(cfg, calls, device) -> dict:
    """``utils/flops.asr_decode_flops`` of each beam call (per model of an
    ensemble; a fusion LM's work is not counted) and, on the card, its MFU
    against the bf16 peak beside the card's name and power limit."""
    from speecht5_tpu_torch.utils import flops

    per = [c["models"] * flops.asr_decode_flops(cfg, c["batch"], c["beam"], c["samples"],
                                                c["steps"]) for c in calls]
    if torch.device(device).type != "cuda":
        return {"calls": calls, "decode_flops": per, "mfu": "not measured (no card)"}
    return {"calls": calls, "decode_flops": per, "peak_flops": flops.chip_peak_flops(),
            "mfu": [flops.mfu(f, c["ms"] / 1e3) for f, c in zip(per, calls)],
            "card": card_line()}


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
    model = init_model(cfg, card_generator(device, seed), device)
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
        out["device_launches"] = tts_device_launches(services[0][1], texts[0])
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
    share of the profiled wall and the largest device times by name.  Only
    the device is traced (as ``beam_device_launches``)."""
    from torch.profiler import ProfilerActivity, profile

    steps0 = steps_run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # device events only
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    steps = steps_run() - steps0
    t0 = time.perf_counter()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    read_s = time.perf_counter() - t0
    busy = _union_ms([(e.time_range.start, e.time_range.end) for e in events])
    by_name = {}     # summed under the name's first 60 characters
    for e in events:
        key = e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_launches": len(events), "decode_steps": steps,
            "per_step": len(events) / steps if steps else None, "device_busy_ms": busy,
            "wall_ms_profiled": wall, "idle_share": 1.0 - busy / wall,
            "top_device_ms": {n: round(t, 3) for n, t in top}, "trace_read_s": read_s}


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
    clf = SIDClassifier(init_model(cfg, card_generator(device, seed), device), device)
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
    model = init_model(cfg, card_generator(device, seed), device)
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
    model_k = init_model(cfgs[0], card_generator(device, seed), device)
    model_t = init_model(cfgs[1], card_generator(device, seed + 1), device)
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
    model = init_model(cfg, card_generator(device, seed), device)
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
    model_k = init_model(cfg_k, card_generator(device, seed), device)
    model_t = init_model(cfg_t, card_generator(device, seed + 1), device)
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
    with _DecodeTimes(device) as calls:
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
    log(json.dumps({"phase": "evaluate_mfu", **decode_mfu(cfg, calls, device)}))
    return result


# ---------------------------------------------------- parallel (29-30)


def _rank_entry(rank, world, store, backend, entry, argv, device, queue):
    """One spawned rank: ``cli/train.main`` or ``cli/evaluate.main`` with the
    ``--distributed-*`` flags, its launch counts zeroed just before and read
    just after, each train update timed; puts {"rank", "result", "counts",
    "update_ms"} (or {"rank", "error"}) on ``queue``."""
    import traceback

    faulthandler.enable()
    faulthandler.dump_traceback_later(PARALLEL_RANK_S, exit=True)
    # the numerics of main()'s process: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from speecht5_tpu_torch.cli import evaluate

        flags = ["--distributed-num-processes", str(world), "--distributed-process-id",
                 str(rank), "--distributed-coordinator", f"file://{store}",
                 "--distributed-platform", backend]
        if entry == "evaluate":
            flags = ["--data-parallel"] + flags
        _sync(device)
        K.reset_launch_counts()
        with _UpdateTimes(device) as update_ms:
            result = (cli_train.main if entry == "train" else evaluate.main)(argv + flags)
        _sync(device)
        if entry == "train":
            result = {k: result[k] for k in ("steps", "history", "final_loss")}
        queue.put({"rank": rank, "result": result, "counts": K.launch_counts(),
                   "update_ms": update_ms})
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


class Ranks:
    """``world`` spawned ranks of ``entry`` ("train" / "evaluate") on
    ``argv``, meeting through a file store in a temporary directory, gloo
    on loopback: ``start`` them, then ``wait`` for every rank's message
    (in rank order); all are killed when one fails or the time runs out.
    ``env``: the children's environment (this process's when None)."""

    def __init__(self, entry, argv, world, backend, device="cuda", env=None,
                 timeout=PARALLEL_RANK_S):
        self.entry, self.argv, self.world, self.backend = entry, argv, world, backend
        self.device, self.env, self.timeout = device, env, timeout

    def start(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.queue, self.dir = ctx.Queue(), tempfile.mkdtemp()
        saved = dict(os.environ)
        try:
            os.environ.clear()
            os.environ.update({**(saved if self.env is None else self.env),
                               "GLOO_SOCKET_IFNAME": "lo"})
            self.procs = [ctx.Process(target=_rank_entry, args=(
                r, self.world, os.path.join(self.dir, "store"), self.backend, self.entry,
                self.argv, self.device, self.queue)) for r in range(self.world)]
            for p in self.procs:
                p.start()
        finally:
            os.environ.clear()
            os.environ.update(saved)
        self.deadline = time.perf_counter() + self.timeout
        return self

    def wait(self) -> list:
        import queue as queue_mod

        msgs = {}
        try:
            while len(msgs) < self.world:
                try:
                    m = self.queue.get(timeout=5)
                except queue_mod.Empty:
                    dead = [p.exitcode for p in self.procs if p.exitcode not in (None, 0)]
                    if dead or time.perf_counter() > self.deadline:
                        raise AssertionError(f"{self.entry} ranks: exit codes {dead}, "
                                             f"{len(msgs)} of {self.world} reported")
                    continue
                if "error" in m:
                    raise AssertionError(f"{self.entry} rank {m['rank']} failed:\n"
                                         f"{m['error']}")
                msgs[m["rank"]] = m
            for p in self.procs:
                p.join(timeout=60)
            codes = [p.exitcode for p in self.procs]
            if codes != [0] * self.world:
                raise AssertionError(f"{self.entry} ranks exited {codes}")
        finally:
            self.kill()
        return [msgs[r] for r in range(self.world)]

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def run_ranks(entry, argv, world, backend, device="cuda", env=None):
    """``Ranks(...)`` started and waited for."""
    return Ranks(entry, argv, world, backend, device, env).start().wait()


def parallel_train_args(work_dir, arch="speecht5_base_asr", device="cuda", n_utts=PARALLEL_BATCH,
                        seconds=PARALLEL_SECONDS, seed=0):
    """Phase 29's corpus in ``work_dir`` and ``cli/train.py``'s arguments:
    s2t, f32, the kernel route, every stochastic part off, one global batch
    of ``n_utts`` an update, a fixed seed (the save dir appended by the
    caller)."""
    manifest, labels, dict_path = write_corpus(work_dir, n_utts, seconds, seed + 29)
    args = ["--task", "s2t", "--arch", arch, "--manifest", manifest, "--labels", labels,
            "--dict", dict_path, "--batch-size", str(n_utts), "--ctc-weight", "0.5",
            "--dtype", "float32", "--log-interval", "1", "--keep-last", "1",
            "--seed", str(seed + 1), "--device", device, "--mask-prob", "0"]
    for ov in DETERMINISTIC + TRAIN_OVERRIDES:
        args += ["--override", ov]
    return args


def phase_parallel_train(device="cuda", arch="speecht5_base_asr", updates=3,
                         modes=PARALLEL_MODES, n_utts=PARALLEL_BATCH,
                         seconds=PARALLEL_SECONDS, seed=0, env=None):
    """Phase 29: the one-process run, then each mode of ``modes`` as spawned
    ranks (``run_ranks``; ``env`` their environment).  Every rank's losses
    within ``PARALLEL_TOL`` of the one-process run's; on a card the train
    attention and conv kernels launch on every rank.  -> {"one", "modes":
    {name: {backend, world, mesh, losses, grad_norms, counts}}}."""
    on_card = torch.device(device).type == "cuda"
    out = {"card": card_line() if on_card else "cpu", "modes": {}}
    with tempfile.TemporaryDirectory() as d:
        args = parallel_train_args(d, arch, device, n_utts, seconds, seed)
        _sync(device)
        K.reset_launch_counts()
        one = cli_train.main(args + ["--save-dir", os.path.join(d, "one"),
                                     "--max-updates", str(updates)])
        _sync(device)
        ref = [r["loss"] for r in one["history"]]
        out["one"] = {"losses": ref, "grad_norms": [r["grad_norm"] for r in one["history"]],
                      "counts": K.launch_counts()}
        # every mode's ranks at once: they share the card, and the phase
        # checks values, not times
        runs = [Ranks("train", args + flags + ["--save-dir", os.path.join(d, name),
                                               "--max-updates", str(updates)],
                      world, backend, device, env) for name, world, backend, flags in modes]
        try:
            for r in runs:
                r.start()
            results = [r.wait() for r in runs]
        finally:
            for r in runs:
                if hasattr(r, "procs"):
                    r.kill()
        for (name, world, backend, flags), ranks in zip(modes, results):
            n_model = int(flags[flags.index("--n-model-shards") + 1]) if (
                "--n-model-shards" in flags) else 1
            rec = {"backend": backend, "world": world,
                   "mesh": {"data": world // n_model, "model": n_model},
                   "losses": [[h["loss"] for h in r["result"]["history"]] for r in ranks],
                   "grad_norms": [[h["grad_norm"] for h in r["result"]["history"]]
                                  for r in ranks],
                   "counts": [r["counts"] for r in ranks]}
            out["modes"][name] = rec
            log(json.dumps({"parallel_train": name, **rec}))
            for losses in rec["losses"]:
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
                if len(losses) != updates or not rel <= PARALLEL_TOL[name]:
                    raise AssertionError(f"parallel {name}: losses {losses} against the "
                                         f"one-process run's {ref}")
            missing = [n for c in rec["counts"] for n in TRAIN_KERNELS + ("conv_stack",)
                       if on_card and c[n] == 0]
            if missing:
                raise AssertionError(f"parallel {name}: a rank never launched {missing}")
    log(json.dumps({"phase": "parallel_train", "one": out["one"], "card": out["card"]}))
    return out


def phase_parallel_wrapper(train_args, work_dir, device="cuda", updates=2,
                           mode=PARALLEL_WRAPPER, env=None):
    """Phase 29's wrapper cost: ``updates`` updates of ``train_args`` (the
    train phase's recipe run, bf16) in this process and as ``mode`` (data
    parallelism at world size 1 over NCCL): each update's wall ms side by
    side, the card's name and power limit beside them."""
    name, world, backend, flags = mode
    one_dir, par_dir = os.path.join(work_dir, "wrap_one"), os.path.join(work_dir, "wrap_dp")
    with _UpdateTimes(device) as one_ms:
        one = cli_train.main(train_args + ["--save-dir", one_dir, "--max-updates",
                                           str(updates)])
    ranks = run_ranks("train", train_args + flags + ["--save-dir", par_dir, "--max-updates",
                                                     str(updates)], world, backend, device,
                      env)
    rec = {"mode": name, "backend": backend, "world": world,
           "update_ms_one_process": one_ms, "update_ms_wrapped": ranks[0]["update_ms"],
           "losses_one_process": [h["loss"] for h in one["history"]],
           "losses_wrapped": [h["loss"] for h in ranks[0]["result"]["history"]],
           "card": card_line() if torch.device(device).type == "cuda" else "cpu"}
    log(json.dumps({"phase": "parallel_wrapper", **rec}))
    shutil.rmtree(one_dir, ignore_errors=True)
    shutil.rmtree(par_dir, ignore_errors=True)
    return rec


def phase_parallel_evaluate(work_dir, device="cuda", arch="speecht5_base_asr", n_utts=8,
                            seconds=PARALLEL_EVAL_SECONDS, max_len=EVAL_MAX_LEN, seed=0,
                            dtype="bfloat16", world=2, env=None):
    """Phase 30: ``cli/evaluate.py --decoder beam --data-parallel`` over
    ``world`` gloo ranks on the checkpoint in ``work_dir``/ckpt and
    ``n_utts`` seeded clips of one length, batch ``n_utts``, against the
    one-process evaluate at batch ``n_utts // world``: hypotheses and WER
    equal; on a card the inference attention, conv and decode-step kernels
    launch on every rank."""
    d = os.path.join(work_dir, "parallel_evaluate")
    os.makedirs(d)
    manifest, labels, dict_path = write_corpus(d, n_utts, (seconds, seconds), seed + 30)
    common = ["--task", "s2t", "--arch", arch, "--manifest", manifest, "--labels", labels,
              "--dict", dict_path, "--ckpt", os.path.join(work_dir, "ckpt"),
              "--dtype", dtype, "--normalize", "--device", device, "--beam", str(BEAM),
              "--max-len", str(max_len), "--ctc-weight", "0.3",
              *[a for ov in BEAM_OVERRIDES for a in ("--override", ov)]]
    from speecht5_tpu_torch.cli import evaluate

    _sync(device)
    K.reset_launch_counts()
    one = evaluate.main(common + ["--batch-size", str(n_utts // world),
                                  "--results-path", os.path.join(d, "one")])
    _sync(device)
    one_counts = K.launch_counts()
    ranks = run_ranks("evaluate", common + ["--batch-size", str(n_utts), "--results-path",
                                            os.path.join(d, "dp")], world, "gloo", device, env)
    hyps = [open(os.path.join(d, p, "hyps.txt"), encoding="utf-8").read().splitlines()
            for p in ("one", "dp")]
    res = ranks[0]["result"]
    rec = {"world": world, "backend": "gloo", "wer_one_process": one["value"],
           "wer_data_parallel": res["value"], "n_utts": res["n_utts"],
           "hypotheses_equal": hyps[0] == hyps[1], "one_process_counts": one_counts,
           "counts": [r["counts"] for r in ranks],
           "wall_s": {"one_process": one["wall_s"], "data_parallel": res["wall_s"]},
           "card": card_line() if torch.device(device).type == "cuda" else "cpu"}
    log(json.dumps({"phase": "parallel_evaluate", **rec}))
    if not (rec["hypotheses_equal"] and res["value"] == one["value"]
            and len(hyps[1]) == n_utts):
        raise AssertionError(f"data-parallel evaluate differs: {hyps}")
    if torch.device(device).type == "cuda":
        missing = [n for c in rec["counts"] for n in
                   ("banded_flash_attention", "conv_stack", "flash_attention_bias")
                   if c[n] == 0]
        if missing:
            raise AssertionError(f"parallel evaluate: a rank never launched {missing}")
    return rec


def phase_parity_sweep(device="cuda", arch="speecht5_base_asr", dtype="bfloat16",
                       overrides=BEAM_OVERRIDES):
    """The checkpoint-day sweep as its dry run: ``cli/parity.py --dry-run
    --dry-run-arch <arch> --arms`` on ``device`` (``dtype``, every kernel on)
    in a temporary directory: random-init fixtures (SWEEP_*: 4 clips of
    4000 samples, the model saved model-only), the joint beam (beam 2,
    max_len 8, CTC weight 0.3), then CTC greedy and the rescore arm.  The
    row's WER ("ours") and both arms' must be finite.  -> {"counts" (its
    launches), "record", "wall_s"}."""
    from speecht5_tpu_torch.cli import parity

    with tempfile.TemporaryDirectory() as d:
        argv = ["--ckpt-dir", os.path.join(d, "ckpt"), "--data-dir", os.path.join(d, "data"),
                "--dry-run", "--dry-run-arch", arch, "--arms", "--device", device,
                "--dtype", dtype, "--batch-size", str(SWEEP_BATCH),
                *[a for ov in overrides for a in ("--override", ov)]]
        _sync(device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        records = parity.main(argv)
        _sync(device)
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    rec = records[0] if len(records) == 1 else {}
    wers = [rec.get("ours")] + [a.get("wer") for a in rec.get("arms", {}).values()]
    if (rec.get("status") != "report_only" or set(rec.get("arms", {}))
            != {"ctc_greedy", "ctc_rescore"}
            or not all(w is not None and math.isfinite(w) for w in wers)):
        raise AssertionError(f"parity sweep records: {records}")
    result = {"counts": counts, "record": rec, "wall_s": wall}
    log(json.dumps({"phase": "parity_sweep", **result}))
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
    ``text_lines`` lines of random letter words (fairseq .ltr tokens), raw
    (``text.txt``) and binarized (``text.bin/.idx``, ``binarize_text``).
    -> (manifest, km labels, raw text file, dictionary)."""
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
    binarize_text(text, dict_path)
    return manifest, km, text, dict_path


def binarize_text(text: str, dict_path: str) -> str:
    """Each non-empty line of ``text`` encoded by the dictionary (no EOS),
    written through the port's ``MMapIndexedDatasetWriter`` as fairseq's
    mmap ``<text without its suffix>.bin/.idx``; returns the ``.bin``
    path."""
    from speecht5_tpu_torch.data import binarized
    from speecht5_tpu_torch.data.dictionary import load_cli_dictionary

    dictionary, _ = load_cli_dictionary(dict_path)
    prefix = os.path.splitext(text)[0]
    w = binarized.MMapIndexedDatasetWriter(prefix, binarized.best_fitting_dtype(len(dictionary)))
    with open(text, encoding="utf-8") as f:
        for line in f:
            ids = dictionary.encode_line(line, append_eos=False) if line.strip() else []
            if len(ids):
                w.add_item(ids)
    w.finalize()
    return binarized.data_file(prefix)


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
    corpus read from its fairseq-binarized ``.bin/.idx`` (whose blocks must
    first equal those of the raw text): ``updates`` updates of both tasks,
    then a resume.  Checks: every metric finite; the log-mel kernel once
    per speech update, the train kernels once per encoder layer run (24 an
    update, speech or text), the conv, inference and decode-step kernels
    never.  Then ``large_update_profile``."""
    ovs = LARGE_TRAIN_OVERRIDES + list(overrides)
    cfg = large_config("bfloat16", ovs, arch)
    with tempfile.TemporaryDirectory() as d:
        manifest, km, raw, dict_path = write_pretrain_corpus(d, n_utts, seconds, seed=seed)
        text = os.path.splitext(raw)[0] + ".bin"
        speech_ds, text_ds = pretrain_datasets(cfg, manifest, km, text, dict_path)
        raw_blocks = pretrain_datasets(cfg, manifest, km, raw, dict_path)[1].blocks
        if not (len(text_ds.blocks) == len(raw_blocks) > 0 and all(
                np.array_equal(a, b) for a, b in zip(text_ds.blocks, raw_blocks))):
            raise AssertionError(f"binarized text blocks differ from the raw file's: "
                                 f"{len(text_ds.blocks)} / {len(raw_blocks)}")
        run_seed = mixed_seed(speech_ds, text_ds, updates)
        args = ["--task", "pretrain", "--arch", arch, "--manifest", manifest,
                "--labels", km, "--text-file", text, "--dict", dict_path,
                "--save-dir", os.path.join(d, "ckpt"), *PRETRAIN_FLAGS, "--keep-last", "1",
                "--log-interval", "1", "--seed", str(run_seed), "--device", device]
        for ov in ovs:
            args += ["--override", ov]
        result = train_and_resume(args, os.path.join(d, "ckpt"), updates, device, "pretrain")
    tasks = [next(iter(row)).split("/")[0] for row in result["history"]]
    speech = tasks[:updates].count("pretrain_speech")
    result.update(tasks=tasks, speech_updates=speech, run_seed=run_seed,
                  text_file=os.path.basename(text), text_blocks=len(raw_blocks))
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
    model = init_model(cfg, card_generator(device, seed), device)
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
    model = init_model(cfg, card_generator(device, seed), device).train()
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


# ------------------------------------------------------- sibling families

# phases 31-34: SpeechLM, SpeechUT and Speech2C at full width, then
# each family's kernel route against its plain route in f32
SLM_FLAGS = ["speech_encoder.use_pallas_attn=True",
             "speech_encoder.use_pallas_attn_train=True",
             "unit_encoder.use_pallas_attn=True", "unit_encoder.use_pallas_attn_train=True",
             "conv_features.impl='pallas'"]
SUT_FLAGS = SLM_FLAGS + ["decoder.use_pallas_attn=True"]
SPEECH2C_FLAGS = TRAIN_OVERRIDES + BEAM_OVERRIDES
SIB_BATCH, SIB_UPDATES = 4, 3
SIB_SPEECH_S = (8.0, 16.0)
SIB_MONO_UNITS = (256, 512)          # the mono-unit corpus' lengths (<= 1024 keys)
SIB_PAIRED_UNITS = (100, 250)        # paired units; their text about a fifth
SIB_REQUESTS_S = (3, 11)             # SpeechLM CTC requests
SIB_BEAM_S = 3                       # the SpeechUT / Speech2C beam's request
SIB_CTC_S = 3.0                      # the CTC recipe's utterances at Base
SIB_PARITY_MAX_LEN = 60              # the f32 parity beams (the served ones: 200)
SIB_CTC_T = C.ConvFeatureConfig().out_length(SIB_REQUESTS_S[1] * 16000)      # 549
SIB_RECIPE_T = C.ConvFeatureConfig().out_length(int(SIB_CTC_S * 16000))      # 149
# the tiny presets' sizes, for the CPU rehearsals
SIB_TINY = {"speech_s": (0.3, 0.6), "mono": (8, 16), "paired": (6, 12),
            "requests_s": (0.3, 0.5), "beam_s": 0.3, "max_len": 8, "ctc_s": 0.25,
            "batch": 2}


def _sib_sizes(tiny: bool) -> dict:
    if tiny:
        return SIB_TINY
    return {"speech_s": SIB_SPEECH_S, "mono": SIB_MONO_UNITS, "paired": SIB_PAIRED_UNITS,
            "requests_s": SIB_REQUESTS_S, "beam_s": SIB_BEAM_S, "max_len": BEAM_MAX_LEN,
            "ctc_s": SIB_CTC_S, "batch": SIB_BATCH}


def sibling_config(family: str, dtype: str, kernels: bool, tiny: bool = False,
                   overrides=()):
    """The family's Base preset (``tiny``: its tiny preset) at ``dtype``,
    its kernel flags on with ``kernels``."""
    base = {"speechlm": (speechlm_tiny, SpeechLMConfig),
            "speechut": (speechut_tiny, SpeechUTConfig),
            "speech2c": (lambda: C.speecht5_tiny(vocab_size=20),
                         speech2c_base),
            "yitrans": (yitrans_tiny, YiTransConfig),
            "vatlm": (vatlm_tiny, lambda: VATLMConfig(phone_vocab_size=VAT_PHONES)),
            }[family][0 if tiny else 1]()
    flags = {"speechlm": SLM_FLAGS, "speechut": SUT_FLAGS,
             "speech2c": SPEECH2C_FLAGS, "yitrans": YIT_FLAGS, "vatlm": VAT_FLAGS}[family]
    return C.apply_overrides(C.replace(base, dtype=dtype),
                             (flags if kernels else []) + list(overrides))


def sibling_still(family: str):
    """Every dropout and layerdrop of the family's stacks at 0 (parity)."""
    stacks = {"speechlm": ("speech_encoder", "unit_encoder"),
              "speechut": ("speech_encoder", "unit_encoder", "decoder"),
              "speech2c": ("encoder", "decoder"), "yitrans": ("encoder", "decoder"),
              "vatlm": ("encoder", "decoder")}[family]
    return [f"{s}.{f}=0.0" for s in stacks
            for f in ("dropout", "attention_dropout", "activation_dropout", "layerdrop")]


def sibling_loader(cfg, streams, sizes: dict, seed: int, device, batch: int):
    """A ``MultiCorpusLoader`` over seeded in-memory corpora of 3 batches
    each: "speech" (``speech_s`` seconds of synthetic audio, random km
    units at the frame rate), "text" / "text_mono" (``mono`` units, padded
    with pad_id at the end) and "text_paired" (``paired`` units and a text
    of about a fifth as many tokens with EOS, its EOS-shifted prev).  At
    most ``batch`` items a batch: every step has ``batch`` rows of each."""
    rng = np.random.default_rng(seed)
    n = 3 * batch
    V = cfg.unit_vocab_size
    corpora = {}
    if "speech" in streams:
        items = []
        for i in range(n):
            wav = synth_audio(float(rng.uniform(*sizes["speech_s"])), seed=700 + seed + i)
            items.append({"wav": wav, "units": rng.integers(
                0, V, cfg.conv_features.out_length(len(wav)))})
        corpora["speech"] = (items, [len(x["wav"]) for x in items])
    for name in ("text", "text_mono"):
        if name in streams:
            items = [rng.integers(2, V, int(rng.integers(*sizes["mono"]))) for _ in range(n)]
            corpora[name] = ([{"units": u} for u in items], [len(u) for u in items])
    if "text_paired" in streams:
        items = []
        for _ in range(n):
            u = rng.integers(2, V, int(rng.integers(*sizes["paired"])))
            text = rng.integers(5, cfg.text_vocab_size, max(len(u) // 5, 2))
            items.append({"units": u, "targets": np.append(text, cfg.eos_id)})
        corpora["text_paired"] = (items, [len(x["units"]) for x in items])

    def pad(rows, value):
        out = np.full((len(rows), max(len(r) for r in rows)), value, np.int64)
        for b, r in enumerate(rows):
            out[b, : len(r)] = r
        return torch.from_numpy(out).to(device)

    def collate_speech(items):
        T = bucket_length(max(len(x["wav"]) for x in items), AUDIO_BUCKETS)
        wav = np.zeros((len(items), T), np.float32)
        for b, x in enumerate(items):
            wav[b, : len(x["wav"])] = x["wav"]
        units = np.zeros((len(items), cfg.conv_features.out_length(T)), np.int64)
        for b, x in enumerate(items):
            units[b, : len(x["units"])] = x["units"]
        return {"wav": torch.from_numpy(wav).to(device),
                "wav_lengths": torch.tensor([len(x["wav"]) for x in items], dtype=torch.int32),
                "units": torch.from_numpy(units).to(device)}

    def collate_units(items):
        return {"units": pad([x["units"] for x in items], cfg.pad_id)}

    def collate_paired(items):
        tgt = pad([x["targets"] for x in items], cfg.pad_id)
        prev = torch.cat([torch.full_like(tgt[:, :1], cfg.eos_id), tgt[:, :-1]], 1)
        return {"units": pad([x["units"] for x in items], cfg.pad_id),
                "prev_tokens": prev, "targets": tgt}

    collate = {"speech": collate_speech, "text": collate_units, "text_mono": collate_units,
               "text_paired": collate_paired}
    total = sum(len(items) for items, _ in corpora.values())
    specs = [TokenCorpusSpec(name, items, collate[name], sizes_,
                             sample_ratio=len(items) / total)
             for name, (items, sizes_) in corpora.items()]
    return MultiCorpusLoader(specs, max_tokens=10 ** 12, seed=seed, max_sentences=batch)


def _expect(counts, want, what, skip=()):
    """Every kernel's launches but those of ``skip`` equal ``want`` (0
    where not named)."""
    full = {**dict.fromkeys(KERNELS, 0), **want}
    bad = {n: [counts[n], full[n]] for n in KERNELS if n not in skip and counts[n] != full[n]}
    if bad:
        raise AssertionError(f"{what} launches [got, want]: {bad}")


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _finite(values, what):
    if not all(math.isfinite(float(v)) for v in values):
        raise AssertionError(f"{what}: non-finite {values}")


def phase_speechlm(device="cuda", tiny=False, seed=0):
    """SpeechLM-P Base (``SpeechLMConfig()``, bf16, every kernel flag on):
    ``SIB_UPDATES`` updates of ``speechlm_joint_loss`` at batch 4 over a
    ``MultiCorpusLoader`` of a speech corpus (8-16 s, km units at 50 Hz)
    and a mono-unit corpus (256-511 units); the CTC recipe
    (``recipes/speechlm_ctc_finetune.run``) for 2 updates on the joint
    model's stack, then greedy CTC through ``decode/asr.CTCDecoder`` on a 3
    s and an 11 s request; then FastText2Unit at ``fastspeech2_s()``: 3
    updates of ``fasttext2unit_loss`` and ``generate``.  Launches checked
    exactly: a joint update runs 18 train-attention layers (6 speech, 6
    unit on the speech frames, 6 unit on the mono units) and 6 conv
    launches; a CTC request 12 inference layers (2 launches each in bf16)
    and 6 conv launches; FastText2Unit none."""
    sz = _sib_sizes(tiny)
    dev = torch.device(device)
    cfg = sibling_config("speechlm", "bfloat16", True, tiny)
    loader = sibling_loader(cfg, ("speech", "text"), sz, seed, dev, sz["batch"])
    model = init_speechlm(cfg, torch.Generator().manual_seed(seed), dev).train()
    opt = recipe_adamw(model, 5e-4)
    gen = torch.Generator().manual_seed(seed + 1)
    out = {"ok": False, "losses": [], "step_s": []}
    L = cfg.speech_encoder.num_layers + 2 * cfg.unit_encoder.num_layers
    K.reset_launch_counts()
    for step, joint in loader.iter_epoch(0):
        if step == SIB_UPDATES:
            break
        t0 = time.perf_counter()
        loss, m = speechlm_joint_loss(model, joint, JointLossConfig(), generator=gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        _sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(loss.item())
    counts = {"train": K.launch_counts()}
    _finite(out["losses"], "speechlm joint losses")
    ups = len(out["losses"])
    if _cuda(dev):
        check_train_counts(counts["train"], ups * L, "SpeechLM encoder")
        _expect(counts["train"], {"conv_stack": ups * 6}, "speechlm train", TRAIN_KERNELS)

    # the CTC fine-tune surface on the joint model's stack: its recipe, then
    # greedy requests
    ctc = init_weights(SpeechLMCtc(cfg, 32), torch.Generator().manual_seed(seed + 3)).to(dev)
    ctc.speechlm.load_state_dict(model.state_dict(), strict=False)
    data = slm_recipe.synthetic_corpus(seed, n=sz["batch"], t_wav=int(sz["ctc_s"] * 16000))
    K.reset_launch_counts()
    fin = slm_recipe.run(cfg, steps=2, device=dev, model=ctc, data=data, log=lambda s: None)
    counts["ctc_finetune"] = K.launch_counts()
    _finite(fin["losses"], "CTC recipe losses")
    out["ctc_recipe_losses"] = fin["losses"]
    dec = CTCDecoder(ctc.eval(), blank_id=0, device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i, secs in enumerate(sz["requests_s"]):
        wav = synth_audio(secs, seed=300 + i)
        ids, lens = dec.frame_ids(wav[None], [len(wav)])
        if int(lens[0]) != cfg.conv_features.out_length(len(wav)) or not (
                (ids >= 0) & (ids < 32)).all():
            raise AssertionError(f"CTC request {secs} s: {lens}, ids {ids.min()}-{ids.max()}")
    _sync(dev)
    out["ctc_requests_s"] = time.perf_counter() - t0
    counts["ctc"] = K.launch_counts()
    n_enc = cfg.speech_encoder.num_layers + cfg.unit_encoder.num_layers
    if _cuda(dev):
        fwd = K.fwd_launches(torch.bfloat16)
        check_train_counts(counts["ctc_finetune"], 2 * n_enc, "SpeechLM CTC encoder")
        _expect(counts["ctc_finetune"], {"conv_stack": 3 * 6,
                                         "banded_flash_attention": n_enc * fwd},
                "CTC recipe (2 updates and its greedy pass)", TRAIN_KERNELS)
        _expect(counts["ctc"], {"banded_flash_attention": len(sz["requests_s"]) * n_enc * fwd,
                                "conv_stack": len(sz["requests_s"]) * 6}, "SpeechLM CTC")

    # FastText2Unit (no kernel: its attention has no rel-pos band)
    fcfg = C.replace(fastspeech2_tiny() if tiny else fastspeech2_s(), dtype="bfloat16")
    t2u = init_fastspeech2(fcfg, torch.Generator().manual_seed(seed + 2), dev).train()
    topt = recipe_adamw(t2u, 5e-4)
    rng = np.random.default_rng(seed)
    K.reset_launch_counts()
    t2u_losses = []
    for _ in range(3):
        lens = rng.integers(8, 24 if tiny else 60, sz["batch"])
        src = np.full((sz["batch"], lens.max()), fcfg.pad_id, np.int64)
        dur = np.zeros(src.shape, np.int64)
        for b, n in enumerate(lens):
            src[b, :n] = rng.integers(2, fcfg.src_vocab_size, n)
            dur[b, :n] = rng.integers(1, 3 if tiny else 8, n)
        src_t, dur_t = torch.from_numpy(src).to(dev), torch.from_numpy(dur).to(dev)
        tgt = torch.from_numpy(rng.integers(0, fcfg.unit_vocab_size,
                                            (sz["batch"], fcfg.max_target_len))).to(dev)
        logits, _, ov, ld = t2u(src_t, dur_t)
        loss, _ = fasttext2unit_loss(logits, ov, tgt, ld, dur_t, src_t != fcfg.pad_id)
        topt.zero_grad(set_to_none=True)
        loss.backward()
        topt.step()
        t2u_losses.append(loss.item())
    units, ulens, _ = t2u.eval().generate(src_t, d_factor=4.0)
    _sync(dev)
    counts["fasttext2unit"] = K.launch_counts()
    _finite(t2u_losses, "FastText2Unit losses")
    if units.shape != (sz["batch"], fcfg.max_target_len) or not (
            (ulens >= 0) & (ulens <= fcfg.max_target_len)).all():
        raise AssertionError(f"FastText2Unit generate: {tuple(units.shape)}, lengths {ulens}")
    if _cuda(dev):
        _expect(counts["fasttext2unit"], {}, "FastText2Unit")
    out.update(counts=counts, t2u_losses=t2u_losses,
               generated_lengths=ulens.tolist(), ok=True)
    log(json.dumps({"phase": "speechlm", **out}))
    del model, ctc, t2u, opt, topt
    torch.cuda.empty_cache()
    return out


def _beam_request(model, sz, device, seed, ctc_weight=0.3):
    """One beam request (beam 5, CTC ``ctc_weight``) through ``ASRDecoder``
    -> (BeamResult, decode steps, wall s)."""
    dec = ASRDecoder(model, beam_size=BEAM, max_len=sz["max_len"], ctc_weight=ctc_weight,
                     device=device)
    wav = synth_audio(sz["beam_s"], seed=seed)
    t0 = time.perf_counter()
    res = dec(wav[None], [len(wav)])
    _sync(device)
    return res, dec.steps_run, time.perf_counter() - t0


def _beam_counts(cfg, enc_layers, steps, chunks=1):
    return {"banded_flash_attention": chunks * enc_layers * K.fwd_launches(torch.bfloat16),
            "conv_stack": chunks * 6,
            "flash_attention_bias": steps * 2 * cfg.decoder.num_layers}


def phase_speechut(device="cuda", tiny=False, seed=0):
    """SpeechUT Base (``SpeechUTConfig()``: 6 + 6 encoder layers, 6 decoder
    layers; bf16, every kernel flag on): ``SIB_UPDATES`` updates of
    ``recipes/speechut_joint_pretrain.run`` (``speechut_joint_loss`` at the
    recipe's weights) over speech, paired and mono streams of batch 4, then
    the beam (beam 5, max_len 200, CTC 0.3) on a 3 s request through
    ``ASRDecoder``.  An update runs 24 train-attention layers (6 + 6 on the
    speech frames, 6 on the paired units, 6 on the mono units; the unit
    encoder's 6 on the speech frames feed no loss term, so they launch the
    forward kernel only) and 6 conv launches; the request 12 inference
    layers, 6 conv launches and 12 decode-step launches a step."""
    sz = _sib_sizes(tiny)
    dev = torch.device(device)
    cfg = sibling_config("speechut", "bfloat16", True, tiny)
    loader = sibling_loader(cfg, ("speech", "text_paired", "text_mono"), sz, seed, dev,
                            sz["batch"])
    model = init_speechut(cfg, torch.Generator().manual_seed(seed), dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = sut_recipe.run(cfg, steps=SIB_UPDATES, seed=seed, device=dev, model=model,
                         loader=loader, log=lambda s: None)
    _sync(dev)
    out = {"ok": False, "losses": res["losses"], "train_s": time.perf_counter() - t0,
           "metrics": res["metrics"]}
    counts = {"train": K.launch_counts()}
    _finite(res["losses"], "speechut joint losses")
    # the unit encoder's pass over the speech frames feeds no loss term
    # (the speech branch's loss reads the speech encoder's HuBERT logits):
    # its layers run the forward kernel and no backward
    back = cfg.speech_encoder.num_layers + 2 * cfg.unit_encoder.num_layers
    fwd_only = cfg.unit_encoder.num_layers
    if _cuda(dev):
        per = K.train_launches_per_layer(torch.bfloat16)
        want = {n: SIB_UPDATES * back * per[n] for n in TRAIN_KERNELS}
        want["banded_attention_train_fwd"] += SIB_UPDATES * fwd_only * per[
            "banded_attention_train_fwd"]
        _expect(counts["train"], want, "SpeechUT train (train kernels)",
                [n for n in KERNELS if n not in TRAIN_KERNELS])
        _expect(counts["train"], {"conv_stack": SIB_UPDATES * 6}, "speechut train",
                TRAIN_KERNELS)
    K.reset_launch_counts()
    beam, steps, wall = _beam_request(res["model"], sz, dev, seed=400)
    counts["beam"] = K.launch_counts()
    if _cuda(dev):
        _expect(counts["beam"], _beam_counts(cfg, cfg.speech_encoder.num_layers
                                             + cfg.unit_encoder.num_layers, steps),
                "SpeechUT beam")
    out.update(counts=counts, beam_steps=steps, beam_s=wall,
               best=beam.tokens[0, 0, : int(beam.lengths[0, 0])].tolist()[:12], ok=True)
    log(json.dumps({"phase": "speechut", **out}))
    del model, res
    torch.cuda.empty_cache()
    return out


def speech2c_corpus(directory, cfg, n, seconds, seed=0):
    """``n`` seeded utterances of ``seconds`` (min, max) with km labels in
    runs of 1-4 frames (as HuBERT units repeat at 50 Hz), codes < vocab - 4
    -> a ``SpeechPretrainDataset(add_decoder_target=True)``."""
    manifest, _, _ = write_corpus(directory, n, seconds=seconds, seed=seed)
    rng = np.random.default_rng(seed)
    with open(manifest, encoding="utf-8") as f:
        sizes = [int(l.split("\t")[1]) for l in f.read().splitlines()[1:] if l]
    km = os.path.join(directory, "train.km")
    with open(km, "w", encoding="utf-8") as f:
        for n_s in sizes:
            frames = n_s * 50 // 16000
            runs = rng.integers(1, 5, frames)
            labels = np.repeat(rng.integers(0, cfg.vocab_size - 4, frames), runs)[:frames]
            f.write(" ".join(map(str, labels)) + "\n")
    return SpeechPretrainDataset(manifest=manifest, km_labels=km, device_mel=True,
                                 add_decoder_target=True, pad_id=cfg.pad_id,
                                 eos_id=cfg.eos_id)


def phase_speech2c(device="cuda", tiny=False, seed=0):
    """``speech2c_base()`` (12 + 6 layers, 504 codes; bf16, every kernel
    flag on): ``SIB_UPDATES`` pretraining updates of
    ``recipes/speech2c_pretrain.run`` at batch 4 on a
    ``SpeechPretrainDataset(add_decoder_target=True)`` corpus of 8 seeded
    8-16 s utterances (HuBERT CE + the decoder's CE on the deduplicated
    codes), then the beam on a 3 s request.  An update runs 12
    train-attention layers and 6 conv launches; the request as SpeechUT's."""
    sz = _sib_sizes(tiny)
    dev = torch.device(device)
    cfg = sibling_config("speech2c", "bfloat16", True, tiny)
    with tempfile.TemporaryDirectory() as d:
        ds = speech2c_corpus(d, cfg, 2 * sz["batch"], sz["speech_s"], seed)
        batches = [ds.collate([ds[i] for i in range(s, s + sz["batch"])],
                              cfg.conv_features.out_length)
                   for s in range(0, len(ds), sz["batch"])]
    lens = [int(b["decoder_target_lengths"].max()) for b in batches]
    model = init_speech2c(cfg, torch.Generator().manual_seed(seed), dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = s2c_recipe.run(cfg, steps=SIB_UPDATES, seed=seed, device=dev, model=model,
                         batches=batches, log=lambda s: None)
    _sync(dev)
    out = {"ok": False, "losses": res["losses"], "first": res["first"], "last": res["last"],
           "train_s": time.perf_counter() - t0, "code_target_lengths": lens}
    counts = {"train": K.launch_counts()}
    _finite(res["losses"], "speech2c losses")
    if _cuda(dev):
        check_train_counts(counts["train"], SIB_UPDATES * cfg.encoder.num_layers,
                           "Speech2C encoder")
        _expect(counts["train"], {"conv_stack": SIB_UPDATES * 6}, "speech2c train",
                TRAIN_KERNELS)
    K.reset_launch_counts()
    beam, steps, wall = _beam_request(res["model"], sz, dev, seed=401)
    counts["beam"] = K.launch_counts()
    if _cuda(dev):
        _expect(counts["beam"], _beam_counts(cfg, cfg.encoder.num_layers, steps),
                "Speech2C beam")
    out.update(counts=counts, beam_steps=steps, beam_s=wall, ok=True)
    log(json.dumps({"phase": "speech2c", **out}))
    del model, res
    torch.cuda.empty_cache()
    return out


def _twin_models(family, init, tiny, device, seed, extra=()):
    """The family's f32 model on the kernel route and on the plain route,
    with the same weights (stochastic parts at 0)."""
    still = sibling_still(family) + list(extra)
    cfg_k = sibling_config(family, "float32", True, tiny, still)
    cfg_p = sibling_config(family, "float32", False, tiny, still)
    mk = init(cfg_k, torch.Generator().manual_seed(seed), device)
    mp = init(cfg_p, torch.Generator().manual_seed(seed), device)
    mp.load_state_dict(mk.state_dict())
    return cfg_k, cfg_p, mk, mp


class _ulp_scaled:
    """Scale ``params`` in place by ``ULP_SCALE`` for the duration of the
    block (forward and backward), then restore their exact values."""

    def __init__(self, params):
        self.params = list(params)

    def __enter__(self):
        self.saved = [p.detach().clone() for p in self.params]
        with torch.no_grad():
            for p in self.params:
                p.mul_(ULP_SCALE)

    def __exit__(self, *exc):
        with torch.no_grad():
            for p, v in zip(self.params, self.saved):
                p.copy_(v)


def _route_loss_grads(models, loss_fn, ulp_fn=None, ulp_params=lambda m: []):
    """loss_fn(model) and its backward on each model in train mode -> [(loss,
    {name: grad})].  With ``ulp_fn`` a third run on the last (plain) model:
    ``ulp_fn(model)``, its inputs scaled by ``ULP_SCALE``, with
    ``ulp_params(model)`` scaled as well for the forward and backward; it
    leaves the model's buffers (BatchNorm statistics) as the second run
    left them."""
    runs = [(m, loss_fn, False) for m in models]
    if ulp_fn is not None:
        runs.append((models[-1], ulp_fn, True))
    out = []
    for m, fn, ulp in runs:
        m.train()
        buffers = {n: b.clone() for n, b in m.named_buffers()} if ulp else {}
        with _ulp_scaled(ulp_params(m) if ulp else []):
            loss = fn(m)
            loss.backward()
        out.append((loss.item(), {n: p.grad for n, p in m.named_parameters()}))
        m.zero_grad(set_to_none=True)
        m.eval()
        with torch.no_grad():
            for n, b in m.named_buffers():
                if n in buffers:
                    b.copy_(buffers[n])
    return out


def _gate(what, results, loss_rtol, grad_rtol):
    """The kernel route's loss and gradients (``results[0]``) against the
    plain route's (``results[1]``): losses within ``loss_rtol``; gradients
    within ``grad_rtol`` of max |g|, or, given the plain route's run under
    ``ULP_SCALE`` (``results[2]``), through ``grad_gate``."""
    (lk, gk), (lp, gp) = results[:2]
    rec = {"loss_kernel": lk, "loss_plain": lp, "loss_rel_diff": abs(lk - lp) / abs(lp)}
    if len(results) == 3:
        worst, name, floored, over = grad_gate(gk, gp, results[2][1], grad_rtol)
        rec.update(grads_held_to_their_ulp_move=floored, grads_over=over)
    else:
        worst, name = grad_diff(gk, gp)
        over = worst > grad_rtol
    rec.update(worst_grad_rel_diff=worst, worst_grad_param=name)
    if rec["loss_rel_diff"] > loss_rtol or over:
        raise AssertionError(f"{what}: kernel and plain routes differ: {rec}")
    return rec


def _beam_gate(what, res_k, res_p, gap_tol, score_rtol):
    """The kernel route's best hypothesis equals the plain route's (or is
    its second at a near tie, within ``gap_tol``), the best scores within
    ``score_rtol``."""
    a = res_k.tokens[0, 0, : int(res_k.lengths[0, 0])].tolist()
    hyps = [res_p.tokens[0, j, : int(res_p.lengths[0, j])].tolist()
            for j in range(res_p.tokens.shape[1])]
    sp = res_p.scores[0].tolist()
    rel = abs(res_k.scores[0, 0].item() - sp[0]) / abs(sp[0])
    tie = a != hyps[0] and a == hyps[1] and sp[0] - sp[1] < gap_tol
    if (a != hyps[0] and not tie) or rel > score_rtol:
        raise AssertionError(f"{what}: beams differ: {a[:20]} vs {hyps[0][:20]}, "
                             f"score rel diff {rel}")
    return {"best_equal": a == hyps[0], "near_tie": tie, "score_rel_diff": rel,
            "length": len(a)}


def phase_siblings_parity(device="cuda", tiny=False, seed=0, loss_rtol=1e-4,
                          grad_rtol=1e-3, gap_tol=1e-4, score_rtol=1e-4, max_frac=1e-3):
    """f32 on the card, every stochastic part at 0, the draws (HuBERT
    masks, the mix selection) drawn once and handed to both routes, the
    same weights: each family's kernel route against its plain route.
    SpeechLM: the joint loss (1e-4) and every gradient (1e-3 of max |g|,
    ``grad_rel_diffs``) on 2 speech utterances and 2 mono-unit rows, then
    greedy CTC ids on a 3 s request (equal, but for frames whose plain
    top-2 gap is under 1e-4, at most 0.1% of them).  SpeechUT: the joint
    loss and gradients with the paired and mono streams, then the beam's
    best hypothesis on a 3 s request (equal, or a near tie of the plain
    route's top two; best scores 1e-4), max_len 60.  Speech2C: the
    pretraining loss and gradients, then the beam as SpeechUT's."""
    sz = dict(_sib_sizes(tiny), batch=2)
    if not tiny:
        sz["max_len"] = SIB_PARITY_MAX_LEN
    dev = torch.device(device)
    out = {"ok": False}

    def draws_for(cfg, joint, text_key, speech_masking):
        g = torch.Generator().manual_seed(seed + 5)
        sp = joint["speech"]
        fl = cfg.conv_features.out_length(sp["wav_lengths"]).cpu()
        T = sp["units"].shape[1]
        tm, cm = sample_feature_masks(fl, T, cfg.d_model, speech_masking, g)
        mix = mix_selection(fl, T, cfg.masking, tm, g)
        u = joint[text_key]["units"]
        um = sample_feature_masks((u != cfg.pad_id).sum(-1).cpu(), u.shape[1], cfg.d_model,
                                  text_masking(cfg.masking), g)
        return {"speech": {"masks": (tm, cm), "mix_sel": mix}, text_key: {"masks": um}}

    # SpeechLM
    cfg, cfg_p, mk, mp = _twin_models("speechlm", init_speechlm, tiny, dev, seed)
    joint = next(sibling_loader(cfg, ("speech", "text"), sz, seed, dev, 2).iter_epoch(0))[1]
    dr = draws_for(cfg, joint, "text", cfg.masking)
    jc = JointLossConfig()
    rec = {"joint": _gate("SpeechLM joint loss", _route_loss_grads(
        (mk, mp), lambda m: speechlm_joint_loss(m, joint, jc, draws=dr)[0]),
        loss_rtol, grad_rtol)}
    ck = init_weights(SpeechLMCtc(cfg, 32), torch.Generator().manual_seed(seed + 3)).to(dev)
    cp = SpeechLMCtc(cfg_p, 32).to(dev)
    ck.speechlm.load_state_dict(mk.state_dict(), strict=False)
    cp.load_state_dict(ck.state_dict())
    wav = synth_audio(sz["beam_s"], seed=500)
    with torch.no_grad():
        lk, _ = ck.eval()(torch.from_numpy(wav[None]).to(dev),
                          torch.tensor([len(wav)], device=dev))
        lp, _ = cp.eval()(torch.from_numpy(wav[None]).to(dev),
                          torch.tensor([len(wav)], device=dev))
    bad = (lk.argmax(-1) != lp.argmax(-1))[0].nonzero()[:, 0]
    gap = 0.0
    if len(bad):
        top2 = torch.topk(lp[0, bad], 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).max().item()
    rec["ctc"] = {"frames": lk.shape[1], "differing_frames": len(bad),
                  "max_top2_gap_at_differing": gap}
    if len(bad) > max_frac * lk.shape[1] or (len(bad) and gap >= gap_tol):
        raise AssertionError(f"SpeechLM CTC ids of the kernel route differ: {rec['ctc']}")
    out["speechlm"] = rec
    del mk, mp, ck, cp

    # SpeechUT
    cfg, _, mk, mp = _twin_models("speechut", init_speechut, tiny, dev, seed)
    joint = next(sibling_loader(cfg, ("speech", "text_paired", "text_mono"), sz, seed, dev,
                                2).iter_epoch(0))[1]
    dr = draws_for(cfg, joint, "text_mono", text_masking(cfg.masking))
    rec = {"joint": _gate("SpeechUT joint loss", _route_loss_grads(
        (mk, mp), lambda m: speechut_joint_loss(m, joint, sut_recipe.JOINT, draws=dr)[0]),
        loss_rtol, grad_rtol)}
    rk, rp = (_beam_request(m, sz, dev, seed=501)[0] for m in (mk, mp))
    rec["beam"] = _beam_gate("SpeechUT", rk, rp, gap_tol, score_rtol)
    out["speechut"] = rec
    del mk, mp

    # Speech2C
    cfg, _, mk, mp = _twin_models("speech2c", init_speech2c, tiny, dev, seed,
                               ["masking.mask_channel_prob=0.0"])
    with tempfile.TemporaryDirectory() as d:
        ds = speech2c_corpus(d, cfg, 2, sz["speech_s"], seed + 1)
        b = {k: torch.as_tensor(v).to(dev) for k, v in
             ds.collate([ds[0], ds[1]], cfg.conv_features.out_length).items()
             if hasattr(v, "dtype")}
    fl = cfg.conv_features.out_length(b["wav_lengths"]).cpu()
    masks = sample_feature_masks(fl, b["km_labels"].shape[1], cfg.d_model, cfg.masking,
                                 torch.Generator().manual_seed(seed + 6))

    def s2c_loss(m):
        o = m.forward_pretrain(b["wav"], b["wav_lengths"], b["prev_tokens"], masks=masks)
        return speech2c_pretrain_loss(o, b["km_labels"], b["decoder_targets"], cfg.pad_id)[0]

    rec = {"pretrain": _gate("Speech2C pretraining loss", _route_loss_grads(
        (mk, mp), s2c_loss), loss_rtol, grad_rtol)}
    rk, rp = (_beam_request(m, sz, dev, seed=502)[0] for m in (mk, mp))
    rec["beam"] = _beam_gate("Speech2C", rk, rp, gap_tol, score_rtol)
    out["speech2c"] = rec
    del mk, mp
    out["ok"] = True
    log(json.dumps({"phase": "siblings_parity", **out}))
    torch.cuda.empty_cache()
    return out


# phases 35-37: YiTrans and VATLM at full width, then each family's kernel
# route against its plain route in f32
YIT_FLAGS = ["encoder.use_pallas_attn=True", "encoder.use_pallas_attn_train=True",
             "decoder.use_pallas_attn=True", "conv_features.impl='pallas'"]
VAT_FLAGS = YIT_FLAGS[:3]            # no waveform front: no conv stack
YIT_TEXT_TOKENS = (128, 256)         # stage 1's denoised mono text
YIT_PAIR_TOKENS = (50, 70)           # the MT pairs; the MT beam's source 51-71 with EOS
YIT_TGT_TOKENS = 30                  # the ASR / ST fine-tunes' targets
YIT_MT_T = 61                        # the MT beam's source (+ EOS) in the kernels phase
VAT_PHONES = 50                      # phone_vocab_size on the Base config (0: no branch)
VAT_CLIP_S = (2.0, 4.0)              # 50-100 video frames at 25 Hz
VAT_BEAM_S = 3.0                     # the AVSR request: 75 frames
VAT_BEAM_T = int(VAT_BEAM_S * 25)
VAT_TRAIN_T = int(VAT_CLIP_S[1] * 25)
VAT_RAW = 96                         # raw lip-ROI frames, the train crop 88 at random
YIT_TINY = dict(SIB_TINY, text=(8, 16), pair=(6, 12), tgt=4, clip_s=(1.0, 1.6), vat_beam_s=1.0)


def _yv_sizes(tiny: bool) -> dict:
    if tiny:
        return YIT_TINY
    return dict(_sib_sizes(False), text=YIT_TEXT_TOKENS, pair=YIT_PAIR_TOKENS,
                tgt=YIT_TGT_TOKENS, clip_s=VAT_CLIP_S, vat_beam_s=VAT_BEAM_S)


def yitrans_data(cfg, sz, seed, device):
    """``recipes/yitrans_pretrain_finetune.synthetic_data`` at the phase's
    sizes: a dictionary of ``vocab_size`` symbols (words, two language
    tags, <mask>), ``SIB_UPDATES`` batches of ``batch`` utterances of
    ``speech_s`` with km units, two languages of mono text of ``text``
    tokens (two batches each), MT pairs of ``pair`` tokens, batches of
    ``batch`` rows by count."""
    b = sz["batch"]
    return yit_recipe.synthetic_data(
        cfg, seed, device, max_sentences=b, n_speech=SIB_UPDATES * b,
        wav_samples=tuple(int(s * SR) for s in sz["speech_s"]), n_mono=2 * b,
        text_tokens=sz["text"], n_pair=2 * b, pair_tokens=sz["pair"],
        n_words=cfg.vocab_size - 7, b_sp=b, b_txt=b, tgt_tokens=sz["tgt"])


def _yit_beam(model, task, data, sz, device, seed):
    """The fine-tuned model's beam (beam 5, ``max_len``): ASR on a
    ``beam_s`` request (CTC 0.3), MT on the first pair's source (no CTC
    head on text) -> (BeamResult, decode steps, wall s)."""
    dec = yit_recipe.decoder_for(model, task, device, beam_size=BEAM, max_len=sz["max_len"],
                                 ctc_weight=0.3 if task == "asr" else 0.0)
    if task == "asr":
        wav = synth_audio(sz["beam_s"], seed=seed)
        args = (wav[None], [len(wav)])
    else:
        args = (data["pair"][0]["source"][None],)
    t0 = time.perf_counter()
    res = dec(*args)
    _sync(device)
    return res, dec.steps_run, time.perf_counter() - t0


def phase_yitrans(device="cuda", tiny=False, seed=0):
    """YiTrans Base (``YiTransConfig()``: 12 + 12 layers, d 768, vocab
    32000; bf16, every kernel flag on) through
    ``recipes/yitrans_pretrain_finetune``: ``SIB_UPDATES`` stage-1 updates
    at batch 4 (speech of 8-16 s with km units; denoised [en_XX] / [de_DE]
    text of 128-256 tokens), one update each of the ASR (0.7 CE + 0.3
    CTC), MT and ST fine-tunes warm-started from stage 1, then the beam
    (beam 5, max_len 200) on a 3 s ASR request (CTC 0.3) and on a 51-71
    token MT source through ``encode_text``.  Launches checked exactly: a
    stage-1 update runs 24 train-attention layers (12 on the speech, 12 on
    the text, one encoder) and 6 conv launches; a fine-tune update 12
    layers and 6 conv launches (none for MT); a request 12 inference
    layers (and 6 conv launches for ASR), 24 decode-step launches a step."""
    sz = _yv_sizes(tiny)
    dev = torch.device(device)
    cfg = sibling_config("yitrans", "bfloat16", True, tiny)
    data = yitrans_data(cfg, sz, seed, dev)
    model = init_yitrans(cfg, torch.Generator().manual_seed(seed), dev)
    gen = torch.Generator().manual_seed(seed + 1)
    L = cfg.encoder.num_layers
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses, metrics = yit_recipe.pretrain(model, data["loader"], SIB_UPDATES, 5e-4,
                                          generator=gen, log=lambda s: None)
    _sync(dev)
    out = {"ok": False, "pretrain_losses": losses, "metrics": metrics,
           "pretrain_s": time.perf_counter() - t0,
           "text_tokens": int(data["mono"][0].sizes.max())}
    counts = {"pretrain": K.launch_counts()}
    _finite(losses, "yitrans stage-1 losses")
    if _cuda(dev):
        check_train_counts(counts["pretrain"], SIB_UPDATES * 2 * L, "YiTrans speech + text")
        _expect(counts["pretrain"], {"conv_stack": SIB_UPDATES * 6}, "yitrans stage 1",
                TRAIN_KERNELS)
    tuned = {}
    for task in yit_recipe.TASKS:
        batch = yit_recipe.finetune_batch(data, task, dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        ft, ft_losses = yit_recipe.finetune(model, task, [batch], 5e-4, generator=gen,
                                            log=lambda s: None)
        _sync(dev)
        counts[f"finetune_{task}"] = K.launch_counts()
        out[f"finetune_{task}"] = {"loss": ft_losses[0], "s": time.perf_counter() - t0}
        _finite(ft_losses, f"yitrans {task} fine-tune")
        if _cuda(dev):
            check_train_counts(counts[f"finetune_{task}"], L, f"YiTrans {task}")
            _expect(counts[f"finetune_{task}"], {"conv_stack": 0 if task == "mt" else 6},
                    f"yitrans {task} fine-tune", TRAIN_KERNELS)
        if task in ("asr", "mt"):
            tuned[task] = ft
        del ft
    for i, task in enumerate(("asr", "mt")):
        K.reset_launch_counts()
        beam, steps, wall = _yit_beam(tuned[task], task, data, sz, dev, seed=410 + i)
        counts[f"beam_{task}"] = K.launch_counts()
        if _cuda(dev):
            want = {"banded_flash_attention": L * K.fwd_launches(torch.bfloat16),
                    "flash_attention_bias": steps * 2 * cfg.decoder.num_layers}
            if task == "asr":
                want["conv_stack"] = 6
            _expect(counts[f"beam_{task}"], want, f"YiTrans {task} beam")
        out[f"beam_{task}"] = {"steps": steps, "s": wall,
                               "best": beam.tokens[0, 0, : int(beam.lengths[0, 0])].tolist()[:12]}
    out.update(counts=counts, ok=True)
    log(json.dumps({"phase": "yitrans", **out}))
    del model, tuned
    torch.cuda.empty_cache()
    return out


def vatlm_corpus(directory, cfg, sz, seed, n):
    """``n`` seeded AV clips of ``clip_s`` seconds and one of
    ``vat_beam_s`` (the request): 16 kHz audio, raw 0-255 lip ROIs of
    ``VAT_RAW`` (the crop + 8) pixels at 25 fps as ``.npy``, km labels of
    ``num_classes[0]`` at 25 Hz -> (the train ``VATLMDataset``, with the
    random crop and flip; the eval one, center crop)."""
    rng = np.random.default_rng(seed)
    raw = cfg.video_size + 8
    lines, labels = [directory], []
    for i, secs in enumerate([*rng.uniform(*sz["clip_s"], n), sz["vat_beam_s"]]):
        frames = max(int(secs * 25), 2)
        write_wav(os.path.join(directory, f"c{i}.wav"), synth_audio(frames / 25, 900 + seed + i))
        np.save(os.path.join(directory, f"c{i}.npy"),
                rng.integers(0, 256, (frames, raw, raw)).astype(np.uint8))
        lines.append(f"c{i}\tc{i}.npy\tc{i}.wav\t{frames * 640}\t{frames}")
        labels.append(" ".join(map(str, rng.integers(0, cfg.num_classes[0], frames))))
    with open(os.path.join(directory, "av.tsv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(directory, "av.km"), "w", encoding="utf-8") as f:
        f.write("\n".join(labels) + "\n")
    kw = dict(label_paths=[os.path.join(directory, "av.km")], stack_order=cfg.audio_feat_dim // 26,
              image_crop_size=cfg.video_size, seed=seed)
    return (VATLMDataset(os.path.join(directory, "av.tsv"), image_aug=True, **kw),
            VATLMDataset(os.path.join(directory, "av.tsv"), **kw))


def vatlm_data(cfg, sz, seed, n_batches):
    """``n_batches`` train batches of ``batch`` clips (epoch e's augmentation
    for batch e) with random phones at the frame rate, and the request's
    eval item (audio [T, F], video [T, H, W, 1])."""
    b = sz["batch"]
    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as d:
        ds, ev = vatlm_corpus(d, cfg, sz, seed, n_batches * b)
        batches = []
        for e in range(n_batches):
            ds.set_epoch(e)
            c = ds.collate([ds[i] for i in range(e * b, (e + 1) * b)])
            B, T = c["audio"].shape[:2]
            batches.append({"audio": c["audio"], "video": c["video"], "lengths": c["lengths"],
                            "targets": c["targets"][0],
                            "phones": rng.integers(4, cfg.phone_vocab_size, (B, T)).astype(
                                np.int32)})
        request = ev[len(ev) - 1]
    return batches, request


def _vat_beam(model, request, sz, device):
    dec = ASRDecoder(model, beam_size=BEAM, max_len=sz["max_len"], encode_method="encode_av",
                     device=device)
    t0 = time.perf_counter()
    res = dec(request["audio"][None], request["video"][None], [len(request["audio"])])
    _sync(device)
    return res, dec.steps_run, time.perf_counter() - t0


def phase_vatlm(device="cuda", tiny=False, seed=0):
    """VATLM Base (``VATLMConfig(phone_vocab_size=50)``: 12 + 6 layers, d
    768, 88 x 88 video through the 3-D stem and ResNet-18 widths (64, 128,
    256, 512), 104-d stacked fbank, 1000 km classes; bf16, every kernel flag
    on) through ``recipes/vatlm_pretrain.run``: ``SIB_UPDATES`` updates at
    batch 4 on 2-4 s clips (50-100 frames at 25 Hz) read by
    ``VATLMDataset`` (the train crop and flip, per-epoch), each update the
    recipe's three streams (audio+video, audio, phones) with the video
    BatchNorm in train mode, then the AVSR beam (beam 5, max_len 200,
    ``encode_method="encode_av"``) on a 3 s clip.  Launches checked
    exactly: an update runs 36 train-attention layers (12 a stream); the
    request 12 inference layers and 12 decode-step launches a step."""
    sz = _yv_sizes(tiny)
    dev = torch.device(device)
    cfg = sibling_config("vatlm", "bfloat16", True, tiny)
    batches, request = vatlm_data(cfg, sz, seed, SIB_UPDATES)
    model = init_vatlm(cfg, torch.Generator().manual_seed(seed), dev)
    L = cfg.encoder.num_layers
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = vat_recipe.run(cfg, steps=SIB_UPDATES, lr=5e-4, seed=seed, device=dev, model=model,
                         batch=batches, log=lambda s: None)
    _sync(dev)
    out = {"ok": False, "losses": res["losses"], "last": res["last"],
           "train_s": time.perf_counter() - t0,
           "frames": [int(b["lengths"].max()) for b in batches]}
    counts = {"train": K.launch_counts()}
    _finite(res["losses"], "vatlm losses")
    if _cuda(dev):
        check_train_counts(counts["train"], SIB_UPDATES * len(VATLM_STREAMS) * L,
                           "VATLM encoder")
        _expect(counts["train"], {}, "vatlm train", TRAIN_KERNELS)
    K.reset_launch_counts()
    beam, steps, wall = _vat_beam(res["model"], request, sz, dev)
    counts["beam"] = K.launch_counts()
    if _cuda(dev):
        _expect(counts["beam"], {"banded_flash_attention": L * K.fwd_launches(torch.bfloat16),
                                 "flash_attention_bias": steps * 2 * cfg.decoder.num_layers},
                "VATLM AVSR beam")
    out.update(counts=counts, beam_steps=steps, beam_s=wall, request_frames=len(request["audio"]),
               ok=True)
    log(json.dumps({"phase": "vatlm", **out}))
    del model, res
    torch.cuda.empty_cache()
    return out


def phase_yitrans_vatlm_parity(device="cuda", tiny=False, seed=0, loss_rtol=1e-4,
                               grad_rtol=1e-3, gap_tol=1e-4, score_rtol=1e-4):
    """f32 on the card, every dropout at 0, the HuBERT masks drawn once and
    handed to both routes, the same weights: each family's kernel route
    against its plain route.  YiTrans: the stage-1 loss (1e-4) and every
    gradient through ``grad_gate`` (1e-3 of its max |g|, or twice the
    plain route's own move under ``ULP_SCALE`` of the waveform and the
    token embeddings) on 2 speech utterances and 2 denoised text rows,
    then the best hypotheses of the ASR beam (3 s, CTC 0.3) and the MT beam
    (equal, or a near tie of the plain route's top two; best scores 1e-4),
    max_len 60.  VATLM: the three-stream loss and gradients on 2
    clips (the same masks on each stream; BatchNorm on batch statistics;
    the ULP scaling on the audio, the video and the phone embeddings), then
    the AVSR beam as YiTrans'."""
    sz = dict(_yv_sizes(tiny), batch=2)
    if not tiny:
        sz["max_len"] = SIB_PARITY_MAX_LEN
    dev = torch.device(device)
    out = {"ok": False}

    cfg, _, mk, mp = _twin_models("yitrans", init_yitrans, tiny, dev, seed)
    data = yitrans_data(cfg, sz, seed, dev)
    joint = next(data["loader"].iter_epoch(0))[1]
    sp = joint["speech"]
    masks = sample_feature_masks(cfg.conv_features.out_length(sp["wav_lengths"]).cpu(),
                                 sp["units"].shape[1], cfg.d_model, text_masking(cfg.masking),
                                 torch.Generator().manual_seed(seed + 5))

    def yit_loss(j):
        return lambda m: yitrans_pretrain_loss(m, j, JointLossConfig(),
                                               draws={"speech": {"masks": masks}})[0]

    ulp_joint = dict(joint, speech=dict(sp, wav=sp["wav"] * ULP_SCALE))
    rec = {"pretrain": _gate("YiTrans stage-1 loss", _route_loss_grads(
        (mk, mp), yit_loss(joint), yit_loss(ulp_joint), lambda m: [m.embed_tokens.weight]),
        loss_rtol, grad_rtol)}
    for i, task in enumerate(("asr", "mt")):
        rk, rp = (_yit_beam(m, task, data, sz, dev, seed=510 + i)[0] for m in (mk, mp))
        rec[f"beam_{task}"] = _beam_gate(f"YiTrans {task}", rk, rp, gap_tol, score_rtol)
    out["yitrans"] = rec
    del mk, mp

    cfg, _, mk, mp = _twin_models("vatlm", init_vatlm, tiny, dev, seed)
    (batch,), request = vatlm_data(cfg, sz, seed + 1, 1)
    b = vat_recipe.on_device(batch, dev)
    g = torch.Generator().manual_seed(seed + 6)
    draws = {name: {"masks": sample_feature_masks(b["lengths"].cpu(), b["audio"].shape[1],
                                                  cfg.d_model, text_masking(cfg.masking), g)}
             for name, _ in VATLM_STREAMS}

    def vat_loss(bb):
        return lambda m: vatlm_pretrain_loss(m, bb, draws=draws)[0]

    rec = {"pretrain": _gate("VATLM three-stream loss", _route_loss_grads(
        (mk, mp), vat_loss(b), vat_loss(dict(b, audio=b["audio"] * ULP_SCALE,
                                             video=b["video"] * ULP_SCALE)),
        lambda m: [m.phone_embed.weight]), loss_rtol, grad_rtol)}
    rk, rp = (_vat_beam(m, request, sz, dev)[0] for m in (mk, mp))
    rec["beam_avsr"] = _beam_gate("VATLM AVSR", rk, rp, gap_tol, score_rtol)
    out["vatlm"] = rec
    del mk, mp
    out["ok"] = True
    log(json.dumps({"phase": "yitrans_vatlm_parity", **out}))
    torch.cuda.empty_cache()
    return out


WAVLLM_SFT_S = (8.0, 16.0)           # the SFT clips
WAVLLM_SFT_BATCH, WAVLLM_SFT_UPDATES = 2, 2
WAVLLM_TARGET_BYTES = (19, 39)       # + EOS: 20-40 target tokens
WAVLLM_REQUESTS_S = (10, 30)         # WavLM T 499 / 1499, Whisper 500 / 1500 frames
WAVLLM_MAX_NEW, WAVLLM_BEAM = 32, 4
WAVLLM_LR = 1e-4
WAVLLM_LORA_B_STD = 0.02             # the adapters as after fine-tuning (B = 0 at init)
WAVLLM_PARITY_DEPTH = dict(whisper_layers=4, llama_layers=4)    # WavLM keeps its 12
WAVLLM_TINY = dict(sft_s=(0.5, 0.9), target=(6, 10), requests_s=(0.6, 1.2), max_new=4, beam=2)
WAVLM_T = tuple(C.ConvFeatureConfig().out_length(s * 16000) for s in WAVLLM_REQUESTS_S)
# the tiled kernel's further cases (flash_bias_case): WavLM's padded batch of
# two at 30 s, a T that is a multiple of neither 8 nor 64, a sample with no
# valid frame
WAVLM_TILED_CASES = (f"wavlm_b2_T{WAVLM_T[-1]}", "wavlm_T77", "wavlm_b2_empty_T130")
WAVLM_CONV_T = (WAVLLM_REQUESTS_S[-1] * 16000 - 10) // 5 + 1      # after conv 0: 95999


def _wavllm_sizes(tiny: bool) -> dict:
    if tiny:
        return WAVLLM_TINY
    return dict(sft_s=WAVLLM_SFT_S, target=WAVLLM_TARGET_BYTES, requests_s=WAVLLM_REQUESTS_S,
                max_new=WAVLLM_MAX_NEW, beam=WAVLLM_BEAM)


def wavllm_prefix_len(seconds: float, cfg: WavLLMConfig = WavLLMConfig()) -> int:
    """The packed prefix's slots of a ``seconds`` request at the released
    geometry: BOS + the chat template's left prompt, the audio (Whisper's
    frames and WavLM's, each through its two stride-2 adapters, the
    shorter), the right prompt around ``PROMPTS[0]`` (byte tokens)."""
    n = int(seconds * 16000)
    halve = lambda t: (t + 1) // 2
    whisper = halve(halve(halve(n // WHISPER_HOP)))
    wavlm = halve(halve(cfg.wavlm.conv.out_length(n)))
    left, right = prompt_strings(wavllm_recipe.PROMPTS[0])
    return 1 + len(left.encode()) + min(whisper, wavlm) + len(right.encode())


def wavllm_config(dtype: str, kernels: bool, tiny: bool = False, **kw) -> WavLLMConfig:
    """``WavLLMConfig()`` (the released geometry: Whisper 32 x 1280, WavLM
    Base, LLaMA 32 x 4096, LoRA r 8; ``tiny``: ``wavllm_tiny`` at 80 mels and
    the recipe's RoPE table) at ``dtype``, with ``kernels`` the WavLM
    attention and the LLaMA decode step on ``flash_attention_bias`` and the
    extractor on the conv stack (else all plain, the extractor ``xla``)."""
    cfg = (wavllm_tiny(n_mels=80, max_seq_len=wavllm_recipe.TINY_SEQ_LEN) if tiny
           else WavLLMConfig())
    wavlm = C.replace(cfg.wavlm, use_pallas_attn=kernels,
                      conv=C.replace(cfg.wavlm.conv, impl="pallas" if kernels else "xla"))
    return C.replace(cfg, dtype=dtype, use_pallas_attn=kernels, wavlm=wavlm, **kw)


def wavllm_data(cfg, sz, seed, n_batches=WAVLLM_SFT_UPDATES):
    """``n_batches`` SFT batches of ``WAVLLM_SFT_BATCH`` clips of ``sft_s``
    with ``target`` bytes (``recipes/wavllm_sft.write_corpus``, read back
    through ``WavLLMDataset``: the Whisper mel, the waveform, the chat
    template, byte tokens) and one request per ``requests_s`` -> (batches,
    requests), numpy."""
    tok = wavllm_recipe.byte_tokenizer(cfg.vocab_size)
    batches, requests = [], []
    with tempfile.TemporaryDirectory() as d:
        for u in range(n_batches):
            os.makedirs(os.path.join(d, f"sft{u}"))
            tsv = wavllm_recipe.write_corpus(os.path.join(d, f"sft{u}"), WAVLLM_SFT_BATCH,
                                             seconds=sz["sft_s"], target_bytes=sz["target"],
                                             seed=seed + u)
            batches.append(wavllm_recipe.load_batch(tsv, tok, cfg))
        for i, secs in enumerate(sz["requests_s"]):
            os.makedirs(os.path.join(d, f"req{i}"))
            tsv = wavllm_recipe.write_corpus(os.path.join(d, f"req{i}"), 1, seconds=(secs, secs),
                                             seed=seed + 100 + i)
            requests.append(wavllm_recipe.load_batch(tsv, tok, cfg))
    return batches, requests


def _wavllm_request(model, req, method, max_new, beam):
    """``generate`` (greedy) or ``generate_beam`` on one request ->
    (tokens [1, max_new], the beam's score or None)."""
    kw = dict(max_new=max_new, wav=req["wav"], wav_lengths=req["wav_lengths"],
              left_tokens=req["left_tokens"])
    if method == "beam":
        return model.generate_beam(req["mel"], req["mel_lengths"], req["prompt_tokens"],
                                   beam_size=beam, **kw)
    return model.generate(req["mel"], req["mel_lengths"], req["prompt_tokens"], **kw), None


def _peak_gb(device) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if _cuda(device) else 0.0


WAVLLM_PROFILED_STEPS = 4


def wavllm_step_profile(model, req):
    """Greedy generation on ``req`` under ``torch.profiler`` (device events
    only, ``device_profile``), at ``WAVLLM_PROFILED_STEPS`` decode steps and
    at none (the prefill alone): device launches, busy ms and wall ms a
    decode step by difference, the prefill's launches and busy ms, and the
    longer run's idle share and largest device times."""
    a, b = (device_profile(lambda n=n: _wavllm_request(model, req, "greedy", n + 1, 1),
                           lambda: 0)
            for n in (0, WAVLLM_PROFILED_STEPS))
    per = lambda k: (b[k] - a[k]) / WAVLLM_PROFILED_STEPS
    return {"launches_per_step": per("device_launches"), "busy_ms_per_step": per("device_busy_ms"),
            "wall_ms_per_step": per("wall_ms_profiled"), "idle_share": b["idle_share"],
            "prefill_launches": a["device_launches"], "prefill_busy_ms": a["device_busy_ms"],
            "top_device_ms": b["top_device_ms"]}


def phase_wavllm(device="cuda", tiny=False, seed=0):
    """WavLLM at ``WavLLMConfig()``'s released geometry (Whisper-large-v2's
    encoder 32 x 1280, WavLM Base with the conv-stack extractor, LLaMA-2-7B
    32 x 4096, LoRA r 8; bf16, every kernel flag on), its random seeded
    weights drawn on the card (the frozen matrices in bf16, the trained
    parameters f32; LoRA B normal(0.02)): ``WAVLLM_SFT_UPDATES`` updates of
    ``recipes/wavllm_sft`` at batch 2 (8-16 s clips, the chat template,
    20-40 byte target tokens; train mode, so dropout on and WavLM's
    attention on its plain route), then per request (10 s, 30 s) a prefill
    alone (twice: a warm-up, then timed), ``generate`` and
    ``generate_beam`` (beam 4), max_new 32.
    Launches checked exactly: an update runs the conv stack once per
    WavLM forward (6 launches) and no attention kernel; a prefill 12
    attention launches (WavLM's layers) and 6 conv launches; each decode
    step one decode-step launch per LLaMA layer (32).  Logged: update
    walls, ms a decode step (the generation's wall less the prefill's,
    over its 31 steps), launches a step, peak memory; on a card, then the
    10 s request's greedy decode steps under ``torch.profiler``
    (``wavllm_step_profile``)."""
    sz = _wavllm_sizes(tiny)
    dev = torch.device(device)
    cfg = wavllm_config("bfloat16", True, tiny)
    n_conv = len(cfg.wavlm.conv.layers) - 1
    batches, requests = wavllm_data(cfg, sz, seed)
    t0 = time.perf_counter()
    model = init_wavllm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                        param_dtype=torch.bfloat16, lora_b_std=WAVLLM_LORA_B_STD)
    _sync(dev)
    out = {"ok": False, "init_s": time.perf_counter() - t0,
           "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
           "sft_tokens": [[int(v) for v in b["target_tokens"].shape] for b in batches],
           "request_text_tokens": []}
    params = wavllm_recipe.freeze_for_sft(model)
    opt = wavllm_recipe.make_optimizer(params, WAVLLM_LR)
    on_dev = [wavllm_recipe.to_device(b, dev) for b in batches]
    if _cuda(dev):
        torch.cuda.reset_peak_memory_stats()
    counts, walls, losses = {}, [], []
    K.reset_launch_counts()
    for b in on_dev:
        t0 = time.perf_counter()
        losses.append(wavllm_recipe.sft_update(model, opt, b))
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    counts["sft"] = K.launch_counts()
    out.update(sft_losses=losses, sft_update_s=walls, sft_peak_gb=_peak_gb(dev))
    _finite(losses, "WavLLM SFT losses")
    if _cuda(dev):
        _expect(counts["sft"], {"conv_stack": len(on_dev) * n_conv}, "WavLLM SFT")
    opt.zero_grad(set_to_none=True)
    del opt
    model.eval()
    L = cfg.llama_layers
    steps = sz["max_new"] - 1
    for secs, req in zip(sz["requests_s"], requests):
        r = wavllm_recipe.to_device(req, dev)
        rec = {}
        # the first prefill warms the request's shapes up; the second is
        # the one the decode loops' times are taken against
        for method, max_new in (("prefill_warm", 1), ("prefill", 1),
                                ("greedy", sz["max_new"]), ("beam", sz["max_new"])):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            tokens, score = _wavllm_request(model, r, "beam" if method == "beam" else "greedy",
                                            max_new, sz["beam"])
            _sync(dev)
            wall = time.perf_counter() - t0
            c = counts[f"{method}_{secs}s"] = K.launch_counts()
            if _cuda(dev):
                _expect(c, {"conv_stack": n_conv, "flash_attention_bias":
                            cfg.wavlm.num_layers + (max_new - 1) * L,
                            "flash_attention_bias_tiled": cfg.wavlm.num_layers},
                        f"WavLLM {method} on {secs} s")
            if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
                raise AssertionError(f"WavLLM {method}: tokens out of the vocabulary")
            if score is not None:
                _finite(score.tolist(), f"WavLLM beam score on {secs} s")
            rec[method] = {"s": wall, "tokens": tokens[0, :12].tolist()}
            if method in ("greedy", "beam"):
                rec[method]["ms_per_step"] = (wall - rec["prefill"]["s"]) / steps * 1e3
                if _cuda(dev):
                    rec[method]["launches_per_step"] = (
                        c["flash_attention_bias"] - cfg.wavlm.num_layers) / steps
        out[f"request_{secs}s"] = rec
        out["request_text_tokens"].append(int(req["left_tokens"].shape[1]
                                              + req["prompt_tokens"].shape[1]))
        if _cuda(dev) and secs == sz["requests_s"][0]:
            out["step_profile"] = wavllm_step_profile(model, r)

    out.update(counts=counts, peak_gb=_peak_gb(dev), ok=True)
    log(json.dumps({"phase": "wavllm", **out}))
    del model
    torch.cuda.empty_cache()
    return out


def _wavllm_twins(tiny, device, seed, **kw):
    """The f32 model on the kernel route and on the plain route, the same
    weights, the trained parameters (``freeze_for_sft``) asking for
    gradients."""
    models = []
    for kernels in (True, False):
        cfg = wavllm_config("float32", kernels, tiny, **kw)
        m = init_wavllm(cfg, torch.Generator(device=device).manual_seed(seed), device,
                        lora_b_std=WAVLLM_LORA_B_STD)
        if models:
            m.load_state_dict(models[0].state_dict())
        wavllm_recipe.freeze_for_sft(m)
        models.append(m)
    return models


def _wavllm_loss_grads(model, b, scale=1.0):
    """``sft_loss`` in eval mode (no dropout: WavLM's attention on its
    kernel route when the flag is on) and its backward, the audio scaled by
    ``scale`` -> (loss, {name: gradient of each trained parameter})."""
    model.eval()
    loss = wavllm_recipe.sft_loss(model, dict(b, mel=b["mel"] * scale, wav=b["wav"] * scale))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_wavllm_parity(device="cuda", tiny=False, seed=0, logit_rtol=1e-4, loss_rtol=1e-4,
                        grad_rtol=1e-3, score_rtol=1e-4):
    """f32 on the card, the released widths at a cut depth (Whisper 4 and
    LLaMA 4 layers, WavLM's 12), every dropout off (eval mode), the same
    weights: the kernel route (WavLM's attention and the LLaMA decode step
    on ``flash_attention_bias``, the conv stack) against the plain route,
    for LoRA and LoRA-MoE (3 experts): ``forward_sft``'s logits (1e-4 of
    max |logit|), the SFT loss (1e-4) and every trained parameter's
    gradient (``grad_gate``: 1e-3 of its max |g|, or twice the plain
    route's own move under ``ULP_SCALE`` of the audio) on one SFT batch;
    greedy tokens equal and the beam's best hypothesis equal, its score
    within 1e-4, on the 10 s request."""
    sz = _wavllm_sizes(tiny)
    dev = torch.device(device)
    depth = {} if tiny else WAVLLM_PARITY_DEPTH
    cfg = wavllm_config("float32", True, tiny, **depth)
    (batch,), requests = wavllm_data(cfg, sz, seed + 7, n_batches=1)
    b = wavllm_recipe.to_device(batch, dev)
    r = wavllm_recipe.to_device(requests[0], dev)
    out = {"ok": False}
    for variant, kw in (("lora", {}), ("lora_moe", {"lora_moe": True, "n_experts": 3})):
        mk, mp = _wavllm_twins(tiny, dev, seed, **depth, **kw)
        args = (b["mel"], b["mel_lengths"], b["prompt_tokens"], b["target_tokens"], b["wav"],
                b["wav_lengths"], b["left_tokens"])
        with torch.no_grad():
            lk, lp = (m.forward_sft(*args)[0] for m in (mk, mp))
        rec = {"logits_rel_diff": ((lk - lp).abs().max() / lp.abs().max()).item()}
        if rec["logits_rel_diff"] > logit_rtol:
            raise AssertionError(f"WavLLM {variant}: forward_sft logits differ: {rec}")
        rec.update(_gate(f"WavLLM {variant} SFT", [
            _wavllm_loss_grads(mk, b), _wavllm_loss_grads(mp, b),
            _wavllm_loss_grads(mp, b, ULP_SCALE)], loss_rtol, grad_rtol))
        (gk, _), (gp, _) = (_wavllm_request(m, r, "greedy", sz["max_new"], sz["beam"])
                            for m in (mk, mp))
        (bk, sk), (bp, sp) = (_wavllm_request(m, r, "beam", sz["max_new"], sz["beam"])
                              for m in (mk, mp))
        rec.update(greedy_equal=torch.equal(gk, gp), beam_equal=torch.equal(bk, bp),
                   beam_score_rel_diff=((sk - sp).abs() / sp.abs()).max().item())
        if not (rec["greedy_equal"] and rec["beam_equal"]) or \
                rec["beam_score_rel_diff"] > score_rtol:
            raise AssertionError(f"WavLLM {variant}: decodes differ: {rec}, greedy "
                                 f"{gk.tolist()} vs {gp.tolist()}, beam {bk.tolist()} vs "
                                 f"{bp.tolist()}")
        out[variant] = rec
        del mk, mp
        torch.cuda.empty_cache()
    out["ok"] = True
    log(json.dumps({"phase": "wavllm_parity", **out}))
    return out


# ------------------------------------------------------------ phases 40-45
# the codec families at full width (bf16) and their f32 route parity
S2ST_REQUEST_S, S2ST_MAX_LEN, S2ST_UNITS = 3.0, 100, 1000
ENCODEC_S, ENCODEC_NQ = 10.0, (8, 32)
VALLEX_PHONEMES, VALLEX_PROMPT, VALLEX_MAX_NEW = 40, 225, 150   # the prompt: 3 s at 75 Hz
VIOLA_UNITS, VIOLA_TEXT, VIOLA_MAX_NEW = 150, 30, 64
PROSODY_TOKENS, PROSODY_STEPS, PROSODY_REF_S = 60, 60, 3.0
CODEC_PARITY_DEPTH = 2          # phase 45's layers a stack
CODEC_PARITY_STEPS = 8          # phase 45's teacher-forced decode steps
CODEC_TINY = dict(s2st_s=0.3, s2st_max_len=6, codec_s=0.2, nq=(2, 4), phonemes=6, prompt=5,
                  max_new=6, units=5, text=4, task_new=4, tokens=6, steps=4, ref_s=0.3)


def _codec_sizes(tiny: bool) -> dict:
    if tiny:
        return CODEC_TINY
    return dict(s2st_s=S2ST_REQUEST_S, s2st_max_len=S2ST_MAX_LEN, codec_s=ENCODEC_S,
                nq=ENCODEC_NQ, phonemes=VALLEX_PHONEMES, prompt=VALLEX_PROMPT,
                max_new=VALLEX_MAX_NEW, units=VIOLA_UNITS, text=VIOLA_TEXT,
                task_new=VIOLA_MAX_NEW, tokens=PROSODY_TOKENS, steps=PROSODY_STEPS,
                ref_s=PROSODY_REF_S)


def _depth(stack, depth):
    return stack if depth is None else C.replace(stack, num_layers=depth)


def s2st_config(dtype: str, kernels: bool, tiny: bool = False, depth=None):
    """Speech2S at ``SpeechUTConfig()``'s Base geometry with a
    ``S2ST_UNITS``-id decoder vocabulary (specials 0-4, units from 5;
    ``tiny``: the recipe's preset), its kernel flags on with ``kernels``,
    every dropout 0; ``depth``: the layers of each stack."""
    cfg = s2st_recipe.tiny_config() if tiny else SpeechUTConfig(text_vocab_size=S2ST_UNITS)
    cfg = C.replace(cfg, dtype=dtype, **{s: _depth(getattr(cfg, s), depth) for s in
                                         ("speech_encoder", "unit_encoder", "decoder")})
    return C.apply_overrides(cfg, (SUT_FLAGS if kernels else []) + sibling_still("speechut"))


def s2st_vocoder(cfg, tiny: bool, device, seed: int):
    """``CodeHiFiGANConfig()`` (hop 256) with the duration predictor, its
    table over the decoder vocabulary (``tiny``: the recipe's vocoder)."""
    vcfg = (s2st_recipe.vocoder_config(cfg.text_vocab_size) if tiny else
            CodeHiFiGANConfig(num_units=cfg.text_vocab_size, dur_predictor=True))
    return init_codehifigan(vcfg, torch.Generator().manual_seed(seed), device)


def _s2st_request(model, vocoder, wav, sz, device):
    """speech -> the units of the best beam (beam 5) -> the vocoder ->
    dict(units, beam result, steps, durations, waveform, walls)."""
    t0 = time.perf_counter()
    units, res, dec = s2st_recipe.decode_units(
        model, torch.from_numpy(wav[None]).to(device), torch.tensor([len(wav)]), beam=BEAM,
        max_len=sz["s2st_max_len"], device=device)
    _sync(device)
    t_beam = time.perf_counter() - t0
    with torch.no_grad():
        u = torch.tensor([units[0]], dtype=torch.int64, device=device)
        _, dur = vocoder.durations(vocoder.unit_embed(u), torch.ones_like(u, dtype=torch.bool))
        out = vocoder(u)
    _sync(device)
    return {"units": units[0], "res": res, "steps": dec.steps_run, "durations": dur[0],
            "wav": out[0], "beam_s": t_beam, "request_s": time.perf_counter() - t0}


def phase_s2st(device="cuda", tiny=False, seed=0):
    """Speech2S's S2ST chain (``recipes/speech2s_s2st``'s entry points) at
    ``SpeechUTConfig()``'s Base geometry (6 + 6 encoder and 6 decoder
    layers, a 1000-id unit vocabulary; bf16, every kernel flag on), random
    seeded weights: one 3 s request through the speech encoder (the conv
    stack, the inference attention), the beam over units (beam 5, max_len
    100, each step's self- and cross-attention on ``flash_attention_bias``),
    ``CodeHiFiGANConfig()`` with the duration predictor (f32) and
    ``write_wav``.  Launches exact: 6 conv launches, 12 x 2 attention
    launches, 12 decode-step launches a step.  Logged: the request wall,
    ms and launches a beam step, the waveform's buffer against its voiced
    length ``sum(durations) * 256``."""
    sz = _codec_sizes(tiny)
    dev = torch.device(device)
    cfg = s2st_config("bfloat16", True, tiny)
    model = init_speechut(cfg, card_generator(dev, seed), dev)
    vocoder = s2st_vocoder(cfg, tiny, dev, seed + 2)
    hop = math.prod(vocoder.cfg.generator.upsample_rates)
    wav = synth_audio(sz["s2st_s"], seed=600 + seed)
    K.reset_launch_counts()
    r = _s2st_request(model, vocoder, wav, sz, dev)
    counts = {"request": K.launch_counts()}
    if _cuda(dev):
        _expect(counts["request"], _beam_counts(cfg, cfg.speech_encoder.num_layers
                                                + cfg.unit_encoder.num_layers, r["steps"]),
                "S2ST request")
    voiced = int(r["durations"].sum()) * hop
    if r["wav"].shape[-1] != len(r["units"]) * vocoder.cfg.max_duration * hop or \
            not torch.isfinite(r["wav"]).all() or not 0 < voiced <= r["wav"].shape[-1]:
        raise AssertionError(f"S2ST waveform: {tuple(r['wav'].shape)}, voiced {voiced}")
    with tempfile.TemporaryDirectory() as d:
        out_wav = r["wav"][:voiced].float().cpu().numpy()
        write_wav(os.path.join(d, "s2st.wav"), out_wav / max(1e-6, float(np.abs(out_wav).max())))
    out = {"ok": True, "counts": counts, "request_s": r["request_s"], "beam_s": r["beam_s"],
           "beam_steps": r["steps"], "ms_per_step": r["beam_s"] / r["steps"] * 1e3,
           "units": len(r["units"]), "wav_samples": int(r["wav"].shape[-1]),
           "voiced_samples": voiced, "sum_durations_x_hop": voiced}
    if _cuda(dev):
        out["launches_per_step"] = counts["request"]["flash_attention_bias"] / r["steps"]
    log(json.dumps({"phase": "s2st", **out}))
    del model, vocoder
    torch.cuda.empty_cache()
    return out


def codec_config(tiny: bool, lm_cfg=None):
    """``encodec_24khz()``; ``tiny``: ``encodec_tiny``, with the codebooks
    of the codec LM config ``lm_cfg`` when given."""
    if not tiny:
        return encodec_24khz()
    if lm_cfg is None:
        return encodec_tiny()
    return encodec_tiny(num_quantizers=lm_cfg.n_codebooks, codebook_size=lm_cfg.codebook_size)


def phase_encodec(device="cuda", tiny=False, seed=0):
    """EnCodec at ``encodec_24khz()`` (f32; the LSTM on cuDNN), random
    seeded weights: 10 s of 24 kHz audio encoded at 8 and at 32 codebooks
    (1.5 and 6 kbps), each decoded back (after one untimed warm-up pass).
    No kernel on this path: every launch count 0.  Logged: the walls and
    the round-trip shapes."""
    sz = _codec_sizes(tiny)
    dev = torch.device(device)
    cfg = codec_config(tiny)
    model = init_encodec(cfg, torch.Generator().manual_seed(seed), dev)
    wav = torch.from_numpy(synth_audio(sz["codec_s"], seed=610 + seed,
                                       sr=cfg.sampling_rate)[None]).to(dev)
    with torch.no_grad():
        model.decode_codes(model.encode(wav[:, : 20 * cfg.hop_length], 2))
    K.reset_launch_counts()
    out = {"ok": False}
    for n_q in sz["nq"]:
        t0 = time.perf_counter()
        with torch.no_grad():
            codes = model.encode(wav, n_q)
            _sync(dev)
            t1 = time.perf_counter()
            rec = model.decode_codes(codes)
        _sync(dev)
        frames = wav.shape[-1] // cfg.hop_length
        if codes.shape != (1, n_q, frames) or rec.shape != (1, frames * cfg.hop_length) or \
                not torch.isfinite(rec).all() or int(codes.max()) >= cfg.codebook_size:
            raise AssertionError(f"EnCodec n_q {n_q}: codes {tuple(codes.shape)}, "
                                 f"waveform {tuple(rec.shape)}")
        out[f"nq{n_q}"] = {"encode_s": t1 - t0, "decode_s": time.perf_counter() - t1,
                           "codes": list(codes.shape), "wav": list(rec.shape)}
    counts = {"roundtrip": K.launch_counts()}
    _expect(counts["roundtrip"], {}, "EnCodec")
    out.update(ok=True, counts=counts, audio_samples=int(wav.shape[-1]))
    log(json.dumps({"phase": "encodec", **out}))
    del model
    torch.cuda.empty_cache()
    return out


def vallex_config(dtype: str, kernels: bool, tiny: bool = False, depth=None):
    """``VALLEXConfig()`` (12 + 12 pre-LN layers, d 1024, 16 heads, 8
    codebooks of 1024; ``tiny``: ``vallex_tiny``) at ``dtype``, the AR
    decode steps on ``flash_attention_bias`` with ``kernels``."""
    cfg = vallex_tiny() if tiny else VALLEXConfig()
    ar = C.replace(_depth(cfg.ar, depth), use_pallas_attn=kernels, dropout=0.0,
                   attention_dropout=0.0)
    nar = C.replace(_depth(cfg.nar, depth), dropout=0.0, attention_dropout=0.0)
    return C.replace(cfg, dtype=dtype, ar=ar, nar=nar)


def _codec_lm_inputs(cfg, sz, seed):
    rng = np.random.default_rng(seed)
    phonemes = torch.from_numpy(rng.integers(1, cfg.phoneme_vocab, (1, sz["phonemes"])))
    prompt = torch.from_numpy(rng.integers(0, cfg.codebook_size,
                                           (1, cfg.n_codebooks, sz["prompt"])))
    return phonemes, prompt


def phase_vallex(device="cuda", tiny=False, seed=0):
    """VALL-E X at ``VALLEXConfig()`` (bf16, random seeded weights drawn on
    the card): 40 phonemes and a 3 s acoustic prompt (225 codes of 8
    codebooks), ``VALLEX.synthesize``: the AR stage greedy to max_new 150
    (a causal prefill of the 266-slot prefix on the dense route, then one
    cached step a code, each layer's self-attention on
    ``flash_attention_bias``), then 7 NAR passes (plain attention, as in
    JAX), then EnCodec 24 kHz decodes the 8 codebooks of prompt +
    continuation.  Launches exact: 12 decode-step launches a step, nothing
    else.  Logged: ms an AR step (the synthesis less a timed prefill and a
    timed second run of the NAR passes, over its steps), launches a step,
    the NAR wall, the codec's wall."""
    sz = _codec_sizes(tiny)
    dev = torch.device(device)
    cfg = vallex_config("bfloat16", True, tiny)
    model = init_vallex(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    codec = init_encodec(codec_config(tiny, cfg), torch.Generator().manual_seed(seed + 7), dev)
    phonemes, prompt = (t.to(dev) for t in _codec_lm_inputs(cfg, sz, seed + 620))
    prefill = []
    for _ in range(2):        # a warm-up, then the timed prefill
        t0 = time.perf_counter()
        model.ar.generate(phonemes, prompt[:, 0], max_new=1)
        _sync(dev)
        prefill.append(time.perf_counter() - t0)
    K.reset_launch_counts()
    steps0 = model.ar.steps_run
    t0 = time.perf_counter()
    codes, lengths = model.synthesize(phonemes, prompt, max_new=sz["max_new"])
    _sync(dev)
    synth_s = time.perf_counter() - t0
    steps = model.ar.steps_run - steps0
    counts = {"synthesize": K.launch_counts()}
    if _cuda(dev):
        _expect(counts["synthesize"], {"flash_attention_bias": steps * cfg.ar.num_layers},
                "VALL-E X synthesize")
    valid = torch.arange(sz["max_new"], device=dev)[None] < lengths[:, None]
    t0 = time.perf_counter()
    with torch.no_grad():
        for j in range(1, cfg.n_codebooks):
            model.nar(phonemes, codes, j, code_valid=valid)
    _sync(dev)
    nar_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        wav = codec.decode_codes(torch.cat([prompt, codes], dim=-1))
    _sync(dev)
    codec_s = time.perf_counter() - t0
    n_frames = prompt.shape[-1] + sz["max_new"]
    if wav.shape != (1, n_frames * codec.cfg.hop_length) or not torch.isfinite(wav).all() \
            or int(codes.max()) >= cfg.codebook_size:
        raise AssertionError(f"VALL-E X: codes {tuple(codes.shape)}, wav {tuple(wav.shape)}")
    out = {"ok": True, "counts": counts, "prefill_s": prefill[1], "synthesize_s": synth_s,
           "ar_steps": steps, "length": int(lengths[0]), "nar_s": nar_s, "codec_s": codec_s,
           "ms_per_step": (synth_s - nar_s - prefill[1]) / max(steps, 1) * 1e3,
           "wav_samples": int(wav.shape[-1]), "codes": codes[0, :, :8].tolist()}
    if _cuda(dev):
        out["launches_per_step"] = counts["synthesize"]["flash_attention_bias"] / steps
    log(json.dumps({"phase": "vallex", **out}))
    del model, codec
    torch.cuda.empty_cache()
    return out


def viola_config(dtype: str, kernels: bool, tiny: bool = False, depth=None):
    """``VioLAConfig()`` (a 24-layer pre-LN trunk and a 12-layer NAR, d
    1024, 16 heads; ``tiny``: ``viola_tiny``) at ``dtype``, the trunk's
    decode steps on ``flash_attention_bias`` with ``kernels``."""
    cfg = viola_tiny() if tiny else VioLAConfig()
    trunk = C.replace(_depth(cfg.trunk, depth), use_pallas_attn=kernels, dropout=0.0,
                      attention_dropout=0.0)
    nar = C.replace(_depth(cfg.nar, depth), dropout=0.0, attention_dropout=0.0)
    return C.replace(cfg, dtype=dtype, trunk=trunk, nar=nar)


def viola_prefixes(cfg, sz, seed):
    """The three tasks' prefixes (numpy [1, n]): ASR from ``units``
    semantic units, MT and TTS from ``text`` text tokens; with TTS's
    ``allowed_range`` (the code block)."""
    rng = np.random.default_rng(seed)
    units = (cfg.unit0 + rng.integers(0, cfg.unit_vocab, sz["units"])).tolist()
    text = (cfg.text0 + rng.integers(0, cfg.text_vocab, sz["text"])).tolist()
    row = lambda lang, task, src: np.asarray(
        [[cfg.lang_id(lang), cfg.task_id(task), *src, cfg.sep_id]], np.int64)
    return {"asr": (row(0, "asr", units), {}), "mt": (row(1, "mt", text), {}),
            "tts": (row(0, "tts", text), {"allowed_range": (cfg.code0, cfg.total_vocab)})}


def viola_fill(model, prefix, tts_out, lengths):
    """The NAR fill of a TTS continuation: codebook 0 from the LM's codes,
    each other stage's argmax (``VALLEX.synthesize``'s rule) -> [1, K, T]."""
    cfg = model.cfg
    T = tts_out.shape[1]
    valid = torch.arange(T, device=tts_out.device)[None] < lengths[:, None]
    codes = torch.zeros((1, cfg.n_codebooks, T), dtype=torch.int64, device=tts_out.device)
    codes[:, 0] = (tts_out - cfg.code0).clamp(0, cfg.codebook_size - 1) * valid
    with torch.no_grad():
        for j in range(1, cfg.n_codebooks):
            codes[:, j] = model.nar_logits(prefix, codes, j, code_valid=valid).argmax(-1) * valid
    return codes


def phase_viola(device="cuda", tiny=False, seed=0):
    """VioLA at ``VioLAConfig()`` (bf16, random seeded weights drawn on the
    card): greedy ASR (150 units), MT and TTS (30 text tokens; TTS held to
    the code block) to max_new 64 each (a causal prefill, then one cached
    step a token, each trunk layer on ``flash_attention_bias``), the NAR
    fill of the TTS codes (7 passes) and an EnCodec 24 kHz decode of its 8
    codebooks.  Launches exact: 24 decode-step launches a step, nothing
    else.  Logged per task: the wall, a timed prefill, ms and launches a
    step."""
    sz = _codec_sizes(tiny)
    dev = torch.device(device)
    cfg = viola_config("bfloat16", True, tiny)
    model = init_viola(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    codec = init_encodec(codec_config(tiny, cfg), torch.Generator().manual_seed(seed + 11), dev)
    out, counts = {"ok": False}, {}
    for task, (prefix, kw) in viola_prefixes(cfg, sz, seed + 630).items():
        prefix = torch.from_numpy(prefix).to(dev)
        walls = []
        for max_new in (1, 1):       # a warm-up, then the timed prefill
            t0 = time.perf_counter()
            model.generate(prefix, max_new=max_new, **kw)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
        K.reset_launch_counts()
        steps0 = model.steps_run
        t0 = time.perf_counter()
        tokens, lengths = model.generate(prefix, max_new=sz["task_new"], **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
        steps = model.steps_run - steps0
        counts[task] = K.launch_counts()
        if _cuda(dev):
            _expect(counts[task], {"flash_attention_bias": steps * cfg.trunk.num_layers},
                    f"VioLA {task}")
        lo, hi = kw.get("allowed_range", (0, cfg.total_vocab))
        ok = (tokens == cfg.eos_id) | (tokens == cfg.pad_id) | ((tokens >= lo) & (tokens < hi))
        if not ok.all():
            raise AssertionError(f"VioLA {task}: tokens outside their block {tokens.tolist()}")
        out[task] = {"s": wall, "prefill_s": walls[1], "steps": steps,
                     "ms_per_step": (wall - walls[1]) / max(steps, 1) * 1e3,
                     "prefix": int(prefix.shape[1]), "tokens": tokens[0, :8].tolist()}
        if _cuda(dev):
            out[task]["launches_per_step"] = counts[task]["flash_attention_bias"] / steps
        if task == "tts":
            t0 = time.perf_counter()
            codes = viola_fill(model, prefix, tokens, lengths)
            with torch.no_grad():
                wav = codec.decode_codes(codes)
            _sync(dev)
            if wav.shape != (1, codes.shape[-1] * codec.cfg.hop_length) or \
                    not torch.isfinite(wav).all():
                raise AssertionError(f"VioLA TTS waveform {tuple(wav.shape)}")
            out["nar_and_codec_s"] = time.perf_counter() - t0
    out.update(ok=True, counts=counts)
    log(json.dumps({"phase": "viola", **out}))
    del model, codec
    torch.cuda.empty_cache()
    return out


def prosody_config(dtype: str, kernels: bool, tiny: bool = False, depth=None):
    """``speecht5_base`` (``tiny``: ``speecht5_tiny``) with its text
    encoder's inference attention and the decode steps on the kernels with
    ``kernels``, every dropout 0 but the Tacotron prenet's (always on, as
    served)."""
    cfg = C.speecht5_tiny() if tiny else C.speecht5_base()
    cfg = C.replace(cfg, dtype=dtype, encoder=_depth(cfg.encoder, depth),
                    decoder=_depth(cfg.decoder, depth))
    kernel_flags = ["encoder.use_pallas_attn=True", "decoder.use_pallas_attn=True"]
    return C.apply_overrides(cfg, (kernel_flags if kernels else []) + DETERMINISTIC)


def prosody_request(cfg, sz, seed, device):
    """A ``tokens``-token text (ids drawn from ``seed``, eos last), an
    x-vector and a reference log-mel of ``ref_s`` seconds (host numpy)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, cfg.vocab_size, (1, sz["tokens"]))
    tokens[0, -1] = cfg.eos_id
    spk = rng.standard_normal((1, cfg.spk_embed_dim)).astype(np.float32)
    ref = log_mel_numpy(synth_audio(sz["ref_s"], seed=seed + 1), n_mels=cfg.n_mels)
    ref = torch.from_numpy(ref[None]).to(device)
    return (torch.from_numpy(tokens).to(device), torch.from_numpy(spk).to(device), ref,
            torch.tensor([ref.shape[1]], device=device))


def prosody_model(cfg, tiny, device, seed):
    pcfg = ProsodyConfig(dim=8, conv_channels=16, n_convs=2, predictor_hidden=16) if tiny \
        else ProsodyConfig()
    model = init_prosody_speecht5(cfg, pcfg, card_generator(device, seed), device)
    with torch.no_grad():
        model.backbone.speech_decoder_postnet.prob_out.bias.fill_(TTS_STOP_BIAS)
    return model


def _prosody_tts(model, mode, request, sz, vocoder, device):
    tokens, spk, ref, ref_len = request
    target = model if mode == "predicted" else ProsodyTransfer(model, ref, ref_len)
    dec = TTSDecoder(target, max_frames=sz["steps"] * model.cfg.reduction_factor,
                     vocoder=vocoder, device=device)
    t0 = time.perf_counter()
    res = dec.text_to_speech(tokens, spk)
    _sync(device)
    return res, dec.steps_run, time.perf_counter() - t0


def phase_prosody(device="cuda", tiny=False, seed=0):
    """Prosody-SpeechT5 on ``speecht5_base`` with ``ProsodyConfig()`` (bf16,
    the text encoder's inference attention and the decode steps on the
    kernels), random seeded weights, the stop bias at ``TTS_STOP_BIAS``:
    ``TTSDecoder.text_to_speech`` of a 60-token text for 60 decode steps
    with the HiFi-GAN vocoder, under the predictor's prosody
    (``encode_text``) and under transfer from a 3 s reference log-mel
    (``ProsodyTransfer``: ``encode_text_ref``).  Launches exact, each mode
    as one /tts request (``tts_launches_expected``).  Logged: walls, ms a
    step."""
    sz = _codec_sizes(tiny)
    dev = torch.device(device)
    cfg = prosody_config("bfloat16", True, tiny)
    model = prosody_model(cfg, tiny, dev, seed)
    vocoder = tts_vocoder(cfg.n_mels, dev, cfg=HiFiGANConfig(in_dim=cfg.n_mels,
                                                             upsample_initial_channel=32)
                          if tiny else None)
    request = prosody_request(cfg, sz, seed + 640, dev)
    _prosody_tts(model, "predicted", request, {**sz, "steps": 4}, vocoder, dev)   # warm-up
    out, counts = {"ok": False}, {}
    for mode in ("predicted", "transfer"):
        K.reset_launch_counts()
        res, steps, wall = _prosody_tts(model, mode, request, sz, vocoder, dev)
        counts[mode] = K.launch_counts()
        if _cuda(dev):
            _expect(counts[mode], tts_launches_expected(cfg, steps), f"Prosody {mode}")
        if steps != sz["steps"] or not torch.isfinite(res.mel).all() or \
                not torch.isfinite(res.wav).all():
            raise AssertionError(f"Prosody {mode}: {steps} steps, mel finite "
                                 f"{bool(torch.isfinite(res.mel).all())}")
        out[mode] = {"s": wall, "steps": steps, "ms_per_step": wall / steps * 1e3,
                     "mel": list(res.mel.shape), "wav": list(res.wav.shape)}
    out.update(ok=True, counts=counts)
    log(json.dumps({"phase": "prosody", **out}))
    del model, vocoder
    torch.cuda.empty_cache()
    return out


def _twins(make, cfgs, seed, device):
    """The model at each config (the kernel route, the plain route), the
    second on the first's weights."""
    mk = make(cfgs[0], seed, device)
    mp = make(cfgs[1], seed, device)
    mp.load_state_dict(mk.state_dict())
    return mk, mp


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _gate_rel(what, value, tol):
    if not value <= tol:
        raise AssertionError(f"{what}: {value} > {tol}")
    return value


def _vallex_step_logits(model, phonemes, prompt0, codes0, n: int):
    """The AR stage's prefill and ``n`` cached steps teacher-forced on
    ``codes0`` -> logits [n + 1, B, V] (the steps' attention on the
    model's route)."""
    ar = model.ar
    B, Lp = phonemes.shape
    prev = torch.cat([torch.full((B, 1), ar.cfg.code_bos, device=prompt0.device), prompt0], 1)
    x, valid = ar._embed_seq(phonemes, prev)
    cache = ar.decoder.init_cache(None, B, x.shape[1] + n)
    sv = torch.cat([valid[:, :Lp], torch.ones((B, cache["layers"][0]["k"].shape[1] - Lp),
                                              dtype=torch.bool, device=x.device)], 1)
    with torch.no_grad():
        feats, cache = ar.decoder.decode_step(x, cache, self_valid=sv)
        out = [ar.out_proj(feats[:, -1].float())]
        for t in range(n):
            emb = ar.code_embed(codes0[:, t])[:, None].to(ar.dtype) + ar.pos.table[
                cache["index"] - Lp].to(ar.dtype)
            feats, cache = ar.decoder.decode_step(emb, cache, self_valid=sv)
            out.append(ar.out_proj(feats[:, 0].float()))
    return torch.stack(out)


def _viola_step_logits(model, prefix, tokens, n: int):
    cache = model.init_cache(1, prefix.shape[1] + n)
    sv = torch.ones((1, prefix.shape[1] + n), dtype=torch.bool, device=prefix.device)
    with torch.no_grad():
        logits, cache = model.decode_step(prefix, cache, self_valid=sv)
        out = [logits]
        for t in range(n):
            logits, cache = model.decode_step(tokens[:, t:t + 1], cache, self_valid=sv)
            out.append(logits)
    return torch.stack(out)


def phase_codec_families_parity(device="cuda", tiny=False, seed=0, logit_rtol=1e-4,
                                score_rtol=1e-4, wav_atol=2e-3, mel_atol=2e-3):
    """f32 on the card, each family at full width with 2 layers a stack,
    the kernel route against the plain route on the same weights: the S2ST
    beam's units equal (its best score within 1e-4 relative) and the
    vocoder's waveforms within 2e-3; VALL-E X's codes and lengths equal,
    its teacher-forced AR step logits and every NAR stage's logits within
    1e-4 of max; VioLA's three tasks' tokens equal and its trunk's step
    logits within 1e-4 of max; Prosody's TTS in both modes: lengths equal,
    mels, stop probabilities and waveforms within 2e-3."""
    sz = _codec_sizes(tiny)
    dev = torch.device(device)
    depth = None if tiny else CODEC_PARITY_DEPTH
    n = min(CODEC_PARITY_STEPS, sz["max_new"] - 1)
    out = {"ok": False}

    # S2ST: the beam over units, then the vocoder
    mk, mp = _twins(lambda c, s, d: init_speechut(c, card_generator(d, s), d),
                    [s2st_config("float32", k, tiny, depth) for k in (True, False)], seed, dev)
    vocoder = s2st_vocoder(mk.cfg, tiny, dev, seed + 2)
    psz = {**sz, "s2st_max_len": min(sz["s2st_max_len"], SIB_PARITY_MAX_LEN)}
    wav = synth_audio(sz["s2st_s"], seed=600 + seed)
    rk, rp = (_s2st_request(m, vocoder, wav, psz, dev) for m in (mk, mp))
    rec = _beam_gate("S2ST beam", rk["res"], rp["res"], 0.0, score_rtol)
    if rk["units"] != rp["units"]:
        raise AssertionError(f"S2ST units differ: {rk['units'][:20]} vs {rp['units'][:20]}")
    rec["wav_max_abs_diff"] = _gate_rel("S2ST waveform", (rk["wav"] - rp["wav"]).abs().max()
                                        .item(), wav_atol)
    out["s2st"] = rec
    del mk, mp, vocoder

    # VALL-E X: generate, the AR step logits, every NAR stage
    cfgs = [vallex_config("float32", k, tiny, depth) for k in (True, False)]
    mk, mp = _twins(lambda c, s, d: init_vallex(c, torch.Generator(device=d).manual_seed(s), d),
                    cfgs, seed, dev)
    phonemes, prompt = (t.to(dev) for t in _codec_lm_inputs(cfgs[0], sz, seed + 620))
    (ck, lk), (cp, lp) = (m.ar.generate(phonemes, prompt[:, 0], max_new=sz["max_new"])
                          for m in (mk, mp))
    if not (torch.equal(ck, cp) and torch.equal(lk, lp)):
        raise AssertionError(f"VALL-E X codes differ: {ck.tolist()} vs {cp.tolist()}")
    lgk, lgp = (_vallex_step_logits(m, phonemes, prompt[:, 0], cp, n) for m in (mk, mp))
    rec = {"ar_logits_rel": _gate_rel("VALL-E X AR step logits", _rel(lgk, lgp), logit_rtol)}
    with torch.no_grad():
        rec["nar_logits_rel"] = max(_gate_rel(f"VALL-E X NAR stage {j}", _rel(
            mk.nar(phonemes, prompt, j), mp.nar(phonemes, prompt, j)), logit_rtol)
            for j in range(1, cfgs[0].n_codebooks))
    out["vallex"] = {**rec, "codes_equal": True, "steps": n}
    del mk, mp

    # VioLA: the three tasks' tokens, the trunk's step logits
    cfgs = [viola_config("float32", k, tiny, depth) for k in (True, False)]
    mk, mp = _twins(lambda c, s, d: init_viola(c, torch.Generator(device=d).manual_seed(s), d),
                    cfgs, seed, dev)
    rec = {}
    for task, (prefix, kw) in viola_prefixes(cfgs[0], sz, seed + 630).items():
        prefix = torch.from_numpy(prefix).to(dev)
        (tk, lk), (tp, lp) = (m.generate(prefix, max_new=sz["task_new"], **kw)
                              for m in (mk, mp))
        if not (torch.equal(tk, tp) and torch.equal(lk, lp)):
            raise AssertionError(f"VioLA {task} tokens differ: {tk.tolist()} vs {tp.tolist()}")
        lgk, lgp = (_viola_step_logits(m, prefix, tp, min(n, tp.shape[1])) for m in (mk, mp))
        rec[task] = _gate_rel(f"VioLA {task} step logits", _rel(lgk, lgp), logit_rtol)
    out["viola"] = {"step_logits_rel": rec, "tokens_equal": True}
    del mk, mp

    # Prosody: TTS under both modes
    cfgs = [prosody_config("float32", k, tiny, depth) for k in (True, False)]
    mk, mp = _twins(lambda c, s, d: prosody_model(c, tiny, d, s), cfgs, seed, dev)
    vocoder = tts_vocoder(cfgs[0].n_mels, dev, cfg=HiFiGANConfig(
        in_dim=cfgs[0].n_mels, upsample_initial_channel=32) if tiny else None)
    request = prosody_request(cfgs[0], sz, seed + 640, dev)
    rec = {}
    for mode in ("predicted", "transfer"):
        (a, _, _), (b, _, _) = (_prosody_tts(m, mode, request, sz, vocoder, dev)
                                for m in (mk, mp))
        if not torch.equal(a.lengths, b.lengths):
            raise AssertionError(f"Prosody {mode}: lengths {a.lengths} vs {b.lengths}")
        rec[mode] = {f: _gate_rel(f"Prosody {mode} {f}", (getattr(a, f) - getattr(b, f)).abs()
                                  .max().item(), tol)
                     for f, tol in (("mel", mel_atol), ("stop_probs", mel_atol),
                                    ("wav", wav_atol))}
    out["prosody"] = rec
    del mk, mp, vocoder
    torch.cuda.empty_cache()
    out["ok"] = True
    log(json.dumps({"phase": "codec_families_parity", **out}))
    return out


def kernels_line(records, counts, by_path=None):
    """The contract line: each kernel's path case (MAIN_CASE) in the named
    keys, the other cases under "other"; ``launches`` from the runs of the
    paths that drive the kernel (``counts``, summed over the paths), and
    per path under "launches_by_path".  ``flash_attention_bias``'s own
    count holds its tiled kernel's launches too: its entry gives the split
    kernel's share."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tolerance")
    rates = ("bound_share", "achieved_tflops",      # the redesigned kernels'
             "parts_ms", "graph_ms", "library_graph_ms", "bound_share_graph",
             "max_prob_err", "max_prob_tolerance",   # the TTS cross step's output
             "without_max_prob_ms", "without_max_prob_graph_ms", "path")
    own = lambda c, name: c[name] - (c["flash_attention_bias_tiled"]
                                     if name == "flash_attention_bias" else 0)
    out = []
    for name, meta in KERNELS.items():
        main = records[name][MAIN_CASE[name]]
        out.append({
            "name": name, "route": "cuda", "impl": "cuda", **meta,
            "launches": own(counts, name), **{k: main[k] for k in keys},
            **{k: main[k] for k in rates if k in main},
            "launches_by_path": {p: own(c, name) for p, c in (by_path or {}).items()},
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


def _wall(walls, name, t0):
    """Record phase ``name``'s wall since ``t0`` and log it at once, so that
    a run the watchdog ends still shows where its time went."""
    walls[name] = time.perf_counter() - t0
    log(json.dumps({"phase_wall": name, "seconds": walls[name]}))


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
    _wall(walls, "build", t0)

    t0 = time.perf_counter()
    records = phase_kernels()
    _wall(walls, "kernels", t0)

    base = C.speecht5_base_asr()
    t0 = time.perf_counter()
    served = phase_serve(base)
    _wall(walls, "serve", t0)
    log(json.dumps({"phase": "serve", "launches": served["counts"]}))
    missing = [n for n in ("banded_flash_attention", "conv_stack")
               if served["counts"][n] == 0]
    if missing:
        raise AssertionError(f"serving path never launched {missing}")

    t0 = time.perf_counter()
    phase_parity(base)
    _wall(walls, "parity", t0)

    t0 = time.perf_counter()
    beam = phase_serve_beam(base, requests_s=BEAM_REQUESTS_S[:1], buckets=BEAM_BUCKETS)
    _wall(walls, "serve_beam", t0)
    log(json.dumps({"phase": "serve_beam", "launches": beam["counts"]}))

    t0 = time.perf_counter()
    phase_beam_parity(base, requests_s=BEAM_REQUESTS_S[:1], buckets=BEAM_BUCKETS,
                      max_len=SIB_PARITY_MAX_LEN)
    _wall(walls, "beam_parity", t0)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        trained = phase_train(d)
        _wall(walls, "train", t0)
        t0 = time.perf_counter()
        ev = phase_evaluate(d, trained["args"], updates=3)["counts"]
        _wall(walls, "evaluate", t0)
        t0 = time.perf_counter()
        peval = phase_parallel_evaluate(d)
        _wall(walls, "parallel_evaluate", t0)
        t0 = time.perf_counter()
        phase_parallel_wrapper(trained["args"], d)
        _wall(walls, "parallel_wrapper", t0)
    missing = [n for n in ("banded_flash_attention", "conv_stack", "flash_attention_bias")
               if ev[n] == 0]
    if missing:
        raise AssertionError(f"evaluate never launched {missing}: {ev}")
    t0 = time.perf_counter()
    sweep = phase_parity_sweep()["counts"]
    _wall(walls, "parity_sweep", t0)
    missing = [n for n in ("banded_flash_attention", "conv_stack", "flash_attention_bias")
               if sweep[n] == 0]
    if missing:
        raise AssertionError(f"the parity sweep never launched {missing}: {sweep}")
    tc = trained["counts"]
    if tc["banded_flash_attention"] != 0 or tc["conv_stack"] == 0:
        raise AssertionError(f"train path launches wrong: {tc}")
    check_train_counts(tc, trained["layer_runs"], "encoder")
    if not all(math.isfinite(v) for r in trained["history"] for v in r.values()):
        raise AssertionError("non-finite train metrics")

    t0 = time.perf_counter()
    phase_train_parity(base)
    _wall(walls, "train_parity", t0)

    t0 = time.perf_counter()
    ptrain = phase_parallel_train(updates=PARALLEL_UPDATES)
    _wall(walls, "parallel_train", t0)

    t0 = time.perf_counter()
    t2s = phase_train_t2s()
    _wall(walls, "train_t2s", t0)
    check_t2s_counts(t2s)

    t0 = time.perf_counter()
    phase_t2s_parity(C.speecht5_base())
    _wall(walls, "t2s_parity", t0)

    t0 = time.perf_counter()
    warm = phase_warm_start(updates=WARM_UPDATES)
    _wall(walls, "warm_start", t0)
    check_train_counts(warm["train_counts"], warm["layer_runs"], "warm-started encoder")
    wsc = warm["serve_counts"]
    if wsc["banded_flash_attention"] != base.encoder.num_layers * K.fwd_launches(
            torch.bfloat16) or wsc["conv_stack"] != len(base.conv_features.layers) - 1:
        raise AssertionError(f"greedy request from the converted checkpoint: {wsc}")

    t0 = time.perf_counter()
    tts = phase_serve_tts(C.speecht5_base())
    _wall(walls, "serve_tts", t0)
    log(json.dumps({"phase": "serve_tts", "launches": tts["counts"]}))

    t0 = time.perf_counter()
    phase_tts_parity(C.speecht5_base())
    _wall(walls, "tts_parity", t0)

    t0 = time.perf_counter()
    s2s = phase_train_s2s()
    _wall(walls, "train_s2s", t0)
    check_speech_train_counts(s2s, C.speecht5_base(), 1, "s2s")

    t0 = time.perf_counter()
    phase_s2s_parity(C.speecht5_base())
    _wall(walls, "s2s_parity", t0)

    t0 = time.perf_counter()
    vc = phase_vc_decode(C.speecht5_base(), requests=1, max_frames=VC_MAX_FRAMES)
    _wall(walls, "vc_decode", t0)

    t0 = time.perf_counter()
    s2c = phase_train_s2c()
    _wall(walls, "train_s2c", t0)
    check_speech_train_counts(s2c, C.speecht5_base_sid(), 0, "s2c")

    t0 = time.perf_counter()
    sid = phase_s2c_parity(C.speecht5_base_sid(num_classes=SID_SPEAKERS))
    _wall(walls, "s2c_parity", t0)

    t0 = time.perf_counter()
    rescore = phase_serve_rescore(base)
    _wall(walls, "serve_rescore", t0)

    t0 = time.perf_counter()
    phase_rescore_parity(base)
    _wall(walls, "rescore_parity", t0)

    t0 = time.perf_counter()
    beam_lm = phase_beam_lm(base, requests_s=LARGE_REQUESTS_S[:1], max_len=BEAM_LM_MAX_LEN)
    _wall(walls, "beam_lm", t0)

    t0 = time.perf_counter()
    phase_beam_lm_parity(base)
    _wall(walls, "beam_lm_parity", t0)

    t0 = time.perf_counter()
    pre = phase_train_pretrain_large()
    _wall(walls, "train_pretrain_large", t0)

    t0 = time.perf_counter()
    phase_pretrain_parity()
    _wall(walls, "pretrain_parity", t0)

    large = C.speecht5_large()
    t0 = time.perf_counter()
    served_large = phase_serve(large, requests_s=LARGE_REQUESTS_S, chunked=False)
    log(json.dumps({"phase": "serve_large", "launches": served_large["counts"]}))
    want = {**dict.fromkeys(KERNELS, 0), "banded_flash_attention": len(LARGE_REQUESTS_S)
            * large.encoder.num_layers * K.fwd_launches(torch.bfloat16)}
    if served_large["counts"] != want:
        raise AssertionError(f"Large greedy launches {served_large['counts']}, want {want}")
    beam_large = phase_serve_beam(large, requests_s=LARGE_REQUESTS_S[:1], buckets=BEAM_BUCKETS)
    log(json.dumps({"phase": "serve_beam_large", "launches": beam_large["counts"]}))
    _wall(walls, "serve_large", t0)

    t0 = time.perf_counter()
    phase_parity(large, requests_s=LARGE_REQUESTS_S[:1], buckets=LARGE_PARITY_BUCKETS)
    phase_beam_parity(large, requests_s=LARGE_REQUESTS_S[:1], buckets=BEAM_BUCKETS,
                      max_len=SIB_PARITY_MAX_LEN)
    _wall(walls, "large_parity", t0)

    t0 = time.perf_counter()
    slm = phase_speechlm()
    _wall(walls, "speechlm", t0)

    t0 = time.perf_counter()
    sut = phase_speechut()
    _wall(walls, "speechut", t0)

    t0 = time.perf_counter()
    s2c_pre = phase_speech2c()
    _wall(walls, "speech2c", t0)

    t0 = time.perf_counter()
    phase_siblings_parity()
    _wall(walls, "siblings_parity", t0)

    t0 = time.perf_counter()
    yit = phase_yitrans()
    _wall(walls, "yitrans", t0)

    t0 = time.perf_counter()
    vat = phase_vatlm()
    _wall(walls, "vatlm", t0)

    t0 = time.perf_counter()
    phase_yitrans_vatlm_parity()
    _wall(walls, "yitrans_vatlm_parity", t0)

    t0 = time.perf_counter()
    wavllm = phase_wavllm()
    _wall(walls, "wavllm", t0)

    t0 = time.perf_counter()
    phase_wavllm_parity()
    _wall(walls, "wavllm_parity", t0)

    codec_paths = {}
    for name, phase in (("s2st", phase_s2st), ("encodec", phase_encodec),
                        ("vallex", phase_vallex), ("viola", phase_viola),
                        ("prosody", phase_prosody)):
        t0 = time.perf_counter()
        codec_paths[name] = phase()["counts"]
        _wall(walls, name, t0)
    t0 = time.perf_counter()
    phase_codec_families_parity()
    _wall(walls, "codec_families_parity", t0)

    walls["total"] = time.perf_counter() - t_start
    log(json.dumps({"phase_seconds": walls, "card": card_line()}))
    by_path = {"serve": served["counts"], "serve_beam": beam["counts"],
               "train_s2t": tc, "train_t2s": t2s["counts"],
               "warm_start_train": warm["train_counts"],
               "warm_start_serve": wsc, "serve_tts": tts["counts"],
               "train_s2s": s2s["counts"], "vc_decode": vc["counts"],
               "train_s2c": s2c["counts"], "sid_inference": sid["counts"],
               "evaluate": ev, "parity_sweep": sweep,
               "serve_rescore": rescore["open"]["counts"],
               "serve_rescore_lexicon": rescore["lexicon"]["counts"],
               "beam_lm": beam_lm["counts"], "train_pretrain_large": pre["counts"],
               "serve_large": served_large["counts"],
               "serve_beam_large": beam_large["counts"],
               **{f"parallel_train_{m}_rank{r}": c for m, rec in ptrain["modes"].items()
                  for r, c in enumerate(rec["counts"])},
               **{f"parallel_evaluate_rank{r}": c for r, c in enumerate(peval["counts"])},
               **{f"speechlm_{k}": c for k, c in slm["counts"].items()},
               **{f"speechut_{k}": c for k, c in sut["counts"].items()},
               **{f"speech2c_{k}": c for k, c in s2c_pre["counts"].items()},
               **{f"yitrans_{k}": c for k, c in yit["counts"].items()},
               **{f"vatlm_{k}": c for k, c in vat["counts"].items()},
               **{f"wavllm_{k}": c for k, c in wavllm["counts"].items()},
               **{f"{fam}_{k}": c for fam, cs in codec_paths.items() for k, c in cs.items()}}
    counts = {n: sum(c[n] for c in by_path.values()) for n in KERNELS}
    log(json.dumps(kernels_line(records, counts, by_path)))
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
