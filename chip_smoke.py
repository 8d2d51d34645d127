#!/usr/bin/env python3
"""Drive the PyTorch port (``audiocraft_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

1. Card and build: prints the card's name and power limit, builds the CUDA
   kernels from ``audiocraft_tpu_torch/csrc`` and prints the build time;
   the attention route's widest head must equal the kernels'.
2. Kernels against their plain PyTorch versions, on the card, at the main
   paths' shapes: RVQ encode (codes equal, near-ties excluded and counted,
   D from 32 to 1024), one LSTM layer (fp32 and bf16; one cooperative
   launch a layer, timed at B = 128 and B = 4 beside cuDNN) and the flash
   attention forward K3f (fp32 and bf16, causal and not, at MAGNeT-small's
   [8, 1500, 16, 64], causal at the training shape [4, 1501, 16, 64], off
   the tiles, on peaked rows, on views the bf16 wrapper copies or pads and
   on the fused qkv slices it must pass uncopied; heads of 256 take the
   plain path), each timed beside
   its bound, its plain version and, where one exists, one PyTorch call
   computing the same thing.
3. The codec path: ``get_encodec_32khz()`` (bf16, random weights from a
   seed) tokenizes and reconstructs 128 clips of 10 s on its default route,
   the fused route (the input conv through K5, two encoder stages through
   K4); K1, K2, K4 and K5 must launch during that run.  The breakdown is the
   module stack's, layer by layer.
4. fp32 codec parity: the same weights with ``compute_dtype=None`` on the
   card and on the CPU (plain versions), with torch's default TF32 flags:
   the codec turns cuDNN's TF32 off itself.  Then the fp32 parity path at
   b16 x 10 s: the card's default route (K5, then K4's register-tiled fp32
   kernel twice, counted: the ``kernels`` line's ``launches`` of
   ``fused_stage_fp32``) and the module stack, both timed, the fused and
   module-stack codes of rows 0-1 equal to the CPU's but at near-ties.
5. The MAGNeT path: ``get_magnet_lm('small', segment_duration=30)`` with its
   T5-base conditioning (bf16, random weights from a seed) generates 30 s for
   4 seeded descriptions with CFG, and the 32 kHz codec decodes them; every
   stage-0 self-attention must go through the attention kernel and the
   decode through the LSTM kernel.  Then the debug MAGNeT facade generates
   from a text prompt on the card.
6. MAGNeT parity: the same LM in fp32 (TF32 off), one stage-0 forward
   through the attention kernel against the plain path, and the greedy
   token match of a generate on each route (K3f's fp32 kernel: the
   ``launches`` of ``flash_attention_fp32``).
7. The training path: ``get_musicgen_lm('small')`` (published widths, 24
   layers, random weights from a seed) trains with AdamW in bf16 compute on
   fp32 masters, each step encoding 4 clips of 30 s with
   ``get_encodec_32khz()``; every self-attention must run the flash forward
   and both backward kernels, the loss must fall, and every parameter must
   get a finite, non-zero gradient.  A profiled step prints the device's
   busy time and the host's: operators by self time, dtype copies and
   optimizer calls.  Then the fp32 LM step, the training CLI's default
   dtype, on the same batch: one warm-up and two timed steps, each
   launching K3f fp32 and both K3b fp32 kernels once a layer (K3b fp32:
   the ``launches`` of ``flash_attention_bwd_*_fp32``), its ms, peak memory
   and K3b fp32's share of it (the two kernels' device time in one more
   step under torch.profiler); the model's state is restored after.  Then
   the training CLI takes two debug steps on the card.
8. Training parity in fp32 (TF32 off): loss and every gradient of the
   kernel route against the plain route, then three AdamW steps on each;
   and the bf16-compute gradients of both routes on the same batch.
9. The encode routes: ``get_encodec_32khz()`` encodes 128 clips of 10 s
   three times on each route, the module stack (``fused=False``), the fused
   route with K5 as its input conv (the default on the card) and
   ``conv0_kernel`` alone (``fused=False, conv0_kernel=True``); K4 must
   launch twice and K5 once per fused encode, K5 once per ``conv0_kernel``
   encode, K1 once and K2 twice per encode on every route; each route's bf16
   latent is held against the module stack's (3e-2), and the fp32 codes and
   latent of the fused and K5 routes against the module stack on the CPU.
   Then every route (and the fused route with cuDNN's input conv, the
   earlier default's) timed at every encode shape this script runs.
10. The data-movement probe (P1): ``apps/probe_ops`` runs its seven bf16
   operations on the card, each of which must equal torch's result (6
   gather and 1 contraction launches).  Then each operation's kernel, the
   torch call that copies the same result (``clone()`` of the view,
   ``torch.matmul``) and its plain version, by device time per launch
   (torch.profiler over 100 launches) and host time per call (1000 calls,
   no synchronize between), beside the gather kernel's launch floor at [1,
   1]; the same at 2048x the probe's rows, past the L2, beside the bytes
   bound (TB/s, fraction of it); every kernel equal to plain there and on
   ragged shapes (flat counts off 8, odd strides, a column stride of 3).
11. The MusicGen path: ``get_musicgen('small')`` (random weights from a
   seed, the LM decoding in bf16) generates 30 s for 4 seeded descriptions
   with 1-pass CFG and top-k sampling, its decode steps replayed as CUDA
   graphs, and the codec decodes them (K2 twice); the capture, generate and
   decode times, steps/s, tokens/s, audio-s/s, the KV-cache bytes and peak
   memory are printed, beside the step's eager host and device ms, the
   replayed step's ms, the device's idle share over replays and the
   attention's and heads' part of a step.
   Then ``optimize_for_serving()`` on a copy of the LM, stride extension to
   45 s at B = 1 (two windows; the tokens decoded in windows, K2 in the
   head once), and the debug facade's public ``generate``,
   ``generate_unconditional`` and ``generate_continuation`` (decoded in
   windows); the graph route over 4 x 10 s against the eager loop's whole
   generate (the graph's must be faster).  Parity in fp32 (TF32 off) at
   the published widths on the first 4 of the 24 layers over 2 s: the graph
   route's greedy and sampled tokens equal the eager loop's, the cached
   steps' logits the cache-free forward's within 1e-4 relative, and the
   card's greedy tokens the CPU's, or differ first at a near-tie.
12. Stereo and streaming: the stereo wrapper over ``get_encodec_32khz()``
   tokenizes and reconstructs 64 stereo clips of 10 s (the mono codec at
   b128), its codes equal to the mono codec's of each channel;
   ``get_musicgen('small', stereo=True)`` generates 10 s for 4 seeded
   descriptions (1-pass CFG, top-k 250, bf16, CUDA graph steps) into
   [4, 2, 320000] audio, and in fp32 its greedy tokens at 1 s equal the
   CPU's; the causal ``get_encodec_24khz()`` streams 16 clips of 10 s in 1 s
   chunks through ``CodecStreamer`` both ways (K2 from a carried (h, c)),
   held to the whole-signal encode and decode in fp32.
13. Melody and style: the chroma extractor at 10 s on the card against the
   CPU (and every seeded note at its pitch class);
   ``get_musicgen('medium', melody=True)`` (published widths, bf16 decode,
   CUDA graph steps) generates 10 s for 2 seeded descriptions, each with a
   seeded 10 s melody, behind the 938-frame chroma prefix (K2 twice, in the
   decode); two generates in one decode cache with other melodies give a
   fresh cache's tokens; fp32 greedy tokens at 1 s on 4 of the 48 layers
   equal the CPU's; ``generate_music_segments`` extends a 20 s melody in
   10 s segments with 1 s of overlap (K5, K4, K1 and K2 in each
   continuation's prompt encode), stitched, written with ``audio_write``
   and read back.  Then ``get_musicgen('medium', style=True)``: its style
   embeddings (the fp32 codec through K5, K4's fp32 variant, K2 and K1,
   then K1 in the bottleneck) against the CPU's (1e-4), the bottleneck
   codes equal but at near-ties, K1 at D = 512, K = 1024, n_q = 3, K4 fp32
   (its register-tiled kernel: beside the cuDNN module stack, the bound and
   its per-phase split) and K2 fp32 at the 3 s excerpt against their plain
   versions and timed,
   and a double-CFG generate of 10 s for 2 descriptions with 10 s clips.
14. Codec training: ``get_encodec_32khz()`` from fresh codebooks (k-means
   on the first batch) against ``MultiScaleSTFTDiscriminator()``, the JAX
   CLI's defaults (8 x 1 s, Adam 3e-4, the balancer's weights, bf16
   compute on fp32 masters): the GAN step and the reconstruction step, 3
   warm-up and 10 timed steps each, by CUDA events per part and by the
   host clock, with audio-s trained/s, peak memory and the device's idle
   share under the profiler; no forward-only kernel may launch, every LSTM
   weight must get a gradient and every loss be finite; codebook usage is
   printed.  Then one fp32 GAN step at 2 x 0.5 s on the card and on the
   CPU (losses within 1e-4 relative, codes equal but at near-ties, the EMA
   state within 1e-5, gradients within 1e-3 in global norm); on a
   world-size-1 NCCL group the GAN step equals the step alone bit for bit
   and the data-parallel LM step (``make_lm_train_step`` with the group) at
   MusicGen-small widths (2 x 10 s) equals the step alone, through K3f and
   K3b, as does the step with
   per-layer checkpointing (K3f again in the backward); K2, K4 and K5
   refuse a grad-requiring input.
15. HTDemucs, JASCO and the joint embedding: ``get_htdemucs()`` at the
   published htdemucs widths (fp32, cuDNN's TF32 off) against the CPU on a
   1 s mix (1e-4), one 7.8 s window and a 30 s mix in six windows timed
   (audio-s/s, peak memory, kernels under the profiler); MusicGen-melody's
   chroma conditioner on a 10 s melody with and without the vocals and
   other stems; ``get_jasco_model()`` at its defaults: 2 samples x 10 s
   with 3 CFG terms, the drums separated by Demucs and encoded by the 32
   kHz codec (K5, K4 twice, K2 twice, K1; K1 against plain at the drum
   rows), K3f at [6, 500, 8, 64] fp32 against plain, SDPA and its bound,
   one vector-field evaluation on the K3f route (8 launches) against the
   plain route (1e-5) and the CPU (1e-4), the 100-step Euler generate on
   each route (800 launches; 1e-3), one dopri5 generate with its steps and
   host reads; ``JointEmbeddingConditioner(512, 1536)`` on 8 rows, K1 once
   at N = 8, D = 512, K = 1024, n_q = 12, codes equal to plain.  The
   ``kernels`` line gives each kernel's phase-15 counts beside the main
   path's: ``launches_jasco`` (the drums encode and the Euler generate on
   the K3f route) and ``launches_joint_embed``.
16. Pod, the model group, MultiBand-Diffusion, the metrics, rope: one 1 x
   120 s file through ``pod_encode`` / ``pod_decode`` on a world-size-1
   NCCL group with ``get_encodec_32khz()`` (fp32 codes equal the module
   stack's encode of the padded signal but at near-ties, the waveform within
   1e-5 of decode; bf16 timed beside encode and decode; K2 2 + 2, K1 1);
   ``get_musicgen_lm('large')`` in bf16 sharded by ``shard_lm`` over the
   group's model group (``make_mesh(1, 1)``), 2 x 10 s of codes with T5
   conditions: logits bit-equal to the unsharded forward, K3f 48 times, one
   all-reduce timed, the device's busy time under the profiler;
   one ``DiffusionUnet`` and ``NoiseSchedule()`` a band and the
   ``MultiBandProcessor`` (stand-in widths, fp32) conditioned on the
   32 kHz codec's latent of 4 x 10 s of codes: a UNet forward card vs CPU
   (1e-4), the BLSTM variant's K2 against plain (1e-4), the 4-band reverse
   process of 80 UNet calls timed; codec-FAD and codec-KLD of 8 + 8 clips
   of 10 s, fp32 card vs CPU (FAD and ``chroma_cosine`` 1e-4, codes equal
   but at near-ties); MusicGen-small's widths with rope and ``kv_repeat=2``:
   K3f (24) against plain (1e-4), 2 x 10 s generated through replayed
   graphs, the step beside its byte bound, fp32 greedy tokens at 2 s on the
   first 4 of the 24 layers equal the CPU's but at near-ties.  The
   ``kernels`` line gives each kernel's
   phase-16 counts: ``launches_pod``, ``launches_tp``,
   ``launches_diffusion``, ``launches_metrics`` and ``launches_rope``.
17. Checkpoints: MusicGen-small and the 32 kHz codec, seeded, written as a
   reference export and imported by ``apps/import_checkpoint``, then as an
   HF snapshot converted by ``get_pretrained`` and loaded again from the
   cache by ``load_model``; the loaded state, codes, greedy tokens and fp32
   logits against the originals (``launches_ckpt``).
18. Data to tokens: a corpus of 12 mono WAVs of 25-40 s at 32 kHz and a
   stereo WAV of 20 s at 44.1 kHz (and a FLAC and an MP3 copy where the
   native audio library loads; the line ``native audio: ...`` says whether
   it does) through ``apps/tokenize`` in batches of 32 rows x 10 s with a
   checkpoint of the seeded 32 kHz codec: K1, K2, K4 and K5 launch once,
   twice, twice and once a batch (``launches_data``), the npz codes equal
   the codec's own encode of the rows the CLI built, 8 rows of batch 0 in
   fp32 equal the CPU's codes but at near-ties, and the pipeline's
   audio-s/s, the host's load time a batch, the card's busy share under the profiler and
   the bare encode at b128 x 10 s through ``obs.chained_throughput`` are
   printed; ``--chunk`` and ``--pod`` over one 120 s file in fp32 against
   the whole-signal encode; ``apps/eval_codec`` on 4 batches of 8 x 1 s
   (finite metrics, the bitrate, the codebook statistics of ``encode``'s
   codes); two steps of ``train_encodec --debug`` from the corpus.
19. Serving: MusicGen-small at its published widths (seeded weights, the
   decode in bf16) written as a checkpoint directory, loaded by
   ``load_model`` and served by ``apps/serve``'s ``GenerationService``
   behind a ``ThreadingHTTPServer`` on 127.0.0.1 (continuous batching:
   a 200 ms window, at most 4 a batch): ``/health`` and ``/models``; three
   concurrent 5 s text requests coalesced into one facade call at bucket 4
   (K2 twice) while other threads poll ``/health`` (the decode captures its
   CUDA graphs on the batcher's thread; nothing else touches the card); a
   continuation from a 2 s WAV prompt (K5 1, K4 2, K2 4, K1 1); a greedy
   request whose WAV equals a direct ``generate`` of the same text; a bad
   duration (400) and an unknown model (404).  Each request's seconds to
   its body, the batch's audio-s/s and the peak memory are printed.  Then
   ``apps/generate`` (10 s), ``apps/batch_generate`` (4 prompts in one
   batch) and ``apps/scale_bench`` (one card, b8 x 10 s, on its
   ``get_encodec_32khz()``, the codebooks seeded) once each; whether the
   video muxer loads is printed (``launches_serve``).
Every random-weight codec that encodes or decodes (phases 3-13, 15-19) has its
codebooks seeded from its own latents first (``seed_codebooks``): a fresh
codebook is zeros, as the JAX package's ``kmeans_init`` makes it.
Phase 2 also holds K3b (the attention backward, both dtypes, at the model
shapes, phase 14's data-parallel LM step's included, and the tiles'
edges), K4 (both 32 kHz stage shapes and the edges of its tiles; its
resources, per-phase cycle split and weight bytes from L2 printed), K5 and
K6 against their plain versions.  The fp32 kernels are timed there too
(``apps/time_fp32_kernels``): K4 fp32 at both 32 kHz stages at B = 16 x 10 s
beside its plain version, the cuDNN module stack in fp32 (TF32 off), the
bound, the counter's per-phase split and its resources (lines ``K4 fp32
stage N (B=16 x 10 s)``); K3f fp32 at [8, 1500, 16, 64] and [6, 500, 8,
64] beside SDPA in fp32 and the bound (lines ``K3f fp32 ...``); K3b's fp32
kernels (held at the tiles' edges T = 31, 33, 63-65, 127 and 129 too, and
to equal bits on a second run) at [4, 1501, 16, 64] and [2, 501, 16, 64]
causal beside SDPA's fp32 backward, with their resources.  The
``kernels`` line has a row for each fp32 kernel (``*_fp32``).  Then
one JSON line on the kernels and, last, one JSON line with the result.
Any failed check ends the run with a non-zero exit and no result line, as
does a host without a CUDA card.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import tempfile
import time
import typing as tp
import warnings

import numpy as np
import torch

from audiocraft_tpu_torch.adversarial import MultiScaleSTFTDiscriminator
from audiocraft_tpu_torch.apps import probe_ops, time_fp32_kernels, train_lm
from audiocraft_tpu_torch.builders import (get_encodec_24khz, get_encodec_32khz, get_htdemucs,
                                           get_jasco_model, get_magnet_lm, get_musicgen,
                                           get_musicgen_lm, get_wrapped_compression_model)
from audiocraft_tpu_torch.codec.streaming import CodecStreamer, encoder_stream
from audiocraft_tpu_torch.cond.attributes import (ClassifierFreeGuidanceDropout,
                                                  ConditioningAttributes, JointEmbedCondition,
                                                  SymbolicCondition, WavCondition)
from audiocraft_tpu_torch.cond.chroma_cond import ChromaConditioner
from audiocraft_tpu_torch.cond.joint_embed import JointEmbeddingConditioner
from audiocraft_tpu_torch.dist.mesh import (global_sum, make_data_group, make_mesh, shard_lm,
                                            world_size)
from audiocraft_tpu_torch.dist.pod import pod_decode, pod_encode
from audiocraft_tpu_torch.dist.train import (GAN_WEIGHTS, lm_loss, lm_loss_and_grads,
                                             make_encodec_gan_train_step,
                                             make_encodec_train_step, make_lm_train_step)
from audiocraft_tpu_torch.gen.extend import (generate_music_segments, plan_segments,
                                             stitch_segments)
from audiocraft_tpu_torch.gen.magnet import get_debug_magnet
from audiocraft_tpu_torch.gen.musicgen import MusicGen, get_debug_musicgen
from audiocraft_tpu_torch.io.audio_utils import normalize_audio
from audiocraft_tpu_torch.io.wav import audio_read, audio_write
from audiocraft_tpu_torch.lm.decode import DecodeCache
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.nn.chroma import ChromaExtractor
from audiocraft_tpu_torch.nn.demucs import HTDemucs, make_stem_fn
from audiocraft_tpu_torch.nn.diffusion import DiffusionUnet, MultiBandProcessor, NoiseSchedule
from audiocraft_tpu_torch.nn.transformer import StreamingMultiheadAttention
from audiocraft_tpu_torch.ops import _build, attention
from audiocraft_tpu_torch.ops import lstm as lstm_ops
from audiocraft_tpu_torch.ops.attention import (
    attention_bwd_dkv, attention_bwd_dkv_reference, attention_bwd_dq, attention_bwd_dq_reference,
    attention_di, attention_lse_reference, fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_reference, fused_attention_with_lse)
from audiocraft_tpu_torch.ops.lstm import lstm_kernel_info, lstm_layer, lstm_layer_reference
from audiocraft_tpu_torch.ops.probe import (gather, gather_reference, split_contract,
                                           split_contract_reference)
from audiocraft_tpu_torch.ops.rvq import (rvq_encode, rvq_encode_clocks, rvq_encode_reference,
                                         rvq_kernel_info, rvq_plan)
from audiocraft_tpu_torch.ops.seanet import (
    StageSpec, banded_mono_conv, banded_mono_conv_reference, encoder_stage_plan,
    encoder_stage_weights, fused_encoder_apply, fused_stage, fused_stage_clocks,
    fused_stage_reference, mono_input_conv, mono_input_conv_reference, packed_stage_weights,
    stage_kernel_info, stage_plan, stage_route, stage_weight_l2_bytes, tiled_plan)
from audiocraft_tpu_torch.losses import Balancer
from audiocraft_tpu_torch.obs import PEAK_BF16, PEAK_BYTES, PEAK_FP32, WARMUP_CALLS
from audiocraft_tpu_torch.metrics import (FrechetAudioDistance, chroma_cosine,
                                          kl_divergence_metric, make_codec_embed_fn,
                                          make_codec_prob_fn)
from audiocraft_tpu_torch.optim import OptState, make_optimizer
from audiocraft_tpu_torch.patterns import DelayedPatternProvider
from audiocraft_tpu_torch.quant.codebook import compute_distances, quantize


BATCH, SECONDS, SAMPLE_RATE = 128, 10, 32000       # main path: b128 x 10 s clips
RVQ_SHAPE = dict(n=BATCH * SECONDS * 50, d=128, k=2048, n_q=4)
LSTM_SHAPE = dict(t=SECONDS * 50, b=BATCH, h=1024)
# MAGNeT-small-30s: 4 prompts x 2 (CFG), 30 s at 50 Hz, 16 heads of 64
PROMPTS, MAGNET_SECONDS, DESC_LEN = 4, 30, 12
ATTN_SHAPE = dict(b=2 * PROMPTS, t=MAGNET_SECONDS * 50, h=16, d=64)
# MusicGen-small training: 4 clips x 30 s, T = 1500 codes, S = 1501 steps
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_STEPS, TRAIN_LR = 4, 30, 5, 1e-4
TRAIN_ATTN_SHAPE = (TRAIN_BATCH, TRAIN_SECONDS * 50 + 1, 16, 64)
# phase 14's data-parallel MusicGen-small LM step: 2 clips x 10 s, S = 501
LM_DP_BATCH, LM_DP_SECONDS = 2, 10
LM_DP_ATTN_SHAPE = (LM_DP_BATCH, LM_DP_SECONDS * 50 + 1, 16, 64)
# the two stages that encode(fused=True) runs through K4 at 32 kHz, b128 x 10 s
STAGES = ((StageSpec(c_in=64, c_out=128, stride=4), SECONDS * SAMPLE_RATE),
          (StageSpec(c_in=128, c_out=256, stride=4), SECONDS * SAMPLE_RATE // 4))
CONV0_CHANNELS, CONV0_TAPS = 64, 7
# K1's (at the main shape and at D = 1024) and K5's times before their redesign
# (this script's phase 2 on the earlier designs, NVIDIA H100 80GB HBM3, 700.00 W)
RVQ_OLD_MS, RVQ_OLD_WIDE_MS, MONO_OLD_MS = 6.267, 23.509, 5.797
ENCODES = 3   # timed encodes per route in phase 9
PARITY_BATCH = 16   # phase 4's fp32 encode: b16 x 10 s on both routes
# MusicGen-small generate: 4 descriptions x 30 s with 1-pass CFG (model batch
# 8, 1503 steps); stride extension to 45 s at B = 1; fp32 parity over 2 s at
# the published widths on the first 4 of the 24 layers; the step timed over
# 50 steps from offset 1000
MG_PROMPTS, MG_SECONDS, MG_STRIDE_SECONDS, MG_PARITY_SECONDS = 4, 30, 45, 2
MG_PARITY_LAYERS = 4
MG_TIMED_STEPS, MG_STEP_OFFSET = 50, 1000
# phase 12: 64 stereo clips x 10 s (the mono codec at b128); MusicGen-stereo-
# small, 4 descriptions x 10 s, fp32 parity over 1 s; the 24 kHz codec
# streaming 16 clips x 10 s in chunks of 1 s (75 frames)
STEREO_BATCH, MGS_SECONDS, MGS_PARITY_SECONDS, MGS_STEP_OFFSET = 64, 10, 1, 250
STREAM_BATCH, STREAM_SECONDS, STREAM_RATE, STREAM_CHUNK_FRAMES = 16, 10, 24000, 75
# phase 13: MusicGen-melody-medium and MusicGen-style-medium, 2 descriptions x
# 10 s with 10 s melodies or style clips, the step timed at offset 250; the
# stale-prefix check at 2 s; fp32 melody parity at 1 s on 4 of the 48 layers;
# the extend utility over a 20 s melody in 10 s segments, 1 s of overlap
MEL_PROMPTS, MEL_SECONDS, MEL_STEP_OFFSET, MEL_CHECK_SECONDS = 2, 10, 250, 2
MEL_PARITY_SECONDS, MEL_PARITY_LAYERS = 1, 4
EXTEND_SECONDS, EXTEND_SEGMENT, EXTEND_OVERLAP = 20, 10, 1
# the encode shapes this script runs (batch, seconds): phases 3 / 9, the
# training encode of phase 7, and B = 1 and 4 at 10 s
ROUTE_SHAPES = ((BATCH, SECONDS), (TRAIN_BATCH, TRAIN_SECONDS), (4, SECONDS), (1, SECONDS))
# phase 10: P1 also at 2048x the probe's rows (128-260 MiB an input, past the
# 50 MB L2); device time per launch by torch.profiler, host time per call
PROBE_SCALE, PROBE_LAUNCHES, PROBE_CALLS = 2048, 100, 1000


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, peak_ops: float, nbytes: float) -> tuple:
    """The least time for the work, and whether operations or bytes set it."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def phase_build() -> None:
    print('== phase 1: card and build', flush=True)
    print('card:', card())
    print('torch', torch.__version__, 'cuda', torch.version.cuda,
          'device', torch.cuda.get_device_name(0))
    result = _build.build()
    lib = _build.library()
    print(f'build: {result.seconds:.1f} s -> {result.path.name}')
    for line in result.log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            print('  ptxas:', line.strip())
    check(attention.MAX_HEAD_DIM == lib.acx_attention_max_dim(),
          f'ops/attention.py MAX_HEAD_DIM {attention.MAX_HEAD_DIM} != the kernels\' '
          f'{lib.acx_attention_max_dim()}')
    print(f'attention route: heads up to {attention.MAX_HEAD_DIM} wide take the kernels '
          f'(the library says {lib.acx_attention_max_dim()}); RVQ kernel rows up to '
          f'D = {lib.acx_rvq_max_dim()}', flush=True)


def _rvq_inputs(device, n, d, k, n_q, seed=1):
    """Random rows and codebooks with planted ties: codes 7, 16, 25, ... copy
    code 3 in every codebook, and every 97th row equals code 3 of the first."""
    gen = torch.Generator().manual_seed(seed)
    embeds = torch.randn(n_q, k, d, generator=gen)
    x = torch.randn(n, d, generator=gen)
    embeds[:, 7::9] = embeds[:, 3:4]
    x[::97] = embeds[0, 3]
    return x.to(device), embeds.to(device)


def _near_ties(x, embeds, codes, rel=1e-6):
    """Rows whose top-2 plain distances lie within ``rel`` of each other at
    some codebook of the chain that ``codes`` takes."""
    residual, near = x.clone(), torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for q, embed in enumerate(embeds):
        top2 = compute_distances(residual, embed).topk(2, dim=1).values
        near |= (top2[:, 0] - top2[:, 1]).abs() <= rel * top2[:, 0].abs()
        residual = residual - embed[codes[q].long()]
    return near


def check_rvq(x, embeds) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel codes against the plain codes on ``_rvq_inputs``: equal on every
    row but the near-ties, and every planted tie goes to the first equal
    code.  Returns (kernel codes, plain codes, near-tie mask)."""
    codes = rvq_encode(x, embeds)
    plain = rvq_encode_reference(x, embeds)
    torch.cuda.synchronize()
    what = f'rvq {tuple(x.shape)} x {tuple(embeds.shape)}'
    check(bool((codes[0, ::97] == 3).all() and (plain[0, ::97] == 3).all()),
          f'{what}: planted ties do not go to the first equal code')
    copies = torch.arange(7, embeds.shape[1], 9, device=x.device)
    check(not bool(torch.isin(codes, copies).any()),
          f'{what}: a copy of code 3 won over code 3')
    near = _near_ties(x, embeds, plain)
    diff = (codes != plain)[:, ~near]
    check(not bool(diff.any()), f'{what}: {int(diff.any(0).sum())} rows differ from the plain codes')
    return codes, plain, near


def check_off_tile_shapes(device) -> None:
    """Shapes off the kernels' tiles, masked inside the kernels: RVQ at the
    debug codec's D = 32 and K = 400 with N not a multiple of 128, at D = 30
    (not a multiple of 4: the kernel's scalar loads), and at the style
    conditioner's widths D = 256, 512 and 1024 (128 residual rows a block
    up to D = 400, 64 up to D = 800, 32 above); LSTM with B and H not multiples of 8 or
    of the units a block owns; and a row wider than the RVQ kernel's maximum
    (1024), which must raise.  At the RVQ plan's own edges: N of one
    block's rows, one more and one fewer at each row count (128 at D = 128,
    64 at D = 512, 32 at D = 1024), K not a multiple of the code tile, and a
    grid of fewer blocks than the SMs.  Then the RVQ kernel timed at D =
    1024 beside D = 128 on the style conditioner's codebooks (K = 1024,
    n_q = 6)."""
    nears = []
    for n, d, k in ((517, 32, 400), (301, 30, 400), (301, 256, 400), (301, 512, 1024),
                    (517, 1024, 1024)):
        x, embeds = _rvq_inputs(device, n=n, d=d, k=k, n_q=4, seed=8 + d)
        nears.append(f'D={d}: {int(check_rvq(x, embeds)[2].sum())}')
    edges = []
    for d, k in ((128, 2048), (512, 1000), (1024, 1000)):
        rows = rvq_plan(d).rows
        for n in (rows - 1, rows, rows + 1):
            x, embeds = _rvq_inputs(device, n=n, d=d, k=k, n_q=4, seed=20 + n)
            edges.append(f'N={n} D={d} K={k}: {int(check_rvq(x, embeds)[2].sum())}')
    for n, d, k in ((1000, 128, 200), (4000, 128, 1000)):   # 8 and 32 blocks; K off the tile
        x, embeds = _rvq_inputs(device, n=n, d=d, k=k, n_q=4, seed=30 + k)
        edges.append(f'N={n} D={d} K={k}: {int(check_rvq(x, embeds)[2].sum())}')
    print('rvq at the plan\'s edges, codes equal (near-tie rows excluded): ' + ', '.join(edges),
          flush=True)
    gen = torch.Generator().manual_seed(9)
    T, B, C, H = 7, 3, 48, 40
    args = [torch.randn(shape, generator=gen) * 0.5
            for shape in ((T, B, C), (4 * H, C), (4 * H, H), (4 * H,), (4 * H,))]
    errs = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        a = [t.to(device, dtype) for t in args]
        errs.append(float((lstm_layer(*a).float() - lstm_layer_reference(*a).float())
                          .abs().max()))
        check(errs[-1] <= tol, f'lstm T={T} B={B} H={H} {dtype}: max-abs {errs[-1]:.3g} > {tol}')
    try:
        rvq_encode(torch.zeros(8, 1032, device=device), torch.zeros(1, 16, 1032, device=device))
    except ValueError:
        pass
    else:
        raise CheckFailed('rvq: D = 1032 did not raise')
    print(f'off-tile shapes: rvq N=517 D=32 K=400, N=301 D=30 K=400, N=301 D=256 K=400, '
          f'N=301 D=512 K=1024, '
          f'N=517 D=1024 K=1024 codes equal (near-tie rows excluded: {", ".join(nears)}); '
          f'lstm T={T} B={B} C={C} H={H} max-abs fp32 {errs[0]:.3g} (<= 1e-5), '
          f'bf16 {errs[1]:.3g} (<= 5e-2); D=1032 refused', flush=True)
    times = {}
    for d in (128, 1024):
        x, embeds = _rvq_inputs(device, n=8192, d=d, k=1024, n_q=6, seed=12)
        times[d] = time_ms(lambda: rvq_encode(x, embeds), 5)
        del x, embeds
    print(f'rvq N=8192 K=1024 n_q=6: kernel D=128 {times[128]:.3f} ms, D=1024 '
          f'{times[1024]:.3f} ms ({times[1024] / times[128]:.2f}x for 8x the width; before this '
          f'design {RVQ_OLD_WIDE_MS} ms at D=1024)', flush=True)


def check_rvq_main(device) -> dict:
    """K1 at the main path's shape (N = 64000, D = 128, K = 2048, n_q = 4):
    codes equal to the plain codes but for near-ties, then its time beside
    its bound, its plain time and the kernel's time before this design; its
    per-phase cycle split from the counter's instance (which must give the
    same codes), its resources, and the four fp32 products alone through
    torch.matmul with TF32 off, a yardstick of the card's fp32 rate."""
    s = RVQ_SHAPE
    x, embeds = _rvq_inputs(device, **s)
    codes, plain, near = check_rvq(x, embeds)
    checked = ~near
    ops = 2.0 * s['n'] * s['d'] * s['k'] * s['n_q']
    nbytes = 4.0 * (s['n'] * s['d'] + s['n_q'] * s['k'] * s['d'] + s['n_q'] * s['n'])
    b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
    rvq = dict(name='rvq_encode', route='cuda', source='audiocraft_tpu_torch/csrc/rvq.cu',
               replaces='audiocraft_tpu/ops/rvq_pallas.py:46',
               max_abs_err=float((codes - plain)[:, checked].abs().max()),
               ms=time_ms(lambda: rvq_encode(x, embeds), 5),
               plain_ms=time_ms(lambda: rvq_encode_reference(x, embeds), 5),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"rvq N={s['n']} D={s['d']} K={s['k']} n_q={s['n_q']}: codes equal on "
          f"{int(checked.sum())} rows, {int(near.sum())} near-tie rows excluded; "
          f"kernel {rvq['ms']:.3f} ms ({ops / rvq['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{rvq['plain_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
          f"before this design {RVQ_OLD_MS} ms", flush=True)
    counted, lapped, worked = rvq_encode_clocks(x, embeds)
    check(torch.equal(counted, codes), 'rvq: the counter\'s instance gives other codes')
    total = sum(lapped.values())
    print('rvq per-phase split (one thread a block, summed over blocks; '
          f'{total / 1e9:.3f} G block-cycles): '
          + ', '.join(f'{k} {v / total:.3f}' for k, v in lapped.items()), flush=True)
    print('rvq per-warp work before each barrier (G warp-cycles): '
          + ', '.join(f'{k} {v / 1e9:.3f}' for k, v in worked.items() if v), flush=True)
    info = rvq_kernel_info(s['n'], s['d'], s['k'], s['n_q'])
    print('rvq resources: ' + ', '.join(f'{k} {v}' for k, v in info.items()), flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        et = embeds.transpose(1, 2).contiguous()
        mm = time_ms(lambda: [x @ et[q] for q in range(s['n_q'])], 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"rvq yardstick: the four fp32 products x @ E_q^T alone through torch.matmul, "
          f"TF32 off, {mm:.3f} ms ({ops / mm / 1e9:.1f} TFLOP/s); card {card()}", flush=True)
    return rvq


def _lstm_args(T: int, B: int, H: int, seed: int) -> tp.List[torch.Tensor]:
    """Seeded x [T, B, H] and weights uniform in +-1/sqrt(H), as the codec's init."""
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)
    weights = [(torch.rand(shape, generator=gen) * 2 - 1) * bound
               for shape in ((4 * H, H), (4 * H, H), (4 * H,), (4 * H,))]
    return [torch.randn(T, B, H, generator=gen) * 0.5, *weights]


def plan_text(plan) -> str:
    return f'{plan.grid} blocks of {plan.units} units x {plan.batch_rows} batch rows'


def _cudnn_lstm(args: tp.List[torch.Tensor]) -> tp.Tuple[torch.nn.LSTM, bool]:
    """cuDNN's nn.LSTM with the layer's weights, packed once into cuDNN's
    flat buffer.  nn.LSTM packs only fp16 and fp32 weights itself; unpacked
    bf16 weights are copied into a fresh buffer (8 MB at H = 1024) on every
    call, which would be timed with it.  Returns the module and whether a
    call ran on the packed buffer (cuDNN warns when it has to repack)."""
    H = args[0].shape[-1]
    cudnn = torch.nn.LSTM(H, H, num_layers=1).to(args[0].device, args[0].dtype)
    with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        for p, w in zip((cudnn.weight_ih_l0, cudnn.weight_hh_l0, cudnn.bias_ih_l0,
                         cudnn.bias_hh_l0), args[1:]):
            p.copy_(w)
        try:
            torch._cudnn_rnn_flatten_weight(
                cudnn._flat_weights, 4, H, torch.backends.cudnn.rnn.get_cudnn_mode('LSTM'),
                H, 0, 1, False, False)
        except (RuntimeError, AttributeError) as exc:   # timed repacking, and said so
            print(f'cuDNN did not pack the {args[0].dtype} LSTM weights: {exc}', flush=True)
        cudnn(args[0])
        torch.cuda.synchronize()
    packed = not any('not part of single contiguous' in str(w.message) for w in caught)
    return cudnn, packed


def time_lstm(args: tp.List[torch.Tensor], reps: int) -> dict:
    """One bf16 layer on the card: the kernel held against its plain version
    on the same inputs (max-abs <= 5e-2, as at the codec's shape), both timed
    beside cuDNN's nn.LSTM with its weights packed once, the bound, and the
    kernel's plan and resources."""
    T, B, H = args[0].shape
    out = lstm_layer(*args)
    ref = lstm_layer_reference(*args)
    err = float((out.float() - ref.float()).abs().max())
    check(bool(torch.isfinite(out).all()), f'lstm bf16 T={T} B={B}: non-finite output')
    check(err <= 5e-2, f'lstm bf16 T={T} B={B} H={H}: max-abs {err:.3g} > 5e-2')
    cudnn, packed = _cudnn_lstm(args)
    with torch.no_grad(), warnings.catch_warnings():
        warnings.filterwarnings('ignore', message='RNN module weights are not part')
        cudnn_err = float((cudnn(args[0])[0].float() - ref.float()).abs().max())
        library = time_ms(lambda: cudnn(args[0]), reps)
    del out, ref, cudnn
    ops = 2.0 * T * B * 4 * H * (H + H)          # input projection + recurrence
    nbytes = 2.0 * (2 * T * B * H + 8 * H * H + 8 * H)
    b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes)
    plan = lstm_ops.device_plan(H, B, torch.bfloat16, args[0].device)
    info = lstm_kernel_info(torch.bfloat16, plan)
    entry = dict(ms=time_ms(lambda: lstm_layer(*args), reps),
                 plain_ms=time_ms(lambda: lstm_layer_reference(*args), 1),
                 bound_ms=b_ms, bound_by=b_by, library_ms=library)
    print(f"lstm one bf16 layer T={T} B={B} H={H}: max-abs against plain {err:.3g} (<= 5e-2); "
          f"kernel {entry['ms']:.3f} ms ({entry['ms'] * 1e3 / T:.2f} us per step), plain "
          f"{entry['plain_ms']:.3f} ms, cuDNN nn.LSTM {library:.3f} ms "
          f"({library * 1e3 / T:.2f} us per step; weights "
          f"{'packed once' if packed else 'repacked on every call'}; max-abs against plain "
          f"{cudnn_err:.3g}, information), bound {b_ms:.3f} ms ({b_by}); plan: "
          f"{plan_text(plan)}, batch tile {plan.batch_tile}, K chunk "
          f"{plan.k_chunk} in a ring of {plan.stages}, weight slice {plan.weight_bytes} B "
          f"{'resident' if plan.resident else 'streamed'}, {plan.smem_bytes} B dynamic shared "
          f"memory a block; {info['registers']} registers x {info['threads']} threads, "
          f"{info['static_shared_bytes']} B static shared, {info['spill_bytes']} B spilled",
          flush=True)
    return entry


def check_lstm(device) -> dict:
    """K2 against its plain version at the codec's shape, T = 500, B = 128,
    H = 1024: fp32 within 1e-4 (TF32 plays no part; only the order of the
    fp32 sums differs, over 500 steps), bf16 within 5e-2 (bf16 products are
    exact in fp32; the sums' order moves a bf16-stored h by a step, which the
    recurrence carries).  Then one bf16 layer checked (5e-2) and timed at the
    training encode's and MAGNeT decode's shape, T = 1500, B = 4, at B = 4
    to 128 for T = 500, and at the codec's shape."""
    T, B, H = LSTM_SHAPE['t'], LSTM_SHAPE['b'], LSTM_SHAPE['h']
    x, *weights = _lstm_args(T, B, H, seed=2)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        args = [a.to(device, dtype) for a in (x, *weights)]
        out = lstm_layer(*args)
        ref = lstm_layer_reference(*args)
        errs[dtype] = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f'lstm {dtype}: non-finite output')
        check(errs[dtype] <= tol, f'lstm {dtype}: max-abs {errs[dtype]:.3g} > {tol}')
    print(f'lstm T={T} B={B} H={H}: max-abs fp32 {errs[torch.float32]:.3g} (<= 1e-4), '
          f'bf16 {errs[torch.bfloat16]:.3g} (<= 5e-2)', flush=True)
    del out, ref, args
    small = [a.to(device, torch.bfloat16) for a in _lstm_args(1500, 4, H, seed=3)]
    time_lstm(small, 10)
    del small
    sweep, sweep_err = {}, {}
    for b in (4, 8, 16, 32, 64, 128):   # how a step grows with the bytes of h
        a = [t.to(device, torch.bfloat16) for t in _lstm_args(T, b, H, seed=4)]
        sweep_err[b] = float((lstm_layer(*a).float() - lstm_layer_reference(*a).float())
                             .abs().max())
        check(sweep_err[b] <= 5e-2, f'lstm bf16 T={T} B={b}: max-abs {sweep_err[b]:.3g} > 5e-2')
        sweep[b] = time_ms(lambda: lstm_layer(*a), 3) * 1e3 / T
    print(f'lstm one bf16 layer T={T} H={H}, us per step by batch: '
          + ', '.join(f'B={b} {us:.2f}' for b, us in sweep.items())
          + f'; max-abs against plain <= {max(sweep_err.values()):.3g} (<= 5e-2)', flush=True)
    # timed in bf16, the main path's dtype
    args = [a.to(device, torch.bfloat16) for a in (x, *weights)]
    entry = time_lstm(args, 10)
    # the same layer with the plan held to one batch group (128 blocks of 8
    # units over all 128 rows), timed in this call beside the plan's split
    whole = lstm_ops.fit_plan(H, B, torch.bfloat16, 8, 1, True,
                              lstm_ops.device_limits(device.index or 0)[1])
    chosen = lstm_ops.device_plan
    lstm_ops.device_plan = lambda *_: whole
    try:
        check(float((lstm_layer(*args).float() - lstm_layer_reference(*args).float())
                    .abs().max()) <= 5e-2, 'lstm bf16, one batch group: max-abs > 5e-2')
        one_group = time_ms(lambda: lstm_layer(*args), 3)
    finally:
        lstm_ops.device_plan = chosen
    print(f'lstm one bf16 layer T={T} B={B} H={H} held to one batch group ({whole.grid} blocks '
          f'of {whole.units} units x {whole.batch_rows} rows, information): {one_group:.3f} ms '
          f'({one_group * 1e3 / T:.2f} us per step), against {entry["ms"]:.3f} ms for the '
          f'plan\'s {plan_text(lstm_ops.device_plan(H, B, torch.bfloat16, device))}', flush=True)
    return dict(name='lstm_step', route='cuda', source='audiocraft_tpu_torch/csrc/lstm.cu',
                replaces='audiocraft_tpu/ops/lstm_pallas.py:44',
                max_abs_err=errs[torch.bfloat16], **entry)


def _lstm_state(B: int, H: int, dtype, device, seed: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    return ((torch.randn(B, H, generator=gen) * 0.3).to(device, dtype),
            (torch.randn(B, H, generator=gen) * 0.3).to(device))


def check_lstm_carry(device) -> None:
    """K2 started from a carried (h0, c0) and returning its final (h, c),
    against the plain version with the same carry: fp32 within 1e-4, bf16
    within 5e-2 (as from zero), output, h_T and c_T, at the streaming shape
    (T = 75, one chunk of the 24 kHz codec, B = 16, H = 512), at T = 1, at a
    ragged H = 40, B = 3, and at the codec's T = 500, B = 128, H = 1024;
    then two chained launches against one over the whole sequence."""
    errs = []
    for T, B, H in ((STREAM_CHUNK_FRAMES, STREAM_BATCH, 512), (1, STREAM_BATCH, 512),
                    (9, 3, 40), (LSTM_SHAPE['t'], LSTM_SHAPE['b'], LSTM_SHAPE['h'])):
        x, *weights = _lstm_args(T, B, H, seed=5)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            args = [a.to(device, dtype) for a in (x, *weights)]
            state = _lstm_state(B, H, dtype, device, seed=6)
            out, (h, c) = lstm_layer(*args, state=state, return_state=True)
            ref, (h_ref, c_ref) = lstm_layer_reference(*args, state=state, return_state=True)
            check(h.dtype == dtype and c.dtype == torch.float32, f'carry dtypes {h.dtype} {c.dtype}')
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in ((out, ref), (h, h_ref), (c, c_ref)))
            check(err <= tol, f'lstm carry T={T} B={B} H={H} {dtype}: max-abs {err:.3g} > {tol}')
            errs.append(f'T={T} B={B} H={H} {str(dtype)[6:]} {err:.3g}')
    T, B, H = 2 * STREAM_CHUNK_FRAMES, STREAM_BATCH, 512
    x, *weights = [a.to(device) for a in _lstm_args(T, B, H, seed=7)]
    whole, (h, c) = lstm_layer(x, *weights, return_state=True)
    first, state = lstm_layer(x[:STREAM_CHUNK_FRAMES], *weights, return_state=True)
    second, (h2, c2) = lstm_layer(x[STREAM_CHUNK_FRAMES:], *weights, state=state,
                                  return_state=True)
    chained = torch.cat([first, second])
    err = max(float((a - b).abs().max()) for a, b in ((chained, whole), (h2, h), (c2, c)))
    check(err <= 1e-5, f'lstm fp32: two chained launches max-abs {err:.3g} from one > 1e-5')
    print(f'lstm from a carried (h, c), output and final (h, c) against plain, max-abs: '
          f'{"; ".join(errs)} (fp32 <= 1e-4, bf16 <= 5e-2); two chained fp32 launches of '
          f'{STREAM_CHUNK_FRAMES} steps against one of {T}: max-abs {err:.3g} (<= 1e-5; '
          f'bit-identical {torch.equal(chained, whole) and torch.equal(c2, c)}, information: '
          'the input projections are separate matmuls)', flush=True)


def phase_kernels(device) -> dict:
    print('== phase 2: kernels against their plain versions', flush=True)
    results = {}
    check_off_tile_shapes(device)

    results['rvq_encode'] = check_rvq_main(device)
    results['lstm_step'] = check_lstm(device)
    check_lstm_carry(device)
    for entry in (*check_attention(device), *check_attention_backward(device),
                  *check_fused_stage(device)):
        results[entry['name']] = entry
    results.update(check_mono_conv(device))
    return results


def _attn_err(q, k, v, causal: bool) -> float:
    out = fused_attention(q, k, v, causal=causal)
    ref = fused_attention_reference(q, k, v, causal=causal)
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f'attention {tuple(q.shape)}: output {tuple(out.shape)} {out.dtype}')
    check(bool(torch.isfinite(out).all()), f'attention {tuple(q.shape)}: non-finite output')
    return float((out.float() - ref.float()).abs().max())


def _attn_case(shape, how: str, gen, device) -> tp.Callable[[torch.dtype], tp.List[torch.Tensor]]:
    """Seeded q, k, v [B, T, H, D] on the card in a given dtype.  ``how``:
    'plain' (randn); 'peaked' (q times 6, so one key takes most of a row's
    weight, and v uniform in [-4, 4]); 'offset' (views that start one element
    past a 16-byte boundary, which the bf16 wrapper copies); 'fused' (strided
    slices of one [B, T, 3 H D] projection, cast before the split, as the
    transformer passes them)."""
    B, T, H, D = shape
    if how == 'fused':
        qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(device)
        return lambda dtype: [x.unflatten(-1, (H, D)) for x in qkv.to(dtype).split(H * D, -1)]
    q, k, v = (torch.randn(shape, generator=gen).to(device) for _ in range(3))
    if how == 'peaked':
        q, v = 6 * q, 8 * torch.rand(shape, generator=gen).to(device) - 4
    if how == 'offset':
        def views(dtype):
            flat = [torch.empty(x.numel() + 1, dtype=dtype, device=device) for x in (q, k, v)]
            return [f[1:].view(shape).copy_(x) for f, x in zip(flat, (q, k, v))]
        return views
    return lambda dtype: [x.to(dtype) for x in (q, k, v)]


def print_attention_fwd_resources() -> None:
    """Registers per thread, shared memory per block and blocks per SM of
    K3f's instances (cudaFuncGetAttributes and the occupancy API); the fp32
    kernel's shared bytes must equal ``fwd_f32_geometry``'s."""
    for dtype, dim in ((torch.bfloat16, 32), (torch.bfloat16, 64), (torch.bfloat16, 128),
                       (torch.float32, 32), (torch.float32, 64), (torch.float32, 128)):
        i = attention.attention_fwd_kernel_info(dim, dtype)
        what = 'tensor cores' if dtype == torch.bfloat16 else 'FMA'
        print(f"attention forward kernel {dtype} D={dim} {what}: {i['registers']} registers x "
              f"{i['threads']} threads, {i['shared_bytes']} B shared, {i['blocks_per_sm']} "
              f"blocks/SM, {i['spill_bytes']} B spilled", flush=True)
        if dtype == torch.float32:
            plan = attention.fwd_f32_geometry(dim)['shared_bytes']
            check(i['shared_bytes'] == plan,
                  f'K3f fp32 D={dim}: {i["shared_bytes"]} B shared, the plan says {plan}')


def check_attention(device) -> tp.Tuple[dict, dict]:
    """K3f against its plain version (the plain one computed from the same
    inputs in the same dtype), fp32 at 1e-5 (TF32 off; only the order of the
    fp32 sums differs) and bf16 at 2e-2 (the online rescaling, P carried as
    two bf16 parts into the tensor-core product and the bf16 rounding of the
    output), causal and not, at MAGNeT's shape, off the 64-row tiles, and
    on peaked rows (bf16; one key takes most of the weight, |v| up to 4);
    causal at the training shapes (phase 7's and phase 14's data-parallel
    step's); on views the bf16 wrapper copies (a start off 16 bytes) or pads
    (D = 36 to 40), and on the fused qkv slices, which it must pass
    uncopied.  D = 256 must raise when the kernel is called, and a
    transformer layer with heads of 256 and attn_kernel='auto' must take the
    plain path by shape, launch nothing and equal the plain route (fp32,
    1e-5).  Then times in bf16: K3f at S = 1500 and 500 (not causal) and at the
    training shape (causal) beside SDPA and the bound; and the fp32 kernel at
    [8, 1500, 16, 64] and JASCO's [6, 500, 8, 64] beside SDPA in fp32 and the
    bound.  Returns the bf16 entry and the fp32 one (JASCO's shape)."""
    print_attention_fwd_resources()
    gen = torch.Generator().manual_seed(10)
    both = (False, True)
    cases = [('main', tuple(ATTN_SHAPE.values()), 'plain', both),
             ('training', TRAIN_ATTN_SHAPE, 'plain', (True,)),
             ('data-parallel training', LM_DP_ATTN_SHAPE, 'plain', (True,)),
             ('off-tile', (1, 130, 3, 32), 'plain', both),
             ('peaked', (2, ATTN_SHAPE['t'], 16, 64), 'peaked', both),
             ('copied', (2, 130, 3, 64), 'offset', both),
             ('padded', (2, 130, 3, 36), 'plain', both),
             ('fused qkv', (2, 257, 4, 64), 'fused', both)]
    errs = {}
    for name, shape, how, masks in cases:
        inputs = _attn_case(shape, how, gen, device)
        # the peaked rows test what carries P into the bf16 products
        dtypes = ((torch.float32, 1e-5),) * (how != 'peaked') + ((torch.bfloat16, 2e-2),)
        for dtype, tol in dtypes:
            for causal in masks:
                err = _attn_err(*inputs(dtype), causal)
                errs[(name, dtype, causal)] = err
                check(err <= tol, f'attention {name} {shape} {dtype} causal={causal}: max-abs '
                                  f'{err:.3g} > {tol}')
        print(f'attention {name} {shape}: max-abs ' + ', '.join(
            f'{"fp32" if dtype == torch.float32 else "bf16"}{" causal" if causal else ""} '
            f'{errs[(name, dtype, causal)]:.3g}'
            for dtype, _ in dtypes for causal in masks)
              + ' (<= 1e-5 fp32, 2e-2 bf16)', flush=True)
        del inputs
    offset = _attn_case((2, 130, 3, 64), 'offset', gen, device)(torch.bfloat16)
    check(offset[0].data_ptr() % 16 != 0 and all(
        a is not b for a, b in zip(attention._rows_on_16_bytes(*offset), offset)),
        'the wrapper passed a view off 16 bytes uncopied')
    B, T, H, D = TRAIN_ATTN_SHAPE
    fused = _attn_case(TRAIN_ATTN_SHAPE, 'fused', gen, device)(torch.bfloat16)
    check(fused[0].stride(1) == 3 * H * D and all(
        a is b for a, b in zip(attention._rows_on_16_bytes(*fused), fused)),
        'the fused qkv slices of the model did not pass the 16-byte rule uncopied')
    print('16-byte rows: the fused qkv slices pass uncopied; a view 2 bytes off 16 is copied; '
          'D = 36 is padded to 40 and sliced back', flush=True)

    try:
        x = torch.zeros(1, 8, 1, 256, device=device)
        fused_attention(x, x, x, causal=False)
    except ValueError:
        pass
    else:
        raise CheckFailed('attention: D = 256 did not raise')
    wide = []
    for causal in (False, True):
        layer = StreamingMultiheadAttention(512, 2, causal=causal, attn_kernel='auto',
                                            generator=gen).to(device)
        x = torch.randn(2, 300, 512, generator=gen).to(device)
        before = fused_attention.launches
        with torch.no_grad():
            out = layer(x)
            layer.attn_kernel = False
            plain = layer(x)
        check(fused_attention.launches == before, 'a head of 256 launched the attention kernel')
        wide.append(float((out - plain).abs().max()))
        check(wide[-1] <= 1e-5, f'attention layer D=256 causal={causal}: {wide[-1]:.3g} > 1e-5')
    print(f"attention layer E=512, 2 heads of 256, attn_kernel='auto', T=300: plain path by "
          f'shape, no launch; max-abs against attn_kernel=False {wide[0]:.3g} / causal '
          f'{wide[1]:.3g} (<= 1e-5)', flush=True)

    times = {}
    magnet = tuple(ATTN_SHAPE.values())   # MAGNeT stage 0 at 30 s and at 10 s, then training
    for shape, causal in ((magnet, False), (magnet[:1] + (500,) + magnet[2:], False),
                          (TRAIN_ATTN_SHAPE, True)):
        B, T, H, D = shape
        q, k, v = (torch.randn(shape, generator=gen).to(device, torch.bfloat16)
                   for _ in range(3))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal)
        pairs = T * (T + 1) / 2 if causal else T * T
        b_ms, b_by = bound_ms(4.0 * B * H * pairs * D, PEAK_BF16,
                              2.0 * 4 * B * T * H * D + (4.0 * B * H * T if causal else 0))
        fn = (lambda: fused_attention_with_lse(q, k, v, causal=True)) if causal else \
            (lambda: fused_attention(q, k, v, causal=False))
        t = times[(T, causal)] = dict(
            ms=time_ms(fn, 20),
            plain_ms=time_ms(lambda: fused_attention_reference(q, k, v, causal=causal), 3),
            library_ms=time_ms(sdpa, 20), bound_ms=b_ms, bound_by=b_by)
        print(f'attention bf16 {shape} causal={causal}{" with lse" if causal else ""}: kernel '
              f'{t["ms"]:.4f} ms, plain {t["plain_ms"]:.3f} ms, SDPA {t["library_ms"]:.4f} ms, '
              f'bound {b_ms:.4f} ms ({b_by}); kernel / SDPA {t["ms"] / t["library_ms"]:.2f}, '
              f'{4.0 * B * H * pairs * D / t["ms"] / 1e9:.0f} TFLOP/s', flush=True)
        del q, k, v
    fq, fk, fv = fused
    fused_ms = time_ms(lambda: fused_attention_with_lse(fq, fk, fv, causal=True), 20)
    print(f'attention bf16 {TRAIN_ATTN_SHAPE} causal on the fused qkv slices (the model\'s '
          f'layout): kernel {fused_ms:.4f} ms (information)', flush=True)
    del fused, fq, fk, fv
    # the fp32 kernel at MAGNeT-small's width and at JASCO's U-net (its entry)
    name = card()
    f32 = {}
    for shape in reversed(time_fp32_kernels.ATTN_SHAPES):
        f32[shape] = time_fp32_kernels.time_attention(shape, device, seed=162)
        time_fp32_kernels.print_attention(f32[shape], name)
        check(f32[shape]['max_abs_err'] <= 1e-5, f'attention fp32 {shape}: max-abs > 1e-5')
    jasco = f32[time_fp32_kernels.ATTN_SHAPES[0]]
    entry = dict(name='flash_attention', route='cuda',
                 source='audiocraft_tpu_torch/csrc/attention.cu',
                 replaces='audiocraft_tpu/ops/attention_pallas.py:117',
                 max_abs_err=errs[('main', torch.bfloat16, False)],
                 **times[(ATTN_SHAPE['t'], False)])
    entry_f32 = dict(name='flash_attention_fp32', route='cuda',
                     source='audiocraft_tpu_torch/csrc/attention.cu',
                     replaces='audiocraft_tpu/ops/attention_pallas.py:117',
                     **{k: jasco[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'library_ms',
                                              'bound_ms', 'bound_by')})
    return entry, entry_f32


def _attn_bwd_errs(q, k, v, do, causal: bool) -> tp.Tuple[float, float, float]:
    """K3f's lse and K3b's gradients against their plain versions on the
    same inputs: (lse max-abs, worst gradient max-abs / max-abs of the plain
    gradient, worst gradient max-abs); a second run of the kernels must give
    the same bits (each gradient has one writer).  A gradient that is zero in exact
    arithmetic is rounding noise on both sides (dq and dk at T = 1, where
    P = 1 and dS = dP - di = 0), so each gradient's max-abs is floored at
    1e-2 of the largest of the three."""
    o, lse = fused_attention_with_lse(q, k, v, causal=causal)
    lse_err = float((lse - attention_lse_reference(q, k, v, causal=causal)).abs().max())
    refs = fused_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    tops = [float(r.float().abs().max()) for r in refs]
    floor = 1e-2 * max(tops)
    rel = err = 0.0
    grads = fused_attention_backward(q, k, v, o, lse, do, causal=causal)
    again = fused_attention_backward(q, k, v, o, lse, do, causal=causal)
    for g, a, r, top in zip(grads, again, refs, tops):
        what = f'attention backward {tuple(q.shape)} {q.dtype}'
        check(torch.equal(g, a), f'{what}: a second run gives other bits')
        check(g.shape == r.shape and g.dtype == r.dtype,
              f'{what}: gradient {tuple(g.shape)} {g.dtype}')
        check(bool(torch.isfinite(g).all()), f'{what}: non-finite')
        diff = float((g.float() - r.float()).abs().max())
        check(math.isfinite(diff), f'{what}: error {diff}')
        err, rel = max(err, diff), max(rel, diff / max(top, floor))
    return lse_err, rel, err


def _attn_inputs(shape, fused: bool, gen, device) -> tp.Callable[[torch.dtype], tuple]:
    """Seeded q, k, v, dO [B, T, H, D] in a given dtype.  With ``fused``, q,
    k and v are what the transformer passes: strided slices of one
    [B, T, 3 H D] projection (nn/transformer.py), cast before the split."""
    B, T, H, D = shape
    if not fused:
        inputs = [torch.randn(shape, generator=gen).to(device) for _ in range(4)]
        return lambda dtype: tuple(x.to(dtype) for x in inputs)
    qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(device)
    do = torch.randn(shape, generator=gen).to(device)
    return lambda dtype: (*(x.unflatten(-1, (H, D)) for x in qkv.to(dtype).split(H * D, -1)),
                          do.to(dtype))


def print_attention_bwd_resources() -> None:
    """Registers per thread, shared memory per block and blocks per SM of the
    K3b kernels (cudaFuncGetAttributes and the occupancy API); the fp32
    kernels' threads and shared bytes at every width class must equal
    ``attention.bwd_f32_geometry``'s."""
    for dtype, dims in ((torch.bfloat16, (32, 64, 128)), (torch.float32, (32, 64, 128))):
        for dim in dims:
            info = attention.attention_bwd_kernel_info(dim, dtype)
            print(f'attention backward kernels {dtype} D={dim}: ' + '; '.join(
                f"{name} {i['registers']} registers x {i['threads']} threads, "
                f"{i['shared_bytes']} B shared, {i['blocks_per_sm']} blocks/SM, "
                f"{i['spill_bytes']} B spilled" for name, i in info.items()), flush=True)
            if dtype == torch.float32:
                geometry = attention.bwd_f32_geometry(dim)
                for name, i in info.items():
                    want = geometry[name]
                    check((i['threads'], i['shared_bytes']) == (want['threads'],
                                                                 want['shared_bytes']),
                          f'K3b fp32 {name} D={dim}: {i} against bwd_f32_geometry {want}')


def check_attention_backward(device) -> tp.List[dict]:
    """K3b (and K3f's lse) against the plain versions: fp32 (TF32 off; only
    the order of fp32 sums differs) within 1e-4 of each gradient's max-abs,
    bf16 within 2e-2 (the gradients are rounded to bf16; P and dS are
    rounded once to bf16 on both sides, at the same points), lse within
    1e-5; a second run gives equal bits.  Shapes: the training shapes
    (causal; phase 7's and phase 14's data-parallel step's), MAGNeT's (not
    causal), the tiles' edges at D = 64 (T = 1, 63, 65, 129; and in fp32 the
    32-row tiles' T = 31, 33, 64, 127), D = 32 and 128 at T = 130, q, k, v as strided
    slices of one fused projection, and D = 36 (padded to 40 by the wrapper
    for the bf16 kernels' 16-byte copies); both masks except at the model
    shapes.  Then each kernel timed at the training shape in
    bf16 beside SDPA's backward and the bound, and in fp32 (also at phase
    14's [2, 501, 16, 64]) beside SDPA's fp32 backward: the entries of both
    dtypes, the fp32 ones at the training shape."""
    print_attention_bwd_resources()
    gen = torch.Generator().manual_seed(11)
    both = (True, False)
    fp32_only = ((torch.float32, 1e-4),)
    every = (*fp32_only, (torch.bfloat16, 2e-2))
    cases = [(TRAIN_ATTN_SHAPE, (True,), False, every), (LM_DP_ATTN_SHAPE, (True,), False, every),
             (tuple(ATTN_SHAPE.values()), (False,), False, every),
             *(((2, t, 3, 64), both, False, every) for t in (1, 63, 65, 129)),
             # the edges of the fp32 kernels' 32-row tiles and 64-row blocks
             *(((2, t, 3, 64), both, False, fp32_only) for t in (31, 33, 64, 127)),
             ((1, 130, 3, 32), both, False, every), ((1, 130, 3, 128), both, False, every),
             ((2, 257, 4, 64), both, True, every), ((1, 70, 2, 36), both, False, every)]
    worst = {}
    for shape, masks, fused, dtypes in cases:
        inputs = _attn_inputs(shape, fused, gen, device)
        layout = ' fused qkv' if fused else ''
        for causal in masks:
            for dtype, tol in dtypes:
                lse_err, rel, err = _attn_bwd_errs(*inputs(dtype), causal)
                worst[(shape, causal, dtype)] = err
                print(f'attention backward {shape}{layout} causal={causal} {dtype}: lse '
                      f'max-abs {lse_err:.3g} (<= 1e-5), gradients max-abs / max {rel:.3g} '
                      f'(<= {tol})', flush=True)
                check(lse_err <= 1e-5, f'lse {shape} {dtype}: max-abs {lse_err:.3g} > 1e-5')
                check(rel <= tol, f'attention backward {shape}{layout} causal={causal} '
                                  f'{dtype}: {rel:.3g} > {tol}')
        del inputs

    B, T, H, D = TRAIN_ATTN_SHAPE
    q, k, v, do = (torch.randn(TRAIN_ATTN_SHAPE, generator=gen).to(device, torch.bfloat16)
                   for _ in range(4))
    o, lse = fused_attention_with_lse(q, k, v, causal=True)
    di = attention_di(o, do)
    args = (q, k, v, do, lse, di)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2), retain_graph=True)
    library = time_ms(sdpa_bwd, 10)
    pairs = T * (T + 1) / 2            # (query, key) pairs a causal row set needs
    product = 2.0 * B * H * pairs * D  # one [T, T] x D product over those pairs
    elems, stats = B * T * H * D, B * H * T
    entries = []
    for name, fn, ref, n_products, n_out in (
            ('flash_attention_bwd_dkv', attention_bwd_dkv, attention_bwd_dkv_reference, 4, 2),
            ('flash_attention_bwd_dq', attention_bwd_dq, attention_bwd_dq_reference, 3, 1)):
        b_ms, b_by = bound_ms(n_products * product, PEAK_BF16,
                              2.0 * (4 + n_out) * elems + 4.0 * 2 * stats)
        entry = dict(name=name, route='cuda', source='audiocraft_tpu_torch/csrc/attention_bwd.cu',
                     replaces='audiocraft_tpu/ops/attention_pallas.py:167 (bundled '
                              f'flash_attention.py:{941 if n_out == 2 else 1287} '
                              f'_flash_attention_bwd_{name.rsplit("_", 1)[1]})',
                     max_abs_err=worst[(TRAIN_ATTN_SHAPE, True, torch.bfloat16)],
                     ms=time_ms(lambda: fn(*args, causal=True), 20),
                     plain_ms=time_ms(lambda: ref(*args, causal=True), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=library)
        entries.append(entry)
        print(f'{name} bf16 {TRAIN_ATTN_SHAPE} causal: kernel {entry["ms"]:.4f} ms, plain '
              f'{entry["plain_ms"]:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {n_products} products)',
              flush=True)
    whole = bound_ms(5 * product, PEAK_BF16, 2.0 * 7 * elems + 8.0 * stats)[0]
    print(f'attention backward bf16 {TRAIN_ATTN_SHAPE} causal: both kernels '
          f'{entries[0]["ms"] + entries[1]["ms"]:.4f} ms, SDPA backward (dq, dk, dv in one '
          f'call) {library:.4f} ms, bound of the whole backward {whole:.4f} ms '
          f'(5 products, {5 * product / 1e9:.1f} GFLOP)', flush=True)
    del q, k, v, out, leaves
    fq, fk, fv, fdo = _attn_inputs(TRAIN_ATTN_SHAPE, True, gen, device)(torch.bfloat16)
    check(fq.stride(1) == 3 * H * D, 'the fused layout is not strided')
    fused = (fq, fk, fv, fdo, lse, attention_di(o, fdo))
    fused_ms = [time_ms(lambda: fn(*fused, causal=True), 20)
                for fn in (attention_bwd_dkv, attention_bwd_dq)]
    print(f'the same on strided q, k, v slices of one fused projection (the model\'s layout): '
          f'dK/dV {fused_ms[0]:.4f} ms, dQ {fused_ms[1]:.4f} ms (information)', flush=True)
    del fq, fk, fv, fdo, fused, args, o, lse, di
    # the fp32 FMA kernels (the training CLI's default fp32 step) at the same
    # shape and at phase 14's data-parallel step's
    name = card()
    for shape in (TRAIN_ATTN_SHAPE, LM_DP_ATTN_SHAPE):
        rows = time_fp32_kernels.time_attention_backward(shape, device, seed=11)
        for kname, row in rows.items():
            check(row['max_rel'] <= 1e-4, f'K3b fp32 {kname} {shape}: {row["max_rel"]:.3g} > 1e-4')
            check(row['repeat_equal'], f'K3b fp32 {kname} {shape}: a second run gives other bits')
            time_fp32_kernels.print_attention_backward(kname, row, name)
        if shape == TRAIN_ATTN_SHAPE:
            pair_ms = sum(row['ms'] for row in rows.values())
            for entry, row in zip(list(entries), rows.values()):
                entries.append(dict(entry, name=entry['name'] + '_fp32',
                                    max_abs_err=row['max_abs_err'],
                                    **{k: row[k] for k in ('ms', 'plain_ms', 'library_ms',
                                                           'bound_ms', 'bound_by')}))
    print(f'K3b fp32 {TRAIN_ATTN_SHAPE} causal: both kernels {pair_ms:.4f} ms, SDPA fp32 '
          f'backward (dq, dk, dv in one call) {entries[-1]["library_ms"]:.4f} ms; card {name}',
          flush=True)
    return entries


def _stage_params(spec: StageSpec, device, dtype, seed: int) -> tp.Dict[str, torch.Tensor]:
    """Random stage weights in the kernel's layout (ops/seanet.stage_params),
    uniform in +-1/sqrt(fan_in) as the encoder's init draws them."""
    gen = torch.Generator().manual_seed(seed)
    C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    shapes = dict(w1=((3 * C, H), 3 * C), b1=((H,), 3 * C), w2=((H, C), H), b2=((C,), H),
                  wd=((2 * s * C, C_out), 2 * s * C), bd=((C_out,), 2 * s * C))
    return {name: ((torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in))
            .to(device, dtype) for name, (shape, fan_in) in shapes.items()}


def _stage_errs(x, params, spec, chunk: int) -> tp.Tuple[tp.Tuple[float, ...], float]:
    """K4 against its plain version, the plain one run on ``chunk`` batch rows
    at a time (its fp32 temporaries at b128 would not fit): max-abs / max-abs
    of the plain output over all frames, the first 4 and the last 4; and the
    max-abs over all frames."""
    out = fused_stage(x, params, spec)
    check(bool(torch.isfinite(out).all()), f'fused_stage {spec} {tuple(x.shape)}: non-finite')
    worst = [0.0, 0.0, 0.0]
    top = [0.0, 0.0, 0.0]
    for i in range(0, x.shape[0], chunk):
        ref = fused_stage_reference(x[i:i + chunk], params, spec).float()
        got = out[i:i + chunk].float()
        for j, sl in enumerate((slice(None), slice(0, 4), slice(-4, None))):
            worst[j] = max(worst[j], float((got[..., sl] - ref[..., sl]).abs().max()))
            top[j] = max(top[j], float(ref[..., sl].abs().max()))
        del ref, got
    return tuple(w / max(t, 1e-30) for w, t in zip(worst, top)), worst[0]


def print_stage_profile(si: int, spec: StageSpec, x: torch.Tensor,
                        params: tp.Dict[str, torch.Tensor]) -> None:
    """K4's resources (cudaFuncGetAttributes and the occupancy API), its
    per-phase split from one launch with the cycle counter on (thread 0 of
    each block, summed over blocks) and the weight bytes its design reads
    from L2."""
    B, C, L = x.shape
    info = stage_kernel_info(spec, B, L, x.dtype)
    y, clocks, work = fused_stage_clocks(x, params, spec)
    check(torch.equal(y, fused_stage(x, params, spec)), f'stage {si}: counter changes the output')
    total = sum(clocks.values())
    plan = stage_plan(spec, x.dtype)
    weights = 2 * sum(params[k].numel() for k in ('w1', 'w2', 'wd'))
    l2 = (stage_weight_l2_bytes(spec, plan, B, L, info['blocks']) if plan
          else info['blocks'] * weights)
    print(f"fused_stage {si} resources: {info['registers']} registers x {info['threads']} "
          f"threads, {info['shared_bytes']} B shared, {info['blocks_per_sm']} blocks/SM, "
          f"{info['spill_bytes']} B spilled; plan {plan}; {info['blocks']} blocks; weight "
          f"bytes from L2 {l2 / 1e9:.3f} GB", flush=True)
    print(f'fused_stage {si} per-phase split ({total / 1e9:.3f} G block-cycles): '
          + ', '.join(f'{k} {v / total:.3f}' for k, v in clocks.items()), flush=True)
    if plan:
        # what bounds it: a shared resource (L2, DRAM) lets the time grow less
        # than the block count shrinks; a per-SM limit makes it grow as much
        ms = {b: time_ms(lambda: fused_stage_clocks(x, params, spec, b), 3)
              for b in (info['blocks'], info['blocks'] // 2)}
        print(f"fused_stage {si} with the counter on {info['blocks']} / {info['blocks'] // 2} "
              f"blocks: {ms[info['blocks']]:.3f} / {ms[info['blocks'] // 2]:.3f} ms (ratio "
              f"{ms[info['blocks'] // 2] / ms[info['blocks']]:.3f})", flush=True)
    if work:
        # a warp's own work in a phase against the phase's time at its barrier
        warps = info['threads'] // 32
        print(f'fused_stage {si} warp work / phase time: '
              + ', '.join(f'{k} {work[k] / warps / max(v, 1):.3f}' for k, v in clocks.items()),
              flush=True)


def check_fused_stage(device) -> tp.Tuple[dict, dict]:
    """K4 against its plain version on the same inputs: fp32 (TF32 off; only
    the order of fp32 sums differs) within 1e-5 of the max at B = 16, bf16
    within 1e-2 (the same rounding points; a sum in another order can move a
    bf16-stored z or ELU(r) by one step) at b128, the first and last 4 frames
    checked on their own, at both stage shapes of the fused encode; then
    shapes off the tiles: B = 1, a length whose frames fill no whole tile,
    the shortest length the route takes (one frame), the debug codec's
    widths (C = 4, s = 16, the register-tiled FMA variant in bf16), and the
    tensor-core plan's ragged edges (frames of one tile, one more, one
    fewer; fewer items than SMs), the register-tiled fp32 plan's likewise,
    and a stage only stage_kernel takes.  The fp32 kernel timed at B = 16 x
    10 s (both stages) beside its bound, its plain version and the cuDNN
    module stack in fp32, with its per-phase split and resources.  Then each
    stage timed in bf16 at b128 beside its bound, its plain version and the
    module stack it replaces (resnet block, ELU, downsample conv: cuDNN),
    with its resources, its per-phase split from the cycle counter and its
    weight bytes from L2.  Returns the bf16 entry and the fp32 one."""
    gen = torch.Generator(device=device).manual_seed(60)   # b128 inputs are drawn on the card
    lines = []
    bf16_abs = fp32_abs = 0.0
    fp32_rows = []   # K4 fp32 timed at B = 16 x 10 s, both stages
    name = card()
    encoder32 = get_encodec_32khz(compute_dtype=None).encoder
    for si, (spec, L) in enumerate(STAGES):
        for dtype, batch, tol in ((torch.float32, 16, 1e-5), (torch.bfloat16, BATCH, 1e-2)):
            params = _stage_params(spec, device, dtype, seed=61 + si)
            x = (torch.randn(batch, spec.c_in, L, generator=gen, device=device) * 0.5).to(dtype)
            errs, abs_err = _stage_errs(x, params, spec, chunk=16)
            if dtype == torch.bfloat16:
                bf16_abs = max(bf16_abs, abs_err)
            else:
                fp32_abs = max(fp32_abs, abs_err)
                stack = torch.nn.Sequential(*encoder32.model[1 + 3 * si:4 + 3 * si])
                fp32_rows.append(time_fp32_kernels.time_stage(spec, x, params, stack))
                time_fp32_kernels.print_stage(si, 'B=16 x 10 s', spec, fp32_rows[-1], name)
                check(fp32_rows[-1]['max_rel'] <= 1e-5, f'K4 fp32 stage {si}: timed run apart')
            del x
            lines.append(f'stage {si} {dtype} B={batch}: max-abs / max {errs[0]:.3g}, first 4 '
                         f'frames {errs[1]:.3g}, last 4 {errs[2]:.3g} (<= {tol})')
            check(max(errs) <= tol, f'fused_stage {si} {dtype}: {errs} > {tol}')
    del encoder32
    debug = StageSpec(c_in=4, c_out=8, stride=16)
    cases = [(spec, L, 1) for spec, L in ((STAGES[0][0], 4 * 67), (STAGES[1][0], 4 * 97),
                                           (STAGES[0][0], 4), (STAGES[1][0], 4),
                                           (debug, 16 * 37))]
    # the tensor-core plan's ragged edges: frames of one tile, one more and
    # one fewer; and fewer items than SMs (and than a cluster) for the
    # persistent grid
    # and the 24 kHz codec's fused stage, the kernel's third instance
    for spec in (STAGES[0][0], STAGES[1][0], StageSpec(c_in=32, c_out=64, stride=2)):
        tile = stage_plan(spec, torch.bfloat16).tile
        cases += [(spec, spec.stride * f, 3) for f in (tile, tile + 1, tile - 1)]
        cases.append((spec, spec.stride * (2 * tile + 5), 2))
    # the register-tiled fp32 plan's ragged edges: frames of one item, one
    # more and one fewer, and fewer items than SMs, at every stage it is
    # built for; a stage it is not built for (C = 48) runs stage_kernel
    for spec in (STAGES[0][0], STAGES[1][0], StageSpec(c_in=32, c_out=64, stride=2), debug):
        tile = tiled_plan(spec).tile
        cases += [(spec, spec.stride * f, 3) for f in (tile, tile + 1, tile - 1)]
        cases.append((spec, spec.stride * (2 * tile + 5), 2))
    simt = StageSpec(c_in=48, c_out=96, stride=4)
    check(stage_route(simt, torch.float32)[0] == 0, 'C = 48 does not take stage_kernel')
    cases.append((simt, 4 * 70, 2))
    for spec, L, batch in cases:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            params = _stage_params(spec, device, dtype, seed=65)
            x = (torch.randn(batch, spec.c_in, L, generator=gen, device=device) * 0.5).to(dtype)
            errs, _ = _stage_errs(x, params, spec, chunk=batch)
            check(max(errs) <= tol, f'fused_stage {spec} B={batch} L={L} {dtype}: {errs} > {tol}')
    lines.append('off the tiles (B = 1; frames 67, 97, 1; C = 4, s = 16), at the tensor-core '
                 'plan\'s ragged edges (B = 3, frames tile, tile + 1, tile - 1; B = 2, 2 tile + 5 '
                 'frames; both 32 kHz stages and the 24 kHz stage), at the register-tiled fp32 '
                 'plan\'s (the same at its tiles, the debug codec\'s stage too) and on a stage '
                 'only stage_kernel takes (C = 48): fp32 <= 1e-5, bf16 <= 1e-2, edges included')
    try:
        x = torch.zeros(1, 64, 6, device=device)
        fused_stage(x, _stage_params(STAGES[0][0], device, torch.float32, seed=66), STAGES[0][0])
    except ValueError:
        lines.append('a length not a multiple of the stride refused')
    else:
        raise CheckFailed('fused_stage: L = 6 at stride 4 did not raise')
    for line in lines:
        print(line, flush=True)

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_by = {}   # each stage's limit, weighted by its bound
    encoder = get_encodec_32khz().encoder
    for si, (spec, L) in enumerate(STAGES):
        C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
        params = _stage_params(spec, device, torch.bfloat16, seed=61 + si)
        # packed once, as encoder_stage_weights packs them for the fused encode
        params.update(packed_stage_weights(params, spec))
        x = (torch.randn(BATCH, C, L, generator=gen, device=device) * 0.5).to(torch.bfloat16)
        stack = torch.nn.Sequential(*encoder.model[1 + 3 * si:4 + 3 * si])
        ms = time_ms(lambda: fused_stage(x, params, spec), 5)
        print_stage_profile(si, spec, x, params)
        plain = time_ms(lambda: [fused_stage_reference(x[i:i + 16], params, spec)
                                 for i in range(0, BATCH, 16)], 1)
        with torch.no_grad():
            unfused = time_ms(lambda: stack(x), 3)
        U = L // s
        ops = 2.0 * BATCH * L * (3 * C * H + H * C) + 2.0 * BATCH * U * (2 * s * C * C_out)
        nbytes = 2.0 * (BATCH * C * L + BATCH * C_out * U + 3 * C * H + H * C
                        + 2 * s * C * C_out + H + C + C_out)
        b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes)
        print(f'fused_stage {si} bf16 [{BATCH}, {C}, {L}] -> [{BATCH}, {C_out}, {U}]: kernel '
              f'{ms:.3f} ms, plain {plain:.3f} ms (8 chunks of 16), module stack it replaces '
              f'(cuDNN, information) {unfused:.3f} ms, bound {b_ms:.3f} ms ({b_by}; '
              f'{ops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)', flush=True)
        total['ms'] += ms
        total['plain_ms'] += plain
        total['bound_ms'] += b_ms
        bound_by[b_by] = bound_by.get(b_by, 0.0) + b_ms
        del x
    # the two launches are bounded one by one; the larger share names the limit
    entry = dict(name='fused_stage', route='cuda', source='audiocraft_tpu_torch/csrc/seanet.cu',
                 replaces='audiocraft_tpu/ops/seanet_pallas.py:157',
                 max_abs_err=bf16_abs, ms=total['ms'], plain_ms=total['plain_ms'],
                 bound_ms=total['bound_ms'], bound_by=max(bound_by, key=bound_by.get),
                 library_ms=None)
    # the fp32 parity path's register-tiled kernel: both stages at B = 16 x 10
    # s, its library time the cuDNN module stack in fp32 with TF32 off
    sums = {k: sum(r[k] for r in fp32_rows) for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
    print(f"K4 fp32 both stages at B = 16 x 10 s: kernel {sums['ms']:.3f} ms, plain "
          f"{sums['plain_ms']:.3f} ms, module stack {sums['library_ms']:.3f} ms, bound "
          f"{sums['bound_ms']:.4f} ms; card {name}", flush=True)
    by = {b: sum(r['bound_ms'] for r in fp32_rows if r['bound_by'] == b)
          for b in ('operations', 'bytes')}
    entry_f32 = dict(name='fused_stage_fp32', route='cuda',
                     source='audiocraft_tpu_torch/csrc/seanet.cu',
                     replaces='audiocraft_tpu/ops/seanet_pallas.py:157', max_abs_err=fp32_abs,
                     bound_by=max(by, key=by.get), **sums)
    return entry, entry_f32


def _mono_errs(fn, ref, x, w, b) -> tp.Tuple[float, float]:
    out = fn(x, w, b)
    check(bool(torch.isfinite(out).all()), f'{fn.__name__} {tuple(x.shape)}: non-finite')
    plain = ref(x, w, b)
    check(out.shape == plain.shape, f'{fn.__name__}: {tuple(out.shape)} != {tuple(plain.shape)}')
    diff = (out.float() - plain.float()).abs()
    scale = plain.float().abs()
    if x.dtype == torch.bfloat16:   # one bf16 step of each output
        check(bool((diff <= 2 ** -7 * scale + 1e-6 * float(scale.max())).all()),
              f'{fn.__name__} {tuple(x.shape)} bf16: more than one bf16 step apart')
    return float(diff.max() / scale.max()), float(diff.max())


def check_mono_conv(device) -> tp.Dict[str, dict]:
    """K5 and K6 against their plain versions: fp32 within 1e-6 of the max
    (TF32 off; seven fp32 products summed in another order), bf16 within one
    bf16 step of each output; at b128 x 10 s, at B = 1 off the 1024-sample
    tiles, and at the shortest lengths (K5: one output; K6: T = 4, one more
    than its pad); at the edges of the 1024-output item (T = 1023, 1024 and
    1025 at B = 3, whose odd-length rows start off 4 bytes in bf16); and at
    32 channels x 5 taps, a width that takes the generic instance.  Then
    both timed in bf16 at b128 beside the bound, the plain version, the
    kernel's time before this design and one cuDNN F.conv1d on the padded
    signal, with the output's rate beside y.fill_(0) on the same tensor."""
    gen = torch.Generator().manual_seed(70)
    k, h = CONV0_TAPS, (CONV0_TAPS - 1) // 2
    T = SECONDS * SAMPLE_RATE
    w32 = (torch.rand(CONV0_CHANNELS, 1, k, generator=gen) * 2 - 1) / math.sqrt(k)
    b32 = (torch.rand(CONV0_CHANNELS, generator=gen) * 2 - 1) / math.sqrt(k)
    w5 = (torch.rand(32, 1, 5, generator=gen) * 2 - 1) / math.sqrt(5)
    b5 = (torch.rand(32, generator=gen) * 2 - 1) / math.sqrt(5)
    cases = {'banded_mono_conv': (banded_mono_conv, banded_mono_conv_reference, k - 1),
             'mono_input_conv': (mono_input_conv, mono_input_conv_reference, 0)}
    errs: tp.Dict[tuple, float] = {}
    abs_errs: tp.Dict[str, float] = {}
    for name, (fn, ref, extra) in cases.items():
        shapes = [(BATCH, T, w32, b32), (1, 1000 + 3, w32, b32),
                  (1, 1 if extra else h + 1, w32, b32), (3, 1023, w32, b32),
                  (3, 1024, w32, b32), (3, 1025, w32, b32), (2, 1025, w5, b5),
                  (1, 1 if extra else 3, w5, b5)]
        for batch, length, w, b in shapes:
            pad = w.shape[-1] - 1 if extra else 0
            x = torch.randn(batch, 1, length + pad, generator=gen) * 0.4
            for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, None)):
                xd, wd, bd = (t.to(device, dtype) for t in (x, w, b))
                err, abs_err = _mono_errs(fn, ref, xd, wd, bd)
                errs[(name, batch, length, w.shape[0], dtype)] = err
                if (batch, dtype) == (BATCH, torch.bfloat16):
                    abs_errs[name] = abs_err
                if tol is not None:
                    check(err <= tol, f'{name} B={batch} T={length} C={w.shape[0]} {dtype}: '
                                      f'{err:.3g} > {tol}')
            del x
        big = (name, BATCH, T, CONV0_CHANNELS)
        print(f'{name}: max-abs / max fp32 {errs[big + (torch.float32,)]:.3g} at '
              f'[{BATCH}, 1, {T}] (<= 1e-6), bf16 {errs[big + (torch.bfloat16,)]:.3g} '
              f'(one bf16 step of each output); B = 1 at T = 1003 and at the shortest length, '
              f'B = 3 at T = 1023, 1024, 1025, and 32 channels x 5 taps at B = 2, T = 1025 and '
              f'at the shortest length held to the same', flush=True)

    results = {}
    x = (torch.randn(BATCH, 1, T + k - 1, generator=gen) * 0.4).to(device, torch.bfloat16)
    w, b = w32.to(device, torch.bfloat16), b32.to(device, torch.bfloat16)
    library = time_ms(lambda: torch.nn.functional.conv1d(x, w, b), 5)
    ops = 2.0 * BATCH * T * CONV0_CHANNELS * k
    nbytes = 2.0 * (BATCH * (T + k - 1) + BATCH * CONV0_CHANNELS * T + CONV0_CHANNELS * (k + 1))
    b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes)
    for name, (fn, ref, extra) in cases.items():
        xin = x if extra else x[..., h:h + T].contiguous()
        entry = dict(name=name, route='cuda', source='audiocraft_tpu_torch/csrc/seanet.cu',
                     replaces=('audiocraft_tpu/ops/seanet_pallas.py:407' if extra else
                               'audiocraft_tpu/ops/seanet_pallas.py:515'),
                     max_abs_err=abs_errs[name],
                     ms=time_ms(lambda: fn(xin, w, b), 10),
                     plain_ms=time_ms(lambda: ref(xin, w, b), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=library)
        results[name] = entry
        out_bytes = 2.0 * BATCH * CONV0_CHANNELS * T
        print(f'{name} bf16 [{BATCH}, 1, {T}] -> [{BATCH}, {CONV0_CHANNELS}, {T}]: kernel '
              f'{entry["ms"]:.3f} ms ({out_bytes / entry["ms"] / 1e9:.3f} TB/s of output), plain '
              f'{entry["plain_ms"]:.3f} ms, cuDNN F.conv1d on the padded signal {library:.3f} ms, '
              f'bound {b_ms:.3f} ms ({b_by}); before this design {MONO_OLD_MS} ms', flush=True)
    y = torch.empty(BATCH, CONV0_CHANNELS, T, dtype=torch.bfloat16, device=device)
    fill = time_ms(lambda: y.fill_(0), 10)
    print(f'write ceiling: y.fill_(0) on the same [{BATCH}, {CONV0_CHANNELS}, {T}] bf16 output '
          f'{fill:.3f} ms ({2.0 * y.numel() / fill / 1e9:.3f} TB/s); card {card()}', flush=True)
    del y
    return results


def _clips(batch: int, samples: int, device, seed: int) -> torch.Tensor:
    """Seeded test audio: a few random tones plus noise, [batch, 1, samples]."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(samples) / SAMPLE_RATE
    freqs = 50 + 2000 * torch.rand(batch, 4, 1, generator=gen)
    tones = torch.sin(2 * math.pi * freqs * t).sum(1, keepdim=True) * 0.1
    noise = 0.02 * torch.randn(batch, 1, samples, generator=gen)
    return (tones + noise).to(device)


def seed_codebooks(model, wav: torch.Tensor, seed: int = 3) -> None:
    """Codebook q takes random residual frames left after q codebooks, as a
    k-means init would start, so that codes spread over the codebook, and
    counts as inited.  A fresh codec's codebooks are zeros (``kmeans_init``),
    on which every row takes code 0, so every random-weight codec that
    encodes or decodes here is seeded first."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        x = model.encoder(model._cast(wav)).float()
        residual = x.transpose(1, 2).reshape(-1, x.shape[1])
        for layer in model.quantizer.vq.layers:
            cb = layer._codebook
            pick = torch.randperm(residual.shape[0], generator=gen)[:cb.embed.shape[0]]
            cb.embed.copy_(residual[pick.to(residual.device)])
            cb.embed_avg.copy_(cb.embed)
            cb.inited.fill_(1)
            residual = residual - cb.embed[quantize(residual, cb.embed).long()]


def layer_ms(stack, x: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[tp.Tuple[str, float]]]:
    """Run a SEANet stack layer by layer, with CUDA events around each layer."""
    marks = []
    with torch.no_grad():
        for layer in stack.model:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            x = layer(x)
            end.record()
            marks.append((type(layer).__name__, start, end))
    torch.cuda.synchronize()
    return x, [(name, start.elapsed_time(end)) for name, start, end in marks]


def print_breakdown(model, wav: torch.Tensor) -> None:
    """Where one encode and one decode spend device time, by layer kind."""
    emb, enc = layer_ms(model.encoder, model._cast(wav))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    codes = model.quantizer.encode(emb.float())
    latent = model.decode_latent(codes)
    end.record()
    _, dec = layer_ms(model.decoder, model._cast(latent))
    for stack, times in (('encoder', enc), ('decoder', dec)):
        kinds: tp.Dict[str, float] = {}
        for name, ms in times:
            kinds[name] = kinds.get(name, 0.0) + ms
        print(f'{stack} layers (ms): ' + ', '.join(f'{i}:{n} {ms:.2f}' for i, (n, ms)
                                                   in enumerate(times)))
        print(f'{stack} by kind (ms): ' + ', '.join(f'{n} {ms:.2f}' for n, ms in kinds.items())
              + f', total {sum(kinds.values()):.2f}')
    print(f'rvq encode + latent lookup: {start.elapsed_time(end):.2f} ms', flush=True)


def phase_main_path(device) -> dict:
    print('== phase 3: main path, get_encodec_32khz() encode (its default route on the card: '
          'the fused route, K5 + K4) + decode', flush=True)
    model = get_encodec_32khz()
    check(model.compute_dtype == 'bfloat16', 'the 32 kHz default is not bf16')
    seed_codebooks(model, _clips(16, SECONDS * SAMPLE_RATE, device, seed=4))
    wav = _clips(BATCH, SECONDS * SAMPLE_RATE, device, seed=5)
    model.decode(model.encode(wav)[0])   # warm-up, not counted
    torch.cuda.synchronize()

    check(model.fused_default(wav), 'the default route at b128 x 10 s is not the fused one')
    rvq_encode.launches = lstm_layer.launches = 0
    fused_stage.launches = banded_mono_conv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes, scale = model.encode(wav)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = model.decode(codes)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _seanet_launches()
    peak = torch.cuda.max_memory_allocated()

    frames = SECONDS * 50
    check(tuple(codes.shape) == (BATCH, 4, frames) and codes.dtype == torch.int32,
          f'codes {tuple(codes.shape)} {codes.dtype}')
    check(bool(((codes >= 0) & (codes < 2048)).all()), 'codes out of range')
    check(tuple(out.shape) == (BATCH, 1, SECONDS * SAMPLE_RATE), f'wav {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite waveform')
    check(launches['rvq_encode'] == 1, f"rvq launches {launches['rvq_encode']} != 1")
    check(launches['lstm_step'] == 2 * 2,
          f"lstm launches {launches['lstm_step']} != 4 (2 layers, encode and decode)")
    check(launches['fused_stage'] == 2 and launches['banded_mono_conv'] == 1,
          f'the default encode launched {launches}, not K4 twice and K5 once')
    audio = BATCH * SECONDS
    name = card()
    print(f'codes {tuple(codes.shape)}, {int(codes.unique().numel())} distinct; wav '
          f'{tuple(out.shape)}; launches {launches}')
    print(f'encode {t1 - t0:.4f} s = {audio / (t1 - t0):.1f} audio-s tokenized/s; decode '
          f'{t2 - t1:.4f} s = {audio / (t2 - t1):.1f} audio-s decoded/s; peak memory '
          f'{peak / 2**30:.2f} GiB; card {name}', flush=True)
    print('module stack (fused=False) breakdown, layer by layer (the fused route\'s is phase '
          '9\'s):', flush=True)
    print_breakdown(model, wav)
    return launches


def phase_parity(device) -> int:
    """fp32 parity, card against CPU; then the fp32 b16 x 10 s encode on
    both routes.  Returns K4 fp32's launches in one fused encode."""
    print("== phase 4: fp32 parity, card vs CPU (TF32 flags at torch's defaults)", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32,
          "TF32 flags not at torch's defaults: this phase shows the codec turns cuDNN's off")
    gpu = get_encodec_32khz(compute_dtype=None)
    cpu = get_encodec_32khz(compute_dtype=None, device='cpu')
    seed_codebooks(gpu, _clips(8, SECONDS * SAMPLE_RATE, device, seed=6))
    wav = _clips(8, 2 * SAMPLE_RATE, device, seed=7)
    cpu.quantizer.load_state_dict(gpu.quantizer.state_dict())
    with torch.no_grad():
        lat_gpu = gpu.encoder(wav).float()
        lat_cpu = cpu.encoder(wav.cpu()).float()
        rel = float((lat_gpu.cpu() - lat_cpu).abs().max() / lat_cpu.abs().max())
        share = float((gpu.quantizer.encode(lat_gpu).cpu()
                       == cpu.quantizer.encode(lat_cpu)).float().mean())
    print(f'encoder latent [8, 128, 100]: max-abs / max {rel:.3g} (<= 1e-4); '
          f'code match share {share:.6f} (>= 0.995)', flush=True)
    check(rel <= 1e-4, f'latent rel {rel:.3g} > 1e-4')
    check(share >= 0.995, f'code match share {share:.6f} < 0.995')
    check(torch.backends.cudnn.allow_tf32, "the codec did not restore cuDNN's TF32 flag")

    # the fp32 parity path at b16 x 10 s: the card's default route (fused: K5,
    # then K4's register-tiled fp32 kernel for two stages) against the module
    # stack, timed; rows 0-1 against the CPU's module stack
    wav = _clips(PARITY_BATCH, SECONDS * SAMPLE_RATE, device, seed=8)
    name = card()
    check(gpu.fused_default(wav), 'the fp32 default route at b16 x 10 s is not the fused one')
    _reset_launch_counts()
    with torch.no_grad():
        gpu.encode(wav)
    torch.cuda.synchronize()
    k4_fp32 = fused_stage.fp32_launches
    check(k4_fp32 == 2, f'the fp32 fused encode launched K4 fp32 {k4_fp32} times, not 2')
    times = {}
    for route, kw in (('fused (default)', {}), ('module stack', dict(fused=False))):
        with torch.no_grad():
            times[route] = time_ms(lambda: gpu.encode(wav, **kw), 3)
    audio = PARITY_BATCH * SECONDS
    print(f'fp32 encode b{PARITY_BATCH} x {SECONDS} s: ' + ', '.join(
        f'{r} {ms:.3f} ms ({audio / ms * 1e3:.1f} audio-s/s)' for r, ms in times.items())
        + f'; module stack / fused {times["module stack"] / times["fused (default)"]:.2f}; K4 '
        f'fp32 launches in one fused encode {k4_fp32}; card {name}', flush=True)
    with torch.no_grad():
        lat_cpu = cpu.encoder(wav[:2].cpu()).float()
        for route, stages in (('fp32 b16 x 10 s, rows 0-1, fused', 2),
                              ('fp32 b16 x 10 s, rows 0-1, module stack', 0)):
            lat = gpu.encoder(wav, fused_stages=stages)[:2].float()
            _fp32_codes_vs_cpu(route, lat, lat_cpu, gpu, cpu)
    return k4_fp32


def set_attn_kernel(lm, flag) -> None:
    """Route every self-attention of ``lm`` (an LM or JASCO's flow model) by
    ``flag`` (see ops.attention.kernel_route)."""
    for layer in lm.transformer.layers:
        layer.self_attn.attn_kernel = flag


def _descriptions(n: int, device, seed: int) -> dict:
    """n seeded T5 id rows of DESC_LEN, then n null rows (mask 0): what the
    CFG dropout of the facade yields for n descriptions."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 32100, (n, DESC_LEN), generator=gen)
    ids = torch.cat([ids, torch.zeros_like(ids)])
    mask = torch.cat([torch.ones(n, DESC_LEN, dtype=torch.long),
                      torch.zeros(n, DESC_LEN, dtype=torch.long)])
    return {'description': (ids.to(device), mask.to(device))}


def _stage_sequence(lm, batch: int, device, seed: int) -> torch.Tensor:
    """A stage-0 input: all mask ids but a seeded quarter of the positions."""
    gen = torch.Generator().manual_seed(seed)
    T = MAGNET_SECONDS * 50
    seq = torch.full((batch, lm.n_q, T), lm.special_token_id, dtype=torch.long)
    keep = torch.rand(batch, lm.n_q, T, generator=gen) < 0.25
    seq[keep] = torch.randint(0, lm.card, (int(keep.sum()),), generator=gen)
    return seq.to(device)


def phase_magnet(device, lm32, provider32, codec) -> dict:
    print('== phase 5: MAGNeT path, get_magnet_lm(small, 30 s) generate + codec decode',
          flush=True)
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=22))
    lm = copy.deepcopy(lm32).to(torch.bfloat16)
    provider = copy.deepcopy(provider32).to(torch.bfloat16)
    tokenized = _descriptions(PROMPTS, device, seed=20)
    with torch.no_grad():   # warm-up: one stage-0 forward, not counted
        cond = provider(tokenized)
        lm(_stage_sequence(lm, 2 * PROMPTS, device, seed=21), cond)
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(22)
    rvq_encode.launches = lstm_layer.launches = fused_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        cond = provider(tokenized)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens = lm.generate_magnet(gen, condition_tensors=cond, num_samples=PROMPTS,
                                max_gen_len=MAGNET_SECONDS * 50)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    attn_launches = fused_attention.launches
    audio = codec.decode(tokens)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {'flash_attention': attn_launches, 'lstm_step': lstm_layer.launches,
                'rvq_encode': rvq_encode.launches}
    peak = torch.cuda.max_memory_allocated()

    frames = MAGNET_SECONDS * 50
    n_layers = len(lm.transformer.layers)
    check(tuple(tokens.shape) == (PROMPTS, 4, frames), f'tokens {tuple(tokens.shape)}')
    check(bool(((tokens >= 0) & (tokens < lm.card)).all()), 'tokens out of range or masked')
    check(tuple(audio.shape) == (PROMPTS, 1, frames * 640), f'audio {tuple(audio.shape)}')
    check(bool(torch.isfinite(audio).all()), 'non-finite audio')
    check(attn_launches == 20 * n_layers,
          f'attention launches {attn_launches} != 20 stage-0 forwards x {n_layers} layers')
    check(launches['lstm_step'] == 2, f"lstm launches {launches['lstm_step']} != 2 layers")
    audio_s = PROMPTS * MAGNET_SECONDS
    print(f'tokens {tuple(tokens.shape)}, {int(tokens.unique().numel())} distinct; audio '
          f'{tuple(audio.shape)}; launches {launches}')
    print(f'conditions {t1 - t0:.4f} s, generate {t2 - t1:.4f} s, decode {t3 - t2:.4f} s: '
          f'{audio_s / (t3 - t0):.2f} audio-s generated/s end to end '
          f'({audio_s / (t2 - t1):.2f} for the generate alone); peak memory '
          f'{peak / 2**30:.2f} GiB; card {card()}', flush=True)

    with torch.no_grad():
        seq = torch.cat([tokens, tokens])
        cross_kv = lm.transformer.precompute_cross_kv(lm.cross_source(cond, 2 * PROMPTS))
        band = lm.restricted_context_attn_mask(frames, device)
        stage0 = time_ms(lambda: lm(seq, cond, cross_kv=cross_kv), 3)
        banded = time_ms(lambda: lm(seq, cond, cross_kv=cross_kv, attn_mask=band), 3)
        t5 = time_ms(lambda: provider(tokenized), 5)
    print(f'one forward at B={2 * PROMPTS} T={frames}: stage 0 (attention kernel) '
          f'{stage0:.2f} ms, stages 1-3 (plain banded attention) {banded:.2f} ms; '
          f'T5-base encoder + projection at B={2 * PROMPTS} L={DESC_LEN}: {t5:.3f} ms',
          flush=True)
    del lm, provider, cond, cross_kv

    facade = get_debug_magnet()
    audio, tokens = facade.generate(['a short jingle'], generator=torch.Generator().manual_seed(23),
                                    return_tokens=True)
    torch.cuda.synchronize()
    check(tokens.shape[:2] == (1, 4) and bool(((tokens >= 0) & (tokens < 400)).all()),
          f'debug facade tokens {tuple(tokens.shape)}')
    check(bool(torch.isfinite(audio).all()), 'debug facade: non-finite audio')
    print(f'debug facade on {audio.device}: tokens {tuple(tokens.shape)}, audio '
          f'{tuple(audio.shape)}', flush=True)
    return launches


def phase_magnet_parity(device, lm, provider) -> int:
    print('== phase 6: MAGNeT parity in fp32 (TF32 off), attention kernel vs plain path',
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    n = 2
    fused_attention.fp32_launches = 0
    with torch.no_grad():
        cond = provider(_descriptions(n, device, seed=30))
        seq = _stage_sequence(lm, 2 * n, device, seed=31)
        set_attn_kernel(lm, 'auto')
        before = fused_attention.launches
        fast = lm(seq, cond)
        check(fused_attention.launches - before == len(lm.transformer.layers),
              'the stage-0 forward did not take the attention kernel')
        set_attn_kernel(lm, False)
        plain = lm(seq, cond)
    rel = float((fast - plain).abs().max() / plain.abs().max())
    share = float((fast.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f'stage-0 logits [{2 * n}, 4, {seq.shape[-1]}, {lm.card}]: max-abs / max {rel:.3g} '
          f'(<= 1e-4), argmax share {share:.6f} (>= 0.999)', flush=True)
    check(rel <= 1e-4, f'stage-0 logits rel {rel:.3g} > 1e-4')
    check(share >= 0.999, f'stage-0 argmax share {share:.6f} < 0.999')
    tokens = {}
    for flag in ('auto', False):
        set_attn_kernel(lm, flag)
        tokens[flag] = lm.generate_magnet(torch.Generator().manual_seed(32),
                                          condition_tensors=cond, num_samples=n,
                                          max_gen_len=MAGNET_SECONDS * 50, use_sampling=False)
    set_attn_kernel(lm, 'auto')
    match = float((tokens['auto'] == tokens[False]).float().mean())
    k3f_fp32 = fused_attention.fp32_launches
    print(f'greedy generate, kernel route vs plain route: token match share {match:.6f} '
          f'(information; re-masking feeds back its own choices); K3f fp32 launches in this '
          f'phase {k3f_fp32}', flush=True)
    check(k3f_fp32 > 0, 'the fp32 parity phase launched no K3f fp32')
    return k3f_fp32


def _train_conditions(provider, n: int, device, seed: int,
                      cfg_drop: tp.Optional[ClassifierFreeGuidanceDropout] = None) -> dict:
    """Condition tensors of n seeded T5 id rows of DESC_LEN, computed under
    no_grad.  With ``cfg_drop`` the training app's CFG dropout nullifies the
    descriptions (all or none, as the reference does), and a nullified row
    gets mask 0, as the T5 conditioner gives an empty text."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 32100, (n, DESC_LEN), generator=gen)
    mask = torch.ones(n, DESC_LEN, dtype=torch.long)
    if cfg_drop is not None:
        attrs = cfg_drop([ConditioningAttributes(text={'description': f'row {i}'})
                          for i in range(n)])
        for i, attr in enumerate(attrs):
            if attr.text['description'] is None:
                mask[i] = 0
    with torch.no_grad():
        return provider({'description': (ids.to(device), mask.to(device))})


# the fp32 FMA kernels' own counts (of the launches each wrapper counts in all)
FP32_COUNTERS = {'fused_stage_fp32': fused_stage, 'flash_attention_fp32': fused_attention,
                 'flash_attention_bwd_dkv_fp32': attention_bwd_dkv,
                 'flash_attention_bwd_dq_fp32': attention_bwd_dq}


def _launch_counts() -> tp.Dict[str, int]:
    return {'flash_attention': fused_attention.launches,
            'flash_attention_bwd_dkv': attention_bwd_dkv.launches,
            'flash_attention_bwd_dq': attention_bwd_dq.launches,
            'rvq_encode': rvq_encode.launches, 'lstm_step': lstm_layer.launches,
            'fused_stage': fused_stage.launches, 'banded_mono_conv': banded_mono_conv.launches,
            **{name: fn.fp32_launches for name, fn in FP32_COUNTERS.items()}}


def _reset_launch_counts() -> None:
    fused_attention.launches = attention_bwd_dkv.launches = attention_bwd_dq.launches = 0
    rvq_encode.launches = lstm_layer.launches = 0
    fused_stage.launches = banded_mono_conv.launches = 0
    for fn in FP32_COUNTERS.values():
        fn.fp32_launches = 0


def print_train_breakdown(lm, optimizer, state, codec, wav, codes, cond) -> None:
    """Where one training step spends device time: codec encode, forward
    (to the loss), backward, optimizer update, with CUDA events."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    params = list(lm.parameters())
    marks[0].record()
    codec.encode(wav)
    marks[1].record()
    loss = lm_loss(lm, codes, cond, compute_dtype='bfloat16')
    marks[2].record()
    grads = torch.autograd.grad(loss, params)
    marks[3].record()
    optimizer.update(grads, state, params)
    marks[4].record()
    torch.cuda.synchronize()
    parts = [marks[i].elapsed_time(marks[i + 1]) for i in range(4)]
    print('training step split (ms): ' + ', '.join(
        f'{name} {ms:.2f}' for name, ms in zip(('codec encode', 'forward', 'backward',
                                                 'optimizer'), parts))
          + f', total {sum(parts):.2f}', flush=True)


def _profiled_step(step, state, codes, cond) -> tp.Tuple[tp.Any, float]:
    """torch.profiler (host and device) over one LM step: the profile and
    the step's wall ms under it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, codes, cond)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _timed_steps(run: tp.Callable[[], tp.Any], n: int, expect: tp.Dict[str, int],
                 what: str) -> tp.Tuple[list, tp.Dict[str, int], tp.Dict[str, int], int]:
    """One warm-up call of ``run`` (not counted), then ``n`` counted calls,
    each of which must launch exactly ``expect``.  Returns the calls'
    results, the last call's launches, the launches of all ``n`` and the peak
    memory of the ``n`` calls."""
    run()   # warm-up, not counted
    torch.cuda.synchronize()
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    results = []
    for i in range(n):
        before = _launch_counts()
        results.append(run())
        after = _launch_counts()
        counts = {k: after[k] - before[k] for k in after}
        check(counts == expect, f'{what} {i} launches {counts} != {expect}')
    return results, counts, _launch_counts(), torch.cuda.max_memory_allocated()


def print_train_profile(step, state, codes, cond) -> None:
    """torch.profiler over one LM step: device busy time against the step's
    wall time (both under the profiler), and the kernels that take most; then
    the host side: the operators that take most host time by self time, and
    the step's count of dtype copies (``aten::_to_copy``, ``aten::copy_``)
    and of the optimizer's ``torch._foreach`` calls."""
    from torch.autograd import DeviceType
    prof, wall_ms = _profiled_step(step, state, codes, cond)
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print('profiler: no device time seen', flush=True)
    else:
        print(f'profiled LM step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall, idle '
              f'share {1 - busy_ms / wall_ms:.3f} (under the profiler); top kernels (ms, calls): '
              + '; '.join(f'{e.key[:70]} {e.self_device_time_total / 1e3:.2f} {e.count}'
                          for e in kernels[:8]), flush=True)
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in ops) / 1e3
    calls = {name: sum(e.count for e in ops if e.key == name)
             for name in ('aten::_to_copy', 'aten::copy_')}
    foreach = sum(e.count for e in ops if e.key.startswith('aten::_foreach_'))
    ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f'profiled LM step, host: operators\' self time {host_ms:.2f} ms of {wall_ms:.2f} ms '
          f'wall, {sum(e.count for e in ops)} operator calls; {calls["aten::_to_copy"]} '
          f'aten::_to_copy and {calls["aten::copy_"]} aten::copy_ calls, {foreach} optimizer '
          f'torch._foreach calls; top operators by host self time (ms, calls): ' + '; '.join(
              f'{e.key[:50]} {e.self_cpu_time_total / 1e3:.2f} {e.count}' for e in ops[:10]),
          flush=True)


def phase_train(device, lm, provider) -> tp.Dict[str, int]:
    print("== phase 7: training path, get_musicgen_lm('small') + get_encodec_32khz() encode, "
          'AdamW in bf16 compute on fp32 masters', flush=True)
    codec = get_encodec_32khz()
    samples = TRAIN_SECONDS * SAMPLE_RATE
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=40))
    wav = _clips(TRAIN_BATCH, samples, device, seed=41)   # the fixed batch
    optimizer = make_optimizer('adamw', TRAIN_LR, betas=(0.9, 0.95), weight_decay=0.1)
    step = make_lm_train_step(lm, optimizer, compute_dtype='bfloat16')
    state = optimizer.init(list(lm.parameters()))
    cfg_drop = ClassifierFreeGuidanceDropout(p=0.1, seed=42)
    n_layers = len(lm.transformer.layers)

    def one_step():
        cond = _train_conditions(provider, TRAIN_BATCH, device, seed=43, cfg_drop=cfg_drop)
        t0 = time.perf_counter()
        codes = codec.encode(wav)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = float(step(state, codes, cond)['loss'])   # synchronises
        return codes, cond, loss, t1 - t0, time.perf_counter() - t1

    expect = {'flash_attention': n_layers, 'flash_attention_bwd_dkv': n_layers,
              'flash_attention_bwd_dq': n_layers, 'rvq_encode': 1, 'lstm_step': 2,
              'fused_stage': 2, 'banded_mono_conv': 1,   # the encode's default, fused route
              **{name: 0 for name in FP32_COUNTERS}}     # bf16 compute: no fp32 kernel
    results, _, launches, peak = _timed_steps(one_step, TRAIN_STEPS, expect, 'step')
    codes, cond = results[-1][:2]
    losses, encode_s, step_s = ([r[i] for r in results] for i in (2, 3, 4))

    B, K, T = codes.shape
    check((B, K, T) == (TRAIN_BATCH, 4, TRAIN_SECONDS * 50), f'codes {tuple(codes.shape)}')
    check(all(math.isfinite(x) for x in losses), f'non-finite loss {losses}')
    check(losses[-1] < losses[0], f'the loss did not fall: {losses}')
    check(all(p.dtype == torch.float32 for p in lm.parameters()), 'master parameters not fp32')

    mean_enc, mean_step = sum(encode_s) / TRAIN_STEPS, sum(step_s) / TRAIN_STEPS
    audio = TRAIN_BATCH * TRAIN_SECONDS
    print(f'losses {[round(x, 5) for x in losses]}; launches over {TRAIN_STEPS} steps '
          f'{launches}')
    print(f'step (mean of {TRAIN_STEPS}): codec encode {mean_enc * 1e3:.1f} ms, LM step '
          f'{mean_step * 1e3:.1f} ms; {B * K * T / mean_step:.0f} codes trained/s by the LM '
          f'step, {B * K * T / (mean_enc + mean_step):.0f} with the encode; '
          f'{audio / (mean_enc + mean_step):.2f} audio-s trained/s; peak memory '
          f'{peak / 2**30:.2f} GiB; card {card()}', flush=True)
    print(f'step times (s): encode {[round(x, 4) for x in encode_s]}, LM '
          f'{[round(x, 4) for x in step_s]}', flush=True)
    print_train_breakdown(lm, optimizer, state, codec, wav, codes, cond)
    print_train_profile(step, state, codes, cond)

    # the gradient of every parameter, the self-attention projections included
    _, grads = lm_loss_and_grads(lm, codes, cond, compute_dtype='bfloat16')
    names = [name for name, _ in lm.named_parameters()]
    for name, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()), f'{name}: non-finite gradient')
        parts = g.chunk(3) if name.endswith('self_attn.in_proj_weight') else (g,)
        check(all(float(part.abs().max()) > 0 for part in parts), f'{name}: zero gradient')
    in_proj = sum(name.endswith('self_attn.in_proj_weight') for name in names)
    check(in_proj == n_layers, f'{in_proj} self-attention projections')
    print(f'gradients: {len(names)} parameters finite and non-zero, the q, k and v rows of '
          f'{in_proj} self_attn.in_proj_weight included', flush=True)
    del grads, state
    launches.update(time_fp32_step(lm, codes, cond))

    train_lm.main(['--debug', '--synthetic', '--steps', '2', '--log-every', '1'])
    torch.cuda.synchronize()
    print('training CLI: --debug --synthetic --steps 2 on the card', flush=True)
    return launches


FP32_STEPS = 2   # timed fp32 LM steps in phase 7, after one warm-up


def time_fp32_step(lm, codes, cond) -> tp.Dict[str, int]:
    """The fp32 LM step (``compute_dtype=None``, the training CLI's default)
    on phase 7's batch: one warm-up, then FP32_STEPS timed steps, each of
    which must launch K3f fp32 and both K3b fp32 kernels once a layer and no
    bf16 attention kernel.  Prints each step's ms, the peak memory and K3b
    fp32's share of the step: its kernels' device time in one more step under
    torch.profiler, against the timed steps' mean.  Restores the model's
    parameters after, so that phase 8 starts from phase 7's bf16 state.
    Returns the K3b fp32 launches of the timed steps."""
    from torch.autograd import DeviceType
    n_layers = len(lm.transformer.layers)
    saved = {k: v.clone() for k, v in lm.state_dict().items()}
    optimizer = make_optimizer('adamw', TRAIN_LR, betas=(0.9, 0.95), weight_decay=0.1)
    step = make_lm_train_step(lm, optimizer, compute_dtype=None)
    state = optimizer.init(list(lm.parameters()))

    def one_step():
        t0 = time.perf_counter()
        loss = float(step(state, codes, cond)['loss'])   # synchronises
        return loss, (time.perf_counter() - t0) * 1e3

    attn = ('flash_attention', 'flash_attention_bwd_dkv', 'flash_attention_bwd_dq')
    expect = {name: 0 for name in _launch_counts()}
    expect.update({name: n_layers for name in attn})   # every dtype's launches
    expect.update({name + '_fp32': n_layers for name in attn})
    results, per_step, launches, peak = _timed_steps(one_step, FP32_STEPS, expect, 'fp32 step')
    losses, step_ms = ([r[i] for r in results] for i in (0, 1))
    check(all(math.isfinite(x) for x in losses), f'fp32 step: non-finite loss {losses}')
    mean = sum(step_ms) / FP32_STEPS
    prof, _ = _profiled_step(step, state, codes, cond)
    k3b = {name: [0.0, 0] for name in ('flash_bwd_dkv_f32_tiled', 'flash_bwd_dq_f32_tiled')}
    for e in prof.key_averages():
        for name, row in k3b.items():
            if e.device_type == DeviceType.CUDA and name in e.key:
                row[0] += e.self_device_time_total / 1e3
                row[1] += e.count
    check(all(n == n_layers for _, n in k3b.values()),
          f'profiled fp32 step: K3b fp32 launches {k3b} (want {n_layers} each)')
    k3b_ms = sum(ms for ms, _ in k3b.values())
    B, K, T = codes.shape
    print(f'fp32 LM step (compute_dtype=None, the training CLI\'s default) at B={B} T={T}: '
          f'{[round(x, 2) for x in step_ms]} ms, mean {mean:.2f} ms, {B * K * T / mean * 1e3:.0f} '
          f'codes trained/s; losses {[round(x, 5) for x in losses]}; peak memory '
          f'{peak / 2**30:.2f} GiB; launches a step {per_step}; K3b fp32 device time in a '
          f'profiled step: ' + ', '.join(f'{name} {ms:.3f} ms ({n} launches)'
                                        for name, (ms, n) in k3b.items())
          + f', {k3b_ms:.2f} ms, {k3b_ms / mean:.1%} of the timed mean; card {card()}',
          flush=True)
    del state, step, optimizer, prof
    lm.load_state_dict(saved)
    torch.cuda.empty_cache()
    return {name + '_fp32': launches[name + '_fp32'] for name in attn[1:]}


# bf16 model gradients, kernel route against plain route (phase 8): the whole
# gradient's relative L2 and the worst parameter's max-abs / max, bounded at
# twice what the fp32-FMA K3b kernels gave on the same batch in the same
# state, after phase 7 (2.96e-3 and 8.58e-3 on an NVIDIA H100 80GB HBM3 at
# 700 W).  This bounds the model-level bf16 gap only: the tensor-core kernels
# read the same (2.95e-3 and 8.55e-3), so the gap comes from bf16 rounding
# elsewhere in the model, and this check cannot tell a small fault in K3b from
# none.  Phase 2, which holds each K3b kernel against its plain twin at 2e-2
# of each gradient's max-abs, is the check of K3b's numerics.
BF16_GRAD_L2, BF16_GRAD_WORST = 5.9e-3, 1.72e-2


def _route_gradients(lm, codes, cond, compute_dtype) -> tp.Tuple[float, float, float, str, float]:
    """Loss and gradients of the kernel route and of the plain route on one
    batch: (kernel loss, plain loss, worst parameter gradient max-abs / max,
    its name, whole gradient relative L2).  The kernel route must launch
    K3f and both K3b kernels once per layer."""
    n_layers = len(lm.transformer.layers)
    results = {}
    for flag in ('auto', False):
        set_attn_kernel(lm, flag)
        before = _launch_counts()
        loss, grads = lm_loss_and_grads(lm, codes, cond, compute_dtype=compute_dtype)
        after = _launch_counts()
        if flag:
            for name in ('flash_attention', 'flash_attention_bwd_dkv', 'flash_attention_bwd_dq'):
                check(after[name] - before[name] == n_layers,
                      f'kernel route: {name} launched {after[name] - before[name]} times')
        results[flag] = (float(loss), grads)
    set_attn_kernel(lm, 'auto')
    (loss_k, grads_k), (loss_p, grads_p) = results['auto'], results[False]
    worst, worst_name = 0.0, ''
    for (name, _), gk, gp in zip(lm.named_parameters(), grads_k, grads_p):
        check(bool(torch.isfinite(gk).all()), f'{name}: non-finite gradient ({compute_dtype})')
        top = float(gp.abs().max())
        err = float((gk - gp).abs().max()) / top if top > 0 else float(gk.abs().max())
        if err > worst:
            worst, worst_name = err, name
    diff = torch.sqrt(sum((gk - gp).double().square().sum() for gk, gp in zip(grads_k, grads_p)))
    norm = torch.sqrt(sum(gp.double().square().sum() for gp in grads_p))
    return loss_k, loss_p, worst, worst_name, float(diff / norm)


def phase_train_parity(device, lm, provider) -> tp.Dict[str, int]:
    """fp32 (TF32 off): loss within 1e-5 relative, every parameter's gradient
    within 1e-3 of its max-abs and the whole within 1e-4 relative L2 of the
    plain route, then three AdamW steps on each route.  bf16 compute on the
    same batch: both routes round at other points (K3f's output and K3b's
    gradients in bf16, P and dS rounded once to bf16 in K3b, against fp32
    softmax and autograd on the plain route), so the gap is that of bf16
    rounding across the model, bounded by BF16_GRAD_L2 and BF16_GRAD_WORST
    (see there; phase 2, not this, checks K3b's own numerics)."""
    print('== phase 8: training parity in fp32 (TF32 off) and bf16, kernel route vs plain route',
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    codec = get_encodec_32khz()
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=50))
    codes = codec.encode(_clips(2, SECONDS * SAMPLE_RATE, device, seed=51))[0]
    cond = _train_conditions(provider, 2, device, seed=52)
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    _reset_launch_counts()
    loss_k, loss_p, worst, worst_name, rel_l2 = _route_gradients(lm, codes, cond, None)
    fp32_launches = {k: v for k, v in _launch_counts().items() if k.endswith('_fp32')}
    check(all(fp32_launches[k] > 0 for k in ('flash_attention_fp32', 'flash_attention_bwd_dkv_fp32',
                                             'flash_attention_bwd_dq_fp32')),
          f'the fp32 gradients launched {fp32_launches}')
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f'B=2 T={codes.shape[-1]} fp32: loss {loss_k:.6f} vs {loss_p:.6f}, relative '
          f'{rel_loss:.3g} (<= 1e-5); worst parameter gradient max-abs / max {worst:.3g} '
          f'({worst_name}, <= 1e-3); whole gradient relative L2 {rel_l2:.3g} (<= 1e-4)',
          flush=True)
    check(rel_loss <= 1e-5, f'fp32 loss relative {rel_loss:.3g} > 1e-5')
    check(worst <= 1e-3, f'{worst_name}: gradient max-abs / max {worst:.3g} > 1e-3')
    check(rel_l2 <= 1e-4, f'gradient relative L2 {rel_l2:.3g} > 1e-4')

    loss_k, loss_p, worst, worst_name, rel_l2 = _route_gradients(lm, codes, cond, 'bfloat16')
    print(f'B=2 T={codes.shape[-1]} bf16 compute: loss {loss_k:.6f} vs {loss_p:.6f}; worst '
          f'parameter gradient max-abs / max {worst:.3g} ({worst_name}, <= {BF16_GRAD_WORST}); '
          f'whole gradient relative L2 {rel_l2:.3g} (<= {BF16_GRAD_L2})', flush=True)
    check(worst <= BF16_GRAD_WORST,
          f'bf16 {worst_name}: gradient max-abs / max {worst:.3g} > {BF16_GRAD_WORST}')
    check(rel_l2 <= BF16_GRAD_L2, f'bf16 gradient relative L2 {rel_l2:.3g} > {BF16_GRAD_L2}')

    trajectories, finals = {}, {}
    for flag in ('auto', False):
        set_attn_kernel(lm, flag)
        lm.load_state_dict(start)
        optimizer = make_optimizer('adamw', TRAIN_LR, betas=(0.9, 0.95), weight_decay=0.1)
        step = make_lm_train_step(lm, optimizer)
        state = optimizer.init(list(lm.parameters()))
        trajectories[flag] = [float(step(state, codes, cond)['loss']) for _ in range(3)]
        finals[flag] = [p.detach().clone() for p in lm.parameters()]
    set_attn_kernel(lm, 'auto')
    rels = [abs(a - b) / abs(b) for a, b in zip(trajectories['auto'], trajectories[False])]
    moved = max(float((a - b).abs().max()) for a, b in zip(finals['auto'], finals[False]))
    print(f'3 AdamW steps (lr {TRAIN_LR}): losses kernel {trajectories["auto"]}, plain '
          f'{trajectories[False]}; relative {[f"{r:.3g}" for r in rels]} (step 1 <= 1e-5, '
          f'later <= 1e-4: Adam turns rounding of near-zero gradients into whole lr steps); '
          f'parameters max-abs apart {moved:.3g} (information); the fp32 kernels\' launches '
          f'in the fp32 gradients {fp32_launches}', flush=True)
    check(rels[0] <= 1e-5 and max(rels[1:]) <= 1e-4, f'AdamW losses apart: {rels}')
    return fp32_launches


def _event() -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def print_fused_breakdown(model, wav: torch.Tensor) -> None:
    """Where one encode on the fused route spends device time, CUDA events
    around the route's own calls: the input conv (K5, and cuDNN's module
    conv of the earlier default for comparison), K4's two stages, each
    remaining layer by kind, the RVQ."""
    enc = model.encoder
    conv0: tp.List[torch.cuda.Event] = []

    def k5(x):
        conv0.append(_event())
        y = enc._conv0_kernel(x)
        conv0.append(_event())
        return y

    with torch.no_grad():
        x = model._cast(wav)
        begin = _event()
        enc.model[0](x)
        cudnn_marks = (begin, _event())
        start = _event()
        x, next_layer = fused_encoder_apply(enc, x, 2, k5)
        end = _event()
        check(len(conv0) == 2 and next_layer == 7, f'fused route: next layer {next_layer}')
        marks = [('conv0 (K5)', conv0[0], conv0[1]), ('K4 stages 0-1', conv0[1], end)]
        for layer in enc.model[next_layer:]:
            begin = _event()
            x = layer(x)
            marks.append((type(layer).__name__, begin, _event()))
        begin = _event()
        model.quantizer.encode(x.float())
        marks.append(('rvq encode', begin, _event()))
    torch.cuda.synchronize()
    times = [(name, a.elapsed_time(b)) for name, a, b in marks]
    kinds: tp.Dict[str, float] = {}
    for name, ms in times:
        kinds[name] = kinds.get(name, 0.0) + ms
    print('fused route (K5 + K4) encode by kind (ms): ' + ', '.join(
        f'{n} {ms:.2f}' for n, ms in kinds.items()) + f', total {sum(kinds.values()):.2f}; '
          f'cuDNN\'s input conv on the same input {cudnn_marks[0].elapsed_time(cudnn_marks[1]):.2f} '
          f'ms (the earlier default\'s)', flush=True)


def _seanet_launches() -> tp.Dict[str, int]:
    return {'fused_stage': fused_stage.launches, 'banded_mono_conv': banded_mono_conv.launches,
            'rvq_encode': rvq_encode.launches, 'lstm_step': lstm_layer.launches}


# the encode routes of phase 9: name -> encode() arguments
ROUTES = {'module stack': dict(fused=False), 'fused + K5 (default)': {},
          'conv0_kernel alone': dict(fused=False, conv0_kernel=True)}


def _fused_cudnn_encode(model, wav: torch.Tensor) -> torch.Tensor:
    """The fused route with cuDNN's input conv (the module's), which the
    earlier default ran: for timing beside the routes."""
    with torch.no_grad():
        x, next_layer = fused_encoder_apply(model.encoder, model._cast(wav), 2)
        for layer in model.encoder.model[next_layer:]:
            x = layer(x)
        return model.quantizer.encode(x.float())


def time_encode_routes(model, debug_model, device) -> None:
    """Each route timed by CUDA events (mean of a few encodes after a warm
    one) at every encode shape of this script: the 32 kHz codec in bf16 at
    ROUTE_SHAPES, and the debug codec (fp32) at B = 1 x 2 s, phase 11's
    prompt encode; the ratio says where the fused route leads."""
    name = card()
    shapes = [(model, 'get_encodec_32khz() bf16', b, s) for b, s in ROUTE_SHAPES]
    shapes.append((debug_model, 'debug codec fp32', 1, 2))
    for codec, what, b, sec in shapes:
        wav = _clips(b, sec * SAMPLE_RATE, device, seed=8)
        reps = 3 if b * sec >= 100 else 10
        row = {route: time_ms(lambda: codec.encode(wav, **kw), reps)
               for route, kw in ROUTES.items()}
        row['fused, cuDNN input conv'] = time_ms(lambda: _fused_cudnn_encode(codec, wav), reps)
        stack, fused = row['module stack'], row['fused + K5 (default)']
        print(f'encode routes, {what} B={b} x {sec} s (ms, CUDA events, mean of {reps}): '
              + ', '.join(f'{r} {ms:.3f}' for r, ms in row.items())
              + f'; module stack / fused + K5 {stack / fused:.2f}; card {name}', flush=True)
        del wav


def _fp32_codes_vs_cpu(route: str, lat: torch.Tensor, lat_cpu: torch.Tensor, gpu, cpu) -> None:
    """fp32 codes of a card route against the module stack's on the CPU:
    every differing code at a near-tie of the CPU's distances (top two
    within 1e-4 relative), the latent within 1e-4 relative."""
    rel = float((lat.cpu() - lat_cpu).abs().max() / lat_cpu.abs().max())
    codes = gpu.quantizer.encode(lat).cpu()
    codes_cpu = cpu.quantizer.encode(lat_cpu)
    B, D, T = lat_cpu.shape
    rows = lat_cpu.transpose(1, 2).reshape(B * T, D)
    differ = (codes != codes_cpu).any(1).reshape(B * T)
    near = _near_ties(rows, cpu.quantizer.embeds(),
                      codes_cpu.permute(1, 0, 2).reshape(codes_cpu.shape[1], -1), rel=1e-4)
    print(f'{route} fp32 on the card vs the module stack on the CPU, latent [{B}, {D}, {T}]: '
          f'max-abs / max {rel:.3g} (<= 1e-4); frames with another code {int(differ.sum())} of '
          f'{B * T}, all at near-ties of the CPU\'s distances: '
          f'{bool((near | ~differ).all())}', flush=True)
    check(rel <= 1e-4, f'{route} fp32: latent rel {rel:.3g} > 1e-4')
    check(bool((near | ~differ).all()), f'{route} fp32: {int((differ & ~near).sum())} frames '
                                        'differ from the CPU\'s codes away from a near-tie')


def phase_fused_encode(device) -> tp.Dict[str, int]:
    print('== phase 9: encode routes of get_encodec_32khz(): the module stack, the fused route '
          'with K5 (the default on the card) and conv0_kernel alone', flush=True)
    model = get_encodec_32khz()
    seed_codebooks(model, _clips(16, SECONDS * SAMPLE_RATE, device, seed=4))
    wav = _clips(BATCH, SECONDS * SAMPLE_RATE, device, seed=5)
    frames = SECONDS * 50
    per_encode = {'module stack': dict(fused_stage=0, banded_mono_conv=0),
                  'fused + K5 (default)': dict(fused_stage=2, banded_mono_conv=1),
                  'conv0_kernel alone': dict(fused_stage=0, banded_mono_conv=1)}
    path_launches: tp.Dict[str, int] = {}
    codes, latents = {}, {}
    name = card()
    for route, kw in ROUTES.items():
        model.encode(wav, **kw)   # warm-up, not counted
        torch.cuda.synchronize()
        fused_stage.launches = banded_mono_conv.launches = 0
        rvq_encode.launches = lstm_layer.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(ENCODES):
            t0 = time.perf_counter()
            codes[route] = model.encode(wav, **kw)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = _seanet_launches()
        peak = torch.cuda.max_memory_allocated()
        expect = {k: ENCODES * v for k, v in per_encode[route].items()}
        expect.update(rvq_encode=ENCODES, lstm_step=ENCODES * 2)
        check(launches == expect, f'{route}: launches {launches} != {expect}')
        if route == 'fused + K5 (default)':
            path_launches.update(fused_stage=launches['fused_stage'],
                                 banded_mono_conv=launches['banded_mono_conv'])
        c = codes[route]
        check(tuple(c.shape) == (BATCH, 4, frames) and bool(((c >= 0) & (c < 2048)).all()),
              f'{route}: codes {tuple(c.shape)}')
        audio = BATCH * SECONDS
        print(f'{route}: encode {", ".join(f"{t:.4f}" for t in times)} s = '
              f'{", ".join(f"{audio / t:.1f}" for t in times)} audio-s tokenized/s; peak memory '
              f'{peak / 2**30:.2f} GiB; launches over {ENCODES} encodes {launches}; card {name}',
              flush=True)
        with torch.no_grad():
            latents[route] = model.encoder(
                model._cast(wav), fused_stages=2 if kw.get('fused', True) else 0,
                conv0_kernel=bool(kw.get('conv0_kernel'))).float()
        check(bool(torch.isfinite(latents[route]).all()), f'{route}: non-finite latent')
    ref = latents['module stack']
    for route in ('fused + K5 (default)', 'conv0_kernel alone'):
        rel = float((latents[route] - ref).abs().max() / ref.abs().max())
        share = float((codes[route] == codes['module stack']).float().mean())
        print(f'{route} vs the module stack, bf16 latent [{BATCH}, 128, {frames}]: max-abs / max '
              f'{rel:.3g} (<= 3e-2); code match share {share:.6f} (information: other bf16 '
              f'rounding points move near-tie codes)', flush=True)
        check(rel <= 3e-2, f'{route}: bf16 latent rel {rel:.3g} > 3e-2')
    print_fused_breakdown(model, wav)
    del latents, codes, wav
    time_encode_routes(model, get_debug_musicgen().compression_model, device)
    del model

    check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 flag is not at torch's default")
    gpu = get_encodec_32khz(compute_dtype=None)
    cpu = get_encodec_32khz(compute_dtype=None, device='cpu')
    seed_codebooks(gpu, _clips(8, SECONDS * SAMPLE_RATE, device, seed=6))
    cpu.quantizer.load_state_dict(gpu.quantizer.state_dict())
    wav = _clips(8, 2 * SAMPLE_RATE, device, seed=7)
    with torch.no_grad():
        lat_cpu = cpu.encoder(wav.cpu()).float()
        for route, kw, kernels in (('fused + K5', dict(fused_stages=2), 3),
                                   ('conv0_kernel alone', dict(conv0_kernel=True), 1)):
            before = fused_stage.launches + banded_mono_conv.launches
            lat = gpu.encoder(wav, **kw).float()
            ran = fused_stage.launches + banded_mono_conv.launches - before
            check(ran == kernels, f'{route} fp32: {ran} kernel launches, not {kernels}')
            _fp32_codes_vs_cpu(route, lat, lat_cpu, gpu, cpu)
    return path_launches


def _device_ms(fn, n: int = PROBE_LAUNCHES) -> float:
    """Device time per call of ``fn``: torch.profiler over ``n`` back-to-back
    calls, after one warm call."""
    def launches():
        for _ in range(n):
            fn()

    fn()
    busy, _, _ = _cuda_busy_ms(launches)
    check(busy > 0, 'the profiler saw no device time')
    return busy / n


def _host_us(fn, n: int = PROBE_CALLS) -> float:
    """Host time per call of ``fn``: ``time.perf_counter`` over ``n`` calls
    with no synchronize between them, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / n * 1e6


def _gather_args(view: torch.Tensor) -> tp.Tuple[torch.Tensor, int, int, int, int]:
    """(x, rows, cols, row_stride, col_stride): the gather that copies ``view``,
    a reshape or a 2-D strided slice of the contiguous x."""
    x = view if view._base is None else view._base
    cols = view.shape[-1]
    return x, view.numel() // cols, cols, view.stride(-2), view.stride(-1)


def _read_bytes(view: torch.Tensor) -> int:
    """Bytes a copy of ``view`` must read: every 32-byte sector of x that its
    elements lie in (its rows start on sectors).  For [:, ::4] that is all of
    x; for [::4, :] a quarter of it."""
    _, rows, cols, _, col_stride = _gather_args(view)
    if col_stride * 2 >= 32:
        return rows * cols * 32
    return rows * 32 * -(-((cols - 1) * col_stride + 1) * 2 // 32)


def _probe_timed(device, scale: int) -> tp.List[dict]:
    """P1's seven operations at ``scale`` times the probe's rows, each with
    its kernel call, the one torch call that copies the same result (the view
    made once, then ``clone()``; ``torch.matmul`` for the contraction), its
    plain version, the bytes and operations of its bound and its check."""
    items = []
    for name, kernel, plain in probe_ops.probes(device, scale=scale):
        if 'dot_general' in name:
            continue
        view = plain()
        x, *args = _gather_args(view)
        check(view.clone().data_ptr() != view.data_ptr(), f'{name}: clone() copied nothing')
        items.append(dict(
            name=name, shape=tuple(view.shape), kernel=kernel,
            library=lambda view=view: view.clone(),
            plain=lambda x=x, args=args: gather_reference(x, *args),
            nbytes=_read_bytes(view) + 2 * view.numel(), ops=0.0,
            ok=lambda kernel=kernel, view=view: bool(torch.equal(kernel(), view))))
    gen = torch.Generator(device).manual_seed(7)
    x = torch.randn(512 * scale, 64, generator=gen, device=device).bfloat16()
    taps = torch.randn(4, 64, 32, generator=gen, device=device).bfloat16()
    m = 128 * scale
    items.insert(2, dict(
        name='3d split + dot_general', shape=(m, 32),
        kernel=lambda: split_contract(x, taps),
        library=lambda: x.reshape(m, 256) @ taps.reshape(256, 32),
        plain=lambda: split_contract_reference(x, taps),
        nbytes=2 * (x.numel() + taps.numel() + m * 32), ops=2.0 * m * 256 * 32,
        ok=lambda: _contract_ok(split_contract(x, taps), x, taps)))
    return items


def _contract_ok(out: torch.Tensor, x: torch.Tensor, taps: torch.Tensor) -> bool:
    """The contraction against its plain version: one bf16 step
    (``probe_ops.check``), widened by the bound on how far two fp32 sums of
    the same K = S * C products, taken in other orders, can lie apart
    (K * 2^-24 * sum |x . taps|).  Over 8 M outputs some lie near 0, where
    the order alone moves a sum by more than one bf16 step of it."""
    ref = split_contract_reference(x, taps).float()
    depth = taps.shape[0] * taps.shape[1]
    spread = depth * 2.0 ** -24 * (x.float().abs().reshape(-1, depth)
                                   @ taps.float().abs().reshape(depth, -1))
    diff = (out.float() - ref).abs()
    return out.shape == ref.shape and bool((diff <= 2 ** -7 * ref.abs() + 1e-6 + spread).all())


def _probe_ragged(device) -> None:
    """The gathers and the contraction off the probe's shapes, each equal to
    its plain version (the contraction within probe_ops.check's bf16 step)."""
    gen = torch.Generator(device).manual_seed(11)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=device).bfloat16()
    flat = rand(1030)
    gathers = [('flat count 481, not a multiple of 8', rand(37, 13), (13, 37, 37, 1)),
               ('col_stride 3', rand(64, 96), (64, 32, 96, 3)),
               ('odd row_stride 231', rand(63, 77), (21, 77, 231, 1)),
               ('col_stride 2', rand(64, 128), (32, 64, 256, 2)),
               ('col_stride 8', rand(64, 256), (64, 32, 256, 8)),
               ('x 6 bytes past a 16-byte boundary', flat[3:1027], (8, 128, 128, 1)),
               ('a 16-byte read would pass the end', rand(37), (2, 8, 8, 4))]
    for name, x, args in gathers:
        check(torch.equal(gather(x, *args), gather_reference(x, *args)),
              f'gather, {name} {args}: kernel != plain')
    for x, taps in ((rand(520, 64), rand(4, 64, 32)), (rand(30, 20), rand(3, 20, 12))):
        ok, err = probe_ops.check(split_contract(x, taps), split_contract_reference(x, taps))
        check(ok, f'split_contract of {tuple(x.shape)} with taps {tuple(taps.shape)}: '
                  f'max-abs {err:.3g} from plain')
    print(f'off the probe\'s shapes, equal to plain: {len(gathers)} gathers '
          f'({"; ".join(name for name, _, _ in gathers)}), 2 contractions ([520, 64] x '
          f'[4, 64, 32]: M = 130 ends mid-tile; [30, 20] x [3, 20, 12])', flush=True)


def phase_probe(device) -> tp.Tuple[tp.Dict[str, int], tp.Dict[str, dict]]:
    print('== phase 10: data-movement probe (P1), apps/probe_ops on the card', flush=True)
    name_card = card()
    gather.launches = split_contract.launches = 0
    results = probe_ops.run(device)
    launches = {'probe_gather': gather.launches, 'probe_contract': split_contract.launches}
    for name, ok, shape, err in results:
        print(f'{name}: {"OK" if ok else "FAIL"} {shape} (max-abs from torch {err:.3g})',
              flush=True)
    check(all(ok for _, ok, _, _ in results), 'a probe operation failed')
    check(launches == {'probe_gather': 6, 'probe_contract': 1}, f'probe launches {launches}')

    gather.launches = split_contract.launches = 0
    one = torch.zeros(1, 1, dtype=torch.bfloat16, device=device)
    floor = _device_ms(lambda: gather(one, 1, 1, 1, 1))
    print(f'launch floor: the gather kernel at [1, 1] {floor * 1e3:.2f} us a launch (device '
          f'time, torch.profiler over {PROBE_LAUNCHES} launches)', flush=True)
    small = _probe_timed(device, 1)
    for item in small:
        item.update(ms=_device_ms(item['kernel']), host_us=_host_us(item['kernel']),
                    library_ms=_device_ms(item['library']),
                    library_host_us=_host_us(item['library']), plain_ms=_device_ms(item['plain']),
                    bound=bound_ms(item['ops'], PEAK_BF16, item['nbytes']))
        yard = 'matmul' if item['ops'] else 'clone()'
        print(f'{item["name"]} {item["shape"]}: kernel {item["ms"] * 1e3:.2f} us a launch '
              f'({item["ms"] / floor:.2f}x the floor), {item["host_us"]:.2f} us a call on the '
              f'host; {yard} {item["library_ms"] * 1e3:.2f} us, {item["library_host_us"]:.2f} us; '
              f'plain {item["plain_ms"] * 1e3:.2f} us; bound {item["bound"][0] * 1e3:.4f} us '
              f'({item["bound"][1]})', flush=True)
    big = _probe_timed(device, PROBE_SCALE)
    for item in big:
        item.update(ms=_device_ms(item['kernel']), library_ms=_device_ms(item['library']),
                    bound=bound_ms(item['ops'], PEAK_BF16, item['nbytes']))
        yard = 'matmul' if item['ops'] else 'clone()'
        print(f'{item["name"]} {item["shape"]} ({PROBE_SCALE}x): kernel {item["ms"]:.4f} ms, '
              f'{item["nbytes"] / item["ms"] / 1e9:.3f} TB/s, {item["bound"][0] / item["ms"]:.3f} '
              f'of the bound {item["bound"][0]:.4f} ms ({item["bound"][1]}: '
              f'{item["nbytes"] / 2 ** 20:.1f} MiB); {yard} {item["library_ms"]:.4f} ms, '
              f'{item["nbytes"] / item["library_ms"] / 1e9:.3f} TB/s', flush=True)
    timing_launches = {'probe_gather': gather.launches, 'probe_contract': split_contract.launches}
    print(f'the timing\'s own launches (apart from the probe\'s {launches}): {timing_launches}; '
          f'card {name_card}', flush=True)
    for item in small + big:
        check(item['ok'](), f'{item["name"]} {item["shape"]}: kernel != plain')
    _probe_ragged(device)

    def entry(name: str, replaces: str, items: tp.List[dict], big_items: tp.List[dict],
              max_abs_err: float) -> dict:
        total = lambda key, of=items: sum(item[key] for item in of)
        return dict(name=name, route='cuda', source='audiocraft_tpu_torch/csrc/probe.cu',
                    replaces=replaces, max_abs_err=max_abs_err, ms=total('ms'),
                    plain_ms=total('plain_ms'), bound_ms=sum(i['bound'][0] for i in items),
                    bound_by=items[0]['bound'][1], library_ms=total('library_ms'),
                    host_us=total('host_us'), library_host_us=total('library_host_us'),
                    launch_floor_ms=floor, ms_2048x=total('ms', big_items),
                    bound_ms_2048x=sum(i['bound'][0] for i in big_items),
                    library_ms_2048x=total('library_ms', big_items))

    is_contract = lambda item: item['ops'] > 0
    errs = {name: err for name, _, _, err in results}
    entries = {
        'probe_gather': entry('probe_gather', 'scripts/probe_mosaic_ops.py:13',
                              [i for i in small if not is_contract(i)],
                              [i for i in big if not is_contract(i)],
                              max(e for n, e in errs.items() if 'dot_general' not in n)),
        'probe_contract': entry('probe_contract', 'scripts/probe_mosaic_ops.py:46',
                                [i for i in small if is_contract(i)],
                                [i for i in big if is_contract(i)],
                                errs['3d split + dot_general'])}
    library = {'probe_gather': 'six clone()s of views made once', 'probe_contract': 'torch matmul'}
    for name, e in entries.items():
        print(f'{name}: kernel {e["ms"]:.5f} ms ({e["host_us"]:.2f} us on the host), plain '
              f'{e["plain_ms"]:.5f} ms, bound {e["bound_ms"]:.6f} ms ({e["bound_by"]}), '
              f'{library[name]} {e["library_ms"]:.5f} ms ({e["library_host_us"]:.2f} us); '
              f'{PROBE_SCALE}x: kernel {e["ms_2048x"]:.4f} ms, bound {e["bound_ms_2048x"]:.4f}, '
              f'{library[name]} {e["library_ms_2048x"]:.4f}', flush=True)
    return launches, entries


class SeededT5Ids:
    """Stands in for the T5 vocabulary, which is not in the repository: each
    text becomes DESC_LEN ids seeded by its characters, with the HF
    tokenizer's output keys (T5Conditioner.tokenize nulls empty texts)."""

    def __call__(self, entries, return_tensors='np', padding=True):
        ids = np.stack([np.random.RandomState(sum(map(ord, e)) + 1).randint(1, 32100, DESC_LEN)
                        for e in entries])
        return {'input_ids': ids, 'attention_mask': np.ones_like(ids)}


def _musicgen_launches() -> tp.Dict[str, int]:
    return {'rvq_encode': rvq_encode.launches, 'lstm_step': lstm_layer.launches,
            'flash_attention': fused_attention.launches}


def _reset_musicgen_launches() -> None:
    rvq_encode.launches = lstm_layer.launches = fused_attention.launches = 0


def _cuda_busy_ms(fn) -> tp.Tuple[float, float, list]:
    """(device busy ms, window ms by CUDA events, kernels by device time) of
    ``fn`` under torch.profiler; busy 0 when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = _event()
        fn()
        end = _event()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return busy, start.elapsed_time(end), kernels


def print_decode_step(lm, state, cond_batch: int, offset: int = MG_STEP_OFFSET) -> float:
    """One decode step of ``state`` (a finished generate) at ``offset``,
    50 steps each way on the same caches: the eager step's
    host and device ms, the replayed graph's ms, and the device's busy time
    and idle share over replays under the profiler; then the attention's and
    the heads' part of a step, and the step's byte bound.  Returns the graph
    step's ms."""
    graph = state.graphs[0]
    index = state.current[0].index

    def rewind():
        state.offset.fill_(offset)
        index.fill_(offset - 1)

    def eager():
        for _ in range(MG_TIMED_STEPS):
            state.step()

    def replays():
        for _ in range(MG_TIMED_STEPS):
            graph.replay()

    with torch.no_grad():
        rewind()
        torch.cuda.synchronize()
        start, t0 = _event(), time.perf_counter()
        eager()
        host_ms = (time.perf_counter() - t0) * 1e3 / MG_TIMED_STEPS
        end = _event()
        torch.cuda.synchronize()
        eager_wall = start.elapsed_time(end) / MG_TIMED_STEPS
        rewind()
        eager_busy = _cuda_busy_ms(eager)[0] / MG_TIMED_STEPS
        rewind()
        torch.cuda.synchronize()
        start = _event()
        replays()
        end = _event()
        torch.cuda.synchronize()
        graph_ms = start.elapsed_time(end) / MG_TIMED_STEPS
        rewind()
        busy, window, kernels = _cuda_busy_ms(replays)
    name = card()
    print(f'decode step at offset {offset} of {state.plan["S"]}, model batch '
          f'{cond_batch}, {MG_TIMED_STEPS} steps each way on the same caches: eager '
          f'{host_ms:.3f} ms of host time a step ({eager_wall:.3f} ms wall by CUDA events, '
          f'device busy {eager_busy:.3f} ms under the profiler); graph replay {graph_ms:.3f} ms '
          f'a step; card {name}', flush=True)
    if busy == 0:
        print('profiler: no device time seen over the replays (not measured)', flush=True)
    else:
        print(f'profiled {MG_TIMED_STEPS} replays: device busy {busy:.2f} ms of {window:.2f} ms '
              f'(CUDA events), idle share {1 - busy / window:.3f}; top kernels (ms, calls): '
              + '; '.join(f'{e.key[:60]} {e.self_device_time_total / 1e3:.2f} {e.count}'
                          for e in kernels[:8]), flush=True)

    print_step_parts(lm, state, graph_ms)
    return graph_ms


def print_step_parts(lm, state, graph_ms: float) -> None:
    """The attention's part of a replayed step of ``graph_ms``:
    plain_attention over the whole capacity, as a cached step runs it in
    every layer; the heads with their fp32 casts; and the step's byte
    bound."""
    cache = state.current[0]
    B, cap, H, D = cache.k.shape
    gen = torch.Generator().manual_seed(47)
    q = torch.randn(B, 1, H, D, generator=gen).to(cache.k)
    mask = torch.zeros(1, 1, 1, cap, device=q.device)
    n_layers = len(lm.transformer.layers)
    attn = time_ms(lambda: attention.plain_attention(q, cache.k, cache.v, mask), 20)
    out = torch.randn(B, 1, lm.dim, generator=gen).to(cache.k)
    heads = time_ms(lambda: lm.apply_heads(out), 20)
    weight_bytes, cross_bytes, kv_read, bound = step_bound(lm, state)
    print(f'attention over the cache [{B}, {cap}, {H}, {D}] {cache.k.dtype}: {attn:.4f} ms a '
          f'layer (fp32 upcast of k and v included), x {n_layers} layers = '
          f'{attn * n_layers:.3f} ms, {attn * n_layers / graph_ms:.3f} of a graph step; heads '
          f'(4 x {lm.card} x {lm.dim}, weights cast to fp32 each call) {heads:.4f} ms, '
          f'{heads / graph_ms:.3f} of a step; byte bound of a step (weights '
          f'{weight_bytes / 1e9:.3f} GB + cross K/V {cross_bytes / 1e9:.3f} GB + KV read '
          f'{kv_read / 1e9:.3f} GB at 3.35 TB/s) {bound:.3f} ms; card {card()}', flush=True)


def step_bound(lm, state) -> tp.Tuple[int, int, int, float]:
    """What a decode step of ``state`` reads: every matrix of ``lm`` but the
    embeddings (4 rows a step) and the cross-attention's K/V projection rows
    (2/3 of its in_proj), whose products come precomputed in the state's
    cross K/V; those, and the running segment's caches.  Returns (weight,
    cross K/V and cache bytes, the step's byte bound in ms)."""
    weight_bytes = 0
    for n, p in lm.named_parameters():
        if not n.startswith('emb.'):
            share = 3 if n.endswith('cross_attention.in_proj_weight') else 1
            weight_bytes += p.numel() * p.element_size() // share
    cross_bytes = sum(t.numel() * t.element_size() for kv in state.cross_kv if kv is not None
                      for pair in kv for t in pair)
    kv_read = sum(c.nbytes() for c in state.current)
    return (weight_bytes, cross_bytes, kv_read,
            (weight_bytes + cross_bytes + kv_read) / PEAK_BYTES * 1e3)


def replay_ms(state, offset: int, prefix: int = 0) -> float:
    """ms of one replayed decode step of ``state`` at ``offset`` (behind a
    prefix of ``prefix`` positions), CUDA events over MG_TIMED_STEPS replays
    on the same caches."""
    graph = state.graphs[0]
    with torch.no_grad():
        state.offset.fill_(offset)
        state.current[0].index.fill_(prefix + offset - 1)
        torch.cuda.synchronize()
        start = _event()
        for _ in range(MG_TIMED_STEPS):
            graph.replay()
        end = _event()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / MG_TIMED_STEPS


def _musicgen_generate(lm, cond, frames: int, seed: tp.Optional[int], graph_cache,
                       eager: bool = False, kv_dtype=None, kv_buckets=None,
                       states: tp.Optional[list] = None, compute_dtype=None) -> torch.Tensor:
    """``lm.generate`` of MG_PROMPTS-style rows (1-pass CFG, top-k 250 when
    ``seed`` is given, greedy when None); ``eager`` takes the private eager
    loop."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    rows = next(iter(cond.values()))[0].shape[0] // 2
    return lm.generate(gen, condition_tensors=cond, num_samples=rows, max_gen_len=frames,
                       use_sampling=seed is not None, top_k=250, cfg_coef=3.0,
                       compute_dtype=compute_dtype, kv_dtype=kv_dtype, kv_buckets=kv_buckets,
                       graph_cache=graph_cache, _eager=eager, _state_out=states)


def _time_cast_refresh(cache: DecodeCache, lm) -> float:
    """ms of the bf16 copy's refresh from ``lm``'s weights, which every
    generate on ``cache`` runs; the copy is made first if it is not there."""
    cache.cast(lm, torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache.cast(lm, torch.bfloat16)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_musicgen(device) -> tp.Dict[str, int]:
    print("== phase 11: MusicGen path, get_musicgen('small') generate (bf16 decode, CUDA "
          'graph steps) + codec decode', flush=True)
    mg = get_musicgen('small', seed=40)
    seed_codebooks(mg.compression_model, _clips(8, SECONDS * SAMPLE_RATE, device, seed=44))
    mg.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
    check(mg.decode_dtype == 'bfloat16', f'decode dtype {mg.decode_dtype}')
    refresh_ms = _time_cast_refresh(mg._decode_cache, mg.lm)
    frames, hop = int(MG_SECONDS * mg.frame_rate), int(mg.sample_rate // mg.frame_rate)
    tokenized = _descriptions(MG_PROMPTS, device, seed=41)
    _reset_musicgen_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        cond = mg.condition_provider(tokenized)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    states: list = []
    tokens = _musicgen_generate(mg.lm, cond, frames, 42, mg._decode_cache, states=states,
                                compute_dtype=mg.decode_dtype)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    audio = mg.generate_audio(tokens)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _musicgen_launches()
    peak = torch.cuda.max_memory_allocated()
    check(len(mg._decode_cache) == 1, f'{len(mg._decode_cache)} decode states after one generate')
    state = states[0]
    lm = state.lm
    check(lm.float_dtype == torch.bfloat16 and lm is not mg.lm, 'the decode copy is not bf16')
    capture_s = sum(state.capture_seconds)
    S = state.plan['S']
    check(tuple(tokens.shape) == (MG_PROMPTS, 4, frames), f'tokens {tuple(tokens.shape)}')
    check(bool(((tokens >= 0) & (tokens < lm.card)).all()), 'tokens out of range or masked')
    check(tuple(audio.shape) == (MG_PROMPTS, 1, frames * hop), f'audio {tuple(audio.shape)}')
    check(bool(torch.isfinite(audio).all()), 'non-finite audio')
    check(launches == {'rvq_encode': 0, 'lstm_step': 2, 'flash_attention': 0},
          f'launches {launches} != 2 LSTM launches in the decode only')
    audio_s, gen_s = MG_PROMPTS * MG_SECONDS, t2 - t1
    name = card()
    print(f'tokens {tuple(tokens.shape)}, {int(tokens.unique().numel())} distinct; audio '
          f'{tuple(audio.shape)}; launches {launches}')
    print(f'conditions {t1 - t0:.4f} s, generate {gen_s:.3f} s with {len(state.capture_seconds)} '
          f'capture(s) of {capture_s:.3f} s ({S / gen_s:.1f} steps/s, '
          f'{MG_PROMPTS * 4 * frames / gen_s:.0f} tokens/s), decode '
          f'{t3 - t2:.4f} s: {audio_s / (t3 - t0):.2f} audio-s generated/s end to end '
          f'({audio_s / gen_s:.2f} for the generate alone); KV caches '
          f'{state.kv_bytes() / 2**30:.3f} GiB; peak memory {peak / 2**30:.2f} GiB; the bf16 '
          f'copy\'s refresh from the fp32 weights, in every generate, {refresh_ms:.3f} ms; card '
          f'{name}', flush=True)

    print_decode_step(lm, state, 2 * MG_PROMPTS)
    # the graph route and the eager loop over 4 x 10 s (phase 12's stereo
    # shape: caches of 508 steps); the graph's time includes its capture
    short: list = []
    short_frames = int(MGS_SECONDS * mg.frame_rate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_tokens = _musicgen_generate(lm, cond, short_frames, 42, DecodeCache(), states=short)
    torch.cuda.synchronize()
    short_s = time.perf_counter() - t0
    eager = _musicgen_generate(lm, cond, short_frames, 42, None, eager=True)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0 - short_s
    share = float((eager == short_tokens).float().mean())
    print(f'the eager loop over {MG_PROMPTS} x {MGS_SECONDS} s: {eager_s:.3f} s against the '
          f'graph route\'s {short_s:.3f} s with its capture ({eager_s / short_s:.2f}x); token '
          f'match share with the graph route {share:.6f} (bf16; information, the fp32 parity '
          f'below is gated)', flush=True)
    check(short_s < eager_s, f'the graph route ({short_s:.3f} s) is not faster than the eager '
                             f'loop ({eager_s:.3f} s)')
    del eager, short_tokens
    mono_short_ms = replay_ms(short[0], MGS_STEP_OFFSET)
    print(f'MusicGen-small replayed decode step at 4 x {MGS_SECONDS} s (caches of '
          f'{short[0].plan["S"]} steps), offset {MGS_STEP_OFFSET}: {mono_short_ms:.3f} ms, mean '
          f'of {MG_TIMED_STEPS} (phase 12 times the stereo step there); card {card()}',
          flush=True)
    del short

    # the serving recipe on a copy of the LM: int8 weights, int8 KV, 'auto' buckets
    served = MusicGen(mg.name, mg.compression_model, copy.deepcopy(mg.lm), mg.condition_provider)
    served.optimize_for_serving()
    _time_cast_refresh(served._decode_cache, served.lm)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sstates: list = []
    stokens = _musicgen_generate(served.lm, cond, frames, 42, served._decode_cache,
                                 kv_dtype=served.kv_dtype, kv_buckets=served.kv_buckets,
                                 states=sstates, compute_dtype=served.decode_dtype)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    sstate = sstates[0]
    slm = sstate.lm
    segments = [seg[2] for seg in sstate.plan['segments']]
    check(bool(((stokens >= 0) & (stokens < lm.card)).all()), 'serving: tokens out of range')
    check(len(sstate.graphs) == len(segments) > 1 and sstate.current[0].quantized,
          f'serving: {len(sstate.graphs)} graphs for segments {segments}')
    print(f'optimize_for_serving (int8 weights, int8 KV, kv_buckets auto: segments {segments}, '
          f'one graph each, captures {sum(sstate.capture_seconds):.3f} s): generate '
          f'{serve_s:.3f} s, {MG_PROMPTS * 4 * frames / serve_s:.0f} tokens/s (bf16 route '
          f'{gen_s:.3f} s); KV caches {sstate.kv_bytes() / 2**30:.3f} GiB over all segments; peak '
          f'memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; token match share with the '
          f'bf16 route {float((stokens == tokens).float().mean()):.4f} (information); card {name}',
          flush=True)
    # the recipe's three parts one at a time over 4 x 10 s, beside the bf16
    # graph route there (capture included in each)
    parts = {}
    for part, (model, kv_dtype, kv_buckets) in {
            'int8 weights': (slm, None, None), 'int8 KV': (lm, 'int8', None),
            "kv_buckets 'auto'": (lm, None, 'auto')}.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _musicgen_generate(model, cond, short_frames, 42, DecodeCache(), kv_dtype=kv_dtype,
                           kv_buckets=kv_buckets)
        torch.cuda.synchronize()
        parts[part] = time.perf_counter() - t0
    print(f'the serving recipe by part, one generate of {MG_PROMPTS} x {MGS_SECONDS} s each (s): '
          + ', '.join(f'{part} {sec:.3f}' for part, sec in parts.items())
          + f'; the bf16 route there {short_s:.3f}; card {name}', flush=True)
    del served, slm, sstate, sstates, stokens

    # stride extension to MG_STRIDE_SECONDS at B = 1 through the public
    # generate, its tokens decoded in windows (decode_chunk_frames lowered)
    windows: tp.List[float] = []
    mg.set_generation_params(duration=MG_STRIDE_SECONDS, extend_stride=20.0)
    mg.set_custom_progress_callback(lambda done, text: windows.append(done))
    mg.decode_chunk_frames = 2000
    _reset_musicgen_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, long_tokens = mg.generate(['a long piece for strings'],
                                     generator=torch.Generator().manual_seed(44),
                                     return_tokens=True)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    launches_long = _musicgen_launches()
    long_peak = torch.cuda.max_memory_allocated()
    resident = list(mg._decode_cache.states.values())
    check(len(resident) == 3 <= mg._decode_cache.max_states,
          f'{len(resident)} decode states resident after the stride extension, not 3')
    long_frames = int(MG_STRIDE_SECONDS * mg.frame_rate)
    check(len(windows) == 2, f'stride extension ran {len(windows)} windows, not 2')
    check(tuple(long_tokens.shape) == (1, 4, long_frames), f'long tokens {long_tokens.shape}')
    check(bool(((long_tokens >= 0) & (long_tokens < lm.card)).all()), 'long tokens out of range')
    check(tuple(audio.shape) == (1, 1, long_frames * hop) and bool(torch.isfinite(audio).all()),
          f'long audio {tuple(audio.shape)}')
    check(launches_long['lstm_step'] == 2, f"chunked decode: {launches_long['lstm_step']} LSTM "
                                           'launches, not 2 (the head runs once)')
    whole = mg.compression_model.decode(long_tokens)
    rel = float((audio - whole).abs().max() / whole.abs().max())
    print(f'stride extension to {MG_STRIDE_SECONDS} s at B = 1 (stride 20 s): {len(windows)} '
          f'windows, tokens {tuple(long_tokens.shape)}, {long_s:.3f} s with the decode; chunked '
          f'decode (windows of {mg.decode_chunk_frames // 2} frames) against one decode: '
          f'max-abs / max {rel:.3g} (bf16, information); launches {launches_long}; peak memory '
          f'{long_peak / 2**30:.2f} GiB with {len(resident)} decode states resident (at most '
          f'{mg._decode_cache.max_states}; KV caches {sum(s.kv_bytes() for s in resident) / 2**30:.3f} '
          f'GiB together), {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after; card '
          f'{name}', flush=True)
    mg.set_custom_progress_callback(None)
    del audio, whole, long_tokens, lm, state, states, resident
    mg._decode_cache.clear()   # frees the bf16 copy, the states and their graphs
    torch.cuda.empty_cache()

    # the debug facade's public entry points (whitespace LUT tokenizer)
    dmg = get_debug_musicgen()
    dframes = int(dmg.duration * dmg.frame_rate)
    dgen = torch.Generator().manual_seed(45)
    audio, dtokens = dmg.generate(['a short jingle', 'calm piano'], generator=dgen,
                                  return_tokens=True)
    check(tuple(dtokens.shape) == (2, 4, dframes)
          and bool(((dtokens >= 0) & (dtokens < 400)).all()),
          f'debug generate tokens {tuple(dtokens.shape)}')
    uaudio, utokens = dmg.generate_unconditional(2, generator=dgen, return_tokens=True)
    prompt = torch.randn(1, 1, 2 * 44100, generator=torch.Generator().manual_seed(46)) * 0.1
    dmg.decode_chunk_frames = 60
    _reset_musicgen_launches()
    caudio, ctokens = dmg.generate_continuation(prompt.to(device), 44100, ['drums'],
                                                generator=dgen, return_tokens=True)
    launches_debug = _musicgen_launches()
    dhop = int(dmg.sample_rate // dmg.frame_rate)
    check(tuple(ctokens.shape) == (1, 4, dframes) and tuple(caudio.shape) == (1, 1, dframes * dhop),
          f'continuation {tuple(ctokens.shape)} {tuple(caudio.shape)}')
    check(launches_debug['rvq_encode'] == 1, f'continuation: {launches_debug} (one prompt encode)')
    for a in (audio, uaudio, caudio):
        check(bool(torch.isfinite(a).all()), 'debug facade: non-finite audio')
    print(f'debug facade on {caudio.device}: generate {tuple(audio.shape)}, unconditional '
          f'{tuple(uaudio.shape)}, continuation {tuple(caudio.shape)} decoded in windows of 30 '
          f'frames; launches in the continuation {launches_debug}', flush=True)
    phase_musicgen_parity(device, mg)
    return {'lstm_step': launches['lstm_step'], 'rvq_encode': launches_debug['rvq_encode']}


def _first_layers(lm: LMModel, n: int) -> LMModel:
    """A copy of ``lm`` with its first ``n`` transformer layers: the same
    widths, the depth cut."""
    layers = lm.transformer.layers
    lm.transformer.layers = torch.nn.ModuleList()   # the copy takes n layers, not all
    try:
        cut = copy.deepcopy(lm)
    finally:
        lm.transformer.layers = layers
    cut.transformer.layers = copy.deepcopy(layers[:n])
    cut.num_layers = n
    return cut


def phase_musicgen_parity(device, mg) -> None:
    print(f'== phase 11 parity: MusicGen-small\'s widths cut to {MG_PARITY_LAYERS} of 24 layers '
          'in fp32 (TF32 off), graph vs eager, cached vs cache-free, card vs CPU', flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    lm, n, frames = (_first_layers(mg.lm, MG_PARITY_LAYERS), 2,
                     int(MG_PARITY_SECONDS * mg.frame_rate))
    check(lm.float_dtype == torch.float32, 'the parity LM is not fp32')
    with torch.no_grad():
        cond = mg.condition_provider(_descriptions(n, device, seed=43))
    states: list = []
    graphs = DecodeCache()
    greedy = _musicgen_generate(lm, cond, frames, None, graphs, states=states)
    again = _musicgen_generate(lm, cond, frames, None, graphs, states=states)
    check(len(graphs) == 1 and states[0] is states[1] and torch.equal(greedy, again),
          'a second generate of one signature did not replay the first one\'s graph alike')
    eager = _musicgen_generate(lm, cond, frames, None, None, eager=True)
    check(torch.equal(greedy, eager), 'greedy tokens: graph route != eager loop')
    sampled = _musicgen_generate(lm, cond, frames, 48, DecodeCache())
    sampled_eager = _musicgen_generate(lm, cond, frames, 48, None, eager=True)
    check(torch.equal(sampled, sampled_eager), 'sampled tokens: graph route != eager loop')
    bucketed_states: list = []
    bucketed = _musicgen_generate(lm, cond, frames, None, DecodeCache(), kv_buckets=[32, 64],
                                  states=bucketed_states)
    check(len(bucketed_states[0].graphs) == 3 and torch.equal(bucketed, greedy),
          'kv_buckets [32, 64]: not three graphs, or other tokens than one full-capacity cache')
    halves = tuple({k: (t[i * n:(i + 1) * n], m[i * n:(i + 1) * n]) for k, (t, m) in cond.items()}
                   for i in range(2))
    two_step = [lm.generate(condition_tensors=halves, num_samples=n, max_gen_len=frames,
                            use_sampling=False, cfg_coef=3.0,
                            graph_cache=DecodeCache() if i == 0 else None, _eager=i == 1)
                for i in range(2)]
    check(torch.equal(*two_step), 'two-step CFG: graph route != eager loop')
    print(f'greedy and sampled (top-k 250) tokens {tuple(greedy.shape)}: graph route equal to '
          'the eager loop, bit for bit; a second generate replays the first one\'s graph and '
          'equals it; kv_buckets [32, 64] (three graphs) equal one full-capacity cache; '
          'two-step CFG (both forwards in one graph) equal to its eager loop', flush=True)

    seq = states[0].seq
    S = seq.shape[-1]
    tiled = torch.cat([seq[..., :S - 1]] * 2)
    with torch.no_grad():
        full = lm(tiled, cond)
        caches = lm.init_cache(2 * n, S)
        cross_kv = lm.transformer.precompute_cross_kv(lm.cross_source(cond, 2 * n))
        steps = [lm(tiled[..., t:t + 1], cond, cross_kv=cross_kv, caches=caches)
                 for t in range(S - 1)]
    rel = float((torch.cat(steps, dim=2) - full).abs().max() / full.abs().max())
    print(f'cached steps against the cache-free forward, logits [{2 * n}, 4, {S - 1}, '
          f'{lm.card}]: max-abs / max {rel:.3g} (<= 1e-4)', flush=True)
    check(rel <= 1e-4, f'cached step logits rel {rel:.3g} > 1e-4')
    del full, steps, caches

    check_greedy_against_cpu(lm, cond, frames, n, greedy, seq)


def check_greedy_against_cpu(lm, cond, frames: int, n: int, greedy: torch.Tensor,
                             seq: torch.Tensor) -> None:
    """The card's fp32 greedy tokens (``greedy``, its pattern sequence
    ``seq``) against the same generate on the CPU: equal, or first apart at
    a near-tie of the CPU's guided logits (top two within 1e-4 relative)."""
    cpu_lm = copy.deepcopy(lm).cpu()
    cpu_cond = {k: (t.cpu(), m.cpu()) for k, (t, m) in cond.items()}
    cpu_states: list = []
    t0 = time.perf_counter()
    cpu_tokens = _musicgen_generate(cpu_lm, cpu_cond, frames, None, None, states=cpu_states)
    cpu_s = time.perf_counter() - t0
    if torch.equal(cpu_tokens, greedy.cpu()):
        print(f'greedy tokens, card against CPU ({cpu_s:.1f} s there): equal', flush=True)
        return
    cpu_seq, card_seq = cpu_states[0].seq, seq.cpu()
    diff = (cpu_seq != card_seq).nonzero()
    step = int(diff[:, 2].min())
    b, k = (int(v) for v in diff[diff[:, 2] == step][0, :2])
    with torch.no_grad():
        logits = cpu_lm(torch.cat([cpu_seq[..., :step]] * 2), cpu_cond)[:, :, -1]
    logits = logits[n:] + (logits[:n] - logits[n:]) * 3.0
    top2 = logits[b, k].topk(2).values
    margin = float((top2[0] - top2[1]) / top2[0].abs())
    print(f'greedy tokens, card against CPU: first differing step {step} (row {b}, codebook '
          f'{k}); the CPU\'s top-2 margin there {margin:.3g} relative (< 1e-4: a near-tie)',
          flush=True)
    check(margin < 1e-4, f'card and CPU greedy tokens differ at step {step} where the margin '
                         f'is {margin:.3g}, not a near-tie')


def _stereo_tokenize(device) -> tp.Dict[str, int]:
    """The stereo wrapper over the 32 kHz codec at b64 stereo x 10 s: the
    mono codec sees b128 x 10 s, phase 3's kernel shapes."""
    codec = get_encodec_32khz()
    seed_codebooks(codec, _clips(16, SECONDS * SAMPLE_RATE, device, seed=4))
    stereo = get_wrapped_compression_model(codec, interleave_stereo=True)
    left = _clips(STEREO_BATCH, SECONDS * SAMPLE_RATE, device, seed=70)
    right = _clips(STEREO_BATCH, SECONDS * SAMPLE_RATE, device, seed=71)
    wav = torch.cat([left, right], dim=1)
    stereo.decode(stereo.encode(wav)[0])   # warm-up, not counted
    torch.cuda.synchronize()
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes, scale = stereo.encode(wav)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = stereo.decode(codes)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _seanet_launches()
    peak = torch.cuda.max_memory_allocated()
    frames = SECONDS * 50
    check(scale is None and tuple(codes.shape) == (STEREO_BATCH, 8, frames),
          f'stereo codes {tuple(codes.shape)}')
    check(tuple(out.shape) == (STEREO_BATCH, 2, SECONDS * SAMPLE_RATE)
          and bool(torch.isfinite(out).all()), f'stereo audio {tuple(out.shape)}')
    expect = dict(fused_stage=2, banded_mono_conv=1, rvq_encode=1, lstm_step=4)
    check(launches == expect, f'stereo encode + decode launched {launches}, not {expect}')
    mono = codec.encode(torch.cat([left, right]))[0]
    l, r = stereo.get_left_right_codes(codes)
    check(torch.equal(l, mono[:STEREO_BATCH]) and torch.equal(r, mono[STEREO_BATCH:]),
          'stereo codes differ from the mono codec\'s codes of each channel')
    audio = STEREO_BATCH * SECONDS
    print(f'stereo wrapper, b{STEREO_BATCH} stereo x {SECONDS} s (the mono codec at b'
          f'{2 * STEREO_BATCH}, its default fused route): codes {tuple(codes.shape)}, equal bit '
          f'for bit to the mono codec\'s of each channel in one b{2 * STEREO_BATCH} batch; audio '
          f'{tuple(out.shape)}; encode {t1 - t0:.4f} s = {audio / (t1 - t0):.1f} stereo audio-s '
          f'tokenized/s, decode {t2 - t1:.4f} s = {audio / (t2 - t1):.1f} decoded/s; peak memory '
          f'{peak / 2**30:.2f} GiB; launches {launches}; card {card()}', flush=True)
    return launches


def _stereo_musicgen(device) -> tp.Dict[str, int]:
    """MusicGen-stereo-small at published widths: 4 seeded descriptions x
    10 s, 1-pass CFG, top-k 250, the LM in bf16 with graph-replayed steps,
    then the stereo decode; then the fp32 greedy tokens at 1 s against the
    CPU's."""
    mg = get_musicgen('small', stereo=True, seed=60)
    seed_codebooks(mg.compression_model.model, _clips(8, SECONDS * SAMPLE_RATE, device, seed=64))
    mg.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
    check(mg.name == 'musicgen-stereo-small' and mg.lm.n_q == 8 and mg.audio_channels == 2,
          f'{mg.name}: {mg.lm.n_q} codebooks, {mg.audio_channels} channels')
    frames, hop = int(MGS_SECONDS * mg.frame_rate), int(mg.sample_rate // mg.frame_rate)
    with torch.no_grad():
        cond = mg.condition_provider(_descriptions(MG_PROMPTS, device, seed=61))
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states: list = []
    tokens = _musicgen_generate(mg.lm, cond, frames, 62, mg._decode_cache, states=states,
                                compute_dtype=mg.decode_dtype)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    audio = mg.generate_audio(tokens)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state = states[0]
    check(tuple(tokens.shape) == (MG_PROMPTS, 8, frames)
          and bool(((tokens >= 0) & (tokens < mg.lm.card)).all()), f'tokens {tuple(tokens.shape)}')
    check(tuple(audio.shape) == (MG_PROMPTS, 2, frames * hop) and bool(torch.isfinite(audio).all()),
          f'stereo audio {tuple(audio.shape)}')
    check(launches['lstm_step'] == 2 and launches['rvq_encode'] == 0,
          f'generate + decode launched {launches}, not K2 twice (the decode at doubled batch)')
    S = state.plan['S']
    name = card()
    print(f'MusicGen-stereo-small: tokens {tuple(tokens.shape)}, audio {tuple(audio.shape)}; '
          f'generate {t1 - t0:.3f} s with {len(state.capture_seconds)} capture(s) of '
          f'{sum(state.capture_seconds):.3f} s ({S / (t1 - t0):.1f} steps/s, '
          f'{MG_PROMPTS * 8 * frames / (t1 - t0):.0f} tokens/s), stereo decode {t2 - t1:.4f} s; '
          f'KV caches {state.kv_bytes() / 2**30:.3f} GiB; peak memory {peak / 2**30:.2f} GiB; '
          f'launches {launches}; card {name}', flush=True)
    print_decode_step(state.lm, state, 2 * MG_PROMPTS, offset=MGS_STEP_OFFSET)
    print(f'MusicGen-stereo-small replayed decode step at offset {MGS_STEP_OFFSET}: '
          f'{replay_ms(state, MGS_STEP_OFFSET):.3f} ms, mean of {MG_TIMED_STEPS} (the mono '
          f'step at this shape: phase 11); card {name}', flush=True)
    del tokens, audio, state, states
    mg._decode_cache.clear()
    torch.cuda.empty_cache()

    lm, n = mg.lm, 2
    pframes = int(MGS_PARITY_SECONDS * mg.frame_rate)
    check(lm.float_dtype == torch.float32 and not torch.backends.cuda.matmul.allow_tf32,
          'the stereo parity LM is not fp32 with TF32 off')
    with torch.no_grad():
        cond = mg.condition_provider(_descriptions(n, device, seed=63))
    pstates: list = []
    greedy = _musicgen_generate(lm, cond, pframes, None, DecodeCache(), states=pstates)
    check(tuple(greedy.shape) == (n, 8, pframes), f'stereo greedy {tuple(greedy.shape)}')
    print(f'MusicGen-stereo-small fp32 greedy tokens {tuple(greedy.shape)}, card against CPU:',
          flush=True)
    check_greedy_against_cpu(lm, cond, pframes, n, greedy, pstates[0].seq)
    return launches


def _streamed_codes_share(codec, lat: torch.Tensor, codes: torch.Tensor,
                          streamed: torch.Tensor) -> tp.Tuple[float, int, int]:
    """(share of the streamed codes equal to the whole encode's, frames that
    differ, of which at near-ties of the whole latent's distances)."""
    B, D, T = lat.shape
    differ = (streamed != codes).any(1).reshape(B * T)
    rows = lat.transpose(1, 2).reshape(B * T, D)
    near = _near_ties(rows, codec.quantizer.embeds(),
                      codes.permute(1, 0, 2).reshape(codes.shape[1], -1), rel=1e-4)
    return (float((streamed == codes).float().mean()), int(differ.sum()),
            int((differ & near).sum()))


def _stream_24khz(device) -> tp.Dict[str, int]:
    """The causal 24 kHz codec at published widths (fp32) streaming B = 16 x
    10 s in 1 s chunks through CodecStreamer, each way, against the
    whole-signal encode and decode; K2 starts each chunk from the carried
    (h, c).  Then K2 timed with the carry and from zero at the chunk's shape."""
    codec = get_encodec_24khz()
    check(codec.compute_dtype is None and codec.causal, 'the 24 kHz codec is not causal fp32')
    chunk = STREAM_CHUNK_FRAMES * codec.encoder.hop_length
    check(chunk == STREAM_RATE, f'a chunk of {STREAM_CHUNK_FRAMES} frames is {chunk} samples')
    seed_codebooks(codec, _clips(8, STREAM_SECONDS * STREAM_RATE, device, seed=73))
    wav = _clips(STREAM_BATCH, STREAM_SECONDS * STREAM_RATE, device, seed=74)
    n_chunks = STREAM_SECONDS
    lat = codec.encode_to_latent(wav)
    codes = codec.quantizer.encode(lat)
    whole = codec.decode(codes)
    state, parts = None, []
    for i in range(n_chunks):
        part, state = encoder_stream(codec.encoder, wav[..., i * chunk:(i + 1) * chunk], state)
        parts.append(part)
    rel_lat = float((torch.cat(parts, -1) - lat).abs().max() / lat.abs().max())
    del parts, state

    def stream(direction: str, data: torch.Tensor, size: int) -> tp.Tuple[torch.Tensor, list]:
        streamer = CodecStreamer(codec, chunk=size if direction == 'encode'
                                 else STREAM_CHUNK_FRAMES, direction=direction)
        outs, ms = [], []
        for i in range(n_chunks):
            start = _event()
            out = streamer.feed(data[..., i * size:(i + 1) * size])
            end = _event()
            torch.cuda.synchronize()
            check(len(out) == 1, f'{direction}: chunk {i} gave {len(out)} outputs')
            outs.append(out[0])
            ms.append(start.elapsed_time(end))
        check(streamer.flush() == (None, 0), f'{direction}: a rest was left in the buffer')
        return torch.cat(outs, -1), ms

    stream('encode', wav, chunk)   # warm-ups, not counted
    stream('decode', codes, STREAM_CHUNK_FRAMES)
    _reset_launch_counts()
    streamed, enc_ms = stream('encode', wav, chunk)
    enc_launches = _seanet_launches()
    share, differ, near = _streamed_codes_share(codec, lat, codes, streamed)
    _reset_launch_counts()
    audio, dec_ms = stream('decode', codes, STREAM_CHUNK_FRAMES)
    dec_launches = _seanet_launches()
    rel_wav = float((audio - whole).abs().max() / whole.abs().max())
    per_chunk = 2 * n_chunks   # 2 layers
    check(enc_launches['lstm_step'] == per_chunk and enc_launches['rvq_encode'] == n_chunks,
          f'stream encode launched {enc_launches}')
    check(dec_launches['lstm_step'] == per_chunk, f'stream decode launched {dec_launches}')
    check(tuple(streamed.shape) == tuple(codes.shape) and tuple(audio.shape) == tuple(whole.shape),
          f'streamed {tuple(streamed.shape)} {tuple(audio.shape)}')
    check(bool(torch.isfinite(audio).all()), 'non-finite streamed audio')
    name = card()
    print(f'24 kHz codec streaming B={STREAM_BATCH} x {STREAM_SECONDS} s in {n_chunks} chunks of '
          f'{STREAM_CHUNK_FRAMES} frames (fp32), against the whole signal: latent max-abs / max '
          f'{rel_lat:.3g} (<= 1e-4); code match share {share:.6f} (>= 0.995; {differ} frames '
          f'differ, {near} of them at near-ties); audio max-abs / max {rel_wav:.3g} (<= 1e-4); '
          f'launches encode {enc_launches}, decode {dec_launches}', flush=True)
    print(f'ms per chunk (CUDA events, feed to output): encode '
          f'{", ".join(f"{m:.2f}" for m in enc_ms)}; decode {", ".join(f"{m:.2f}" for m in dec_ms)}'
          f' ({STREAM_BATCH} x 1 s of audio a chunk); card {name}', flush=True)
    check(rel_lat <= 1e-4, f'streamed latent rel {rel_lat:.3g} > 1e-4')
    check(share >= 0.995, f'streamed code match share {share:.6f} < 0.995')
    check(rel_wav <= 1e-4, f'streamed audio rel {rel_wav:.3g} > 1e-4')

    H = codec.encoder.model[-3].dimension
    x, *weights = [a.to(device) for a in _lstm_args(STREAM_CHUNK_FRAMES, STREAM_BATCH, H, seed=75)]
    carry = _lstm_state(STREAM_BATCH, H, torch.float32, device, seed=76)
    zero_ms = time_ms(lambda: lstm_layer(x, *weights), 20)
    carry_ms = time_ms(lambda: lstm_layer(x, *weights, state=carry, return_state=True), 20)
    print(f'K2 at the chunk\'s shape T={STREAM_CHUNK_FRAMES} B={STREAM_BATCH} H={H} fp32: from a '
          f'carried (h, c), returning the final (h, c), {carry_ms:.4f} ms; from zero {zero_ms:.4f} '
          f'ms (mean of 20, CUDA events); card {name}', flush=True)
    return {'encode': enc_launches['lstm_step'], 'decode': dec_launches['lstm_step']}


def phase_stereo_streaming(device) -> tp.Dict[str, tp.Dict[str, int]]:
    print('== phase 12: stereo and streaming: the stereo wrapper at b64 stereo x 10 s, '
          "get_musicgen('small', stereo=True), get_encodec_24khz() streamed in 1 s chunks",
          flush=True)
    start = time.perf_counter()
    launches = {'stereo codec': _stereo_tokenize(device)}
    torch.cuda.empty_cache()
    launches['musicgen-stereo'] = _stereo_musicgen(device)
    torch.cuda.empty_cache()
    launches['streaming K2'] = _stream_24khz(device)
    print(f'phase 12: {time.perf_counter() - start:.1f} s; launches by path {launches}',
          flush=True)
    return launches


NOTE_HZ = (261.63, 329.63, 392.0, 466.16, 293.66, 369.99, 493.88)   # C E G A# D F# B
NOTE_CLASS = (0, 4, 7, 10, 2, 6, 11)


def _melodies(batch: int, seconds: float, seed: int,
              note_s: float = 0.5) -> tp.Tuple[np.ndarray, tp.List[tp.List[int]]]:
    """Seeded melodies [batch, 1, T] at 32 kHz: runs of sine notes of
    ``note_s`` seconds at pitch classes drawn from the seed; and each row's
    classes, note by note."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(note_s * SAMPLE_RATE)) / SAMPLE_RATE
    rows, classes = [], []
    for _ in range(batch):
        picks = rng.randint(0, len(NOTE_HZ), int(round(seconds / note_s)))
        rows.append(np.concatenate([0.4 * np.sin(2 * np.pi * NOTE_HZ[p] * t) for p in picks]))
        classes.append([NOTE_CLASS[p] for p in picks])
    return np.stack(rows)[:, None].astype(np.float32), classes


def check_chroma(device) -> None:
    """13.1: the chroma extractor at 10 s on the card against the CPU (the
    raw normalized chroma within 1e-5; the one-hot equal wherever the CPU's
    top two classes are more than 1e-5 apart), and every note's inner frames
    at its pitch class."""
    wav, classes = _melodies(MEL_PROMPTS, MEL_SECONDS, seed=80)
    x = torch.from_numpy(wav)
    raw = ChromaExtractor(sample_rate=SAMPLE_RATE, n_chroma=12, radix2_exp=12)
    hot = ChromaExtractor(sample_rate=SAMPLE_RATE, n_chroma=12, radix2_exp=12, argmax=True)
    card_raw, cpu_raw = raw(x.to(device)).cpu(), raw(x)
    err = float((card_raw - cpu_raw).abs().max())
    card_hot, cpu_hot = hot(x.to(device)).cpu(), hot(x)
    top2 = cpu_raw.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 1e-5
    per_note = card_hot.shape[1] / len(classes[0])
    missed = sum(int((card_hot[b, int((i + 0.3) * per_note):int((i + 0.7) * per_note)]
                      .argmax(-1) != c).sum())
                 for b, row in enumerate(classes) for i, c in enumerate(row))
    ms = time_ms(lambda: hot(x.to(device)), 5)
    print(f'chroma [{MEL_PROMPTS}, 1, {MEL_SECONDS * SAMPLE_RATE}] -> {tuple(card_hot.shape)}: '
          f'card against CPU, raw max-abs {err:.3g} (<= 1e-5), one-hot equal on {int(sure.sum())} '
          f'frames ({int((~sure).sum())} near-tie frames excluded); inner frames off their '
          f'note\'s class {missed} (0); {ms:.3f} ms on the card with the host copy (CUDA events, '
          'information)', flush=True)
    check(err <= 1e-5, f'chroma raw card vs CPU max-abs {err:.3g} > 1e-5')
    check(torch.equal(card_hot[sure], cpu_hot[sure]), 'chroma one-hot card != CPU off near-ties')
    check(missed == 0, f'{missed} inner note frames off their pitch class')


def _generate_timed(mg, descriptions, wavs, seed: int):
    """The facade's public ``generate_with_chroma`` (melody or style clips
    at 32 kHz): (audio, tokens, seconds to the tokens, seconds with the
    decode, the decode state it ran)."""
    marks: tp.List[float] = []

    def done(_progress, _text):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mg.set_custom_progress_callback(done)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, tokens = mg.generate_with_chroma(descriptions, wavs, SAMPLE_RATE,
                                            generator=torch.Generator().manual_seed(seed),
                                            return_tokens=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mg.set_custom_progress_callback(None)
    state = list(mg._decode_cache.states.values())[-1]
    return audio, tokens, marks[-1] - t0, t1 - t0, state


_LAP = [0.0]


def _lap(what: str) -> None:
    """Print the seconds since the last lap of phase 13."""
    now = time.perf_counter()
    print(f'   [phase 13: {what} {now - _LAP[0]:.1f} s]', flush=True)
    _LAP[0] = now


def _print_generate(what: str, mg, tokens, audio, gen_s: float, total_s: float, state,
                    launches, model_batch: int) -> int:
    """Print a generate's numbers and its replayed step at MEL_STEP_OFFSET
    with the attention's part and the byte bound (phase 11 profiles the
    step; the profiler's reading of a 48-layer window takes minutes of
    host time); returns the prefix length."""
    S = state.plan['S']
    prefix = state.plan['segments'][-1][2] - S
    audio_s = tokens.shape[0] * tokens.shape[-1] / mg.frame_rate
    name = card()
    print(f'{what}: tokens {tuple(tokens.shape)}, audio {tuple(audio.shape)}; prefix {prefix} '
          f'frames before {S} pattern steps; conditions + generate {gen_s:.3f} s with '
          f'{len(state.capture_seconds)} capture(s) of {sum(state.capture_seconds):.3f} s '
          f'({S / gen_s:.1f} steps/s), decode {total_s - gen_s:.3f} s: '
          f'{audio_s / total_s:.2f} audio-s/s end to end ({audio_s / gen_s:.2f} to the tokens); '
          f'KV caches {state.kv_bytes() / 1e9:.3f} GB; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; card {name}',
          flush=True)
    step = replay_ms(state, MEL_STEP_OFFSET, prefix)
    print(f'{what}: replayed decode step at offset {MEL_STEP_OFFSET} of {S}, model batch '
          f'{model_batch}: {step:.3f} ms, mean of {MG_TIMED_STEPS}; card {name}', flush=True)
    print_step_parts(state.lm, state, step)
    return prefix


def phase_melody_parity(device, mg, descriptions, melodies) -> None:
    """fp32 greedy tokens at MEL_PARITY_SECONDS of an LM at the medium widths
    cut to MEL_PARITY_LAYERS layers, behind the melody's 938-frame chroma
    prefix (the facade's fp32 conditions), card against CPU."""
    gen = torch.Generator().manual_seed(84)
    lm = LMModel(
        mg.lm.fuser, n_q=4, card=2048, dim=mg.lm.dim, num_heads=mg.lm.transformer.num_heads,
        num_layers=MEL_PARITY_LAYERS, hidden_scale=4, norm_first=True, bias_proj=False,
        bias_ff=False, bias_attn=False, cross_attention=True, causal=True, activation='gelu',
        weight_init='gaussian', attn_kernel='auto', pattern_provider=DelayedPatternProvider(4),
        generator=gen).to(device).eval().requires_grad_(False)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    attributes, _ = mg._prepare_tokens_and_attributes(
        descriptions, None, melody_wavs=mg._convert_melodies(melodies, SAMPLE_RATE))
    with torch.no_grad():
        cond = mg._cfg_condition_tensors(attributes)
    n, frames = len(descriptions), int(MEL_PARITY_SECONDS * mg.frame_rate)
    states: list = []
    greedy = _musicgen_generate(lm, cond, frames, None, DecodeCache(), states=states)
    check(tuple(greedy.shape) == (n, 4, frames), f'melody greedy {tuple(greedy.shape)}')
    print(f'MusicGen-melody at the medium widths cut to {MEL_PARITY_LAYERS} of 48 layers, fp32 '
          f'greedy tokens {tuple(greedy.shape)} behind the {cond["self_wav"][0].shape[1]}-frame '
          'chroma prefix, card against CPU:', flush=True)
    check_greedy_against_cpu(lm, cond, frames, n, greedy, states[0].seq)


def _extend_melody(device, mg) -> tp.Dict[str, int]:
    """13.3: ``generate_music_segments`` over a seeded 20 s melody in 10 s
    segments with 1 s of overlap, then ``stitch_segments``; the segments
    and the stitched length against ``plan_segments`` and the stitch's
    arithmetic; K5, K4, K1 and K2 per continuation's prompt encode, K2 per
    decode; the result written with ``audio_write`` and read back."""
    mg.set_generation_params(duration=EXTEND_SEGMENT, top_k=250, cfg_coef=3.0)
    melody = _melodies(1, EXTEND_SECONDS, seed=86)[0][0, 0]
    total, duration, excess = plan_segments(EXTEND_SECONDS, EXTEND_SEGMENT, EXTEND_OVERLAP)
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segments, excess_out = generate_music_segments(
        'a melody that goes on', (SAMPLE_RATE, melody), 87, mg, duration=EXTEND_SECONDS,
        overlap=EXTEND_OVERLAP, segment_duration=EXTEND_SEGMENT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    # the segment lengths generate_music_segments gives: whole segments, the
    # last one (or one past the remaining duration) cut to what remains
    lengths, remaining = [], duration
    for idx in range(total):
        last = idx + 1 == total or remaining < EXTEND_SEGMENT
        lengths.append((max(min(remaining, EXTEND_SEGMENT), 1) if last else EXTEND_SEGMENT)
                       * SAMPLE_RATE)
        if remaining > EXTEND_SEGMENT:
            remaining -= EXTEND_SEGMENT
    check(total == 3 and len(segments) == total and excess_out == excess,
          f'extend: {len(segments)} segments, plan {total, duration, excess}')
    check([tuple(s.shape) for s in segments] == [(1, 1, n) for n in lengths],
          f'extend segments {[tuple(s.shape) for s in segments]} != {lengths}')
    stitched = stitch_segments(segments, SAMPLE_RATE, EXTEND_OVERLAP)
    expect = sum(lengths) - (total - 1) * (EXTEND_OVERLAP * SAMPLE_RATE // 2)
    check(tuple(stitched.shape) == (1, 1, expect) and bool(torch.isfinite(stitched).all()),
          f'stitched {tuple(stitched.shape)}, expected {expect} samples')
    per = dict(banded_mono_conv=total, fused_stage=2 * total, rvq_encode=total,
               lstm_step=2 + 2 * total + 2 * total)
    check({k: launches[k] for k in per} == per and launches['flash_attention'] == 0,
          f'extend launched {launches}, expected {per}')
    with tempfile.TemporaryDirectory() as tmp:
        path = audio_write(f'{tmp}/extended', stitched[0], SAMPLE_RATE)
        back, sr = audio_read(path)
    peak = normalize_audio(stitched[0].cpu(), strategy='peak')
    err = float(np.abs(back - peak.numpy()).max())
    check(sr == SAMPLE_RATE and back.shape == (1, expect) and err <= 1.0 / 2 ** 15 + 1e-7,
          f'audio_write / audio_read: {back.shape} at {sr}, {err:.3g} from the normalized wav')
    print(f'extend: plan_segments({EXTEND_SECONDS}, {EXTEND_SEGMENT}, {EXTEND_OVERLAP}) = '
          f'{(total, duration, excess)}; the prompt segment and {total} continuations in '
          f'{seconds:.3f} s, segments of {[n // SAMPLE_RATE for n in lengths]} s, stitched '
          f'{expect} samples ({expect / SAMPLE_RATE:.2f} s: sum less half an overlap a join); '
          f'launches {launches} (per continuation K5 1, K4 2, K1 1, K2 2 in the prompt encode '
          f'and 2 in the decode; K2 2 for the prompt segment\'s decode); written and read back '
          f'as 16-bit wav, {err:.3g} from the peak-normalized audio; card {card()}', flush=True)
    return launches


def _melody_musicgen(device) -> tp.Dict[str, int]:
    """13.2: MusicGen-melody-medium at the published widths."""
    t0 = time.perf_counter()
    mg = get_musicgen('medium', melody=True, seed=80)
    build_s = time.perf_counter() - t0
    seed_codebooks(mg.compression_model, _clips(8, SECONDS * SAMPLE_RATE, device, seed=84))
    mg.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
    lm = mg.lm
    check(mg.name == 'musicgen-melody-medium' and lm.dim == 1536
          and len(lm.transformer.layers) == 48 and lm.transformer.num_heads == 24,
          f'{mg.name}: dim {lm.dim}, {len(lm.transformer.layers)} layers')
    mg.set_generation_params(duration=MEL_SECONDS, top_k=250, cfg_coef=3.0)
    wav, _ = _melodies(MEL_PROMPTS, MEL_SECONDS, seed=81)
    melodies = [torch.from_numpy(w).to(device) for w in wav]
    descriptions = [f'a tune to follow, take {i}' for i in range(MEL_PROMPTS)]
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    audio, tokens, gen_s, total_s, state = _generate_timed(mg, descriptions, melodies, 82)
    launches = _launch_counts()
    frames = int(MEL_SECONDS * mg.frame_rate)
    check(tuple(tokens.shape) == (MEL_PROMPTS, 4, frames)
          and bool(((tokens >= 0) & (tokens < lm.card)).all()), f'tokens {tuple(tokens.shape)}')
    check(tuple(audio.shape) == (MEL_PROMPTS, 1, MEL_SECONDS * SAMPLE_RATE)
          and bool(torch.isfinite(audio).all()), f'melody audio {tuple(audio.shape)}')
    expect = {k: 2 if k == 'lstm_step' else 0 for k in launches}
    check(launches == expect, f'melody generate launched {launches}, not K2 twice (the decode)')
    print(f'get_musicgen(\'medium\', melody=True) built in {build_s:.1f} s', flush=True)
    prefix = _print_generate('MusicGen-melody-medium', mg, tokens, audio, gen_s, total_s, state,
                             launches, 2 * MEL_PROMPTS)
    _lap('melody build, generate and step')
    check(prefix == 938, f'melody prefix {prefix} frames, not 938')
    del audio, tokens, state

    # two generates in one DecodeCache with other melodies, then the second
    # from a fresh cache: the captured steps read the prefix of their call
    mg.set_generation_params(duration=MEL_CHECK_SECONDS, top_k=250, cfg_coef=3.0)
    other = [torch.from_numpy(w).to(device) for w in _melodies(MEL_PROMPTS, MEL_SECONDS, 83)[0]]
    runs = []
    for mels, fresh in ((melodies, False), (other, False), (other, True)):
        if fresh:
            mg._decode_cache.clear()
        runs.append(mg.generate_with_chroma(descriptions, mels, SAMPLE_RATE,
                                            generator=torch.Generator().manual_seed(85),
                                            return_tokens=True)[1])
    check(torch.equal(runs[1], runs[2]), 'a reused decode state gave other tokens than a fresh '
                                         'one for the same melodies (a stale prefix)')
    share = float((runs[0] == runs[1]).float().mean())
    check(share < 1.0, 'two melodies gave the same tokens')
    print(f'stale-prefix check at {MEL_CHECK_SECONDS} s: melodies A then B in one DecodeCache, '
          f'B again from a fresh one: B equal bit for bit; A and B share {share:.3f} of their '
          f'tokens', flush=True)
    mg._decode_cache.clear()
    torch.cuda.empty_cache()
    _lap('stale-prefix check')
    phase_melody_parity(device, mg, descriptions, melodies)
    _lap('melody fp32 parity')
    extend_launches = _extend_melody(device, mg)
    _lap('extend')
    mg._decode_cache.clear()
    return {'generate': launches['lstm_step'], **{f'extend {k}': v for k, v in
                                                  extend_launches.items() if v}}


def _style_inputs(style, clips: torch.Tensor) -> WavCondition:
    """The double-CFG batch the facade collates for ``clips``: each clip, the
    clips again (the style-only rows) and the null rows, zero-padded to the
    clips' length with length 0."""
    B, _, T = clips.shape
    wav = torch.cat([clips, clips, torch.zeros_like(clips)]).cpu().numpy()
    lengths = np.array([T] * (2 * B) + [0] * B)
    return WavCondition(wav, lengths, [SAMPLE_RATE] * 3 * B, [None] * 3 * B, [None] * 3 * B)


def check_style_kernels(device, style, x: WavCondition) -> None:
    """K1 at the bottleneck's shape (D = 512, K = 1024, n_q = 3), K4's fp32
    variant at the excerpt's stages and K2 in fp32 at its T = 150, each
    against its plain version on the inputs the style forward gives it,
    then timed beside its plain version and bound."""
    wav = torch.from_numpy(x.wav).to(device)
    name = card()
    with torch.no_grad():
        z = style.embed_tokens(style.excerpt_tokens(wav))
        flat = z.reshape(-1, z.shape[-1]).contiguous()
        embeds = style.rvq.embeds()[:style.eval_q].contiguous()
        codes, plain = rvq_encode(flat, embeds), rvq_encode_reference(flat, embeds)
        near = _near_ties(flat, embeds, plain)
        check(not bool((codes != plain)[:, ~near].any()),
              'rvq at the style bottleneck: codes differ from plain off near-ties')
        n, d = flat.shape
        q, k, _ = embeds.shape
        b_ms, b_by = bound_ms(2.0 * n * d * k * q, PEAK_FP32, 4.0 * (n * d + q * k * d + q * n))
        ms = time_ms(lambda: rvq_encode(flat, embeds), 10)
        plain_ms = time_ms(lambda: rvq_encode_reference(flat, embeds), 10)
        print(f'rvq at the style bottleneck N={n} D={d} K={k} n_q={q}: codes equal to plain on '
              f'{int((~near).sum())} rows ({int(near.sum())} near-tie rows excluded); kernel '
              f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); plan '
              f'{rvq_plan(d).rows} rows a block, {rvq_kernel_info(n, d, k, q)["blocks"]} blocks; '
              f'card {name}', flush=True)
        enc = style.feat_extractor.encoder
        start = style.excerpt_start(wav.shape[-1])
        n_samples = int(style.length * style.sample_rate)
        y = enc.model[0](wav[..., start:start + n_samples].contiguous())
        for si, (spec, ids) in enumerate(encoder_stage_plan(enc)[:2]):
            params = encoder_stage_weights(enc, spec, ids, torch.float32)
            check(stage_route(spec, torch.float32)[1] == tiled_plan(spec),
                  f'K4 fp32 stage {si} at the style excerpt does not take the tiled kernel')
            # beside the cuDNN module stack it replaces (the encoder's own layers, fp32)
            stack = torch.nn.Sequential(*enc.model[ids[0]:ids[1] + 1])
            row = time_fp32_kernels.time_stage(spec, y, params, stack, reps=5)
            time_fp32_kernels.print_stage(si, 'style excerpt', spec, row, name)
            check(row['max_rel'] <= 1e-5, f'K4 fp32 stage {si} at the style excerpt: '
                                          f'{row["max_rel"]:.3g} > 1e-5')
            y = fused_stage(y, params, spec)
    T, B, H = int(style.length * style.feat_extractor.frame_rate), wav.shape[0], 1024
    args = [a.to(device) for a in _lstm_args(T, B, H, seed=92)]
    out, ref = lstm_layer(*args), lstm_layer_reference(*args)
    err = float((out - ref).abs().max())
    check(err <= 1e-4, f'K2 fp32 T={T} B={B}: max-abs {err:.3g} > 1e-4')
    cudnn, _ = _cudnn_lstm(args)
    with torch.no_grad():
        library = time_ms(lambda: cudnn(args[0]), 10)
    l_ms, l_by = bound_ms(2.0 * T * B * 4 * H * 2 * H, PEAK_FP32,
                          4.0 * (2 * T * B * H + 8 * H * H + 8 * H))
    print(f'K2 fp32 at the style excerpt T={T} B={B} H={H}: max-abs against plain {err:.3g} '
          f'(<= 1e-4); kernel {time_ms(lambda: lstm_layer(*args), 10):.4f} ms, plain '
          f'{time_ms(lambda: lstm_layer_reference(*args), 3):.4f} ms, cuDNN nn.LSTM '
          f'{library:.4f} ms, bound {l_ms:.4f} ms ({l_by}); plan '
          f'{plan_text(lstm_ops.device_plan(H, B, torch.float32, device))}; card {name}',
          flush=True)


def _style_musicgen(device) -> tp.Dict[str, int]:
    """13.4: MusicGen-style-medium at the published widths, double CFG."""
    t0 = time.perf_counter()
    smg = get_musicgen('medium', style=True, seed=90)
    build_s = time.perf_counter() - t0
    smg.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
    style = smg.condition_provider.conditioners['self_wav']
    seed_codebooks(smg.compression_model, _clips(8, SECONDS * SAMPLE_RATE, device, seed=94))
    if style.feat_extractor is not smg.compression_model:
        seed_codebooks(style.feat_extractor, _clips(8, SECONDS * SAMPLE_RATE, device, seed=95))
    check(smg.name == 'musicgen-style-medium' and smg.lm.dim == 1536
          and style.feat_extractor.compute_dtype is None and style.dim == 512
          and style.rvq.bins == 1024 and style.eval_q == 3,
          f'{smg.name}: style dim {style.dim}, eval_q {style.eval_q}')
    clips = _clips(MEL_PROMPTS, MEL_SECONDS * SAMPLE_RATE, device, seed=91)
    x = _style_inputs(style, clips)
    _reset_launch_counts()
    emb, mask = style(x)
    torch.cuda.synchronize()
    cond_launches = _launch_counts()
    expect = dict(banded_mono_conv=1, fused_stage=2, lstm_step=2, rvq_encode=2)
    check({k: cond_launches[k] for k in expect} == expect,
          f'the style forward launched {cond_launches}, not {expect}')
    cpu_style = copy.deepcopy(style).cpu()
    emb_cpu, mask_cpu = cpu_style(x)
    wav = torch.from_numpy(x.wav)
    with torch.no_grad():
        tokens, tokens_cpu = style.excerpt_tokens(wav.to(device)).cpu(), cpu_style.excerpt_tokens(wav)
        z_cpu = cpu_style.embed_tokens(tokens_cpu)
        z = style.embed_tokens(tokens_cpu.to(device)).cpu()
        zq, codes = (t.cpu() for t in style.bottleneck(z.to(device)))
        zq_cpu, codes_cpu = cpu_style.bottleneck(z_cpu)
    same_tokens = torch.equal(tokens, tokens_cpu)
    rel = float((emb.cpu() - emb_cpu).abs().max() / emb_cpu.abs().max())
    rel_z = float((z - z_cpu).abs().max() / z_cpu.abs().max())
    rel_q = float((zq - zq_cpu).abs().max() / zq_cpu.abs().max())
    rows = z_cpu.reshape(-1, z_cpu.shape[-1])
    near = _near_ties(rows, cpu_style.rvq.embeds()[:style.eval_q],
                      codes_cpu.permute(1, 0, 2).reshape(style.eval_q, -1), rel=1e-4)
    differ = (codes != codes_cpu).any(1).reshape(-1)
    print(f'style embeddings {tuple(emb.shape)} (mask {mask.sum(1).tolist()}), card against CPU: '
          f'codec tokens of the excerpt equal {same_tokens}; embeddings max-abs / max {rel:.3g} '
          f'(<= 1e-4 when the tokens are equal); from the CPU\'s tokens, the bottleneck input '
          f'{rel_z:.3g} and output {rel_q:.3g} (<= 1e-4), its codes {tuple(codes.shape)} differ on '
          f'{int(differ.sum())} of {differ.numel()} frames, near-ties {int((differ & near).sum())}; '
          f'launches of the style forward {cond_launches}', flush=True)
    if same_tokens:
        check(rel <= 1e-4, f'style embeddings card vs CPU rel {rel:.3g} > 1e-4')
    else:   # the excerpt's codes apart only at near-ties; the rest held from shared tokens
        start = style.excerpt_start(wav.shape[-1])
        excerpt = wav[..., start:start + int(style.length * style.sample_rate)]
        _fp32_codes_vs_cpu('style codec', style.feat_extractor.encode_to_latent(
            excerpt.to(device)), cpu_style.feat_extractor.encode_to_latent(excerpt),
            style.feat_extractor, cpu_style.feat_extractor)
    check(torch.equal(mask.cpu(), mask_cpu), 'style mask card != CPU')
    check(rel_z <= 1e-4 and rel_q <= 1e-4, f'style bottleneck rel {rel_z:.3g} / {rel_q:.3g}')
    check(bool((near | ~differ).all()), 'style bottleneck codes differ off near-ties')
    del cpu_style
    _lap('style build and embeddings against the CPU')
    check_style_kernels(device, style, x)
    _lap('K1, K4 fp32 and K2 fp32 at the style shapes')

    smg.set_generation_params(duration=MEL_SECONDS, top_k=250, cfg_coef=3.0, cfg_coef_beta=5.0)
    descriptions = [f'in this style, take {i}' for i in range(MEL_PROMPTS)]
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    audio, tokens, gen_s, total_s, state = _generate_timed(
        smg, descriptions, [c for c in clips], 93)
    launches = _launch_counts()
    frames = int(MEL_SECONDS * smg.frame_rate)
    check(tuple(tokens.shape) == (MEL_PROMPTS, 4, frames)
          and bool(((tokens >= 0) & (tokens < smg.lm.card)).all()), f'tokens {tuple(tokens.shape)}')
    check(tuple(audio.shape) == (MEL_PROMPTS, 1, MEL_SECONDS * SAMPLE_RATE)
          and bool(torch.isfinite(audio).all()), f'style audio {tuple(audio.shape)}')
    expect = dict(banded_mono_conv=1, fused_stage=2, rvq_encode=2, lstm_step=4)
    check({k: launches[k] for k in expect} == expect and launches['flash_attention'] == 0,
          f'style generate launched {launches}, not {expect}')
    check(state.plan['n_groups'] == 3, 'the style generate is not double CFG')
    print(f'get_musicgen(\'medium\', style=True) built in {build_s:.1f} s', flush=True)
    prefix = _print_generate('MusicGen-style-medium (double CFG 3.0 / beta 5.0)', smg, tokens,
                             audio, gen_s, total_s, state, launches, 3 * MEL_PROMPTS)
    _lap('style generate and step')
    check(prefix == 10, f'style prefix {prefix} frames, not 10')
    smg._decode_cache.clear()
    return launches


def phase_melody_style(device) -> tp.Dict[str, tp.Dict[str, int]]:
    print("== phase 13: melody and style: chroma on the card, get_musicgen('medium', "
          "melody=True) with the extend utility, get_musicgen('medium', style=True)", flush=True)
    start = _LAP[0] = time.perf_counter()
    check_chroma(device)
    _lap('chroma')
    launches = {'musicgen-melody': _melody_musicgen(device)}
    torch.cuda.empty_cache()
    _lap('melody model freed')
    launches['musicgen-style'] = _style_musicgen(device)
    torch.cuda.empty_cache()
    print(f'phase 13: {time.perf_counter() - start:.1f} s; launches by path {launches}',
          flush=True)
    return launches


# phase 14: EnCodec training at the 32 kHz codec's widths with the JAX CLI's
# defaults (8 clips x 1 s, Adam 3e-4, the balancer's weights, bf16 compute on
# fp32 masters), 3 warm-up and 10 timed steps; fp32 parity with the CPU at
# 2 x 0.5 s; the group path on a world-size-1 NCCL group, with
# MusicGen-small's data-parallel LM step at 2 x 10 s
CT_BATCH, CT_SECONDS, CT_WARM, CT_TIMED = 8, 1, 3, 10
CT_PARITY_BATCH, CT_PARITY_SAMPLES, CT_LR = 2, SAMPLE_RATE // 2, 3e-4


class _GradCapture:
    """An optimizer that keeps the gradients it is given and updates nothing."""

    def init(self, params):
        return OptState(0, [], [])

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        state.count += 1


class _CodecTrainer:
    """A codec, the EnCodec discriminator, Adam for both, the balancer and
    both steps, from seeds; ``optimizer`` makes both optimizers instead of
    Adam."""

    def __init__(self, device, seed: int, compute_dtype, group=None, optimizer=None):
        self.model = get_encodec_32khz(compute_dtype=None, device=device, seed=seed)
        self.disc = MultiScaleSTFTDiscriminator(
            generator=torch.Generator().manual_seed(seed + 1)).to(device)
        self.g_opt = optimizer() if optimizer else make_optimizer('adam', CT_LR)
        self.d_opt = optimizer() if optimizer else make_optimizer('adam', CT_LR)
        self.balancer = Balancer(weights=dict(GAN_WEIGHTS))
        self.gan = make_encodec_gan_train_step(self.model, self.disc, self.g_opt, self.d_opt,
                                               self.balancer, compute_dtype=compute_dtype,
                                               group=group)
        self.recon = make_encodec_train_step(self.model, self.g_opt,
                                             compute_dtype=compute_dtype, group=group)
        self.g_state = self.g_opt.init(list(self.model.parameters()))
        self.r_state = self.g_opt.init(list(self.model.parameters()))
        self.d_state = self.d_opt.init(list(self.disc.parameters()))
        self.bal = self.balancer.init_state(device)
        self.generator = torch.Generator().manual_seed(seed + 2)

    def gan_step(self, x, on_part=None):
        return self.gan(self.g_state, self.d_state, self.bal, x, self.generator, on_part=on_part)

    def recon_step(self, x, on_part=None):
        return self.recon(self.r_state, x, self.generator, on_part=on_part)


def _time_train_steps(step, wav, what: str) -> tp.Dict[str, tp.Any]:
    """CT_TIMED steps timed by CUDA events per part and by the host clock,
    peak memory over them, then CT_TIMED more under the profiler for the
    device's idle share; every loss must be finite."""
    marks: tp.List[tp.Tuple[str, torch.cuda.Event]] = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    starts, metrics = [], []
    t0 = time.perf_counter()
    for _ in range(CT_TIMED):
        starts.append(len(marks))
        marks.append(('start', _event()))
        metrics.append(step(wav, on_part=lambda name: marks.append((name, _event()))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    parts: tp.Dict[str, float] = {}
    for i in range(1, len(marks)):
        name, ev = marks[i]
        if name != 'start':
            parts[name] = parts.get(name, 0.0) + marks[i - 1][1].elapsed_time(ev) / CT_TIMED
    for m in metrics:
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        check(not bad, f'{what}: non-finite {bad}')
    busy, window, kernels = _cuda_busy_ms(lambda: [step(wav) for _ in range(CT_TIMED)])
    step_ms = sum(parts.values())
    audio_s = wav.shape[0] * wav.shape[-1] / SAMPLE_RATE
    print(f'{what}: {step_ms:.3f} ms a step by CUDA events ('
          + ', '.join(f'{k} {v:.3f}' for k, v in parts.items())
          + f'); {wall / CT_TIMED * 1e3:.3f} ms by the host clock = '
          f'{audio_s * CT_TIMED / wall:.1f} audio-s trained/s; peak memory '
          f'{peak / 2**30:.3f} GiB; device busy {busy:.1f} of {window:.1f} ms over '
          f'{CT_TIMED} steps under the profiler: idle share {1 - busy / window:.3f}', flush=True)
    print(f'{what}: last metrics ' + ', '.join(f'{k} {float(v):.4g}' for k, v in
                                               metrics[-1].items()), flush=True)
    print(f'{what}: {len(kernels)} kernel names; the most device time a step (ms): '
          + '; '.join(f'{e.key[:60]} {e.self_device_time_total / 1e3 / CT_TIMED:.3f} '
                      f'x{e.count // CT_TIMED}' for e in kernels[:8]), flush=True)
    return dict(step_ms=step_ms, parts=parts, host_ms=wall / CT_TIMED * 1e3, peak=peak,
                idle=1 - busy / window)


def _codebook_usage(model) -> tp.List[int]:
    return [int((layer._codebook.cluster_size >= layer._codebook.threshold_ema_dead_code).sum())
            for layer in model.quantizer.vq.layers]


def _capture_codes(model) -> tp.Tuple[list, tp.Any]:
    """Each quantizer forward's input rows and codes, through hooks."""
    seen: list = []

    def pre(module, args):
        seen.append(['input', args[0].detach().clone()])

    def post(module, args, out):
        seen[-1].append(out.codes.detach().clone())

    return seen, (model.quantizer.register_forward_pre_hook(pre),
                  model.quantizer.register_forward_hook(post))


def check_gan_step(device) -> dict:
    """14a: the GAN step and the reconstruction step at full width, from a
    fresh codec (k-means on the first batch)."""
    tr = _CodecTrainer(device, seed=100, compute_dtype='bfloat16')
    check(all(float(layer._codebook.inited) == 0 for layer in tr.model.quantizer.vq.layers),
          'a fresh codec is not un-inited')
    wav = _clips(CT_BATCH, CT_SECONDS * SAMPLE_RATE, device, seed=101)
    lstm = {n: p.detach().clone() for n, p in tr.model.named_parameters() if '.lstm.' in n}
    _reset_launch_counts()
    tr.gan_step(wav)
    torch.cuda.synchronize()
    launches = _launch_counts()
    check(all(float(layer._codebook.inited) == 1 for layer in tr.model.quantizer.vq.layers),
          'k-means did not run on the first batch')
    # Adam's first update is lr * g / (|g| + eps): an element moves iff its gradient is non-zero
    moved = {n: float((p.detach() != lstm[n]).float().mean())
             for n, p in tr.model.named_parameters() if n in lstm}
    print('LSTM weights moved by the first Adam step (share of elements): '
          + ', '.join(f'{n} {v:.4f}' for n, v in moved.items()), flush=True)
    check(len(moved) == 16 and min(moved.values()) > 0.5,
          f'LSTM weights got zero gradients: {moved}')
    check(sum(launches.values()) == 0,
          f'the training step launched forward-only kernels: {launches}')
    for _ in range(CT_WARM - 1):
        tr.gan_step(wav)
    gan = _time_train_steps(tr.gan_step, wav, 'GAN step (8 x 1 s, bf16 compute)')
    seen, hooks = _capture_codes(tr.model)
    tr.gan_step(wav)
    for h in hooks:
        h.remove()
    codes = seen[-1][2]
    print(f'codebook usage after {CT_WARM + 2 * CT_TIMED + 2} GAN steps: active codes '
          f'(EMA count >= 2) per codebook {_codebook_usage(tr.model)} of '
          f'{tr.model.quantizer.bins}; distinct codes in '
          f'the last batch {[int(codes[:, q].unique().numel()) for q in range(codes.shape[1])]}',
          flush=True)
    for _ in range(CT_WARM):
        tr.recon_step(wav)
    recon = _time_train_steps(tr.recon_step, wav, 'reconstruction step (8 x 1 s, bf16 compute)')
    print(f'card {card()}', flush=True)
    return {'gan': gan, 'recon': recon}


def check_gan_parity(device) -> None:
    """14b: one fp32 GAN step at 2 x 0.5 s on the card and on the CPU, the
    same weights, codebooks and draws: losses within 1e-4 relative, codes
    equal but at near-ties, the EMA state within 1e-5, gradients within 1e-3
    relative in global norm (gradients, not post-Adam weights)."""
    gpu, cpu = (_CodecTrainer(dev, seed=110, compute_dtype=None, optimizer=_GradCapture)
                for dev in (device, torch.device('cpu')))
    seed_codebooks(gpu.model, _clips(8, SECONDS * SAMPLE_RATE, device, seed=111))
    gen = torch.Generator().manual_seed(112)
    bins = gpu.model.quantizer.bins
    for layer in gpu.model.quantizer.vq.layers:   # some codes under the expiry threshold
        layer._codebook.cluster_size.copy_(6 * torch.rand(bins, generator=gen))
    cpu.model.load_state_dict(gpu.model.state_dict())
    cpu.disc.load_state_dict(gpu.disc.state_dict())
    before = [layer._codebook.embed.cpu().clone() for layer in cpu.model.quantizer.vq.layers]
    wav = _clips(CT_PARITY_BATCH, CT_PARITY_SAMPLES, torch.device('cpu'), seed=113)
    results = []
    for tr in (gpu, cpu):
        seen, hooks = _capture_codes(tr.model)
        metrics = tr.gan_step(wav.to(next(tr.model.parameters()).device))
        for h in hooks:
            h.remove()
        state = {k: torch.stack([getattr(layer._codebook, k) for layer in
                                 tr.model.quantizer.vq.layers]).cpu()
                 for k in ('cluster_size', 'embed_avg', 'embed')}
        results.append((metrics, seen[-1][1].cpu(), seen[-1][2].cpu(), state,
                        [g.cpu() for g in tr.g_opt.grads], [g.cpu() for g in tr.d_opt.grads]))
    (mg, _, cg, sg, gg, dg), (mc, xc, cc, sc, gc, dc) = results
    worst = max(abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])), 1e-30) for k in mc)
    rows = xc.transpose(1, 2).reshape(-1, xc.shape[1])
    flat_c = cc.permute(1, 0, 2).reshape(cc.shape[1], -1)
    flat_g = cg.permute(1, 0, 2).reshape(cg.shape[1], -1)
    near = _near_ties(rows, before, flat_c, rel=1e-5)
    differ = (flat_c != flat_g).any(0)
    check(not bool((differ & ~near).any()),
          f'{int((differ & ~near).sum())} code rows differ away from near-ties')
    touched = torch.zeros(bins, dtype=torch.bool)
    for q in range(flat_c.shape[0]):
        touched[flat_c[q, differ].long()] = True
        touched[flat_g[q, differ].long()] = True
    ema = max(float(((sg[k] - sc[k]).abs() - 1e-5 * sc[k].abs())[:, ~touched].max())
              for k in sc)
    norm = lambda gs: torch.sqrt(sum(g.double().square().sum() for g in gs))
    g_rel = float(norm([a - b for a, b in zip(gg, gc)]) / norm(gc))
    d_rel = float(norm([a - b for a, b in zip(dg, dc)]) / norm(dc))
    print(f'fp32 GAN step, card vs CPU at {CT_PARITY_BATCH} x 0.5 s: worst loss rel {worst:.3g} '
          f'(<= 1e-4); code rows differing {int(differ.sum())} of {differ.numel()} (near-ties '
          f'{int(near.sum())}); EMA state excess over 1e-5 + 1e-5 rel {ema:.3g} (<= 0) on '
          f'{int((~touched).sum())} untouched codes; generator gradients rel {g_rel:.3g}, '
          f'discriminator gradients rel {d_rel:.3g} (<= 1e-3)', flush=True)
    check(worst <= 1e-4, f'losses differ by {worst:.3g}')
    check(ema <= 1e-5, f'EMA state differs by {ema:.3g} beyond 1e-5')
    check(g_rel <= 1e-3 and d_rel <= 1e-3, f'gradients differ: {g_rel:.3g}, {d_rel:.3g}')


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _trainer_tensors(tr) -> tp.Dict[str, torch.Tensor]:
    out = {f'model.{k}': v for k, v in tr.model.state_dict().items()}
    out.update({f'disc.{k}': v for k, v in tr.disc.state_dict().items()})
    out.update({f'bal.{k}': v for k, v in tr.bal.items()})
    for name, st in (('g', tr.g_state), ('d', tr.d_state)):
        out.update({f'{name}.mu{i}': t for i, t in enumerate(st.mu)})
        out.update({f'{name}.nu{i}': t for i, t in enumerate(st.nu)})
    return out


def check_group_path(device) -> tp.Dict[str, int]:
    """14c: a world-size-1 NCCL group: the GAN step with the group equals
    the step without, bit for bit; the data-parallel LM step (make_lm_train_step
    with the group) at MusicGen-small widths equals the step without, running
    K3f and K3b at LM_DP_ATTN_SHAPE, which phase 2 holds against plain."""
    import torch.distributed as dist
    group = make_data_group('nccl', f'tcp://127.0.0.1:{_free_port()}', 1, 0)
    wav = _clips(CT_BATCH, CT_SECONDS * SAMPLE_RATE, device, seed=121)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out = {}
        for name, g in (('alone', None), ('group', group)):
            tr = _CodecTrainer(device, seed=120, compute_dtype='bfloat16', group=g)
            metrics = [tr.gan_step(wav) for _ in range(2)]   # k-means, then the EMA
            out[name] = (metrics, _trainer_tensors(tr))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    (ma, ta), (mb, tb) = out['alone'], out['group']
    diff = [k for k in ta if not torch.equal(ta[k], tb[k])]
    diff += [f'metric {k}' for a, b in zip(ma, mb) for k in a if not torch.equal(a[k], b[k])]
    print(f'GAN step with a world-size-1 NCCL group against the step alone, 2 steps: '
          f'{len(ta)} tensors and {sum(len(m) for m in ma)} metrics compared, '
          f'{len(diff)} differ {diff[:5]}', flush=True)
    check(not diff, f'the group step differs from the step alone: {diff[:5]}')

    lm, provider = get_musicgen_lm('small', seed=1)
    gen = torch.Generator().manual_seed(122)
    codes = torch.randint(0, lm.card, (LM_DP_BATCH, lm.n_q, LM_DP_SECONDS * 50),
                          generator=gen).to(device)
    cond = _train_conditions(provider, LM_DP_BATCH, device, seed=123)
    grads, launches = {}, {}
    for name in ('alone', 'dp'):
        cap = _GradCapture()
        step = make_lm_train_step(lm, cap, compute_dtype='bfloat16',
                                  group=None if name == 'alone' else group)
        _reset_launch_counts()
        loss = float(step(cap.init(None), codes, cond)['loss'])
        launches[name] = _launch_counts()
        grads[name] = (loss, cap.grads)
    (la, ga), (lb, gb) = grads['alone'], grads['dp']
    norm = lambda gs: torch.sqrt(sum(g.double().square().sum() for g in gs))
    rel = float(norm([a - b for a, b in zip(ga, gb)]) / norm(ga))
    same = all(torch.equal(a, b) for a, b in zip(ga, gb))
    k = launches['dp']
    print(f"make_lm_train_step with the group at MusicGen-small widths, {LM_DP_BATCH} x "
          f"{LM_DP_SECONDS} s (attention {LM_DP_ATTN_SHAPE}): "
          f"loss {lb:.6f} against {la:.6f}; gradients bit-equal {same}, rel {rel:.3g}; "
          f"launches in the dp step: K3f {k['flash_attention']}, K3b dK/dV "
          f"{k['flash_attention_bwd_dkv']}, dQ {k['flash_attention_bwd_dq']}", flush=True)
    check(la == lb and rel <= 1e-6, f'the dp LM step differs: loss {lb} vs {la}, rel {rel:.3g}')
    check(k['flash_attention'] > 0 and k['flash_attention_bwd_dkv'] > 0
          and k['flash_attention_bwd_dq'] > 0, f'the dp LM step launched {k}')
    # per-layer checkpointing: K3f runs again in the backward, the gradients stay
    lm.transformer.checkpointing = True
    cap = _GradCapture()
    _reset_launch_counts()
    lc = float(make_lm_train_step(lm, cap, compute_dtype='bfloat16')(cap.init(None), codes,
                                                                     cond)['loss'])
    kc = _launch_counts()
    lm.transformer.checkpointing = False
    rel_c = float(norm([a - b for a, b in zip(ga, cap.grads)]) / norm(ga))
    print(f'the same LM step with per-layer checkpointing: loss {lc:.6f}, gradients rel '
          f'{rel_c:.3g} (<= 1e-6); K3f launches {kc["flash_attention"]} (twice the '
          f'{launches["alone"]["flash_attention"]} without)', flush=True)
    check(lc == la and rel_c <= 1e-6, f'checkpointing changed the step: rel {rel_c:.3g}')
    check(kc['flash_attention'] == 2 * launches['alone']['flash_attention'],
          f'checkpointing launched K3f {kc["flash_attention"]} times')
    dist.destroy_process_group()
    del lm, provider
    torch.cuda.empty_cache()
    return k


def check_grad_refusal(device) -> None:
    """14d: K2, K4 and K5 raise on a CUDA input that requires a gradient."""
    refused = {}
    x = torch.zeros(4, 2, 64, device=device, requires_grad=True)
    w = [torch.zeros(256, 64, device=device) for _ in range(2)] + \
        [torch.zeros(256, device=device) for _ in range(2)]
    spec = STAGES[0][0]
    cases = {
        'K2 lstm_layer': lambda: lstm_layer(x, *w),
        'K4 fused_stage': lambda: fused_stage(
            torch.zeros(1, spec.c_in, 64, device=device, requires_grad=True),
            _stage_params(spec, device, torch.bfloat16, seed=1), spec),
        'K5 banded_mono_conv': lambda: banded_mono_conv(
            torch.zeros(1, 1, 70, device=device, requires_grad=True),
            torch.zeros(64, 1, 7, device=device), torch.zeros(64, device=device)),
    }
    for name, fn in cases.items():
        try:
            fn()
            refused[name] = False
        except RuntimeError as err:
            refused[name] = 'no backward' in str(err)
    print(f'forward-only kernels refuse a grad-requiring input on the card: {refused}',
          flush=True)
    check(all(refused.values()), f'a kernel took a grad-requiring input: {refused}')


def phase_codec_training(device) -> tp.Dict[str, int]:
    print("== phase 14: codec training, get_encodec_32khz() with the MS-STFT discriminator: "
          'the GAN and reconstruction steps, fp32 parity with the CPU, the NCCL group path',
          flush=True)
    start = time.perf_counter()
    check_gan_step(device)
    print(f'-- 14a {time.perf_counter() - start:.1f} s', flush=True)
    check_gan_parity(device)
    print(f'-- 14b {time.perf_counter() - start:.1f} s', flush=True)
    launches = check_group_path(device)
    check_grad_refusal(device)
    print(f'phase 14: {time.perf_counter() - start:.1f} s', flush=True)
    return launches



# phase 15: HTDemucs at the published widths (one 7.8 s window, a 30 s mix in
# six windows, card against CPU at 1 s); a 10 s melody's chroma behind the
# vocals and other stems; JASCO at get_jasco_model()'s widths, 2 samples x
# 10 s with 3 CFG terms (all conditions, text only, null; weights summing to
# 1), the 100-step Euler generate on each attention route and one dopri5
# generate; the joint embedding's bottleneck (K1 at N = 8, D = 512)
DM_WINDOW_S, DM_MIX_S, DM_PARITY_S = 7.8, 30, 1
JASCO_SAMPLES, JASCO_SECONDS, JASCO_STEPS = 2, 10, 100
JASCO_CFG = (3.0, 1.0, -3.0)
JE_ROWS, JE_DIM, JE_OUT = 8, 512, 1536


def _sync_s(fn):
    """(fn(), host seconds to the end of its device work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _stereo_mix(seconds: float, sr: int, seed: int) -> torch.Tensor:
    """Seeded stereo test audio [1, 2, T]: a few tones, a pulse train and noise."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(int(seconds * sr)) / sr
    freqs = 60 + 1500 * torch.rand(2, 5, 1, generator=gen)
    tones = torch.sin(2 * math.pi * freqs * t).sum(1) * 0.08
    pulse = (torch.sin(2 * math.pi * 2.0 * t) > 0.95).float() * 0.3
    return (tones + pulse + 0.02 * torch.randn(2, t.shape[0], generator=gen))[None]


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max() / b.float().abs().max())


def check_demucs(device) -> HTDemucs:
    """15a: HTDemucs at ``HTDemucsConfig()``'s widths, fp32 with cuDNN's
    TF32 off: the card against the CPU on a 1 s mix (within 1e-4 of the
    stems' largest value); one 7.8 s window and a 30 s mix in six windows,
    timed, with their audio-s/s and peak memory; the device's kernels over
    one window under the profiler."""
    name = card()
    model, build_s = _sync_s(lambda: get_htdemucs(seed=150))
    sr = model.cfg.sample_rate
    print(f'HTDemucs {model.cfg}: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M '
          f'parameters, built in {build_s:.1f} s', flush=True)
    x = _stereo_mix(DM_PARITY_S, sr, seed=151)
    cpu = get_htdemucs(device='cpu', seed=150)
    card_stems, cpu_stems = model.separate(x.to(device)).cpu(), cpu.separate(x)
    err = _rel_err(card_stems, cpu_stems)
    print(f'HTDemucs {DM_PARITY_S} s mix {tuple(x.shape)} -> stems {tuple(card_stems.shape)}: '
          f'card against CPU max-abs / max {err:.3g} (<= 1e-4)', flush=True)
    check(err <= 1e-4, f'HTDemucs card vs CPU {err:.3g} > 1e-4')
    check(torch.backends.cudnn.allow_tf32, 'HTDemucs did not restore the cuDNN TF32 flag')
    del cpu
    window = _stereo_mix(DM_WINDOW_S, sr, seed=152).to(device)
    check(window.shape[-1] <= model.segment_length(), 'the 7.8 s mix is longer than a window')
    win_ms = time_ms(lambda: model.separate(window), 3)
    mix = _stereo_mix(DM_MIX_S, sr, seed=153).to(device)
    torch.cuda.reset_peak_memory_stats()
    stems, mix_s = _sync_s(lambda: model.separate(mix))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_win = len(range(0, mix.shape[-1], int(model.segment_length() * 0.75)))
    check(tuple(stems.shape) == (1, 4, 2, mix.shape[-1]) and bool(torch.isfinite(stems).all()),
          f'HTDemucs 30 s stems {tuple(stems.shape)} not finite or mis-shaped')
    recon = _rel_err(stems.sum(1), mix)
    print(f'HTDemucs one {DM_WINDOW_S} s window ({window.shape[-1]} samples, padded to '
          f'{model.segment_length()}): {win_ms:.1f} ms ({DM_WINDOW_S / win_ms * 1e3:.1f} '
          f'audio-s/s); {DM_MIX_S} s mix in {n_win} windows: {mix_s * 1e3:.1f} ms '
          f'({DM_MIX_S / mix_s:.1f} audio-s/s), peak memory {peak:.2f} GiB; stems summed '
          f'against the mix {recon:.3g} (random weights: information); card {name}', flush=True)
    check(n_win == 6, f'the 30 s mix ran {n_win} windows, not 6')
    padded = torch.nn.functional.pad(window, (0, model.segment_length() - window.shape[-1]))
    busy, span, kernels = _cuda_busy_ms(lambda: model(padded))
    print(f'HTDemucs one window under the profiler: device busy {busy:.1f} ms of '
          f'{span:.1f} ms (idle share {max(0.0, 1 - busy / span):.3f}); kernels by device '
          'time: ' + '; '.join(f'{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms x'
                               f'{e.count}' for e in kernels[:10]), flush=True)
    return model


def check_melody_stems(device, demucs: HTDemucs) -> None:
    """15b: a seeded 10 s melody through MusicGen-melody-medium's chroma
    conditioner (``ChromaConditioner``, 1536 channels) with and without
    ``make_stem_fn(stems=('vocals', 'other'))``, timed."""
    cond = ChromaConditioner(output_dim=1536, sample_rate=SAMPLE_RATE, n_chroma=12,
                             radix2_exp=12, duration=30.0,
                             generator=torch.Generator().manual_seed(154)).to(device)
    wav, _ = _melodies(1, MEL_SECONDS, seed=155)
    x = WavCondition(wav, np.array([wav.shape[-1]]), [SAMPLE_RATE], [None], [None])
    stem_fn = make_stem_fn(demucs, SAMPLE_RATE, stems=('vocals', 'other'))
    with torch.no_grad():
        cond(cond.tokenize(x, stem_fn=stem_fn))                      # warm
        (plain, _), plain_s = _sync_s(lambda: cond(cond.tokenize(x)))
        filtered, stem_s = _sync_s(lambda: cond.tokenize(x, stem_fn=stem_fn))
        (stemmed, _), chroma_s = _sync_s(lambda: cond(filtered))
    check(filtered.wav.shape == wav.shape and np.isfinite(filtered.wav).all(),
          f'the stem hook gave {filtered.wav.shape}')
    check(plain.shape == stemmed.shape and bool(torch.isfinite(stemmed).all()),
          'the chroma condition behind the stems is not finite')
    print(f'melody {tuple(wav.shape)} through the chroma conditioner -> {tuple(stemmed.shape)}: '
          f'{plain_s * 1e3:.1f} ms without the separator, {(stem_s + chroma_s) * 1e3:.1f} ms '
          f'with it (separation {stem_s * 1e3:.1f} ms); card {card()}', flush=True)


def _jasco_attributes(descriptions, chords, melody, drums) -> tp.List[ConditioningAttributes]:
    """The 3 CFG groups stacked on the batch: every condition, the text
    alone (the null chord, a zero melody, a nullified drum wav), nothing."""
    rows = []
    for term in ('all', 'text', 'null'):
        for i, desc in enumerate(descriptions):
            keep = term == 'all'
            a = ConditioningAttributes(text={'description': None if term == 'null' else desc})
            a.symbolic['chords'] = SymbolicCondition(
                frame_chords=chords[i] if keep else np.full_like(chords[i], 194))
            a.symbolic['melody'] = SymbolicCondition(
                melody=melody[i] if keep else np.zeros_like(melody[i]))
            w = drums[i:i + 1] if keep else np.zeros((1, 1, 1), np.float32)
            a.wav['self_wav'] = WavCondition(w, np.array([w.shape[-1]]), [SAMPLE_RATE],
                                             [None], [None])
            rows.append(a)
    return rows


def _jasco_conditions(device, provider, codec, demucs: HTDemucs):
    """15c's conditions: seeded chords, melody salience and mixes; the drum
    stems by Demucs; the provider's tokenize (T5 ids from ``SeededT5Ids``)
    and each conditioner timed; K1, K2, K4 and K5 counted in the drums
    encode, and K1 held against its plain version at the drum rows."""
    n, frames = JASCO_SAMPLES, JASCO_SECONDS * 50
    rng = np.random.RandomState(160)
    chords = [np.repeat(rng.randint(0, 194, frames // 25), 25) for _ in range(n)]
    melody = [rng.rand(53, frames).astype(np.float32) ** 4 for _ in range(n)]
    mix = torch.cat([_clips(1, JASCO_SECONDS * SAMPLE_RATE, device, seed=161 + i)
                     for i in range(n)])
    seed_codebooks(codec, _clips(8, JASCO_SECONDS * SAMPLE_RATE, device, seed=159))
    stem_fn = make_stem_fn(demucs, SAMPLE_RATE, stems=('drums',))
    drums, demucs_s = _sync_s(lambda: stem_fn(mix))
    descriptions = ['funky drums with a walking bass', 'slow jazz ballad']
    provider.conditioners['description'].load_tokenizer = SeededT5Ids
    tokenized, tok_s = _sync_s(lambda: provider.tokenize(
        _jasco_attributes(descriptions, chords, melody, drums)))
    cond, times = {}, {}
    with torch.no_grad():
        for name, module in provider.conditioners.items():
            if name == 'self_wav':
                _reset_launch_counts()
            cond[name], times[name] = _sync_s(lambda: module(tokenized[name]))
            if name == 'self_wav':
                launches = _launch_counts()
    expect = dict(rvq_encode=1, lstm_step=2, fused_stage=2, banded_mono_conv=1)
    check(all(launches[k] == v for k, v in expect.items()),
          f'drums encode launched {launches}, not {expect}')
    check(all(c[0].shape[0] == 3 * n for c in cond.values()), 'a condition lost its CFG rows')
    for name in ('chords', 'melody', 'self_wav'):
        check(cond[name][0].shape[1] == frames, f'{name} has {cond[name][0].shape[1]} frames')
    wav = torch.from_numpy(tokenized['self_wav'].wav).to(device)
    with torch.no_grad():
        lat = codec.encode_to_latent(wav)
        flat = lat.transpose(1, 2).reshape(-1, lat.shape[1]).contiguous()
        embeds = codec.quantizer.embeds().contiguous()
        codes, plain = rvq_encode(flat, embeds), rvq_encode_reference(flat, embeds)
    near = _near_ties(flat, embeds, plain)
    check(not bool((codes != plain)[:, ~near].any()),
          'rvq at the drum rows: codes differ from plain off near-ties')
    print(f'JASCO conditions for {3 * n} rows ({n} samples x 3 CFG terms): Demucs drum stems '
          f'{demucs_s * 1e3:.1f} ms, tokenize {tok_s * 1e3:.1f} ms, T5 '
          f'{times["description"] * 1e3:.1f} ms, drums (codec encode, first-codebook latent, '
          f'blur) {times["self_wav"] * 1e3:.1f} ms, chords {times["chords"] * 1e3:.2f} ms, '
          f'melody {times["melody"] * 1e3:.2f} ms; drums encode launches {launches}; K1 at '
          f'the drum rows N={flat.shape[0]} D={flat.shape[1]}: codes equal to plain on '
          f'{int((~near).sum())} rows ({int(near.sum())} near-tie rows excluded); card {card()}',
          flush=True)
    return cond, launches


def check_jasco_attention(device) -> None:
    """K3f at the U-net's self-attention, [6, 500, 8, 64] fp32 non-causal:
    against its plain version (1e-5), timed beside SDPA and the bound."""
    shape = (3 * JASCO_SAMPLES, JASCO_SECONDS * 50, 8, 64)
    B, T, H, D = shape
    gen = torch.Generator().manual_seed(162)
    q, k, v = (torch.randn(shape, generator=gen).to(device) for _ in range(3))
    err = float((fused_attention(q, k, v, causal=False)
                 - fused_attention_reference(q, k, v, causal=False)).abs().max())
    check(err <= 1e-5, f'attention at the JASCO shape: max-abs {err:.3g} > 1e-5')
    ops = 4.0 * B * H * T * T * D
    b_ms, b_by = bound_ms(ops, PEAK_FP32, 4.0 * 4 * B * T * H * D)
    ms = time_ms(lambda: fused_attention(q, k, v, causal=False), 20)
    plain_ms = time_ms(lambda: fused_attention_reference(q, k, v, causal=False), 5)
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), 20)
    print(f'attention fp32 {shape} not causal (the JASCO U-net): max-abs against plain '
          f'{err:.3g} (<= 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA '
          f'{sdpa_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {ops / ms / 1e9:.1f} TFLOP/s; card '
          f'{card()}', flush=True)


def _generate(model, cond, method: str, seed: int):
    return _sync_s(lambda: model.generate(
        cond, JASCO_CFG, num_samples=JASCO_SAMPLES, max_gen_len=JASCO_SECONDS * 50,
        euler_steps=JASCO_STEPS, method=method, generator=torch.Generator().manual_seed(seed)))


def check_jasco(device, demucs: HTDemucs) -> tp.Dict[str, int]:
    """15c: JASCO from ``get_jasco_model()`` (seeded weights): one vector
    field evaluation on each attention route (1e-5) and against the CPU
    (1e-4); the 100-step Euler generate on each route (1e-3), K3f 8 times an
    evaluation on the kernel route and never on the plain one; a dopri5
    generate with its trial and accepted steps."""
    name = card()
    (model, provider, codec), build_s = _sync_s(lambda: get_jasco_model(seed=163))
    n_layers = len(model.transformer.layers)
    print(f'get_jasco_model(): flow model {sum(p.numel() for p in model.parameters()) / 1e6:.1f}'
          f' M parameters ({n_layers} layers, dim {model.dim}, flow_dim {model.flow_dim}), '
          f'provider {sum(p.numel() for p in provider.parameters()) / 1e6:.1f} M, built in '
          f'{build_s:.1f} s', flush=True)
    cond, drum_launches = _jasco_conditions(device, provider, codec, demucs)
    check_jasco_attention(device)
    gen = torch.Generator().manual_seed(164)
    z = torch.randn(JASCO_SAMPLES, JASCO_SECONDS * 50, model.flow_dim, generator=gen).to(device)
    t = torch.tensor(0.37, device=device)

    def vf():
        return model.estimated_vector_field(z, t, cond, JASCO_CFG)

    with torch.no_grad():
        fused_attention.launches = 0
        routed = vf()
        check(fused_attention.launches == n_layers,
              f'one evaluation launched K3f {fused_attention.launches} times, not {n_layers}')
        routed_ms = time_ms(vf, 10)
        set_attn_kernel(model, False)
        fused_attention.launches = 0
        plain = vf()
        plain_ms = time_ms(vf, 10)
        check(fused_attention.launches == 0, 'the plain route launched K3f')
        set_attn_kernel(model, 'auto')
        err = _rel_err(routed, plain)
        check(err <= 1e-5, f'JASCO vector field kernel vs plain route {err:.3g} > 1e-5')
        cpu = copy.deepcopy(model).cpu()
        on_cpu = cpu.estimated_vector_field(z.cpu(), t.cpu(), {
            k: (a.cpu(), b.cpu()) for k, (a, b) in cond.items()}, JASCO_CFG)
        cpu_err = _rel_err(routed, on_cpu)
        del cpu
    check(cpu_err <= 1e-4, f'JASCO vector field card vs CPU {cpu_err:.3g} > 1e-4')
    print(f'JASCO vector field [{3 * JASCO_SAMPLES}, {JASCO_SECONDS * 50}, {model.dim}] with 3 '
          f'CFG terms {JASCO_CFG}: kernel route {routed_ms:.3f} ms, plain route '
          f'{plain_ms:.3f} ms; max-abs / max kernel vs plain {err:.3g} (<= 1e-5), card vs CPU '
          f'{cpu_err:.3g} (<= 1e-4); card {name}', flush=True)

    fused_attention.launches = fused_attention.fp32_launches = 0
    euler, euler_s = _generate(model, cond, 'euler', seed=165)
    euler_launches, euler_fp32 = fused_attention.launches, fused_attention.fp32_launches
    check(euler_launches == n_layers * JASCO_STEPS,
          f'the Euler generate launched K3f {euler_launches} times')
    set_attn_kernel(model, False)
    euler_plain, plain_s = _generate(model, cond, 'euler', seed=165)
    set_attn_kernel(model, 'auto')
    check(fused_attention.launches == euler_launches, 'the plain generate launched K3f')
    gen_err = _rel_err(euler, euler_plain)
    check(gen_err <= 1e-3, f'JASCO Euler latents kernel vs plain route {gen_err:.3g} > 1e-3')
    check(tuple(euler.shape) == (JASCO_SAMPLES, JASCO_SECONDS * 50, model.flow_dim)
          and bool(torch.isfinite(euler).all()), f'Euler latents {tuple(euler.shape)}')
    fused_attention.launches = 0
    dopri, dopri_s = _generate(model, cond, 'dopri5', seed=165)
    stats = dict(model.ode_stats)
    check(bool(torch.isfinite(dopri).all()), 'dopri5 latents are not finite')
    check(fused_attention.launches == n_layers * stats['evals'],
          f'dopri5 launched K3f {fused_attention.launches} times for {stats["evals"]} evaluations')
    print(f'JASCO Euler {JASCO_STEPS} steps -> latents {tuple(euler.shape)}: kernel route '
          f'{euler_s:.3f} s ({euler_s / JASCO_STEPS * 1e3:.2f} ms a step, '
          f'{JASCO_SAMPLES * JASCO_SECONDS / euler_s:.1f} audio-s/s), K3f launches '
          f'{euler_launches}; plain route {plain_s:.3f} s; max-abs / max kernel vs plain '
          f'{gen_err:.3g} (<= 1e-3); card {name}', flush=True)
    print(f'JASCO dopri5 (atol = rtol = 1e-5): {dopri_s:.3f} s, {stats["trials"]} trial steps, '
          f'{stats["accepted"]} accepted, {stats["evals"]} evaluations, {stats["host_reads"]} '
          f'host reads, K3f launches {fused_attention.launches}; max-abs / max against the '
          f'Euler latents {_rel_err(dopri, euler):.3g} (information); card {name}', flush=True)
    return {**{k: drum_launches[k] for k in ('rvq_encode', 'lstm_step', 'fused_stage',
                                            'banded_mono_conv', 'fused_stage_fp32')},
            'flash_attention': euler_launches, 'flash_attention_fp32': euler_fp32}


def _seeded_joint_embed(x: JointEmbedCondition) -> tp.Tuple[np.ndarray, tp.List[int]]:
    """Stands in for CLAP (``transformers`` is not on this machine):
    L2-normalised seeded rows, the empty rows' indices."""
    rows = np.stack([np.random.RandomState(int(abs(w).sum() * 1e3) % 2 ** 31).randn(JE_DIM)
                     for w in np.asarray(x.wav)]).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True), \
        [i for i, n in enumerate(x.length) if n <= 1]


def check_joint_embed(device) -> int:
    """15d: ``JointEmbeddingConditioner(dim=512, output_dim=1536)`` on 8 rows:
    its RVQ eval forward launches K1 once (N = 8, D = 512, K = 1024, n_q =
    12), whose codes equal the plain version's; K1 there timed."""
    je = JointEmbeddingConditioner(JE_DIM, JE_OUT, embed_fn=_seeded_joint_embed,
                                   generator=torch.Generator().manual_seed(170)).to(device)
    wav = np.random.RandomState(171).randn(JE_ROWS, 1, 48000).astype(np.float32)
    length = np.array([48000] * (JE_ROWS - 1) + [1])
    x = JointEmbedCondition(wav, ['a'] * JE_ROWS, length, [48000] * JE_ROWS, [None] * JE_ROWS,
                            [None] * JE_ROWS)
    tokens = je.tokenize(x)
    rvq_encode.launches = 0
    with torch.no_grad():
        out, mask = je(tokens)
    launches = rvq_encode.launches
    check(launches == 1, f'the joint embedding launched K1 {launches} times')
    check(tuple(out.shape) == (JE_ROWS, 1, JE_OUT) and float(out[-1].abs().max()) == 0
          and float(mask[-1]) == 0, 'the joint embedding did not mask its empty row')
    flat = torch.from_numpy(tokens[0]).to(device)
    embeds = je.rvq.embeds().contiguous()
    codes, plain = rvq_encode(flat, embeds), rvq_encode_reference(flat, embeds)
    check(torch.equal(codes, plain), 'K1 at the joint embedding: codes differ from plain')
    n, d = flat.shape
    q, k, _ = embeds.shape
    b_ms, b_by = bound_ms(2.0 * n * d * k * q, PEAK_FP32, 4.0 * (n * d + q * k * d + q * n))
    print(f'joint embedding [{JE_ROWS}, {JE_DIM}] -> {tuple(out.shape)}: K1 N={n} D={d} K={k} '
          f'n_q={q} codes equal to plain; kernel {time_ms(lambda: rvq_encode(flat, embeds), 20):.4f}'
          f' ms, plain {time_ms(lambda: rvq_encode_reference(flat, embeds), 20):.4f} ms, bound '
          f'{b_ms:.4f} ms ({b_by}); card {card()}', flush=True)
    return launches


def phase_demucs_jasco(device) -> tp.Dict[str, int]:
    print("== phase 15: HTDemucs, MusicGen-melody's chroma behind the stems, get_jasco_model() "
          'with Demucs drums, the joint embedding', flush=True)
    start = time.perf_counter()
    demucs = check_demucs(device)
    print(f'-- 15a {time.perf_counter() - start:.1f} s', flush=True)
    check_melody_stems(device, demucs)
    launches = check_jasco(device, demucs)
    print(f'-- 15c {time.perf_counter() - start:.1f} s', flush=True)
    launches['rvq_encode (joint embedding)'] = check_joint_embed(device)
    del demucs
    torch.cuda.empty_cache()
    print(f'phase 15: {time.perf_counter() - start:.1f} s; launches {launches}', flush=True)
    return launches


# phase 16: one 120 s file tokenized by pod; MusicGen-large over a model group;
# the stand-in MultiBand-Diffusion decode (4 bands, 20 UNet calls each) of 4 x
# 10 s; codec-FAD and codec-KLD of 8 + 8 clips of 10 s; MusicGen-small widths
# with rope and kv_repeat 2, 2 x 10 s decoded (fp32 against the CPU at 2 s)
POD_SECONDS = 120
TP_BATCH, TP_SECONDS = 2, 10
MBD_BATCH, MBD_SECONDS, MBD_BANDS = 4, 10, 4
METRIC_CLIPS, METRIC_SECONDS, METRIC_WINDOW = 8, 10, 0.2
ROPE_BATCH, ROPE_SECONDS, ROPE_PARITY_SECONDS, ROPE_STEP_OFFSET = 2, 10, 2, 250


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def check_pod(device, group) -> tp.Dict[str, int]:
    """16a: one 120 s file through ``pod_encode`` / ``pod_decode`` on the
    group, ``get_encodec_32khz()`` at its widths: in fp32 (cuDNN's TF32
    off) the codes equal the module stack's ``encode`` of the padded signal
    but at near-ties of its distances (1e-4 relative), the waveform within
    1e-5 of ``decode``; in bf16 timed beside the plain encode and decode,
    with K2's and K1's launches counted."""
    model = get_encodec_32khz()
    wav = _clips(1, POD_SECONDS * SAMPLE_RATE, device, seed=160)
    seed_codebooks(model, wav)
    f32 = torch.float32
    with torch.no_grad():
        codes = pod_encode(model, wav, group, compute_dtype=f32)
        lat = model.encoder(wav, lstm_kernel=True).float()
        ref = model.quantizer.encode(lat)
    rows = lat[0].t()
    differ = (codes != ref)[0].any(0)
    near = _near_ties(rows, model.quantizer.embeds(), ref[0], rel=1e-4)
    print(f'pod_encode fp32 of 1 x {POD_SECONDS} s ({wav.shape[-1]} samples, {codes.shape[-1]} '
          f'frames) on a world-size-{world_size(group)} NCCL group against encode(fused=False): '
          f'{int(differ.sum())} frames with another code, all at near-ties: '
          f'{bool((near | ~differ).all())}', flush=True)
    check(bool((near | ~differ).all()), f'pod codes differ away from a near-tie at '
                                        f'{int((differ & ~near).sum())} frames')
    wav_pod = pod_decode(model, ref, group, compute_dtype=f32)
    wav_ref = model.decode(ref, compute_dtype=f32)
    err = float((wav_pod - wav_ref).abs().max())
    print(f'pod_decode fp32 against decode: max-abs {err:.3g} (<= 1e-5)', flush=True)
    check(err <= 1e-5, f'pod_decode: max-abs {err:.3g} > 1e-5')
    del lat, rows, wav_pod, wav_ref
    _reset_launch_counts()
    codes = pod_encode(model, wav, group)
    pod_audio = pod_decode(model, codes, group)
    launches = _launch_counts()
    check(launches['lstm_step'] == 4 and launches['rvq_encode'] == 1,
          f'pod encode and decode launched {launches} (K2 2 + 2, K1 1 expected)')
    check(bool(torch.isfinite(pod_audio).all()), 'pod_decode: non-finite audio')
    torch.cuda.reset_peak_memory_stats()
    times = {name: time_ms(fn, 2) for name, fn in (
        ('pod_encode', lambda: pod_encode(model, wav, group)),
        ('encode (default route)', lambda: model.encode(wav)),
        ('pod_decode', lambda: pod_decode(model, codes, group)),
        ('decode', lambda: model.decode(codes)))}
    print(f'pod bf16, 1 x {POD_SECONDS} s on {world_size(group)} rank(s): '
          + ', '.join(f'{k} {v:.1f} ms' for k, v in times.items())
          + f'; launches in one pod encode + decode: K2 {launches["lstm_step"]}, K1 '
          f'{launches["rvq_encode"]}; peak memory {_peak_gib():.2f} GiB; card {card()}',
          flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def check_tensor_parallel(device, group) -> tp.Dict[str, int]:
    """16b: ``get_musicgen_lm('large')`` in bf16, 2 x 10 s of codes with T5
    conditions: ``shard_lm`` over the model group gives the unsharded
    forward's logits bit for bit; the forward timed, K3f's launches
    counted."""
    lm, provider = get_musicgen_lm('large', seed=2)
    check(len(lm.transformer.layers) == 48 and lm.dim == 2048
          and lm.transformer.num_heads == 32, 'not the large widths')
    n_params = sum(p.numel() for p in lm.parameters())
    cond = _train_conditions(provider, TP_BATCH, device, seed=161)
    del provider
    lm.to(torch.bfloat16)
    cond = {k: (t.to(torch.bfloat16), m) for k, (t, m) in cond.items()}
    gen = torch.Generator().manual_seed(162)
    seq = torch.randint(0, lm.card, (TP_BATCH, lm.n_q, TP_SECONDS * 50), generator=gen).to(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ref = lm(seq, cond)
        plain_ms = time_ms(lambda: lm(seq, cond), 3)
        shard_lm(lm, group)
        _reset_launch_counts()
        logits = lm(seq, cond)
        launches = _launch_counts()
        ms = time_ms(lambda: lm(seq, cond), 3)
        # what one of the forward's 96 all-reduces costs on this group, and
        # the device's busy time over a sharded forward
        y = torch.zeros(TP_BATCH, TP_SECONDS * 50, lm.dim, dtype=torch.bfloat16, device=device)
        reduce_ms = time_ms(lambda: global_sum(y, group), 20)
        busy, window, kernels = _cuda_busy_ms(lambda: lm(seq, cond))
    same = torch.equal(logits, ref)
    print(f'MusicGen-large ({n_params / 1e9:.2f} B parameters, bf16) sharded over a '
          f'world-size-{world_size(group)} NCCL model group, {TP_BATCH} x {TP_SECONDS} s: logits '
          f'{tuple(logits.shape)} bit-equal to the unsharded forward {same}; forward {ms:.1f} ms '
          f'(unsharded {plain_ms:.1f} ms); one all-reduce of {tuple(y.shape)} bf16 '
          f'{reduce_ms:.3f} ms (96 a forward, after each out_proj and linear2); K3f launches '
          f'{launches["flash_attention"]}; peak memory {_peak_gib():.2f} GiB; card {card()}',
          flush=True)
    print(f'a sharded forward under the profiler: device busy {busy:.1f} of {window:.1f} ms '
          f'(CUDA events); top kernels (ms, calls): '
          + '; '.join(f'{e.key[:50]} {e.self_device_time_total / 1e3:.2f} {e.count}'
                      for e in kernels[:6]), flush=True)
    check(same, 'the sharded logits differ from the unsharded forward')
    check(launches['flash_attention'] == 48, f'the sharded forward launched {launches}')
    del lm, ref, logits
    torch.cuda.empty_cache()
    return launches


def _blstm_plain(bilstm, z: torch.Tensor) -> torch.Tensor:
    """The BLSTM of ``nn/diffusion.py`` with each direction on K2's plain
    version (``lstm_layer_reference``) on the same tensors."""
    C = z.shape[1]
    y = z.permute(2, 0, 1)
    for i, p in enumerate(bilstm.layers):
        fwd = lstm_layer_reference(y, *[p[n] for n in bilstm.NAMES[:4]])
        bwd = lstm_layer_reference(y.flip(0), *[p[n] for n in bilstm.NAMES[4:]]).flip(0)
        y = torch.cat([fwd, bwd], dim=-1)
        if i < len(bilstm.layers) - 1:
            y = y[..., :C] + y[..., C:]
    return bilstm.linear(y).permute(1, 2, 0)


def _stand_in_unets(n_bands: int, device, seed: int, **overrides) -> tp.List[DiffusionUnet]:
    """One ``DiffusionUnet`` a band at the stand-in widths (no published
    MultiBand-Diffusion configuration is in the repository): 48 hidden
    channels, depth 4, kernel 8, stride 4, growth 2, 4 norm groups, every
    layer's timestep embedding, a transformer bottleneck of 384 channels at
    T / 256, the 32 kHz codec's 128-d latent as the condition; fp32."""
    gen = torch.Generator().manual_seed(seed)
    cfg = dict(chin=1, hidden=48, depth=4, kernel=8, stride=4, growth=2.0, norm_groups=4,
               res_blocks=1, emb_all_layers=True, codec_dim=128, use_transformer=True)
    cfg.update(overrides)
    return [DiffusionUnet(**cfg, generator=gen).to(device).eval().requires_grad_(False)
            for _ in range(n_bands)]


def check_diffusion(device, codec) -> tp.Dict[str, int]:
    """16c: the stand-in MultiBand-Diffusion widths (``_stand_in_unets``)
    conditioned on the 32 kHz codec's latent of 4 x 10 s of codes, fp32: one
    UNet forward at 1 s on the card against the CPU (1e-4 relative); the
    BLSTM variant's K2 (fp32, H = 384, T = 1250, B = 4) against its plain
    version (1e-4, phase 2's fp32 bar); the 4-band reverse process timed."""
    unets = _stand_in_unets(MBD_BANDS, device, seed=163)
    processor = MultiBandProcessor(n_bands=MBD_BANDS, sample_rate=SAMPLE_RATE).to(device)
    schedules = [NoiseSchedule() for _ in range(MBD_BANDS)]
    gen = torch.Generator().manual_seed(164)
    frames = MBD_SECONDS * 50
    codes = torch.randint(0, codec.cardinality, (MBD_BATCH, codec.num_codebooks, frames),
                          generator=gen).to(device)
    cond = codec.decode_latent(codes)                                 # [4, 128, 500]
    # the processor's band statistics from the codec's own audio of the codes
    processor.project_sample(codec.decode(codes),
                             generator=torch.Generator(device=device).manual_seed(168))
    x1 = torch.randn(MBD_BATCH, 1, SAMPLE_RATE, generator=gen).to(device)
    unet = unets[0]
    with torch.no_grad():
        out = unet(x1, 500, condition=cond[..., :50])
        out_cpu = copy.deepcopy(unet).cpu()(x1.cpu(), 500, condition=cond[..., :50].cpu())
    rel = _rel_err(out, out_cpu)
    print(f'DiffusionUnet fp32 at 1 s, card against CPU: max-abs / max {rel:.3g} (<= 1e-4); '
          f'bottleneck {unet.bottleneck_dim} channels', flush=True)
    check(rel <= 1e-4, f'UNet card vs CPU: rel {rel:.3g} > 1e-4')

    blstm = _stand_in_unets(1, device, seed=165, bilstm=True, use_transformer=False)[0]
    z = torch.randn(MBD_BATCH, blstm.bottleneck_dim, frames * 640 // 256, generator=gen).to(device)
    _reset_launch_counts()
    with torch.no_grad():
        y = blstm.bilstm(z)
        launches_blstm = _launch_counts()['lstm_step']
        err = float((y - _blstm_plain(blstm.bilstm, z)).abs().max())
        x_full = torch.randn(MBD_BATCH, 1, MBD_SECONDS * SAMPLE_RATE, generator=gen).to(device)
        blstm_ms = time_ms(lambda: blstm(x_full, 500, condition=cond), 2)
    print(f'BLSTM bottleneck {tuple(z.shape)} fp32: K2 launches {launches_blstm} (2 layers x 2 '
          f'directions), max-abs against the plain LSTM {err:.3g} (<= 1e-4); the BLSTM UNet\'s '
          f'forward at {MBD_BATCH} x {MBD_SECONDS} s {blstm_ms:.1f} ms', flush=True)
    check(launches_blstm == 4, f'the BLSTM launched K2 {launches_blstm} times')
    check(err <= 1e-4, f'BLSTM on K2 against plain: max-abs {err:.3g} > 1e-4')
    del blstm

    noise = torch.randn(MBD_BATCH, 1, MBD_SECONDS * SAMPLE_RATE, generator=gen).to(device)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: unet(noise, 500, condition=cond), 3)
        calls = [0]

        def band_fn(band):
            def fn(x, step, c):
                calls[0] += 1
                return unets[band](x, step, condition=c)
            return fn

        def reverse():
            out = sum(schedules[b].generate_subsampled(
                band_fn(b), noise, condition=cond,
                generator=torch.Generator(device=device).manual_seed(166 + b))
                for b in range(MBD_BANDS))
            return processor.return_sample(out)

        _reset_launch_counts()
        audio, seconds = _sync_s(reverse)
        launches = _launch_counts()
    check(calls[0] == 20 * MBD_BANDS, f'{calls[0]} UNet calls, not {20 * MBD_BANDS}')
    check(bool(torch.isfinite(audio).all()) and audio.shape == noise.shape,
          'the reverse process gave no finite audio of the input shape')
    audio_s = MBD_BATCH * MBD_SECONDS
    print(f'MultiBand-Diffusion stand-in, {MBD_BANDS} bands x 20 UNet calls on {MBD_BATCH} x '
          f'{MBD_SECONDS} s, fp32: one UNet forward {fwd_ms:.1f} ms; reverse process '
          f'{seconds:.2f} s, {audio_s / seconds:.1f} audio-s/s; peak memory {_peak_gib():.2f} '
          f'GiB; card {card()}', flush=True)
    del unets, processor
    torch.cuda.empty_cache()
    launches['lstm_step'] += launches_blstm
    return launches


def _fad(embed_fn, ref: np.ndarray, gen: np.ndarray) -> float:
    fad = FrechetAudioDistance(embed_fn, SAMPLE_RATE)
    fad.add(reference=ref, generated=gen)
    return fad.compute()


def check_metrics(device) -> tp.Dict[str, int]:
    """16d: codec-FAD and codec-KLD between two sets of 8 x 10 s clips on the
    32 kHz codec (windows of 0.2 s: 400 embeddings of 256 dims a set, a
    full-rank covariance): fp32 FAD and ``chroma_cosine`` on the card against
    the CPU within 1e-4 relative; the prob fn's codes equal the CPU's but at
    near-ties, the KLD printed on both; the bf16 embed fn timed."""
    gpu = get_encodec_32khz(compute_dtype=None)
    cpu = get_encodec_32khz(compute_dtype=None, device='cpu')
    seed_codebooks(gpu, _clips(8, SECONDS * SAMPLE_RATE, device, seed=170))
    cpu.load_state_dict(gpu.state_dict())
    samples = METRIC_SECONDS * SAMPLE_RATE
    ref = _clips(METRIC_CLIPS, samples, 'cpu', seed=171).numpy()
    gen = _clips(METRIC_CLIPS, samples, 'cpu', seed=172).numpy()
    _reset_launch_counts()
    fad = _fad(make_codec_embed_fn(gpu, METRIC_WINDOW), ref, gen)
    prob = make_codec_prob_fn(gpu)
    kld = kl_divergence_metric(prob(ref, SAMPLE_RATE), prob(gen, SAMPLE_RATE))['kld']
    launches = _launch_counts()
    t0 = time.perf_counter()
    fad_cpu = _fad(make_codec_embed_fn(cpu, METRIC_WINDOW), ref, gen)
    prob_cpu = make_codec_prob_fn(cpu)
    kld_cpu = kl_divergence_metric(prob_cpu(ref, SAMPLE_RATE), prob_cpu(gen, SAMPLE_RATE))['kld']
    cpu_s = time.perf_counter() - t0
    rel_fad = abs(fad - fad_cpu) / abs(fad_cpu)
    x = torch.from_numpy(ref[:2]).to(device)
    with torch.no_grad():
        _fp32_codes_vs_cpu('the prob fn\'s encode (2 of the clips)', gpu.encode_to_latent(x),
                           cpu.encode_to_latent(x.cpu()), gpu, cpu)
    chroma = chroma_cosine(ref, gen, SAMPLE_RATE, device=device)
    chroma_cpu = chroma_cosine(ref, gen, SAMPLE_RATE, device='cpu')
    rel_chroma = abs(chroma - chroma_cpu) / abs(chroma_cpu)
    print(f'codec-FAD fp32 of {METRIC_CLIPS} + {METRIC_CLIPS} clips x {METRIC_SECONDS} s: card '
          f'{fad:.6f}, CPU {fad_cpu:.6f} (rel {rel_fad:.3g} <= 1e-4; {cpu_s:.1f} s on the CPU); '
          f'codec-KLD card {kld:.6f}, CPU {kld_cpu:.6f}; chroma_cosine card {chroma:.6f}, CPU '
          f'{chroma_cpu:.6f} (rel {rel_chroma:.3g} <= 1e-4)', flush=True)
    check(rel_fad <= 1e-4, f'FAD card vs CPU: rel {rel_fad:.3g} > 1e-4')
    check(rel_chroma <= 1e-4, f'chroma_cosine card vs CPU: rel {rel_chroma:.3g} > 1e-4')
    check(launches['rvq_encode'] == 2 and launches['lstm_step'] == 8,
          f'the metrics launched {launches} (K1 2, K2 8 expected)')
    del cpu
    bf16 = get_encodec_32khz()
    bf16.load_state_dict(gpu.state_dict())
    embed = make_codec_embed_fn(bf16, METRIC_WINDOW)
    embed_ms = time_ms(lambda: embed(ref, SAMPLE_RATE), 3)
    print(f'codec embed fn bf16 on {METRIC_CLIPS} x {METRIC_SECONDS} s (host array in, host '
          f'array out): {embed_ms:.1f} ms; card {card()}', flush=True)
    del gpu, bf16
    torch.cuda.empty_cache()
    return launches


def check_rope(device) -> tp.Dict[str, int]:
    """16e: MusicGen-small's widths with ``positional_embedding='rope'`` and
    ``kv_repeat=2``: an fp32 forward over 2 x 10 s of codes on K3f (k and v
    repeated to the q heads) against the plain route (1e-4 relative, phase
    6's bar); 2 x 10 s generated in
    bf16 with the replayed CUDA-graph step, the step beside its byte bound;
    fp32 greedy tokens at 2 s on the first ``MG_PARITY_LAYERS`` layers equal
    the CPU's but at near-ties.  No published
    size uses rope or ``kv_repeat``: the LM is ``get_musicgen_lm('small')``'s
    with those two set."""
    small, provider = get_musicgen_lm('small', seed=3)
    lm = LMModel(small.fuser, n_q=4, card=2048, dim=small.dim,
                 num_heads=small.transformer.num_heads, num_layers=len(small.transformer.layers),
                 hidden_scale=4, norm_first=True, bias_proj=False, bias_ff=False,
                 bias_attn=False, cross_attention=True, causal=True, activation='gelu',
                 weight_init='gaussian', attn_kernel='auto', positional_embedding='rope',
                 kv_repeat=2, pattern_provider=DelayedPatternProvider(4),
                 generator=torch.Generator().manual_seed(3))
    lm = lm.to(device).eval().requires_grad_(False)
    del small
    attn = lm.transformer.layers[0].self_attn
    check(attn.num_kv_heads == 8 and attn.in_proj_weight.shape == (2048, 1024),
          'not the kv_repeat=2 projection')
    cond = _descriptions(ROPE_BATCH, device, seed=180)
    with torch.no_grad():
        cond_t = provider(cond)
    gen = torch.Generator().manual_seed(181)
    seq = torch.randint(0, lm.card, (ROPE_BATCH, lm.n_q, ROPE_SECONDS * 50),
                        generator=gen).to(device)
    cond_rows = {k: (t[:ROPE_BATCH], m[:ROPE_BATCH]) for k, (t, m) in cond_t.items()}
    with torch.no_grad():
        _reset_launch_counts()
        logits = lm(seq, cond_rows)
        launches = _launch_counts()
        set_attn_kernel(lm, False)
        plain = lm(seq, cond_rows)
        set_attn_kernel(lm, 'auto')
    rel = _rel_err(logits, plain)
    print(f'rope + kv_repeat 2 forward fp32 [{ROPE_BATCH}, 4, {ROPE_SECONDS * 50}]: K3f launches '
          f'{launches["flash_attention"]}, logits against the plain route max-abs / max '
          f'{rel:.3g} (<= 1e-4)', flush=True)
    check(launches['flash_attention'] == 24, f'the rope forward launched {launches}')
    check(rel <= 1e-4, f'rope forward K3f vs plain: rel {rel:.3g} > 1e-4')
    del logits, plain
    cache, states = DecodeCache(), []
    frames = ROPE_SECONDS * 50
    tokens, gen_s = _sync_s(lambda: _musicgen_generate(lm, cond_t, frames, 182, cache,
                                                       states=states,
                                                       compute_dtype=torch.bfloat16))
    state = states[0]
    check(bool(state.graphs) and tokens.shape == (ROPE_BATCH, 4, frames)
          and bool(((tokens >= 0) & (tokens < lm.card)).all()), 'the rope generate failed')
    step_ms = replay_ms(state, ROPE_STEP_OFFSET)
    weight_bytes, cross_bytes, kv_read, bound = step_bound(state.lm, state)
    print(f'rope + kv_repeat 2 generate bf16, {ROPE_BATCH} x {ROPE_SECONDS} s with CFG through '
          f'replayed CUDA graphs: {gen_s:.2f} s; step at offset {ROPE_STEP_OFFSET} '
          f'{step_ms:.3f} ms against its byte bound {bound:.3f} ms (weights '
          f'{weight_bytes / 1e9:.3f} GB + cross K/V {cross_bytes / 1e9:.3f} GB + KV read '
          f'{kv_read / 1e9:.3f} GB of {state.current[0].k.shape[2]} kv heads); card {card()}',
          flush=True)
    del cache, states, state
    parity, cut = ROPE_PARITY_SECONDS * 50, _first_layers(lm, MG_PARITY_LAYERS)
    states = []
    greedy = _musicgen_generate(cut, cond_t, parity, None, DecodeCache(), states=states)
    print(f'rope + kv_repeat 2 fp32 greedy tokens at {ROPE_PARITY_SECONDS} s on the first '
          f'{MG_PARITY_LAYERS} of the 24 layers:', flush=True)
    check_greedy_against_cpu(cut, cond_t, parity, ROPE_BATCH, greedy, states[0].seq)
    del cut
    del lm, provider, states
    torch.cuda.empty_cache()
    return launches


def phase_pod_tp_diffusion(device) -> tp.Dict[str, tp.Dict[str, int]]:
    print('== phase 16: pod tokenization, MusicGen-large over a model group, the '
          'MultiBand-Diffusion stand-in, the generation metrics, rope and kv_repeat', flush=True)
    start = time.perf_counter()
    data_group, model_group = make_mesh(1, 1, 'nccl', f'tcp://127.0.0.1:{_free_port()}', 1, 0)
    launches = {}
    for key, fn in (('pod', lambda: check_pod(device, data_group)),
                    ('tp', lambda: check_tensor_parallel(device, model_group)),
                    ('diffusion', lambda: check_diffusion(device, _seeded_codec(device))),
                    ('metrics', lambda: check_metrics(device)),
                    ('rope', lambda: check_rope(device))):
        launches[key] = fn()
        print(f'-- 16 {key}: {time.perf_counter() - start:.1f} s', flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f'phase 16: {time.perf_counter() - start:.1f} s; launches {launches}', flush=True)
    return launches


# ------------------------------------------------- phase 17: checkpoints

CKPT_ENCODE, CKPT_GEN, CKPT_HF_STEPS, CKPT_HF_GEN = (4, 10), (2, 10), 50, (2, 5)


def encodec_32khz_xp_cfg() -> dict:
    """The ``xp.cfg`` of a facebook/encodec_32khz export, as a plain dict
    (reference builders.py:56-91 schema, the published values)."""
    return {
        'compression_model': 'encodec', 'device': 'cuda', 'dtype': 'float32',
        'encodec': {'autoencoder': 'seanet', 'quantizer': 'rvq', 'sample_rate': 32000,
                    'channels': 1, 'causal': False, 'renormalize': False},
        'seanet': {'dimension': 128, 'channels': 1, 'causal': False, 'n_filters': 64,
                   'n_residual_layers': 1, 'ratios': [8, 5, 4, 4], 'activation': 'ELU',
                   'activation_params': {'alpha': 1.0}, 'norm': 'weight_norm',
                   'norm_params': {}, 'kernel_size': 7, 'residual_kernel_size': 3,
                   'last_kernel_size': 7, 'dilation_base': 2, 'pad_mode': 'reflect',
                   'true_skip': True, 'compress': 2, 'lstm': 2, 'disable_norm_outer_blocks': 0,
                   'encoder': {}, 'decoder': {'trim_right_ratio': 1.0, 'final_activation': None,
                                              'final_activation_params': None}},
        'rvq': {'n_q': 4, 'q_dropout': False, 'bins': 2048, 'decay': 0.99, 'kmeans_init': True,
                'kmeans_iters': 10, 'threshold_ema_dead_code': 2.0,
                'orthogonal_reg_weight': 0.0, 'orthogonal_reg_active_codes_only': False,
                'orthogonal_reg_max_codes': None},
    }


def musicgen_small_xp_cfg() -> dict:
    """The ``xp.cfg`` of a facebook/musicgen-small LM export (reference
    builders.py:136-254 schema, config/model/lm/musicgen_lm.yaml's fields,
    the small solver's values)."""
    return {
        'lm_model': 'transformer_lm', 'device': 'cuda', 'dtype': 'float16',
        'transformer_lm': {
            'dim': 1024, 'num_heads': 16, 'num_layers': 24, 'hidden_scale': 4, 'n_q': 4,
            'card': 2048, 'dropout': 0.0, 'emb_lr': None, 'activation': 'gelu',
            'norm_first': True, 'bias_ff': False, 'bias_attn': False, 'bias_proj': False,
            'past_context': None, 'causal': True, 'custom': False, 'memory_efficient': True,
            'attention_as_float32': False, 'positional_embedding': 'sin', 'xpos': False,
            'checkpointing': 'none', 'weight_init': 'gaussian', 'depthwise_init': 'current',
            'zero_bias_init': True, 'norm': 'layer_norm', 'cross_attention': False,
            'qk_layer_norm': False, 'qk_layer_norm_cross': False, 'attention_dropout': None,
            'kv_repeat': 1, 'two_step_cfg': False, 'q_modeling': None},
        'codebooks_pattern': {'modeling': 'delay', 'delay': {'delays': [0, 1, 2, 3],
                                                             'flatten_first': 0,
                                                             'empty_initial': 0}},
        'conditioners': {'args': {'merge_text_conditions_p': 0.25, 'drop_desc_p': 0.5},
                         'description': {'model': 't5', 't5': {'name': 't5-base',
                                                               'finetune': False,
                                                               'word_dropout': 0.3,
                                                               'normalize_text': False}}},
        'fuser': {'cross_attention_pos_emb': False, 'cross_attention_pos_emb_scale': 1.0,
                  'sum': [], 'prepend': [], 'cross': ['description'], 'input_interpolate': []},
        'classifier_free_guidance': {'training_dropout': 0.3, 'inference_coef': 3.0},
        'attribute_dropout': {'args': {'active_on_eval': False}, 'text': {},
                              'wav': {'self_wav': 1.0}},
        'dataset': {'segment_duration': 30},
    }


def musicgen_small_hf_config() -> dict:
    """facebook/musicgen-small's ``config.json`` (MusicgenForConditionalGeneration):
    the published values of its decoder, its t5-base text encoder and its
    32 kHz audio encoder."""
    return {
        'architectures': ['MusicgenForConditionalGeneration'], 'model_type': 'musicgen',
        'decoder': {'activation_function': 'gelu', 'audio_channels': 1, 'ffn_dim': 4096,
                    'hidden_size': 1024, 'num_attention_heads': 16, 'num_codebooks': 4,
                    'num_hidden_layers': 24, 'vocab_size': 2048, 'max_position_embeddings': 2048,
                    'model_type': 'musicgen_decoder'},
        'text_encoder': {'_name_or_path': 't5-base', 'd_ff': 3072, 'd_kv': 64, 'd_model': 768,
                         'feed_forward_proj': 'relu', 'num_heads': 12, 'num_layers': 12,
                         'relative_attention_max_distance': 128,
                         'relative_attention_num_buckets': 32, 'vocab_size': 32128,
                         'model_type': 't5'},
        'audio_encoder': {'audio_channels': 1, 'codebook_dim': 128, 'codebook_size': 2048,
                          'compress': 2, 'dilation_growth_rate': 2, 'hidden_size': 128,
                          'kernel_size': 7, 'last_kernel_size': 7, 'norm_type': 'weight_norm',
                          'normalize': False, 'num_filters': 64, 'num_lstm_layers': 2,
                          'num_residual_layers': 1, 'pad_mode': 'reflect',
                          'residual_kernel_size': 3, 'sampling_rate': 32000,
                          'target_bandwidths': [2.2], 'trim_right_ratio': 1.0,
                          'upsampling_ratios': [8, 5, 4, 4], 'use_causal_conv': False,
                          'use_conv_shortcut': False, 'model_type': 'encodec'},
    }


def weight_norm_export(state: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, torch.Tensor]:
    """A codec state dict with every SEANet conv weight stored as weight
    norm keeps it (``weight_g``, ``weight_v``), as the published EnCodec
    exports do: v the weight, g its fp32 norm over all axes but the first."""
    out = {}
    for key, w in state.items():
        w = w.detach().cpu()
        if key.endswith(('conv.conv.weight', 'convtr.convtr.weight')):
            base = key[:-len('weight')]
            v = w.float().numpy()
            g = np.sqrt(np.sum(np.square(v), axis=tuple(range(1, v.ndim)), keepdims=True))
            out[base + 'weight_g'], out[base + 'weight_v'] = torch.from_numpy(g), w.float()
        else:
            out[key] = w
    return out


def _hf_codec_name(key: str) -> str:
    for ours, theirs in (('encoder.model.', 'encoder.layers.'), ('decoder.model.', 'decoder.layers.'),
                         ('.conv.conv.', '.conv.'), ('.convtr.convtr.', '.conv.'),
                         ('quantizer.vq.layers.', 'quantizer.layers.'),
                         ('._codebook.', '.codebook.')):
        key = key.replace(ours, theirs)
    return key


_HF_LAYER_NAMES = (('norm1.', 'self_attn_layer_norm.'), ('norm2.', 'final_layer_norm.'),
                   ('norm_cross.', 'encoder_attn_layer_norm.'), ('linear1.', 'fc1.'),
                   ('linear2.', 'fc2.'), ('cross_attention.', 'encoder_attn.'))


def hf_snapshot_state(codec, lm, provider) -> tp.Dict[str, torch.Tensor]:
    """The port's modules under ``MusicgenForConditionalGeneration``'s
    names: the inverse of ``ckpt/hf_import`` and of the HF codec import
    (``codec/wrappers.py``), which the package does not ship (the JAX
    package has no exporter either)."""
    out: tp.Dict[str, torch.Tensor] = {}
    dec = 'decoder.model.decoder.'
    for key, value in lm.state_dict().items():
        head, _, rest = key.partition('.')
        if head == 'emb':
            out[f'{dec}embed_tokens.{rest}'] = value
        elif head == 'linears':
            out[f'decoder.lm_heads.{rest}'] = value
        elif head == 'out_norm':
            out[f'{dec}layer_norm.{rest}'] = value
        else:
            name = key[len('transformer.'):]
            for ours, theirs in _HF_LAYER_NAMES:
                name = name.replace(ours, theirs)
            if name.endswith('in_proj_weight'):
                for part, chunk in zip('qkv', value.chunk(3)):
                    out[f'{dec}{name[:-len("in_proj_weight")]}{part}_proj.weight'] = chunk
            else:
                out[dec + name] = value
    cond = 'conditioners.description.'
    for key, value in provider.state_dict().items():
        if key.startswith(cond + 't5.'):
            out['text_encoder.' + key[len(cond + 't5.'):]] = value
        elif key.startswith(cond + 'output_proj.'):
            out['enc_to_dec_proj.' + key[len(cond + 'output_proj.'):]] = value
    for key, value in codec.state_dict().items():
        out['audio_encoder.' + _hf_codec_name(key)] = value
    return {k: v.detach().cpu().contiguous() for k, v in out.items()}


def write_safetensors(path, tensors: tp.Mapping[str, torch.Tensor]) -> None:
    """A ``.safetensors`` file of fp32 tensors: the 8-byte little-endian
    header length, the JSON header (dtype, shape, byte offsets), the raw
    buffers."""
    import struct
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        blob = t.float().numpy().tobytes()
        header[name] = {'dtype': 'F32', 'shape': list(t.shape),
                        'data_offsets': [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b' ' * (-len(head) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def _gb(path) -> float:
    from pathlib import Path
    return sum(f.stat().st_size for f in Path(path).rglob('state.npz')) / 1e9


def _states_equal(ours: torch.nn.Module, theirs: torch.nn.Module, what: str,
                  folded: tp.Sequence[str] = ()) -> None:
    """``ours`` holds ``theirs``'s state: bit for bit, or, for the weights
    under a weight-norm fold, within one fp32 ulp relative elementwise."""
    mine = ours.state_dict()
    for key, value in theirs.state_dict().items():
        got = mine[key]
        if key.endswith(tuple(folded)):
            rel = float(((got.float() - value.float()).abs()
                         / value.float().abs().clamp_min(1e-30)).max())
            check(rel <= 2 ** -23, f'{what} {key}: the folded weight is {rel:.3g} relative from '
                                   'the written one (> 1 ulp)')
        else:
            check(torch.equal(got, value), f'{what} {key}: the loaded state differs')


def _codes_apart_from_near_ties(model, wav, codes) -> int:
    """``codes`` against ``model``'s fp32 codes of ``wav``: rows that differ
    must be near-ties of ``model``'s distances, 1e-3 relative (the fold
    moves the weights by up to an ulp and the latent by about 1e-6 of its
    largest value; a residual's distances are far smaller than its squared
    norm, so their relative margins move by up to about 1e-4).  Returns the
    differing rows."""
    lat = model.encode_to_latent(wav, compute_dtype='float32')
    ref = model.quantizer.encode(lat)
    x = lat.transpose(1, 2).reshape(-1, lat.shape[1])
    flat = lambda c: c.transpose(0, 1).reshape(c.shape[1], -1)
    near = _near_ties(x, model.quantizer.embeds(), flat(ref), rel=1e-3)
    diff = (flat(codes) != flat(ref)).any(0)
    check(not bool((diff & ~near).any()),
          f'{int((diff & ~near).sum())} rows of the loaded codec\'s codes differ away from a '
          'near-tie')
    return int(diff.sum())


def _greedy(mg, descriptions, seconds: float) -> tp.Tuple[torch.Tensor, float]:
    mg.set_generation_params(use_sampling=False, duration=seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tokens = mg.generate(descriptions, return_tokens=True)
    torch.cuda.synchronize()
    return tokens, time.perf_counter() - t0


def check_reference_export(device, root) -> tp.Tuple[tp.Any, tp.Dict[str, int]]:
    """17a: MusicGen-small and its 32 kHz codec, seeded, written in the
    reference export layout, imported by the CLI, loaded by get_pretrained.
    Returns the original facade and the kernels' launches on the loaded
    facade's path (the import, the load, an encode and a generate)."""
    from audiocraft_tpu_torch.apps import import_checkpoint
    from audiocraft_tpu_torch.ckpt import loaders
    from audiocraft_tpu_torch.config import diff_models

    mg = get_musicgen('small')
    codec, lm, provider = mg.compression_model, mg.lm, mg.condition_provider
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=171))
    t5 = provider.conditioners['description'].t5
    t0 = time.perf_counter()
    torch.save({'xp.cfg': encodec_32khz_xp_cfg(),
                'best_state': weight_norm_export(codec.state_dict())},
               root / 'compression_state_dict.bin')
    lm_state = {k: v.cpu() for k, v in lm.state_dict().items()}
    lm_state.update({f'condition_provider.{k}': v.cpu() for k, v in provider.state_dict().items()
                     if '.t5.' not in k})
    torch.save({'xp.cfg': musicgen_small_xp_cfg(), 'best_state': lm_state},
               root / 'state_dict.bin')
    torch.save({k: v.cpu() for k, v in t5.state_dict().items()}, root / 't5.bin')
    written = time.perf_counter() - t0

    _reset_launch_counts()
    t0 = time.perf_counter()
    import_checkpoint.main(['compression', str(root / 'compression_state_dict.bin'),
                            '--out', str(root / 'model' / 'compression')])
    t1 = time.perf_counter()
    import_checkpoint.main(['lm', str(root / 'state_dict.bin'), '--out',
                            str(root / 'model' / 'lm'), '--t5-state', str(root / 't5.bin')])
    t2 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loaded = loaders.get_pretrained(str(root / 'model'))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    loaded.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
    mg.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
    batch, seconds = CKPT_ENCODE
    wav = _clips(batch, seconds * SAMPLE_RATE, device, seed=172)
    enc_ms = time_ms(lambda: loaded.compression_model.encode(wav), 3)
    codes32, _ = loaded.compression_model.encode(wav, compute_dtype='float32')
    descriptions = [f'checkpoint {i}' for i in range(CKPT_GEN[0])]
    tokens, gen_s = _greedy(loaded, descriptions, CKPT_GEN[1])
    torch.cuda.synchronize()
    launches = _launch_counts()
    print(f'17a: reference export written in {written:.1f} s; import (CLI) compression '
          f'{t1 - t0:.1f} s, lm {t2 - t1:.1f} s; cold get_pretrained {t3 - t2:.1f} s; '
          f'state.npz {_gb(root / "model"):.3f} GB; device memory while loading: peak '
          f'{peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB before, the original facade '
          f'resident)', flush=True)

    check(diff_models(loaded.compression_model, codec) == [],
          f'codec config drift {diff_models(loaded.compression_model, codec)}')
    check(diff_models(loaded.lm, lm) == [], f'LM config drift {diff_models(loaded.lm, lm)}')
    check(diff_models(loaded.condition_provider, provider) == [], 'provider config drift')
    for path in ('compression', 'lm'):
        meta = json.loads((root / 'model' / path / 'config.json').read_text())
        check(meta['extra']['unmapped_keys'] == [],
              f'{path}: unmapped keys {meta["extra"]["unmapped_keys"][:4]}')
    _states_equal(loaded.compression_model, codec, 'codec',
                  folded=('conv.conv.weight', 'convtr.convtr.weight'))
    _states_equal(loaded.lm, lm, 'LM')
    _states_equal(loaded.condition_provider, provider, 'provider')
    apart = _codes_apart_from_near_ties(codec, wav, codes32)
    orig_enc_ms = time_ms(lambda: codec.encode(wav), 3)
    orig_tokens, orig_gen_s = _greedy(mg, descriptions, CKPT_GEN[1])
    check(torch.equal(tokens, orig_tokens), 'the loaded facade\'s greedy tokens differ from the '
                                            'original facade\'s')
    print(f'17a: fp32 codes of {batch} x {seconds} s equal the original codec\'s but at '
          f'{apart} near-tie rows; bf16 encode {enc_ms:.2f} ms loaded, {orig_enc_ms:.2f} ms '
          f'original (phase 9 times this shape on every route); greedy generate '
          f'{CKPT_GEN[0]} x {CKPT_GEN[1]} s (bf16, graph steps) {gen_s:.2f} s loaded, '
          f'{orig_gen_s:.2f} s original, tokens equal {tuple(tokens.shape)}', flush=True)
    del loaded
    return mg, launches


def check_hf_snapshot(device, root, mg) -> None:
    """17b: ``mg``'s modules written as a MusicgenForConditionalGeneration
    snapshot, converted and loaded by get_pretrained, then loaded again from
    the cache by load_model."""
    from audiocraft_tpu_torch.ckpt import hf_import, loaders

    src = root / 'musicgen-small'
    src.mkdir()
    t0 = time.perf_counter()
    state = hf_snapshot_state(mg.compression_model, mg.lm, mg.condition_provider)
    write_safetensors(src / 'model.safetensors', state)
    (src / 'config.json').write_text(json.dumps(musicgen_small_hf_config()))
    written = time.perf_counter() - t0
    size = (src / 'model.safetensors').stat().st_size / 1e9
    del state

    convert = hf_import.import_hf_snapshot
    spent = []

    def timed_convert(*args, **kw):
        t = time.perf_counter()
        convert(*args, **kw)
        spent.append(time.perf_counter() - t)

    hf_import.import_hf_snapshot = timed_convert
    try:
        t0 = time.perf_counter()
        loaded = loaders.get_pretrained(str(src), cache_dir=str(root / 'cache'))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    finally:
        hf_import.import_hf_snapshot = convert
    check(len(spent) == 1, 'get_pretrained did not convert the snapshot')
    del loaded
    loaders.clear_model_cache()
    t0 = time.perf_counter()
    loaded = loaders.load_model(str(src), cache_dir=str(root / 'cache'))
    torch.cuda.synchronize()
    cached = time.perf_counter() - t0
    check(loaders.load_model(str(src), cache_dir=str(root / 'cache')) is loaded,
          'load_model did not keep the model')
    print(f'17b: snapshot written in {written:.1f} s ({size:.3f} GB of safetensors); cold '
          f'get_pretrained {cold:.1f} s (conversion {spent[0]:.1f} s), cached load_model '
          f'{cached:.1f} s; state.npz {_gb(root / "cache"):.3f} GB', flush=True)
    for side in ('lm', 'compression'):
        meta = json.loads((root / 'cache' / 'musicgen-small-hf' / side / 'config.json').read_text())
        check(meta['extra']['unmapped_keys'] == [],
              f'HF {side}: unmapped keys {meta["extra"]["unmapped_keys"][:4]}')
    _states_equal(loaded.lm, mg.lm, 'HF LM')
    _states_equal(loaded.condition_provider, mg.condition_provider, 'HF provider')
    _states_equal(loaded.compression_model.model, mg.compression_model, 'HF codec')

    loaded.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
    descriptions = [f'snapshot {i}' for i in range(CKPT_HF_GEN[0])]
    attrs = [ConditioningAttributes(text={'description': d}) for d in descriptions]
    with torch.no_grad():
        cond = loaded.condition_provider(loaded.condition_provider.tokenize(attrs))
        seq = torch.randint(0, 2048, (CKPT_HF_GEN[0], 4, CKPT_HF_STEPS),
                            generator=torch.Generator().manual_seed(173)).to(device)
        logits = loaded.lm(seq, cond)
        cpu_lm = copy.deepcopy(loaded.lm).cpu()
        cpu_logits = cpu_lm(seq.cpu(), {k: (t.cpu(), m.cpu()) for k, (t, m) in cond.items()})
    rel = float((logits.cpu() - cpu_logits).abs().max() / cpu_logits.abs().max())
    check(rel <= 1e-4, f'HF LM fp32 logits, card against CPU: {rel:.3g} > 1e-4')
    del cpu_lm
    loaded.set_generation_params(duration=CKPT_HF_GEN[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = loaded.generate(descriptions, generator=torch.Generator().manual_seed(174))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(tuple(audio.shape) == (CKPT_HF_GEN[0], 1, CKPT_HF_GEN[1] * SAMPLE_RATE)
          and bool(torch.isfinite(audio).all()), f'HF generate gave {tuple(audio.shape)}')
    print(f'17b: no unmapped keys; the imported state is the seeded modules\'; fp32 logits of '
          f'{CKPT_HF_GEN[0]} x {CKPT_HF_STEPS} steps card vs CPU {rel:.3g} (<= 1e-4); sampled '
          f'generate {CKPT_HF_GEN[0]} x {CKPT_HF_GEN[1]} s {gen_s:.2f} s', flush=True)
    loaders.clear_model_cache()


def phase_checkpoints(device) -> tp.Dict[str, int]:
    print('== phase 17: checkpoints: a reference export through the import CLI and an HF '
          'snapshot through get_pretrained, MusicGen-small and the 32 kHz codec', flush=True)
    from pathlib import Path
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        mg, launches = check_reference_export(device, root)
        print(f'-- 17a: {time.perf_counter() - start:.1f} s; launches {launches}', flush=True)
        for name in ('rvq_encode', 'lstm_step', 'fused_stage', 'banded_mono_conv'):
            check(launches[name] > 0, f'{name} did not launch on the loaded model\'s path')
        check_hf_snapshot(device, root, mg)
        del mg
    torch.cuda.empty_cache()
    print(f'phase 17: {time.perf_counter() - start:.1f} s; launches {launches}; card {card()}',
          flush=True)
    return launches


def _seeded_codec(device):
    codec = get_encodec_32khz()
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=167))
    return codec


# phase 18: the data-to-tokens path.  A corpus of 12 mono WAVs of 25-40 s at
# 32 kHz and one stereo WAV of 20 s at 44.1 kHz through apps/tokenize in
# batches of 32 rows x 10 s; --chunk and --pod over one 120 s file;
# apps/eval_codec on 4 batches of 8 x 1 s; train_encodec from the corpus.
# Earlier runs of this script's phase 3 read the fused route's bf16 encode
# at b128 x 10 s as 79.5-80.1 ms (NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's.
DATA_FILES, DATA_SECONDS, DATA_STEREO = 12, (25, 40), (20, 44100)
TOK_ROWS, TOK_SECONDS, TOK_LONG_SECONDS = 32, 10, 120
TOK_PARITY_ROWS = 8   # of batch 0, encoded in fp32 on the card and on the CPU
EVAL_ARGS = ['--batch', '8', '--batches', '4', '--segment', '1.0']
PHASE3_ENCODE_MS = (79.5, 80.1)


def _write_corpus(root) -> tp.List[str]:
    """18a's corpus under ``root / 'corpus'``; where the native library
    loads, also a FLAC and an MP3 copy.  Returns the audio files' paths."""
    from audiocraft_tpu_torch.io import native
    from audiocraft_tpu_torch.io.wav import wav_write
    data = root / 'corpus'
    data.mkdir()
    paths = []
    for i in range(DATA_FILES):
        seconds = DATA_SECONDS[0] + (DATA_SECONDS[1] - DATA_SECONDS[0]) * i / (DATA_FILES - 1)
        x = _clips(1, int(seconds * SAMPLE_RATE), 'cpu', seed=1800 + i)[0].numpy()
        paths.append(str(data / f'mono{i:02d}.wav'))
        wav_write(x, paths[-1], SAMPLE_RATE)
    seconds, rate = DATA_STEREO
    rng = np.random.RandomState(1812)
    t = np.arange(seconds * rate) / rate
    stereo = (0.15 * np.sin(2 * np.pi * (60 + 1500 * rng.rand(2, 3, 1)) * t).sum(1)
              + 0.02 * rng.randn(2, t.size)).astype(np.float32)
    paths.append(str(data / 'stereo44k.wav'))
    wav_write(stereo, paths[-1], rate)
    reason = native.unavailable_reason()
    if reason is None:
        native.encode_audio(data / 'mono00.flac', _clips(1, 20 * SAMPLE_RATE, 'cpu',
                                                         seed=1813)[0].numpy(), SAMPLE_RATE)
        native.encode_audio(data / 'stereo44k.mp3', stereo, rate)
        paths += [str(data / 'mono00.flac'), str(data / 'stereo44k.mp3')]
        print('native audio: loaded')
    else:
        print(f'native audio: not loadable ({reason})')
    return paths


def _quiet(fn):
    """``fn()`` with its standard output captured: (result, the output)."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue()


def check_tokenize(device, root, paths: tp.List[str], ckpt) -> tp.Dict[str, int]:
    """18b: the tokenize CLI over the corpus; its launches, its codes
    against the codec's own encode of the rows it built, one batch in fp32
    against the CPU, its rate, the host's load time a batch, the card's
    busy share across the pipeline, and the bare encode at b128 x 10 s."""
    from audiocraft_tpu_torch.apps import tokenize
    from audiocraft_tpu_torch.ckpt.io import load_checkpoint
    from audiocraft_tpu_torch.io import native
    from audiocraft_tpu_torch.io.wav import audio_info
    from audiocraft_tpu_torch.obs import chained_throughput

    out = root / 'tokens.npz'
    _reset_launch_counts()
    result = tokenize.main([*paths, '--out', str(out), '--checkpoint', str(ckpt),
                            '--batch-rows', str(TOK_ROWS), '--batch-seconds', str(TOK_SECONDS),
                            '--stats'])
    torch.cuda.synchronize()
    launches = _launch_counts()
    chunks = tokenize.plan_chunks(paths, TOK_SECONDS, [audio_info(p) for p in paths])
    batches = [chunks[i:i + TOK_ROWS] for i in range(0, len(chunks), TOK_ROWS)]
    nb = len(batches)
    check(launches == {'flash_attention': 0, 'flash_attention_bwd_dkv': 0,
                       'flash_attention_bwd_dq': 0, 'rvq_encode': nb, 'lstm_step': 2 * nb,
                       'fused_stage': 2 * nb, 'banded_mono_conv': nb,
                       **{name: 0 for name in FP32_COUNTERS}},
          f'tokenize over {nb} batches launched {launches} (K1 1, K2 2, K4 2, K5 1 a batch)')
    rates = result['rates']
    print(f'18b: tokenize CLI, {len(paths)} files, {len(chunks)} chunks of {TOK_SECONDS} s in '
          f'{nb} batches of {TOK_ROWS} rows: {rates["audio_sec_per_s"]:.1f} audio-s/s '
          f'({result["seconds"]:.3f} s for {len(chunks) * TOK_SECONDS} audio-s, the first batch '
          f'included); host load a batch {[round(1e3 * s, 1) for s in result["load_s"]]} ms, the '
          f'device loop waited {1e3 * result["wait_s"]:.1f} ms; launches {launches}; card '
          f'{card()}', flush=True)

    model = load_checkpoint(ckpt)[0]
    use_native = native.available() and any(not p.endswith('.wav') for p in paths)

    def load(batch):
        return tokenize.load_rows(batch, TOK_ROWS, TOK_SECONDS, SAMPLE_RATE, use_native,
                                  pin=True)

    with np.load(out) as z:
        codes = z['codes']
    check(codes.shape == (len(chunks), 4, TOK_SECONDS * 50) and codes.dtype == np.int32,
          f'tokenize wrote codes {codes.shape} {codes.dtype}')
    start = 0
    for batch in batches:
        ref = model.encode(load(batch).to(device))[0][:len(batch)].cpu().numpy()
        check(np.array_equal(codes[start:start + len(batch)], ref),
              f'the CLI\'s codes of rows {start}.. differ from encode of the rows it built')
        start += len(batch)
    print(f'18b: the npz codes equal encode of the rows the CLI built, bit for bit ({len(chunks)} '
          f'rows)', flush=True)
    # batch 0's first rows in fp32, the card's route against the plain
    # versions on the CPU
    rows = load(batches[0])[:TOK_PARITY_ROWS]
    lat = model.encode_to_latent(rows.to(device), compute_dtype='float32')
    t0 = time.perf_counter()
    cpu_model = load_checkpoint(ckpt, 'cpu')[0]
    lat_cpu = cpu_model.encode_to_latent(rows, compute_dtype='float32')
    print(f'18b: batch 0\'s first rows [{TOK_PARITY_ROWS}, 1, {rows.shape[-1]}] in fp32 on the '
          f'CPU: '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    _fp32_codes_vs_cpu('18b: tokenize batch 0', lat, lat_cpu, model, cpu_model)
    del lat, lat_cpu, cpu_model

    busy, window, kernels = _cuda_busy_ms(lambda: tokenize.encode_batches(model, batches, load,
                                                                          device))
    top = ', '.join(f'{e.key[:40]} {e.self_device_time_total / 1e3:.1f}' for e in kernels[:4])
    print(f'18b: the pipeline under torch.profiler: the card busy {busy:.1f} of {window:.1f} ms '
          f'({busy / max(window, 1e-9):.3f}); kernels by device ms: {top}', flush=True)

    wav = _clips(BATCH, SECONDS * SAMPLE_RATE, device, seed=1814)

    def step(carry, x):
        c = model.encode(x)[0]
        return c, carry + c[0, 0, 0]

    dt, rate = chained_throughput(step, [wav], iters=5, units_per_iter=BATCH * SECONDS)
    print(f'18b: bare encode b{BATCH} x {SECONDS} s through obs.chained_throughput: '
          f'{1e3 * dt:.2f} ms ({rate:.1f} audio-s/s; earlier runs of phase 3 read '
          f'{PHASE3_ENCODE_MS[0]}-{PHASE3_ENCODE_MS[1]} ms for this route); card {card()}',
          flush=True)
    del model, wav
    return launches


def check_whole_file(device, root, ckpt32) -> None:
    """18c: ``--chunk`` and ``--pod`` over one 120 s file with the fp32
    codec: their codes equal the whole-signal encode's (the module stack,
    fp32) but at near-ties of its distances (1e-4 relative)."""
    from audiocraft_tpu_torch.apps import tokenize
    from audiocraft_tpu_torch.ckpt.io import load_checkpoint
    from audiocraft_tpu_torch.io.wav import wav_write

    x = _clips(1, TOK_LONG_SECONDS * SAMPLE_RATE, 'cpu', seed=1815)
    path = root / 'long.wav'
    wav_write(x[0].numpy(), path, SAMPLE_RATE)
    model = load_checkpoint(ckpt32)[0]
    from audiocraft_tpu_torch.io.wav import audio_read
    signal = torch.from_numpy(audio_read(path)[0])[None].to(device)
    with torch.no_grad():
        lat = model.encoder(signal, lstm_kernel=True).float()
        ref = model.quantizer.encode(lat)
    near = _near_ties(lat[0].t(), model.quantizer.embeds(), ref[0], rel=1e-4)
    for mode in (['--chunk'], ['--pod']):
        out = root / f'long{mode[0].strip("-")}.npz'
        _reset_launch_counts()
        t0 = time.perf_counter()
        tokenize.main([str(path), '--out', str(out), '--checkpoint', str(ckpt32), '--stats',
                       *mode])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        with np.load(out) as z:
            codes = torch.from_numpy(z['codes_0']).to(device)
        check(tuple(codes.shape) == (4, TOK_LONG_SECONDS * 50), f'{mode[0]}: {codes.shape}')
        differ = (codes != ref[0]).any(0)
        print(f'18c: tokenize {mode[0]} fp32 of 1 x {TOK_LONG_SECONDS} s: {int(differ.sum())} of '
              f'{codes.shape[-1]} frames differ from the whole-signal encode, all at near-ties: '
              f'{bool((near | ~differ).all())}; CLI {seconds:.2f} s with the load; launches '
              f'K2 {launches["lstm_step"]}, K1 {launches["rvq_encode"]}', flush=True)
        check(bool((near | ~differ).all()), f'{mode[0]}: {int((differ & ~near).sum())} frames '
                                            'differ away from a near-tie')
        check(launches['lstm_step'] == 2 and launches['rvq_encode'] == 1,
              f'{mode[0]} launched {launches} (K2 2, K1 1)')
    del model, lat


def check_eval_codec(device, root, ckpt) -> tp.Dict[str, int]:
    """18d: eval_codec over the corpus: finite metrics, the bitrate by its
    formula, and its codebook statistics those of ``encode``'s codes of the
    same batches."""
    from audiocraft_tpu_torch.apps import eval_codec
    from audiocraft_tpu_torch.ckpt.io import load_checkpoint
    from audiocraft_tpu_torch.data.audio_dataset import AudioDataset

    _reset_launch_counts()
    t0 = time.perf_counter()
    metrics, printed = _quiet(lambda: eval_codec.main([str(root / 'corpus'), '--ckpt', str(ckpt),
                                                       *EVAL_ARGS]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    print(printed.strip())
    check(json.loads(printed.strip().splitlines()[-1]) == metrics, 'eval_codec printed another '
                                                                   'line than it returned')
    check(all(math.isfinite(metrics[k]) for k in ('sisnr_db', 'msspec_distance', 'l1')),
          f'eval_codec: non-finite metrics {metrics}')
    model = load_checkpoint(ckpt)[0]
    check(metrics['bitrate_kbps'] == model.frame_rate * 4 * math.log2(2048) / 1000.0 == 2.2,
          f'bitrate {metrics["bitrate_kbps"]}')
    ds = AudioDataset.from_path(root / 'corpus', segment_duration=1.0, sample_rate=SAMPLE_RATE,
                                channels=1, num_samples=32)
    ds.start_epoch(0)
    counts = np.zeros((4, 2048), np.int64)
    for batch in list(ds.iter_batches(8))[:4]:
        c = model.encode(torch.from_numpy(batch).to(device))[0].cpu().numpy()
        for k in range(4):
            counts[k] += np.bincount(c[:, k].ravel(), minlength=2048)
    probs = counts / counts.sum(axis=1, keepdims=True)
    with np.errstate(divide='ignore', invalid='ignore'):
        entropy = (-np.nansum(np.where(probs > 0, probs * np.log2(probs), 0.0), axis=1)).tolist()
    used = (counts > 0).mean(axis=1).tolist()
    check(used == metrics['codebook_usage'] and entropy == metrics['codebook_entropy_bits'],
          f'eval_codec usage {metrics["codebook_usage"]} and entropy '
          f'{metrics["codebook_entropy_bits"]} are not those of encode\'s codes {used} {entropy}')
    print(f'18d: eval_codec {seconds:.2f} s with the load; its codebook usage and entropy those '
          f'of encode\'s codes of the same batches; launches {launches}', flush=True)
    del model
    return launches


def check_train_from_data(device, root) -> None:
    """18e: two debug steps of the codec trainer with the corpus as its
    DATA_DIR: both losses finite."""
    from audiocraft_tpu_torch.apps import train_encodec
    _, printed = _quiet(lambda: train_encodec.main([str(root / 'corpus'), '--debug', '--steps',
                                                    '2', '--log-every', '1']))
    lines = [line for line in printed.splitlines() if line.startswith('step')]
    losses = [float(line.split()[3]) for line in lines]
    print(f'18e: train_encodec --debug from the corpus: {lines}', flush=True)
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses),
          f'train_encodec from a DATA_DIR: losses {losses}')


def phase_data_to_tokens(device) -> tp.Dict[str, int]:
    print('== phase 18: data to tokens: a corpus through apps/tokenize (batched, --chunk, --pod), '
          'apps/eval_codec and train_encodec from a DATA_DIR', flush=True)
    from pathlib import Path

    from audiocraft_tpu_torch.ckpt.io import save_checkpoint
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths = _write_corpus(root)
        codec = _seeded_codec(device)
        save_checkpoint(root / 'codec', codec)
        codec.compute_dtype = None
        save_checkpoint(root / 'codec32', codec)
        del codec
        print(f'-- 18a: corpus and checkpoints {time.perf_counter() - start:.1f} s', flush=True)
        launches = check_tokenize(device, root, paths, root / 'codec')
        print(f'-- 18b: {time.perf_counter() - start:.1f} s', flush=True)
        check_whole_file(device, root, root / 'codec32')
        print(f'-- 18c: {time.perf_counter() - start:.1f} s', flush=True)
        check_eval_codec(device, root, root / 'codec')
        print(f'-- 18d: {time.perf_counter() - start:.1f} s', flush=True)
        check_train_from_data(device, root)
    torch.cuda.empty_cache()
    print(f'phase 18: {time.perf_counter() - start:.1f} s; tokenize launches {launches}; card '
          f'{card()}', flush=True)
    return launches



# phase 19: serving.  MusicGen-small (seeded, the decode in bf16) from a
# checkpoint directory behind apps/serve's HTTP server: three concurrent
# 5 s text requests coalesced at bucket 4, a 5 s continuation of a 2 s
# prompt, a 5 s greedy request; then generate (10 s), batch_generate (4 x
# 10 s in one batch) and scale_bench (b8 x 10 s, 4 timed encodes).
SERVE_SECONDS, SERVE_PROMPT_SECONDS, SERVE_WINDOW_MS, SERVE_MAX_BATCH = 5.0, 2, 200, 4
SERVE_CONCURRENT, SERVE_GEN_SECONDS, SERVE_BATCH_PROMPTS = 3, 10, 4
SERVE_SCALE = (8, 10, 4)   # scale_bench's rows a card, seconds, timed iterations
SERVE_TIMEOUT_S = 300   # any one HTTP request or thread join


def _http(url: str, body: tp.Optional[dict] = None) -> tp.Tuple[int, dict, bytes, float]:
    """GET ``url`` (or POST ``body`` as JSON) -> (status, headers, body,
    seconds to the body)."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            payload = r.read()
            return r.status, dict(r.headers), payload, time.perf_counter() - t0
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, dict(exc.headers), exc.read(), time.perf_counter() - t0


def _wav_samples(body: bytes) -> np.ndarray:
    """A mono 16-bit WAV body's int16 samples."""
    check(body[:4] == b'RIFF' and body[8:12] == b'WAVE', 'the body is not a WAV file')
    return np.frombuffer(body[44:], '<i2')


def _write_serving_checkpoint(device, path) -> None:
    """MusicGen-small, seeded, with its codebooks seeded, written by
    ``ckpt/io.save_checkpoint`` (the codec and the LM bundle)."""
    from audiocraft_tpu_torch.ckpt.io import save_checkpoint
    mg = get_musicgen('small', seed=190)
    seed_codebooks(mg.compression_model, _clips(8, SECONDS * SAMPLE_RATE, device, seed=191))
    save_checkpoint(path / 'compression', mg.compression_model)
    save_checkpoint(path / 'lm', {'lm': mg.lm, 'condition_provider': mg.condition_provider})
    del mg
    torch.cuda.empty_cache()


def check_served_requests(service, model, url: str) -> tp.Dict[str, int]:
    """19b: the requests over HTTP to ``service``, which serves ``model``;
    returns the kernels' launches while they were served."""
    import base64
    import threading
    from audiocraft_tpu_torch.apps import serve

    status, _, body, _ = _http(f'{url}/health')
    health = json.loads(body)
    check(status == 200 and health['status'] == 'ok', f'/health: {status} {health}')
    status, _, body, _ = _http(f'{url}/models')
    check(status == 200 and json.loads(body)['current'] == health['model'], f'/models: {body}')
    name, sr = health['model'], model.sample_rate
    samples = int(SERVE_SECONDS * model.frame_rate) * int(sr // model.frame_rate)

    calls: tp.List[int] = []
    generate = model.generate

    def counted(texts, **kw):
        calls.append(len(texts))
        return generate(texts, **kw)

    model.generate = counted
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    served: tp.Dict[str, tp.Any] = {}
    polls: tp.List[int] = []
    stop = threading.Event()

    def fire(i: int) -> None:
        served[i] = _http(f'{url}/generate', {'text': f'served tune {i}', 'model': name,
                                               'duration': SERVE_SECONDS, 'seed': 190 + i})

    def poll() -> None:   # handler threads that stay on the host meanwhile
        while not stop.is_set():
            polls.append(_http(f'{url}/health')[0])
            time.sleep(0.01)

    poller = threading.Thread(target=poll, daemon=True)
    threads = [threading.Thread(target=fire, args=(i,), daemon=True)
               for i in range(SERVE_CONCURRENT)]
    poller.start()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(SERVE_TIMEOUT_S)
        check(not th.is_alive(), 'a served request did not end')
    batch_s = time.perf_counter() - t0
    stop.set()
    poller.join(SERVE_TIMEOUT_S)
    check(not poller.is_alive(), 'the /health poller did not end')
    model.generate = generate
    batch_launches = _launch_counts()
    check(calls == [4], f'{SERVE_CONCURRENT} concurrent requests made facade calls of {calls} '
                        'texts, not one call at bucket 4')
    seeds = {headers.get('X-Seed') for _, headers, _, _ in served.values()}
    check(len(seeds) == 1 and int(seeds.pop()) in range(190, 190 + SERVE_CONCURRENT),
          'the batch\'s responses do not share its lead\'s seed')
    for i, (status, headers, body, _) in served.items():
        check(status == 200 and headers['Content-Type'] == 'audio/wav',
              f'request {i}: {status} {headers}')
        wav = _wav_samples(body)
        check(wav.size == samples and np.abs(wav).max() > 0, f'request {i}: {wav.size} samples')
    check(len(polls) > 0 and set(polls) == {200}, f'/health during the batch: {set(polls)}')
    check(batch_launches == {**{k: 0 for k in batch_launches}, 'lstm_step': 2},
          f'the coalesced batch launched {batch_launches} (K2 2 in the decode only)')
    secs = [round(served[i][3], 3) for i in range(SERVE_CONCURRENT)]
    print(f'19b: {SERVE_CONCURRENT} concurrent {SERVE_SECONDS:g} s requests, one facade call '
          f'at bucket 4: seconds to each body {secs}, the batch {batch_s:.3f} s, '
          f'{SERVE_CONCURRENT * SERVE_SECONDS / batch_s:.2f} audio-s/s; {len(polls)} /health '
          f'polls answered meanwhile; launches {batch_launches}; card {card()}', flush=True)

    prompt = _clips(1, SERVE_PROMPT_SECONDS * sr, 'cpu', seed=192)[0].numpy()
    _reset_launch_counts()
    status, headers, body, cont_s = _http(f'{url}/generate', {
        'text': 'continue this', 'model': name, 'duration': SERVE_SECONDS, 'seed': 193,
        'prompt_wav': base64.b64encode(serve._wav_bytes(prompt, sr)).decode(),
        'return_history_json': True})
    cont_launches = _launch_counts()
    doc = json.loads(body)
    check(status == 200 and doc['metadata']['continuation'] is True,
          f'continuation: {status} {doc.get("error")}')
    check(_wav_samples(base64.b64decode(doc['audio_b64'])).size == samples,
          'continuation: the audio\'s length')
    check(cont_launches == {**{k: 0 for k in cont_launches}, 'banded_mono_conv': 1,
                            'fused_stage': 2, 'lstm_step': 4, 'rvq_encode': 1},
          f'the continuation launched {cont_launches} (K5 1, K4 2, K2 4, K1 1)')
    print(f'19b: continuation of a {SERVE_PROMPT_SECONDS} s prompt to {SERVE_SECONDS:g} s: '
          f'{cont_s:.3f} s to the body; launches {cont_launches}', flush=True)

    greedy_req = {'text': 'a greedy tune', 'model': name, 'duration': SERVE_SECONDS,
                  'seed': 194, 'topk': 1}
    _reset_launch_counts()
    status, _, body, greedy_s = _http(f'{url}/generate', greedy_req)
    launches = {k: batch_launches[k] + cont_launches[k] + n
                for k, n in _launch_counts().items()}
    for bad, code in (({'text': 'x', 'model': name, 'duration': 0}, 400),
                      ({'text': 'x', 'model': 'no-such-model'}, 404)):
        got = _http(f'{url}/generate', bad)[0]
        check(got == code, f'{bad}: {got}, not {code}')
    peak = torch.cuda.max_memory_allocated()
    check(status == 200, f'greedy request: {status}')
    with service.lock:   # the direct generate takes the service's lock too
        model.set_generation_params(duration=SERVE_SECONDS, top_k=1, top_p=0.0,
                                    temperature=1.0, cfg_coef=3.0,
                                    extend_stride=min(10.0, model.max_duration / 2))
        direct = model.generate([greedy_req['text']],
                                generator=torch.Generator().manual_seed(194))
        direct = direct[0].float().cpu().numpy()
    check(body == serve._wav_bytes(direct, sr), 'the greedy request\'s WAV differs from a direct '
                                                'generate of the same text')
    print(f'19b: greedy request (top-k 1) {greedy_s:.3f} s to the body, its WAV equal to a direct '
          f'generate of the same text, byte for byte; a bad duration 400, an unknown model 404; '
          f'peak memory over the requests {peak / 2**30:.2f} GiB; card {card()}', flush=True)
    return launches


def check_cli_apps(device, root, ckpt: str, cache: str) -> None:
    """19c: generate, batch_generate and scale_bench on the card, once each."""
    from audiocraft_tpu_torch import builders
    from audiocraft_tpu_torch.apps import batch_generate, generate, scale_bench
    from audiocraft_tpu_torch.io.wav import wav_read

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, printed = _quiet(lambda: generate.main(['a generated tune', '--checkpoint', ckpt,
                                                  '--duration', str(SERVE_GEN_SECONDS),
                                                  '--out', str(root / 'generated.wav')]))
    gen_s = time.perf_counter() - t0
    wav, rate = wav_read(path)
    check(rate == SAMPLE_RATE and wav.shape == (1, SERVE_GEN_SECONDS * SAMPLE_RATE)
          and np.isfinite(wav).all(), f'generate CLI wrote {wav.shape} at {rate}')

    prompts = root / 'prompts.txt'
    prompts.write_text(''.join(f'batch tune {i}\n' for i in range(SERVE_BATCH_PROMPTS)))
    t0 = time.perf_counter()
    manifest, _ = _quiet(lambda: batch_generate.main([
        str(prompts), '--out', str(root / 'batch'), '--model', ckpt, '--cache-dir', cache,
        '--duration', str(SERVE_GEN_SECONDS), '--batch-size', str(SERVE_BATCH_PROMPTS)]))
    batch_s = time.perf_counter() - t0
    check(len(manifest) == SERVE_BATCH_PROMPTS and all(
        wav_read(root / 'batch' / m['wav'])[0].shape == (1, SERVE_GEN_SECONDS * SAMPLE_RATE)
        for m in manifest), f'batch_generate wrote {manifest}')

    build = builders.get_encodec_32khz

    def seeded(*args, **kw):
        codec = build(*args, **kw)
        seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=195))
        _reset_launch_counts()   # count scale_bench's encodes only
        return codec

    builders.get_encodec_32khz = seeded
    try:
        rows, seconds, iters = SERVE_SCALE
        results, printed = _quiet(lambda: scale_bench.main([
            '--devices', '1', '--batch-per-device', str(rows), '--seconds', str(seconds),
            '--iters', str(iters)]))
    finally:
        builders.get_encodec_32khz = build
    launches = _launch_counts()
    print(printed.strip())
    check(len(results) == 1 and results[0]['devices'] == 1
          and results[0]['audio_sec_per_s'] > 0, f'scale_bench: {results}')
    encodes = iters + WARMUP_CALLS   # chained_throughput's warm-up calls too
    check(launches == {**{k: 0 for k in launches}, 'rvq_encode': encodes,
                       'lstm_step': 2 * encodes, 'fused_stage': 2 * encodes,
                       'banded_mono_conv': encodes},
          f'scale_bench\'s {encodes} encodes launched {launches} (K1 1, K2 2, K4 2, K5 1 each)')
    print(f'19c: generate CLI {SERVE_GEN_SECONDS} s in {gen_s:.2f} s with the write; '
          f'batch_generate {SERVE_BATCH_PROMPTS} x {SERVE_GEN_SECONDS} s in one batch '
          f'{batch_s:.2f} s; scale_bench one card b{rows} x {seconds} s '
          f'{results[0]["audio_sec_per_s"]} audio-s/s, launches {launches}; card {card()}',
          flush=True)


def phase_serving(device) -> tp.Dict[str, int]:
    print('== phase 19: serving: apps/serve over HTTP with continuous batching, then the '
          'generate, batch_generate and scale_bench CLIs', flush=True)
    import threading
    from http.server import ThreadingHTTPServer
    from pathlib import Path

    from audiocraft_tpu_torch.apps import serve
    from audiocraft_tpu_torch.ckpt import loaders
    from audiocraft_tpu_torch.io import video

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt, cache = root / 'musicgen-small', str(root / 'cache')
        _write_serving_checkpoint(device, ckpt)
        written = time.perf_counter() - start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = loaders.load_model(str(ckpt), cache)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        model.condition_provider.conditioners['description'].load_tokenizer = SeededT5Ids
        check(model.decode_dtype == 'bfloat16' and model.lm.dim == 1024
              and len(model.lm.transformer.layers) == 24, 'not MusicGen-small in bf16')
        print(f'19a: checkpoint written in {written:.1f} s; load_model {load_s:.2f} s '
              f'(cold, from {cache})', flush=True)

        service = serve.GenerationService(str(ckpt), cache_dir=cache,
                                          batch_window_ms=SERVE_WINDOW_MS,
                                          max_batch=SERVE_MAX_BATCH)
        check(service._get_model(None) is model, 'the service did not take the cached model')
        server = ThreadingHTTPServer(('127.0.0.1', 0), serve.make_handler(service))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            launches = check_served_requests(service, model,
                                             f'http://127.0.0.1:{server.server_address[1]}')
        finally:
            server.shutdown()
            server.server_close()
            thread.join(SERVE_TIMEOUT_S)
            service.close()
        check(not thread.is_alive(), 'the HTTP server\'s thread did not end')
        print(f'-- 19b: {time.perf_counter() - start:.1f} s', flush=True)
        check_cli_apps(device, root, str(ckpt), cache)
        reason = video.unavailable_reason()
        print(f'video muxer: {"loaded" if reason is None else f"not loadable ({reason})"}',
              flush=True)
        del model
        loaders.clear_model_cache()
    torch.cuda.empty_cache()
    print(f'phase 19: {time.perf_counter() - start:.1f} s; served launches {launches}; card '
          f'{card()}', flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    # the global flags stay at torch's defaults: fp32 matmuls without TF32,
    # cuDNN convolutions with it, which the fp32 codec turns off itself
    print(f'TF32 flags left at torch\'s defaults: matmul allow_tf32 '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32 '
          f'{torch.backends.cudnn.allow_tf32} (the fp32 conv stacks turn it off themselves)')
    device = torch.device('cuda')
    start = time.perf_counter()
    mark = lambda: print(f'-- {time.perf_counter() - start:.1f} s since the start', flush=True)
    phase_build()
    mono_input_conv.launches = 0
    kernels = phase_kernels(device)
    kernel_checks_k6 = mono_input_conv.launches
    mark()
    launches = phase_main_path(device)
    # the fp32 FMA kernels' main paths: the fp32 encode (phase 4), MAGNeT's
    # fp32 parity (phase 6), the fp32 LM step (phase 7, the training CLI's
    # default dtype)
    launches['fused_stage_fp32'] = phase_parity(device)
    mark()
    lm, provider = get_magnet_lm('small', segment_duration=MAGNET_SECONDS)
    magnet_launches = phase_magnet(device, lm, provider, get_encodec_32khz())
    launches['flash_attention_fp32'] = phase_magnet_parity(device, lm, provider)
    del lm, provider
    mark()
    lm, provider = get_musicgen_lm('small', seed=1)
    train_launches = phase_train(device, lm, provider)
    phase_train_parity(device, lm, provider)
    for name in ('flash_attention_bwd_dkv_fp32', 'flash_attention_bwd_dq_fp32'):
        launches[name] = train_launches.pop(name)
    del lm, provider
    mark()
    launches.update(phase_fused_encode(device))
    mark()
    probe_launches, probe_kernels = phase_probe(device)
    launches.update(probe_launches)
    kernels.update(probe_kernels)
    # K6 is on no model path (the JAX package calls it from tests only): its
    # launches are phase 2's, its checks and timing
    musicgen_launches = phase_musicgen(device)
    mark()
    print(f'K1 and K2 launches on the MusicGen path (phase 11): {musicgen_launches}', flush=True)
    phase_stereo_streaming(device)
    mark()
    phase_melody_style(device)
    mark()
    dp_launches = phase_codec_training(device)
    mark()
    print(f'K3f and K3b launches in one data-parallel LM step (phase 14): {dp_launches}',
          flush=True)
    jasco_launches = phase_demucs_jasco(device)
    mark()
    print(f'K1, K2, K3f, K4 and K5 launches on the JASCO path (phase 15): {jasco_launches}',
          flush=True)
    slice16 = phase_pod_tp_diffusion(device)
    mark()
    ckpt_launches = phase_checkpoints(device)
    mark()
    data_launches = phase_data_to_tokens(device)
    mark()
    serve_launches = phase_serving(device)
    mark()
    launches['mono_input_conv'] = kernel_checks_k6
    launches['flash_attention'] = magnet_launches['flash_attention']
    for name in ('flash_attention_bwd_dkv', 'flash_attention_bwd_dq'):
        launches[name] = train_launches[name]
    for name, n in launches.items():
        kernels[name]['launches'] = n
    idle = [name for name, kern in kernels.items() if kern.get('launches', 0) == 0]
    check(not idle, f'kernels without a launch on their path: {idle}')
    # phase 15's counts beside the main path's: the drums encode and the
    # 100-step Euler generate, and the joint embedding's RVQ forward
    joint_embed = jasco_launches.pop('rvq_encode (joint embedding)')
    check(set(jasco_launches) <= set(kernels), f'phase 15 counted unknown kernels {jasco_launches}')
    for name, kern in kernels.items():
        kern['launches_jasco'] = jasco_launches.get(name, 0)
        kern['launches_joint_embed'] = joint_embed if name == 'rvq_encode' else 0
        # phase 16's counts: one pod encode + decode, one tensor-parallel
        # forward, the diffusion reverse process and a BLSTM bottleneck, the
        # metrics' four encodes, the rope forward
        for key, counts in slice16.items():
            kern[f'launches_{key}'] = counts.get(name, 0)
        # phase 17's: the loaded checkpoint's import, load, encode and generate
        kern['launches_ckpt'] = ckpt_launches.get(name, 0)
        # phase 18's: the tokenize CLI's batched pipeline over the corpus
        kern['launches_data'] = data_launches.get(name, 0)
        # phase 19's: the served requests (the coalesced batch, the
        # continuation, the greedy request)
        kern['launches_serve'] = serve_launches.get(name, 0)
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'launches_jasco',
            'launches_joint_embed', 'launches_pod', 'launches_tp', 'launches_diffusion',
            'launches_metrics', 'launches_rope', 'launches_ckpt', 'launches_data',
            'launches_serve', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    # P1's entries also carry phase 10's host times, launch floor and 2048x shapes
    extra = ('host_us', 'library_host_us', 'launch_floor_ms', 'ms_2048x', 'bound_ms_2048x',
             'library_ms_2048x')
    print(card())
    print(json.dumps({'kernels': [{k: kern[k] for k in keys + extra if k in kern}
                                  for kern in kernels.values()]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
