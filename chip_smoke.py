#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``seedvc_tpu_torch``) on one NVIDIA GPU.

Run from the repo root: ``python3 chip_smoke.py``. Phases, in order; any
failure exits non-zero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every CUDA kernel of the port from ``seedvc_tpu_torch/csrc``,
   print ptxas's register lines and each kernel's SASS instruction count and
   commonest opcodes (``cuobjdump -sass``); every f32 attention kernel must
   run TF32 tensor-core instructions (``HMMA.1688.F32.TF32``);
3. kernels: each kernel against its plain PyTorch twin, on the card, at the
   shapes of both conversion paths plus ragged ones, with the tolerance
   printed: K1's RoPE pre-pass bit for bit; K1 and K3 (one source, RoPE on
   and off) in bf16 and f32, with lens None, partial, the main path's
   (1966, 1477) and with a 0 entry (every key masked), K1 at the SVC
   path's 12 heads with its lens (1966, 1493) and with a 0 entry, and K1 at
   the real-time paths' 6 heads: a block's T = 331 (every key valid) and the
   offline chunks' T = 2050 with lens (1968, 1968), (1495, 1495) and a 0
   entry, and K1 at the v2 path's 3-way CFG stack: (3, 8, 2560, 64) with
   lens (2154, 2154, 2154) and (3, 8, 2048, 64) with (1966, 1497, 0) and
   (1497, 1497, 1497) and at T = 1536 with every key valid and with
   (1290, 0, 1290), and K1 at the eval path's one chunk at context 1536:
   (2, 8, 1536, 64) with lens (1291, 946) and a 0 entry, (2, 12, 1536, 64)
   with (1291, 1291), and the multi-GPU phase's shapes: one CFG branch a
   rank, (1, 8, 2048, 64) bf16 and f32 with lens 1966, 1477 and 1, and
   (1, 8, 2560, 64), and (f32) the sharded steps' (2, 4, 896, 64) with
   (896, 700) and (0, 640) and (1, 8, 896, 64) with 700 and 896 keys, each
   with a planted fault that must fail the limits; K1 and K3 over a query
   slab (q of a rank's Tq rows against Tk keys, bf16 and f32): the
   time-sharded conversions' (2, 8, 1024 / 2048) at both offsets with lens
   1966, a 0 entry and one valid key, v2's (3, 8, 1281 and 1279 / 2560) and
   ``xlsr_tiny``'s (2, 6, 1026 and 1024 / 2050), each with a planted fault
   (past offset 0 q's table at local positions, else the last valid key tile
   dropped);
   ``Attention(use_flash=True)``
   at a T that is no multiple of 512, which must launch K1 (or K3 with
   grouped KV heads) and agree with its plain twins; and K2 at every stage
   shape of a 22 kHz and of a 44.1 kHz chunk, of the v2 path's 2046-frame
   22 kHz chunk, of the eval path's 1024-frame chunks at both rates, and at
   its corners (T % 4 != 0,
   one tile and one tile +- 1, T = 1, B = 2, ``logscale=False``,
   |alpha * u| of a few hundred), each with a planted fault (one filter tap
   nudged) that must fail the limit, and one K2 call profiled: it must run
   exactly one device kernel; then K1ᵇ, the backward of K1 (RoPE on) and of
   K3 (RoPE off), against autograd through the twins in f32 and bf16 at
   (2, 8, T, 64), T = 896, 2560 and 777, lens None, a 0 entry, one valid key
   and partial, each with a planted fault (the last valid key tile dropped
   from dk and dv), given the forward's log-sum-exp and (f32) computing the
   statistics itself, and in f32 at the v2 trainer's shapes (2, 8, 386, 64)
   and (2, 8, 1154, 64) (T = 128-frame mel bucket + 2) with the lens of its
   clips, a 0 entry and one valid key (K1 f32 at those too, with its
   log-sum-exp), and in f32 at the multi-GPU steps' (2, 4, 896, 64) and
   (1, 8, 896, 64); a row with one valid key must get dq = dk = 0 exactly;
   the f32 forward's log-sum-exp against the twin's; SDPA's own f32 error
   against the twins printed beside the kernels' as a yardstick; and one
   K1ᵇ call repeated (dq is summed by atomics);
4. small: a small-config conversion on cuda (kernels) and on cpu (plain
   twins), f32, same weights and noise, compared; then the same config in
   bf16 (the main path's DiT precision) on cuda, kernels against the plain
   twins swapped in on the card; then a bf16 conversion whose DiT has
   grouped KV heads (4 query heads, 2 KV heads), kernels against twins: K3
   must launch and K1 must not;
5. full: the ``whisper_small_wavenet`` preset at full width, random weights,
   30 s source + 5 s reference, 25 steps, cfg 0.7, run cold, warm, and warm
   with a device synchronise after each stage (for the stage times); launch
   counts are checked against the plan (2 chunks: 650 K1, 218 K2, 0 K3);
6. SVC, the ``whisper_base_f0_44k`` path: (a) a small F0-conditioned
   conversion (reduced RMVPE) on cuda with the kernels and on cpu with the
   plain twins, same weights and noise, waves and extracted F0 compared;
   (b) RMVPE at full width on a 3 s vibrato tone, cuda against cpu
   (salience, and F0 on the frames whose salience peak is clear); (c) the
   full-width SVC path through its entry points, 30 s source + 5 s reference
   written as wav files: ``python -m seedvc_tpu_torch.apps.infer
   --f0-condition true --auto-f0-adjust true --semi-tone-shift 2`` (its wav
   checked), then ``SeedVCWrapper().convert_voice(f0_condition=True)`` cold
   and warm, and a warm run with a device synchronise after each stage;
   launch counts are checked against the plan (2 chunks: 850 K1, 218 K2,
   0 K3);
7. microbench: every component of ``seedvc_tpu_torch.apps.microbench`` at
   full width, its JSON rows printed, and each component's launch counts
   checked (``attention`` K3 only, ``dit`` 13 K1 a call, ``vocoder`` 109 K2
   a call, ``serving*`` 25 x 13 K1 a sample, ``train*`` 13 K1 and 13 K1ᵇ a
   step, ``train_onfly_v2`` among them, the rest none);
8. real-time, ``xlsr_tiny`` (XLS-R, a DiT with time and style tokens, HiFT):
   (a) a reduced converter, offline, cuda (K1) against cpu (plain twins) in
   f32 with the same weights, CFM noise and HiFT draws; then streaming in
   f32, the captured block program's replays on cuda against the block
   function on cpu, and in bf16, the replays against the same block function
   run eagerly on a second state, each fed the same blocks, noise and draws
   (emitted audio, SOLA offsets, VAD decisions, one replay a converted
   block; 3 speech, 4 silent, 2 speech blocks), and the captured launches
   checked; (b) at full width: the
   offline path, 30 s + 5 s, 25 steps, cold, warm and synchronised (450 K1,
   0 K2, 0 K3); the block program's graph replay against eager, alternating;
   ``python -m seedvc_tpu_torch.apps.stream_bench`` (20 blocks of 0.25 s, 10
   steps; 90 K1 captured a block, 0 K2, 0 K3, 20 replays; block 0 within
   the steady spread); ``python -m seedvc_tpu_torch.apps.realtime --simulate`` on a
   written 10 s wav (length and finiteness of its output);
9. v2 (HuBERT -> ASTRAL tokens, the batched AR decode, DiTV2 with 3-way CFG,
   BigVGAN 22 kHz): (a) a reduced ``V2Config`` in f32, cuda (kernels, the AR
   decode as a CUDA graph) against cpu (plain twins), same weights, CFM
   noise and AR draws: HuBERT features, narrow and wide token indices (equal
   wherever every projected bit clears 1e-4), the AR's tokens (equal, or the
   first divergence at a near tie of probs/q), the waves of
   ``convert_timbre`` and ``convert_voice``; then the AR decode by graph
   replay against the same step run eagerly on the card (tokens equal);
   (b) ``V2Config()`` at full width, random weights: ``convert_timbre`` on
   20 s + 5 s, 30 steps, both rates 0.7, cold, warm and synchronised (one
   chunk at T = 2560: 390 K1, 109 K2, 0 K3); ``convert_voice`` on the same
   clip with the AR decoded by graph replay, eagerly, and by graph again
   (token counts, decode steps, replays, ms a token, plan; chunks x 390 K1
   and chunks x 109 K2; each AR decode kernel counted by its wrapper: 12
   (the head 1) times the steps run eagerly, and one capture); ``python -m
   seedvc_tpu_torch.apps.infer_v2`` on written wavs (its wav's length and
   finiteness); (c) the AR decode chain's kernels (``ops/ar_decode.py``) at
   ``ARConfig()`` in bf16, at 1 and 3 rows and (attention) 1,000 and 4,000
   keys: each against its twin and timed beside its twin, ``F.linear`` of
   its products and its bound by bytes (rows of the kernels line, their
   launches from (b)'s graphed conversion), then one decode step replayed
   from a CUDA graph, the chain (61 kernels) against the plain step;
10. training (v1 fine-tuning): (a) a reduced ``whisper_small_wavenet``
   (DiT 128 wide, 2 heads of 64, depth 3) on the same weights, batch and
   ``TrainDraws``, cuda (K1 forward, K1ᵇ backward) against cpu (twins): the
   loss and every parameter's gradient, then the parameters' change over 3
   AdamW steps with warmup and the clip active; (b) at full width,
   ``python -m seedvc_tpu_torch.apps.train`` in process on synthetic wavs
   (eight 4-12 s clips and one 29.7 s clip), B = 2: 6 f32 steps saving at 3
   and 6, a second run that resumes at 6 and trains to 9, 3 steps with
   ``--compute-dtype bfloat16`` (each step 13 K1, 13 K1ᵇ, 0 K3, a finite
   loss and grad norm; steps/s, prep and step seconds, peak device memory,
   the T of each step), 10 steps on one fixed batch and draws that must
   lower the loss, and the exported ``vc.pkl`` converted by ``VoiceConverter``
   (5 s, finite, the right length);
10b. v2 training (joint AR + CFM fine-tuning): (a) a reduced v2 trainer
   (tests/test_trainer_v2.py's tiny sizes, the DiT at 8 heads of 64) on the
   same weights, batch and ``TrainDrawsV2``, cuda (K1 f32, K1ᵇ) against cpu
   (twins): the first step's ``loss_cfm``, ``loss_ar`` and every gradient,
   the parameters after 3 steps with warmup and the global clip active;
   ``train_ar=False`` on the card (the AR branch bit for bit, no moments);
   one distillation step against a perturbed teacher; (b) at full width,
   ``python -m seedvc_tpu_torch.apps.train_v2`` in process on eight
   synthetic clips of 4-12 s, B = 2: 6 steps saving at 3 and 6, a run that
   resumes at 6 and trains to 9 (each step 13 K1, 13 K1ᵇ, 0 K3, a finite
   loss and grad norm; steps/s, prep and step seconds, peak device memory,
   each step's T), 3 steps with ``--train-cfm false`` (0 K1, 0 K1ᵇ), and 10
   steps on one fixed batch and draws that must lower the loss;
11. OpenVoice in v1 fine-tuning: the ToneColorConverter (each coupling's
   ``post`` drawn, since a zero one leaves g without effect) reduced and at
   full width, cuda against cpu on 2 s with the same weights and noise
   (``extract_se``, ``voice_conversion``, and a target embedding that must
   move the wave), the full one's ms a call on 10 s; then ``apps.train`` at
   full width on phase 10's clips with an ``openvoice.pkl`` (the batch's own
   voices shuffled) and with a ``se_db.pkl`` (8 x 256) beside it, 3 steps
   each (13 K1 f32, 13 K1ᵇ, 0 K3 and a finite loss a step; step and prep
   seconds, peak memory), and every batch of an epoch prepared synchronised:
   the perturbed content must differ from the clean, and the converter's
   share of the prep is printed;
12. the evaluation harness: WavLM-SV at full width cuda against cpu on 5 s,
   and a padded 10 s bucket with ``lengths`` against each clip unpadded; then
   ``python -m seedvc_tpu_torch.apps.eval`` in process at full width:
   whisper_small_wavenet on a 10 s and a 6 s source against a 5 s reference,
   25 steps, SECS by a random full-width WavLM-SV from a pkl (one chunk a
   conversion at context 1536: 325 K1 and 109 K2 each); the same again,
   which must convert nothing; ``--baseline openvoice`` from a pkl (no K1,
   no K2); one source with ``whisper_base_f0_44k --f0-metrics`` (425 K1,
   109 K2); seconds a conversion and of each embedding, the summary line;
12b. the web UI (``apps.webui``), the serving entry point: (a) in process,
   ``ConverterRegistry(device="cuda")`` behind ``make_server`` on a thread,
   warmed with 30 s + 5 s for vc, svc and v2 (seconds, plans and launches a
   mode: one silent conversion a plan); ``GET /``, ``/api/status`` (the three
   converters), ``/api/examples`` and one example; ``POST /api/convert`` as
   multipart wav uploads: vc and svc (pitch shift 2, auto-F0) on 30 s + 5 s
   (650 K1 / 218 K2 and 850 / 218), v2 with ``convert_style=1`` on 20 s + 5 s
   (the AR captured and replayed as a CUDA graph on the registry's device
   thread; 390 K1 and 109 K2 a chunk), 0 K3, each request's client wall, ``X-RTF``, the
   stats' wall and audio-s/s; the vc body against the same conversion called
   directly (1 LSB) and the same request again (1 LSB); ``/api/convert_stream``
   in flac and wav, its chunked
   framing parsed here, decoded to the vc body (1 LSB), its chunks and the
   time to the first audio chunk; two concurrent 10 s + 5 s requests (seeds 0
   and 1) from two client threads, each against its sequential run (1 LSB),
   the pair's wall against the sum; mp3 (400 naming ffmpeg before any header
   without ``ffmpeg``, else 200 ``audio/mpeg``) and a request without the
   reference (400); (b) ``python -m seedvc_tpu_torch.apps.webui --warm 10:5
   --warm-modes vc`` as a subprocess on a free port: its ``warmed`` and
   ``serving on`` lines within a bounded wait, ``/api/status``, one 10 s +
   5 s conversion, then it is terminated;
12c. checkpoints, the reference's files into the port without JAX: the
   full-width ``whisper_small_wavenet`` models, the v2 stack, RMVPE and HiFT
   from seed 0, written in the reference's layout under the zoo's file names
   (``tests/torch_ref_checkpoints.py``: the DiT ``.pth`` with a ``net`` and a
   differing ``ema``, CAMPPlus's ``.bin``, BigVGAN's ``{'generator'}``,
   Whisper's ``model.safetensors``, the v2 CFM and AR ``.pth``, ASTRAL,
   HuBERT with ``weight_g`` / ``weight_v``), converted by ``python -m
   seedvc_tpu_torch.apps.convert_checkpoint`` in four processes at once (v1;
   ``--use-ema --hift``; v2 with ``--rmvpe``; a ``.pth`` with a key
   deleted, which must exit non-zero naming it); every ``.pkl`` against the
   exported tree (equal, a folded weight norm's kernel to 1e-6 of its
   largest value); ``python -m seedvc_tpu_torch.apps.infer --checkpoint-dir``
   on 30 s + 5 s against a converter given the same files' trees in memory
   (1 LSB; 650 K1, 218 K2), and again after one DiT weight was changed in the
   ``.pth`` (the wave must move); v2's ``convert_timbre`` on 20 s + 5 s from
   ``load_v2_params`` against the in-memory trees (1 LSB; 390 K1, 109 K2);
   the seconds of the build, the writes, the CLI, the loads and the infer
   beside phase 5's;
13. multi-GPU (``parallel/*``, one process a GPU): (a) world size 1 over
   NCCL, in process under the launcher's environment (``RANK=0``,
   ``WORLD_SIZE=1``): ``apps.train --fsdp`` for 3 steps on phase 10's clips
   and seed, whose losses must equal phase 10's first three within 1e-5
   relative, then 2 steps of ``apps.train_v2 --fsdp`` (13 K1 f32 and 13 K1ᵇ a
   step); (b) two ranks on the one card over gloo with cuda tensors (this
   script started twice with ``--mg-rank``): one sharded step of the
   full-width ``whisper_small_wavenet`` model at B = 2, T = 896 on a
   (2, 1) and a (1, 2) mesh against the one-process step on the same batch
   and draws (loss, grad norm, every parameter; each rank's K1 f32 and K1ᵇ
   launches, 13 each, at (1, 8, 896, 64) and (2, 4, 896, 64)); (c) the
   CFG-sharded ``VoiceConverter`` on phase 5's 30 s + 5 s clip (each rank 650
   K1 at (1, 8, 2048, 64) and 218 K2) and v2's ``convert_timbre`` with its
   3-way stack over the 2 ranks on phase 9's clip (390 K1, at B = 2 and 1,
   and 109 K2 each), each wave against the unsharded one on the same rank;
   (d) three planted faults that (b)'s checks must catch: a contiguous (not
   head-aligned) ``wqkv`` split, a grad norm of the local pieces only, and a
   rank that draws its own rows' noise; (e) the time-sharded conversions on a
   (1, 2) mesh (``seq_shard_axis='model'``): phase 5's clip with the preset
   (each rank 650 K1 over its (2, 8, 1024 / 2048) slab, 218 K2), the same
   with ``use_flash_attention=False`` (0 K1) and v2's ``convert_timbre`` on
   phase 9's (390 K1 over (3, 8, 1281) / (3, 8, 1279), 109 K2), each wave
   against its unsharded one within one f16 step, the sampler's mels
   printed beside it, and a planted fault (every halo from a neighbour left
   zero) that the v1 comparison must catch. FSDP over two ranks does not
   run on the card (FSDP2 over gloo with cuda tensors dies with SIGSEGV);
   the CPU tests hold it;
14. the ``{"kernels": [...]}`` line: device times of kernel, plain twin and
   library call at the shapes of every path (each timed window queued behind a
   spin kernel, so the host's dispatch rate does not enter), with each
   kernel's bound on an H100 SXM; before it, K3's time per head at
   B*H = 13, 16 and 26 (its wave tail), and K2 at all six stage shapes
   (time, bound share, a device copy of the same bytes) with the card's SM
   clock, power and temperature sampled by ``nvidia-smi`` beside the windows;
   and the training rows: K1 f32 and K1ᵇ f32 / bf16 at the training run's
   largest T and its commonest other T, against SDPA's forward and SDPA's
   backward alone, the f32 bounds at 3xTF32 (3x the operations at the TF32
   peak), with the share of the bound; and the same f32 rows at the v2
   training run's largest and commonest other T, with the launches a step;
   and the eval rows: K1 at (2, 8, 1536, 64) and (2, 12, 1536, 64) and K2 at
   a 1024-frame chunk's stage shapes at 22.05 and 44.1 kHz, launches from
   phase 12; and the web UI rows: K1 and K2 at the shapes of its vc, svc and
   v2 requests (the v2 request's plan, which the AR's length sets), launches
   from phase 12b; and the checkpoint rows: K1 and K2 at phase 5's and
   phase 9's shapes, launches from phase 12c; and the multi-GPU rows: K1 at
   one CFG branch a rank (v1 B = 1, v2 B = 2 and 1), K1 over each rank's
   query slab of the time-sharded conversions (SDPA on the same slab as its
   library time), K2, and K1 f32 / K1ᵇ at the sharded steps' (2, 4, 896, 64)
   and (1, 8, 896, 64), launches from phase 13 (each rank's).

The last line is ``{"ok": true, "device": {...}}``. ``--profile`` adds one
profiled warm conversion to phases 5, 6, 8 and 9 (a ``convert_timbre`` in
9), one profiled block replay to phase 8 and one AR decode replay to phase 9
(device time by kernel, idle share), one profiled train step to phase 10
and the step's account at the training rows' two T (wall, device time, the
share of K1 and K1ᵇ), the same account of one v2 train step to phase 10b,
and times two layout choices of the real-time path (:func:`rt_layout_ab`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): dense bf16 and TF32 tensor cores, fp32
# outside the tensor cores, HBM3 bandwidth. The f32 attention kernels do each
# f32 product as three TF32 ones (3xTF32), so their bound is 3x the f32
# operations at the TF32 peak (bound_3xtf32).
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
BOUND_3XTF32 = "3xTF32: 3x the f32 operations at the 495 TFLOP/s dense TF32 peak"

# Main-path plan of a 30 s source with a 5 s reference (see plan_chunks);
# the SVC path's plan is the same at 44.1 kHz, hop 512.
MAIN_CONTEXT, MAIN_W, MAIN_CHUNKS = 2048, 1536, 2
UPSAMPLE_22K, UPSAMPLE_44K = (4, 4, 2, 2, 2, 2), (8, 4, 2, 2, 2, 2)
# K1 limits as (max abs, relative L2 norm). bf16: with unit-normal q/k/v the
# output's std is about sqrt(e/T) (0.036 at T = 2048), so the limit is set
# from the measured error (4e-3: P and the output round to bf16 after a
# running rather than a global max), not from the JAX tests' 3e-2 at T = 256;
# phase 3 checks that a planted fault (the last valid key tile dropped) fails
# it. f32: summation order only.
K1_TOL = {"bfloat16": (1e-2, 2e-2), "float32": (1e-4, 1e-4)}
K1_FAULT_KEYS = 64
# (T, lens) of phase 3: lens None, partial, a 0 entry (every key of that row
# masked: the mean of V over all T keys) and the main path's (1966, 1477)
K1_CASES = [(512, None), (512, (438, 256)), (2048, None), (2048, (1755, 1024)),
            (2048, (1966, 1477)), (2048, (0, 1966)), (2560, None), (2560, (2195, 1280)),
            (777, None), (777, (666, 388)), (777, (0, 1))]
# K1 at the SVC path's 12 heads (DiT 768 wide): its lens and a 0 entry
K1_SVC_HEADS = 12
K1_SVC_CASES = [(2048, (1966, 1493)), (2048, (0, 1966))]
# K1 at the real-time paths' 6 heads (xlsr_tiny's DiT, 384 wide) and T with
# the 2 prefix tokens: a block's (331 = 258 prompt + 71 block frames + 2,
# every key valid) and the offline chunks' (2050 = 2048 + 2; keys 430 + W + 2
# = 1968 and 1495), and a 0 entry
RT_HEADS = 6
RT_BLOCK_T, RT_OFFLINE_T = 331, 2050
K1_RT_CASES = [(RT_BLOCK_T, None), (RT_OFFLINE_T, (1968, 1968)), (RT_OFFLINE_T, (1495, 1495)),
               (RT_OFFLINE_T, (0, 1968))]
# K1 on the v2 path: the 3-way CFG stack (B = 3), 8 heads, T with the 2
# prefix tokens. A 20 s source with a 5 s reference (430 prompt frames) is
# one chunk at context 2558 (T = 2560) with 430 + 1722 + 2 = 2154 valid keys
# in every branch; a 30 s source is two chunks at context 2046 (T = 2048)
# with 1966 and 1497 keys; and a 0 entry. K2 runs at a 2046-frame chunk's
# stage shapes.
V2_T, V2_LENS, V2_W = 2560, 2154, 2046
# and a v2 T other than 2048 and 2560: context 1534 (T = 1536), every key
# valid, and partial lens with a 0 entry
K1_V2_CASES = [(V2_T, (V2_LENS,) * 3), (2048, (1966, 1497, 0)), (2048, (1497, 1497, 1497)),
               (1536, (1536, 1536, 1536)), (1536, (1290, 0, 1290))]
# Phase 13 (multi-GPU) runs these shapes on each of its two ranks: the
# sharded train steps at the training phase's 128-frame bucket T = 896, B = 2
# (f32: K1 with its log-sum-exp, and K1ᵇ), where (1, 2) keeps 4 of the 8
# heads ((2, 4, 896, 64)) and (2, 1) one of the two rows ((1, 8, 896, 64));
# the CFG-sharded conversion one CFG branch a rank (bf16 (1, 8, 2048, 64)
# with the main path's lens); the v2 3-way stack over 2 ranks, 2 rows and 1
# ((2, 8, 2560, 64), held above, and (1, 8, 2560, 64)). Partial lens, every
# key, a 0 entry beside a valid row, and (forward) one valid key: a lone row
# with 0 keys cannot fail the planted fault, which also masks every key, and
# a lone row with one key has no gradient but dv's to hold K1ᵇ against.
MG_T, MG_LENS, MG_HEADS = 896, (896, 700), 4
K1_MG_TRAIN_CASES = [(MG_T, MG_LENS, MG_HEADS), (MG_T, (0, 640), MG_HEADS),
                     (MG_T, (700,), 8), (MG_T, (MG_T,), 8)]
K1_MG_CASES = [(2048, (1966,), 8), (2048, (1477,), 8), (2048, (1,), 8), (V2_T, (V2_LENS,), 8)]


def seq_slabs(T: int, n_prefix: int = 0, ranks: int = 2) -> list:
    """Each rank's query rows (a, b) of the DiT's T + n_prefix tokens when
    the sampler splits its T time rows over ``ranks`` (ceil(T / ranks) a
    rank, the last short) and the first rank holds the prefix tokens too."""
    per, rows, start = -(-T // ranks), [], 0
    for r in range(ranks):
        n = max(0, min(per, T - r * per)) + (n_prefix if r == 0 else 0)
        rows.append((start, start + n))
        start += n
    return rows


# K1 and K3 over a query slab (phase 13's time-sharded conversions on two
# ranks): q with a rank's Tq rows, k and v with all Tk, q roped at the rows'
# global positions. v1: (2, 8, 1024 / 2048) at offsets 0 and 1024 with the
# main path's keys, a 0 entry and one valid key; v2: the 3-way stack's
# (3, 8, 1281 / 2560) with the prefix tokens on the first slab and
# (3, 8, 1279 / 2560); xlsr_tiny's 6 heads, (2, 6, 1026 / 2050), its prefix
# on the first slab. The planted fault on a slab past offset 0 is q's table
# at local positions (rows 0..Tq), which must fail the limit; on the first
# slab, where local and global positions agree, the last valid key tile
# dropped.
K1_SEQ_CASES = ([(MAIN_CONTEXT, (1966, 1966), 8, ab) for ab in seq_slabs(MAIN_CONTEXT)]
                + [(MAIN_CONTEXT, (0, 1966), 8, seq_slabs(MAIN_CONTEXT)[1]),
                   (MAIN_CONTEXT, (1, 1477), 8, seq_slabs(MAIN_CONTEXT)[1])]
                + [(RT_OFFLINE_T, (1968, 1968), RT_HEADS, ab)
                   for ab in seq_slabs(RT_OFFLINE_T - 2, 2)]
                + [(V2_T, (V2_LENS,) * 3, 8, ab) for ab in seq_slabs(V2_T - 2, 2)])
# K1 and K2 on the eval path (apps.eval in the eval phase): a 10 s and a 6 s
# source with a 5 s reference are one chunk each at context 1536 (W = 1024):
# keys 430 + 861 = 1291 and 430 + 516 = 946, and a 0 entry; at 8 heads for
# whisper_small_wavenet and 12 for whisper_base_f0_44k (the 10 s source alone
# at 44.1 kHz, hop 512: the same frames). K2 at the stage shapes of a
# 1024-frame chunk at 22.05 and at 44.1 kHz.
EVAL_T, EVAL_W, EVAL_LENS = 1536, 1024, (1291, 946)
K1_EVAL_CASES = [(EVAL_T, EVAL_LENS), (EVAL_T, (0, EVAL_LENS[0]))]
K1_EVAL_SVC_CASES = [(EVAL_T, (EVAL_LENS[0],) * 2)]
# v2 fine-tuning (apps.train_v2 in the v2-training phase): eight synthetic
# clips of 4-12 s, B = 2. The DiT's trunk sees T = the 128-frame mel bucket
# + 2 prefix tokens (T % 64 == 2: a last tile of two rows and keys) with
# mel_len + 2 valid keys. Phase 3 holds K1 f32 (with the log-sum-exp) and
# K1ᵇ f32 at the T of a (4.0 s, 4.4 s) batch and of a (12 s, 11 s) batch,
# with those lens, a 0 entry and one valid key.
V2T_CLIPS = (4.0, 4.4, 6.0, 7.0, 8.0, 10.0, 11.0, 12.0)
V2T_SR, V2T_HOP, V2T_BUCKET = 22050, 256, 128


def v2t_lens(*secs) -> tuple:
    """The K1 lens (mel frames + 2) of clips of ``secs`` seconds."""
    return tuple(int(x * V2T_SR) // V2T_HOP + 2 for x in secs)


def v2t_T(*secs) -> int:
    return -(-(max(v2t_lens(*secs)) - 2) // V2T_BUCKET) * V2T_BUCKET + 2


_V2T_A, _V2T_B = v2t_lens(4.0, 4.4), v2t_lens(12.0, 11.0)
K1_V2T_CASES = [(v2t_T(4.0, 4.4), _V2T_A), (v2t_T(4.0, 4.4), (0, _V2T_A[0])),
                (v2t_T(4.0, 4.4), (_V2T_A[1], 1)), (v2t_T(12.0, 11.0), _V2T_B),
                (v2t_T(12.0, 11.0), (0, _V2T_B[0])), (v2t_T(12.0, 11.0), (_V2T_B[0], 1))]
# K2: fp32 FIR sums in another order than cuDNN's, and sin^2 by a polynomial
# (|err| <= 2e-7) where the twin calls sin. The planted fault is the twin with
# one tap of the 12-tap filter nudged by 1e-4 (of 0.443), which must fail it.
K2_TOL = 2e-5
K2_FAULT_TAP = 1e-4
K2_TILE = 1016  # outputs a block (TT in anti_alias.cu)
# fp32 operations per output as the kernel computes them (an FMA is two):
# 12 up-FIR and 12 down-FIR FMAs (48), and per phase (u0, u1) alpha*u, the
# rounding FFMA and FADD, two Cody-Waite FFMAs, z*z, 7 Horner FFMAs and the
# final FFMA (25 each, 50).
K2_FLOPS = 98
# K1ᵇ, the backward of K1 and K3, against autograd through the twin: f32 by
# its relative L2 norm and its max abs error over the largest gradient
# (summation order only), bf16 by its relative L2 norm. Set at 1e-5 / 1e-4
# and 2e-2, then tightened from the measured worst (NVIDIA H100 80GB HBM3,
# 700 W: f32 3.4e-7 / 5.4e-7, bf16 1.13e-3) to about 5x it. The planted fault is
# the twin's gradient with the last valid key tile (64 keys) dropped from dk
# and dv, which must fail them. Cases: the training path's T = 896 (10 s
# clips, 128-frame buckets) and T = 2560 (a 29.7 s clip), and a ragged
# T = 777; lens None, a 0 entry (every key masked: dv the mean of dO), a
# single valid key, and partial.
K1B_TOL = {"float32": (2e-6, 5e-6), "bfloat16": (5e-3, None)}
K1B_CASES = [(896, None), (896, (0, 896)), (896, (896, 1)), (896, (815, 896)),
             (2560, None), (2560, (0, 2558)), (2560, (2558, 1)), (2560, (2476, 2558)),
             (777, None), (777, (0, 700)), (777, (700, 1))]


def k2_cases() -> list:
    """((B, C, T), kind) of phase 3: the main path's stage shapes, then the
    kernel's corners: T % 4 != 0 (the scalar load path), T of one tile and one
    tile +- 1, two tiles + 1, T < 4 and T = 1 (both edge patches in one tile),
    B = 2, ``logscale=False``, and a large alpha (see ``k2_inputs``)."""
    corners = [(1, 24, 3001), (1, 24, K2_TILE), (1, 24, K2_TILE - 1), (1, 24, K2_TILE + 1),
               (1, 8, 2 * K2_TILE + 1), (1, 24, 3), (1, 48, 7), (1, 8, 1), (2, 96, 1000),
               (2, 24, 3001)]
    return ([(s, "default") for s in stage_shapes(UPSAMPLE_22K) + stage_shapes(UPSAMPLE_44K)
             + stage_shapes(UPSAMPLE_22K, V2_W) + stage_shapes(UPSAMPLE_22K, EVAL_W)
             + stage_shapes(UPSAMPLE_44K, EVAL_W) + corners]
            + [((1, 32, 1001), "linear"), ((2, 16, 4096), "linear"),
               ((1, 24, 4099), "large_alpha"), ((1, 96, 24576), "large_alpha")])


def k2_inputs(shape, kind: str, g):
    """x, alpha, beta, logscale for one case. "default": x ~ N(0, 1), log
    alpha and log beta ~ 0.3 N(0, 1). "linear": alpha and beta |N(0, 1)| + 0.5,
    logscale off. "large_alpha": x ~ 2 N(0, 1) and log alpha ~ 3 + 0.3 N(0, 1),
    so |alpha u| reaches a few hundred (the range reduction of sin^2); log
    beta ~ 2.5 + 0.3 N(0, 1) keeps the function's own gain 1 + alpha / e^beta on
    u's rounding, which differs with the summation order, within the limit."""
    import torch

    B, C, T = shape
    x = torch.randn(shape, generator=g, device="cuda")
    a, b = (torch.randn(C, generator=g, device="cuda") for _ in range(2))
    if kind == "linear":
        return x, a.abs() + 0.5, b.abs() + 0.5, False
    if kind == "large_alpha":
        return 2 * x, 3 + 0.3 * a, 2.5 + 0.3 * b, True
    return x, 0.3 * a, 0.3 * b, True


@contextlib.contextmanager
def nudged_tap(delta: float):
    """The plain twin's 12-tap filter with tap 5 nudged by ``delta``."""
    from seedvc_tpu_torch.ops import anti_alias

    saved = anti_alias._filter

    def nudged(*args, **kwargs):
        f = saved(*args, **kwargs).clone()
        f[5] += delta
        return f

    anti_alias._filter = nudged
    try:
        yield
    finally:
        anti_alias._filter = saved


def device_kernels(fn) -> int:
    """Device kernels that one call of ``fn`` runs (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    log(f"FAILED: {msg}")
    sys.exit(1)


def bound(ops: float, peak_ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def bound_3xtf32(ops: float, nbytes: float) -> tuple[float, str]:
    """The bound of an f32 attention kernel: its f32 operations, each done
    as three TF32 products on the tensor cores, at the TF32 peak."""
    return bound(3 * ops, PEAK_TF32, nbytes)


# ---------------------------------------------------------------------------
def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(card)
    # fp32 everywhere the JAX package asks for Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from seedvc_tpu_torch.ops import build

    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source {secs}")
    for name, text in build.PTXAS_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "Performance Loss")):
                log(f"  ptxas[{name}]: {line.strip()}")
    tf32_kernels = []
    for name in build.SOURCES:
        build.load_library(name)
        for fn, (total, ops, mma) in sass_summary(build.library_path(name)).items():
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common(14))
            log(f"  sass[{name}] {fn}: {total} instructions; {top}; tensor-core ops {dict(mma)}")
            if any(k in fn for k in F32_MMA_KERNELS):
                tf32_kernels.append(fn)
                if not any("TF32" in op for op in mma):
                    fail(f"phase 2: {fn} runs no TF32 tensor-core instruction")
    if tf32_kernels:
        log(f"  sass: TF32 HMMA in every f32 attention kernel ({len(tf32_kernels)} kernels)")


# the f32 attention kernels must run on the tensor cores (HMMA with TF32)
F32_MMA_KERNELS = ("attn_fwd_tf32", "bwd_dkdv_kernel")


def sass_summary(path) -> dict:
    """{kernel: (instruction count, Counter of opcodes, Counter of the
    tensor-core opcodes in full, e.g. HMMA.1688.F32.TF32)} of a built
    library's SASS (``cuobjdump -sass``); empty if cuobjdump is missing."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True).stdout
    kernels, mma, fn = {}, {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            kernels[fn], mma[fn] = collections.Counter(), collections.Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and ins:
            op = ins.group(1)
            kernels[fn][op.split(".")[0]] += 1
            if op.split(".")[0] in ("HMMA", "HGMMA"):
                mma[fn][op] += 1
    return {f: (sum(c.values()), c, mma[f]) for f, c in kernels.items()}


def _k1_inputs(T, dtype, lens, seed=0, heads=8, B=2):
    """q, k, v (B, heads, T, 64) with B = len(lens) (``B`` without lens)."""
    import torch

    from seedvc_tpu_torch.nn.layers import rope_full_cache

    g = torch.Generator(device="cuda").manual_seed(seed)
    B = B if lens is None else len(lens)
    q, k, v = (torch.randn((B, heads, T, 64), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, cos, sin, lens_t


def k1_errors(out, ref) -> tuple[float, float]:
    """(max abs, relative L2 norm) of out against ref."""
    diff = out.float() - ref.float()
    return diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()


def phase_kernels() -> dict:
    import torch

    from seedvc_tpu_torch.ops import anti_alias, attention

    errs = {"k1": 0.0, "k1_svc": 0.0, "k1_rt": 0.0, "k1_v2": 0.0, "k1_eval": 0.0,
            "k1_eval_svc": 0.0, "k1_mg": 0.0, "k2": 0.0, "k2_svc": 0.0, "k2_v2": 0.0,
            "k2_eval": 0.0, "k2_eval_svc": 0.0, "k3": 0.0}
    slots = {8: "", K1_SVC_HEADS: "_svc", RT_HEADS: "_rt", "v2": "_v2", "eval": "_eval",
             "eval_svc": "_eval_svc", "mg": "_mg"}
    heads_of = {"v2": 8, "v2t": 8, "eval": 8, "eval_svc": K1_SVC_HEADS, "mg": 8,
                ("mgt", 8): 8, ("mgt", MG_HEADS): MG_HEADS}
    f32_only = ("v2t", ("mgt", 8), ("mgt", MG_HEADS))  # training shapes: f32, as they run
    # K1's first stage: roped q times 2^-3 and roped k, bit for bit
    for T in (2048, 777):
        q, k, _, cos, sin, _ = _k1_inputs(T, torch.bfloat16, None, seed=3)
        qo, ko = attention.rope_prepass(q, k, cos, sin)
        same = (torch.equal(qo, attention.rope_scaled_reference(q, cos, sin, 0.125))
                and torch.equal(ko, attention.rope_scaled_reference(k, cos, sin)))
        log(f"K1 rope pre-pass (2,8,{T},64) bf16: equal to its plain twin: {same}")
        if not same:
            fail(f"K1's RoPE pre-pass differs from its plain twin at T={T}")
    # K1 and K3 share one source (RoPE on / off) and one set of limits
    for key, rope, kernel, twin in (
            ("k1", True, attention.dit_attention_fused, attention.dit_attention_fused_reference),
            ("k3", False, attention.dit_attention, attention.dit_attention_reference)):
        cases = [(T, lens, 8) for T, lens in K1_CASES]
        if rope:
            cases += [(T, lens, K1_SVC_HEADS) for T, lens in K1_SVC_CASES]
            cases += [(T, lens, RT_HEADS) for T, lens in K1_RT_CASES]
            cases += [(T, lens, "v2") for T, lens in K1_V2_CASES]
            cases += [(T, lens, "v2t") for T, lens in K1_V2T_CASES]
            cases += [(T, lens, "eval") for T, lens in K1_EVAL_CASES]
            cases += [(T, lens, "eval_svc") for T, lens in K1_EVAL_SVC_CASES]
            cases += [(T, lens, "mg") for T, lens, _ in K1_MG_CASES]
            cases += [(T, lens, ("mgt", h)) for T, lens, h in K1_MG_TRAIN_CASES]
        for dtype in (torch.bfloat16, torch.float32):
            atol, rtol = K1_TOL[str(dtype).split(".")[1]]
            for T, lens, slot_heads in cases:
                if slot_heads in f32_only and dtype != torch.float32:
                    continue  # the trainers' shapes: f32 only, as they run them
                heads = heads_of.get(slot_heads, slot_heads)
                q, k, v, cos, sin, lens_t = _k1_inputs(T, dtype, lens, heads=heads)
                args = (q, k, v, cos, sin) if rope else (q, k, v)
                f32 = dtype == torch.float32
                out, lse = kernel(*args, lens_t, return_lse=True)
                ref = twin(*args, lens_t)
                # planted fault: the twin with the last valid key tile dropped
                n_valid = lens_t if lens_t is not None else torch.full(
                    (q.shape[0],), T, dtype=torch.int32, device="cuda")
                bad = twin(*args, n_valid - K1_FAULT_KEYS)
                err, rel = k1_errors(out, ref)
                f_err, f_rel = k1_errors(bad, ref)
                what = (f"{key.upper()} {kernel.__name__} {tuple(q.shape)} {dtype} "
                        f"lens={lens}")
                log(f"{what}: max_abs_err {err:.3e} tol {atol:g}, rel_l2 {rel:.3e} "
                    f"tol {rtol:g}; planted fault max_abs {f_err:.3e} rel_l2 {f_rel:.3e}")
                if not (err <= atol and rel <= rtol):
                    fail(f"{what}: kernel disagrees with its plain twin")
                if f_err <= atol and f_rel <= rtol:
                    fail(f"{what}: the limit passes a planted fault")
                if f32:
                    lse_check(what, q, k, v, cos, sin, lens_t, lse, ref, rope)
                if dtype == torch.bfloat16:
                    slot = key + slots[slot_heads]
                    errs[slot] = max(errs[slot], err)
    errs["k1_seq"] = seq_slab_checks()
    attention_module_check()
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape, kind in k2_cases():
        x, alpha, beta, logscale = k2_inputs(shape, kind, g)
        out = anti_alias.anti_alias_snake(x, alpha, beta, logscale)
        ref = anti_alias.anti_alias_snake_reference(x, alpha, beta, logscale)
        with nudged_tap(K2_FAULT_TAP):
            bad = anti_alias.anti_alias_snake_reference(x, alpha, beta, logscale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        f_err = (bad - ref).abs().max().item()
        what = f"K2 anti_alias_snake {shape} f32 {kind}"
        log(f"{what}: max_abs_err {err:.3e} tol {K2_TOL:g}; planted fault max_abs {f_err:.3e}")
        if not err <= K2_TOL:
            fail(f"{what}: kernel disagrees with its plain twin")
        if f_err <= K2_TOL:
            fail(f"{what}: the limit passes a planted fault")
        slot = ("k2_svc" if shape in stage_shapes(UPSAMPLE_44K)
                else "k2_v2" if shape in stage_shapes(UPSAMPLE_22K, V2_W)
                else "k2_eval" if shape in stage_shapes(UPSAMPLE_22K, EVAL_W)
                else "k2_eval_svc" if shape in stage_shapes(UPSAMPLE_44K, EVAL_W) else "k2")
        errs[slot] = max(errs[slot], err)
    n = device_kernels(lambda: anti_alias.anti_alias_snake(x, alpha, beta, logscale))
    log(f"K2: one call ran {n} device kernel(s)")
    if n != 1:
        fail(f"one K2 call ran {n} device kernels, expected 1")
    return errs


def seq_slab_checks() -> float:
    """Phase 3's slab cases (K1_SEQ_CASES): K1 and K3, bf16 and f32, each
    against its twin on the same slab within K1's limits, with its planted
    fault; K1 f32's log-sum-exp against the twin's. Returns the worst bf16
    K1 max abs error."""
    import torch

    from seedvc_tpu_torch.ops import attention

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = K1_TOL[str(dtype).split(".")[1]]
        for Tk, lens, heads, (a, b) in K1_SEQ_CASES:
            q, k, v, cos, sin, lens_t = _k1_inputs(Tk, dtype, lens, seed=5, heads=heads)
            qs = q[:, :, a:b].contiguous()
            q_rope = (cos[a:b], sin[a:b])
            for key, kernel, twin, args, fault_args in (
                    ("K1", attention.dit_attention_fused, attention.dit_attention_fused_reference,
                     (qs, k, v, cos, sin, lens_t), (q_rope,)),
                    ("K3", attention.dit_attention, attention.dit_attention_reference,
                     (attention.rope_scaled_reference(qs, *q_rope),
                      attention.rope_scaled_reference(k, cos, sin), v, lens_t), ())):
                kw = {"q_rope": q_rope} if key == "K1" else {}
                out, lse = kernel(*args, return_lse=True, **kw)
                ref = twin(*args, *fault_args)
                if key == "K1" and a > 0:  # q roped at local positions
                    fault, bad = "q table at local positions", twin(*args, (cos[: b - a],
                                                                            sin[: b - a]))
                else:  # the last valid key tile dropped
                    fault = "last valid key tile dropped"
                    bad = twin(*args[:-1], lens_t - K1_FAULT_KEYS, *fault_args)
                err, rel = k1_errors(out, ref)
                f_err, f_rel = k1_errors(bad, ref)
                what = (f"{key} slab q rows {a}:{b} of {Tk}, q {tuple(qs.shape)} k/v "
                        f"{tuple(k.shape)} {dtype} lens={lens}")
                log(f"{what}: max_abs_err {err:.3e} tol {atol:g}, rel_l2 {rel:.3e} tol {rtol:g}; "
                    f"planted fault ({fault}) max_abs {f_err:.3e} rel_l2 {f_rel:.3e}")
                if not (err <= atol and rel <= rtol):
                    fail(f"{what}: kernel disagrees with its plain twin")
                if f_err <= atol and f_rel <= rtol:
                    fail(f"{what}: the limit passes a planted fault")
                if dtype == torch.float32:
                    lse_ref = attention.dit_attention_lse_reference(
                        *((attention.rope_scaled_reference(qs, *q_rope),
                           attention.rope_scaled_reference(k, cos, sin)) if key == "K1"
                          else args[:2]), lens_t)
                    lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item()
                    log(f"{what}: lse rel err {lse_err:.3e} tol {LSE_RTOL:g}")
                    if not lse_err <= LSE_RTOL:
                        fail(f"{what}: the kernel's log-sum-exp disagrees with the twin's")
                elif key == "K1":
                    worst = max(worst, err)
    return worst


# The f32 kernel's row log-sum-exp (kept for K1ᵇ) against the plain one of
# the twin's logits: 1e-5 of max(1, |lse|) (logits from 3xTF32 products,
# exp2 and log in f32; with one valid key lse is that key's logit, which can
# lie near 0); -1e30 where no key is valid.
LSE_RTOL = 1e-5


def masked_sdpa_inputs(q, k, cos, sin, lens, rope: bool):
    """q, k as SDPA takes them (roped for K1) and the twin's mask as an
    additive -1e30 bias (B, 1, 1, T), or None."""
    import torch

    from seedvc_tpu_torch.ops import attention

    if rope:
        q, k = (attention.rope_scaled_reference(x, cos, sin) for x in (q, k))
    if lens is None:
        return q, k, None
    T = q.shape[2]
    keep = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    bias = torch.zeros(keep.shape, dtype=q.dtype, device=q.device).masked_fill(~keep, -1e30)
    return q, k, bias[:, None, None, :]


def lse_check(what, q, k, v, cos, sin, lens, lse, ref, rope: bool):
    """The f32 kernel's log-sum-exp against the twin's; SDPA's own f32 error
    against the twin (ref) is printed beside it, as a yardstick."""
    import torch.nn.functional as F

    from seedvc_tpu_torch.ops import attention

    qr, kr, bias = masked_sdpa_inputs(q, k, cos, sin, lens, rope)
    lse_ref = attention.dit_attention_lse_reference(qr, kr, lens)
    lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item()
    s_err, s_rel = k1_errors(F.scaled_dot_product_attention(qr, kr, v, attn_mask=bias), ref)
    log(f"{what}: lse rel err {lse_err:.3e} tol {LSE_RTOL:g}; yardstick: SDPA f32 against "
        f"the twin max_abs_err {s_err:.3e}, rel_l2 {s_rel:.3e}")
    if not lse_err <= LSE_RTOL:
        fail(f"{what}: the kernel's log-sum-exp disagrees with the twin's")


def bwd_errors(got, ref) -> tuple[float, float]:
    """(relative L2 norm, max abs error over the reference's max abs) of a
    (dq, dk, dv) triple, the worst of the three."""
    rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
              for a, b in zip(got, ref))
    mx = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
             for a, b in zip(got, ref))
    return rel, mx


def phase_kernels_bwd() -> dict:
    """K1ᵇ (RoPE on: K1's backward; off: K3's) against autograd through the
    twins at K1B_CASES, f32 and bf16, each with its planted fault: given the
    forward's log-sum-exp, as the autograd Functions call it, and (f32)
    computing the statistics itself. A batch row with one valid key must
    have dq = dk = 0 and dv = 0 past key 0 exactly. SDPA's own backward
    error against the twin is printed beside K3's f32 cases as a yardstick,
    and one case runs twice: dq is summed by atomics. Returns the worst
    relative L2 and max abs error by dtype."""
    import torch
    import torch.nn.functional as F

    from seedvc_tpu_torch.ops import attention

    def run(rope, q, k, v, cos, sin, lens_t, g, with_lse=True):
        if rope:
            o, lse = attention.dit_attention_fused(q, k, v, cos, sin, lens_t, return_lse=True)
            return attention.dit_attention_fused_bwd(q, k, v, cos, sin, lens_t, o, g,
                                                     lse if with_lse else None)
        o, lse = attention.dit_attention(q, k, v, lens_t, return_lse=True)
        return attention.dit_attention_bwd(q, k, v, lens_t, o, g, lse if with_lse else None)

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        rel_tol, max_tol = K1B_TOL[name]
        worst = [0.0, 0.0, 0.0]  # rel L2, max abs over max|ref|, max abs
        # the trainers' other shapes in f32, as they run them: the v2
        # trainer's, and the multi-GPU steps' (4 heads, or one row)
        cases = [(T, lens, 8) for T, lens in K1B_CASES]
        if dtype == torch.float32:
            cases += [(T, lens, 8) for T, lens in K1_V2T_CASES] + K1_MG_TRAIN_CASES
        for rope in (True, False):
            for T, lens, heads in cases:
                q, k, v, cos, sin, lens_t = _k1_inputs(T, dtype, lens, seed=T + 5, heads=heads)
                g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(T),
                                device="cuda").to(dtype)
                if rope:
                    ref = attention.dit_attention_fused_bwd_reference(q, k, v, cos, sin, lens_t, g)
                else:
                    ref = attention.dit_attention_bwd_reference(q, k, v, lens_t, g)
                # planted fault: the last valid key tile dropped from dk and dv
                bad = [t.clone() for t in ref]
                for b in range(q.shape[0]):
                    n = T if lens is None or lens[b] <= 0 else min(lens[b], T)
                    for t in bad[1:]:
                        t[b, :, max(n - K1_FAULT_KEYS, 0):n] = 0
                f_rel, f_mx = bwd_errors(bad, ref)
                what = f"K1b {'K1' if rope else 'K3'} {tuple(q.shape)} {name} lens={lens}"
                if f_rel <= rel_tol and (max_tol is None or f_mx <= max_tol):
                    fail(f"{what}: the limit passes a planted fault")
                calls = ([("lse", True), ("own stats", False)] if dtype == torch.float32
                         else [("own stats: the bf16 core writes no lse", True)])
                for how, with_lse in calls:
                    got = run(rope, q, k, v, cos, sin, lens_t, g, with_lse)
                    torch.cuda.synchronize()
                    rel, mx = bwd_errors(got, ref)
                    abs_err = max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, ref))
                    log(f"{what} ({how}): rel_l2 {rel:.3e} tol {rel_tol:g}, max_abs/max|ref| "
                        f"{mx:.3e} tol {max_tol}; planted fault rel_l2 {f_rel:.3e} max {f_mx:.3e}")
                    if not (rel <= rel_tol and (max_tol is None or mx <= max_tol)):
                        fail(f"{what} ({how}): K1b disagrees with autograd through the twin")
                    for b in range(q.shape[0]):
                        if lens is not None and lens[b] == 1 and (
                                got[0][b].any() or got[1][b].any() or got[2][b, :, 1:].any()):
                            fail(f"{what} ({how}): batch row {b} has one valid key, but dq, dk "
                                 "or dv past key 0 is not exactly 0")
                    worst = [max(worst[0], rel), max(worst[1], mx), max(worst[2], abs_err)]
                if dtype == torch.float32 and not rope and not (lens and min(lens) <= 0):
                    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                    _, _, bias = masked_sdpa_inputs(q, k, None, None, lens_t, False)
                    lib = torch.autograd.grad(
                        F.scaled_dot_product_attention(*leaves, attn_mask=bias), leaves, g)
                    s_rel, s_mx = bwd_errors(lib, ref)
                    log(f"{what}: yardstick: SDPA's f32 backward against the twin rel_l2 "
                        f"{s_rel:.3e}, max_abs/max|ref| {s_mx:.3e}")
        errs[name] = worst
    # dq is added up by atomics: the same call twice
    q, k, v, cos, sin, _ = _k1_inputs(2560, torch.float32, None, seed=99)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(99),
                    device="cuda")
    first, second = (run(True, q, k, v, cos, sin, None, g) for _ in range(2))
    torch.cuda.synchronize()
    dq_diff = (first[0] - second[0]).abs().max().item()
    same_kv = torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    log(f"K1b atomics repeat (2, 8, 2560, 64) f32: dq max abs difference {dq_diff:.3e} "
        f"(rel_l2 {((first[0] - second[0]).norm() / first[0].norm()).item():.3e}), "
        f"dk and dv bit for bit: {same_kv}")
    if not same_kv or dq_diff > 1e-6 * first[0].abs().max().item():
        fail("K1b: two runs on the same inputs differ beyond dq's atomic order")
    return errs


def attention_module_check(T: int = 777):
    """``Attention(use_flash=True)`` at a T that is no multiple of 512 takes
    K1 (heads not grouped, rope_full given) or K3 (2 KV heads for 8 query
    heads), once, and agrees with the same module through the plain twins;
    f32, K1's f32 limits."""
    import torch

    from seedvc_tpu_torch.nn.layers import Attention, rope_cache, rope_full_cache

    atol, rtol = K1_TOL["float32"]
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((2, T, 512), generator=g, device="cuda")
    freqs = torch.from_numpy(rope_cache(T, 64)).cuda()
    lens = torch.tensor([T - T // 7, T // 2], dtype=torch.int32, device="cuda")
    for n_kv, key in ((None, "k1"), (2, "k3")):
        torch.manual_seed(0)
        m = Attention(512, 8, n_local_heads=n_kv, use_flash=True).cuda()
        rope_full = None if n_kv else tuple(torch.from_numpy(a).cuda()
                                            for a in rope_full_cache(T, 64))
        reset_counts()
        with torch.no_grad():
            out = m(x, freqs, lens, rope_full)
            counts = read_counts()
            with plain_twins():
                ref = m(x, freqs, lens, rope_full)
        err, rel = k1_errors(out, ref)
        expect = {"k1": 0, "k2": 0, "k3": 0, key: 1}
        log(f"Attention(use_flash) T={T} {n_kv or 8} KV heads f32: launches {counts}, "
            f"max_abs_err {err:.3e} tol {atol:g}, rel_l2 {rel:.3e} tol {rtol:g}")
        if counts != expect:
            fail(f"Attention at T={T}: launches {counts}, expected {expect}")
        if not (err <= atol and rel <= rtol):
            fail(f"Attention at T={T}: kernels and plain twins disagree")


def stage_shapes(rates, W: int = MAIN_W):
    """BigVGAN stage shapes (1, C, T_s) of one W-frame chunk."""
    shapes, T = [], W
    for i, u in enumerate(rates):
        T *= u
        shapes.append((1, 1536 // 2 ** (i + 1), T))
    return shapes


def synthetic_audio(seconds: float, sr: int, f0: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    vib = f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))
    wave = 0.3 * np.sin(2 * np.pi * np.cumsum(vib) / sr) + 0.1 * np.sin(2 * np.pi * 3 * vib * t)
    return (wave + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def reset_counts():
    from seedvc_tpu_torch.ops import anti_alias, ar_decode, attention

    attention.LAUNCHES = 0
    attention.DIT_ATTENTION_LAUNCHES = 0
    attention.BWD_LAUNCHES = 0
    anti_alias.LAUNCHES = 0
    ar_decode.reset_counts()


def read_counts() -> dict:
    """K1, K2, K3, and each AR decode kernel that launched (``ar_<kernel>``):
    a path that runs no AR compares as ``{"k1", "k2", "k3"}`` and fails its
    check if it launches one."""
    from seedvc_tpu_torch.ops import anti_alias, ar_decode, attention

    return {"k1": attention.LAUNCHES, "k2": anti_alias.LAUNCHES,
            "k3": attention.DIT_ATTENTION_LAUNCHES,
            **{f"ar_{k}": n for k, n in ar_decode.KERNEL_LAUNCHES.items() if n}}


def check_ar_counts(what: str, counts: dict, gen, n_layer: int, steps: int) -> dict:
    """The AR decode kernels' counts of one ``ARGenerator.generate`` of
    ``steps`` decode steps: every step run eagerly launches each layer's
    kernel once a layer and the head once, a capture counts what one replay
    launches, a replay calls no wrapper. Returns each kernel's launches on
    the device (the counted ones, less the capture's, plus the replays')."""
    from seedvc_tpu_torch.ops import ar_decode

    per_step = {k: 1 if k == "head" else n_layer for k in ar_decode.KERNELS}
    counted = {k: counts.get(f"ar_{k}", 0) for k in ar_decode.KERNELS}
    wrapped = steps - gen.replays + gen.captures  # steps run eagerly, and the capture
    if counted != {k: n * wrapped for k, n in per_step.items()}:
        fail(f"{what}: AR decode kernel launches {counted}, expected {per_step} times "
             f"{wrapped} ({steps} steps, {gen.replays} replays, {gen.captures} captures)")
    if gen.captures and gen.fused_launches != sum(per_step.values()):
        fail(f"{what}: {gen.fused_launches} decode kernels a replay, expected "
             f"{sum(per_step.values())}")
    return {k: counted[k] + per_step[k] * (gen.replays - gen.captures) for k in counted}


SMALL_TOL = 2e-3  # f16 output wave: one f16 step near 1.0 is 4.9e-4


def small_converter(device: str, dtype=None, kv_heads=None, f0: bool = False):
    """The small v1 converter, flash attention on (K1; the einsum path runs
    no kernel). With ``kv_heads`` its DiT has 4 query heads of 64 and a trunk
    with that many KV heads, so its attention takes K3. With ``f0`` it is
    F0-conditioned (256 F0 bins) and its RMVPE is :func:`reduced_rmvpe`."""
    import dataclasses

    import torch

    from seedvc_tpu_torch.core import config as c
    from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
    from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
    from seedvc_tpu_torch.nn.transformer import Transformer
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    heads = 2 if kv_heads is None else 4
    cfg = c.SeedVCConfig(model_params=c.ModelParams(
        length_regulator=c.LengthRegulatorConfig(channels=128, in_channels=64,
                                                 sampling_ratios=(1, 1), f0_condition=f0,
                                                 n_f0_bins=256),
        DiT=c.DiTConfig(hidden_dim=64 * heads, num_heads=heads, depth=3, content_dim=128,
                        final_layer_type="wavenet", use_flash_attention=True,
                        f0_condition=f0, n_f0_bins=256),
        wavenet=c.WavenetConfig(hidden_dim=64, num_layers=2)))
    vc = VoiceConverter(
        cfg, whisper_cfg=WhisperEncoderConfig(d_model=64, n_layers=1, n_heads=4, ffn_dim=128),
        vocoder_cfg=BigVGANConfig(upsample_initial_channel=128, resblock_kernel_sizes=(3,),
                                  resblock_dilation_sizes=((1, 3),)),
        prompt_cap_frames=128, context_frames=512,
        compute_dtype=torch.float32 if dtype is None else dtype, seed=0, device=device)
    if kv_heads is not None:
        dit = vc.vc.cfm.estimator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            trunk = Transformer(dataclasses.replace(dit.transformer.cfg, n_local_heads=kv_heads))
        dit.transformer = trunk.requires_grad_(False).eval().to(vc.device, vc.compute_dtype)
    if f0:
        vc.rmvpe = reduced_rmvpe(device)
    return vc


RMVPE_SMALL = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4)


def reduced_rmvpe(device: str):
    """A reduced RMVPE from seed 0 whose output layer has one clear peak
    (bias -4 + 8 exp(-((bin - 150) / 2)^2), input weights scaled by 0.3), so
    that no frame's argmax sits within f32 rounding of a runner-up and the
    cuda and cpu runs decode the same bins."""
    import torch

    from seedvc_tpu_torch.models.rmvpe import RMVPE, RMVPE_E2E

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        m = RMVPE_E2E(**RMVPE_SMALL)
    with torch.no_grad():
        m.fc_linear.weight.mul_(0.3)
        bins = torch.arange(360, dtype=torch.float32)
        m.fc_linear.bias.copy_(-4 + 8 * torch.exp(-((bins - 150) / 2) ** 2))
    return RMVPE(m.requires_grad_(False).eval().to(device))


@contextlib.contextmanager
def plain_twins():
    """Route the model's kernel calls to the plain twins (on any device)."""
    from seedvc_tpu_torch.nn import layers, snake
    from seedvc_tpu_torch.ops import anti_alias, attention

    saved = layers.dit_attention_fused, layers.dit_attention, snake.anti_alias_snake
    layers.dit_attention_fused = attention.dit_attention_fused_reference
    layers.dit_attention = attention.dit_attention_reference
    snake.anti_alias_snake = anti_alias.anti_alias_snake_reference
    try:
        yield
    finally:
        layers.dit_attention_fused, layers.dit_attention, snake.anti_alias_snake = saved


def compare_waves(what: str, a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    if a.shape != b.shape or not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail(f"{what}: shapes {a.shape} vs {b.shape} or non-finite output")
    err = float(np.abs(a - b).max())
    snr = 10 * np.log10(np.mean(a ** 2) / max(np.mean((a - b) ** 2), 1e-20))
    return err, snr


SMALL_STEPS, SMALL_DEPTH = 10, 3


def phase_small():
    import torch

    src = synthetic_audio(8.0, 22050, 140.0, seed=1)
    ref = synthetic_audio(1.5, 22050, 220.0, seed=2)
    noise = np.random.default_rng(3).standard_normal((512, 80)).astype(np.float32)

    def run(device, dtype=None, twins=False, kv_heads=None):
        vc = small_converter(device, dtype, kv_heads)
        reset_counts()
        with plain_twins() if twins else contextlib.nullcontext():
            _, wave, stats = vc.convert(
                src, 22050, ref, 22050, diffusion_steps=SMALL_STEPS, cfg_rate=0.7,
                noise_fn=lambda s: torch.from_numpy(noise[: s[1]][None]))
        counts = read_counts()
        log(f"small conversion on {device} {vc.compute_dtype}"
            f"{f' GQA {kv_heads} KV heads' if kv_heads else ''}"
            f"{' (plain twins)' if twins else ''}: {len(wave)} samples, "
            f"{stats['chunks']} chunks, launches {counts}")
        attn, other = ("k1", "k3") if kv_heads is None else ("k3", "k1")
        if device == "cuda" and not twins:
            expect = stats["chunks"] * SMALL_STEPS * SMALL_DEPTH
            if counts[attn] != expect or counts[other] != 0 or counts["k2"] == 0:
                fail(f"small cuda conversion launched the wrong code: {counts}, "
                     f"expected {attn} = {expect}, {other} = 0, k2 > 0")
        elif any(counts.values()):
            fail(f"small conversion through the plain twins launched kernels: {counts}")
        return wave

    err, snr = compare_waves("small f32 conversion", run("cpu"), run("cuda"))
    log(f"small f32 conversion cuda vs cpu: max_abs_err {err:.3e} tol {SMALL_TOL:g}, "
        f"SNR {snr:.1f} dB")
    if not err <= SMALL_TOL:
        fail("small conversion: cuda and cpu disagree")
    # the main path's bf16 K1 inside a conversion; at random weights attention
    # adds little to the DiT's residual stream, so this guards the call
    # (layout, masking lens, finite output), while a subtle fault such as a
    # dropped key tile is caught per kernel in phase 3
    for kv_heads in (None, 2):
        what = "small bf16" + ("" if kv_heads is None else f" GQA ({kv_heads} KV heads)")
        err, snr = compare_waves(f"{what} conversion",
                                 run("cuda", torch.bfloat16, True, kv_heads),
                                 run("cuda", torch.bfloat16, False, kv_heads))
        log(f"{what} conversion on cuda, kernels vs plain twins: max_abs_err {err:.3e} "
            f"tol {SMALL_TOL:g}, SNR {snr:.1f} dB")
        if not err <= SMALL_TOL:
            fail(f"{what} conversion: kernels and plain twins disagree")


def phase_full(card: str, profile: bool = False) -> dict:
    import torch

    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    t0 = time.perf_counter()
    vc = VoiceConverter(device="cuda")
    log(f"full: whisper_small_wavenet built in {time.perf_counter() - t0:.1f} s "
        f"(compute dtype {vc.compute_dtype})")
    sr = vc.sr
    src = synthetic_audio(30.0, sr, 140.0, seed=4)
    ref = synthetic_audio(5.0, sr, 220.0, seed=5)
    target_len = len(src) // vc.hop
    p_len = len(ref) // vc.hop
    plan = vc.plan_chunks(target_len, p_len)
    log(f"full: plan (prompt_cap, context, W) = {plan}")
    if plan[1:] != (MAIN_CONTEXT, MAIN_W):
        fail(f"unexpected plan {plan}")
    expect = {"k1": MAIN_CHUNKS * 25 * vc.cfg.dit.depth, "k2": MAIN_CHUNKS * 109, "k3": 0}
    result = {}
    # "warm" is the end-to-end number; "warm, stages synced" ends every stage
    # in a device synchronise so its stage times split the device time
    for run, synced in (("cold", False), ("warm", False), ("warm, stages synced", True)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, wave, stats = vc.convert(src, sr, ref, sr, diffusion_steps=25, cfg_rate=0.7,
                                    profile=synced)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        secs = len(wave) / sr
        log(f"full {run}: {wall:.3f} s wall for {secs:.2f} s of audio "
            f"({secs / wall:.2f} audio-s/s), {stats['chunks']} chunks, launches {counts}, "
            f"on {card}")
        log("  stages: " + json.dumps({k: round(v["seconds"], 4)
                                       for k, v in stats["stages"].items()}))
        if not np.isfinite(wave).all():
            fail("full conversion produced non-finite audio")
        if abs(secs - len(src) / sr) > 0.5:
            fail(f"full conversion length {secs:.2f} s vs source {len(src) / sr:.2f} s")
        if counts != expect:
            fail(f"launch counts {counts}, expected {expect}")
        if run == "warm":
            result = {"wall_s": wall, "audio_s": secs, "counts": counts, "p_len": p_len,
                      "W": plan[2]}
    if profile:
        profile_conversion(lambda: vc.convert(src, sr, ref, sr, diffusion_steps=25,
                                              cfg_rate=0.7), result["wall_s"])
    return result


PORT_KERNELS = ("attn_core_kernel", "rope_prepass", "attn_fwd_tf32", "bwd_prep_kernel",
                "bwd_dkdv_kernel", "bwd_finish_kernel", "anti_alias_snake_kernel")


def profile_conversion(run, warm_wall: float):
    """One more warm conversion, ``run()``, under torch.profiler: device time
    by kernel, and the device's idle share of the profiled wall and of the
    unprofiled warm wall (the profiler slows the host, so the first
    overstates it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device kernels only: user annotations span kernels and would count twice
    kernels = [e for e in avgs
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(avgs.table(sort_by="self_device_time_total", row_limit=20))
    for name in PORT_KERNELS:  # the port's own kernels, in or out of the table's top rows
        rows = [e for e in kernels if name in e.key]
        log(f"profile: {name}: {sum(e.count for e in rows)} launches, "
            f"{sum(e.self_device_time_total for e in rows) / 1e3:.3f} ms of device time")
    log(f"profile: {sum(e.count for e in kernels)} device kernels busy {busy:.3f} s; "
        f"profiled wall {wall:.3f} s (idle share {1 - busy / wall:.3f}); "
        f"unprofiled warm wall {warm_wall:.3f} s (idle share {1 - busy / warm_wall:.3f})")


# RMVPE, cuda against cpu (f32, TF32 off): the salience's max abs error, and
# decoded F0 compared (relative) on the frames whose salience peak clears
# both the 0.03 voicing threshold and the runner-up bin by RMVPE_MARGIN;
# elsewhere f32 rounding may move the argmax. At least RMVPE_CLEAR of the
# frames must be clear.
RMVPE_SAL_TOL = 1e-5
RMVPE_F0_RTOL = 1e-4
RMVPE_MARGIN = 1e-3
RMVPE_CLEAR = 0.5
SVC_PRESET = "whisper_base_f0_44k"


def f0_agreement(what: str, sal_a, sal_b, f0_a, f0_b, min_clear: float):
    """Hold two RMVPE runs to each other (see RMVPE_SAL_TOL)."""
    sal_err = float(np.abs(sal_a - sal_b).max())
    top2 = np.sort(sal_b, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > RMVPE_MARGIN) & (top2[..., 1] > 0.03 + RMVPE_MARGIN)
    same_bin = np.argmax(sal_a, -1) == np.argmax(sal_b, -1)
    rel = np.abs(f0_a - f0_b)[clear] / np.maximum(f0_b[clear], 1e-9)
    f0_err = float(rel.max()) if rel.size else 0.0
    log(f"{what}: salience max_abs_err {sal_err:.3e} tol {RMVPE_SAL_TOL:g}; "
        f"argmax equal on {same_bin.mean():.4f} of {same_bin.size} frames; "
        f"{clear.mean():.4f} clear (margin {RMVPE_MARGIN:g}), F0 max rel err there "
        f"{f0_err:.3e} tol {RMVPE_F0_RTOL:g}; voiced {(f0_b > 0).mean():.3f}")
    if not (sal_err <= RMVPE_SAL_TOL and f0_err <= RMVPE_F0_RTOL and clear.mean() >= min_clear):
        fail(f"{what}: cuda and cpu disagree")


def phase_svc_small():
    """(a) the small F0-conditioned conversion, cuda (kernels) against cpu
    (plain twins), f32, same weights and noise; the F0 each side extracted
    is recorded and compared too."""
    import torch

    src = synthetic_audio(8.0, 22050, 140.0, seed=11)
    ref = synthetic_audio(1.5, 22050, 220.0, seed=12)
    noise = np.random.default_rng(13).standard_normal((512, 80)).astype(np.float32)

    def run(device):
        vc = small_converter(device, f0=True)
        f0s = []
        extract = vc.extract_f0

        def recorded(*a, **kw):
            f0s.append(extract(*a, **kw))
            return f0s[-1]

        vc.extract_f0 = recorded
        reset_counts()
        _, wave, stats = vc.convert(
            src, 22050, ref, 22050, diffusion_steps=SMALL_STEPS, cfg_rate=0.7,
            auto_f0_adjust=True, pitch_shift=2.0,
            noise_fn=lambda s: torch.from_numpy(noise[: s[1]][None]))
        counts = read_counts()
        log(f"svc small conversion on {device}: {len(wave)} samples, {stats['chunks']} chunks, "
            f"stages {sorted(stats['stages'])}, launches {counts}")
        if "f0" not in stats["stages"]:
            fail("svc small conversion has no f0 stage")
        expect = stats["chunks"] * SMALL_STEPS * SMALL_DEPTH if device == "cuda" else 0
        if counts["k1"] != expect or counts["k3"] != 0 or (counts["k2"] > 0) != (device == "cuda"):
            fail(f"svc small conversion on {device} launched the wrong code: {counts}")
        return wave, f0s[0]

    (w_cpu, (alt_cpu, ori_cpu)), (w_cuda, (alt_cuda, ori_cuda)) = run("cpu"), run("cuda")
    f0_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                 for a, b in ((alt_cuda, alt_cpu), (ori_cuda, ori_cpu)))
    err, snr = compare_waves("svc small conversion", w_cpu, w_cuda)
    log(f"svc small conversion cuda vs cpu: F0 max rel err {f0_err:.3e} tol {RMVPE_F0_RTOL:g} "
        f"(voiced {(alt_cpu > 0).mean():.3f}), wave max_abs_err {err:.3e} tol {SMALL_TOL:g}, "
        f"SNR {snr:.1f} dB")
    if not (f0_err <= RMVPE_F0_RTOL and err <= SMALL_TOL):
        fail("svc small conversion: cuda and cpu disagree")


def phase_rmvpe_full():
    """(b) RMVPE at full width on a 3 s vibrato tone, cuda against cpu."""
    import copy

    import torch

    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.models.rmvpe import RMVPE, RMVPE_E2E, decode_f0

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = RMVPE_E2E().requires_grad_(False).eval()
    on_cpu, on_cuda = RMVPE(copy.deepcopy(model)), RMVPE(model.cuda())
    audio = synthetic_audio(3.0, 16000, 180.0, seed=14)[None]
    t0 = time.perf_counter()
    sal_cpu = on_cpu.salience(audio).numpy()[0]
    cpu_s = time.perf_counter() - t0
    sal_cuda = on_cuda.salience(audio).cpu().numpy()[0]
    ms = cuda_time_ms(lambda: on_cuda.salience(audio), iters=5, warmup=1)
    log(f"rmvpe full width (1, {audio.shape[1]}) 16 kHz: {sal_cuda.shape[0]} frames; "
        f"cuda {ms:.2f} ms a call, cpu {cpu_s:.2f} s")
    f0_agreement("rmvpe full width cuda vs cpu", sal_cuda, sal_cpu, decode_f0(sal_cuda),
                 decode_f0(sal_cpu), RMVPE_CLEAR)


def check_counts(what: str, counts: dict, expect: dict):
    """Every count against ``expect``; the AR decode kernels' only where
    ``expect`` names them (``check_ar_counts`` holds them on the v2 paths)."""
    got = {k: n for k, n in counts.items() if not k.startswith("ar_") or k in expect}
    if got != expect:
        fail(f"{what}: launch counts {got}, expected {expect}")


def phase_svc(card: str, profile: bool = False) -> dict:
    """(c) the full-width SVC path through the CLI and the wrapper."""
    import tempfile

    import torch

    from seedvc_tpu_torch.apps import infer
    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.pipelines.convert import OVERLAP_FRAMES
    from seedvc_tpu_torch.pipelines.wrapper import SeedVCWrapper

    phase_svc_small()
    phase_rmvpe_full()
    cfg = get_preset(SVC_PRESET)
    sr, hop = cfg.sr, cfg.preprocess_params.spect_params.hop_length
    src = synthetic_audio(30.0, sr, 140.0, seed=15)
    ref = synthetic_audio(5.0, sr, 220.0, seed=16)
    expect = {"k1": MAIN_CHUNKS * 25 * cfg.dit.depth, "k2": MAIN_CHUNKS * 109, "k3": 0}
    with tempfile.TemporaryDirectory() as tmp:
        src_path, ref_path = os.path.join(tmp, "src.wav"), os.path.join(tmp, "ref.wav")
        save_wav(src_path, src, sr)
        save_wav(ref_path, ref, sr)
        src, ref = load_wav(src_path)[0], load_wav(ref_path)[0]  # what the CLI reads
        reset_counts()
        t0 = time.perf_counter()
        infer.main(["--source", src_path, "--target", ref_path, "--output",
                    os.path.join(tmp, "out"), "--f0-condition", "true", "--auto-f0-adjust",
                    "true", "--semi-tone-shift", "2", "--diffusion-steps", "25"])
        torch.cuda.synchronize()
        counts = read_counts()
        (name,) = os.listdir(os.path.join(tmp, "out"))
        wave, out_sr = load_wav(os.path.join(tmp, "out", name))
        log(f"svc cli: {time.perf_counter() - t0:.1f} s (build included), wrote {name}: "
            f"{out_sr} Hz, {len(wave)} samples, launches {counts}")
        if out_sr != sr or len(wave) != len(src) // hop * hop or not np.isfinite(wave).all():
            fail(f"svc cli wrote {out_sr} Hz, {len(wave)} samples, expected {sr} Hz, "
                 f"{len(src) // hop * hop} finite samples")
        check_counts("svc cli", counts, expect)

    t0 = time.perf_counter()
    wrap = SeedVCWrapper()
    vc = wrap.converter(True)
    log(f"svc: {SVC_PRESET} built in {time.perf_counter() - t0:.1f} s (compute dtype "
        f"{vc.compute_dtype}, DiT {cfg.dit.hidden_dim} wide, {cfg.dit.depth} deep, "
        f"{cfg.dit.num_heads} heads)")
    target_len, p_len = len(src) // hop, len(ref) // hop
    plan = vc.plan_chunks(target_len, p_len)
    step = plan[2] - OVERLAP_FRAMES
    lens = [p_len + min(plan[2], target_len - i * step) for i in range(MAIN_CHUNKS)]
    log(f"svc: plan (prompt_cap, context, W) = {plan}, K1 lens by chunk {lens}")
    if plan[1:] != (MAIN_CONTEXT, MAIN_W):
        fail(f"unexpected svc plan {plan}")
    result = {}
    kw = dict(f0_condition=True, diffusion_steps=25, inference_cfg_rate=0.7,
              auto_f0_adjust=True, pitch_shift=2.0)
    for run in ("cold", "warm", "warm, stages synced"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "warm, stages synced":
            _, wave, stats = vc.convert(src, sr, ref, sr, diffusion_steps=25, cfg_rate=0.7,
                                        auto_f0_adjust=True, pitch_shift=2.0, profile=True)
        else:
            ((_, wave, stats),) = wrap.convert_voice(src, sr, ref, sr, stream_output=False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        secs = len(wave) / sr
        log(f"svc {run}: {wall:.3f} s wall for {secs:.2f} s of audio "
            f"({secs / wall:.2f} audio-s/s), {stats['chunks']} chunks, launches {counts}, "
            f"on {card}")
        log("  stages: " + json.dumps({k: round(v["seconds"], 4)
                                       for k, v in stats["stages"].items()}))
        if not np.isfinite(wave).all() or len(wave) != target_len * hop or "f0" not in stats[
                "stages"]:
            fail(f"svc {run}: {len(wave)} samples (expected {target_len * hop}), "
                 f"stages {sorted(stats['stages'])}, or non-finite audio")
        check_counts(f"svc {run}", counts, expect)
        if run == "warm":
            result = {"wall_s": wall, "audio_s": secs, "counts": counts, "lens": lens}
    if profile:
        profile_conversion(lambda: list(wrap.convert_voice(src, sr, ref, sr, stream_output=False,
                                                           **kw)), result["wall_s"])
    return result


# Kernel launches per call of each microbench component at full width
# (13 DiT layers, 109 BigVGAN activations, 25 Euler steps); the rest none.
MB_DEPTH, MB_ACTS, MB_STEPS = 13, 109, 25
MB_LAUNCHES = {"attention": {"k3": 1}, "dit": {"k1": MB_DEPTH}, "vocoder": {"k2": MB_ACTS},
               "serving": {"k1": MB_STEPS * MB_DEPTH}, "serving_b1": {"k1": MB_STEPS * MB_DEPTH},
               "serving_b2": {"k1": MB_STEPS * MB_DEPTH},
               **{t: {"k1": MB_DEPTH, "k1b": MB_DEPTH}
                  for t in ("train_step", "train_step_bf16", "train_onfly", "train_onfly_sync",
                            "train_onfly_v2")}}


def phase_microbench() -> dict:
    """Every ported microbench component at full width; launch counts are
    zeroed before and read after each, and must be calls x the plan."""
    from seedvc_tpu_torch.apps import microbench as mb
    from seedvc_tpu_torch.ops import attention

    counts = {}
    for name, fn in mb.ALL.items():
        reset_counts()
        out = fn()
        # the AR decode kernels are held on the v2 paths (check_ar_counts)
        got = {k: n for k, n in {**read_counts(), "k1b": attention.BWD_LAUNCHES}.items()
               if not k.startswith("ar_")}
        calls = sum(r["calls"] for r in (out if isinstance(out, list) else [out]))
        expect = {k: MB_LAUNCHES.get(name, {}).get(k, 0) * calls for k in got}
        log(f"  microbench {name}: {calls} calls, launches {got}")
        if got != expect:
            fail(f"microbench {name}: launches {got}, expected {expect}")
        counts[name] = got
    return counts


# ---------------------------------------------------------------------------
# Real-time: xlsr_tiny (XLS-R, DiT with time and style tokens, HiFT) offline,
# then the streaming block program as one CUDA graph.
RT_PRESET = "xlsr_tiny"
RT_STEPS, RT_BLOCKS, RT_BLOCK_TIME = 10, 20, 0.25
# graph replay against the same block function run eagerly: the same kernels
# on the same inputs, so only a library's choice of algorithm may differ
GRAPH_TOL = 1e-3
# a stream in f32, cuda against cpu: K1 against its twin (f32, 1e-4) and
# summation order, through SOLA with the same offsets
RT_STREAM_TOL = 5e-4


def rt_small_converter(device: str, dtype=None):
    """A reduced xlsr_tiny: SSL encoder 128 wide (2 layers, 64 conv channels,
    the positional conv at its real kernel and groups), the preset's DiT (384
    wide, 6 heads of 64, both prefix tokens, MLP head) cut to depth 3, HiFT
    with 64 base channels; prompt cap 128, context 512."""
    import dataclasses

    import torch

    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.models.hifigan import HiFTConfig
    from seedvc_tpu_torch.models.ssl import SSLConfig
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    cfg = get_preset(RT_PRESET)
    mp = cfg.model_params
    mp = dataclasses.replace(
        mp, length_regulator=dataclasses.replace(mp.length_regulator, in_channels=128),
        DiT=dataclasses.replace(mp.DiT, depth=SMALL_DEPTH))
    return VoiceConverter(
        dataclasses.replace(cfg, model_params=mp),
        whisper_cfg=SSLConfig(conv_dim=64, d_model=128, n_layers=2, n_heads=8, ffn_dim=256),
        vocoder_cfg=HiFTConfig(base_channels=64), prompt_cap_frames=128, context_frames=512,
        compute_dtype=torch.float32 if dtype is None else dtype, seed=0, device=device)


def cpu_draws(shape):
    """HiFT draws made on the CPU from a fixed seed, so that a cuda and a cpu
    run see the same numbers (the default draws come from each device's own
    generator)."""
    import math

    import torch

    g = torch.Generator().manual_seed(5)
    B, T, H = shape
    return ((torch.rand((B, 1, H), generator=g) * 2 - 1) * math.pi,
            torch.randn((B, T, H), generator=g))


@contextlib.contextmanager
def recorded(module, names, log: dict):
    """Record every result of ``module.<name>`` for each name into
    ``log[name]`` while the block runs."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            log.setdefault(name, []).append(out)
            return out
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def stream_blocks(stream, blocks) -> tuple[list, dict]:
    """Emitted blocks, and the SOLA offsets and VAD decisions made on them."""
    from seedvc_tpu_torch.pipelines import streaming

    log: dict = {}
    with recorded(streaming, ("sola_offset", "is_speech_block"), log):
        out = [stream.process_block(b) for b in blocks]
    return out, log


def phase_rt_small():
    """The reduced xlsr_tiny converter: (a) offline, cuda (K1) against cpu
    (plain twins), f32, same weights, CFM noise and HiFT draws; (b) streaming
    in f32, the captured block program on cuda replayed against the block
    function on cpu, same blocks, noise and draws; (c) streaming in bf16 on
    cuda (the encoder in f32, as on the full path), the replays against the
    same block function run eagerly on a second converter state fed the same
    blocks and noise. Streams compare emitted audio, SOLA offsets and VAD
    decisions, and count their replays."""
    import torch

    from seedvc_tpu_torch.pipelines.streaming import StreamConfig, StreamingConverter

    src = synthetic_audio(8.0, 22050, 140.0, seed=21)
    ref = synthetic_audio(3.0, 22050, 220.0, seed=22)
    noise = np.random.default_rng(23).standard_normal((512, 80)).astype(np.float32)

    def run(device):
        vc = rt_small_converter(device)
        reset_counts()
        _, wave, stats = vc.convert(src, 22050, ref, 22050, diffusion_steps=SMALL_STEPS,
                                    cfg_rate=0.7, draws_fn=cpu_draws,
                                    noise_fn=lambda s: torch.from_numpy(noise[: s[1]][None]))
        counts = read_counts()
        log(f"rt small conversion on {device}: {len(wave)} samples, {stats['chunks']} chunks, "
            f"launches {counts}")
        k1 = stats["chunks"] * SMALL_STEPS * SMALL_DEPTH if device == "cuda" else 0
        check_counts(f"rt small conversion on {device}", counts, {"k1": k1, "k2": 0, "k3": 0})
        return vc, wave

    (vc_cpu, w_cpu), (vc_cuda, w_cuda) = run("cpu"), run("cuda")
    err, snr = compare_waves("rt small f32 conversion", w_cpu, w_cuda)
    log(f"rt small f32 conversion cuda vs cpu: max_abs_err {err:.3e} tol {SMALL_TOL:g}, "
        f"SNR {snr:.1f} dB")
    if not err <= SMALL_TOL:
        fail("rt small conversion: cuda and cpu disagree")

    bank = np.random.default_rng(24).standard_normal((4, 512, 80)).astype(np.float32)

    def stream(vc, graph: bool = True):
        n = [0]

        def noise_fn(shape):
            n[0] += 1
            return torch.from_numpy(bank[n[0] % len(bank)][: shape[1]][None])

        st = StreamingConverter(vc, StreamConfig(), noise_fn=noise_fn, draws_fn=cpu_draws)
        reset_counts()
        st.set_reference(ref, 22050)
        counts = read_counts()
        if not graph:
            st._graph = None  # the same block function, run eagerly
        return st, counts

    def compare(what, a, b, tol):
        """Run the blocks through streams a (graph) and b; check they agree
        and that a replayed its graph once for every converted block."""
        reset_counts()
        a_out, a_log = stream_blocks(a, blocks)
        replay_counts = read_counts()
        b_out, b_log = stream_blocks(b, blocks)
        converted = len(a_log.get("sola_offset", [])) + 1
        check_counts(f"{what} replays (the wrappers run only when captured)", replay_counts,
                     {"k1": 0, "k2": 0, "k3": 0})
        err = max(float(np.abs(x - y).max()) for x, y in zip(a_out, b_out))
        log(f"{what}, {len(blocks)} blocks, {a.replays} replays: max_abs_err {err:.3e} tol "
            f"{tol:g}; SOLA offsets {a_log.get('sola_offset')} vs {b_log.get('sola_offset')}; "
            f"VAD {a_log['is_speech_block']} vs {b_log['is_speech_block']}")
        if not (err <= tol and a_log == b_log and all(np.isfinite(x).all() for x in a_out)):
            fail(f"{what}: the two streams disagree")
        if a_log["is_speech_block"] != [True] * 3 + [False] * 4 + [True] * 2:
            fail(f"{what}: VAD decisions {a_log['is_speech_block']}")
        if a.replays != converted:
            fail(f"{what}: {a.replays} replays for {converted} converted blocks")

    (g32, _), (c32, _) = stream(vc_cuda), stream(vc_cpu)
    blocks = []
    for i, kind in enumerate("sssqqqqss"):  # speech, quiet (the VAD gate), speech
        b = synthetic_audio(2 * RT_BLOCK_TIME, 22050, 150.0 + 10 * i, seed=30 + i)[: g32.block]
        blocks.append(b if kind == "s" else np.zeros_like(b))
    compare("rt small f32 streaming, cuda graph replay vs cpu", g32, c32, RT_STREAM_TOL)
    del g32, c32, vc_cpu, vc_cuda

    vc = rt_small_converter("cuda", torch.bfloat16)
    (g_st, g_counts), (e_st, _) = stream(vc), stream(vc, graph=False)
    T = g_st._prompt_len + g_st.dit_frames + 2
    expect = {"k1": RT_STEPS * SMALL_DEPTH, "k2": 0, "k3": 0}
    log(f"rt small streaming (bf16, T = {T}): set_reference launches {g_counts} "
        f"(eager warm-up + capture), captured per block {g_st.graph_launches}")
    check_counts("rt small captured block", g_st.graph_launches, expect)
    check_counts("rt small set_reference", g_counts, {k: 2 * v for k, v in expect.items()})
    compare("rt small bf16 streaming, graph replay vs eager", g_st, e_st, GRAPH_TOL)


def time_blocks(st, blocks) -> list:
    """Wall ms of process_block on each block (ends in the output's fetch)."""
    times = []
    for b in blocks:
        t0 = time.perf_counter()
        st.process_block(b)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def rt_layout_ab(card: str):
    """Device time of two layout choices on the real-time path, at the
    stream's (T = 249 frames, 18176 samples) and an offline chunk's (1499,
    393216) lengths: XLS-R's grouped positional conv (1024 channels, kernel
    128, 16 groups, padding (64, 63)) as cuDNN's conv in bf16 and f32 against
    the same product over unfolded windows, and HiFT's phase cumsum over the
    time axis of (1, n, 9) against over the last axis (the port's)."""
    import torch
    import torch.nn.functional as F

    from seedvc_tpu_torch.core.profiling import cuda_time_ms

    g = torch.Generator(device="cuda").manual_seed(50)
    C, G, K = 1024, 16, 128
    w = torch.randn((C, C // G, K), generator=g, device="cuda") / (C // G * K) ** 0.5
    b = torch.randn(C, generator=g, device="cuda") * 0.1

    def conv(x, w, b):
        return F.conv1d(F.pad(x, (K // 2, K // 2 - 1)), w, b, groups=G)

    def unfold_mm(x, w, b):
        B, _, T = x.shape
        xu = F.pad(x, (K // 2, K // 2 - 1)).unfold(-1, K, 1)  # (B, C, T, K)
        xu = xu.reshape(B, G, C // G, T, K).permute(0, 1, 3, 2, 4).reshape(B, G, T, -1)
        out = torch.matmul(xu, w.reshape(G, C // G, -1).transpose(1, 2))  # (B, G, T, C/G)
        return out.permute(0, 1, 3, 2).reshape(B, C, T) + b[:, None]

    for T in (249, 1499):
        x = torch.randn((1, C, T), generator=g, device="cuda")
        ref = conv(x.double(), w.double(), b.double())
        for dt in (torch.bfloat16, torch.float32):
            args = x.to(dt), w.to(dt), b.to(dt)
            row = []
            for name, fn in (("cudnn", conv), ("unfold_mm", unfold_mm)):
                err = float((fn(*args).double() - ref).abs().max())
                row.append(f"{name} {cuda_time_ms(lambda: fn(*args), iters=20):.4f} ms "
                           f"(max abs vs f64 {err:.2e})")
            log(f"rt A/B pos_conv T={T} {dt}: " + ", ".join(row) + f", on {card}")
    for n in (18176, 393216):
        f = torch.rand((1, n, 9), generator=g, device="cuda") * 0.1
        ms_time = cuda_time_ms(lambda: torch.cumsum(f, 1))
        ms_last = cuda_time_ms(lambda: torch.cumsum(f.transpose(1, 2), -1).transpose(1, 2))
        log(f"rt A/B cumsum (1, {n}, 9) f32: over time {ms_time:.4f} ms, over the last axis "
            f"{ms_last:.4f} ms, on {card}")


def phase_rt_full(card: str, profile: bool = False) -> dict:
    """xlsr_tiny at full width: (a) offline 30 s + 5 s, 25 steps, cold, warm
    and synchronised, 450 K1 and no K2/K3; (b) the block program on the same
    converter, graph replay against eager, alternating; (c) ``python -m
    seedvc_tpu_torch.apps.stream_bench``; (d) ``python -m
    seedvc_tpu_torch.apps.realtime --simulate`` on a written 10 s wav."""
    import tempfile

    import torch

    from seedvc_tpu_torch.apps import realtime, stream_bench
    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.pipelines.convert import OVERLAP_FRAMES, VoiceConverter
    from seedvc_tpu_torch.pipelines.streaming import StreamConfig, StreamingConverter

    t0 = time.perf_counter()
    vc = VoiceConverter(get_preset(RT_PRESET), device="cuda")
    dc = vc.cfg.dit
    log(f"rt: {RT_PRESET} built in {time.perf_counter() - t0:.1f} s (compute dtype "
        f"{vc.compute_dtype}; XLS-R {vc.whisper.cfg.d_model} wide, {vc.whisper.cfg.n_layers} "
        f"layers; DiT {dc.hidden_dim} wide, {dc.depth} deep, {dc.num_heads} heads, prefix "
        f"tokens; HiFT {vc.vocoder.cfg.base_channels} base channels)")
    sr = vc.sr
    src = synthetic_audio(30.0, sr, 140.0, seed=41)
    ref = synthetic_audio(5.0, sr, 220.0, seed=42)
    target_len, p_len = len(src) // vc.hop, len(ref) // vc.hop
    plan = vc.plan_chunks(target_len, p_len)
    step = plan[2] - OVERLAP_FRAMES
    lens = [p_len + min(plan[2], target_len - i * step) + 2 for i in range(MAIN_CHUNKS)]
    log(f"rt offline: plan (prompt_cap, context, W) = {plan}, K1 at T = {plan[1] + 2}, "
        f"lens by chunk {lens}")
    if plan[1:] != (MAIN_CONTEXT, MAIN_W) or lens != [1968, 1495]:
        fail(f"unexpected rt plan {plan} / lens {lens}")
    expect = {"k1": MAIN_CHUNKS * 25 * dc.depth, "k2": 0, "k3": 0}
    result = {"lens": lens}
    for run, synced in (("cold", False), ("warm", False), ("warm, stages synced", True)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, wave, stats = vc.convert(src, sr, ref, sr, diffusion_steps=25, cfg_rate=0.7,
                                    profile=synced)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        secs = len(wave) / sr
        log(f"rt offline {run}: {wall:.3f} s wall for {secs:.2f} s of audio "
            f"({secs / wall:.2f} audio-s/s), {stats['chunks']} chunks, launches {counts}, "
            f"on {card}")
        log("  stages: " + json.dumps({k: round(v["seconds"], 4)
                                       for k, v in stats["stages"].items()}))
        if not np.isfinite(wave).all() or len(wave) != target_len * vc.hop:
            fail(f"rt offline {run}: {len(wave)} samples (expected {target_len * vc.hop}) "
                 "or non-finite audio")
        check_counts(f"rt offline {run}", counts, expect)
        if run == "warm":
            result.update(wall_s=wall, audio_s=secs, counts=counts)
    if profile:
        profile_conversion(lambda: vc.convert(src, sr, ref, sr, diffusion_steps=25,
                                              cfg_rate=0.7), result["wall_s"])

    # (b) the block program on this converter: graph replay vs eager, in turns
    st = StreamingConverter(vc, StreamConfig(diffusion_steps=RT_STEPS, vad_threshold_db=-10000.0))
    st.set_reference(ref[: 3 * sr], sr)
    rng = np.random.default_rng(43)
    blocks = [(rng.standard_normal(st.block) * 0.1).astype(np.float32) for _ in range(10)]
    graph = st._graph
    runs = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        st._graph = graph if mode == "graph" else None
        runs[mode] += time_blocks(st, blocks)[2:]
    st._graph = graph
    med = {m: float(np.median(v)) for m, v in runs.items()}
    log(f"rt block program at full width (T = {st._prompt_len + st.dit_frames + 2}): median "
        f"ms a block, graph replay {med['graph']:.2f}, eager {med['eager']:.2f} "
        f"({len(runs['graph'])} blocks each, alternating), on {card}")
    result["block_graph_ms"], result["block_eager_ms"] = med["graph"], med["eager"]
    if profile:
        profile_conversion(lambda: st.process_block(blocks[0]), med["graph"] / 1e3)
        rt_layout_ab(card)

    # (c) the benchmark entry point
    reset_counts()
    bench = stream_bench.main(["--n-blocks", str(RT_BLOCKS), "--block-time", str(RT_BLOCK_TIME),
                               "--steps", str(RT_STEPS)])
    counts = read_counts()
    per_block = {"k1": RT_STEPS * dc.depth, "k2": 0, "k3": 0}
    check_counts("stream_bench captured block", bench["graph_launches"], per_block)
    check_counts("stream_bench run (eager warm-up + capture)", counts,
                 {k: 2 * v for k, v in per_block.items()})
    if bench["dit_T"] + 2 != RT_BLOCK_T:
        fail(f"stream_bench DiT T {bench['dit_T']} + 2, expected {RT_BLOCK_T}")
    if bench["replays"] != RT_BLOCKS:
        fail(f"stream_bench: {bench['replays']} graph replays for {RT_BLOCKS} blocks")
    steady = bench["block_ms"][3:]
    log(f"stream_bench: block 0 {bench['block_ms'][0]:.2f} ms, steady median "
        f"{bench['steady_ms']:.2f} ms (range {min(steady):.2f}-{max(steady):.2f}) against "
        f"{bench['budget_ms']:.0f} ms, occupancy {bench['steady_ms'] / bench['budget_ms']:.3f}; "
        f"launches counted in the run {counts}, captured per block {bench['graph_launches']}, "
        f"replays {bench['replays']}")
    if bench["block_ms"][0] > 1.5 * max(steady):
        fail("stream_bench: block 0 is outside the steady state's spread")
    result.update(bench=bench, bench_counts=counts)

    # (d) the real-time CLI on a written 10 s wav, in a scratch working dir
    # (it saves its settings JSON under the working directory)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            save_wav("in.wav", synthetic_audio(10.0, 16000, 150.0, seed=44), 16000)
            save_wav("ref.wav", synthetic_audio(3.0, sr, 220.0, seed=45), sr)
            t0 = time.perf_counter()
            report = realtime.main(["--reference", "ref.wav", "--simulate", "in.wav",
                                    "--output", "out.wav"])
            wave, out_sr = load_wav("out.wav")
            settings = os.path.exists(os.path.join("configs", "inuse", "realtime.json"))
        finally:
            os.chdir(cwd)
    n_in = -(-10 * 16000 * sr // 16000)
    n_blocks = -(-n_in // st.block)
    log(f"realtime --simulate: {time.perf_counter() - t0:.1f} s (build included), wrote "
        f"{out_sr} Hz, {len(wave)} samples ({n_blocks} blocks); report {json.dumps(report)}; "
        f"settings saved: {settings}")
    if out_sr != sr or len(wave) != n_blocks * st.block or not np.isfinite(wave).all():
        fail(f"realtime --simulate wrote {out_sr} Hz, {len(wave)} samples, expected {sr} Hz "
             f"and {n_blocks * st.block} finite samples")
    result["realtime"] = report
    return result


# ---------------------------------------------------------------------------
# v2: HuBERT -> ASTRAL tokens, the batched AR decode (one CUDA graph a
# token), DiTV2 with 3-way CFG over K1, BigVGAN 22 kHz.
V2_STEPS = 30
# ASTRAL tokens, cuda against cpu: equal wherever every projected bit clears
# this (elsewhere f32 summation order may flip a sign)
V2_BIT_CLEAR = 1e-4
# the AR's tokens, cuda against cpu: equal, or the first divergence at a
# near tie, the top two probs/q within this (relative)
V2_TIE = 1e-5
# HuBERT features, cuda (cuDNN, TF32 off) against cpu, f32
V2_SSL_TOL = 1e-3
# the reduced AR's EOS weights are raised so its decode ends after several hundred
# tokens (at random weights it would run to 2048 on both devices)
V2_SMALL_EOS_BIAS = 0.05


def v2_small_converter(device: str):
    """A reduced V2Config in f32: HuBERT 128 wide (2 layers, 64 conv
    channels, the positional conv at its real kernel and groups), ASTRAL
    quantizers 64 wide (2 blocks; codebooks 32 and 2048), the DiT at full
    width (512, 8 heads of 64) cut to depth 3, the AR 256 wide (2 layers, 12
    query heads of 64 over 2 KV heads as ``ARConfig()``'s, which the decode
    kernels take; vocab 2049, max_seq 4096), a small BigVGAN; prompt cap 128,
    context 766."""
    import torch

    from seedvc_tpu_torch.models.ar import ARConfig
    from seedvc_tpu_torch.models.astral import AstralConfig
    from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
    from seedvc_tpu_torch.models.dit_v2 import DiTV2Config
    from seedvc_tpu_torch.models.ssl import SSLConfig
    from seedvc_tpu_torch.pipelines import convert_v2

    astral = dict(dim=64, intermediate_dim=128, num_blocks=2, input_dim=128)
    cfg = convert_v2.V2Config(
        dit=DiTV2Config(depth=SMALL_DEPTH),
        ar=ARConfig(dim=256, n_layer=2, n_head=12, n_local_heads=2, head_dim=64,
                    intermediate_size=512),
        ssl=SSLConfig(conv_dim=64, d_model=128, n_layers=2, n_heads=8, ffn_dim=256),
        narrow=AstralConfig(codebook_size=32, **astral),
        wide=AstralConfig(codebook_size=2048, **astral),
        prompt_cap_frames=128, context_frames=766)
    saved = convert_v2.BIGVGAN_22K_80
    convert_v2.BIGVGAN_22K_80 = BigVGANConfig(upsample_initial_channel=128,
                                              resblock_kernel_sizes=(3,),
                                              resblock_dilation_sizes=((1, 3),))
    try:
        vc = convert_v2.VoiceConverterV2(cfg, seed=0, compute_dtype=torch.float32,
                                         device=device)
    finally:
        convert_v2.BIGVGAN_22K_80 = saved
    with torch.no_grad():
        vc.ar.output.weight[cfg.ar.eos] += V2_SMALL_EOS_BIAS
    return vc


def v2_cpu_draws(shape):
    """AR draws made on the CPU from a fixed seed, the same for a cuda and a
    cpu run."""
    import torch

    g = torch.Generator().manual_seed(61)
    return torch.empty(shape).exponential_(generator=g).clamp_min_(1e-30)


@contextlib.contextmanager
def ar_scores(log: list):
    """Record the top two of each sample's probs/q (one (B, 2) tensor a
    sampled step) while the block runs; eager steps only (a CUDA graph's
    replays call no Python)."""
    from seedvc_tpu_torch.models import ar

    saved = ar.sample_token

    def scored(*a, **kw):
        scores = ar.token_scores(*a, **kw)
        log.append(scores.topk(2, dim=-1).values.cpu())
        return scores.argmax(-1)

    ar.sample_token = scored
    try:
        yield log
    finally:
        ar.sample_token = saved


def v2_bits(vc, wave16: np.ndarray):
    """HuBERT features of the 5 s-bucketed wave, and each quantizer's
    indices and projected bits (the l2-normalised ``project_in``)."""
    import torch

    from seedvc_tpu_torch.nn.bsq import l2norm

    T = len(wave16)
    padded = np.zeros(-(-max(T, 8000) // 80000) * 80000, np.float32)
    padded[:T] = wave16
    with torch.no_grad():
        feats = vc.ssl(torch.from_numpy(padded[None]).to(vc.device))
        out = {"ssl": feats.cpu().numpy()}
        for name in ("narrow", "wide"):
            q = getattr(vc, name)
            out[name] = q(feats)[1].cpu().numpy()
            out[name + "_bits"] = l2norm(q.quantizer.project_in(q.encoder(feats))).cpu().numpy()
    return out


def phase_v2_small():
    """(a) the reduced V2Config in f32, cuda (K1, K2) against cpu (plain
    twins), same weights, CFM noise and AR draws: HuBERT features, ASTRAL
    indices, the AR's tokens and the waves of convert_timbre and
    convert_voice; then the AR decode's graph replay against the same step
    run eagerly on the card."""
    import torch

    from seedvc_tpu_torch.dsp.resample import resample_host

    src = synthetic_audio(8.0, 22050, 140.0, seed=51)
    ref = synthetic_audio(1.5, 22050, 220.0, seed=52)
    noise = np.random.default_rng(53).standard_normal((768, 80)).astype(np.float32)
    kw = dict(diffusion_steps=SMALL_STEPS, draws_fn=v2_cpu_draws,
              noise_fn=lambda s: torch.from_numpy(noise[: s[1]][None]))

    def tokens_of(vc, fn):
        """fn()'s AR tokens and counts (from the generator's calls)."""
        got = []
        generate = vc.generator.generate

        def rec(*a, **k):
            got.append(tuple(t.cpu() for t in generate(*a, **k)))
            return got[-1]

        vc.generator.generate = rec
        try:
            out = fn()
        finally:
            vc.generator.generate = generate
        return out, got[0]

    runs = {}
    for device in ("cpu", "cuda"):
        vc = v2_small_converter(device)
        bits = v2_bits(vc, resample_host(src, 22050, 16000))
        reset_counts()
        _, timbre, t_stats = vc.convert_timbre(src, 22050, ref, 22050, **kw)
        t_counts = read_counts()
        scores: list = []
        with ar_scores(scores) if device == "cpu" else contextlib.nullcontext():
            reset_counts()
            (_, voice, v_stats), ar_out = tokens_of(
                vc, lambda: vc.convert_voice(src, 22050, ref, 22050, **kw))
        v_counts = read_counts()
        log(f"v2 small on {device}: timbre {len(timbre)} samples, {t_stats['chunks']} chunks, "
            f"launches {t_counts}; voice: narrow {v_stats['narrow_tokens']}, wide "
            f"{v_stats['wide_tokens']} tokens, ar_batch {v_stats['ar_batch']}, decode steps "
            f"{v_stats['decode_steps']}, replays {v_stats['replays']}, target_len "
            f"{v_stats['target_len']}, plan {v_stats['plan']}, {v_stats['chunks']} chunks, "
            f"launches {v_counts}")
        for what, counts, stats in (("timbre", t_counts, t_stats), ("voice", v_counts, v_stats)):
            k1 = stats["chunks"] * SMALL_STEPS * SMALL_DEPTH if device == "cuda" else 0
            if counts["k1"] != k1 or counts["k3"] != 0 or (counts["k2"] > 0) != (device == "cuda"):
                fail(f"v2 small {what} on {device}: launches {counts}, expected k1 = {k1}, "
                     f"k3 = 0, k2 {'> 0' if device == 'cuda' else '= 0'}")
        if device == "cuda" and v_stats["replays"] != v_stats["decode_steps"] - 1:
            fail(f"v2 small: {v_stats['replays']} replays for {v_stats['decode_steps']} "
                 "decode steps (the first runs eagerly)")
        if device == "cuda":
            check_ar_counts("v2 small voice on cuda", v_counts, vc.generator,
                            vc.cfg.ar.n_layer, v_stats["decode_steps"])
        elif any(n for k, n in {**t_counts, **v_counts}.items() if k.startswith("ar_")):
            fail(f"v2 small on cpu: AR decode kernels launched ({v_counts})")
        runs[device] = dict(vc=vc, bits=bits, timbre=timbre, voice=voice, ar=ar_out,
                            scores=scores, stats=v_stats)

    cpu, cuda = runs["cpu"], runs["cuda"]
    ssl_err = float(np.abs(cpu["bits"]["ssl"] - cuda["bits"]["ssl"]).max())
    log(f"v2 small HuBERT features {cpu['bits']['ssl'].shape} cuda vs cpu: max_abs_err "
        f"{ssl_err:.3e} tol {V2_SSL_TOL:g}")
    if not ssl_err <= V2_SSL_TOL:
        fail("v2 small: HuBERT features disagree")
    for name in ("narrow", "wide"):
        clear = np.abs(cpu["bits"][name + "_bits"]).min(-1) > V2_BIT_CLEAR
        same = cpu["bits"][name] == cuda["bits"][name]
        log(f"v2 small {name} indices {same.shape}: equal on {int(same[clear].sum())} of "
            f"{int(clear.sum())} frames whose bits clear {V2_BIT_CLEAR:g}; {int((~clear).sum())} "
            f"frames not clear ({int(same[~clear].sum())} of them equal)")
        if not same[clear].all():
            fail(f"v2 small: {name} indices differ where every bit is clear")
    (c_tok, c_n), (g_tok, g_n) = cpu["ar"], cuda["ar"]
    if torch.equal(c_tok, g_tok) and torch.equal(c_n, g_n):
        log(f"v2 small AR tokens cuda (graph) vs cpu: equal, counts {c_n.tolist()}")
    else:
        diff = (c_tok != g_tok).nonzero()
        b, step = (int(diff[0, 0]), int(diff[0, 1])) if len(diff) else (0, -1)
        if step < 0:
            fail(f"v2 small AR: equal tokens but counts {c_n.tolist()} vs {g_n.tolist()}")
        top2 = cpu["scores"][step][b]
        margin = float((top2[0] - top2[1]) / top2[0])
        log(f"v2 small AR tokens cuda vs cpu: first divergence row {b} step {step}, top-2 "
            f"probs/q margin {margin:.3e} (relative) tol {V2_TIE:g}")
        if not margin <= V2_TIE:
            fail("v2 small AR: tokens diverge away from a near tie")
    err, snr = compare_waves("v2 small timbre", cpu["timbre"], cuda["timbre"])
    log(f"v2 small f32 convert_timbre cuda vs cpu: max_abs_err {err:.3e} tol {SMALL_TOL:g}, "
        f"SNR {snr:.1f} dB")
    if not err <= SMALL_TOL:
        fail("v2 small convert_timbre: cuda and cpu disagree")
    if torch.equal(c_tok, g_tok):
        err, snr = compare_waves("v2 small voice", cpu["voice"], cuda["voice"])
        log(f"v2 small f32 convert_voice cuda vs cpu: max_abs_err {err:.3e} tol "
            f"{SMALL_TOL:g}, SNR {snr:.1f} dB")
        if not err <= SMALL_TOL:
            fail("v2 small convert_voice: cuda and cpu disagree")

    vc = cuda["vc"]
    vc.generator.use_graph = False
    try:
        (_, _, e_stats), e_ar = tokens_of(
            vc, lambda: vc.convert_voice(src, 22050, ref, 22050, **kw))
    finally:
        vc.generator.use_graph = None
    same = torch.equal(e_ar[0], g_tok) and torch.equal(e_ar[1], g_n)
    log(f"v2 small AR on cuda, graph replay vs eager: tokens equal {same}; "
        f"{cuda['stats']['replays']} replays vs {e_stats['replays']}")
    if not same or e_stats["replays"] != 0:
        fail("v2 small AR: graph replay and eager decode disagree")


def phase_v2_full(card: str, profile: bool = False) -> dict:
    """(b) V2Config() at full width, random weights from seed 0: convert_timbre
    on a 20 s source with a 5 s reference, 30 steps, both rates 0.7, cold,
    warm and synchronised (1 chunk: 390 K1, 109 K2, 0 K3); convert_voice
    on the same clip, with the AR timed by graph replay and eagerly; the
    infer_v2 CLI on written wavs."""
    import tempfile

    import torch

    from seedvc_tpu_torch.apps import infer_v2
    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
    from seedvc_tpu_torch.pipelines.convert import OVERLAP_FRAMES
    from seedvc_tpu_torch.pipelines.convert_v2 import VoiceConverterV2

    t0 = time.perf_counter()
    vc = VoiceConverterV2(device="cuda")
    c = vc.cfg
    log(f"v2: V2Config() built in {time.perf_counter() - t0:.1f} s (compute dtype "
        f"{vc.compute_dtype}; HuBERT {c.ssl.d_model} wide, {c.ssl.n_layers} layers; ASTRAL "
        f"{c.wide.dim} wide, {c.wide.num_blocks} blocks; DiT {c.dit.hidden_dim} wide, "
        f"{c.dit.depth} deep, {c.dit.num_heads} heads; AR {c.ar.dim} wide, {c.ar.n_layer} layers, "
        f"max_seq {c.ar.max_seq_len})")
    sr, hop = c.sr, c.hop
    src = synthetic_audio(20.0, sr, 140.0, seed=54)
    ref = synthetic_audio(5.0, sr, 220.0, seed=55)
    kw = dict(diffusion_steps=V2_STEPS, intelligibility_cfg_rate=0.7, similarity_cfg_rate=0.7)

    def check_plan(what, stats, counts):
        cap, context, W = stats["plan"]
        p_len = len(ref) // hop
        n, lens, processed, tl = 0, [], 0, stats["target_len"]
        while processed < tl:
            w = min(W, tl - processed)
            lens.append(p_len + w + 2)
            processed += w if processed + W >= tl else w - OVERLAP_FRAMES
            n += 1
        expect = {"k1": n * V2_STEPS * c.dit.depth, "k2": n * 109, "k3": 0}
        log(f"  {what}: plan {stats['plan']}, K1 at T = {context + 2} (B = 3), lens by chunk "
            f"{lens}, {n} chunks")
        if n != stats["chunks"]:
            fail(f"{what}: {stats['chunks']} chunks, the plan gives {n}")
        check_counts(what, counts, expect)
        return lens

    result = {}
    for run, synced in (("cold", False), ("warm", False), ("warm, stages synced", True)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, wave, stats = vc.convert_timbre(src, sr, ref, sr, profile=synced, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        secs = len(wave) / sr
        log(f"v2 timbre {run}: {wall:.3f} s wall for {secs:.2f} s of audio "
            f"({secs / wall:.2f} audio-s/s), {stats['chunks']} chunks, launches {counts}, "
            f"on {card}")
        log("  stages: " + json.dumps({k: round(v["seconds"], 4)
                                       for k, v in stats["stages"].items()}))
        if not np.isfinite(wave).all() or len(wave) != len(src) // hop * hop:
            fail(f"v2 timbre {run}: {len(wave)} samples (expected {len(src) // hop * hop}) "
                 "or non-finite audio")
        lens = check_plan(f"v2 timbre {run}", stats, counts)
        if stats["plan"][1] + 2 != V2_T or lens != [V2_LENS]:
            fail(f"v2 timbre: plan {stats['plan']}, lens {lens}; expected T = {V2_T}, lens "
                 f"[{V2_LENS}]")
        if run == "warm":
            result.update(wall_s=wall, audio_s=secs, counts=counts, lens=lens)
    if profile:
        profile_conversion(lambda: vc.convert_timbre(src, sr, ref, sr, **kw), result["wall_s"])

    voice = {}
    for mode in ("graph", "eager", "graph"):
        vc.generator.use_graph = mode == "graph"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, wave, stats = vc.convert_voice(src, sr, ref, sr, profile=mode == "eager", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        ms_tok = stats["ar_seconds"] / max(stats["decode_steps"], 1) * 1e3
        log(f"v2 voice ({mode} AR decode): {wall:.3f} s wall for {len(wave) / sr:.2f} s of "
            f"audio; narrow {stats['narrow_tokens']} -> wide {stats['wide_tokens']} tokens, "
            f"ar_batch {stats['ar_batch']}, decode steps {stats['decode_steps']}, replays "
            f"{stats['replays']}, AR {stats['ar_seconds']:.3f} s ({ms_tok:.4f} ms a token), "
            f"target_len {stats['target_len']}, launches {counts}, on {card}")
        log("  stages: " + json.dumps({k: round(v["seconds"], 4)
                                       for k, v in stats["stages"].items()}))
        if not np.isfinite(wave).all() or len(wave) != stats["target_len"] * hop:
            fail(f"v2 voice: {len(wave)} samples (expected {stats['target_len'] * hop}) or "
                 "non-finite audio")
        check_plan(f"v2 voice ({mode})", stats, counts)
        on_device = check_ar_counts(f"v2 voice ({mode})", counts, vc.generator, c.ar.n_layer,
                                    stats["decode_steps"])
        voice[mode] = dict(ms_per_token=ms_tok, stats=stats, wall_s=wall, counts=counts,
                           ar_on_device=on_device, replays=vc.generator.replays)
    vc.generator.use_graph = None
    g = voice["graph"]["stats"]
    if g["replays"] != g["decode_steps"] - 1:
        fail(f"v2 voice: {g['replays']} replays for {g['decode_steps']} decode steps")
    result["voice"] = voice
    if profile:
        from seedvc_tpu_torch.core.profiling import cuda_time_ms

        replay = vc.generator.graph.replay
        log(f"profile: one AR decode replay runs {device_kernels(replay)} device kernels, "
            f"{cuda_time_ms(replay, iters=20):.4f} ms of device time (CUDA events)")

    with tempfile.TemporaryDirectory() as tmp:
        src_path, ref_path = os.path.join(tmp, "src.wav"), os.path.join(tmp, "ref.wav")
        save_wav(src_path, src, sr)
        save_wav(ref_path, ref, sr)
        reset_counts()
        t0 = time.perf_counter()
        out_path, stats = infer_v2.main(["--source", src_path, "--target", ref_path,
                                         "--output", os.path.join(tmp, "out"),
                                         "--diffusion-steps", str(V2_STEPS)])
        torch.cuda.synchronize()
        wave, out_sr = load_wav(out_path)
        log(f"infer_v2 cli: {time.perf_counter() - t0:.1f} s (build included), wrote "
            f"{os.path.basename(out_path)}: {out_sr} Hz, {len(wave)} samples, wide tokens "
            f"{stats['wide_tokens']}, launches {read_counts()}")
        if out_sr != sr or len(wave) != stats["target_len"] * hop or not np.isfinite(wave).all():
            fail(f"infer_v2 wrote {out_sr} Hz, {len(wave)} samples, expected {sr} Hz and "
                 f"{stats['target_len'] * hop} finite samples")
    return result


# ---------------------------------------------------------------------------
# The v2 AR decode chain (ops/ar_decode.py, csrc/ar_decode.cu) at ARConfig()
# in bf16: each kernel against its plain twin and F.linear, and one decode
# step replayed from a CUDA graph, the chain against the plain step.
AR_ROWS = (1, 3)  # the v2_voice cell decodes 1-3 rows
AR_KEYS = (1000, 4000)  # about a 20 s source's keys, and near the cache's end
AR_SOURCE = "seedvc_tpu_torch/csrc/ar_decode.cu"
AR_REPLACES = "no Pallas kernel: seedvc_tpu/models/ar.py::ARTransformer.decode_step (XLA)"
AR_PATH = "v2 convert_voice (V2Config()), the AR decode from its CUDA graph"
# against the twin: a few bf16 roundings of the largest output (the sums' order differs)
AR_TOL = 2 ** -6


def ar_kernel_cases(model, B: int, keys: int):
    """{kernel: (call, twin call, output, bytes)} at layer 0's weights, B rows,
    ``keys`` valid slots a row (min_key 0, kv_pos keys - 1)."""
    import torch

    from seedvc_tpu_torch.ops import ar_decode as ad

    c, blk, dt = model.cfg, model.layers_0, model.output.weight.dtype
    g = torch.Generator(device="cuda").manual_seed(70 + B)
    kc, vc = (torch.randn((B, c.n_local_heads, c.max_seq_len, c.head_dim), generator=g,
                          device="cuda").to(dt) for _ in range(2))
    x = torch.randn((B, c.dim), generator=g, device="cuda").to(dt)
    s = ad.new_scratch(B, c, "cuda", dt)
    s.q.copy_(torch.randn(s.q.shape, generator=g, device="cuda") * 3)
    s.attn.normal_(generator=g)
    s.hidden.normal_(generator=g)
    kv, mk = torch.tensor(keys - 1, device="cuda"), torch.zeros(B, dtype=torch.long,
                                                                device="cuda")
    pos, table = torch.full((B,), keys - 1, device="cuda"), model.rope_table("cuda")
    el, att, eps = 2, blk.attention, c.norm_eps
    n_w = lambda *ws: sum(w.numel() for w in ws) * el  # noqa: E731
    kv_bytes = 2 * B * c.n_local_heads * keys * c.head_dim * el
    out = {}
    for name, args, res, nbytes in (
            ("attn_in", (x, blk.attention_norm.weight, att.wqkv.weight, table, pos, kv, s.q,
                         kc, vc, eps), 6, n_w(att.wqkv.weight) + 2 * B * c.dim * el),
            ("attention", (s.q, kc, vc, kv, mk, s.attn, s.part, s.counters), 5,
             kv_bytes + 2 * s.q.numel() * el),
            ("attn_out", (s.attn, att.wo.weight, x, s.x), 3, n_w(att.wo.weight)
             + 3 * B * c.dim * el),
            ("ffn_in", (x, blk.ffn_norm.weight, blk.feed_forward_w1.weight,
                        blk.feed_forward_w3.weight, s.hidden, eps), 4,
             n_w(blk.feed_forward_w1.weight, blk.feed_forward_w3.weight)
             + B * (c.dim + c.intermediate_size) * el),
            ("ffn_out", (s.hidden, blk.feed_forward_w2.weight, s.x), 2,
             n_w(blk.feed_forward_w2.weight) + B * (c.intermediate_size + 2 * c.dim) * el),
            ("head", (x, model.norm.weight, model.output.weight, s.logits, eps), 3,
             n_w(model.output.weight) + B * c.dim * el + s.logits.numel() * 4)):
        out[name] = (args, res, nbytes)
    return out


def ar_library_ms(model, B: int, name: str) -> float | None:
    """F.linear of the kernel's product(s) alone at B rows: the library's
    yardstick (None for attention, which no library call computes alike)."""
    import torch
    import torch.nn.functional as F

    from seedvc_tpu_torch.core.profiling import cuda_time_ms

    blk, dt = model.layers_0, model.output.weight.dtype
    ws = {"attn_in": (blk.attention.wqkv.weight,), "attn_out": (blk.attention.wo.weight,),
          "ffn_in": (blk.feed_forward_w1.weight, blk.feed_forward_w3.weight),
          "ffn_out": (blk.feed_forward_w2.weight,), "head": (model.output.weight,)}.get(name)
    if ws is None:
        return None
    xs = [torch.randn((B, w.shape[1]), device="cuda").to(dt) for w in ws]
    return cuda_time_ms(lambda: [F.linear(x, w) for x, w in zip(xs, ws)], iters=50)


def ar_step_graphs(model, B: int, keys: int) -> dict:
    """ms of one decode step replayed from a CUDA graph: the chain
    (``decode_chain``) and the plain step (``decode_step_reference``), at B
    rows with ``keys`` valid slots; the chain's launches by its counter, and
    each graph's device kernels by the profiler (whose sessions can drop a
    few edge records once many kernels ran in the process)."""
    import torch

    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.ops import ar_decode as ad

    c, dt = model.cfg, model.output.weight.dtype
    kc, vc = model.new_caches(B, "cuda", dt)
    kc.normal_()
    vc.normal_()
    x = torch.randn((B, 1, c.dim), device="cuda").to(dt)
    pos, kv = torch.full((B,), keys - 1, device="cuda"), torch.tensor(keys - 1, device="cuda")
    mk = torch.zeros(B, dtype=torch.long, device="cuda")
    s = ad.new_scratch(B, c, "cuda", dt)
    steps = {"chain": lambda: model.decode_chain(x, pos, kv, kc, vc, mk, s),
             "plain": lambda: model.decode_step_reference(x, pos, kv, kc, vc, mk)}
    out = {}
    for name, step in steps.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ad.LAUNCHES
        with torch.cuda.graph(graph):
            step()
        out[name + "_launches"] = ad.LAUNCHES - before
        out[name] = cuda_time_ms(graph.replay, iters=50)
        out[name + "_kernels"] = device_kernels(graph.replay)
    return out


def phase_ar_decode(card: str, v2: dict) -> dict:
    """The decode chain's kernels at ARConfig() bf16 (random weights, the
    wqkv 3x wider as in the benchmark): each against its twin and timed
    (kernel, twin, F.linear of its products, the bound by bytes), at 1 and 3
    rows, attention at 1,000 and 4,000 keys; then one decode step from a
    CUDA graph, the chain against the plain step; then ARGenerator's whole
    captured step (at most 130 kernels a replay, 61 of them the chain's).
    Each row's ``launches`` is what ran on the device in ``phase_v2_full``'s
    warm graphed voice conversion, from the wrappers' counts there
    (``check_ar_counts``); ``per_step`` is the eager conversion's count over
    its decode steps."""
    import torch

    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.models.ar import ARConfig, ARGenerator, ARTransformer
    from seedvc_tpu_torch.ops import ar_decode as ad

    torch.manual_seed(0)
    model = ARTransformer(ARConfig()).eval()
    with torch.no_grad():
        for i in range(model.cfg.n_layer):
            getattr(model, f"layers_{i}").attention.wqkv.weight.mul_(3.0)
    model = model.cuda().to(torch.bfloat16)
    rows, steps = [], {}
    graphed, eager = v2["voice"]["graph"], v2["voice"]["eager"]
    eager_steps = eager["stats"]["decode_steps"]
    with torch.no_grad():
        for B in AR_ROWS:
            for keys in AR_KEYS:
                for name, (args, res, nbytes) in ar_kernel_cases(model, B, keys).items():
                    if name != "attention" and keys != AR_KEYS[0]:
                        continue  # the products do not depend on the keys
                    kern = getattr(ad, name)
                    twin = getattr(ad, name + "_reference")
                    got = [a.clone() if torch.is_tensor(a) else a for a in args]
                    ref = [a.clone() if torch.is_tensor(a) else a for a in args]
                    kern(*got)
                    twin(*ref)
                    torch.cuda.synchronize()
                    err = float((got[res].float() - ref[res].float()).abs().max())
                    scale = float(ref[res].float().abs().max())
                    ms = cuda_time_ms(lambda: kern(*args), iters=50)
                    plain = cuda_time_ms(lambda: twin(*args), iters=10)
                    lib = ar_library_ms(model, B, name)
                    b_ms = nbytes / PEAK_BYTES * 1e3
                    what = f"B {B}" + (f", {keys} keys" if name == "attention" else "")
                    log(f"AR {name} ({what}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                        f"F.linear {'-' if lib is None else f'{lib:.4f}'} ms, bound "
                        f"{b_ms:.4f} ms (bytes, {b_ms / ms:.1%}), max |err| {err:.3g} of "
                        f"{scale:.3g}")
                    rows.append({"name": f"ar_{name}", "route": "cuda", "path": AR_PATH,
                                 "source": AR_SOURCE, "replaces": AR_REPLACES,
                                 "shape": what + " bf16, ARConfig()",
                                 "launches": graphed["ar_on_device"][name],
                                 "wrapper_count": graphed["counts"].get(f"ar_{name}", 0),
                                 "per_step": eager["counts"].get(f"ar_{name}", 0)
                                 / eager_steps,
                                 "replays": graphed["replays"],
                                 "max_abs_err": err, "tol": AR_TOL * max(scale, 1.0),
                                 "ms": ms,
                                 "plain_ms": plain, "bound_ms": b_ms, "bound_by": "bytes",
                                 "library_ms": lib})
                    if not err <= AR_TOL * max(scale, 1.0):
                        fail(f"AR {name} ({what}): max |err| {err} against the twin")
                steps[(B, keys)] = t = ar_step_graphs(model, B, keys)
                log(f"AR decode step from a CUDA graph, B {B}, {keys} keys: chain "
                    f"{t['chain']:.4f} ms ({t['chain_launches']} launches, "
                    f"{t['chain_kernels']} kernels traced), plain {t['plain']:.4f} ms "
                    f"({t['plain_kernels']} kernels traced), on {card}")
                if t["chain_launches"] != 5 * model.cfg.n_layer + 1:
                    fail(f"AR decode chain: {t['chain_launches']} launches a step, expected "
                         f"{5 * model.cfg.n_layer + 1}")
        # the whole captured step of ARGenerator: the chain, sampling and bookkeeping
        gen = ARGenerator(model, 40)
        g = torch.Generator(device="cuda").manual_seed(1)
        gen.generate(torch.randn((2, 256, model.cfg.dim), generator=g, device="cuda"),
                     torch.tensor([256, 100]),
                     torch.randint(0, 2048, (2, 64), generator=g, device="cuda"),
                     torch.tensor([40, 9]), seed=3)
        n_kernels = device_kernels(gen.graph.replay)
        replay_ms = cuda_time_ms(gen.graph.replay, iters=20)
    log(f"AR generate (2 rows): one replay of its decode step runs {n_kernels} device kernels "
        f"({gen.fused_launches} of the chain), {replay_ms:.4f} ms, on {card}")
    if n_kernels > 130 or gen.fused_launches != 5 * model.cfg.n_layer + 1:
        fail(f"AR generate: {n_kernels} kernels a replay, {gen.fused_launches} of the chain")
    return {"rows": rows, "steps": steps, "replay_kernels": n_kernels, "replay_ms": replay_ms}


# ---------------------------------------------------------------------------
# Training: v1 fine-tuning (the VCModel loss through K1 forward and K1ᵇ
# backward, AdamW), reduced cuda against cpu, then apps.train at full width.
TRAIN_DEPTH = 13
# cuda (K1, K1ᵇ) against cpu (twins), f32 with TF32 off: the loss to 1e-5
# relative, every parameter's gradient to 1e-4 relative L2, and after 3
# AdamW steps each parameter's change to 1e-3 relative L2 (Adam divides by
# sqrt(nu), which amplifies the gradients' last-digit differences where
# nu is small)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_STEP_RTOL = 1e-5, 1e-4, 1e-3
TRAIN_CLIP = 0.5
TRAIN_CLIPS = (4.0, 5.0, 6.0, 7.0, 8.0, 10.0, 11.0, 12.0, 29.7)


def small_train_params():
    """whisper_small_wavenet reduced: DiT 128 wide (2 heads of 64, K1's head
    width), depth 3, WaveNet 64 wide with 2 layers, regulator 128 wide fed
    64-wide content."""
    import dataclasses

    from seedvc_tpu_torch.core.config import get_preset

    mp = get_preset("whisper_small_wavenet").model_params
    return dataclasses.replace(
        mp, length_regulator=dataclasses.replace(mp.length_regulator, channels=128,
                                                 in_channels=64),
        DiT=dataclasses.replace(mp.DiT, hidden_dim=128, num_heads=2, depth=3, content_dim=128),
        wavenet=dataclasses.replace(mp.wavenet, hidden_dim=64, num_layers=2))


def rel_l2(a, b) -> float:
    return ((a.float().cpu() - b.float().cpu()).norm()
            / max(b.float().cpu().norm().item(), 1e-30)).item()


def phase_train_small():
    """(a) The reduced config on the same weights, batch and TrainDraws: loss
    and every gradient, cuda against cpu; then 3 AdamW steps (warmup, clip
    active) and the parameters they leave."""
    import torch

    from seedvc_tpu_torch.models.vc import VCModel, draw_train
    from seedvc_tpu_torch.ops import attention
    from seedvc_tpu_torch.train.optim import make_optimizer, warmup_cosine
    from seedvc_tpu_torch.train.step import init_state, make_train_step

    mp = small_train_params()
    depth = mp.DiT.depth
    torch.manual_seed(0)
    models = {"cpu": VCModel(mp)}
    models["cuda"] = VCModel(mp)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    models["cuda"].cuda()
    rng = np.random.default_rng(11)
    B, T, Ts = 2, 384, 192
    host = {"s_alt": rng.standard_normal((B, Ts, 64)), "s_ori": rng.standard_normal((B, Ts, 64)),
            "mels": rng.standard_normal((B, T, 80)) - 4.0, "style": rng.standard_normal((B, 192))}
    host = {k: torch.from_numpy(v.astype(np.float32)) for k, v in host.items()}
    host["mel_lens"] = torch.tensor([T, 301], dtype=torch.int32)
    host["s_lens"] = torch.tensor(171, dtype=torch.int32)
    p = mp.DiT.class_dropout_prob

    def draws_fn(key, shape, device):
        return draw_train(torch.Generator().manual_seed(100 + key), *shape, p)

    out = {}
    for dev, model in models.items():
        batch = {k: v.to(dev) for k, v in host.items()}
        draws = draws_fn(0, (B, T, 80), "cpu")
        draws = type(draws)(*(None if d is None else d.to(dev) for d in draws))
        reset_counts()
        loss, _ = model(batch["s_alt"], batch["s_ori"], batch["mels"], batch["mel_lens"],
                        batch["style"], draws, s_lens=batch["s_lens"])
        loss.backward()
        launched = (attention.LAUNCHES, attention.BWD_LAUNCHES, attention.DIT_ATTENTION_LAUNCHES)
        if launched != ((depth, depth, 0) if dev == "cuda" else (0, 0, 0)):
            fail(f"train small {dev}: launches (K1, K1b, K3) {launched}")
        grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()
                 if q.grad is not None}
        opt = make_optimizer(warmup_cosine(1e-3, 2, 10), grad_clip=TRAIN_CLIP)
        state = init_state(model, opt)
        p0 = {n: q.detach().clone() for n, q in model.named_parameters()}
        step = make_train_step(model, opt, draws_fn=draws_fn)
        norms = []
        for i in range(3):
            state, metrics = step(state, batch, i)
            norms.append(float(metrics["grad_norm"]))
        out[dev] = (loss.item(), grads,
                    {n: q.detach() - p0[n] for n, q in model.named_parameters()}, norms)
    (l_c, g_c, d_c, n_c), (l_p, g_p, d_p, n_p) = out["cuda"], out["cpu"]
    loss_rel = abs(l_c - l_p) / abs(l_p)
    grad_rel = max(rel_l2(g_c[n], g_p[n]) for n in g_p)
    step_rel = max(rel_l2(d_c[n], d_p[n]) for n in d_p)
    log(f"train small: loss cuda {l_c:.6f} cpu {l_p:.6f} (rel {loss_rel:.2e} tol "
        f"{TRAIN_LOSS_RTOL:g}); worst gradient rel_l2 {grad_rel:.2e} tol {TRAIN_GRAD_RTOL:g} "
        f"over {len(g_p)} parameters; grad norms cuda {n_c} cpu {n_p} (clip {TRAIN_CLIP}); "
        f"after 3 AdamW steps worst parameter-change rel_l2 {step_rel:.2e} tol "
        f"{TRAIN_STEP_RTOL:g}")
    if set(g_c) != set(g_p) or len(g_p) != sum(1 for _ in models["cpu"].parameters()):
        fail("train small: a parameter got no gradient")
    if loss_rel > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_RTOL or step_rel > TRAIN_STEP_RTOL:
        fail("train small: cuda and cpu disagree")
    if min(n_p) <= TRAIN_CLIP:
        fail("train small: the clip was not active")


def train_step_log(history) -> tuple[float, list]:
    """Steps/s over the steps after the first (log_interval 1 reads the loss
    each step, so each step's end is synchronised) and per-step records."""
    ends = [h["end"] for h in history]
    rate = (len(ends) - 1) / (ends[-1] - ends[0]) if len(ends) > 1 else float("nan")
    rows = []
    for i, h in enumerate(history):
        rows.append({"step": h["step"], "T": h["T"], "prep_s": round(h["prep_s"], 4),
                     "step_s": None if i == 0 else round(ends[i] - ends[i - 1], 4),
                     "loss": float(h["loss"]), "grad_norm": float(h["grad_norm"]),
                     "k1": h["k1"], "k1b": h["k1b"], "k3": h["k3"]})
    return rate, rows


def check_train_history(what: str, rows, first_step: int, n: int):
    if [r["step"] for r in rows] != list(range(first_step, first_step + n)):
        fail(f"{what}: steps {[r['step'] for r in rows]}")
    for r in rows:
        if (r["k1"], r["k1b"], r["k3"]) != (TRAIN_DEPTH, TRAIN_DEPTH, 0):
            fail(f"{what}: step {r['step']} launched K1/K1b/K3 {r['k1']}/{r['k1b']}/{r['k3']}, "
                 f"expected {TRAIN_DEPTH}/{TRAIN_DEPTH}/0")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            fail(f"{what}: step {r['step']} loss {r['loss']} grad norm {r['grad_norm']}")


def phase_train(card: str, profile: bool = False) -> dict:
    """(a) reduced, cuda against cpu; (b) ``apps.train`` at full width on
    synthetic clips: 6 steps, resume to 9, 3 steps in bf16, 10 steps on one
    fixed batch and draws, the export converted by ``VoiceConverter``."""
    import pickle
    import tempfile

    import torch

    from seedvc_tpu_torch.apps import train as train_app
    from seedvc_tpu_torch.apps.audio_io import save_wav
    from seedvc_tpu_torch.models.vc import draw_train
    from seedvc_tpu_torch.ops import attention
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.train.optim import make_optimizer
    from seedvc_tpu_torch.train.step import init_state, make_train_step

    phase_train_small()
    sr = 22050
    result = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="train_smoke_") as tmp:
        data, export = os.path.join(tmp, "data"), os.path.join(tmp, "export")
        os.makedirs(data)
        for i, secs in enumerate(TRAIN_CLIPS):
            save_wav(os.path.join(data, f"clip{i}.wav"),
                     synthetic_audio(secs, sr, 110.0 + 17 * i, seed=60 + i), sr)
        os.chdir(tmp)  # apps.train writes ./runs/<run-name>
        try:
            base = ["--dataset-dir", data, "--batch-size", "2", "--log-interval", "1",
                    "--export-dir", export]
            for what, extra, first, n in (
                    ("train f32", ["--max-steps", "6", "--save-interval", "3"], 1, 6),
                    ("train resume", ["--max-steps", "9", "--save-interval", "3"], 7, 3),
                    ("train bf16", ["--max-steps", "3", "--run-name", "bf16",
                                    "--compute-dtype", "bfloat16", "--save-interval", "100"],
                     1, 3)):
                reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer = train_app.main(base + extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rate, rows = train_step_log(trainer.history)
                for r in rows:
                    log(f"  {what} step {r}")
                check_train_history(what, rows, first, n)
                totals = (attention.LAUNCHES, attention.BWD_LAUNCHES,
                          attention.DIT_ATTENTION_LAUNCHES)
                if totals != (TRAIN_DEPTH * n, TRAIN_DEPTH * n, 0):
                    fail(f"{what}: launches (K1, K1b, K3) {totals} for {n} steps")
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                prep = float(np.mean([r["prep_s"] for r in rows]))
                step_s = [r["step_s"] for r in rows if r["step_s"] is not None]
                log(f"{what}: {n} steps in {wall:.1f} s wall (models built, data read, "
                    f"saved and exported included); {rate:.3f} steps/s after the first; "
                    f"prep {prep:.3f} s a step on the worker; step seconds (end to end, "
                    f"a checkpoint save after steps 3 and 6 included) {step_s}, median "
                    f"{float(np.median(step_s)) if step_s else float('nan'):.4f}; "
                    f"T by step {[r['T'] for r in rows]}; peak device memory {peak:.2f} GiB; "
                    f"launches (K1, K1b, K3) {totals}; {card}")
                result[what] = {"steps_per_s": rate, "prep_s": prep, "step_s": step_s,
                                "T": [r["T"] for r in rows], "peak_gib": peak,
                                "launches": totals, "wall_s": wall,
                                "losses": [r["loss"] for r in rows]}

            # 10 steps on one fixed batch with fixed draws lower the loss
            model = trainer.model
            batch = next(iter(FTDataset(data, sr, 2).batches(shuffle=False)))
            feats = trainer.prepare_batch(batch, np.random.default_rng(0), cache=False)
            B, T = feats["mels"].shape[:2]
            fixed = draw_train(torch.Generator(device="cuda").manual_seed(5), B, T, 80,
                               model.mp.DiT.class_dropout_prob, device="cuda")
            model.float()
            opt = make_optimizer(1e-4)
            state = init_state(model, opt)
            step = make_train_step(model, opt, draws_fn=lambda *_a: fixed)
            losses, walls = [], []
            for i in range(10):
                t0 = time.perf_counter()
                state, metrics = step(state, feats, i)
                losses.append(float(metrics["loss"]))  # reads the device: a synchronised step
                walls.append(time.perf_counter() - t0)
            fixed_wall = float(np.median(walls[1:]))
            log(f"train fixed batch (B={B}, T={T}): losses over 10 steps "
                f"{[round(x, 5) for x in losses]}; step wall median {fixed_wall:.4f} s; {card}")
            if not losses[-1] < losses[0]:
                fail("train: 10 steps on one fixed batch did not lower the loss")
            result["fixed"] = {"T": T, "step_wall_s": fixed_wall}
            if profile:
                profile_conversion(lambda: step(state, feats, 0), fixed_wall)
                # the step at the training rows' two T: wall, device time and
                # the share of K1 and K1ᵇ
                shapes = train_shapes(result["train f32"]["T"])
                ds = FTDataset(data, sr, 2)
                # the run's own batches (an epoch drops the odd clip out)
                for batch in (b for e in range(4) for b in ds.batches(epoch=e)):
                    if not shapes:
                        break
                    feats = trainer.prepare_batch(batch, np.random.default_rng(0), cache=False)
                    B, T = feats["mels"].shape[:2]
                    if T not in shapes:
                        continue
                    shapes.remove(T)
                    fixed = draw_train(torch.Generator(device="cuda").manual_seed(5), B, T, 80,
                                       model.mp.DiT.class_dropout_prob, device="cuda")
                    step = make_train_step(model, opt, draws_fn=lambda *_a, d=fixed: d)
                    result[f"step_T{T}"] = train_step_account(step, state, feats, B, T, card)

            # the export converts on the card
            with open(os.path.join(export, "vc.pkl"), "rb") as f:
                tree = pickle.load(f)
            vc = VoiceConverter(vc_params=tree, device="cuda")
            src = synthetic_audio(5.0, sr, 150.0, seed=71)
            ref = synthetic_audio(3.0, sr, 210.0, seed=72)
            _, wave, _ = vc.convert(src, sr, ref, sr, diffusion_steps=10, cfg_rate=0.7)
            expect = len(src) // vc.hop * vc.hop
            log(f"train export: converted 5 s with the exported weights: {len(wave)} samples "
                f"(expected {expect}), finite {bool(np.isfinite(wave).all())}")
            if len(wave) != expect or not np.isfinite(wave).all():
                fail("train: the exported weights did not convert")
        finally:
            os.chdir(cwd)
    return result


def train_shapes(ts: list) -> list:
    """A training run's largest T and its commonest other T (the smaller on
    a tie), from the T of its steps: the shapes of the training rows and of
    the step account."""
    import collections

    t_counts = collections.Counter(ts)
    rest = sorted(t for t in t_counts if t != max(t_counts))
    return sorted({max(t_counts)} | ({max(rest, key=lambda t: (t_counts[t], -t))}
                                     if rest else set()))


def train_step_account(step, state, feats, B: int, T: int, card: str) -> dict:
    """One f32 train step on a fixed batch at mel length T: its synchronised
    wall (median of 5 after 2 warm-ups) and, from one profiled step, the
    device time by kernel (the top rows), and the share of it that K1 (RoPE
    pre-pass and core) and K1ᵇ (its four kernels) take."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    walls = []
    for i in range(7):
        t0 = time.perf_counter()
        float(step(state, feats, i)[1]["loss"])  # reads the device: a synchronised step
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls[2:]))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, feats, 0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3

    def ms(names):
        return sum(e.self_device_time_total for e in kernels
                   if any(n in e.key for n in names)) / 1e3

    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))
    k1 = ms(("attn_fwd_tf32", "rope_prepass_f32"))
    k1b = ms(("bwd_prep_kernel", "bwd_dkdv_kernel", "bwd_finish_kernel"))
    log(f"train step account (B={B}, T={T}, f32): wall {wall:.4f} s (median of 5), device "
        f"{busy:.2f} ms (idle {1 - busy / 1e3 / wall:.3f}); K1 {k1:.2f} ms ({k1 / busy:.1%}), "
        f"K1b {k1b:.2f} ms ({k1b / busy:.1%}), both {(k1 + k1b) / busy:.1%} of device time; "
        f"{card}")
    return {"wall_s": wall, "device_ms": busy, "k1_ms": k1, "k1b_ms": k1b}


TRAIN_KINDS = (("float32", "fwd"), ("float32", "bwd"), ("bfloat16", "bwd"))


def train_rows(ts: list, card: str, path: str, kinds=TRAIN_KINDS) -> list:
    """The kernels line's training rows: K1 f32 and K1ᵇ f32 / bf16 at the T
    a run used most and at its largest T (``ts``: the T of its steps), q/k/v
    (2, 8, T, 64) with every key valid; launches at that T in the run, 13 a
    step (K1ᵇ bf16 is on no training path: bf16 compute runs attention in
    f32, as the JAX step's type promotion does). K1 is timed writing the
    log-sum-exp and K1ᵇ given it, as the autograd Functions call them (K1ᵇ
    computing the statistics itself is timed and printed too). The f32
    bounds are at 3xTF32, bf16 at the bf16 peak. Library: SDPA forward, and
    SDPA's backward alone (autograd.grad through a retained graph)."""
    import collections

    t_counts = collections.Counter(ts)
    rows = []
    for T in train_shapes(ts):
        rows += train_kernel_rows(T, 2, 8, TRAIN_DEPTH * t_counts[T], card, path, kinds)
    return rows


def train_kernel_rows(T: int, B: int, H: int, launches: int, card: str, path: str,
                      kinds=TRAIN_KINDS, launches_per_step: int = TRAIN_DEPTH) -> list:
    """:func:`train_rows`' rows at q/k/v (B, H, T, 64), every key valid."""
    import torch
    import torch.nn.functional as F

    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.ops import attention

    rows = []
    for dtype, kernel in ((getattr(torch, dt), kind) for dt, kind in kinds):
        q, k, v, cos, sin, _ = _k1_inputs(T, dtype, None, seed=T, heads=H, B=B)
        B, H, _, d = q.shape
        g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda").to(dtype)
        qr = attention.rope_scaled_reference(q, cos, sin)
        kr = attention.rope_scaled_reference(k, cos, sin)
        size = q.element_size()
        f32 = dtype == torch.float32
        own = None
        if kernel == "fwd":
            out = attention.dit_attention_fused(q, k, v, cos, sin)
            err = (out - attention.dit_attention_fused_reference(q, k, v, cos, sin)
                   ).abs().max().item()
            ms = cuda_time_ms(lambda: attention.dit_attention_fused(q, k, v, cos, sin,
                                                                    return_lse=True))
            plain = cuda_time_ms(lambda: attention.dit_attention_fused_reference(
                q, k, v, cos, sin), iters=5)
            lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v))
            b_ms, b_by = bound_3xtf32(4.0 * B * H * T * T * d,
                                      4 * B * H * T * d * size + 2 * T * d * 4 + B * H * T * 4)
            name, n, replaces = ("dit_attention_fused", launches,
                                 "seedvc_tpu/ops/pallas/attention.py:171")
            source = "seedvc_tpu_torch/csrc/attention.cu"
        else:
            o, lse = attention.dit_attention_fused(q, k, v, cos, sin, return_lse=True)
            got = attention.dit_attention_fused_bwd(q, k, v, cos, sin, None, o, g, lse)
            ref = attention.dit_attention_fused_bwd_reference(q, k, v, cos, sin, None, g)
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
            ms = cuda_time_ms(lambda: attention.dit_attention_fused_bwd(
                q, k, v, cos, sin, None, o, g, lse), iters=10)
            own = cuda_time_ms(lambda: attention.dit_attention_fused_bwd(
                q, k, v, cos, sin, None, o, g), iters=10)
            plain = cuda_time_ms(lambda: attention.dit_attention_fused_bwd_reference(
                q, k, v, cos, sin, None, g), iters=3)
            leaves = [t.detach().clone().requires_grad_() for t in (qr, kr, v)]
            lib_out = F.scaled_dot_product_attention(*leaves)
            lib = cuda_time_ms(lambda: torch.autograd.grad(lib_out, leaves, g,
                                                           retain_graph=True), iters=10)
            ops, nbytes = 10.0 * B * H * T * T * d, 8 * B * H * T * d * size + 2 * T * d * 4
            b_ms, b_by = (bound_3xtf32(ops, nbytes + (B * H * T * 4 if f32 else 0)) if f32
                          else bound(ops, PEAK_BF16, nbytes))
            name = "dit_attention_bwd"
            n = launches if dtype == torch.float32 else 0
            replaces = ("no Pallas kernel: the XLA recompute bwd of _fused_diff / "
                        "_plain_diff, seedvc_tpu/ops/pallas/attention.py:326-335, :353-362")
            source = "seedvc_tpu_torch/csrc/attention_bwd.cu"
        dt = str(dtype).split(".")[1]
        rate = BOUND_3XTF32 if f32 else "the 989 TFLOP/s dense bf16 peak"
        log(f"{name} ({kernel}) q/k/v {tuple(q.shape)} {dt}: kernel {ms:.4f} ms"
            + ("" if own is None else f" (computing its own statistics {own:.4f} ms)")
            + f", plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}"
            f"{' (3xTF32)' if f32 and b_by == 'operations' else ''}), share "
            f"{b_ms / ms:.3f}, max_abs_err {err:.3e}; {card}")
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "path": path if n else "none on the training path (phase 3 only)",
               "shape": f"q/k/v {tuple(q.shape)} {dt}, lens None",
               "launches": n, "launches_per_step": launches_per_step if n else 0,
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by, "bound_rate": rate,
               "share": b_ms / ms, "library_ms": lib, "card": card}
        if own is not None:
            row["ms_own_statistics"] = own
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# v2 fine-tuning: the joint AR + CFM loss, K1 f32 forward and K1ᵇ backward in
# the DiT's trunk; reduced cuda against cpu, then apps.train_v2 at full width.
# Limits as the v1 training phase's (TRAIN_*_RTOL); the distillation term,
# a squared difference of two close losses, to 1e-5 of the loss.
V2T_CLIP = 0.5


def small_v2_cfg():
    """tests/test_trainer_v2.py's tiny v2 sizes, with the DiT at 8 heads of
    64 (512 wide, depth 2): K1's head width."""
    from seedvc_tpu_torch.models.ar import ARConfig
    from seedvc_tpu_torch.models.astral import AstralConfig
    from seedvc_tpu_torch.models.dit_v2 import DiTV2Config
    from seedvc_tpu_torch.models.ssl import SSLConfig
    from seedvc_tpu_torch.pipelines.convert_v2 import V2Config

    return V2Config(
        dit=DiTV2Config(hidden_dim=512, depth=2, num_heads=8, content_dim=32,
                        style_encoder_dim=24),
        ar=ARConfig(dim=32, n_layer=2, n_head=4, n_local_heads=2, head_dim=8,
                    intermediate_size=64, vocab_size=33, max_seq_len=1024),
        ssl=SSLConfig(conv_dim=16, d_model=32, n_layers=1, n_heads=4, ffn_dim=64),
        narrow=AstralConfig(dim=24, intermediate_dim=48, num_blocks=1, input_dim=32,
                            codebook_size=8),
        wide=AstralConfig(dim=24, intermediate_dim=48, num_blocks=1, input_dim=32,
                          codebook_size=32))


def v2_batch(secs, seed: int):
    """A dataset batch of synthetic clips of ``secs`` seconds (their own 16 kHz
    renderings as the 16 kHz waves)."""
    from seedvc_tpu_torch.train.dataset import Batch

    waves = [synthetic_audio(x, V2T_SR, 120.0 + 31 * i, seed + i) for i, x in enumerate(secs)]
    w16 = [synthetic_audio(x, 16000, 120.0 + 31 * i, seed + i) for i, x in enumerate(secs)]

    def pad(ws):
        out = np.zeros((len(ws), max(len(w) for w in ws)), np.float32)
        for i, w in enumerate(ws):
            out[i, :len(w)] = w
        return out

    return Batch(pad(waves), pad(w16), np.array([len(w) for w in waves], np.int32),
                 np.array([len(w) for w in w16], np.int32))


def phase_train_v2_small():
    """(a) The reduced v2 trainer on cuda (K1 f32, K1ᵇ) and on cpu (twins),
    the same weights (both built from one seed), batch and draws: the first
    step's losses and every gradient, the parameters after 3 steps with
    warmup and the global clip active; with ``train_ar=False`` the AR and
    its regulator stay bit for bit and hold no moments; one distillation
    step."""
    import torch

    from seedvc_tpu_torch.ops import attention
    from seedvc_tpu_torch.train.trainer_v2 import TrainerV2, TrainerV2Config, draw_train_v2
    from seedvc_tpu_torch.weights import to_jax_params

    cfg = small_v2_cfg()
    depth, p = cfg.dit.depth, cfg.dit.class_dropout_prob

    def draws_fn(key, shape, device):
        return draw_train_v2(torch.Generator().manual_seed(100 + key[-1]), *shape, p)

    def make(device, teacher=None, **over):
        tc = TrainerV2Config(batch_size=2, warmup_steps=2, max_steps=10, base_lr=1e-3,
                             grad_clip=V2T_CLIP, **over)
        return TrainerV2(cfg, tc, device=device, draws_fn=draws_fn, teacher_params=teacher)

    host = make("cpu")
    feats_h, dims = host.prepare_batch(v2_batch((4.0, 3.2), seed=80))
    out = {}
    for dev in ("cuda", "cpu"):
        tr = host if dev == "cpu" else make("cuda")
        feats = {k: v.to(dev) for k, v in feats_h.items()}
        p0 = {n: q.detach().clone() for n, q in tr.model.named_parameters()}
        reset_counts()
        m1 = {k: float(v) for k, v in tr._device_step(feats, dims, (0, 0)).items()}
        launched = (attention.LAUNCHES, attention.BWD_LAUNCHES, attention.DIT_ATTENTION_LAUNCHES)
        if launched != ((depth, depth, 0) if dev == "cuda" else (0, 0, 0)):
            fail(f"train_v2 small {dev}: launches (K1, K1b, K3) {launched} in one step")
        grads = {n: q.grad.detach().clone() for n, q in tr.model.named_parameters()
                 if q.grad is not None}
        norms = [m1["grad_norm"]] + [float(tr._device_step(feats, dims, (0, i))["grad_norm"])
                                     for i in (1, 2)]
        out[dev] = (m1, grads, {n: q.detach() - p0[n] for n, q in tr.model.named_parameters()},
                    norms)
    (m_c, g_c, d_c, n_c), (m_p, g_p, d_p, n_p) = out["cuda"], out["cpu"]
    loss_rel = max(abs(m_c[k] - m_p[k]) / abs(m_p[k]) for k in ("loss_cfm", "loss_ar"))
    grad_rel = max(rel_l2(g_c[n], g_p[n]) for n in g_p)
    step_rel = max(rel_l2(d_c[n], d_p[n]) for n in d_p)
    log(f"train_v2 small (T={dims['mel_T'] + 2}): loss_cfm cuda {m_c['loss_cfm']:.6f} cpu "
        f"{m_p['loss_cfm']:.6f}, loss_ar cuda {m_c['loss_ar']:.6f} cpu {m_p['loss_ar']:.6f} "
        f"(worst rel {loss_rel:.2e} tol {TRAIN_LOSS_RTOL:g}); worst gradient rel_l2 "
        f"{grad_rel:.2e} tol {TRAIN_GRAD_RTOL:g} over {len(g_p)} parameters; grad norms cuda "
        f"{n_c} cpu {n_p} (global clip {V2T_CLIP}); after 3 steps worst parameter-change "
        f"rel_l2 {step_rel:.2e} tol {TRAIN_STEP_RTOL:g}")
    n_params = sum(1 for _ in host.model.parameters())
    if set(g_c) != set(g_p) or len(g_p) != n_params:
        fail("train_v2 small: a parameter got no gradient")
    if loss_rel > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_RTOL or step_rel > TRAIN_STEP_RTOL:
        fail("train_v2 small: cuda and cpu disagree")
    if min(n_p + n_c) <= V2T_CLIP:
        fail("train_v2 small: the global clip was not active")

    # train_ar=False on the card: the AR branch stays bit for bit, no moments
    tr = make("cuda", train_ar=False)
    feats = {k: v.cuda() for k, v in feats_h.items()}
    before = {n: q.detach().clone() for n, q in tr.model.named_parameters()}
    reset_counts()
    for i in range(2):
        m = tr._device_step(feats, dims, (0, i))
    moved = {n for n, q in tr.model.named_parameters() if not torch.equal(q, before[n])}
    frozen_ok = all(n.startswith(("dit.", "cfm_reg.")) for n in moved) and any(
        n.startswith("dit.") for n in moved)
    ar_state = tr.state.opt_state.groups["ar"]
    log(f"train_v2 small train_ar=False: {len(moved)} of {len(before)} parameters moved, all "
        f"in dit/cfm_reg: {frozen_ok}; ar moments {len(ar_state.mu)}, count {ar_state.count}; "
        f"metrics {sorted(m)}; launches (K1, K1b) {attention.LAUNCHES, attention.BWD_LAUNCHES}")
    if not frozen_ok or ar_state.mu or ar_state.count or "loss_ar" in m:
        fail("train_v2 small: train_ar=False changed the AR branch")
    if (attention.LAUNCHES, attention.BWD_LAUNCHES) != (2 * depth, 2 * depth):
        fail("train_v2 small: train_ar=False launched the wrong K1/K1b count")

    # one distillation step, cuda against cpu: the teacher is the trained
    # host's weights perturbed, both terms on
    rng = np.random.default_rng(3)

    def perturbed(tree):
        return {k: perturbed(v) if isinstance(v, dict)
                else (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    teacher = perturbed(to_jax_params(host.model))
    dist = {}
    for dev in ("cuda", "cpu"):
        tr = make(dev, teacher=teacher, distill_cfm=True, distill_ar=True)
        feats = {k: v.to(dev) for k, v in feats_h.items()}
        dist[dev] = {k: float(v) for k, v in tr._device_step(feats, dims, (0, 0)).items()}
    worst = max(abs(dist["cuda"][k] - dist["cpu"][k]) for k in dist["cpu"] if k != "grad_norm")
    log(f"train_v2 small distillation: cuda {dist['cuda']} cpu {dist['cpu']}; worst loss "
        f"difference {worst:.2e} tol {TRAIN_LOSS_RTOL:g} x loss")
    if set(dist["cuda"]) != set(dist["cpu"]) or not dist["cpu"]["loss_distill"] > 0:
        fail("train_v2 small: the distillation step gave no distillation term")
    if worst > TRAIN_LOSS_RTOL * dist["cpu"]["loss"]:
        fail("train_v2 small: the distillation step disagrees between cuda and cpu")


def phase_train_v2(card: str, profile: bool = False) -> dict:
    """(a) reduced, cuda against cpu; (b) ``apps.train_v2`` at full width
    (``V2Config()``, random weights) on eight synthetic clips of 4-12 s,
    B = 2: 6 steps saving at 3 and 6, a run that resumes at 6 and trains to
    9 (each step 13 K1, 13 K1ᵇ, 0 K3, a finite loss and grad norm), 3 steps
    with ``--train-cfm false`` (no K1, no K1ᵇ), then 10 steps on one fixed
    batch and draws with a fresh optimizer, which must lower the loss; with
    ``profile``, one profiled step of that batch (the step's account)."""
    import tempfile

    import torch

    from seedvc_tpu_torch.apps import train_v2 as train_v2_app
    from seedvc_tpu_torch.apps.audio_io import save_wav
    from seedvc_tpu_torch.ops import attention
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.train.optim import make_v2_optimizer
    from seedvc_tpu_torch.train.trainer_v2 import V2TrainState, draw_train_v2

    phase_train_v2_small()
    result = {"T": []}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="train_v2_smoke_") as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for i, secs in enumerate(V2T_CLIPS):
            save_wav(os.path.join(data, f"clip{i}.wav"),
                     synthetic_audio(secs, V2T_SR, 105.0 + 19 * i, seed=90 + i), V2T_SR)
        os.chdir(tmp)  # apps.train_v2 writes ./runs/<run-name>
        try:
            base = ["--dataset-dir", data, "--batch-size", "2", "--log-interval", "1"]
            for what, extra, first, n, per_step in (
                    ("train_v2", ["--max-steps", "6", "--save-interval", "3"], 1, 6, TRAIN_DEPTH),
                    ("train_v2 resume", ["--max-steps", "9", "--save-interval", "3"], 7, 3,
                     TRAIN_DEPTH),
                    ("train_v2 cfm off", ["--max-steps", "3", "--run-name", "ar_only",
                                          "--train-cfm", "false", "--save-interval", "100"],
                     1, 3, 0)):
                trainer = None
                torch.cuda.empty_cache()
                reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer = train_v2_app.main(base + extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rate, rows = train_step_log(trainer.history)
                for r in rows:
                    log(f"  {what} step {r}")
                if [r["step"] for r in rows] != list(range(first, first + n)):
                    fail(f"{what}: steps {[r['step'] for r in rows]}")
                for r in rows:
                    if (r["k1"], r["k1b"], r["k3"]) != (per_step, per_step, 0):
                        fail(f"{what}: step {r['step']} launched K1/K1b/K3 "
                             f"{r['k1']}/{r['k1b']}/{r['k3']}, expected {per_step}/{per_step}/0")
                    if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                        fail(f"{what}: step {r['step']} loss {r['loss']} grad norm "
                             f"{r['grad_norm']}")
                totals = (attention.LAUNCHES, attention.BWD_LAUNCHES,
                          attention.DIT_ATTENTION_LAUNCHES)
                if totals != (per_step * n, per_step * n, 0):
                    fail(f"{what}: launches (K1, K1b, K3) {totals} for {n} steps")
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                prep = float(np.mean([r["prep_s"] for r in rows]))
                step_s = [r["step_s"] for r in rows if r["step_s"] is not None]
                log(f"{what}: {n} steps in {wall:.1f} s wall (models built, data read and "
                    f"saved included); {rate:.3f} steps/s after the first; prep {prep:.3f} s "
                    f"a step on the worker; step seconds (end to end, saves included) "
                    f"{step_s}, median "
                    f"{float(np.median(step_s)) if step_s else float('nan'):.4f}; T by step "
                    f"{[r['T'] + 2 for r in rows]} (mel bucket + 2); peak device memory "
                    f"{peak:.2f} GiB; launches (K1, K1b, K3) {totals}; {card}")
                result[what] = {"steps_per_s": rate, "prep_s": prep, "step_s": step_s,
                                "T": [r["T"] + 2 for r in rows], "peak_gib": peak,
                                "launches": totals, "wall_s": wall}
                if per_step:
                    result["T"] += [r["T"] + 2 for r in rows]
                    cfm_trainer = trainer

            # 10 steps on one fixed batch (the longest clips: the run's
            # largest T) with fixed draws and a fresh optimizer (constant LR
            # 1e-4) lower the loss
            trainer = cfm_trainer
            batch = max(FTDataset(data, V2T_SR, 2).batches(shuffle=False),
                        key=lambda b: int(b.wave_lengths.max()))
            feats, dims = trainer.prepare_batch(batch)
            B, T = feats["mels"].shape[:2]
            fixed = draw_train_v2(torch.Generator(device="cuda").manual_seed(5), B, T, 80,
                                  trainer.vcfg.dit.class_dropout_prob, device="cuda")
            trainer.draws_fn = lambda *_a: fixed
            trainer.optimizer = make_v2_optimizer(1e-4)
            params = trainer.state.params
            trainer.state = V2TrainState(params, trainer.optimizer.init(params), 0,
                                         trainer.state.layout)
            losses, walls = [], []
            for i in range(10):
                t0 = time.perf_counter()
                losses.append(float(trainer._device_step(feats, dims, (0, i))["loss"]))
                walls.append(time.perf_counter() - t0)  # float() read the device
            fixed_wall = float(np.median(walls[1:]))
            log(f"train_v2 fixed batch (B={B}, T={T + 2}, ar_C={dims['ar_C']}, "
                f"ar_X={dims['ar_X']}): losses over 10 steps {[round(x, 5) for x in losses]}; "
                f"step wall median {fixed_wall:.4f} s; {card}")
            if not losses[-1] < losses[0]:
                fail("train_v2: 10 steps on one fixed batch did not lower the loss")
            result["fixed"] = {"T": T + 2, "step_wall_s": fixed_wall}
            if profile:
                result["account"] = train_step_account(
                    lambda _st, _f, i: (None, trainer._device_step(feats, dims, (0, i))),
                    None, feats, B, T + 2, card)
        finally:
            os.chdir(cwd)
    return result


# ---------------------------------------------------------------------------
# The OpenVoice timbre perturbation of v1 fine-tuning (phase 11) and the
# evaluation harness (phase 12). The converter and WavLM-SV run cuDNN
# convolutions, cuDNN's GRU and plain products (TF32 off) and no kernel of the
# port; the perturbed train step runs K1 f32 and K1ᵇ, each eval conversion K1
# bf16 and K2. Limits as tests/test_torch_cuda.py: OpenVoice's speaker
# embeddings and its wave 1e-5 absolute, cuda against cpu; WavLM-SV 1e-5
# relative L2 cuda against cpu and padded against unpadded. Each cuda-against-
# cpu check also runs with TF32 on (its planted fault), which it must see.
OV_SE_TOL, OV_WAVE_TOL = 1e-5, 1e-5
WAVLM_TOL, WAVLM_PAD_TOL = 1e-5, 1e-5
OV_STEPS, OV_SE_DB_ROWS = 3, 8
EVAL_SRC_SECS, EVAL_REF_SECS = (10.0, 6.0), 5.0
EVAL_PATH = "apps.eval conversions (whisper_small_wavenet, 10 s and 6 s sources)"
EVAL_F0_PATH = "apps.eval --f0-metrics conversion (whisper_base_f0_44k, 10 s source)"


@contextlib.contextmanager
def tf32():
    """TF32 on for cuDNN and matmuls, the planted fault of the f32 checks."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def random_openvoice(cfg, seed: int):
    import torch

    from seedvc_tpu_torch.models.openvoice import ToneColorConverter, draw_post

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return draw_post(ToneColorConverter(cfg)).requires_grad_(False).eval()


def openvoice_check(what: str, cfg, seconds: float, seed: int):
    """``cfg``'s converter (random weights and post) on cpu and cuda, the same
    noise, on ``seconds`` of a synthetic 22.05 kHz clip: ``extract_se`` and
    ``voice_conversion`` compared, and compared again with TF32 on, which the
    limits must catch; the target embedding must move the wave. Returns the
    converter on cuda."""
    import copy

    import torch

    from seedvc_tpu_torch.models.openvoice import linear_spectrogram

    ov = random_openvoice(cfg, seed)
    wave = torch.from_numpy(synthetic_audio(seconds, 22050, 150.0, seed=seed))[None]

    def run(dev, m):
        spec = linear_spectrogram(wave.to(dev))
        T = spec.shape[1]
        noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (1, T, cfg.inter_channels)).astype(np.float32)).to(dev)
        g_tgt = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
            (1, cfg.gin_channels)).astype(np.float32)).to(dev)
        se = m.extract_se(spec)
        lens = torch.tensor([T], device=dev)
        return [t.cpu() for t in (se, m.voice_conversion(spec, lens, se, g_tgt, noise, 0.3),
                                  m.voice_conversion(spec, lens, se, se, noise, 0.3))]

    with torch.no_grad():
        se_p, w_p, _ = run("cpu", copy.deepcopy(ov))
        se_c, w_c, same_c = run("cuda", ov.cuda())
        with tf32():
            se_t, w_t, _ = run("cuda", ov)
    se_err, w_err = (se_c - se_p).abs().max().item(), (w_c - w_p).abs().max().item()
    se_tf32, w_tf32 = (se_t - se_p).abs().max().item(), (w_t - w_p).abs().max().item()
    moved = (w_c - same_c).abs().max().item()
    log(f"{what}: extract_se {tuple(se_c.shape)} cuda vs cpu max_abs_err {se_err:.3e} tol "
        f"{OV_SE_TOL:g}; voice_conversion {tuple(w_c.shape)} max_abs_err {w_err:.3e} tol "
        f"{OV_WAVE_TOL:g} (wave max {w_p.abs().max().item():.3f}); with TF32 on (planted "
        f"fault) {se_tf32:.3e} and {w_tf32:.3e}; a N(0, 1) target embedding in place of the "
        f"source's moves the wave by {moved:.3e}")
    if not (torch.isfinite(w_c).all() and se_err <= OV_SE_TOL and w_err <= OV_WAVE_TOL):
        fail(f"{what}: cuda and cpu disagree")
    if not (se_tf32 > OV_SE_TOL or w_tf32 > OV_WAVE_TOL):
        fail(f"{what}: the limits do not see TF32")
    if not moved > 0.01 * w_p.abs().max().item():
        fail(f"{what}: the target speaker embedding does not act")
    return ov


def phase_openvoice_train(card: str):
    """Phase 11: the converter reduced and at full width, cuda against cpu,
    the full one's ms a call on 10 s; then ``apps.train`` at full width on
    phase 10's clips with an ``openvoice.pkl`` (the batch's voices shuffled)
    and with a ``se_db.pkl`` beside it, 3 steps each: 13 K1 f32, 13 K1ᵇ, 0 K3
    and a finite loss a step, the perturbed content unlike the clean, and the
    converter's share of a synchronised prep."""
    import pickle
    import tempfile

    import torch

    from seedvc_tpu_torch.apps import train as train_app
    from seedvc_tpu_torch.apps.audio_io import save_wav
    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.models.openvoice import OpenVoiceConfig, linear_spectrogram
    from seedvc_tpu_torch.ops import attention
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.weights import to_jax_params

    openvoice_check("openvoice reduced", OpenVoiceConfig(
        inter_channels=64, hidden_channels=64, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3, 5),), upsample_initial_channel=128), 2.0, seed=30)
    ov = openvoice_check("openvoice full", OpenVoiceConfig(), 2.0, seed=31)
    with torch.no_grad():
        spec = linear_spectrogram(torch.from_numpy(
            synthetic_audio(10.0, 22050, 150.0, seed=32))[None].cuda())
        T = spec.shape[1]
        se = ov.extract_se(spec)
        noise = torch.randn((1, T, ov.cfg.inter_channels), device="cuda")
        lens = torch.tensor([T], device="cuda")
        se_ms = cuda_time_ms(lambda: ov.extract_se(spec), iters=10)
        vc_ms = cuda_time_ms(
            lambda: ov.voice_conversion(spec, lens, se, se, noise, 0.3), iters=5)
    log(f"openvoice full on 10 s ({T} frames): extract_se {se_ms:.3f} ms, "
        f"voice_conversion {vc_ms:.3f} ms a call; {card}")

    sr = 22050
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ov_train_smoke_") as tmp:
        data, ckpt = os.path.join(tmp, "data"), os.path.join(tmp, "ckpt")
        os.makedirs(data)
        os.makedirs(ckpt)
        for i, secs in enumerate(TRAIN_CLIPS):
            save_wav(os.path.join(data, f"clip{i}.wav"),
                     synthetic_audio(secs, sr, 110.0 + 17 * i, seed=60 + i), sr)
        with open(os.path.join(ckpt, "openvoice.pkl"), "wb") as f:
            pickle.dump(to_jax_params(ov.cpu()), f)
        del ov
        os.chdir(tmp)  # apps.train writes ./runs/<run-name>
        try:
            for what, run in (("train openvoice", "ov"), ("train openvoice se_db", "ov_se_db")):
                if run == "ov_se_db":
                    with open(os.path.join(ckpt, "se_db.pkl"), "wb") as f:
                        pickle.dump(np.random.default_rng(41).standard_normal(
                            (OV_SE_DB_ROWS, 256)).astype(np.float32), f)
                torch.cuda.empty_cache()
                reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer = train_app.main([
                    "--dataset-dir", data, "--batch-size", "2", "--log-interval", "1",
                    "--checkpoint-dir", ckpt, "--run-name", run, "--max-steps", str(OV_STEPS),
                    "--save-interval", "100"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                totals = (attention.LAUNCHES, attention.BWD_LAUNCHES,
                          attention.DIT_ATTENTION_LAUNCHES)
                if (trainer.openvoice is None
                        or (trainer.se_db is None) != (run == "ov")):
                    fail(f"{what}: the trainer did not take the OpenVoice checkpoints")
                rate, rows = train_step_log(trainer.history)
                for r in rows:
                    log(f"  {what} step {r}")
                check_train_history(what, rows, 1, OV_STEPS)
                if totals != (TRAIN_DEPTH * OV_STEPS, TRAIN_DEPTH * OV_STEPS, 0):
                    fail(f"{what}: launches (K1, K1b, K3) {totals} for {OV_STEPS} steps")
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                # synchronised prep of every batch of an epoch, the converter
                # timed inside it; the perturbed content must differ
                ov_s, prep_s, diffs = [], [], []
                perturb = trainer._perturb_openvoice

                def timed(*a, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = perturb(*a, **kw)
                    torch.cuda.synchronize()
                    ov_s.append(time.perf_counter() - t)
                    return out

                trainer._perturb_openvoice = timed
                for i, batch in enumerate(FTDataset(data, sr, 2).batches(shuffle=False)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    feats = trainer.prepare_batch(batch, np.random.default_rng((0, i)),
                                                  cache=False, step=i)
                    torch.cuda.synchronize()
                    prep_s.append(time.perf_counter() - t)
                    diffs.append((feats["s_alt"] - feats["s_ori"]).abs().max().item())
                share = sum(ov_s) / sum(prep_s)
                step_s = [r["step_s"] for r in rows if r["step_s"] is not None]
                log(f"{what}: {OV_STEPS} steps in {wall:.1f} s wall (models built, data read "
                    f"and exported included); step seconds {step_s}; prep on the worker "
                    f"{[r['prep_s'] for r in rows]} s; T by step {[r['T'] for r in rows]}; "
                    f"peak device memory {peak:.2f} GiB; launches (K1, K1b, K3) {totals}; "
                    f"synchronised prep of {len(prep_s)} batches "
                    f"{[round(x, 4) for x in prep_s]} s, OpenVoice "
                    f"{[round(x, 4) for x in ov_s]} s, share {share:.3f}; max |s_alt - s_ori| "
                    f"by batch {[round(x, 4) for x in diffs]}; {card}")
                if min(diffs) <= 1e-3:
                    fail(f"{what}: the perturbed content equals the clean content")
                del trainer
        finally:
            os.chdir(cwd)


def wavlm_check(card: str):
    """WavLM-SV at full width (random weights): cuda against cpu on 5 s, and
    a zero-padded 10 s bucket with ``lengths`` against each clip's unpadded
    forward on the card. Returns the model on cuda."""
    import copy

    import torch

    from seedvc_tpu_torch.models.wavlm_sv import WavLMSV

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(33)
        wl = WavLMSV().requires_grad_(False).eval()
    clips = [synthetic_audio(5.0, 16000, 170.0, seed=34),
             synthetic_audio(3.3, 16000, 120.0, seed=35)]
    with torch.no_grad():
        ref = copy.deepcopy(wl)(torch.from_numpy(clips[0])[None])
        wl.cuda()
        rel = rel_l2(wl(torch.from_numpy(clips[0])[None].cuda()), ref)
        with tf32():
            rel_tf32 = rel_l2(wl(torch.from_numpy(clips[0])[None].cuda()), ref)
        padded = np.zeros((2, 160000), np.float32)
        for i, c in enumerate(clips):
            padded[i, :len(c)] = c
        emb = wl(torch.from_numpy(padded).cuda(),
                 lengths=torch.tensor([len(c) for c in clips], device="cuda"))
        pad_rel = max(rel_l2(emb[i], wl(torch.from_numpy(c)[None].cuda())[0])
                      for i, c in enumerate(clips))
    log(f"wavlm_sv full: cuda vs cpu on 5 s rel_l2 {rel:.3e} tol {WAVLM_TOL:g}, with TF32 on "
        f"(planted fault) {rel_tf32:.3e}; a padded 10 s bucket with lengths vs unpadded, "
        f"worst rel_l2 {pad_rel:.3e} tol {WAVLM_PAD_TOL:g}; {card}")
    if not (rel <= WAVLM_TOL and pad_rel <= WAVLM_PAD_TOL):
        fail("wavlm_sv: cuda against cpu, or padded against unpadded, disagree")
    if not rel_tf32 > WAVLM_TOL:
        fail("wavlm_sv: the limit does not see TF32")
    return wl


def phase_eval(card: str) -> dict:
    """Phase 12: ``python -m seedvc_tpu_torch.apps.eval`` in process at full
    width (random weights): whisper_small_wavenet, a 10 s and a 6 s source
    against a 5 s reference, 25 steps, SECS by a random full-width WavLM-SV
    from a pkl; the same again, which must convert nothing; the OpenVoice
    baseline from a pkl; one source with whisper_base_f0_44k and
    ``--f0-metrics``. Each conversion's K1 and K2 launches must be phase 5's
    per chunk (25 x depth K1, 109 K2) times its chunks."""
    import pickle
    import tempfile

    import torch

    from seedvc_tpu_torch.apps import eval as eval_app
    from seedvc_tpu_torch.apps.audio_io import save_wav
    from seedvc_tpu_torch.models import wavlm_sv
    from seedvc_tpu_torch.models.openvoice import OpenVoiceConfig
    from seedvc_tpu_torch.pipelines import convert
    from seedvc_tpu_torch.weights import to_jax_params

    wl = wavlm_check(card)
    result = {}
    convs, embeds = [], []
    orig_convert, orig_forward = convert.VoiceConverter.convert, wavlm_sv.WavLMSV.forward

    def counted(self, *a, **kw):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_convert(self, *a, **kw)
        torch.cuda.synchronize()
        after = read_counts()
        convs.append({"s": time.perf_counter() - t, "audio_s": len(out[1]) / out[0],
                      "chunks": out[2]["chunks"], "depth": self.cfg.model_params.DiT.depth,
                      **{k: after[k] - before[k] for k in after}})
        return out

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_forward(self, *a, **kw)
        torch.cuda.synchronize()
        embeds.append(time.perf_counter() - t)
        return out

    with tempfile.TemporaryDirectory(prefix="eval_smoke_") as tmp:
        src, tgt = os.path.join(tmp, "src"), os.path.join(tmp, "tgt")
        os.makedirs(src)
        os.makedirs(tgt)
        for i, secs in enumerate(EVAL_SRC_SECS):
            save_wav(os.path.join(src, f"s{i}.wav"),
                     synthetic_audio(secs, 22050, 130.0 + 30 * i, seed=85 + i), 22050)
        save_wav(os.path.join(tgt, "ref.wav"),
                 synthetic_audio(EVAL_REF_SECS, 22050, 210.0, seed=84), 22050)
        xv, ov_pkl = os.path.join(tmp, "wavlm.pkl"), os.path.join(tmp, "ov.pkl")
        with open(xv, "wb") as f:
            pickle.dump(to_jax_params(wl), f)
        del wl
        with open(ov_pkl, "wb") as f:
            pickle.dump(to_jax_params(random_openvoice(OpenVoiceConfig(), 36)), f)
        base = ["--source-dir", src, "--target-dir", tgt]
        convert.VoiceConverter.convert, wavlm_sv.WavLMSV.forward = counted, timed
        try:
            for what, argv in (
                    ("eval", base + ["--output", os.path.join(tmp, "out"), "--xvector-extractor",
                                     "wavlm", "--xvector-checkpoint", xv]),
                    ("eval resume", base + ["--output", os.path.join(tmp, "out"),
                                            "--xvector-extractor", "wavlm",
                                            "--xvector-checkpoint", xv]),
                    ("eval openvoice baseline", base + [
                        "--output", os.path.join(tmp, "ov"), "--baseline", "openvoice",
                        "--baseline-checkpoint", ov_pkl]),
                    ("eval f0", base + ["--output", os.path.join(tmp, "f0"), "--preset",
                                        "whisper_base_f0_44k", "--f0-metrics",
                                        "--max-samples", "1"])):
                first, n_emb = len(convs), len(embeds)
                torch.cuda.empty_cache()
                reset_counts()
                t0 = time.perf_counter()
                report = eval_app.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts()
                mine = convs[first:]
                for c in mine:
                    log(f"  {what} conversion: {c}")
                n_src = 1 if what == "eval f0" else len(EVAL_SRC_SECS)
                expect_convs = 0 if what in ("eval resume", "eval openvoice baseline") else n_src
                rows = report["results"]
                log(f"{what}: {wall:.1f} s wall (models built included); {len(mine)} "
                    f"conversions, seconds {[round(c['s'], 4) for c in mine]} for audio "
                    f"{[round(c['audio_s'], 2) for c in mine]} s; WavLM-SV embeddings "
                    f"{[round(x, 4) for x in embeds[n_emb:]]} s each; launches {counts}; "
                    f"summary {json.dumps(report['summary'])}; {card}")
                if len(mine) != expect_convs or report["summary"]["n"] != n_src:
                    fail(f"{what}: {len(mine)} conversions and {report['summary']['n']} rows, "
                         f"expected {expect_convs} and {n_src}")
                for c in mine:
                    if (c["k1"], c["k2"], c["k3"]) != (c["chunks"] * 25 * c["depth"],
                                                       c["chunks"] * 109, 0):
                        fail(f"{what}: a conversion of {c['chunks']} chunks launched K1/K2/K3 "
                             f"{c['k1']}/{c['k2']}/{c['k3']}")
                if not expect_convs and any(counts.values()):
                    fail(f"{what}: kernels launched without a conversion: {counts}")
                for r in rows:
                    if not -1.0 <= r["secs"] <= 1.0:
                        fail(f"{what}: SECS {r['secs']}")
                if "wavlm" in argv and (
                        len(embeds) - n_emb != n_src + 1
                        or not all("secs_campplus" in r for r in rows)):
                    fail(f"{what}: the WavLM extractor did not score every clip")
                if what == "eval f0" and not all("f0_corr" in r and "voiced_frames" in r
                                                 for r in rows):
                    fail(f"{what}: no F0 metrics")
                result[what] = {"wall_s": wall, "conversions": mine, "counts": counts,
                                "embed_s": embeds[n_emb:], "summary": report["summary"]}
        finally:
            convert.VoiceConverter.convert, wavlm_sv.WavLMSV.forward = orig_convert, orig_forward
    return result


# ---------------------------------------------------------------------------
# Phase 12b: the web UI (apps.webui), the serving entry point, at full width
# from random weights (seed 0): ConverterRegistry on the card behind
# make_server on a thread, requests from this process over localhost, then
# the CLI as a subprocess. Each conversion runs on the registry's device
# thread under its lock, while the handler threads parse and answer. Limits: a served body against the same conversion called
# directly, and each streamed or concurrent body against its sequential
# /api/convert body, within WEB_LSB of int16 (the same kernels on the same
# inputs: only a library's algorithm choice may differ).
WEB_LSB = 1
WEB_SPECS = [(30.0, 5.0)]
WEB_CLI_TIMEOUT = 300.0
WEB_PATH = "web UI POST /api/convert {} (a 30 s source, v2 20 s, with a 5 s reference)"


def multipart(fields: dict) -> tuple[bytes, str]:
    """A multipart/form-data body: ``(filename, bytes)`` values as file
    uploads, everything else as text fields."""
    import uuid

    boundary = uuid.uuid4().hex
    parts = []
    for name, value in fields.items():
        if isinstance(value, tuple):
            head = (f'Content-Disposition: form-data; name="{name}"; filename="{value[0]}"\r\n'
                    "Content-Type: audio/wav\r\n\r\n")
            data = value[1]
        else:
            head, data = f'Content-Disposition: form-data; name="{name}"\r\n\r\n', \
                str(value).encode()
        parts.append(f"--{boundary}\r\n{head}".encode() + data + b"\r\n")
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def wav_upload(wave: np.ndarray, sr: int) -> tuple[bytes, np.ndarray]:
    """A 16-bit wav of ``wave`` and the float samples the server reads from it."""
    import io

    from scipy.io import wavfile

    pcm = (np.clip(wave, -1, 1) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, sr, pcm)
    return buf.getvalue(), pcm.astype(np.float32) / 32768.0


def read_wav_body(body: bytes) -> tuple[int, np.ndarray]:
    import io

    from scipy.io import wavfile

    return wavfile.read(io.BytesIO(body))


def http_call(port: int, method: str, path: str, fields: dict | None = None,
              timeout: float = 600.0) -> dict:
    """One request over a raw socket, the chunked framing parsed here: status,
    headers (lower-case names), the body, each chunk's arrival (seconds after
    the request was sent) and the client's wall."""
    import socket

    body, ctype = multipart(fields) if fields is not None else (b"", None)
    head = f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n"
    if fields is not None:
        head += f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(head.encode() + b"\r\n" + body)
        f = sock.makefile("rb")
        status = int(f.readline().split()[1])
        headers = {}
        while (line := f.readline()) not in (b"\r\n", b""):
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        chunks = []
        if headers.get("transfer-encoding") == "chunked":
            while (size := int(f.readline().strip(), 16)) > 0:
                data = f.read(size)
                chunks.append((time.perf_counter() - t0, data))
                if f.read(2) != b"\r\n":
                    fail(f"{path}: bad chunk framing")
            f.readline()
            data = b"".join(c for _, c in chunks)
        else:
            data = f.read(int(headers.get("content-length", "0")))
    return {"status": status, "headers": headers, "body": data, "chunks": chunks,
            "wall_s": time.perf_counter() - t0}


def expect_status(what: str, r: dict, status: int, ctype: str | None = None):
    if r["status"] != status or (ctype is not None and r["headers"].get("content-type") != ctype):
        fail(f"{what}: {r['status']} {r['headers'].get('content-type')} "
             f"{r['body'][:300]!r}; expected {status} {ctype}")


def n_chunks(target_len: int, W: int) -> int:
    """Chunks the pipelines run for ``target_len`` frames at window W."""
    from seedvc_tpu_torch.pipelines.convert import OVERLAP_FRAMES

    n = processed = 0
    while processed < target_len:
        w = min(W, target_len - processed)
        processed += w if processed + W >= target_len else w - OVERLAP_FRAMES
        n += 1
    return n


def lsb_diff(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        return 1 << 30
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) if a.size else 0


def phase_webui(card: str) -> dict:
    """Phase 12b: (a) the web UI in process, (b) its CLI."""
    import shutil
    import threading

    import torch

    from seedvc_tpu_torch.apps import webui
    from seedvc_tpu_torch.dsp.flac import decode_flac

    result = {}
    registry = webui.ConverterRegistry(device="cuda")
    server = webui.make_server("127.0.0.1", 0, registry)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        # (1) warm each mode: one silent conversion per distinct plan
        steps = {"vc": 25, "svc": 25, "v2": V2_STEPS}
        keys = {"vc": ("v1", "whisper_small_wavenet"), "svc": ("v1", SVC_PRESET),
                "v2": ("v2", "v2")}  # the registry's key of each mode's converter
        for mode in ("vc", "svc", "v2"):
            reset_counts()
            t0 = time.perf_counter()
            plans = registry.warm(WEB_SPECS, modes=(mode,))[mode]
            torch.cuda.synchronize()
            wall, counts = time.perf_counter() - t0, read_counts()
            conv = registry.get(*keys[mode])
            depth = conv.cfg.dit.depth
            chunks = sum(n_chunks(max(int(s * conv.sr) // conv.hop, 1), plan[2])
                         for (s, _), plan in zip(WEB_SPECS, plans))
            expect = {"k1": chunks * steps[mode] * depth, "k2": chunks * 109, "k3": 0}
            log(f"webui warm {mode}: {wall:.3f} s (the converter's build included), plans "
                f"{plans}, launches {counts} (expected {expect}), on {card}")
            check_counts(f"webui warm {mode}", counts, expect)
            result[f"warm {mode}"] = {"wall_s": wall, "plans": plans, "counts": counts}

        # (2) the pages
        for path, ctype in (("/", "text/html; charset=utf-8"), ("/api/status", "application/json"),
                            ("/api/examples", "application/json")):
            r = http_call(port, "GET", path)
            expect_status(f"GET {path}", r, 200, ctype)
            if path == "/api/status":
                loaded = json.loads(r["body"])["loaded"]
                if loaded != ["v1:whisper_base_f0_44k", "v1:whisper_small_wavenet", "v2:v2"]:
                    fail(f"/api/status lists {loaded}")
            if path == "/api/examples":
                example = json.loads(r["body"])[0]["url"]
        r = http_call(port, "GET", example)
        expect_status(f"GET {example}", r, 200, "audio/wav")
        log(f"webui pages: /, /api/status, /api/examples, {example}: 200 each")

        # (3) a request a mode, launches checked against the request's plan
        src22, ref22 = synthetic_audio(30.0, 22050, 140.0, seed=61), \
            synthetic_audio(5.0, 22050, 220.0, seed=62)
        src44, ref44 = synthetic_audio(30.0, 44100, 150.0, seed=63), \
            synthetic_audio(5.0, 44100, 230.0, seed=64)
        src_v2 = synthetic_audio(20.0, 22050, 140.0, seed=65)
        (s22, s22_f), (r22, r22_f) = wav_upload(src22, 22050), wav_upload(ref22, 22050)
        vc_fields = {"mode": "vc", "diffusion_steps": 25, "cfg_rate": 0.7, "seed": 0,
                     "source": ("s.wav", s22), "target": ("r.wav", r22)}
        requests = {
            "vc": (vc_fields, 22050, 256, len(src22)),
            "svc": ({"mode": "svc", "diffusion_steps": 25, "cfg_rate": 0.7, "seed": 0,
                     "pitch_shift": 2, "auto_f0_adjust": "1",
                     "source": ("s.wav", wav_upload(src44, 44100)[0]),
                     "target": ("r.wav", wav_upload(ref44, 44100)[0])}, 44100, 512, len(src44)),
            "v2": ({"mode": "v2", "convert_style": "1", "diffusion_steps": V2_STEPS, "seed": 0,
                    "source": ("s.wav", wav_upload(src_v2, 22050)[0]),
                    "target": ("r.wav", r22)}, 22050, 256, len(src_v2)),
        }
        served = {}
        for mode, (fields, sr, hop, n_src) in requests.items():
            reset_counts()
            r = http_call(port, "POST", "/api/convert", fields)
            counts = read_counts()
            expect_status(f"webui {mode}", r, 200, "audio/wav")
            stats = json.loads(r["headers"]["x-stats"])
            out_sr, pcm = read_wav_body(r["body"])
            target_len = stats["target_len"] if mode == "v2" else n_src // hop
            chunks = stats["chunks"]
            depth = registry.get(*keys[mode]).cfg.dit.depth
            expect = {"k1": chunks * steps[mode] * depth, "k2": chunks * 109, "k3": 0}
            audio_s = len(pcm) / out_sr
            log(f"webui {mode}: 200, {r['wall_s']:.3f} s from the client, X-RTF "
                f"{r['headers']['x-rtf']}, stats wall {stats['wall_seconds']:.3f} s, "
                f"{audio_s:.2f} s of audio at {out_sr} Hz ({audio_s / r['wall_s']:.2f} "
                f"audio-s/s), {chunks} chunks, launches {counts}, on {card}")
            if mode == "v2":
                log(f"  v2: narrow {stats['narrow_tokens']} -> wide {stats['wide_tokens']} "
                    f"tokens, decode steps {stats['decode_steps']}, replays {stats['replays']}, "
                    f"AR {stats['ar_seconds']:.3f} s, plan {stats['plan']}")
                if stats["ar_batch"] < 1 or stats["replays"] != stats["decode_steps"] - 1:
                    fail(f"webui v2: the AR ran {stats['ar_batch']} rows, {stats['replays']} "
                         f"replays for {stats['decode_steps']} steps")
                if chunks != n_chunks(target_len, stats["plan"][2]):
                    fail(f"webui v2: {chunks} chunks, plan {stats['plan']}")
            if out_sr != sr or len(pcm) != target_len * hop or not pcm.std() > 0:
                fail(f"webui {mode}: {out_sr} Hz, {len(pcm)} samples (expected {sr} Hz, "
                     f"{target_len * hop}), std {pcm.std()}")
            check_counts(f"webui {mode}", counts, expect)
            served[mode] = pcm
            result[mode] = {"wall_s": r["wall_s"], "rtf": float(r["headers"]["x-rtf"]),
                            "stats_wall_s": stats["wall_seconds"], "audio_s": audio_s,
                            "counts": counts, "stats": stats}
        # K1's keys by chunk on the v2 request: prompt + chunk + the 2 prefix tokens
        v2s = result["v2"]["stats"]
        W = v2s["plan"][2]
        p_len = min(len(r22_f) // 256, registry.get("v2", "v2").cfg.prompt_cap_frames)
        result["v2"]["lens"] = [p_len + min(W, v2s["target_len"] - i * (W - 16)) + 2
                                for i in range(v2s["chunks"])]

        # (4) the vc body against the same conversion called directly (under
        # the registry's lock, as the server's are)
        conv = registry.get("v1", "whisper_small_wavenet")
        t0 = time.perf_counter()
        with registry.lock:
            _, wave, _ = conv.convert(s22_f, 22050, r22_f, 22050, diffusion_steps=25,
                                      length_adjust=1.0, cfg_rate=0.7,
                                      auto_f0_adjust=True, pitch_shift=0.0, seed=0)
        torch.cuda.synchronize()
        direct_wall = time.perf_counter() - t0
        if not np.isfinite(wave).all():
            fail("webui: the direct vc conversion is not finite")
        direct = (np.clip(wave, -1, 1) * 32767).astype(np.int16)
        d = lsb_diff(served["vc"], direct)
        log(f"webui vc body against a direct convert: max |diff| {d} LSB (limit {WEB_LSB}); "
            f"direct {direct_wall:.3f} s")
        if d > WEB_LSB:
            fail(f"webui vc body differs from the direct conversion by {d} LSB")
        # the same request again: the first one after warm against a later one
        r = http_call(port, "POST", "/api/convert", vc_fields)
        expect_status("webui vc again", r, 200, "audio/wav")
        d = lsb_diff(read_wav_body(r["body"])[1], served["vc"])
        log(f"webui vc again: {r['wall_s']:.3f} s from the client, stats wall "
            f"{json.loads(r['headers']['x-stats'])['wall_seconds']:.3f} s, max |diff| against "
            f"the first {d} LSB")
        if d > WEB_LSB:
            fail(f"webui vc again differs from the first by {d} LSB")
        result["vc again"] = {"wall_s": r["wall_s"]}

        # (5) the chunked streams, flac then wav, against the vc body
        for fmt, ctype in (("flac", "audio/flac"), ("wav", "audio/wav")):
            reset_counts()
            r = http_call(port, "POST", "/api/convert_stream", {**vc_fields, "stream_format": fmt})
            counts = read_counts()
            expect_status(f"webui stream {fmt}", r, 200, ctype)
            if r["headers"].get("transfer-encoding") != "chunked":
                fail(f"webui stream {fmt}: not chunked")
            if fmt == "flac":
                sr_s, pcm_s = decode_flac(r["body"])
                pcm_s = pcm_s[:, 0]
            else:
                sr_s, pcm_s = 22050, np.frombuffer(r["body"][44:], "<i2")
            d = lsb_diff(pcm_s, served["vc"])
            if len(r["chunks"]) < 2:
                fail(f"webui stream {fmt}: {len(r['chunks'])} chunks")
            first_audio = r["chunks"][1][0]
            log(f"webui stream {fmt}: {len(r['chunks'])} chunks (header + "
                f"{len(r['chunks']) - 1} audio), first audio chunk at {first_audio:.3f} s, "
                f"all at {r['wall_s']:.3f} s, {len(r['body'])} bytes, max |diff| against the "
                f"body {d} LSB, launches {counts}, on {card}")
            if sr_s != 22050 or d > WEB_LSB:
                fail(f"webui stream {fmt}: {sr_s} Hz, {d} LSB from the /api/convert body")
            check_counts(f"webui stream {fmt}", counts, result["vc"]["counts"])
            result[f"stream {fmt}"] = {"first_audio_s": first_audio, "wall_s": r["wall_s"],
                                       "chunks": len(r["chunks"]), "bytes": len(r["body"])}

        # (6) two concurrent requests against their sequential runs
        src10 = wav_upload(synthetic_audio(10.0, 22050, 160.0, seed=66), 22050)[0]
        pair = [{**vc_fields, "source": ("s.wav", src10), "seed": s} for s in (0, 1)]
        one = {"k1": 25 * conv.cfg.dit.depth, "k2": 109, "k3": 0}  # one chunk at context 1536
        seq = []
        for f in pair:
            reset_counts()
            r = http_call(port, "POST", "/api/convert", f)
            expect_status("webui sequential", r, 200, "audio/wav")
            check_counts("webui sequential 10 s", read_counts(), one)
            seq.append(r)
        conc = [None, None]
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: conc.__setitem__(
            i, http_call(port, "POST", "/api/convert", pair[i]))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        pair_wall = time.perf_counter() - t0
        counts = read_counts()
        if any(t.is_alive() for t in threads) or None in conc:
            fail("webui concurrent pair did not finish")
        diffs = []
        for i, r in enumerate(conc):
            expect_status(f"webui concurrent {i}", r, 200, "audio/wav")
            diffs.append(lsb_diff(read_wav_body(r["body"])[1], read_wav_body(seq[i]["body"])[1]))
        seq_sum = sum(r["wall_s"] for r in seq)
        log(f"webui concurrent pair (10 s + 5 s, seeds 0 and 1): {pair_wall:.3f} s together "
            f"against {seq_sum:.3f} s for the two in turn ({seq[0]['wall_s']:.3f} + "
            f"{seq[1]['wall_s']:.3f}); each against its sequential body {diffs} LSB; "
            f"launches {counts}, on {card}")
        if max(diffs) > WEB_LSB or lsb_diff(read_wav_body(seq[0]["body"])[1],
                                             read_wav_body(seq[1]["body"])[1]) == 0:
            fail(f"webui concurrent pair: {diffs} LSB, or seeds 0 and 1 gave one body")
        check_counts("webui concurrent pair", counts, {k: 2 * v for k, v in one.items()})
        result["pair"] = {"wall_s": pair_wall, "seq_s": [r["wall_s"] for r in seq]}

        # (7) mp3, and a request without the reference
        r = http_call(port, "POST", "/api/convert_stream", {**vc_fields, "stream_format": "mp3"})
        if shutil.which("ffmpeg") is None:
            expect_status("webui mp3 without ffmpeg", r, 400)
            if b"ffmpeg" not in r["body"] or r["chunks"]:
                fail(f"webui mp3 without ffmpeg: {r['body'][:200]!r}")
            log("webui mp3: no ffmpeg on PATH, 400 before any chunked header: "
                f"{r['body'].decode()}")
        else:
            expect_status("webui mp3", r, 200, "audio/mpeg")
            if not r["body"]:
                fail("webui mp3: empty body")
            log(f"webui mp3: ffmpeg on PATH, 200 audio/mpeg, {len(r['body'])} bytes")
        missing = {k: v for k, v in vc_fields.items() if k != "target"}
        r = http_call(port, "POST", "/api/convert", missing)
        expect_status("webui without target", r, 400)
        log(f"webui without the target upload: 400 {r['body'].decode()}")
        vc_walls = [result["vc"]["wall_s"], result["vc again"]["wall_s"]] + [
            result[f"stream {f}"]["wall_s"] for f in ("flac", "wav")]
        log("webui vc 30 s walls from the client, the first request after warm first: "
            f"{[round(w, 3) for w in vc_walls]}")
    finally:
        server.shutdown()
        server.server_close()
        registry._cache.clear()
        torch.cuda.empty_cache()

    result["cli"] = phase_webui_cli(card)
    return result


def phase_webui_cli(card: str) -> dict:
    """(b) ``python -m seedvc_tpu_torch.apps.webui --warm 10:5 --warm-modes vc``
    as a subprocess on a free port: its warmed and serving lines, /api/status,
    one 10 s + 5 s conversion; then it is terminated."""
    import socket
    import threading

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "seedvc_tpu_torch.apps.webui", "--port",
                             str(port), "--warm", "10:5", "--warm-modes", "vc"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, serving = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving on"):
                serving.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not serving.wait(WEB_CLI_TIMEOUT):
            fail(f"webui cli: no 'serving on' line in {WEB_CLI_TIMEOUT:.0f} s (exit "
                 f"{proc.poll()}): " + " | ".join(lines[-20:]))
        up = time.perf_counter() - t0
        warmed = [x for x in lines if x.startswith("warmed")]
        log(f"webui cli: serving after {up:.1f} s; " + " | ".join(warmed))
        if not warmed:
            fail("webui cli: no 'warmed' line")
        r = http_call(port, "GET", "/api/status")
        expect_status("webui cli status", r, 200, "application/json")
        if "v1:whisper_small_wavenet" not in json.loads(r["body"])["loaded"]:
            fail(f"webui cli status: {r['body']!r}")
        src = synthetic_audio(10.0, 22050, 170.0, seed=67)
        fields = {"mode": "vc", "source": ("s.wav", wav_upload(src, 22050)[0]),
                  "target": ("r.wav", wav_upload(synthetic_audio(5.0, 22050, 210.0, seed=68),
                                                 22050)[0])}
        r = http_call(port, "POST", "/api/convert", fields)
        expect_status("webui cli convert", r, 200, "audio/wav")
        sr, pcm = read_wav_body(r["body"])
        log(f"webui cli convert: 200, {r['wall_s']:.3f} s from the client, X-RTF "
            f"{r['headers']['x-rtf']}, {len(pcm)} samples at {sr} Hz, on {card}")
        if sr != 22050 or len(pcm) != len(src) // 256 * 256 or not pcm.std() > 0:
            fail(f"webui cli convert: {sr} Hz, {len(pcm)} samples, std {pcm.std()}")
        return {"up_s": up, "wall_s": r["wall_s"], "warmed": warmed}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)


# ---------------------------------------------------------------------------
# Phase 12c: released checkpoints into the port without JAX. The full-width
# whisper_small_wavenet models, the v2 stack, RMVPE and HiFT, built from seed
# 0 on the host, are written in the reference's layout under the zoo's file
# names (tests/torch_ref_checkpoints.py, which imports torch and numpy only),
# then converted by `python -m seedvc_tpu_torch.apps.convert_checkpoint` in
# fresh processes. Every converted tree must equal its exported tree, a
# weight-norm-folded kernel to CKPT_FOLD_RTOL of its largest value. apps.infer
# from the converted directory and v2's convert_timbre from load_v2_params
# must give the waves of converters handed the same files' trees in memory
# (the CLI's own conversion run in this process), within CKPT_LSB of int16
# (as WEB_LSB: the same kernels on the same weights; 0 is expected), with
# phase 5's and phase 9's launches. Planted faults: one DiT weight changed in
# the .pth must change the wave; one key deleted must stop the CLI naming it.
CKPT_FOLD_RTOL = 1e-6
CKPT_LSB = 1
CKPT_CLI_TIMEOUT = 600.0
CKPT_CHANGED = "estimator.conv2.weight"  # the DiT's last 1x1 conv onto the mel
CKPT_DELETED = "estimator.transformer.layers.7.attention.wo.weight"
CKPT_PATH = "apps.infer from converted checkpoints (whisper_small_wavenet, 30 s + 5 s)"
CKPT_V2_PATH = "v2 convert_timbre from converted checkpoints (V2Config(), 20 s + 5 s)"


def tree_check(what: str, got: dict, want: dict) -> dict:
    """``got`` (a converted tree) against ``want`` (the exported one): the
    same leaves, shapes and dtypes, each equal, or a kernel within
    CKPT_FOLD_RTOL of its largest value (a folded weight norm)."""
    from torch_ref_checkpoints import flat

    fg, fw = flat(got), flat(want)
    if sorted(fg) != sorted(fw):
        fail(f"{what}: leaves differ: only converted {sorted(set(fg) - set(fw))[:4]}, "
             f"only exported {sorted(set(fw) - set(fg))[:4]}")
    folded, worst = 0, 0.0
    for k, w in fw.items():
        g = fg[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{what}/{k}: {g.shape} {g.dtype}, exported {w.shape} {w.dtype}")
        if np.array_equal(g, w):
            continue
        err = float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-30))
        if not k.endswith("kernel") or err > CKPT_FOLD_RTOL:
            fail(f"{what}/{k}: differs from the exported leaf by {err:.3e} of its largest value "
                 f"(limit {CKPT_FOLD_RTOL:g}, kernels only)")
        folded, worst = folded + 1, max(worst, err)
    return {"leaves": len(fw), "folded": folded, "worst_rel": worst}


def ckpt_cli(out: str, args: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "seedvc_tpu_torch.apps.convert_checkpoint",
                             "--out", out, *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def ckpt_in_memory(out: str, args: list) -> dict:
    """The CLI's conversion of ``args``' files run in this process, its
    trees kept in memory instead of pickled (``out`` stays empty)."""
    from seedvc_tpu_torch.apps import convert_checkpoint

    trees, save = {}, convert_checkpoint._save
    convert_checkpoint._save = lambda out_dir, name, tree: trees.__setitem__(name, tree)
    try:
        convert_checkpoint.main(["--out", out, *args])
    finally:
        convert_checkpoint._save = save
    return trees


def phase_checkpoints(card: str, full: dict, v2_full: dict) -> dict:
    import pickle
    import shutil
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_ref_checkpoints as W

    from seedvc_tpu_torch.apps import infer
    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
    from seedvc_tpu_torch.apps.infer_v2 import load_v2_params
    from seedvc_tpu_torch.models.hifigan import HiFTConfig, HiFTGenerator
    from seedvc_tpu_torch.models.rmvpe import RMVPE_E2E
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    from seedvc_tpu_torch.pipelines.convert_v2 import VoiceConverterV2
    from seedvc_tpu_torch.pipelines.wrapper import load_params_dir
    from seedvc_tpu_torch.weights import to_jax_params

    timing = {}
    t0 = time.perf_counter()
    v1 = VoiceConverter(device="cpu", seed=0)
    v2 = VoiceConverterV2(device="cpu", seed=0)
    torch.manual_seed(0)
    trees = {"vc": to_jax_params(v1.vc), "whisper": to_jax_params(v1.whisper),
             "campplus": to_jax_params(v1.campplus), "vocoder": to_jax_params(v1.vocoder),
             "rmvpe": to_jax_params(RMVPE_E2E()), "hift": to_jax_params(HiFTGenerator(HiFTConfig())),
             **{n: to_jax_params(getattr(v2, n))
                for n in ("ssl", "narrow", "wide", "cfm_reg", "ar_reg", "dit", "ar")}}
    del v1, v2
    ema = W.halved(trees["vc"])
    timing["build_export_s"] = time.perf_counter() - t0
    n_params = sum(a.size for t in trees.values() for a in W.flat(t).values())
    log(f"checkpoints: {len(trees)} trees, {n_params / 1e6:.1f} M values, built from seed 0 and "
        f"exported in {timing['build_export_s']:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        zoo = os.path.join(tmp, "zoo")
        t0 = time.perf_counter()
        contents = W.zoo_contents(trees, ema)
        paths = W.write_zoo(zoo, contents)
        broken = dict(contents["dit"]["net"]["cfm"])
        del broken[CKPT_DELETED]
        torch.save({"net": {**contents["dit"]["net"], "cfm": broken}},
                   os.path.join(tmp, "missing.pth"))
        timing["write_s"] = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(zoo) for f in fs)
        log(f"checkpoints: wrote {len(paths)} files, {size / 2 ** 30:.2f} GiB, in "
            f"{timing['write_s']:.1f} s: " + ", ".join(os.path.relpath(p, zoo)
                                                       for p in paths.values()))

        # four CLI processes at once: v1, --use-ema with --hift, v2 with
        # RMVPE, and the .pth with a key deleted
        v1_flags = ("dit", "campplus", "bigvgan", "whisper")
        v2_flags = ("astral_narrow", "astral_wide", "v2_cfm", "v2_ar", "hubert", "rmvpe")
        runs = {"v1": W.cli_args({f: paths[f] for f in v1_flags}),
                "ema": ["--use-ema", *W.cli_args({f: paths[f] for f in ("dit", "hift")})],
                "v2": W.cli_args({f: paths[f] for f in v2_flags}),
                "missing": ["--dit", os.path.join(tmp, "missing.pth")]}
        outs = {run: os.path.join(tmp, f"out_{run}") for run in runs}
        t0 = time.perf_counter()
        procs = {run: (ckpt_cli(outs[run], args), time.perf_counter()) for run, args in runs.items()}
        results = {}
        for run, (proc, start) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=CKPT_CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                for p, _ in procs.values():
                    p.kill()
                fail(f"convert_checkpoint {run}: no exit within {CKPT_CLI_TIMEOUT:.0f} s")
            results[run] = (proc.returncode, stdout, stderr, time.perf_counter() - start)
        timing["cli_wall_s"] = time.perf_counter() - t0
        for run, (rc, stdout, stderr, wall) in results.items():
            log(f"checkpoints: convert_checkpoint {run}: exit {rc} after {wall:.1f} s (of the "
                f"four processes' {timing['cli_wall_s']:.1f} s); "
                + " | ".join(line.replace(tmp, "<tmp>") for line in stdout.splitlines()))
            if run != "missing" and rc != 0:
                fail(f"convert_checkpoint {run} failed: {stderr[-2000:]}")
        rc, _, stderr, _ = results["missing"]
        named = CKPT_DELETED.split("estimator.", 1)[1]
        log(f"checkpoints: planted fault, {CKPT_DELETED} deleted: exit {rc}, "
            f"stderr ends {stderr.strip().splitlines()[-1] if stderr.strip() else ''!r}")
        if rc == 0 or named not in stderr:
            fail(f"convert_checkpoint with {CKPT_DELETED} deleted: exit {rc}, key not named")

        # every written tree against the exported one
        t0 = time.perf_counter()
        got = {}
        for run in ("v1", "ema", "v2"):
            for name in sorted(os.listdir(outs[run])):
                with open(os.path.join(outs[run], name), "rb") as f:
                    got[(run, name[:-4])] = pickle.load(f)
        timing["pickle_load_s"] = time.perf_counter() - t0
        expect = {("v1", n): trees[n] for n in ("vc", "whisper", "campplus", "vocoder")}
        expect.update({("ema", "vc"): ema, ("ema", "vocoder"): trees["hift"]})
        expect.update({("v2", n): trees[n] for n in ("ssl", "narrow", "wide", "cfm_reg", "ar_reg",
                                                     "dit", "ar", "rmvpe")})
        if sorted(got) != sorted(expect):
            fail(f"converted files {sorted(got)}, expected {sorted(expect)}")
        checks = {f"{run}/{name}.pkl": tree_check(f"{run}/{name}.pkl", got[(run, name)], want)
                  for (run, name), want in expect.items()}
        for what, c in checks.items():
            log(f"  {what}: {c['leaves']} leaves equal the exported tree, {c['folded']} folded "
                f"kernels within {c['worst_rel']:.2e} of their largest value")
        a = W.flat(got[("ema", "vc")])["cfm/estimator/cond_projection/kernel"]
        b = W.flat(got[("v1", "vc")])["cfm/estimator/cond_projection/kernel"]
        if np.array_equal(a, b):
            fail("--use-ema converted the net's tensors")
        del got

        # apps.infer from the converted directory against the converter given
        # the same files' trees in memory
        sr = 22050
        src_path, ref_path = os.path.join(tmp, "src.wav"), os.path.join(tmp, "ref.wav")
        save_wav(src_path, synthetic_audio(30.0, sr, 140.0, seed=71), sr)
        save_wav(ref_path, synthetic_audio(5.0, sr, 220.0, seed=72), sr)
        src, ref = load_wav(src_path)[0], load_wav(ref_path)[0]
        t0 = time.perf_counter()
        load_params_dir(outs["v1"])
        timing["load_params_dir_s"] = time.perf_counter() - t0

        def run_infer(ckpt_dir: str, name: str) -> tuple[np.ndarray, dict, float]:
            out = os.path.join(tmp, name)
            reset_counts()
            start = time.perf_counter()
            infer.main(["--source", src_path, "--target", ref_path, "--output", out,
                        "--checkpoint-dir", ckpt_dir, "--diffusion-steps", "25"])
            torch.cuda.synchronize()
            wall, counts = time.perf_counter() - start, read_counts()
            (fname,) = os.listdir(out)
            return load_wav(os.path.join(out, fname))[0], counts, wall

        wave, infer_counts, timing["infer_wall_s"] = run_infer(outs["v1"], "wav")
        log(f"checkpoints: apps.infer --checkpoint-dir: {timing['infer_wall_s']:.2f} s wall "
            f"(build from the pkls and a cold conversion; phase 5's warm conversion "
            f"{full['wall_s']:.3f} s), {len(wave)} samples, launches {infer_counts}, on {card}")
        check_counts("apps.infer from converted checkpoints", infer_counts, full["counts"])

        t0 = time.perf_counter()
        v1_mem = ckpt_in_memory(os.path.join(tmp, "mem_v1"), runs["v1"])
        timing["in_memory_convert_s"] = time.perf_counter() - t0
        vc = VoiceConverter(device="cuda", seed=0,
                            **{f"{n}_params": v1_mem[n] for n in ("vc", "whisper", "campplus",
                                                                  "vocoder")})
        out_sr, mem, _ = vc.convert(src, sr, ref, sr, diffusion_steps=25, cfg_rate=0.7, seed=0)
        del vc
        save_wav(os.path.join(tmp, "mem.wav"), mem, out_sr)
        mem = load_wav(os.path.join(tmp, "mem.wav"))[0]
        to16 = (lambda w: np.round(w * 32768).astype(np.int32))  # noqa: E731
        lsb = lsb_diff(to16(wave), to16(mem))
        log(f"checkpoints: apps.infer's wave against the in-memory converter's: {lsb} LSB "
            f"(limit {CKPT_LSB}); the in-memory conversion of the v1 files took "
            f"{timing['in_memory_convert_s']:.1f} s")
        if lsb > CKPT_LSB or not np.isfinite(wave).all() or not np.abs(wave).max() > 0:
            fail(f"apps.infer from converted checkpoints: {lsb} LSB from the in-memory converter")

        # planted fault: one DiT weight changed in the .pth
        changed = dict(contents["dit"]["net"]["cfm"])
        changed[CKPT_CHANGED] = changed[CKPT_CHANGED].clone()
        changed[CKPT_CHANGED][0, 0, 0] += 1.0
        torch.save({"net": {**contents["dit"]["net"], "cfm": changed}},
                   os.path.join(tmp, "changed.pth"))
        fault_dir = os.path.join(tmp, "out_changed")
        shutil.copytree(outs["v1"], fault_dir)
        with contextlib.redirect_stdout(sys.stderr):
            from seedvc_tpu_torch.apps import convert_checkpoint

            convert_checkpoint.main(["--out", fault_dir, "--dit", os.path.join(tmp, "changed.pth")])
        faulty, counts, _ = run_infer(fault_dir, "wav_changed")
        lsb_fault = lsb_diff(to16(faulty), to16(mem))
        log(f"checkpoints: planted fault, {CKPT_CHANGED}[0, 0, 0] + 1 in the .pth: "
            f"{lsb_fault} LSB from the in-memory converter (must exceed {CKPT_LSB})")
        if lsb_fault <= CKPT_LSB:
            fail("a DiT weight changed in the .pth did not change apps.infer's wave")

        # v2: convert_timbre from load_v2_params against the in-memory trees
        for name in ("campplus", "vocoder"):
            shutil.copy(os.path.join(outs["v1"], f"{name}.pkl"), outs["v2"])
        t0 = time.perf_counter()
        params = load_v2_params(outs["v2"])
        timing["load_v2_params_s"] = time.perf_counter() - t0
        if sorted(params) != sorted(VoiceConverterV2.PARAM_NAMES):
            fail(f"load_v2_params found {sorted(params)}")
        v2_mem = ckpt_in_memory(os.path.join(tmp, "mem_v2"), runs["v2"])
        v2_mem.update(campplus=v1_mem["campplus"], vocoder=v1_mem["vocoder"])
        src2 = synthetic_audio(20.0, sr, 140.0, seed=73)
        ref2 = synthetic_audio(5.0, sr, 220.0, seed=74)
        kw = dict(diffusion_steps=V2_STEPS, intelligibility_cfg_rate=0.7, similarity_cfg_rate=0.7)
        waves = {}
        for what, p in (("converted files", params), ("in memory", v2_mem)):
            t0 = time.perf_counter()
            conv = VoiceConverterV2(params=p, device="cuda")
            built = time.perf_counter() - t0
            reset_counts()
            t0 = time.perf_counter()
            _, waves[what], stats = conv.convert_timbre(src2, sr, ref2, sr, **kw)
            torch.cuda.synchronize()
            counts = read_counts()
            log(f"checkpoints: v2 convert_timbre, trees {what}: built in {built:.1f} s, "
                f"{time.perf_counter() - t0:.2f} s cold (phase 9's warm "
                f"{v2_full['wall_s']:.3f} s), launches {counts}")
            if what == "converted files":
                timing["v2_build_s"], v2_counts = built, counts
                check_counts("v2 convert_timbre from converted checkpoints", counts,
                             v2_full["counts"])
            del conv
        lsb_v2 = lsb_diff(to16(waves["converted files"]), to16(waves["in memory"]))
        log(f"checkpoints: v2 convert_timbre from the converted files against in memory: "
            f"{lsb_v2} LSB (limit {CKPT_LSB})")
        if lsb_v2 > CKPT_LSB or not np.isfinite(waves["converted files"]).all():
            fail(f"v2 convert_timbre from converted checkpoints: {lsb_v2} LSB from in memory")
    log("checkpoints: seconds " + json.dumps({k: round(v, 2) for k, v in timing.items()}))
    return {"counts": infer_counts, "v2_counts": v2_counts, "timing": timing, "lsb": lsb,
            "lsb_v2": lsb_v2, "trees": checks}


# ---------------------------------------------------------------------------
# Multi-GPU (parallel/*): one process a GPU in a process group. (1) World
# size 1 over NCCL: apps.train and apps.train_v2 with --fsdp under the
# launcher's environment. (2)-(4) Two ranks on the one card over gloo with
# cuda tensors (NCCL refuses two ranks on one device): the sharded v1 step
# of the full-width DiT at (2, 1) and (1, 2) against the one-process step on
# the same batch and draws; the CFG-sharded conversions against the
# unsharded ones; three planted faults that the checks must catch. FSDP with
# two ranks does not run here: FSDP2 over gloo with cuda tensors kills both
# ranks (SIGSEGV) on the first forward, though each collective alone works
# (a probe on this card's machine); the CPU tests hold FSDP at 2 and 4
# ranks and (1) holds it over NCCL at world size 1. The two ranks share one
# card, so their times are no scaling figure.
MG_WORLD = 2
MG_MESHES = (("(2, 1)", 2, 1), ("(1, 2)", 1, 2))
# loss and grad norm relative; parameters over the largest |parameter| (K1ᵇ
# sums dq by atomics, and the ranks sum the batch and the norm in another order)
MG_STEP_RTOL = 1e-5
# a sharded wave against the unsharded one on the card: one f16 step near
# 1.0 (4.9e-4). Within it, a split run's bf16 DiT may differ from the whole
# run's where cuBLAS picks another algorithm for fewer rows; the small
# phase's 2e-3 (SMALL_TOL) would let the zeroed-halo fault through, whose
# error sits on the few frames beside each slab's edge.
MG_WAVE_TOL = 5e-4
MG_WORLD1_RTOL = 1e-5  # world size 1 with FSDP against phase 10's losses


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mg_world1(card: str, train: dict) -> dict:
    """(1) apps.train --fsdp (3 steps) and apps.train_v2 --fsdp (2 steps)
    under RANK=0, WORLD_SIZE=1 over NCCL, in process, on phase 10's clips and
    seed: the v1 losses against phase 10's first three."""
    import tempfile

    import torch
    import torch.distributed as dist

    from seedvc_tpu_torch.apps import train as train_app
    from seedvc_tpu_torch.apps import train_v2 as train_v2_app
    from seedvc_tpu_torch.apps.audio_io import save_wav
    from seedvc_tpu_torch.parallel import distributed

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    cwd, sr, out = os.getcwd(), 22050, {}
    try:
        with tempfile.TemporaryDirectory(prefix="mg_world1_") as tmp:
            data = os.path.join(tmp, "data")
            os.makedirs(data)
            for i, secs in enumerate(TRAIN_CLIPS):
                save_wav(os.path.join(data, f"clip{i}.wav"),
                         synthetic_audio(secs, sr, 110.0 + 17 * i, seed=60 + i), sr)
            os.chdir(tmp)
            base = ["--dataset-dir", data, "--batch-size", "2", "--log-interval", "1",
                    "--save-interval", "100", "--fsdp"]
            for what, app, extra, n in (
                    ("v1", train_app.main, ["--max-steps", "3", "--export-dir", "x"], 3),
                    ("v2", train_v2_app.main, ["--max-steps", "2", "--warmup-steps", "1"], 2)):
                reset_counts()
                t0 = time.perf_counter()
                tr = app(base + extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                _, rows = train_step_log(tr.history)
                check_train_history(f"multi-GPU world 1 {what} --fsdp", rows, 1, n)
                st = tr.state
                n_fsdp = sum(e.fsdp_dim is not None for e in st.layout.entries.values())
                dtensors = sum(hasattr(p, "to_local") for p in st.params.values())
                log(f"multi-GPU world 1 ({dist.get_backend()}, world {dist.get_world_size()}) "
                    f"{what} --fsdp: {n} steps in {wall:.1f} s wall; mesh {st.layout.mesh}; "
                    f"{n_fsdp} parameters FSDP-sharded ({dtensors} DTensors) of {len(st.params)}; "
                    f"losses {[r['loss'] for r in rows]}; launches (K1, K1b) "
                    f"{[(r['k1'], r['k1b']) for r in rows]}; {card}")
                if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
                    fail("multi-GPU world 1: not an NCCL group of one rank")
                if not n_fsdp or not dtensors:
                    fail(f"multi-GPU world 1 {what}: --fsdp sharded nothing")
                out[what] = {"losses": [r["loss"] for r in rows], "wall_s": wall}
            ref = train["train f32"]["losses"][:3]
            rel = max(abs(a - b) / abs(b) for a, b in zip(out["v1"]["losses"], ref))
            log(f"multi-GPU world 1 v1 --fsdp losses against phase 10's: {out['v1']['losses']} "
                f"vs {ref}, worst relative difference {rel:.2e} (tol {MG_WORLD1_RTOL:g})")
            if rel > MG_WORLD1_RTOL:
                fail("multi-GPU world 1: the FSDP run's losses differ from phase 10's")
            out["v1"]["rel"] = rel
    finally:
        os.chdir(cwd)
        if dist.is_initialized():
            dist.destroy_process_group()
        distributed._initialized = False
        for k in env:
            os.environ.pop(k, None)
    return out


def mg_shape_hooks(model, shapes: set) -> list:
    """Record the (B, heads, T, head_dim) that each attention layer of
    ``model`` hands its kernel (this rank's rows and heads)."""
    from seedvc_tpu_torch.nn.layers import Attention

    def hook(mod, args):
        x = args[0]
        shapes.add((x.shape[0], mod.n_head, x.shape[1], mod.head_dim))
    return [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, Attention)]


def mg_train(rank: int, problems: list) -> dict:
    """(2) and (4): one step of the full-width v1 model on B = 2, T = 896
    (mel lens 896 and 700) with fixed draws: the one-process step, then the
    sharded step at each of MG_MESHES, then the planted faults."""
    import torch

    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.models.vc import VCModel, draw_train
    from seedvc_tpu_torch.nn.layers import Attention
    from seedvc_tpu_torch.ops import attention
    from seedvc_tpu_torch.parallel.mesh import make_mesh
    from seedvc_tpu_torch.parallel.sharding import Layout, TPSplit
    from seedvc_tpu_torch.train import step as step_mod
    from seedvc_tpu_torch.train.optim import make_optimizer

    mp = get_preset("whisper_small_wavenet").model_params
    torch.manual_seed(0)
    base = VCModel(mp).state_dict()
    rng = np.random.default_rng(31)
    B, T, Ts = 2, MG_T, 448
    host = {"s_alt": rng.standard_normal((B, Ts, 768)), "s_ori": rng.standard_normal((B, Ts, 768)),
            "mels": rng.standard_normal((B, T, 80)) - 4.0, "style": rng.standard_normal((B, 192))}
    batch = {k: torch.from_numpy(v.astype(np.float32)).cuda() for k, v in host.items()}
    batch["mel_lens"] = torch.tensor(MG_LENS, dtype=torch.int32, device="cuda")
    batch["s_lens"] = torch.tensor(440, dtype=torch.int32, device="cuda")
    draws = draw_train(torch.Generator(device="cuda").manual_seed(7), B, T, 80,
                       mp.DiT.class_dropout_prob, device="cuda")
    opt = make_optimizer(1e-4, grad_clip=TRAIN_CLIP)

    def fresh():
        m = VCModel(mp)
        m.load_state_dict(base)
        return m.cuda()

    model = fresh()
    st = step_mod.init_state(model, opt)
    st, m = step_mod.make_train_step(model, opt, draws_fn=lambda *_: draws)(st, batch, 0)
    ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    scale = max(p.abs().max().item() for p in ref["params"].values())
    del model, st

    def sharded(n_data, n_model):
        mesh = make_mesh(n_data, n_model, device_type="cuda")
        model = fresh()
        st = step_mod.shard_state(step_mod.init_state(model, opt), mesh, model=model)
        step = step_mod.make_sharded_train_step(model, opt, mesh, draws_fn=lambda *_: draws)
        shapes: set = set()
        hooks = mg_shape_hooks(model, shapes)
        reset_counts()
        st, m = step(st, batch, 0)
        torch.cuda.synchronize()
        counts = (attention.LAUNCHES, attention.BWD_LAUNCHES)
        for h in hooks:
            h.remove()
        full = step_mod.gather_full(st.layout, st.params)
        err = max((full[n] - r).abs().max().item() for n, r in ref["params"].items())
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "loss_rel": abs(float(m["loss"]) - ref["loss"]) / abs(ref["loss"]),
                "grad_norm_rel": abs(float(m["grad_norm"]) - ref["grad_norm"]) / ref["grad_norm"],
                "param_err": err / scale, "k1": counts[0], "k1b": counts[1],
                "shapes": sorted(shapes),
                "split": sum(e.tp is not None for e in st.layout.entries.values())}

    def agrees(r):
        return max(r["loss_rel"], r["grad_norm_rel"], r["param_err"]) <= MG_STEP_RTOL

    out = {"ref": {"loss": ref["loss"], "grad_norm": ref["grad_norm"]}}
    for name, n_data, n_model in MG_MESHES:
        r = sharded(n_data, n_model)
        out[name] = r
        log(f"[rank {rank}] multi-GPU step {name}: loss {r['loss']:.7f} (one process "
            f"{ref['loss']:.7f}, rel {r['loss_rel']:.2e}), grad norm {r['grad_norm']:.6f} "
            f"(rel {r['grad_norm_rel']:.2e}), parameters max diff / max|p| "
            f"{r['param_err']:.2e} (tol {MG_STEP_RTOL:g}); K1 f32 {r['k1']}, K1b {r['k1b']} "
            f"launches at {r['shapes']}; {r['split']} tensors split over model")
        if not agrees(r):
            problems.append(f"step {name} disagrees with the one-process step")
        if (r["k1"], r["k1b"]) != (TRAIN_DEPTH, TRAIN_DEPTH):
            problems.append(f"step {name}: launches (K1, K1b) {(r['k1'], r['k1b'])}")
        want = ((1, 8, MG_T, 64) if n_data == 2 else (2, MG_HEADS, MG_T, 64))
        if r["shapes"] != [want]:
            problems.append(f"step {name}: attention shapes {r['shapes']}, expected {want}")

    # (4) planted faults, each of which the checks above must see
    real_splits, real_group, real_rows = Attention.tp_splits, Layout.group, step_mod.draw_rows

    def contiguous(self):
        H, Hkv, hd = self.n_head, self.n_kv, self.head_dim
        return {"wqkv.weight": TPSplit(0, ((H + 2 * Hkv) * hd,)),
                "wo.weight": TPSplit(1, (H * hd,))}

    def own_rows(draws, mesh, n):  # a rank that draws for its own rows alone
        return type(draws)(*(d if d is None or d.ndim == 0 else d[: n // mesh.size("data")]
                             for d in draws))

    faults = (("contiguous wqkv split", 1, 2, lambda: setattr(Attention, "tp_splits", contiguous)),
              ("local-only grad norm", 1, 2, lambda: setattr(Layout, "group", lambda s, a: None)),
              ("a rank's own noise", 2, 1, lambda: setattr(step_mod, "draw_rows", own_rows)))
    out["faults"] = {}
    for what, n_data, n_model, plant in faults:
        plant()
        try:
            r = sharded(n_data, n_model)
        finally:
            Attention.tp_splits, Layout.group = real_splits, real_group
            step_mod.draw_rows = real_rows
        caught = not agrees(r)
        out["faults"][what] = caught
        log(f"[rank {rank}] planted fault '{what}' at ({n_data}, {n_model}): loss rel "
            f"{r['loss_rel']:.2e}, grad norm rel {r['grad_norm_rel']:.2e}, parameters "
            f"{r['param_err']:.2e}: {'caught' if caught else 'NOT caught'}")
        if not caught:
            problems.append(f"planted fault '{what}' passed the checks")
    return out


@contextlib.contextmanager
def sampler_mels():
    """Every mel that the converters' samplers return inside the block, on
    the host (the list yielded): the eager loops and the graphed sampler,
    which an unsharded conversion on cuda takes (v2's through
    ``euler_solve_multicfg``: a sampler called inside another counts once)."""
    from seedvc_tpu_torch.models.cfm import EulerGraph
    from seedvc_tpu_torch.pipelines import convert, convert_v2

    real = convert.euler_solve, convert_v2.euler_solve_multicfg, EulerGraph.__call__
    mels: list = []
    depth = [0]

    def kept(fn):
        def run(*args, **kwargs):
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if not depth[0]:
                mels.append(out.float().cpu())
            return out
        return run
    convert.euler_solve, convert_v2.euler_solve_multicfg = kept(real[0]), kept(real[1])
    EulerGraph.__call__ = kept(real[2])
    try:
        yield mels
    finally:
        convert.euler_solve, convert_v2.euler_solve_multicfg, EulerGraph.__call__ = real


def mg_sharded_run(rank: int, what: str, vc, model, mesh, call, base, expect: dict,
                   problems: list) -> dict:
    """One sharded conversion of ``vc`` (its shard axes set by the caller)
    on ``mesh``: wall, launches, the (B, heads, query rows, head_dim) its
    attention layers see, and the wave against the unsharded ``base`` =
    (wave, its sampler's mels); the mels' largest difference is printed
    beside it."""
    import torch

    from seedvc_tpu_torch.parallel.mesh import set_mesh

    shapes: set = set()
    hooks = mg_shape_hooks(model, shapes)
    with set_mesh(mesh), sampler_mels() as mels:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, wave, _ = call(vc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    for h in hooks:
        h.remove()
    base, base_mels = base
    err, snr = (float(x) for x in compare_waves(f"multi-GPU {what}", wave, base))
    if mels and len(mels) == len(base_mels):
        mel_err = max(float((a - b).abs().max()) for a, b in zip(mels, base_mels))
    else:
        mel_err = float("nan")
        problems.append(f"{what}: {len(mels)} sampler mels against the unsharded run's "
                        f"{len(base_mels)}")
    log(f"[rank {rank}] multi-GPU {what}: {len(wave) / 22050:.2f} s of audio in {wall:.3f} s "
        f"wall (the ranks share one card); against the unsharded wave max abs {err:.2e} (tol "
        f"{MG_WAVE_TOL:g}), SNR {snr:.1f} dB, the sampler's mels max abs {mel_err:.2e}; "
        f"launches {counts}; attention at {sorted(shapes)}")
    if counts != expect:
        problems.append(f"{what}: launches {counts}, expected {expect}")
    if err > MG_WAVE_TOL:
        problems.append(f"{what}: the wave differs from the unsharded one")
    return {"counts": counts, "shapes": sorted(shapes), "err": err, "snr": snr,
            "mel_err": mel_err, "wall_s": wall}


@contextlib.contextmanager
def zero_halos():
    """Planted fault of the time-sharded runs: every convolution's halo rows
    from the neighbours left zero (the sequence's own ends still padded)."""
    from seedvc_tpu_torch.parallel.mesh import SeqShard

    real = SeqShard.halo

    def halo(self, x, pad, mode):
        out = real(self, x, pad, mode).clone()
        if pad and self.rows.start > 0:
            out[..., :pad] = 0
        if pad and self.rows.stop < self.total:
            out[..., -pad:] = 0
        return out
    SeqShard.halo = halo
    try:
        yield
    finally:
        SeqShard.halo = real


def mg_convert(rank: int, problems: list) -> dict:
    """(3) The sharded conversions: VoiceConverter on phase 5's clip and
    VoiceConverterV2.convert_timbre on phase 9's, unsharded, then with
    cfg_shard_axis='data' on a (2, 1) mesh and with seq_shard_axis='model'
    on a (1, 2) mesh (K1 over each rank's query slab), and the v1 preset with
    use_flash_attention=False time-sharded against its own unsharded run;
    each rank's launches and the shapes its attention runs; the planted
    fault (zeroed halos) must fail the v1 comparison."""
    import dataclasses

    import torch

    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.parallel.mesh import make_mesh
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    from seedvc_tpu_torch.pipelines.convert_v2 import VoiceConverterV2

    cfg_mesh = make_mesh(MG_WORLD, 1, device_type="cuda")
    seq_mesh = make_mesh(1, MG_WORLD, device_type="cuda")
    out = {}
    v1_src, v1_ref = synthetic_audio(30.0, 22050, 140.0, seed=4), synthetic_audio(
        5.0, 22050, 220.0, seed=5)
    v2_src, v2_ref = synthetic_audio(20.0, 22050, 140.0, seed=54), synthetic_audio(
        5.0, 22050, 220.0, seed=55)
    preset = get_preset("whisper_small_wavenet")
    plain = dataclasses.replace(preset, model_params=dataclasses.replace(
        preset.model_params, DiT=dataclasses.replace(preset.model_params.DiT,
                                                     use_flash_attention=False)))
    v1_expect = {"k1": MAIN_CHUNKS * 25 * 13, "k2": MAIN_CHUNKS * 109, "k3": 0}

    def v1_call(vc):
        return vc.convert(v1_src, 22050, v1_ref, 22050, diffusion_steps=25, cfg_rate=0.7)

    # each rank's attention in the time-sharded runs: the CFG stack, 8 heads,
    # its query slab (with v2's prefix tokens on rank 0)
    a, b = seq_slabs(MAIN_CONTEXT)[rank]
    v1_slab = [[2, 8, b - a, 64]]
    a, b = seq_slabs(V2_T - 2, 2)[rank]
    v2_slab = [[3, 8, b - a, 64]]
    for what, make, call, expect, slab in (
            ("v1", lambda: VoiceConverter(device="cuda"), v1_call, v1_expect, v1_slab),
            ("v2", lambda: VoiceConverterV2(device="cuda"),
             lambda vc: vc.convert_timbre(v2_src, 22050, v2_ref, 22050,
                                          diffusion_steps=V2_STEPS, intelligibility_cfg_rate=0.7,
                                          similarity_cfg_rate=0.7),
             {"k1": V2_STEPS * 13, "k2": 109, "k3": 0}, v2_slab),
            ("v1 plain", lambda: VoiceConverter(plain, device="cuda"), v1_call,
             {**v1_expect, "k1": 0}, v1_slab)):
        vc = make()
        model = vc.dit if what == "v2" else vc.vc
        with sampler_mels() as mels:
            base = call(vc)[1], mels
        if what != "v1 plain":
            vc.cfg_shard_axis = "data"
            out[what] = mg_sharded_run(rank, f"CFG-sharded {what}", vc, model, cfg_mesh, call,
                                       base, expect, problems)
            vc.cfg_shard_axis = None
        vc.seq_shard_axis = "model"
        out[f"{what} seq"] = r = mg_sharded_run(rank, f"time-sharded {what}", vc, model,
                                                seq_mesh, call, base, expect, problems)
        if [list(x) for x in r["shapes"]] != slab:
            problems.append(f"time-sharded {what}: attention at {r['shapes']}, expected {slab}")
        if what == "v1":
            with zero_halos():
                fault: list = []
                r = mg_sharded_run(rank, "time-sharded v1 with zeroed halos (planted fault)",
                                   vc, model, seq_mesh, call, base, expect, fault)
            caught = r["err"] > MG_WAVE_TOL
            out["fault zero halos"] = {"err": r["err"], "mel_err": r["mel_err"], "caught": caught}
            log(f"[rank {rank}] planted fault 'zeroed halos': max abs {r['err']:.2e}: "
                f"{'caught' if caught else 'NOT caught'}")
            if not caught:
                problems.append("planted fault 'zeroed halos' passed the wave comparison")
        del vc, model
        torch.cuda.empty_cache()
    return out


def mg_rank_main(rank: int, store: str, out_dir: str) -> int:
    """One of the two ranks of (2)-(4): its results as JSON in ``out_dir``."""
    import datetime

    import torch

    from seedvc_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{store}", MG_WORLD, rank, device="cuda:0", backend="gloo",
                           timeout=datetime.timedelta(seconds=300))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    problems: list = []
    res = {"rank": rank, "train": mg_train(rank, problems),
           "convert": mg_convert(rank, problems), "problems": problems}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0  # the parent reads the problems from the result


def mg_two_ranks(card: str, timeout: float = 420.0) -> list:
    """Start the two ranks (this script with --mg-rank), wait for both
    (killing both if one fails or the time runs out), return their results."""
    import tempfile
    import threading

    with tempfile.TemporaryDirectory(prefix="mg_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                   "--mg-rank", str(r), "--mg-store", store, "--mg-out", tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(MG_WORLD)]
        t0, outs = time.perf_counter(), {}

        def drain(r, p):
            outs[r] = p.stdout.read()
        threads = [threading.Thread(target=drain, args=(r, p), daemon=True)
                   for r, p in enumerate(procs)]
        for t in threads:
            t.start()
        while any(p.poll() is None for p in procs):
            if (time.perf_counter() - t0 > timeout
                    or any(p.poll() not in (None, 0) for p in procs)):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                break
            time.sleep(0.5)
        for p in procs:
            p.wait()
        for t in threads:
            t.join(timeout=10)
        wall = time.perf_counter() - t0
        for r in range(MG_WORLD):
            for line in (outs.get(r) or "").splitlines():
                if line.startswith("[rank") or "Error" in line or "FAILED" in line:
                    log(line)
        rcs = [p.returncode for p in procs]
        log(f"multi-GPU two ranks on one card over gloo: exit codes {rcs}, {wall:.1f} s wall; "
            f"{card}")
        results = []
        for r in range(MG_WORLD):
            path = os.path.join(tmp, f"rank{r}.json")
            if not os.path.exists(path):
                tail = "\n".join((outs.get(r) or "").splitlines()[-30:])
                fail(f"multi-GPU rank {r} wrote no result (exit {rcs[r]}):\n{tail}")
            with open(path) as f:
                results.append(json.load(f))
    for res in results:
        for problem in res["problems"]:
            log(f"FAILED: multi-GPU rank {res['rank']}: {problem}")
    if any(res["problems"] for res in results) or any(rcs):
        fail("multi-GPU: a rank's checks failed")
    return results


def mg_rows(mg: dict, errs: dict, card: str) -> list:
    """The kernels line's rows of phase 13's shapes, launches from its runs
    (each rank's count; ``launches`` is rank 0's, the shapes rank 0's unless
    named otherwise): K1 bf16 at one CFG branch a rank of the v1 conversion
    and of v2's 3-way stack (2 rows on rank 0, 1 on rank 1), K1 over each
    rank's query slab in the time-sharded v1 and v2 conversions (and, with
    no launches, xlsr_tiny's slabs of phase 3), K2 in each
    rank's vocoder, K1 f32 and K1ᵇ at the (1, 2) step's 4 heads and the
    (2, 1) step's one row."""
    ranks = mg["ranks"]
    conv = [r["convert"] for r in ranks]
    path = "multi-GPU (phase 13): {} on 2 ranks of one card, rank {}"
    k1_b1 = k1_timing(MAIN_CONTEXT, 8, 1966, seed=41, B=1)
    v2_b2 = k1_timing(V2_T, 8, V2_LENS, seed=42, B=2)
    v2_b1 = k1_timing(V2_T, 8, V2_LENS, seed=43, B=1)
    k2 = k2_timing(UPSAMPLE_22K)
    per_rank = {w: [c[w]["counts"] for c in conv] for w in ("v1", "v2")}
    rows = [
        {**k1_row(k1_b1, conv[0]["v1"]["counts"]["k1"], errs["k1_mg"],
                  path.format("CFG-sharded whisper_small_wavenet conversion", 0)),
         "launches_per_rank": [c["k1"] for c in per_rank["v1"]]},
        {**k2_row(k2, conv[0]["v1"]["counts"]["k2"], errs["k2"],
                  path.format("CFG-sharded whisper_small_wavenet conversion", 0)),
         "launches_per_rank": [c["k2"] for c in per_rank["v1"]]},
        {**k1_row(v2_b2, conv[0]["v2"]["counts"]["k1"], errs["k1_v2"],
                  path.format("CFG-sharded v2 convert_timbre", 0)),
         "launches_per_rank": [c["k1"] for c in per_rank["v2"]]},
        {**k1_row(v2_b1, conv[1]["v2"]["counts"]["k1"], errs["k1_mg"],
                  path.format("CFG-sharded v2 convert_timbre", 1)),
         "launches_per_rank": [c["k1"] for c in per_rank["v2"]]}]
    # the time-sharded conversions on a (1, 2) mesh: K1 over each rank's
    # query slab, K2 in each rank's whole vocoder
    seq_path = "multi-GPU (phase 13): time-sharded {} on 2 ranks of one card, rank {}"
    v1_name, v2_name = "whisper_small_wavenet conversion", "v2 convert_timbre"
    for r, ab in enumerate(seq_slabs(MAIN_CONTEXT)):
        t = k1_timing(MAIN_CONTEXT, 8, 1966, seed=44 + r, slab=ab)
        rows.append({**k1_row(t, conv[r]["v1 seq"]["counts"]["k1"], errs["k1_seq"],
                              seq_path.format(v1_name, r)),
                     "launches_per_rank": [c["v1 seq"]["counts"]["k1"] for c in conv]})
    for r, ab in enumerate(seq_slabs(V2_T - 2, 2)):
        t = k1_timing(V2_T, 8, V2_LENS, seed=46 + r, B=3, slab=ab)
        rows.append({**k1_row(t, conv[r]["v2 seq"]["counts"]["k1"], errs["k1_seq"],
                              seq_path.format(v2_name, r)),
                     "launches_per_rank": [c["v2 seq"]["counts"]["k1"] for c in conv]})
    # xlsr_tiny's slab (its prefix on the first): phase 3 holds it; no
    # time-sharded xlsr_tiny path runs here
    for r, ab in enumerate(seq_slabs(RT_OFFLINE_T - 2, 2)):
        t = k1_timing(RT_OFFLINE_T, RT_HEADS, 1968, seed=48 + r, slab=ab)
        rows.append(k1_row(t, 0, errs["k1_seq"], f"none: phase 3 only ({RT_PRESET}'s query "
                                                 f"slab of rank {r} of 2)"))
    k2_v2 = k2_timing(UPSAMPLE_22K, V2_W)
    for what, key, k2_t, err in (
            (v1_name, "v1 seq", k2, errs["k2"]), (v2_name, "v2 seq", k2_v2, errs["k2_v2"]),
            (f"{v1_name} with use_flash_attention=False", "v1 plain seq", k2, errs["k2"])):
        rows.append({**k2_row(k2_t, conv[0][key]["counts"]["k2"], err, seq_path.format(what, 0)),
                     "launches_per_rank": [c[key]["counts"]["k2"] for c in conv]})
    for name, B, H in (("(1, 2)", 2, MG_HEADS), ("(2, 1)", 1, 8)):
        steps = [r["train"][name] for r in ranks]
        for row in train_kernel_rows(MG_T, B, H, steps[0]["k1"], card,
                                     path.format(f"the sharded v1 step at {name}", 0),
                                     kinds=TRAIN_KINDS[:2]):
            key = "k1" if row["name"] == "dit_attention_fused" else "k1b"
            rows.append({**row, "launches_per_rank": [s[key] for s in steps]})
    return rows


def phase_multi_gpu(card: str, train: dict) -> dict:
    t0 = time.perf_counter()
    world1 = mg_world1(card, train)
    ranks = mg_two_ranks(card)
    log(f"multi-GPU phase: {time.perf_counter() - t0:.1f} s")
    return {"world1": world1, "ranks": ranks}


@contextlib.contextmanager
def smi_sampler(period_ms: int = 100):
    """Samples of the card's SM clock, power draw, power limit and temperature
    every ``period_ms`` while the block runs (collected in the list yielded)."""
    samples = []
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
                             "temperature.gpu", "--format=csv,noheader", "-lms", str(period_ms)],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield samples
    finally:
        proc.terminate()
        out, _ = proc.communicate()
        samples.extend(line.strip() for line in out.splitlines() if line.strip())


def k1_timing(T: int, heads: int, n_valid: int, seed: int, B: int = 2,
              slab: tuple | None = None) -> dict:
    """K1 against its plain twin and SDPA (on the same roped q, k) at q/k/v
    (B, heads, T, 64) bf16 with n_valid keys, and its bound. ``slab`` = (a,
    b): q holds rows a..b only (a rank's query slab, roped at those
    positions) against all T keys."""
    import torch
    import torch.nn.functional as F

    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.ops import attention

    q, k, v, cos, sin, lens = _k1_inputs(T, torch.bfloat16, (n_valid,) * B, seed=seed,
                                         heads=heads)
    a, b = (0, T) if slab is None else slab
    q = q[:, :, a:b].contiguous()
    q_rope = (cos[a:b], sin[a:b])
    ms = cuda_time_ms(lambda: attention.dit_attention_fused(q, k, v, cos, sin, lens,
                                                            q_rope=q_rope))
    plain = cuda_time_ms(lambda: attention.dit_attention_fused_reference(
        q, k, v, cos, sin, lens, q_rope), iters=5)
    prepass = cuda_time_ms(lambda: attention.rope_prepass(q, k, cos, sin, q_rope))
    qr = attention.rope_scaled_reference(q, *q_rope)
    kr = attention.rope_scaled_reference(k, cos, sin)
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask))
    B, H, Tq, d = q.shape
    b_ms, b_by = bound(4.0 * d * Tq * H * n_valid * B, PEAK_BF16,
                       2 * (Tq + T) * B * H * d * 2 + 2 * T * d * 4 + B * 4)
    what = (f"q/k/v {tuple(q.shape)}" if slab is None
            else f"q {tuple(q.shape)} (rows {a}:{b}), k/v {tuple(k.shape)}")
    log(f"K1 {what} bf16 lens={n_valid}: kernel {ms:.4f} ms (RoPE pre-pass alone "
        f"{prepass:.4f} ms), plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return {"shape": f"{what} bf16, lens {n_valid}", "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "library_ms": lib}


def k2_timing(rates, W: int = MAIN_W) -> dict:
    """K2 at every stage shape of a chunk: kernel, plain twin, bound, and a
    device copy of x (the practical floor of the bytes; no yardstick of the
    function, so not a row's library_ms)."""
    import torch

    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.ops import anti_alias

    g = torch.Generator(device="cuda").manual_seed(8)
    k2 = {}
    for shape in stage_shapes(rates, W):
        x, alpha, beta, _ = k2_inputs(shape, "default", g)
        ms = cuda_time_ms(lambda: anti_alias.anti_alias_snake(x, alpha, beta), iters=200)
        plain = cuda_time_ms(lambda: anti_alias.anti_alias_snake_reference(x, alpha, beta),
                             iters=5)
        copy = cuda_time_ms(lambda: torch.empty_like(x).copy_(x), iters=200)
        n, C = x.numel(), shape[1]
        b_ms, b_by = bound(K2_FLOPS * n, PEAK_F32, 8 * n + 8 * C)
        k2[shape] = (ms, plain, b_ms, b_by, copy)
        log(f"K2 {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), bound share {b_ms / ms:.1%}"
            + (" (over 100%: fed from the L2)" if b_ms > ms else "")
            + f"; copy of x {copy:.4f} ms")
    return k2


def k2_row(k2: dict, launches: int, err: float, path: str) -> dict:
    """The kernels line's K2 row: the most frequent launch shape (stages 1-5
    and the post activation move the same bytes), and every stage."""
    shape = list(k2)[-1]
    ms, plain, b_ms, b_by, _ = k2[shape]
    return {"name": "anti_alias_snake", "route": "cuda", "path": path,
            "source": "seedvc_tpu_torch/csrc/anti_alias.cu",
            "replaces": "seedvc_tpu/ops/pallas/anti_alias.py:303 (and :242, C <= 64)",
            "shape": f"x {shape} f32", "launches": launches, "max_abs_err": err, "tol": K2_TOL,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "stages": [{"shape": list(sh), "ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
                        "bound_by": v[3], "copy_ms": v[4]} for sh, v in k2.items()]}


def k1_row(t: dict, launches: int, err: float, path: str) -> dict:
    return {"name": "dit_attention_fused", "route": "cuda", "path": path,
            "source": "seedvc_tpu_torch/csrc/attention.cu",
            "replaces": "seedvc_tpu/ops/pallas/attention.py:171", "launches": launches,
            "max_abs_err": err, "tol": K1_TOL["bfloat16"][0], **t}


def phase_kernel_line(errs: dict, full: dict, svc: dict, mb_counts: dict, rt: dict,
                      v2: dict, ev: dict, web: dict, ckpt: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from seedvc_tpu_torch.core.profiling import cuda_time_ms
    from seedvc_tpu_torch.ops import attention

    # K1 at each path's shape: CFG-stacked (2, H, context, 64) bf16, keys
    # valid up to prompt + first chunk
    k1_main = k1_timing(MAIN_CONTEXT, 8, min(full["p_len"] + full["W"], MAIN_CONTEXT), seed=7)
    k1_svc = k1_timing(MAIN_CONTEXT, K1_SVC_HEADS, svc["lens"][0], seed=17)
    # the real-time paths: 6 heads, T with the 2 prefix tokens
    k1_rt = k1_timing(RT_OFFLINE_T, RT_HEADS, rt["lens"][0], seed=27)
    k1_block = k1_timing(RT_BLOCK_T, RT_HEADS, RT_BLOCK_T, seed=28)
    # the v2 path: the 3-way CFG stack at T = 2560, the timbre run's keys
    k1_v2 = k1_timing(V2_T, 8, v2["lens"][0], seed=29, B=3)
    # the eval path: one chunk at context 1536, the 10 s source's keys
    k1_eval = k1_timing(EVAL_T, 8, EVAL_LENS[0], seed=37)
    k1_eval_svc = k1_timing(EVAL_T, K1_SVC_HEADS, EVAL_LENS[0], seed=38)
    # the web UI's v2 request: the AR sets its length, so its plan is its own
    web_cap, web_context, web_W = web["v2"]["stats"]["plan"]
    k1_web_v2 = k1_timing(web_context + 2, 8, web["v2"]["lens"][0], seed=39, B=3)

    # K3 at its entry point's shape: the microbench attention component,
    # q/k/v (2, 8, 2560, 64) bf16 after RoPE, every key valid
    T3 = 2560
    q3, k3, v3, _, _, _ = _k1_inputs(T3, torch.bfloat16, None, seed=9)
    k3_ms = cuda_time_ms(lambda: attention.dit_attention(q3, k3, v3))
    k3_plain = cuda_time_ms(lambda: attention.dit_attention_reference(q3, k3, v3), iters=5)
    k3_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q3, k3, v3))
    B, H, _, d = q3.shape
    k3_bound, k3_by = bound(4.0 * B * H * T3 * T3 * d, PEAK_BF16, 4 * B * H * T3 * d * 2)
    log(f"K3 {tuple(q3.shape)} bf16 lens=None: kernel {k3_ms:.4f} ms, plain {k3_plain:.4f} ms, "
        f"sdpa {k3_lib:.4f} ms, bound {k3_bound:.4f} ms ({k3_by})")
    # the wave tail at K3's shape: without one, the time per head would be
    # the same at B*H = 13 and 26 as at 16
    g3 = torch.Generator(device="cuda").manual_seed(10)
    per_head = {B * H: k3_ms / (B * H)}
    for shape in ((1, 13, T3, d), (2, 13, T3, d)):
        qt, kt, vt = (torch.randn(shape, generator=g3, device="cuda").bfloat16() for _ in range(3))
        per_head[shape[0] * shape[1]] = cuda_time_ms(
            lambda: attention.dit_attention(qt, kt, vt)) / (shape[0] * shape[1])
    log(f"K3 wave tail at T={T3}: ms per head by B*H "
        + ", ".join(f"{n}: {t:.5f}" for n, t in sorted(per_head.items()))
        + f"; tail share at B*H = {B * H}: {1 - per_head[26] / per_head[B * H]:.3f}")

    # K2 at every stage shape of a 22 kHz and of a 44.1 kHz chunk, the card's
    # clocks and power sampled beside them
    with smi_sampler() as samples:
        k2_main = k2_timing(UPSAMPLE_22K)
        k2_svc = k2_timing(UPSAMPLE_44K)
        k2_v2 = k2_timing(UPSAMPLE_22K, V2_W)
        k2_eval = k2_timing(UPSAMPLE_22K, EVAL_W)
        k2_eval_svc = k2_timing(UPSAMPLE_44K, EVAL_W)
        k2_web_v2 = k2_timing(UPSAMPLE_22K, web_W)
    log("K2 windows, nvidia-smi clocks.sm, power.draw, power.limit, temperature.gpu: "
        + " | ".join(samples))
    main_path, svc_path = "whisper_small_wavenet conversion", f"{SVC_PRESET} SVC conversion"
    return {"kernels": [
        k1_row(k1_main, full["counts"]["k1"], errs["k1"], main_path),
        k2_row(k2_main, full["counts"]["k2"], errs["k2"], main_path),
        {"name": "dit_attention", "route": "cuda", "path": "microbench attention",
         "source": "seedvc_tpu_torch/csrc/attention.cu",
         "replaces": "seedvc_tpu/ops/pallas/attention.py:247",
         "shape": f"q/k/v {tuple(q3.shape)} bf16, lens None",
         "launches": mb_counts["attention"]["k3"],
         "max_abs_err": errs["k3"], "tol": K1_TOL["bfloat16"][0],
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib},
        k1_row(k1_svc, svc["counts"]["k1"], errs["k1_svc"], svc_path),
        k2_row(k2_svc, svc["counts"]["k2"], errs["k2_svc"], svc_path),
        k1_row(k1_rt, rt["counts"]["k1"], errs["k1_rt"], f"{RT_PRESET} offline conversion"),
        stream_k1_row(k1_block, rt, errs["k1_rt"]),
        k1_row(k1_v2, v2["counts"]["k1"], errs["k1_v2"], "v2 convert_timbre (V2Config())"),
        k2_row(k2_v2, v2["counts"]["k2"], errs["k2_v2"], "v2 convert_timbre (V2Config())"),
        k1_row(k1_eval, ev["eval"]["counts"]["k1"], errs["k1_eval"], EVAL_PATH),
        k2_row(k2_eval, ev["eval"]["counts"]["k2"], errs["k2_eval"], EVAL_PATH),
        k1_row(k1_eval_svc, ev["eval f0"]["counts"]["k1"], errs["k1_eval_svc"], EVAL_F0_PATH),
        k2_row(k2_eval_svc, ev["eval f0"]["counts"]["k2"], errs["k2_eval_svc"], EVAL_F0_PATH),
        k1_row(k1_main, web["vc"]["counts"]["k1"], errs["k1"], WEB_PATH.format("vc")),
        k2_row(k2_main, web["vc"]["counts"]["k2"], errs["k2"], WEB_PATH.format("vc")),
        k1_row(k1_svc, web["svc"]["counts"]["k1"], errs["k1_svc"], WEB_PATH.format("svc")),
        k2_row(k2_svc, web["svc"]["counts"]["k2"], errs["k2_svc"], WEB_PATH.format("svc")),
        k1_row(k1_web_v2, web["v2"]["counts"]["k1"], errs["k1_v2"], WEB_PATH.format("v2")),
        k2_row(k2_web_v2, web["v2"]["counts"]["k2"], errs["k2_v2"], WEB_PATH.format("v2")),
        k1_row(k1_main, ckpt["counts"]["k1"], errs["k1"], CKPT_PATH),
        k2_row(k2_main, ckpt["counts"]["k2"], errs["k2"], CKPT_PATH),
        k1_row(k1_v2, ckpt["v2_counts"]["k1"], errs["k1_v2"], CKPT_V2_PATH),
        k2_row(k2_v2, ckpt["v2_counts"]["k2"], errs["k2_v2"], CKPT_V2_PATH),
    ]}


def stream_k1_row(t: dict, rt: dict, err: float) -> dict:
    """K1 on the stream: the wrappers count the eager warm-up's launches and
    the captured ones; a replay relaunches the captured ones on the device
    without calling a wrapper. ``launches`` is what ran on the device in the
    stream_bench run: the warm-up's, plus the captured per replay times the
    replays the stream counted."""
    counted = rt["bench_counts"]["k1"]
    per_replay = rt["bench"]["graph_launches"]["k1"]
    replays = rt["bench"]["replays"]
    return {**k1_row(t, counted - per_replay + per_replay * replays, err,
                     f"{RT_PRESET} stream_bench (eager warm-up, then {replays} replays of the "
                     "captured block)"),
            "wrapper_count": counted, "per_replay": per_replay, "replays": replays}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm conversion of each full-width path "
                         "(torch.profiler)")
    ap.add_argument("--mg-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mg-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mg-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.mg_rank is not None:  # one rank of the multi-GPU phase
        return mg_rank_main(args.mg_rank, args.mg_store, args.mg_out)
    card = phase_device()
    import torch

    import seedvc_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    phase_build()
    errs = phase_kernels()
    errs_bwd = phase_kernels_bwd()
    phase_small()
    full = phase_full(card, args.profile)
    svc = phase_svc(card, args.profile)
    mb_counts = phase_microbench()
    phase_rt_small()
    rt = phase_rt_full(card, args.profile)
    phase_v2_small()
    v2 = phase_v2_full(card, args.profile)
    ar = phase_ar_decode(card, v2)
    train = phase_train(card, args.profile)
    v2t = phase_train_v2(card, args.profile)
    phase_openvoice_train(card)
    ev = phase_eval(card)
    web = phase_webui(card)
    ckpt = phase_checkpoints(card, full, v2)
    mg = phase_multi_gpu(card, train)
    line = phase_kernel_line(errs, full, svc, mb_counts, rt, v2, ev, web, ckpt)
    line["kernels"] += ar["rows"]
    line["kernels"] += mg_rows(mg, errs, card)
    line["kernels"] += train_rows(train["train f32"]["T"], card, "v1 fine-tuning (apps.train, f32)")
    line["kernels"] += train_rows(v2t["T"], card, "v2 fine-tuning (apps.train_v2, f32)",
                                  kinds=TRAIN_KINDS[:2])
    log(f"K1b worst errors against the twin in phase 3 (rel_l2, max/max|ref|, max abs): "
        f"{errs_bwd}")
    log(card)
    print(json.dumps(line), flush=True)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
