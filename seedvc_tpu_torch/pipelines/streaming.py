"""Real-time streaming voice conversion (port of
``seedvc_tpu/pipelines/streaming.py``): a block pipeline whose state lives in
one :class:`StreamingConverter`.

Per audio block:
1. shift the model-rate and 16 kHz ring buffers, append the new block (the
   16 kHz copy resampled on the device, each block alone, with zero edges),
2. content features over the whole window (an SSL window zero-padded to a
   5 s bucket, a Whisper one to 30 s); drop the leading
   ``(extra_ce - extra_dit) * 50`` frames,
3. length-regulate to the DiT window (``ylens = [dit_frames]``, no
   bucketing) and put the cached reference prompt condition in front,
4. CFG Euler sampling, then the vocoder (HiFT with the draws that are the
   same every block, or BigVGAN),
5. take ``crossfade + sola_search + block`` samples ending ``extra_right``
   before the window's end, SOLA-align them against the previous tail, fade,
   emit ``block`` samples.

A VAD gate (energy and spectral flatness, a 2-block hangover) sends silent
blocks past the model: they still shift the rings, and emit the previous
tail faded into silence.

**The block program.** Steps 1-4 are one function over static device
buffers: the two rings, the block's input, its CFM noise, the prompt
condition, prompt mel and style, HiFT's draws and the output. On cuda,
:meth:`StreamingConverter.set_reference` runs it once eagerly (which builds
every kernel and caches every table it uses) and then captures it as one
CUDA graph that :meth:`StreamingConverter.process_block` replays: the
counterpart of the JAX package's one jitted, warmed block program, so block
0 runs at steady state. The kernel wrappers count a launch when it is
captured; ``graph_launches`` holds what one replay launches and ``replays``
counts the replays. On the CPU the function runs eagerly every block.

The block program runs the content encoder in f32 (an f32 copy of the
converter's when its ``compute_dtype`` is lower), as the JAX block program
applies it with the f32 weights; the reference's features come from the
converter's own, as in the JAX package.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from seedvc_tpu_torch.core.profiling import annotate, elapsed_ms
from seedvc_tpu_torch.dsp.resample import resample, resample_kernel
from seedvc_tpu_torch.dsp.sola import crossfade_add, sola_offset
from seedvc_tpu_torch.dsp.vad import is_speech_block
from seedvc_tpu_torch.dsp.whisper_mel import whisper_log_mel
from seedvc_tpu_torch.models.cfm import euler_solve
from seedvc_tpu_torch.ops import launches
from seedvc_tpu_torch.pipelines.convert import VoiceConverter


@dataclass
class StreamConfig:
    block_time: float = 0.25       # seconds per block
    crossfade_time: float = 0.04
    sola_search_time: float = 0.012
    extra_time_ce: float = 2.5     # content-encoder left context
    extra_time_dit: float = 0.5    # DiT left context
    extra_time_right: float = 0.02
    diffusion_steps: int = 10
    cfg_rate: float = 0.7
    max_prompt_time: float = 3.0
    # energy + spectral-flatness VAD gate (dsp/vad.py); <= -1000 disables it
    vad_threshold_db: float = -60.0


# the block program's device parts, between consecutive timing events
DEVICE_PARTS = ("encode_ms", "cfm_ms", "vocode_ms")
TIMINGS_KEPT = 4096


class StreamingConverter:
    """``noise_fn(shape) -> tensor``: each converted block's initial CFM
    noise (default: a ``torch.Generator`` seeded with 0 in
    :meth:`set_reference`, one draw a block). ``draws_fn((B, n_samples, H))
    -> (phase, noise)``: HiFT's draws, made once in :meth:`set_reference`
    (default: the vocoder's own, see ``models/hifigan.py``)."""

    def __init__(self, converter: VoiceConverter, cfg: StreamConfig = StreamConfig(), *,
                 noise_fn: Optional[Callable] = None, draws_fn: Optional[Callable] = None):
        self.vc = converter
        self.cfg = cfg
        self.noise_fn = noise_fn
        self.draws_fn = draws_fn
        sr, hop = converter.sr, converter.hop
        self.sr = sr

        def samples(t):  # rounded to hop multiples for clean mel frames
            return int(round(t * sr / hop)) * hop

        self.block = samples(cfg.block_time)
        self.crossfade = samples(cfg.crossfade_time)
        self.sola_search = samples(cfg.sola_search_time)
        self.extra_ce = samples(cfg.extra_time_ce)
        self.extra_dit = samples(cfg.extra_time_dit)
        self.extra_right = samples(cfg.extra_time_right)

        self.window = (self.extra_ce + self.crossfade + self.sola_search + self.block
                       + self.extra_right)
        self.window_16k = int(self.window / sr * 16000)
        # region the DiT generates, after dropping the CE-only left context
        self.dit_window = self.window - (self.extra_ce - self.extra_dit)
        self.dit_frames = self.dit_window // hop
        self.return_samples = self.crossfade + self.sola_search + self.block
        self.block_16k = -(-16000 * self.block // sr)  # resample's ceil length
        self.drop = int((self.extra_ce - self.extra_dit) / sr * 50)
        if converter.ssl:
            bucket = 5 * 16000
            self.pad16 = -(-max(self.window_16k, 8000) // bucket) * bucket
            self.n_sem = self.window_16k // 320
        else:
            self.pad16 = 30 * 16000
            self.n_sem = self.window_16k // 320 + 1

        self.encoder = (converter.whisper if converter.compute_dtype == torch.float32
                        else copy.deepcopy(converter.whisper).float())

        self.sola_buffer: Optional[np.ndarray] = None
        self._prompt_len = 0
        self._buf: dict = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._gen: Optional[torch.Generator] = None
        self._vad_hang = 0  # blocks of speech hangover left
        # per-block wall split of the last converted block: host ms of
        # "gate_ms", "dispatch_ms", "sync_ms" (includes the device time),
        # "sola_ms" and "total_ms" (entry to return); the graph's device ms of
        # "encode_ms", "cfm_ms" and "vocode_ms" (None when run eagerly)
        self.last_timings: Optional[dict] = None
        # one record a block, the last TIMINGS_KEPT: "gated", "gate_ms",
        # "total_ms" and, for a converted block, last_timings' other keys
        self.timings: deque = deque(maxlen=TIMINGS_KEPT)
        self._marks: tuple = (None,) * 4
        # launches of each kernel in one replay of the captured block (cuda),
        # and the replays since set_reference
        self.graph_launches: Optional[dict] = None
        self.replays = 0

    # ------------------------------------------------------------------
    def set_reference(self, ref_wave: np.ndarray, ref_sr: int):
        """Cache the reference's prompt condition, prompt mel and style,
        make the block program's buffers and, on cuda, warm and capture it."""
        vc, dev = self.vc, self.vc.device
        ref_wave = np.asarray(ref_wave[: int(self.cfg.max_prompt_time * ref_sr)], np.float32)
        wave = torch.from_numpy(ref_wave).to(dev)
        ref = resample(wave, ref_sr, vc.sr).cpu().numpy()
        ref_16k = resample(wave, ref_sr, 16000).cpu().numpy()
        s_ori = vc.semantic_features(ref_16k)
        mel2 = vc._mel_bucketed(ref)
        self._prompt_len = p_len = mel2.shape[1]
        total = p_len + self.dit_frames
        L = self.dit_frames * vc.hop
        b = {
            "ring": torch.zeros(self.window, device=dev),
            "ring16": torch.zeros(self.window_16k, device=dev),
            "block": torch.zeros(self.block, device=dev),
            "noise": torch.zeros((1, total, vc.n_mels), device=dev),
            "out": torch.zeros(self.return_samples, device=dev),
            "prompt_cond": vc._regulate_bucketed(s_ori, p_len),
            "prompt_mel": F.pad(mel2, (0, 0, 0, total - p_len)),
            "style": vc.compute_style(ref_16k),
            "rs_kernel": resample_kernel(vc.sr, 16000, dev),
            "ylens": torch.tensor([self.dit_frames], device=dev),
            "sem_len": torch.tensor(self.n_sem - self.drop, device=dev),
            "total": torch.tensor([total], device=dev),
            "draws": None,
        }
        if vc.vocoder_type == "hifigan":
            shape = (1, L, vc.vocoder.cfg.nb_harmonics + 1)
            draws = (self.draws_fn(shape) if self.draws_fn is not None
                     else vc.vocoder.default_draws(1, L, dev))
            b["draws"] = tuple(d.to(dev) for d in draws)
        self._buf = b
        self._gen = torch.Generator(device=dev).manual_seed(0)
        self.sola_buffer = None
        self._vad_hang = 0
        self._graph = None
        self.replays = 0
        if dev.type == "cuda":
            self._capture()

    def _capture(self):
        """Run the block function once eagerly on a side stream (kernel
        builds, cuFFT plans, cached tables), capture it as one CUDA graph
        with its four timing events (``external=True``: nodes of the graph,
        recorded by each replay), then zero the rings the two runs shifted."""
        dev = self.vc.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = launches.counts()
        marks = tuple(torch.cuda.Event(enable_timing=True, external=True) for _ in range(4))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step(marks)
        self.graph_launches = {k: v - before[k] for k, v in launches.counts().items()}
        self._graph, self._marks = graph, marks
        self._buf["ring"].zero_()
        self._buf["ring16"].zero_()
        torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------
    def _shift_rings(self):
        """Append the block (and its 16 kHz resampling) to the rings, in place."""
        b = self._buf
        block16 = resample(b["block"], self.sr, 16000, b["rs_kernel"])
        b["ring"].copy_(torch.cat([b["ring"][self.block:], b["block"]]))
        b["ring16"].copy_(torch.cat([b["ring16"][self.block_16k:], block16]))

    @torch.no_grad()
    def _step(self, marks: Optional[tuple] = None):
        """The block program: rings -> content -> regulate -> CFM -> vocoder
        -> the returned span, written into ``out``. Static shapes, no host
        reads, so a CUDA graph can capture it. ``marks``: four timing events
        recorded at its start, after the content encoder, after the CFM and
        at its end (the capture's; see :data:`DEVICE_PARTS`)."""
        vc, b = self.vc, self._buf
        cd = vc.compute_dtype

        def mark(i):
            if marks is not None:
                marks[i].record()

        mark(0)
        self._shift_rings()
        padded = F.pad(b["ring16"], (0, self.pad16 - self.window_16k))[None]
        feats = self.encoder(padded if vc.ssl else whisper_log_mel(padded))
        mark(1)
        s_alt = feats[:, self.drop: self.n_sem]
        cond = vc.vc.regulate(s_alt, b["ylens"], self.dit_frames, x_lens=b["sem_len"])
        cat = torch.cat([b["prompt_cond"], cond], dim=1).to(cd)
        mel_out = euler_solve(vc.vc.estimate, b["noise"].to(cd), cat, b["total"],
                              b["prompt_mel"].to(cd), self._prompt_len, b["style"].to(cd),
                              n_timesteps=self.cfg.diffusion_steps, cfg_rate=self.cfg.cfg_rate,
                              precompute_fn=vc.vc.precompute_cond)
        mark(2)
        gen = mel_out[:, self._prompt_len:].float()
        L = self.dit_frames * vc.hop
        wave = vc.vocode(gen, b["draws"])[0, :L]
        start = L - self.return_samples - self.extra_right
        b["out"].copy_(wave[start: start + self.return_samples])
        mark(3)

    # ------------------------------------------------------------------
    def process_block(self, block: np.ndarray) -> np.ndarray:
        """One audio block at the model rate in, one converted block out.

        Its parts are ``torch.profiler`` spans: ``stream.gate`` (the input
        copy and the voice gate), ``stream.dispatch`` (the noise draw and the
        replay), ``stream.sync`` (the wait for the output span) and
        ``stream.sola``. Each block appends its record to :attr:`timings`."""
        t_in = time.perf_counter()
        if not self._buf:
            raise RuntimeError("call set_reference() first")
        if len(block) != self.block:
            raise ValueError(f"block of {len(block)} samples, expected {self.block}")
        b, cfg = self._buf, self.cfg
        with annotate("stream.gate"):
            b["block"].copy_(torch.from_numpy(np.asarray(block, np.float32)))
            gated = False
            if cfg.vad_threshold_db > -1000:
                # hangover: after speech keep converting 2 more blocks, so a
                # borderline mid-word block is bridged instead of cut to silence
                if is_speech_block(block, self.sr, threshold_db=cfg.vad_threshold_db):
                    self._vad_hang = 2
                elif self._vad_hang > 0:
                    self._vad_hang -= 1
                gated = self._vad_hang <= 0
        t0 = time.perf_counter()
        if gated:
            with torch.no_grad():
                self._shift_rings()
            if self.sola_buffer is not None:
                # fade the previous tail out into silence
                out = np.zeros(self.block + self.crossfade, np.float32)
                out = crossfade_add(out, self.sola_buffer)
                self.sola_buffer = np.zeros(self.crossfade, np.float32)
                out = out[: self.block]
            else:
                out = np.zeros(self.block, np.float32)
            self._record(t_in, t0, {}, gated=True)
            return out

        with annotate("stream.dispatch"):
            shape = tuple(b["noise"].shape)
            noise = (self.noise_fn(shape) if self.noise_fn is not None
                     else torch.randn(shape, generator=self._gen, device=self.vc.device))
            b["noise"].copy_(noise)
            if self._graph is not None:
                self._graph.replay()
                self.replays += 1
            else:
                self._step()
        t1 = time.perf_counter()
        with annotate("stream.sync"):
            out = b["out"].to("cpu", copy=True).numpy()  # the next block rewrites b["out"]
        t2 = time.perf_counter()

        # SOLA align + fade against the previous tail
        with annotate("stream.sola"):
            if self.sola_buffer is None:
                emitted = out[: self.block]
                self.sola_buffer = out[self.block: self.block + self.crossfade].copy()
            else:
                k = sola_offset(out[: self.crossfade + self.sola_search], self.sola_buffer,
                                self.sola_search)
                aligned = crossfade_add(np.ascontiguousarray(out[k:]), self.sola_buffer)
                emitted = aligned[: self.block]
                self.sola_buffer = aligned[self.block: self.block + self.crossfade].copy()
                if len(self.sola_buffer) < self.crossfade:
                    self.sola_buffer = np.pad(self.sola_buffer,
                                              (0, self.crossfade - len(self.sola_buffer)))
        parts = {"dispatch_ms": round((t1 - t0) * 1e3, 2),
                 "sync_ms": round((t2 - t1) * 1e3, 2),
                 "sola_ms": round((time.perf_counter() - t2) * 1e3, 2)}
        # the replay's events: the output copy above already waited for them
        for name, a, e in zip(DEVICE_PARTS, self._marks, self._marks[1:]):
            ms = elapsed_ms(a, e) if self._graph is not None else None
            parts[name] = None if ms is None else round(ms, 2)
        self.last_timings = self._record(t_in, t0, parts, gated=False)
        return emitted

    def _record(self, t_in: float, t0: float, parts: dict, gated: bool) -> dict:
        """Append a block's record to :attr:`timings`: ``parts`` with
        ``gate_ms`` (entry to the gate's decision) and ``total_ms`` (entry to
        now); returns ``parts`` so extended."""
        parts["gate_ms"] = round((t0 - t_in) * 1e3, 2)
        parts["total_ms"] = round((time.perf_counter() - t_in) * 1e3, 2)
        self.timings.append({"gated": gated, **parts})
        return parts
