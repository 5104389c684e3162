"""v2 voice/accent conversion: the AR model and the CFM over ASTRAL/BSQ
tokens (port of ``seedvc_tpu/pipelines/convert_v2.py``).

- content: HuBERT-large (cut at layer 18) features on the 16 kHz wave
  padded to 5 s buckets, then both quantizers on that one pass: "narrow"
  tokens (codebook 32, the AR's source) and "wide" tokens (codebook 2048,
  the CFM's condition), cropped to ``len // 320``;
- ``convert_timbre``: the source's wide tokens -> the CFM regulator ->
  multi-condition CFG CFM -> BigVGAN 22 kHz;
- ``convert_voice``: the duration-reduced narrow tokens, with the
  reference's as a prefix, in chunks sized so prefix + chunk <= 1500 tokens,
  all decoded by ONE batched AR ``generate`` into wide tokens; the output's
  mel length follows the AR's token ratio (accent conversion may stretch or
  shrink the utterance); ``cap_to_source`` caps each row at the 50 Hz length
  of its own source span (the durations of its reduced tokens summed), so
  the output lasts about as long as the source, as a trained model's does;
  ``anonymization_only`` decodes with an empty prefix and prompt and samples
  in the ``random_voice`` CFG mode;
- the CFM runs in chunks of one context window (``plan_chunks`` with
  ``align_offset=2`` for the two prefix tokens) joined by a 16-frame
  cosine² crossfade; each chunk's initial noise comes from a generator seeded
  with ``seed``, or from ``noise_fn(shape)``, and the AR's exponential draws
  from its own default, or from ``draws_fn(shape)``;
- ``keep_intermediates`` keeps what the conversion computed on its way, for
  a comparison with a reference: HuBERT's features and both quantizers'
  normalised projections (the continuous numbers whose signs are the
  tokens), the AR's rows and each decode step's f32 logits, and each Euler
  step's state and combined estimate.

``device`` defaults to ``cuda`` and raises when there is none. On cuda the
content encoder, both quantizers, the DiT and the AR run in bfloat16 (the
JAX package's TPU choice; the AR's logits and sampling stay f32) unless
``compute_dtype`` says otherwise; the regulators, CAMPPlus and the vocoder
run in f32 with TF32 off. On the CPU everything is f32.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from seedvc_tpu_torch.core.config import LengthRegulatorConfig, SpectConfig
from seedvc_tpu_torch.core.profiling import StageTimer, probe_ready
from seedvc_tpu_torch.dsp.mel import MelFrontend
from seedvc_tpu_torch.dsp.resample import resample
from seedvc_tpu_torch.models.ar import ARConfig, ARGenerator, ARTransformer
from seedvc_tpu_torch.models.astral import (ASTRAL_NARROW, ASTRAL_WIDE, AstralConfig,
                                            AstralQuantizer)
from seedvc_tpu_torch.models.bigvgan import BIGVGAN_22K_80, BigVGAN
from seedvc_tpu_torch.models.campplus import CAMPPlus
from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg
from seedvc_tpu_torch.models.dit_v2 import DiTV2, DiTV2Config
from seedvc_tpu_torch.models.regulator import InterpolateRegulator
from seedvc_tpu_torch.models.ssl import HUBERT_LARGE_L18, SSLConfig, SSLEncoder
from seedvc_tpu_torch.nn.bsq import duration_reduction, run_lengths
from seedvc_tpu_torch.pipelines.convert import (_chunks, _context_window, _drain,
                                                campplus_style, plan_chunks)
from seedvc_tpu_torch.weights import load_jax_params

AR_MAX_CONTENT_LEN = 1500  # narrow tokens in one AR condition row
AR_MAX_NEW_TOKENS = 2048


@dataclass
class V2Config:
    """``context_frames`` 2558 = 5 * 512 - 2: with the time and style tokens
    the DiT attends over 2560 positions."""

    sr: int = 22050
    hop: int = 256
    n_mels: int = 80
    dit: DiTV2Config = field(default_factory=DiTV2Config)
    ar: ARConfig = field(default_factory=ARConfig)
    ssl: SSLConfig = field(default_factory=lambda: HUBERT_LARGE_L18)
    narrow: AstralConfig = field(default_factory=lambda: ASTRAL_NARROW)
    wide: AstralConfig = field(default_factory=lambda: ASTRAL_WIDE)
    prompt_cap_frames: int = 768
    context_frames: int = 2558
    max_ref_sec: float = 25.0


class VoiceConverterV2:
    """Parameters are random (from ``seed``) unless flax trees come in
    through ``params``, keyed by :attr:`PARAM_NAMES`. ``self.generator`` is
    the batched AR decode (:class:`~seedvc_tpu_torch.models.ar.ARGenerator`,
    a CUDA graph a token on cuda). ``cfg_shard_axis`` splits the sampler's
    CFG stack (up to three branches, unevenly too) over that axis of the
    ``set_mesh`` mesh, as the v1 converter's; ``seq_shard_axis`` splits its
    time axis, as the v1 converter's. ``vocoder_cfg``: BigVGAN's geometry
    (default ``BIGVGAN_22K_80``)."""

    PARAM_NAMES = ("ssl", "narrow", "wide", "campplus", "cfm_reg", "ar_reg",
                   "dit", "ar", "vocoder")

    def __init__(self, cfg: V2Config = V2Config(), *, params: Optional[dict] = None,
                 seed: int = 0, cfg_shard_axis: Optional[str] = None,
                 seq_shard_axis: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None, vocoder_cfg=None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VoiceConverterV2: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self.cfg_shard_axis = cfg_shard_axis
        self.seq_shard_axis = seq_shard_axis
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.compute_dtype = compute_dtype
        self.cfg = cfg
        self.sr, self.hop, self.n_mels = cfg.sr, cfg.hop, cfg.n_mels
        self.mel_fn = MelFrontend(cfg.sr, SpectConfig(n_mels=cfg.n_mels))
        params = params or {}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            modules = {
                "ssl": SSLEncoder(cfg.ssl),
                "narrow": AstralQuantizer(cfg.narrow),
                "wide": AstralQuantizer(cfg.wide),
                "campplus": CAMPPlus(feat_dim=80, embedding_size=cfg.dit.style_encoder_dim),
                "cfm_reg": InterpolateRegulator(LengthRegulatorConfig(
                    channels=cfg.dit.content_dim, is_discrete=True,
                    content_codebook_size=cfg.wide.codebook_size,
                    sampling_ratios=(1, 1, 1, 1))),
                "ar_reg": InterpolateRegulator(LengthRegulatorConfig(
                    channels=cfg.ar.dim, is_discrete=True,
                    content_codebook_size=cfg.narrow.codebook_size, sampling_ratios=())),
                "dit": DiTV2(cfg.dit),
                "ar": ARTransformer(cfg.ar),
                "vocoder": BigVGAN(vocoder_cfg or BIGVGAN_22K_80),
            }
        for name, module in modules.items():
            if params.get(name) is not None:
                load_jax_params(module, params[name])
            module.requires_grad_(False).eval().to(self.device)
            if name in ("ssl", "narrow", "wide", "dit", "ar"):
                module.to(compute_dtype)
            setattr(self, name, module)
        self.generator = ARGenerator(self.ar, max_new_tokens=AR_MAX_NEW_TOKENS,
                                     device=self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def content_tokens(self, wave_16k: np.ndarray,
                       keep: Optional[dict] = None) -> tuple[np.ndarray, np.ndarray]:
        """(narrow, wide) indices (1, len // 320) of a 16 kHz wave, from one
        SSL pass over the wave zero-padded to a 5 s bucket (>= 8000 samples).
        ``keep`` receives the device tensors ``features`` (the bucket's
        frames, d_model) and the ``narrow`` and ``wide`` normalised
        projections (len // 320, bits)."""
        T = len(wave_16k)
        bucket = 5 * 16000
        padded = np.zeros(-(-max(T, 8000) // bucket) * bucket, np.float32)
        padded[:T] = wave_16k
        feats = self.ssl(torch.from_numpy(padded[None]).to(self.device, self.compute_dtype))
        n = T // 320
        (narrow, h_n), (wide, h_w) = self.narrow.codes(feats), self.wide.codes(feats)
        if keep is not None:
            keep.update(features=feats[0], narrow=h_n[0, :n], wide=h_w[0, :n])
        return narrow[:, :n].cpu().numpy(), wide[:, :n].cpu().numpy()

    def compute_style(self, wave_16k: np.ndarray) -> torch.Tensor:
        return campplus_style(self.campplus, wave_16k, self.device)

    @torch.no_grad()
    def _regulate_tokens(self, reg: InterpolateRegulator, tokens: np.ndarray,
                         mel_len: int) -> torch.Tensor:
        """Regulate in a 256-frame output bucket with the tokens padded to 64
        and their true length as ``x_lens``."""
        bucket = -(-mel_len // 256) * 256
        T = tokens.shape[1]
        tok = np.zeros((tokens.shape[0], -(-max(T, 1) // 64) * 64), np.int64)
        tok[:, :T] = tokens
        out = reg(torch.from_numpy(tok).to(self.device),
                  torch.tensor([mel_len], device=self.device), bucket,
                  x_lens=torch.tensor(T, device=self.device))[0]
        return out[:, :mel_len]

    def plan_chunks(self, target_len: int, p_len: int) -> tuple[int, int, int]:
        return plan_chunks(target_len, p_len, self.cfg.context_frames,
                           self.cfg.prompt_cap_frames, align_offset=2)

    @torch.no_grad()
    def _ar_tokens(self, src_n, tgt_n, src_w, tgt_w, anonymization_only: bool, seed: int,
                   draws_fn, *, cap_to_source: bool = False, keep: bool = False,
                   timer: Optional[StageTimer] = None,
                   **knobs) -> tuple[np.ndarray, int, Optional[dict]]:
        """Wide tokens (1, N) from the AR: the duration-reduced source narrow
        tokens in chunks behind the reference's (none when anonymising), all
        chunks decoded as one batch; the batch size; and with ``keep`` the
        decode's rows: ``tokens`` (B, max_new), ``n_tokens`` (B,),
        ``caps`` (B,) or None, ``cond_lens`` (B,), ``prompt_len`` and the
        device ``logits`` (steps + 1, B, vocab) f32."""
        tgt_red, _ = duration_reduction(tgt_n[0])
        src_red, _ = duration_reduction(src_n[0])
        src_dur = run_lengths(src_n[0])
        if anonymization_only:
            prefix, prompt_w = src_red[:0], src_w[:, :0]
        else:
            prefix, prompt_w = tgt_red, tgt_w
        max_chunk = max(AR_MAX_CONTENT_LEN - len(prefix), 1)
        chunks = [src_red[s: s + max_chunk] for s in range(0, max(len(src_red), 1), max_chunk)]
        B = len(chunks)
        cond_lens = np.array([len(prefix) + len(c) for c in chunks], np.int64)
        C_max = int(-(-cond_lens.max() // 256) * 256)
        ar_src = np.zeros((B, C_max), np.int64)
        for b, c in enumerate(chunks):
            ar_src[b, : len(prefix)] = prefix
            ar_src[b, len(prefix): len(prefix) + len(c)] = c
        # identity regulation per row: x_lens == out_len == the longest row
        cond_emb = self.ar_reg(torch.from_numpy(ar_src).to(self.device),
                               torch.from_numpy(cond_lens).to(self.device), C_max,
                               x_lens=torch.tensor(int(cond_lens.max()), device=self.device))[0]
        P_max = -(-max(prompt_w.shape[1], 8) // 64) * 64
        prompt_tok = np.zeros((B, P_max), np.int64)
        prompt_tok[:, : prompt_w.shape[1]] = prompt_w
        caps = None
        if cap_to_source:
            caps = np.array([int(src_dur[s: s + max_chunk].sum())
                             for s in range(0, max(len(src_red), 1), max_chunk)], np.int64)
        g = self.generator
        tokens, n_tok = g.generate(
            cond_emb, torch.from_numpy(cond_lens), torch.from_numpy(prompt_tok),
            prompt_w.shape[1], draws_fn=draws_fn, seed=seed,
            max_tokens=None if caps is None else torch.from_numpy(caps),
            keep_logits=keep, timer=timer, **knobs)
        tokens, n_tok = tokens.cpu().numpy(), n_tok.cpu().numpy()
        rows = None
        if keep:
            rows = {"tokens": tokens, "n_tokens": n_tok, "caps": caps, "cond_lens": cond_lens,
                    "prompt_len": int(prompt_w.shape[1]),
                    "logits": g.logits[: g.decode_steps + 1]}
        wide = np.concatenate([tokens[b, : int(n_tok[b])] for b in range(B)])[None]
        return wide, B, rows

    @torch.no_grad()
    def _sample_vocode(self, noise, chunk, prompt_cond, total_len, prompt_mel, prompt_len: int,
                       context: int, *, style, n_steps: int, rates, random_voice: bool,
                       timer: StageTimer, keep: Optional[tuple] = None) -> torch.Tensor:
        """Multi-condition CFG sampling over [prompt ‖ chunk] in one context
        window, the generated region vocoded; returns the f16 wave. The two
        halves are ``timer``'s stages ``sample`` (counting its Euler
        ``steps``) and ``vocode``, with no synchronise between them.
        ``keep``: buffers for the sampler's state and estimate of each step
        (``euler_solve_multicfg``)."""
        cd = self.compute_dtype
        W = chunk.shape[1]
        with timer("sample"):
            cond, pm = _context_window(chunk, prompt_cond, prompt_mel, prompt_len, context, cd)

            def estimate(x, px, lens, t, s, m, sc=None):
                return self.dit(x, px, lens, t, s, m, static_cond=sc)

            def precompute(x, px, lens, s, m):
                return self.dit(x, px, lens, torch.zeros(x.shape[0], device=x.device), s, m,
                                return_static=True)

            mel_out = euler_solve_multicfg(
                estimate, noise.to(cd), cond, total_len, pm, prompt_len, style.to(cd),
                n_timesteps=n_steps, cfg_rates=rates, random_voice=random_voice,
                precompute_fn=precompute, shard_axis=self.cfg_shard_axis,
                seq_shard_axis=self.seq_shard_axis, keep=keep)
            timer.count("steps", n_steps)
        with timer("vocode"):
            gen = mel_out[:, prompt_len: prompt_len + W].float()
            return self.vocoder(gen).half()

    # ------------------------------------------------------------------
    def convert_voice(self, source, source_sr, reference, reference_sr,
                      **kwargs) -> tuple[int, np.ndarray, dict]:
        """Full conversion; drains :meth:`convert_voice_with_streaming`."""
        return _drain(self.convert_voice_with_streaming(source, source_sr, reference,
                                                        reference_sr, **kwargs),
                      self.sr, {"rtf": 0.0, "wall_seconds": 0.0, "wide_tokens": 0})

    def convert_timbre(self, source, source_sr, reference, reference_sr, **kwargs):
        """Timbre-only conversion: no AR."""
        kwargs["convert_style"] = False
        return self.convert_voice(source, source_sr, reference, reference_sr, **kwargs)

    def convert_voice_with_streaming(
            self, source: np.ndarray, source_sr: int, reference: np.ndarray,
            reference_sr: int, *, convert_style: bool = True,
            anonymization_only: bool = False, diffusion_steps: int = 30,
            length_adjust: float = 1.0, intelligibility_cfg_rate: float = 0.7,
            similarity_cfg_rate: float = 0.7, top_p: float = 0.7, temperature: float = 0.7,
            repetition_penalty: float = 1.5, seed: int = 0,
            noise_fn: Optional[Callable] = None, draws_fn: Optional[Callable] = None,
            cap_to_source: bool = False, keep_intermediates: bool = False,
            profile: bool = False):
        """Generator yielding ``(sr, wave_chunk, stats)`` per crossfaded
        chunk. ``stats``: ``rtf``, ``wall_seconds``, ``wide_tokens``,
        ``narrow_tokens`` (the source's, before duration reduction),
        ``ar_batch`` (rows of the one AR decode, 0 without it), ``decode_steps``,
        ``replays`` and ``ar_seconds`` of that decode, ``target_len``,
        ``plan`` (prompt cap, context, W), ``chunks`` and ``stages`` (wall
        seconds by stage; with ``profile=True`` each stage ends in a device
        synchronise, and each is a recorded span with device time on cuda:
        ``ar`` holds ``ar.prefill`` and ``ar.decode`` with its counters,
        ``sample+vocode`` holds ``sample`` (its Euler ``steps``) and
        ``vocode``).

        ``cap_to_source``: each AR row stops at the 50 Hz length of its source
        span at the latest. ``keep_intermediates``: ``stats["kept"]`` holds
        ``source`` and ``reference`` (see :meth:`content_tokens`), ``tokens``
        (the source's and reference's narrow and wide tokens and the AR's
        wide tokens), ``ar_rows`` (see :meth:`_ar_tokens`; None without the
        AR) and ``chunks``: per CFM chunk its ``p_len``, ``w``, and the
        sampler's ``states`` and combined ``estimates`` of each Euler step,
        device tensors (steps, 1, context, n_mels)."""
        cfg, dev = self.cfg, self.device
        timer = StageTimer(record=profile, device=dev)

        def sync(x):
            return probe_ready(x) if profile else x

        t_start = time.time()
        reference = reference[: int(cfg.max_ref_sec * reference_sr)]
        with timer("resample"):
            def rs(wave, sr_in, sr_out):
                w = torch.from_numpy(np.asarray(wave, np.float32)).to(dev)
                return resample(w, sr_in, sr_out).cpu().numpy()

            src, ref = rs(source, source_sr, cfg.sr), rs(reference, reference_sr, cfg.sr)
            src16, ref16 = rs(source, source_sr, 16000), rs(reference, reference_sr, 16000)
        ref = ref[: cfg.prompt_cap_frames * cfg.hop]
        ref16 = ref16[: int(len(ref) / cfg.sr * 16000)]

        kept = ({"source": {}, "reference": {}, "chunks": []} if keep_intermediates
                else None)
        with timer("content"):
            src_n, src_w = self.content_tokens(src16, None if kept is None else kept["source"])
            tgt_n, tgt_w = self.content_tokens(ref16,
                                               None if kept is None else kept["reference"])
        with timer("mel+style"):
            mel2 = self.mel_fn(torch.from_numpy(ref[None]).to(dev))
            style = sync(self.compute_style(ref16))
        p_len = mel2.shape[1]
        with timer("regulate"):
            prompt_cond = sync(self._regulate_tokens(self.cfm_reg, tgt_w, p_len))

        ar_batch, ar = 0, {"decode_steps": 0, "replays": 0, "ar_seconds": 0.0}
        ar_rows = None
        if convert_style or anonymization_only:
            with timer("ar"):
                wide_tokens, ar_batch, ar_rows = self._ar_tokens(
                    src_n, tgt_n, src_w, tgt_w, anonymization_only, seed, draws_fn,
                    cap_to_source=cap_to_source, keep=keep_intermediates, timer=timer,
                    temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty)
            g = self.generator
            ar = {"decode_steps": g.decode_steps, "replays": g.replays, "ar_seconds": g.decode_s}
        else:
            wide_tokens = src_w

        src_mel_len = len(src) // cfg.hop
        if ar_batch:
            # the duration follows the AR's token ratio
            target_len = max(int(src_mel_len / max(src_w.shape[1], 1) * wide_tokens.shape[1]
                                 * length_adjust), 1)
        else:
            target_len = int(src_mel_len * length_adjust)
        with timer("regulate"):
            cond = sync(self._regulate_tokens(self.cfm_reg, wide_tokens, target_len))

        plan = self.plan_chunks(target_len, p_len)
        extra, per_chunk = {}, None
        if kept is not None:
            kept.update(ar_rows=ar_rows, tokens={
                "src_narrow": src_n, "src_wide": src_w, "ref_narrow": tgt_n, "ref_wide": tgt_w,
                "wide": wide_tokens})
            extra = {"kept": kept}

            def per_chunk(w):
                steps = torch.empty((2, diffusion_steps, 1, plan[1], cfg.n_mels),
                                    dtype=self.compute_dtype, device=dev)
                kept["chunks"].append({"p_len": p_len, "w": w, "states": steps[0],
                                       "estimates": steps[1]})
                return {"keep": (steps[0], steps[1])}

        rates = (float(intelligibility_cfg_rate), float(similarity_cfg_rate))
        for n, emitted, piece in _chunks(
                self._sample_vocode, cond, prompt_cond, mel2, p_len, target_len, plan, cfg.hop,
                seed=seed, noise_fn=noise_fn, timer=timer, sync=sync, per_chunk=per_chunk,
                style=style, n_steps=diffusion_steps, rates=rates,
                random_voice=bool(anonymization_only)):
            dt = time.time() - t_start
            yield cfg.sr, piece, {
                "rtf": dt / max(emitted / cfg.sr, 1e-9), "wall_seconds": dt,
                "wide_tokens": int(wide_tokens.shape[1]), "narrow_tokens": int(src_n.shape[1]),
                "ar_batch": ar_batch, **ar, "target_len": target_len, "plan": plan,
                "chunks": n, "stages": timer.report(), **extra}

    def warm(self, specs, *, diffusion_steps: int = 30, intelligibility_cfg_rate: float = 0.7,
             similarity_cfg_rate: float = 0.7, warm_ar: bool = False,
             verbose: bool = True) -> list:
        """One silent conversion per distinct ``plan_chunks`` plan of the
        ``(source_seconds, ref_seconds)`` pairs in ``specs`` (with
        ``warm_ar``, the first through the AR); returns the plans warmed.
        Eager PyTorch compiles nothing: this builds the kernels, cuDNN and
        cuBLAS plans and the device tables the conversions use."""
        cfg = self.cfg
        warmed, seen = [], set()
        kw = dict(diffusion_steps=diffusion_steps,
                  intelligibility_cfg_rate=intelligibility_cfg_rate,
                  similarity_cfg_rate=similarity_cfg_rate)
        for i, (src_s, ref_s) in enumerate(specs):
            target_len = max(int(src_s * cfg.sr) // cfg.hop, 1)
            p_len = min(max(int(ref_s * cfg.sr) // cfg.hop, 1), cfg.prompt_cap_frames)
            plan = self.plan_chunks(target_len, p_len)
            if plan in seen:
                continue
            seen.add(plan)
            t0 = time.time()
            src = np.zeros(target_len * cfg.hop, np.float32)
            ref = np.zeros(p_len * cfg.hop, np.float32)
            self.convert_voice(src, cfg.sr, ref, cfg.sr, convert_style=warm_ar and i == 0, **kw)
            warmed.append(plan)
            if verbose:
                print(f"warmed v2 (prompt_cap, context, W) = {plan} in {time.time() - t0:.1f} s")
        return warmed
