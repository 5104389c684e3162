"""Offline voice-conversion pipeline (v1), port of ``seedvc_tpu/pipelines/convert.py``.

1. resample source/reference to the model rate and to 16 kHz (host, scipy),
2. semantic features in 30 s windows (5 s overlap, 250 overlapped frames
   dropped on concat): Whisper on the window zero-padded to 30 s, or an SSL
   encoder (XLS-R, the real-time preset) on the window zero-padded to a 5 s
   bucket,
3. mel of the reference, CAMPPlus style from a kaldi fbank,
4. with F0 conditioning (the SVC presets): RMVPE F0 of source and reference,
   the source's matched to the reference's median log-F0 and shifted by
   ``pitch_shift`` semitones,
5. length-regulate source and reference content (and F0),
6. chunked CFM generation: per chunk, condition = [reference prompt ‖ source
   chunk] in one fixed context window chosen by :func:`plan_chunks`,
7. vocoding per chunk (BigVGAN, or HiFT for the real-time preset),
   16-frame cosine^2 crossfade joins.

The lengths are bucketed as in the JAX package (5 s mel buckets with a
reflect-continued tail, 1 s style buckets, 256-frame regulate and F0
buckets), so the two give the same numbers on the same weights and noise.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from seedvc_tpu_torch.core.config import SeedVCConfig, get_preset
from seedvc_tpu_torch.core.profiling import StageTimer, probe_ready
from seedvc_tpu_torch.dsp.fbank import kaldi_fbank
from seedvc_tpu_torch.dsp.mel import MelFrontend
from seedvc_tpu_torch.dsp.resample import resample_host
from seedvc_tpu_torch.dsp.whisper_mel import whisper_log_mel
from seedvc_tpu_torch.models.bigvgan import BIGVGAN_22K_80, BIGVGAN_44K_128, BigVGAN
from seedvc_tpu_torch.models.campplus import CAMPPlus
from seedvc_tpu_torch.models.cfm import EulerGraph, euler_solve
from seedvc_tpu_torch.models.hifigan import HiFTConfig, HiFTGenerator
from seedvc_tpu_torch.models.regulator import f0_to_coarse
from seedvc_tpu_torch.models.rmvpe import RMVPE, RMVPE_E2E
from seedvc_tpu_torch.models.ssl import XLSR_300M_L12, SSLEncoder
from seedvc_tpu_torch.models.vc import VCModel
from seedvc_tpu_torch.models.whisper import WHISPER_SMALL, WhisperEncoder, WhisperEncoderConfig
from seedvc_tpu_torch.weights import load_jax_params

OVERLAP_FRAMES = 16  # reference overlap_frame_len


def plan_chunks(target_len: int, p_len: int, max_context: int,
                prompt_cap: int, align_offset: int = 0) -> tuple[int, int, int]:
    """Pick ``(prompt_cap_b, context, W)`` for one conversion: the real
    prompt length bucketed to 256 frames, the minimal chunk count at the max
    window, the source spread evenly across the chunks, and the context
    rounded up to a multiple of 512. Contexts <= 512 keep the configured
    window."""
    if max_context <= 512:
        return prompt_cap, max_context, max_context - prompt_cap
    cap = min(-(-max(p_len, 1) // 256) * 256, prompt_cap)
    W_max = max_context - cap
    n = max(1, -(-target_len // W_max))
    span = target_len + (n - 1) * OVERLAP_FRAMES
    w = -(-span // n)
    context = min(-(-(cap + w + align_offset) // 512) * 512 - align_offset, max_context)
    return cap, context, context - cap


def cosine_crossfade(chunk1: np.ndarray, chunk2: np.ndarray, overlap: int) -> np.ndarray:
    """Reference ``crossfade`` (cos^2 fade-out of chunk1's tail into chunk2)."""
    fade_out = np.cos(np.linspace(0, np.pi / 2, overlap)) ** 2
    fade_in = np.cos(np.linspace(np.pi / 2, 0, overlap)) ** 2
    out = chunk2.copy()
    n = min(len(chunk2), overlap)
    out[:n] = chunk2[:n] * fade_in[:n] + (chunk1[-overlap:] * fade_out)[:n]
    return out


def join_chunk(prev_tail: Optional[np.ndarray], wave: np.ndarray, is_last: bool,
               overlap: int) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """One chunk's emitted piece and the tail kept for the next: the previous
    tail crossfades into the chunk's head, and every chunk but the last keeps
    its last ``overlap`` samples back."""
    body = wave if is_last else wave[:-overlap]
    piece = body if prev_tail is None else cosine_crossfade(prev_tail, body, overlap)
    return piece, (prev_tail if is_last else wave[-overlap:])


def _context_window(chunk: torch.Tensor, prompt_cond: torch.Tensor, prompt_mel: torch.Tensor,
                    prompt_len: int, context: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The sampler's condition [prompt ‖ chunk] and prompt mel in one
    ``context``-frame window, in ``dtype``."""
    W = chunk.shape[1]
    cond = torch.zeros((1, context, chunk.shape[-1]), dtype=dtype, device=chunk.device)
    cond[:, : prompt_cond.shape[1]] = prompt_cond.to(dtype)
    cond[:, prompt_len: prompt_len + W] = chunk.to(dtype)
    pm = torch.zeros((1, context, prompt_mel.shape[-1]), dtype=dtype, device=chunk.device)
    pm[:, : prompt_mel.shape[1]] = prompt_mel.to(dtype)
    return cond, pm


def _chunks(sample_vocode: Callable, cond: torch.Tensor, prompt_cond: torch.Tensor,
            prompt_mel: torch.Tensor, p_len: int, target_len: int, plan: tuple, hop: int, *,
            seed: int, noise_fn: Optional[Callable], timer: StageTimer, sync: Callable,
            per_chunk: Optional[Callable] = None, **kwargs):
    """Both converters' chunk loop over ``cond`` after the prompt, by
    ``plan`` (prompt_cap, context, W): each chunk's noise (from ``seed`` or
    ``noise_fn``), then ``sample_vocode(..., **kwargs, **per_chunk(w))`` in
    stage ``sample+vocode``; once all are dispatched, each is fetched and
    joined. Yields (chunks so far, samples emitted so far, piece)."""
    cap, context, W = plan
    dev = cond.device
    prompt_cond = F.pad(prompt_cond, (0, 0, 0, cap - p_len))
    prompt_mel = F.pad(prompt_mel, (0, 0, 0, cap - p_len))
    L = (-(-target_len // W) + 1) * W
    cond = F.pad(cond, (0, 0, 0, L - target_len))
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise_shape = (1, context, prompt_mel.shape[-1])
    dispatched = []
    processed = 0
    while processed < target_len:
        w = min(W, target_len - processed)
        is_last = processed + W >= target_len
        noise = (noise_fn(noise_shape).to(dev) if noise_fn is not None
                 else torch.randn(noise_shape, generator=gen, device=dev))
        extra = {} if per_chunk is None else per_chunk(w)
        with timer("sample+vocode"):
            dispatched.append((w, is_last, sync(sample_vocode(
                noise, cond[:, processed: processed + W], prompt_cond,
                torch.tensor([p_len + w], device=dev), prompt_mel, p_len, context,
                timer=timer, **kwargs, **extra))))
        processed += w if is_last else (w - OVERLAP_FRAMES)

    prev_tail: Optional[np.ndarray] = None
    emitted = 0
    for n, (w, is_last, dev_wave) in enumerate(dispatched, 1):
        with timer("fetch"):
            wave = dev_wave[0].float().cpu().numpy()[: w * hop]
        piece, prev_tail = join_chunk(prev_tail, wave, is_last, OVERLAP_FRAMES * hop)
        emitted += len(piece)
        yield n, emitted, piece


def _drain(chunks, sr: int, stats: dict) -> tuple[int, np.ndarray, dict]:
    """(sr, the pieces joined, the last stats) of ``(sr, piece, stats)``s."""
    pieces = []
    for sr, piece, stats in chunks:
        pieces.append(piece)
    return sr, (np.concatenate(pieces) if pieces else np.zeros(0, np.float32)), stats


def campplus_style(campplus: CAMPPlus, wave_16k: np.ndarray, device) -> torch.Tensor:
    """CAMPPlus style from a kaldi fbank of the wave padded to a 1 s bucket,
    mean-subtracted and pooled over the true frame count."""
    n = len(wave_16k)
    bucket = -(-max(n, 1600) // 16000) * 16000
    padded = np.zeros(bucket, np.float32)
    padded[:n] = wave_16k
    frame_lens = torch.tensor([max((n - 400) // 160 + 1, 1)], device=device)
    fb = kaldi_fbank(torch.from_numpy(padded[None]).to(device))
    fmask = (torch.arange(fb.shape[1], device=device)[None, :]
             < frame_lens[:, None]).to(fb.dtype)[..., None]
    mean = (fb * fmask).sum(dim=1, keepdim=True) / torch.clamp(
        frame_lens[:, None, None].to(fb.dtype), min=1.0)
    return campplus((fb - mean) * fmask, frame_lens)


class VoiceConverter:
    """Frozen encoders + generative core + vocoder on one device.

    ``device`` defaults to ``cuda`` and raises when there is none; pass
    ``device="cpu"`` to run the plain PyTorch twins of the kernels.
    ``compute_dtype`` defaults to bfloat16 on cuda (the DiT/CFM path and the
    content encoder; regulator, CAMPPlus, the vocoder, RMVPE and the DSP stay
    f32) and f32 on cpu. The preset's ``speech_tokenizer.type`` picks the
    content encoder: Whisper (``whisper_cfg``), or for ``xlsr`` / ``cnhubert``
    an SSL encoder (``whisper_cfg`` if it is an ``SSLConfig``, else XLS-R
    300M at layer 12); its ``vocoder.type`` picks BigVGAN or HiFT
    (``vocoder_cfg`` overrides either's geometry). On cuda the constructor
    turns TF32 off for both cuDNN and matmuls (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``), because the vocoder is
    specified at full f32 precision. Parameters are random (from ``seed``)
    unless flax trees are given through the ``*_params`` arguments.

    ``cfg_shard_axis``: inside a ``parallel.mesh.set_mesh`` block, split the
    sampler's CFG stack over that mesh axis (each rank runs the DiT on its
    rows; with two ranks, the conditional and the null branch); every rank
    runs the encoders and the vocoder whole and returns the whole wave.
    ``seq_shard_axis``: split the sampler's time axis over that mesh axis
    (each rank runs the DiT on its time rows; composes with
    ``cfg_shard_axis`` on the other axis); the encoders, the regulator and
    the vocoder run whole on every rank, which returns the whole wave.

    On cuda the sampler replays each Euler step from a CUDA graph
    (:class:`~seedvc_tpu_torch.models.cfm.EulerGraph`, one capture per
    sampler shape), with neither shard axis set (a sharded step holds
    collectives) and outside another capture; elsewhere it runs the same
    steps eagerly.
    """

    def __init__(self, cfg: Optional[SeedVCConfig] = None, *,
                 whisper_cfg: WhisperEncoderConfig = WHISPER_SMALL,
                 vc_params=None, whisper_params=None, campplus_params=None,
                 vocoder_params=None, rmvpe_params=None,
                 prompt_cap_frames: int = 768, context_frames: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 cfg_shard_axis: Optional[str] = None, seq_shard_axis: Optional[str] = None,
                 vocoder_cfg=None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VoiceConverter: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self._use_graph = self.device.type == "cuda"  # tests set it for an A/B
        self.cfg = cfg or get_preset("whisper_small_wavenet")
        mp = self.cfg.model_params
        self.cfg_shard_axis = cfg_shard_axis
        self.seq_shard_axis = seq_shard_axis
        self.tokenizer_type = mp.speech_tokenizer.type
        self.vocoder_type = mp.vocoder.type
        if self.tokenizer_type not in ("whisper", "xlsr", "cnhubert"):
            raise NotImplementedError(f"{self.tokenizer_type} tokenizer is not ported")
        if self.vocoder_type not in ("bigvgan", "hifigan"):
            raise NotImplementedError(f"{self.vocoder_type} vocoder is not ported")
        self.ssl = self.tokenizer_type in ("xlsr", "cnhubert")
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.compute_dtype = compute_dtype

        sp = self.cfg.preprocess_params.spect_params
        self.sr = self.cfg.preprocess_params.sr
        self.hop = sp.hop_length
        self.n_mels = sp.n_mels
        self.mel_fn = MelFrontend(self.sr, sp)
        self.prompt_cap = prompt_cap_frames
        if context_frames is None:
            context_frames = max(int(self.sr // self.hop * 30) // 512, 1) * 512
        self.context = context_frames
        self.source_window = self.context - self.prompt_cap

        self.f0_condition = mp.DiT.f0_condition
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            if self.ssl:
                self.whisper = SSLEncoder(whisper_cfg if hasattr(whisper_cfg, "conv_kernels")
                                          else XLSR_300M_L12)
            else:
                self.whisper = WhisperEncoder(whisper_cfg)
            self.campplus = CAMPPlus(feat_dim=80, embedding_size=mp.style_encoder.dim)
            self.vc = VCModel(mp)
            if self.vocoder_type == "hifigan":
                self.vocoder = HiFTGenerator(vocoder_cfg or HiFTConfig(sampling_rate=self.sr))
            else:
                self.vocoder = BigVGAN(vocoder_cfg or (
                    BIGVGAN_44K_128 if self.n_mels == 128 else BIGVGAN_22K_80))
            rmvpe_model = RMVPE_E2E() if self.f0_condition else None
        for module, tree in ((self.whisper, whisper_params), (self.campplus, campplus_params),
                             (self.vc, vc_params), (self.vocoder, vocoder_params),
                             (rmvpe_model, rmvpe_params)):
            if module is None:
                continue
            if tree is not None:
                load_jax_params(module, tree)
            module.requires_grad_(False).eval().to(self.device)
        self.rmvpe = RMVPE(rmvpe_model) if self.f0_condition else None
        # the encoder and the CFM estimator run in compute_dtype; the
        # regulator (vc.length_regulator) stays f32
        self.whisper.to(compute_dtype)
        self.vc.cfm.to(compute_dtype)
        self.sampler = EulerGraph(self.vc.estimate, self.vc.precompute_cond)

    # ------------------------------------------------------------------
    def _whisper_fn(self, wave_16k: torch.Tensor) -> torch.Tensor:
        """Content features (f32) of a (1, T) 16 kHz window, the encoder in
        compute_dtype: an SSL encoder takes the wave cast to it (and
        normalises it there, as the JAX package's cast does); Whisper takes
        the log-mel of the wave zero-padded to 30 s."""
        if self.ssl:
            return self.whisper(wave_16k.to(self.compute_dtype)).float()
        wave_16k = F.pad(wave_16k, (0, 30 * 16000 - wave_16k.shape[1]))
        mel = whisper_log_mel(wave_16k).to(self.compute_dtype)
        return self.whisper(mel).float()

    def semantic_features(self, wave_16k: np.ndarray) -> torch.Tensor:
        """Content features at 50 Hz with 30 s chunking (5 s overlap). Each
        piece is zero-padded to a 1 s bucket (Whisper: the encoder pads to
        30 s) and cropped to ``len // 320 + 1`` frames, or for an SSL encoder
        to a 5 s bucket of at least 8000 samples and ``len // 320`` frames."""
        chunk = 30 * 16000
        overlap = 5 * 16000
        T = wave_16k.shape[-1]

        def encode(piece: np.ndarray) -> torch.Tensor:
            n = min(len(piece), chunk)
            if self.ssl:
                T_b = -(-max(n, 8000) // (5 * 16000)) * (5 * 16000)
            else:
                T_b = min(-(-max(n, 1) // 16000) * 16000, chunk)
            padded = np.zeros(T_b, np.float32)
            padded[:n] = piece[:n]
            feats = self._whisper_fn(torch.from_numpy(padded[None]).to(self.device))
            return feats[:, : len(piece) // 320 + (0 if self.ssl else 1)]

        if T <= chunk:
            return encode(wave_16k)
        outs = []
        start = 0
        while start < T:
            feats = encode(wave_16k[start: start + chunk])
            outs.append(feats if start == 0 else feats[:, 50 * 5:])
            if start + chunk >= T:
                break
            start += chunk - overlap
        return torch.cat(outs, dim=1)

    def _mel_bucketed(self, wave: np.ndarray) -> torch.Tensor:
        """Mel with the wave padded to 5 s buckets; the bucket tail is
        reflect-continued (n_fft samples) before the zero fill, so frames near
        the true end read what a reflect-padded exact-length STFT reads."""
        bucket = 5 * self.sr
        n_frames = len(wave) // self.hop
        padded_len = -(-len(wave) // bucket) * bucket
        padded = np.zeros(padded_len, np.float32)
        padded[: len(wave)] = wave
        n_fft = self.cfg.preprocess_params.spect_params.n_fft
        r = min(padded_len - len(wave), n_fft, len(wave) - 1)
        if r > 0:
            padded[len(wave): len(wave) + r] = wave[-2: -2 - r: -1]
        mel = self.mel_fn(torch.from_numpy(padded[None]).to(self.device))
        return mel[:, :n_frames]

    def _regulate_bucketed(self, s: torch.Tensor, true_len: int,
                           f0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Length-regulate in a 256-frame output bucket, with the content
        padded to 64 tokens and the F0 to 256 frames, each cropped back by
        its true length (``x_lens`` / ``f0_lens``)."""
        bucket_len = -(-true_len // 256) * 256
        s_T = s.shape[1]
        s = F.pad(s, (0, 0, 0, -(-max(s_T, 1) // 64) * 64 - s_T))
        f0_lens = None
        if f0 is not None:
            f_T = f0.shape[1]
            f0 = F.pad(f0, (0, -(-max(f_T, 1) // 256) * 256 - f_T))
            f0_lens = torch.tensor(f_T, device=self.device)
        out = self.vc.regulate(s, torch.tensor([true_len], device=self.device), bucket_len,
                               f0, x_lens=torch.tensor(s_T, device=self.device),
                               f0_lens=f0_lens)
        return out[:, :true_len]

    def plan_chunks(self, target_len: int, p_len: int) -> tuple[int, int, int]:
        return plan_chunks(target_len, p_len, self.context, self.prompt_cap)

    def compute_style(self, wave_16k: np.ndarray) -> torch.Tensor:
        return campplus_style(self.campplus, wave_16k, self.device)

    def warm(self, specs, *, diffusion_steps: int = 25, cfg_rate: float = 0.7,
             verbose: bool = True) -> list:
        """One silent conversion per distinct ``plan_chunks`` plan of the
        ``(source_seconds, ref_seconds)`` pairs in ``specs``; returns the
        plans warmed, without repeats. Eager PyTorch compiles no program per
        shape, but the first conversion on the card pays for what later ones
        reuse: the build of the kernels (``ops/build.py`` runs ``nvcc`` at
        first use), the cuDNN and cuBLAS handles and the plans they pick per
        shape, the allocator's pool, the device tables (RoPE, filters) the
        modules cache, and the sampler's CUDA graph of each context (at this
        ``cfg_rate``; any step count replays it). A server warms at start-up
        so that its first request does not pay for them."""
        warmed, seen = [], set()
        for src_s, ref_s in specs:
            target_len = max(int(src_s * self.sr) // self.hop, 1)
            p_len = min(max(int(ref_s * self.sr) // self.hop, 1), self.prompt_cap)
            plan = self.plan_chunks(target_len, p_len)
            if plan in seen:
                continue
            seen.add(plan)
            t0 = time.time()
            src = np.zeros(target_len * self.hop, np.float32)
            ref = np.zeros(p_len * self.hop, np.float32)
            self.convert(src, self.sr, ref, self.sr, diffusion_steps=diffusion_steps,
                         cfg_rate=cfg_rate)
            warmed.append(plan)
            if verbose:
                print(f"warmed (prompt_cap, context, W) = {plan} in {time.time() - t0:.1f} s")
        return warmed

    def extract_f0(self, src_16k: np.ndarray, ref_16k: np.ndarray, *,
                   auto_f0_adjust: bool = True, pitch_shift: float = 0.0,
                   timer: Optional[StageTimer] = None, keep: Optional[dict] = None):
        """RMVPE F0 of reference and source; with ``auto_f0_adjust`` the
        source's voiced log-F0 is moved so its median meets the reference's,
        then voiced frames are shifted by ``pitch_shift`` semitones. Returns
        (shifted source F0, reference F0), f32 numpy. ``timer`` records
        RMVPE's stages (:class:`~seedvc_tpu_torch.models.rmvpe.RMVPE`);
        ``keep`` gets each side's salience (n_frames, 360) under
        ``salience``."""
        sal = []
        f0_ori = self.rmvpe.infer_from_audio_batch(ref_16k[None], timer=timer, keep=sal)[0]
        f0_alt = self.rmvpe.infer_from_audio_batch(src_16k[None], timer=timer, keep=sal)[0]
        if keep is not None:
            keep["salience"] = {"reference": sal[0][0], "source": sal[1][0]}
        voiced_alt = f0_alt > 1
        voiced_ori = f0_ori > 1
        shifted = f0_alt.copy()

        def median_low(x):
            # the lower of the two middle values for an even count (torch.median's
            # convention, the JAX package's choice); np.median averages them
            return np.sort(x)[(len(x) - 1) // 2]

        if auto_f0_adjust and voiced_alt.any() and voiced_ori.any():
            log_alt = np.log(f0_alt + 1e-5)
            med_ori = median_low(np.log(f0_ori[voiced_ori] + 1e-5))
            med_alt = median_low(np.log(f0_alt[voiced_alt] + 1e-5))
            shifted_log = log_alt.copy()
            shifted_log[voiced_alt] = log_alt[voiced_alt] - med_alt + med_ori
            shifted = np.exp(shifted_log)
            shifted[~voiced_alt] = f0_alt[~voiced_alt]
        if pitch_shift != 0:
            shifted = shifted.copy()
            shifted[voiced_alt] = shifted[voiced_alt] * 2 ** (pitch_shift / 12)
        return shifted.astype(np.float32), f0_ori.astype(np.float32)

    def _graphed(self) -> bool:
        """Whether the sampler replays its steps from CUDA graphs: on cuda
        with no shard axis and no capture underway."""
        return (self._use_graph and self.cfg_shard_axis is None and self.seq_shard_axis is None
                and not torch.cuda.is_current_stream_capturing())

    def vocode(self, mel: torch.Tensor, draws=None) -> torch.Tensor:
        """f32 mel (B, T, n_mels) -> wave (B, T * hop); ``draws``: HiFT's
        random draws (see ``models/hifigan.py``), None for BigVGAN."""
        if self.vocoder_type == "hifigan":
            return self.vocoder(mel, draws)
        return self.vocoder(mel)

    def _sample_vocode(self, noise, chunk, prompt_cond, total_len, prompt_mel,
                       prompt_len: int, context: int, *, style, n_steps: int,
                       cfg_rate: float, draws=None, timer: StageTimer) -> torch.Tensor:
        """CFM sampling over [prompt ‖ chunk] in one context window, the
        generated region sliced out and vocoded; returns the f16 wave. The
        two halves are ``timer``'s stages ``sample`` (counting its Euler
        ``steps``, and as ``graphed_steps`` those replayed from a CUDA
        graph) and ``vocode``, with no synchronise between them."""
        cd = self.compute_dtype
        W = chunk.shape[1]
        with timer("sample"):
            cond_cat, pm = _context_window(chunk, prompt_cond, prompt_mel, prompt_len, context,
                                           cd)
            args = (noise.to(cd), cond_cat, total_len, pm, prompt_len, style.to(cd))
            graphed = self._graphed()
            if graphed:
                mel_out = self.sampler(*args, n_timesteps=n_steps, cfg_rate=cfg_rate)
            else:
                mel_out = euler_solve(self.vc.estimate, *args, n_timesteps=n_steps,
                                      cfg_rate=cfg_rate, precompute_fn=self.vc.precompute_cond,
                                      shard_axis=self.cfg_shard_axis,
                                      seq_shard_axis=self.seq_shard_axis)
            timer.count("steps", n_steps)
            timer.count("graphed_steps", n_steps if graphed else 0)
        with timer("vocode"):
            gen = mel_out[:, prompt_len: prompt_len + W].float()
            return self.vocode(gen, draws).half()

    # ------------------------------------------------------------------
    def convert(self, source, source_sr, reference, reference_sr,
                **kwargs) -> tuple[int, np.ndarray, dict]:
        """Full conversion; drains :meth:`convert_with_streaming`.
        Returns (sr, waveform, stats)."""
        return _drain(self.convert_with_streaming(source, source_sr, reference, reference_sr,
                                                  **kwargs),
                      self.sr, {"rtf": 0.0, "audio_seconds": 0.0, "wall_seconds": 0.0,
                                "chunks": 0, "stages": {}})

    def convert_with_streaming(self, source: np.ndarray, source_sr: int,
                               reference: np.ndarray, reference_sr: int, *,
                               diffusion_steps: int = 25, length_adjust: float = 1.0,
                               cfg_rate: float = 0.7, auto_f0_adjust: bool = True,
                               pitch_shift: float = 0.0, seed: int = 0, profile: bool = False,
                               noise_fn: Optional[Callable] = None,
                               draws_fn: Optional[Callable] = None,
                               keep_intermediates: bool = False):
        """Generator yielding ``(sr, wave_chunk, stats)`` per crossfaded chunk.
        ``auto_f0_adjust`` and ``pitch_shift`` act with F0 conditioning only
        (see :meth:`extract_f0`).

        Each chunk's initial noise comes from a ``torch.Generator`` seeded
        with ``seed``, or from ``noise_fn(shape)`` when given. HiFT's draws
        are made once a call and are the same for every chunk: its
        ``default_draws``, or ``draws_fn((B, n_samples, H))`` -> (phase
        (B, 1, H), noise) when given. With
        ``profile=True`` every stage ends in a device synchronise, so
        ``stats['stages']`` attributes device time to stages, and the
        request's stages are recorded as spans: each stage's entry then has
        its ``device_seconds`` (None without a card). ``sample+vocode``
        holds the stages ``sample`` (with its Euler ``steps``) and
        ``vocode``, not synchronised apart; with F0 conditioning ``f0``
        holds RMVPE's ``f0.salience`` (and in it ``f0.gru``) and
        ``f0.decode``, with their counters (see
        :class:`~seedvc_tpu_torch.models.rmvpe.RMVPE`).

        ``keep_intermediates``: ``stats["kept"]`` holds what the conversion
        computed on its way, adding no synchronise and leaving the wave as
        it is: ``features`` (the content encoder's, ``source`` and
        ``reference``, device f32), ``cond`` and ``prompt_cond`` (the
        regulator's, device f32), and with F0 conditioning ``salience``
        (RMVPE's, host f32 (n_frames, 360)), ``f0`` (Hz after
        ``auto_f0_adjust`` and ``pitch_shift``, host f32) and ``coarse``
        (the regulator's F0 bins, device int64), each by side; else those
        three are None."""
        timer = StageTimer(record=profile, device=self.device)
        kept = ({"salience": None, "f0": None, "coarse": None} if keep_intermediates
                else None)

        def sync(x):
            return probe_ready(x) if profile else x

        t_start = time.time()
        with timer("resample"):
            src = resample_host(source, source_sr, self.sr)
            ref = resample_host(reference, reference_sr, self.sr)
            src_16k = resample_host(source, source_sr, 16000)
            ref_16k = resample_host(reference, reference_sr, 16000)

        # cap the reference prompt at prompt_cap mel frames
        ref = ref[: self.prompt_cap * self.hop]
        ref_16k = ref_16k[: int(len(ref) / self.sr * 16000)]

        with timer("semantic"):
            s_alt = sync(self.semantic_features(src_16k))
            s_ori = sync(self.semantic_features(ref_16k))
        with timer("mel+style"):
            mel2 = self._mel_bucketed(ref)
            style = sync(self.compute_style(ref_16k))
        p_len = mel2.shape[1]
        target_len = int(len(src) // self.hop * length_adjust)
        f0_alt = f0_ori = None
        if self.f0_condition:
            with timer("f0"):
                shifted_f0, f0_ori_np = self.extract_f0(
                    src_16k, ref_16k, auto_f0_adjust=auto_f0_adjust, pitch_shift=pitch_shift,
                    timer=timer, keep=kept)
                f0_alt = torch.from_numpy(shifted_f0[None]).to(self.device)
                f0_ori = torch.from_numpy(f0_ori_np[None]).to(self.device)
        with timer("regulate"):
            cond = sync(self._regulate_bucketed(s_alt, target_len, f0_alt))
            prompt_cond = sync(self._regulate_bucketed(s_ori, p_len, f0_ori))
        extra = {}
        if kept is not None:
            kept.update(features={"source": s_alt, "reference": s_ori}, cond=cond,
                        prompt_cond=prompt_cond)
            if self.f0_condition:
                n_bins = self.cfg.model_params.length_regulator.n_f0_bins
                kept["f0"] = {"source": shifted_f0, "reference": f0_ori_np}
                kept["coarse"] = {side: torch.clamp(f0_to_coarse(f0[0], n_bins), 0, n_bins - 1)
                                  for side, f0 in (("source", f0_alt), ("reference", f0_ori))}
            extra = {"kept": kept}

        plan = self.plan_chunks(target_len, p_len)
        draws = None
        if self.vocoder_type == "hifigan":
            shape = (1, plan[2] * self.hop, self.vocoder.cfg.nb_harmonics + 1)
            draws = tuple(d.to(self.device) for d in (
                draws_fn(shape) if draws_fn is not None
                else self.vocoder.default_draws(1, shape[1], self.device)))
        for n, emitted, piece in _chunks(
                self._sample_vocode, cond, prompt_cond, mel2, p_len, target_len, plan,
                self.hop, seed=seed, noise_fn=noise_fn, timer=timer, sync=sync, style=style,
                n_steps=diffusion_steps, cfg_rate=cfg_rate, draws=draws):
            dt = time.time() - t_start
            yield self.sr, piece, {
                "rtf": dt / max(emitted / self.sr, 1e-9),
                "audio_seconds": emitted / self.sr,
                "wall_seconds": dt,
                "chunks": n,
                "stages": timer.report(),
                **extra,
            }
