"""Offline voice-conversion pipeline (v1), port of ``seedvc_tpu/pipelines/convert.py``.

1. resample source/reference to the model rate and to 16 kHz (host, scipy),
2. semantic features in 30 s windows (5 s overlap, 250 overlapped frames
   dropped on concat): Whisper on the window zero-padded to 30 s, or an SSL
   encoder (XLS-R, the real-time preset) on the window zero-padded to a 5 s
   bucket,
3. mel of the reference, CAMPPlus style from a kaldi fbank,
4. length-regulate source and reference content,
5. chunked CFM generation: per chunk, condition = [reference prompt ‖ source
   chunk] in one fixed context window chosen by :func:`plan_chunks`,
6. vocoding per chunk (BigVGAN, or HiFT for the real-time preset),
   16-frame cosine^2 crossfade joins.

The lengths are bucketed as in the JAX package (5 s mel buckets with a
reflect-continued tail, 1 s style buckets, 256-frame regulate buckets), so
the two give the same numbers on the same weights and noise. F0
conditioning (the SVC presets) is not part of this copy: no cell runs it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vcbench.ref.core.config import SeedVCConfig, get_preset
from vcbench.ref.dsp.fbank import kaldi_fbank
from vcbench.ref.dsp.mel import MelFrontend
from vcbench.ref.dsp.resample import resample_host
from vcbench.ref.dsp.whisper_mel import whisper_log_mel
from vcbench.ref.models.bigvgan import BIGVGAN_22K_80, BIGVGAN_44K_128, BigVGAN
from vcbench.ref.models.campplus import CAMPPlus
from vcbench.ref.models.cfm import euler_solve
from vcbench.ref.models.hifigan import HiFTConfig, HiFTGenerator
from vcbench.ref.models.ssl import XLSR_300M_L12, SSLEncoder
from vcbench.ref.models.vc import VCModel
from vcbench.ref.models.whisper import WHISPER_SMALL, WhisperEncoder, WhisperEncoderConfig

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

    ``compute_dtype`` defaults to bfloat16 on cuda (the DiT/CFM path and the
    content encoder; regulator, CAMPPlus, the vocoder and the DSP stay f32)
    and f32 on cpu; the benchmark passes f32. The preset's
    ``speech_tokenizer.type`` picks the content encoder: Whisper
    (``whisper_cfg``), or for ``xlsr`` / ``cnhubert`` an SSL encoder
    (``whisper_cfg`` if it is an ``SSLConfig``, else XLS-R 300M at layer
    12); its ``vocoder.type`` picks BigVGAN or HiFT (``vocoder_cfg``
    overrides either's geometry). On cuda the constructor turns TF32 off for
    both cuDNN and matmuls. The parameters are filled by the caller.
    """

    def __init__(self, cfg: Optional[SeedVCConfig] = None, *,
                 whisper_cfg: WhisperEncoderConfig = WHISPER_SMALL,
                 prompt_cap_frames: int = 768, context_frames: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 vocoder_cfg=None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.cfg = cfg or get_preset("whisper_small_wavenet")
        mp = self.cfg.model_params
        self.tokenizer_type = mp.speech_tokenizer.type
        self.vocoder_type = mp.vocoder.type
        if self.tokenizer_type not in ("whisper", "xlsr", "cnhubert"):
            raise NotImplementedError(f"{self.tokenizer_type} tokenizer is not ported")
        if self.vocoder_type not in ("bigvgan", "hifigan"):
            raise NotImplementedError(f"{self.vocoder_type} vocoder is not ported")
        if mp.DiT.f0_condition:
            raise NotImplementedError("F0 conditioning is not part of the frozen reference")
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
        for module in (self.whisper, self.campplus, self.vc, self.vocoder):
            module.requires_grad_(False).eval().to(self.device)
        # the encoder and the CFM estimator run in compute_dtype; the
        # regulator (vc.length_regulator) stays f32
        self.whisper.to(compute_dtype)
        self.vc.cfm.to(compute_dtype)

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

    def _regulate_bucketed(self, s: torch.Tensor, true_len: int) -> torch.Tensor:
        """Length-regulate in a 256-frame output bucket, with the content
        padded to 64 tokens and cropped back by its true length
        (``x_lens``)."""
        bucket_len = -(-true_len // 256) * 256
        s_T = s.shape[1]
        s = F.pad(s, (0, 0, 0, -(-max(s_T, 1) // 64) * 64 - s_T))
        out = self.vc.regulate(s, torch.tensor([true_len], device=self.device), bucket_len,
                               None, x_lens=torch.tensor(s_T, device=self.device))
        return out[:, :true_len]

    def plan_chunks(self, target_len: int, p_len: int) -> tuple[int, int, int]:
        return plan_chunks(target_len, p_len, self.context, self.prompt_cap)

    def compute_style(self, wave_16k: np.ndarray) -> torch.Tensor:
        return campplus_style(self.campplus, wave_16k, self.device)

    def vocode(self, mel: torch.Tensor, draws=None) -> torch.Tensor:
        """f32 mel (B, T, n_mels) -> wave (B, T * hop); ``draws``: HiFT's
        random draws (see ``models/hifigan.py``), None for BigVGAN."""
        if self.vocoder_type == "hifigan":
            return self.vocoder(mel, draws)
        return self.vocoder(mel)

    def _sample_vocode(self, noise, chunk, prompt_cond, total_len, prompt_mel,
                       prompt_len: int, style, n_steps: int, cfg_rate: float,
                       context: int, draws=None) -> torch.Tensor:
        """CFM sampling over [prompt ‖ chunk] in one context window, the
        generated region sliced out and vocoded; returns the f16 wave."""
        cd = self.compute_dtype
        W = chunk.shape[1]
        cond_cat = torch.zeros((1, context, chunk.shape[-1]), dtype=cd, device=self.device)
        cond_cat[:, : prompt_cond.shape[1]] = prompt_cond.to(cd)
        cond_cat[:, prompt_len: prompt_len + W] = chunk.to(cd)
        pm = torch.zeros((1, context, self.n_mels), dtype=cd, device=self.device)
        pm[:, : prompt_mel.shape[1]] = prompt_mel.to(cd)
        mel_out = euler_solve(self.vc.estimate, noise.to(cd), cond_cat, total_len, pm,
                              prompt_len, style.to(cd), n_timesteps=n_steps,
                              cfg_rate=cfg_rate, precompute_fn=self.vc.precompute_cond)
        gen = mel_out[:, prompt_len: prompt_len + W].float()
        return self.vocode(gen, draws).half()

    # ------------------------------------------------------------------
    def convert(self, source, source_sr, reference, reference_sr,
                **kwargs) -> tuple[int, np.ndarray, dict]:
        """Full conversion; drains :meth:`convert_with_streaming`.
        Returns (sr, waveform, {"chunks": n})."""
        chunks = [piece for _, piece in self.convert_with_streaming(
            source, source_sr, reference, reference_sr, **kwargs)]
        out = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        return self.sr, out, {"chunks": len(chunks)}

    def convert_with_streaming(self, source: np.ndarray, source_sr: int,
                               reference: np.ndarray, reference_sr: int, *,
                               diffusion_steps: int = 25, length_adjust: float = 1.0,
                               cfg_rate: float = 0.7, seed: int = 0,
                               noise_fn: Optional[Callable] = None,
                               draws_fn: Optional[Callable] = None):
        """Generator yielding ``(sr, wave_chunk)`` per crossfaded chunk.

        Each chunk's initial noise comes from a ``torch.Generator`` seeded
        with ``seed``, or from ``noise_fn(shape)`` when given. HiFT's draws
        are made once a call and are the same for every chunk: its
        ``default_draws``, or ``draws_fn((B, n_samples, H))`` -> (phase
        (B, 1, H), noise) when given."""
        src = resample_host(source, source_sr, self.sr)
        ref = resample_host(reference, reference_sr, self.sr)
        src_16k = resample_host(source, source_sr, 16000)
        ref_16k = resample_host(reference, reference_sr, 16000)

        # cap the reference prompt at prompt_cap mel frames
        ref = ref[: self.prompt_cap * self.hop]
        ref_16k = ref_16k[: int(len(ref) / self.sr * 16000)]

        s_alt = self.semantic_features(src_16k)
        s_ori = self.semantic_features(ref_16k)
        mel2 = self._mel_bucketed(ref)
        style = self.compute_style(ref_16k)
        p_len = mel2.shape[1]
        target_len = int(len(src) // self.hop * length_adjust)
        cond = self._regulate_bucketed(s_alt, target_len)
        prompt_cond = self._regulate_bucketed(s_ori, p_len)

        cap_b, context, W = self.plan_chunks(target_len, p_len)
        prompt_cond_pad = F.pad(prompt_cond, (0, 0, 0, cap_b - p_len))
        prompt_mel_cap = F.pad(mel2, (0, 0, 0, cap_b - p_len))
        L = (-(-target_len // W) + 1) * W
        cond_buf = F.pad(cond, (0, 0, 0, L - target_len))

        gen = torch.Generator(device=self.device).manual_seed(seed)
        noise_shape = (1, context, self.n_mels)
        draws = None
        if self.vocoder_type == "hifigan":
            shape = (1, W * self.hop, self.vocoder.cfg.nb_harmonics + 1)
            draws = tuple(d.to(self.device) for d in (
                draws_fn(shape) if draws_fn is not None
                else self.vocoder.default_draws(1, shape[1], self.device)))
        prev_tail: Optional[np.ndarray] = None
        overlap_wave = OVERLAP_FRAMES * self.hop
        processed = 0
        while processed < target_len:
            w = min(W, target_len - processed)
            is_last = processed + W >= target_len
            if noise_fn is not None:
                noise = noise_fn(noise_shape).to(self.device)
            else:
                noise = torch.randn(noise_shape, generator=gen, device=self.device)
            dev_wave = self._sample_vocode(
                noise, cond_buf[:, processed: processed + W], prompt_cond_pad,
                torch.tensor([p_len + w], device=self.device), prompt_mel_cap, p_len,
                style, diffusion_steps, cfg_rate, context, draws)
            processed += w if is_last else (w - OVERLAP_FRAMES)
            wave = dev_wave[0].float().cpu().numpy()[: w * self.hop]
            piece, prev_tail = join_chunk(prev_tail, wave, is_last, overlap_wave)
            yield self.sr, piece
