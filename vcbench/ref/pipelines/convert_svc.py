"""Offline singing-voice conversion (the SVC presets): the v1 reference
converter (``convert.py``) plus F0.

1. RMVPE's F0 of the reference (cut to the prompt cap, as its content is)
   and of the source (``models/rmvpe.py``), 100 frames a second;
2. with ``auto_f0_adjust`` the source's voiced log-F0 moved so that its
   median meets the reference's (the lower of the two middle values for an
   even count, ``torch.median``'s convention), then the voiced frames
   shifted by ``pitch_shift`` semitones;
3. the regulator adds the F0's coarse-bin embedding to the content, the F0
   padded to a 256-frame bucket and read up to its true length;
4. the rest as v1's: chunked CFM over [prompt ‖ chunk], BigVGAN, 16-frame
   crossfades.

A conversion can take given content features and F0 (``features=``,
``f0=``): the check runs the reference on the program's own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vcbench.ref.core.config import SeedVCConfig
from vcbench.ref.dsp.resample import resample_host
from vcbench.ref.models.rmvpe import RMVPE, RMVPE_E2E, decode_f0
from vcbench.ref.pipelines.convert import OVERLAP_FRAMES, VoiceConverter, join_chunk


def median_low(x: np.ndarray) -> float:
    """The lower of the two middle values for an even count."""
    return np.sort(x)[(len(x) - 1) // 2]


def shift_f0(f0_alt: np.ndarray, f0_ori: np.ndarray, auto_f0_adjust: bool,
             pitch_shift: float) -> np.ndarray:
    """The source's F0 after ``auto_f0_adjust`` and ``pitch_shift`` (voiced:
    above 1 Hz), f32."""
    voiced_alt, voiced_ori = f0_alt > 1, f0_ori > 1
    shifted = f0_alt.copy()
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
    return shifted.astype(np.float32)


class SVCConverter(VoiceConverter):
    """The v1 reference converter for an F0-conditioned preset, with an
    RMVPE of the geometry ``rmvpe`` (``RMVPE_E2E``'s keyword arguments; the
    released checkpoint's by default). Every part f32 by default; the
    parameters are filled by the caller."""

    def __init__(self, cfg: SeedVCConfig, *, rmvpe: Optional[dict] = None, **kw):
        mp = cfg.model_params
        if not mp.length_regulator.f0_condition:
            raise ValueError("SVCConverter needs an F0-conditioned preset")
        # the DiT's flag only gates the regulator's embedding (built from
        # length_regulator's), so the v1 constructor builds the same modules
        plain = dataclasses.replace(cfg, model_params=dataclasses.replace(
            mp, DiT=dataclasses.replace(mp.DiT, f0_condition=False)))
        super().__init__(plain, **kw)
        self.cfg = cfg
        model = RMVPE_E2E(**(rmvpe or {}))
        self.rmvpe = RMVPE(model.requires_grad_(False).eval().to(self.device))

    def salience(self, wave_16k: np.ndarray) -> np.ndarray:
        """RMVPE's salience (n_frames, 360) of one 16 kHz wave, f32 host."""
        return self.rmvpe.salience(wave_16k[None])[0].float().cpu().numpy()

    def regulate_f0(self, s: torch.Tensor, true_len: int, f0: np.ndarray) -> torch.Tensor:
        """Length-regulate content ``s`` (1, T, C) with F0 ``f0`` (Hz) in a
        256-frame output bucket: the content padded to 64 tokens and the F0
        to 256 frames, each read up to its true length."""
        dev = self.device
        bucket_len = -(-true_len // 256) * 256
        s_T, f_T = s.shape[1], len(f0)
        s = F.pad(s, (0, 0, 0, -(-max(s_T, 1) // 64) * 64 - s_T))
        f0_t = F.pad(torch.from_numpy(np.asarray(f0, np.float32)[None]).to(dev),
                     (0, -(-max(f_T, 1) // 256) * 256 - f_T))
        out = self.vc.regulate(s, torch.tensor([true_len], device=dev), bucket_len, f0_t,
                               x_lens=torch.tensor(s_T, device=dev),
                               f0_lens=torch.tensor(f_T, device=dev))
        return out[:, :true_len]

    def prepared(self, source, source_sr, reference, reference_sr):
        """(source at the model rate, the prompt cut to its cap, both at
        16 kHz) as the converter derives them."""
        src = resample_host(source, source_sr, self.sr)
        ref = resample_host(reference, reference_sr, self.sr)
        src_16k = resample_host(source, source_sr, 16000)
        ref_16k = resample_host(reference, reference_sr, 16000)
        ref = ref[: self.prompt_cap * self.hop]
        return src, ref, src_16k, ref_16k[: int(len(ref) / self.sr * 16000)]

    def convert_with_streaming(self, source: np.ndarray, source_sr: int,
                               reference: np.ndarray, reference_sr: int, *,
                               diffusion_steps: int = 25, length_adjust: float = 1.0,
                               cfg_rate: float = 0.7, auto_f0_adjust: bool = True,
                               pitch_shift: float = 0.0, seed: int = 0,
                               noise_fn: Optional[Callable] = None,
                               features: Optional[tuple] = None, f0: Optional[tuple] = None,
                               info: Optional[dict] = None):
        """Generator yielding ``(sr, wave_chunk)`` per crossfaded chunk.
        ``features``: (source, reference) content features (1, T, C) to use
        in place of the content encoder's; ``f0``: (the source's shifted F0,
        the reference's F0) in Hz, in place of RMVPE's; ``info``: a dict
        that gets ``cond`` and ``prompt_cond``."""
        src, ref, src_16k, ref_16k = self.prepared(source, source_sr, reference, reference_sr)
        if features is None:
            features = (self.semantic_features(src_16k), self.semantic_features(ref_16k))
        s_alt, s_ori = (f.to(self.device).float() for f in features)
        if f0 is None:
            f0_ori = decode_f0(self.salience(ref_16k))
            f0_alt = shift_f0(decode_f0(self.salience(src_16k)), f0_ori, auto_f0_adjust,
                              pitch_shift)
        else:
            f0_alt, f0_ori = f0
        mel2 = self._mel_bucketed(ref)
        style = self.compute_style(ref_16k)
        p_len = mel2.shape[1]
        target_len = int(len(src) // self.hop * length_adjust)
        cond = self.regulate_f0(s_alt, target_len, f0_alt)
        prompt_cond = self.regulate_f0(s_ori, p_len, f0_ori)
        if info is not None:
            info.update(cond=cond, prompt_cond=prompt_cond)

        cap_b, context, W = self.plan_chunks(target_len, p_len)
        prompt_cond_pad = F.pad(prompt_cond, (0, 0, 0, cap_b - p_len))
        prompt_mel_cap = F.pad(mel2, (0, 0, 0, cap_b - p_len))
        L = (-(-target_len // W) + 1) * W
        cond_buf = F.pad(cond, (0, 0, 0, L - target_len))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        noise_shape = (1, context, self.n_mels)
        prev_tail: Optional[np.ndarray] = None
        processed = 0
        while processed < target_len:
            w = min(W, target_len - processed)
            is_last = processed + W >= target_len
            noise = (noise_fn(noise_shape).to(self.device) if noise_fn is not None
                     else torch.randn(noise_shape, generator=gen, device=self.device))
            dev_wave = self._sample_vocode(
                noise, cond_buf[:, processed: processed + W], prompt_cond_pad,
                torch.tensor([p_len + w], device=self.device), prompt_mel_cap, p_len,
                style, diffusion_steps, cfg_rate, context)
            processed += w if is_last else (w - OVERLAP_FRAMES)
            wave = dev_wave[0].float().cpu().numpy()[: w * self.hop]
            piece, prev_tail = join_chunk(prev_tail, wave, is_last, OVERLAP_FRAMES * self.hop)
            yield self.sr, piece
