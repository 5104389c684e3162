"""v2 voice conversion, plain: HuBERT-large features, the ASTRAL
quantizers, the AR's rows and its full-forward logits, the multi-condition
CFG CFM and BigVGAN, every part in f32 on one device.

The steps and lengths are the port's (``seedvc_tpu_torch/pipelines/
convert_v2.py`` as of this copy): the 16 kHz wave zero-padded to a 5 s
bucket for HuBERT; the reference's duration-reduced narrow tokens as each
AR row's prefix and the source's in chunks behind it (prefix + chunk <=
1500 tokens); the output's mel length from the AR's token ratio; the CFM in
chunks of one context window (``plan_chunks`` with ``align_offset=2``)
joined by a 16-frame cosine² crossfade, each chunk's wave rounded to f16.

Departures from the published ``inference_v2.py``: the AR is batched over
the chunks of one request (the published decode runs one row); with
``cap_to_source`` a row stops at the 50 Hz length of its source span, since
random weights never draw EOS; the AR here is the full forward over each
row (``models/ar.py``), and the tokens may be given (the benchmark holds a
run's logits and wave against this module on the run's own tokens, since
BSQ codes and sampled tokens flip at near-ties); so may each CFM chunk's
sampler states, at which the sampler's estimates are then taken as well.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vcbench.ref.core.config import LengthRegulatorConfig, SpectConfig
from vcbench.ref.dsp.mel import MelFrontend
from vcbench.ref.dsp.resample import resample
from vcbench.ref.models.ar import ARConfig, ARTransformer, generate
from vcbench.ref.models.astral import AstralConfig, AstralQuantizer
from vcbench.ref.models.bigvgan import BIGVGAN_22K_80, BigVGAN
from vcbench.ref.models.campplus import CAMPPlus
from vcbench.ref.models.cfm_v2 import euler_solve_multicfg, forced_estimates, state_identity
from vcbench.ref.models.dit_v2 import DiTV2, DiTV2Config
from vcbench.ref.models.regulator import InterpolateRegulator
from vcbench.ref.models.ssl import SSLConfig, SSLEncoder
from vcbench.ref.nn.bsq import duration_reduction, run_lengths
from vcbench.ref.pipelines.convert import OVERLAP_FRAMES, campplus_style, join_chunk, plan_chunks

AR_MAX_CONTENT_LEN = 1500
AR_MAX_NEW_TOKENS = 2048


@dataclass
class V2Config:
    sr: int = 22050
    hop: int = 256
    n_mels: int = 80
    dit: DiTV2Config = field(default_factory=DiTV2Config)
    ar: ARConfig = field(default_factory=ARConfig)
    ssl: SSLConfig = field(default_factory=lambda: SSLConfig(n_layers=18))
    narrow: AstralConfig = field(default_factory=lambda: AstralConfig(codebook_size=32))
    wide: AstralConfig = field(default_factory=lambda: AstralConfig(codebook_size=2048))
    prompt_cap_frames: int = 768
    context_frames: int = 2558
    max_ref_sec: float = 25.0


@dataclass
class ARRows:
    """One request's AR rows: regulated conditions (B, C_max, D) with their
    lengths, the prompt's wide tokens (P,), and each row's cap (or None)."""
    cond_emb: torch.Tensor
    cond_lens: np.ndarray
    prompt: np.ndarray
    caps: Optional[np.ndarray]


class VoiceConverterV2:
    """The nine modules, named and ordered as the port's; parameters are
    filled by the caller. ``vocoder_cfg`` overrides BigVGAN's geometry (the
    tests' small vocoder). On cuda TF32 is off for cuDNN and matmuls."""

    MODULES = ("ssl", "narrow", "wide", "campplus", "cfm_reg", "ar_reg", "dit", "ar", "vocoder")

    def __init__(self, cfg: V2Config = V2Config(), *, vocoder_cfg=None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.sr, self.hop, self.n_mels = cfg.sr, cfg.hop, cfg.n_mels
        self.mel_fn = MelFrontend(cfg.sr, SpectConfig(n_mels=cfg.n_mels))
        with torch.random.fork_rng(devices=[]):
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
            module.requires_grad_(False).eval().to(self.device)
            setattr(self, name, module)

    # ------------------------------------------------------------------
    def resampled(self, source, source_sr: int, reference, reference_sr: int):
        """(src, ref, src16, ref16) host waves, the reference cut to its cap."""
        cfg, dev = self.cfg, self.device
        reference = reference[: int(cfg.max_ref_sec * reference_sr)]

        def rs(wave, sr_in, sr_out):
            w = torch.from_numpy(np.asarray(wave, np.float32)).to(dev)
            return resample(w, sr_in, sr_out).cpu().numpy()

        src, ref = rs(source, source_sr, cfg.sr), rs(reference, reference_sr, cfg.sr)
        src16, ref16 = rs(source, source_sr, 16000), rs(reference, reference_sr, 16000)
        ref = ref[: cfg.prompt_cap_frames * cfg.hop]
        ref16 = ref16[: int(len(ref) / cfg.sr * 16000)]
        return src, ref, src16, ref16

    @torch.no_grad()
    def content_features(self, wave_16k: np.ndarray) -> torch.Tensor:
        """HuBERT's features (1, T_bucket // 320, d_model) of the wave
        zero-padded to a 5 s bucket (>= 8000 samples)."""
        T = len(wave_16k)
        bucket = 5 * 16000
        padded = np.zeros(-(-max(T, 8000) // bucket) * bucket, np.float32)
        padded[:T] = wave_16k
        return self.ssl(torch.from_numpy(padded[None]).to(self.device))

    @torch.no_grad()
    def content_tokens(self, wave_16k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        feats = self.content_features(wave_16k)
        n = len(wave_16k) // 320
        return (self.narrow(feats)[1][:, :n].cpu().numpy(),
                self.wide(feats)[1][:, :n].cpu().numpy())

    @torch.no_grad()
    def projections(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The narrow and wide quantizers' normalised projections (the
        continuous numbers whose signs are the tokens) of HuBERT features."""
        return tuple(q.quantizer.project(q.encoder(feats.float()))
                     for q in (self.narrow, self.wide))

    @torch.no_grad()
    def regulate_tokens(self, reg, tokens: np.ndarray, mel_len: int) -> torch.Tensor:
        """Regulate in a 256-frame output bucket, the tokens padded to 64."""
        bucket = -(-mel_len // 256) * 256
        T = tokens.shape[1]
        tok = np.zeros((tokens.shape[0], -(-max(T, 1) // 64) * 64), np.int64)
        tok[:, :T] = tokens
        out = reg(torch.from_numpy(tok).to(self.device),
                  torch.tensor([mel_len], device=self.device), bucket,
                  x_lens=torch.tensor(T, device=self.device))[0]
        return out[:, :mel_len]

    @torch.no_grad()
    def ar_rows(self, src_n, tgt_n, tgt_w, anonymization_only: bool = False,
                cap_to_source: bool = False) -> ARRows:
        """The rows of one request's AR decode: the duration-reduced source
        narrow tokens in chunks behind the reference's (none when
        anonymising)."""
        tgt_red, _ = duration_reduction(tgt_n[0])
        src_red, _ = duration_reduction(src_n[0])
        src_dur = run_lengths(src_n[0])
        prefix = tgt_red[:0] if anonymization_only else tgt_red
        prompt = tgt_w[0, :0] if anonymization_only else tgt_w[0]
        max_chunk = max(AR_MAX_CONTENT_LEN - len(prefix), 1)
        starts = range(0, max(len(src_red), 1), max_chunk)
        chunks = [src_red[s: s + max_chunk] for s in starts]
        B = len(chunks)
        cond_lens = np.array([len(prefix) + len(c) for c in chunks], np.int64)
        C_max = int(-(-cond_lens.max() // 256) * 256)
        ar_src = np.zeros((B, C_max), np.int64)
        for b, c in enumerate(chunks):
            ar_src[b, : len(prefix)] = prefix
            ar_src[b, len(prefix): len(prefix) + len(c)] = c
        cond_emb = self.ar_reg(torch.from_numpy(ar_src).to(self.device),
                               torch.from_numpy(cond_lens).to(self.device), C_max,
                               x_lens=torch.tensor(int(cond_lens.max()), device=self.device))[0]
        caps = (np.array([int(src_dur[s: s + max_chunk].sum()) for s in starts], np.int64)
                if cap_to_source else None)
        return ARRows(cond_emb, cond_lens, np.asarray(prompt, np.int64), caps)

    @torch.no_grad()
    def ar_logits(self, rows: ARRows, generated: list[np.ndarray]) -> list[torch.Tensor]:
        """Each row's logits (N_b, vocab) of its N_b generated tokens, by the
        full forward teacher-forced on them."""
        prompt = torch.from_numpy(rows.prompt)
        return [self.ar.teacher_forced(rows.cond_emb[b, : int(rows.cond_lens[b])], prompt,
                                       torch.from_numpy(np.asarray(g, np.int64)))
                for b, g in enumerate(generated)]

    @torch.no_grad()
    def ar_generate(self, rows: ARRows, draws: torch.Tensor, **knobs) -> list[np.ndarray]:
        prompt = torch.from_numpy(rows.prompt)
        return [generate(self.ar, rows.cond_emb[b, : int(rows.cond_lens[b])], prompt, draws, b,
                         AR_MAX_NEW_TOKENS, None if rows.caps is None else int(rows.caps[b]),
                         **knobs)
                for b in range(len(rows.cond_lens))]

    def _window(self, chunk, prompt_cond, prompt_mel, prompt_len: int, context: int):
        """The condition and prompt mel of [prompt ‖ chunk] in one context
        window, and the DiT's estimator and its precomputation."""
        dev = self.device
        W = chunk.shape[1]
        cond = torch.zeros((1, context, chunk.shape[-1]), device=dev)
        cond[:, : prompt_cond.shape[1]] = prompt_cond
        cond[:, prompt_len: prompt_len + W] = chunk
        pm = torch.zeros((1, context, self.n_mels), device=dev)
        pm[:, : prompt_mel.shape[1]] = prompt_mel

        def estimate(x, px, lens, t, s, m, sc=None):
            return self.dit(x, px, lens, t, s, m, static_cond=sc)

        def precompute(x, px, lens, s, m):
            return self.dit(x, px, lens, torch.zeros(x.shape[0], device=x.device), s, m,
                            return_static=True)
        return cond, pm, estimate, precompute

    @torch.no_grad()
    def sample_vocode(self, noise, chunk, prompt_cond, total_len, prompt_mel, prompt_len: int,
                      style, n_steps: int, rates, random_voice: bool, context: int,
                      round_state: Callable = state_identity) -> torch.Tensor:
        """Multi-condition CFG sampling over [prompt ‖ chunk] in one context
        window, the generated region vocoded; the f16 wave."""
        cond, pm, estimate, precompute = self._window(chunk, prompt_cond, prompt_mel,
                                                      prompt_len, context)
        mel_out = euler_solve_multicfg(estimate, noise.float(), cond, total_len, pm, prompt_len,
                                       style.float(), n_timesteps=n_steps, cfg_rates=rates,
                                       random_voice=random_voice, precompute_fn=precompute,
                                       round_state=round_state)
        W = chunk.shape[1]
        return self.vocoder(mel_out[:, prompt_len: prompt_len + W].float()).half()

    @torch.no_grad()
    def chunk_estimates(self, states, chunk, prompt_cond, total_len, prompt_mel,
                        prompt_len: int, style, n_steps: int, rates, random_voice: bool,
                        context: int) -> list[torch.Tensor]:
        """The sampler's combined estimate at each of a chunk's given states,
        the first of its ``n_steps`` (``cfm_v2.forced_estimates``)."""
        cond, pm, estimate, precompute = self._window(chunk, prompt_cond, prompt_mel,
                                                      prompt_len, context)
        return forced_estimates(estimate, states, cond, total_len, pm, prompt_len,
                                style.float(), n_steps, cfg_rates=rates,
                                random_voice=random_voice, precompute_fn=precompute)

    @torch.no_grad()
    def convert_voice(self, source, source_sr, reference, reference_sr, *,
                      convert_style: bool = True, anonymization_only: bool = False,
                      diffusion_steps: int = 30, length_adjust: float = 1.0,
                      intelligibility_cfg_rate: float = 0.7, similarity_cfg_rate: float = 0.7,
                      top_p: float = 0.7, temperature: float = 0.7,
                      repetition_penalty: float = 1.5, noise_fn: Callable,
                      draws_fn: Optional[Callable] = None, cap_to_source: bool = False,
                      tokens: Optional[dict] = None, states: Optional[list] = None,
                      round_state: Callable = state_identity) -> tuple[int, np.ndarray, dict]:
        """The whole conversion; ``tokens`` (``src_narrow``, ``src_wide``,
        ``ref_narrow``, ``ref_wide`` and the AR's ``wide``, as the port's
        ``stats["kept"]["tokens"]``) replaces the quantizers' and the AR's
        own. ``states``: per CFM chunk, the sampler states of its first steps
        (one a step) at which to take the estimates too. Returns (sr, wave, info): info
        holds the tokens used and, with ``states``, ``estimates`` (per
        chunk, the combined estimate at each state)."""
        cfg, dev = self.cfg, self.device
        src, ref, src16, ref16 = self.resampled(source, source_sr, reference, reference_sr)
        if tokens is None:
            src_n, src_w = self.content_tokens(src16)
            tgt_n, tgt_w = self.content_tokens(ref16)
        else:
            src_n, src_w = tokens["src_narrow"], tokens["src_wide"]
            tgt_n, tgt_w = tokens["ref_narrow"], tokens["ref_wide"]
        mel2 = self.mel_fn(torch.from_numpy(ref[None]).to(dev))
        style = campplus_style(self.campplus, ref16, dev)
        p_len = mel2.shape[1]
        prompt_cond = self.regulate_tokens(self.cfm_reg, tgt_w, p_len)

        use_ar = convert_style or anonymization_only
        if use_ar and tokens is not None:
            wide = tokens["wide"]
        elif use_ar:
            rows = self.ar_rows(src_n, tgt_n, tgt_w, anonymization_only, cap_to_source)
            shape = (AR_MAX_NEW_TOKENS, len(rows.cond_lens), cfg.ar.vocab_size)
            draws = draws_fn(shape).float()
            gen = self.ar_generate(rows, draws, temperature=temperature, top_p=top_p,
                                   repetition_penalty=repetition_penalty)
            wide = np.concatenate(gen)[None]
        else:
            wide = src_w
        src_mel_len = len(src) // cfg.hop
        if use_ar:
            target_len = max(int(src_mel_len / max(src_w.shape[1], 1) * wide.shape[1]
                                 * length_adjust), 1)
        else:
            target_len = int(src_mel_len * length_adjust)
        cond = self.regulate_tokens(self.cfm_reg, wide, target_len)

        cap, context, W = plan_chunks(target_len, p_len, cfg.context_frames,
                                      cfg.prompt_cap_frames, align_offset=2)
        prompt_mel_cap = F.pad(mel2, (0, 0, 0, cap - p_len))
        prompt_cond_pad = F.pad(prompt_cond, (0, 0, 0, cap - p_len))
        L = (-(-target_len // W) + 1) * W
        cond_buf = F.pad(cond, (0, 0, 0, L - target_len))
        rates = (float(intelligibility_cfg_rate), float(similarity_cfg_rate))
        pieces, estimates, prev_tail = [], [], None
        overlap_wave = OVERLAP_FRAMES * cfg.hop
        processed = 0
        while processed < target_len:
            w = min(W, target_len - processed)
            is_last = processed + W >= target_len
            noise = noise_fn((1, context, cfg.n_mels)).to(dev)
            args = (cond_buf[:, processed: processed + W], prompt_cond_pad,
                    torch.tensor([p_len + w], device=dev), prompt_mel_cap, p_len, style)
            wave = self.sample_vocode(
                noise, *args, diffusion_steps, rates, bool(anonymization_only), context,
                round_state)[0].float().cpu().numpy()[: w * cfg.hop]
            if states is not None and len(estimates) < len(states):
                estimates.append(self.chunk_estimates(
                    states[len(estimates)], *args, diffusion_steps, rates,
                    bool(anonymization_only), context))
            piece, prev_tail = join_chunk(prev_tail, wave, is_last, overlap_wave)
            pieces.append(piece)
            processed += w if is_last else (w - OVERLAP_FRAMES)
        out = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        return cfg.sr, out, {"src_narrow": src_n, "src_wide": src_w, "ref_narrow": tgt_n,
                             "ref_wide": tgt_w, "wide": wide, "target_len": target_len,
                             "estimates": estimates}
