"""Builds a v1 ``VoiceConverter`` (the port's, and the frozen reference's)
from a configuration file, fills both from the seed, and counts the
operations of a conversion from its shapes.

The file holds the whole configuration as it is run: the preset
(``SeedVCConfig`` field for field), the content encoder's and the vocoder's
sizes, the converter's prompt cap and context, and the init rules.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import torch

from vcbench import weights

MODULES = ("whisper", "campplus", "vc", "vocoder")


def from_dict(cls, d):
    """A (nested, frozen) dataclass from plain JSON values; lists become
    tuples."""
    if dataclasses.is_dataclass(cls):
        hints = typing.get_type_hints(cls)
        kw = {f.name: from_dict(hints[f.name], d[f.name])
              for f in dataclasses.fields(cls) if f.name in d}
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise KeyError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
        return cls(**kw)
    if isinstance(d, list):
        return tuple(from_dict(None, x) for x in d)
    return d


def configs(pkg, cfg: dict):
    """(SeedVCConfig, content-encoder config, vocoder config) in the classes
    of ``pkg`` (``seedvc_tpu_torch`` or ``vcbench.ref``)."""
    import importlib
    config = importlib.import_module(f"{pkg}.core.config")
    enc = dict(cfg["content_encoder"])
    enc_kind = enc.pop("kind")
    if enc_kind == "whisper":
        enc_cls = importlib.import_module(f"{pkg}.models.whisper").WhisperEncoderConfig
    else:
        enc_cls = importlib.import_module(f"{pkg}.models.ssl").SSLConfig
    voc = dict(cfg["vocoder"])
    voc_kind = voc.pop("kind")
    if voc_kind == "bigvgan":
        voc_cls = importlib.import_module(f"{pkg}.models.bigvgan").BigVGANConfig
    else:
        voc_cls = importlib.import_module(f"{pkg}.models.hifigan").HiFTConfig
    return (from_dict(config.SeedVCConfig, cfg["preset"]), from_dict(enc_cls, enc),
            from_dict(voc_cls, voc))


def modules(vc) -> dict:
    return {name: getattr(vc, name) for name in MODULES}


def program(cfg: dict, device):
    """The port's converter (its own compute dtypes on the device)."""
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    seed_cfg, enc, voc = configs("seedvc_tpu_torch", cfg)
    conv = cfg["converter"]
    return VoiceConverter(seed_cfg, whisper_cfg=enc, vocoder_cfg=voc,
                          prompt_cap_frames=conv["prompt_cap_frames"],
                          context_frames=conv["context_frames"], device=device)


def reference(cfg: dict, device):
    """The frozen plain converter, every part in f32, TF32 off."""
    from vcbench.ref.pipelines.convert import VoiceConverter
    seed_cfg, enc, voc = configs("vcbench.ref", cfg)
    conv = cfg["converter"]
    ref = VoiceConverter(seed_cfg, whisper_cfg=enc, vocoder_cfg=voc,
                         prompt_cap_frames=conv["prompt_cap_frames"],
                         context_frames=conv["context_frames"],
                         compute_dtype=torch.float32, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ref


def fill(vc, cfg: dict, seed: int, device) -> int:
    return weights.fill(modules(vc), cfg["init"], seed, device)


# ---------------------------------------------------------------------------
# operations of a conversion, counted on the reference's modules on the meta
# device (no arithmetic runs), by torch's per-operator formulas; attention is
# counted by the valid keys alone (4 d Tq H n_valid a call)

class Counter:
    """Operations (multiply-adds as 2) of each part of a v1 conversion, by
    shape, split by the precision the configuration runs it in."""

    def __init__(self, cfg: dict):
        from vcbench.ref.models.bigvgan import BigVGAN
        from vcbench.ref.models.campplus import CAMPPlus
        from vcbench.ref.models.hifigan import HiFTGenerator
        from vcbench.ref.models.ssl import SSLEncoder
        from vcbench.ref.models.vc import VCModel
        from vcbench.ref.models.whisper import WhisperEncoder
        seed_cfg, enc, voc = configs("vcbench.ref", cfg)
        self.cfg = seed_cfg
        self.voc = voc
        mp = seed_cfg.model_params
        with torch.device("meta"):
            self.whisper = (WhisperEncoder(enc) if cfg["content_encoder"]["kind"] == "whisper"
                            else SSLEncoder(enc))
            self.campplus = CAMPPlus(feat_dim=80, embedding_size=mp.style_encoder.dim)
            self.vc = VCModel(mp)
            self.vocoder = (BigVGAN(voc) if cfg["vocoder"]["kind"] == "bigvgan"
                            else HiFTGenerator(voc))
        self.n_mels = seed_cfg.preprocess_params.spect_params.n_mels
        self.heads = mp.DiT.num_heads
        self.depth = mp.DiT.depth
        self.head_dim = mp.DiT.hidden_dim // mp.DiT.num_heads

    @staticmethod
    def _count(fn) -> int:
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as m:
            fn()
        return int(m.get_total_flops())

    @functools.lru_cache(maxsize=None)
    def whisper_window(self) -> int:
        return self._count(lambda: self.whisper(torch.zeros(1, 3000, self.n_mels,
                                                            device="meta")))

    @functools.lru_cache(maxsize=None)
    def ssl_window(self, samples: int) -> int:
        """An SSL content encoder over ``samples`` 16 kHz samples."""
        return self._count(lambda: self.whisper(torch.zeros(1, samples, device="meta")))

    @functools.lru_cache(maxsize=None)
    def style(self, frames: int) -> int:
        return self._count(lambda: self.campplus(
            torch.zeros(1, frames, 80, device="meta"),
            torch.tensor([frames], device="meta")))

    @functools.lru_cache(maxsize=None)
    def regulate(self, s_T: int, out_len: int) -> int:
        reg = self.vc.length_regulator
        in_ch = self.cfg.model_params.length_regulator.in_channels
        return self._count(lambda: reg(torch.zeros(1, s_T, in_ch, device="meta"),
                                       torch.tensor([out_len], device="meta"), out_len,
                                       None, x_lens=torch.tensor(s_T, device="meta")))

    @functools.lru_cache(maxsize=None)
    def _sampler(self, context: int, steps: int) -> int:
        """The sampler's operations outside attention (CFG batch 2)."""
        from vcbench.ref.models.cfm import euler_solve
        from vcbench.ref.nn import layers
        orig = layers.dit_attention_fused
        layers.dit_attention_fused = lambda q, k, v, *a, **kw: torch.empty_like(q)
        try:
            M = functools.partial(torch.zeros, device="meta")
            D = self.cfg.model_params.DiT.content_dim
            return self._count(lambda: euler_solve(
                self.vc.estimate, M(1, context, self.n_mels), M(1, context, D),
                torch.tensor([context], device="meta"), M(1, context, self.n_mels), 1,
                M(1, self.cfg.model_params.style_encoder.dim), n_timesteps=steps,
                cfg_rate=0.7, precompute_fn=self.vc.precompute_cond))
        finally:
            layers.dit_attention_fused = orig

    @functools.lru_cache(maxsize=None)
    def train_step(self, B: int, T: int, s_T: int) -> int:
        """Forward and backward of the trained model (regulator + CFM loss)
        on a (B, T) mel batch with s_T content tokens, outside attention."""
        from vcbench.ref.models.vc import TrainDraws
        from vcbench.ref.nn import layers
        orig = layers.dit_attention_fused_diff
        layers.dit_attention_fused_diff = lambda q, k, v, *a, **kw: q * 1.0
        try:
            M = functools.partial(torch.zeros, device="meta")
            mp = self.cfg.model_params
            D = mp.length_regulator.in_channels
            draws = TrainDraws(M(B), torch.zeros(B, dtype=torch.bool, device="meta"), M(B),
                               M(B, T, self.n_mels), M(B))

            def step():
                loss, _ = self.vc(M(B, s_T, D), M(B, s_T, D), M(B, T, self.n_mels),
                                  torch.tensor([T] * B, device="meta"),
                                  M(B, mp.style_encoder.dim), draws,
                                  s_lens=torch.tensor(s_T, device="meta"))
                loss.backward()
            return self._count(step)
        finally:
            layers.dit_attention_fused_diff = orig

    def sampler(self, context: int, steps: int, n_valid: int) -> tuple[int, int]:
        """(operations outside attention, attention operations) of one
        chunk's ``steps`` Euler steps at ``context`` with ``n_valid`` keys."""
        one, two = self._sampler(context, 1), self._sampler(context, 2)
        dense = one + (steps - 1) * (two - one)
        attn = steps * self.depth * 4 * self.head_dim * context * self.heads * 2 * n_valid
        return dense, attn

    @functools.lru_cache(maxsize=None)
    def vocode(self, frames: int) -> int:
        mel = torch.zeros(1, frames, self.n_mels, device="meta")
        if self.voc.__class__.__name__ == "HiFTConfig":
            H, n = self.voc.nb_harmonics + 1, frames * self.voc.total_upsample
            draws = (torch.zeros(1, 1, H, device="meta"), torch.zeros(1, n, H, device="meta"))
            return self._count(lambda: self.vocoder(mel, draws))
        return self._count(lambda: self.vocoder(mel))

    def block(self, stream_cfg, prompt_frames: int) -> dict:
        """Operations of one converted block of the real-time stream: the
        SSL encoder over its padded window (f32), the regulator and the
        vocoder (f32), and ``diffusion_steps`` CFG Euler steps of the DiT
        over prompt + DiT window (``low``: the configured bf16)."""
        s = stream_cfg
        sr = self.cfg.preprocess_params.sr
        hop = self.cfg.preprocess_params.spect_params.hop_length

        def samples(t):
            return int(round(t * sr / hop)) * hop

        window = (samples(s.extra_time_ce) + samples(s.crossfade_time)
                  + samples(s.sola_search_time) + samples(s.block_time)
                  + samples(s.extra_time_right))
        w16 = int(window / sr * 16000)
        pad16 = -(-max(w16, 8000) // 80000) * 80000
        drop = int((samples(s.extra_time_ce) - samples(s.extra_time_dit)) / sr * 50)
        dit_frames = (window - (samples(s.extra_time_ce) - samples(s.extra_time_dit))) // hop
        T = prompt_frames + dit_frames
        dense, attn = self.sampler(T, s.diffusion_steps, T)
        n_prefix = int(self.cfg.model_params.DiT.time_as_token) + \
            int(self.cfg.model_params.DiT.style_as_token)
        attn = attn * (T + n_prefix) ** 2 // T ** 2
        f32 = (self.ssl_window(pad16) + self.regulate(w16 // 320 - drop, dit_frames)
               + self.vocode(dit_frames))
        return {"low": dense + attn, "f32": f32, "T": T + n_prefix}
