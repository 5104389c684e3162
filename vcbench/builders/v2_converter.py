"""Builds a v2 ``VoiceConverterV2`` (the port's, and the frozen reference's)
from a configuration file, fills both from the seed, and counts the
operations of a conversion from its shapes.

The file holds the whole configuration as it is run: ``v2`` (``V2Config``
field for field: the DiT, the AR, HuBERT, both quantizers, the prompt cap
and the context), the vocoder's sizes, the precisions and the init rules.
A port without the AR's per-row cap (``cap_to_source``) or the kept
intermediates the check compares (``keep_intermediates``) cannot run the
cell: :func:`program` refuses it before building anything.
"""

from __future__ import annotations

import functools
import inspect

import torch

from vcbench import peaks, weights
from vcbench.builders.voice_converter import from_dict

MODULES = ("ssl", "narrow", "wide", "campplus", "cfm_reg", "ar_reg", "dit", "ar", "vocoder")
BF16_PARTS = ("ssl", "narrow", "wide", "dit", "ar")


def configs(pkg: str, cfg: dict):
    """(V2Config, BigVGANConfig) in the classes of ``pkg``
    (``seedvc_tpu_torch`` or ``vcbench.ref``)."""
    import importlib
    conv = importlib.import_module(f"{pkg}.pipelines.convert_v2")
    voc = importlib.import_module(f"{pkg}.models.bigvgan").BigVGANConfig
    return from_dict(conv.V2Config, cfg["v2"]), from_dict(voc, cfg["vocoder"])


def program(cfg: dict, device):
    """The port's converter (bf16 HuBERT, quantizers, DiT and AR on cuda)."""
    from seedvc_tpu_torch.pipelines import convert_v2 as pconv
    params = inspect.signature(pconv.VoiceConverterV2.convert_voice_with_streaming).parameters
    if "cap_to_source" not in params or "keep_intermediates" not in params:
        raise RuntimeError("this port's VoiceConverterV2 has no per-row AR cap "
                           "(cap_to_source) or kept intermediates (keep_intermediates): "
                           "the cell cannot run")
    v2cfg, voc = configs("seedvc_tpu_torch", cfg)
    return pconv.VoiceConverterV2(v2cfg, vocoder_cfg=voc, device=device)


def reference(cfg: dict, device):
    """The frozen plain converter, every part in f32, TF32 off."""
    from vcbench.ref.pipelines.convert_v2 import VoiceConverterV2
    v2cfg, voc = configs("vcbench.ref", cfg)
    ref = VoiceConverterV2(v2cfg, vocoder_cfg=voc, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ref


def modules(vc) -> dict:
    return {name: getattr(vc, name) for name in MODULES}


def fill(vc, cfg: dict, seed: int, device) -> int:
    return weights.fill(modules(vc), cfg["init"], seed, device)


# ---------------------------------------------------------------------------
# operations of a conversion by shape: the modules counted on the reference
# on the meta device (no arithmetic runs) by torch's per-operator formulas,
# the AR and attention by the keys each query really attends

class Counter:
    """Operations (multiply-adds as 2) of each part of a v2 conversion, and
    the bytes of the AR's decode steps."""

    def __init__(self, cfg: dict):
        from vcbench.ref.pipelines.convert_v2 import VoiceConverterV2
        self.cfg, voc = configs("vcbench.ref", cfg)
        with torch.device("meta"):
            self.vc = VoiceConverterV2(self.cfg, vocoder_cfg=voc, device="meta")
        c = self.cfg
        self.heads = c.dit.num_heads
        self.depth = c.dit.depth
        self.head_dim = c.dit.hidden_dim // c.dit.num_heads
        a = c.ar
        per_layer = (a.dim * (a.n_head + 2 * a.n_local_heads) * a.head_dim
                     + a.n_head * a.head_dim * a.dim + 3 * a.dim * a.intermediate_size)
        self.ar_layer_weights = a.n_layer * per_layer
        self.ar_out_weights = a.dim * a.vocab_size

    @staticmethod
    def _count(fn) -> int:
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as m:
            fn()
        return int(m.get_total_flops())

    @functools.lru_cache(maxsize=None)
    def ssl(self, samples: int) -> int:
        """HuBERT over ``samples`` (a 5 s bucket) of 16 kHz audio."""
        return self._count(lambda: self.vc.ssl(torch.zeros(1, samples, device="meta")))

    @functools.lru_cache(maxsize=None)
    def quantizers(self, frames: int) -> int:
        x = torch.zeros(1, frames, self.cfg.ssl.d_model, device="meta")
        return self._count(lambda: (self.vc.narrow(x), self.vc.wide(x)))

    @functools.lru_cache(maxsize=None)
    def style(self, frames: int) -> int:
        return self._count(lambda: self.vc.campplus(
            torch.zeros(1, frames, 80, device="meta"), torch.tensor([frames], device="meta")))

    @functools.lru_cache(maxsize=None)
    def regulate(self, which: str, B: int, tokens: int, out_len: int) -> int:
        reg = getattr(self.vc, which)
        return self._count(lambda: reg(torch.zeros(B, tokens, dtype=torch.long, device="meta"),
                                       torch.tensor([out_len] * B, device="meta"), out_len,
                                       x_lens=torch.tensor(tokens, device="meta")))

    def ar_token(self, keys: int) -> int:
        """One query token through the AR's layers attending ``keys`` keys
        (no output projection)."""
        a = self.cfg.ar
        return 2 * self.ar_layer_weights + a.n_layer * 4 * a.head_dim * a.n_head * keys

    def ar_prefill(self, lengths) -> int:
        """The packed prefill: each row's own tokens, causal, and the output
        projection of its last position."""
        out = 0
        for L in lengths:
            out += 2 * self.ar_layer_weights * L
            out += self.cfg.ar.n_layer * 4 * self.cfg.ar.head_dim * self.cfg.ar.n_head * \
                L * (L + 1) // 2
            out += 2 * self.ar_out_weights
        return out

    def ar_decode(self, lengths, emitted) -> int:
        """Each row's decode steps: token j (j >= 1) came from one step over
        its prefill length + j keys, with the output projection."""
        out = 0
        for L, n in zip(lengths, emitted):
            for j in range(1, int(n)):
                out += self.ar_token(L + j) + 2 * self.ar_out_weights
        return out

    def ar_step_bytes(self, B: int, keys: int) -> int:
        """Least bytes of one decode step over B rows: the AR's weights once
        (bf16; of the embedding table the B rows alone) and the K and V
        slots the step attends, ``keys`` summed over the rows, in every
        layer."""
        a = self.cfg.ar
        w = 2 * (self.ar_layer_weights + self.ar_out_weights + B * a.dim
                 + a.n_layer * 2 * a.dim + a.dim)
        return w + 2 * a.n_layer * a.n_local_heads * keys * a.head_dim * 2

    @functools.lru_cache(maxsize=None)
    def _sampler(self, context: int, steps: int, branches: int) -> int:
        """The sampler's operations outside attention."""
        from vcbench.ref.models.cfm_v2 import euler_solve_multicfg
        from vcbench.ref.nn import layers
        orig = layers.dit_attention_fused
        layers.dit_attention_fused = lambda q, k, v, *a, **kw: torch.empty_like(q)
        try:
            M = functools.partial(torch.zeros, device="meta")
            c = self.cfg
            rates = (0.7, 0.7) if branches == 3 else (0.7, 0.0)
            vc = self.vc

            def estimate(x, px, lens, t, s, m, sc=None):
                return vc.dit(x, px, lens, t, s, m, static_cond=sc)

            def precompute(x, px, lens, s, m):
                return vc.dit(x, px, lens, torch.zeros(x.shape[0], device="meta"), s, m,
                              return_static=True)
            return self._count(lambda: euler_solve_multicfg(
                estimate, M(1, context, c.n_mels), M(1, context, c.dit.content_dim),
                torch.tensor([context], device="meta"), M(1, context, c.n_mels), 1,
                M(1, c.dit.style_encoder_dim), n_timesteps=steps, cfg_rates=rates,
                precompute_fn=precompute))
        finally:
            layers.dit_attention_fused = orig

    def sampler(self, context: int, steps: int, n_valid: int,
                branches: int = 3) -> tuple[int, int]:
        """(operations outside attention, attention operations) of one
        chunk: ``steps`` Euler steps of the ``branches``-way stack at
        ``context`` (+ 2 prefix tokens), keys valid below ``n_valid`` + 2."""
        one, two = self._sampler(context, 1, branches), self._sampler(context, 2, branches)
        dense = one + (steps - 1) * (two - one)
        attn = (steps * self.depth * 4 * self.head_dim * (context + 2) * self.heads
                * branches * (n_valid + 2))
        return dense, attn

    @functools.lru_cache(maxsize=None)
    def vocode(self, frames: int) -> int:
        return self._count(lambda: self.vc.vocoder(
            torch.zeros(1, frames, self.cfg.n_mels, device="meta")))

    def k1(self, context: int, n_valid: int, branches: int = 3) -> float:
        """Least seconds of one K1 launch of the sampler's stack."""
        return peaks.k1_bf16(branches, self.heads, context + 2, context + 2,
                             branches * (n_valid + 2), self.head_dim)
