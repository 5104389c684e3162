"""Builds the F0-conditioned v1 ``VoiceConverter`` of the SVC presets (the
port's, and the frozen reference's ``SVCConverter``) from a configuration
file, fills both from the seed, RMVPE included, and counts the operations
of a conversion from its shapes.

The file holds v1's keys (``voice_converter.py``) and ``rmvpe``: RMVPE's
geometry (``RMVPE_E2E``'s arguments; the released checkpoint's at full
size). A port whose ``convert_with_streaming`` keeps no intermediates
cannot run the cell: :func:`program` refuses it before building anything.
"""

from __future__ import annotations

import functools
import inspect

import torch

from vcbench import weights
from vcbench.builders import voice_converter as v1b

MODULES = (*v1b.MODULES, "rmvpe")


def program(cfg: dict, device):
    """The port's converter (its own compute dtypes on the device), with an
    RMVPE of the configuration's geometry."""
    from seedvc_tpu_torch.models.rmvpe import RMVPE, RMVPE_E2E
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    params = inspect.signature(VoiceConverter.convert_with_streaming).parameters
    if "keep_intermediates" not in params:
        raise RuntimeError("this port's VoiceConverter keeps no intermediates "
                           "(keep_intermediates): the cell cannot run")
    conv = v1b.program(cfg, device)
    if cfg["rmvpe"] != _released_geometry(RMVPE_E2E):
        model = RMVPE_E2E(**cfg["rmvpe"]).requires_grad_(False).eval().to(conv.device)
        conv.rmvpe = RMVPE(model)
    return conv


def _released_geometry(cls) -> dict:
    return {k: p.default for k, p in inspect.signature(cls.__init__).parameters.items()
            if p.default is not inspect.Parameter.empty}


def reference(cfg: dict, device):
    """The frozen plain converter, every part in f32, TF32 off."""
    from vcbench.ref.pipelines.convert_svc import SVCConverter
    seed_cfg, enc, voc = v1b.configs("vcbench.ref", cfg)
    conv = cfg["converter"]
    ref = SVCConverter(seed_cfg, rmvpe=cfg["rmvpe"], whisper_cfg=enc, vocoder_cfg=voc,
                       prompt_cap_frames=conv["prompt_cap_frames"],
                       context_frames=conv["context_frames"],
                       compute_dtype=torch.float32, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ref


def modules(vc) -> dict:
    return {**v1b.modules(vc), "rmvpe": vc.rmvpe.model}


def fill(vc, cfg: dict, seed: int, device) -> int:
    return weights.fill(modules(vc), cfg["init"], seed, device)


class Counter(v1b.Counter):
    """v1's counter with RMVPE: its U-Net, both GRU scans and the output
    layer, all f32, counted on the reference's module on the meta device."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        from vcbench.ref.models.rmvpe import RMVPE_E2E
        with torch.device("meta"):
            self.rmvpe_model = RMVPE_E2E(**cfg["rmvpe"])
        self.encoder_mels = cfg["content_encoder"]["n_mels"]

    @functools.lru_cache(maxsize=None)
    def whisper_window(self) -> int:
        """One 30 s Whisper window, over the encoder's own mel bands (80),
        which are not the model's (128 here)."""
        return self._count(lambda: self.whisper(
            torch.zeros(1, 3000, self.encoder_mels, device="meta")))

    @functools.lru_cache(maxsize=None)
    def _unet(self, frames: int) -> int:
        from vcbench.ref.models.rmvpe import N_MELS
        return self._count(lambda: self.rmvpe_model.unet(
            torch.zeros(1, frames, N_MELS, device="meta")))

    @functools.lru_cache(maxsize=None)
    def _gru_step(self) -> int:
        """One frame of both GRU scans (its input and state products)."""
        m = self.rmvpe_model
        x = torch.zeros(1, 1, m.gru_fwd.weight_ih_l0.shape[1], device="meta")
        return self._count(lambda: (m.gru_fwd(x), m.gru_bwd(x)))

    @functools.lru_cache(maxsize=None)
    def _head(self, frames: int) -> int:
        m = self.rmvpe_model
        return self._count(lambda: m.fc_linear(
            torch.zeros(1, frames, m.fc_linear.in_features, device="meta")))

    def rmvpe(self, n16: int) -> int:
        """RMVPE over ``n16`` samples of 16 kHz audio: 1 + n16 // 160 frames
        padded to a multiple of 32, every part over the padded frames."""
        frames = -(-(1 + n16 // 160) // 32) * 32
        return self._unet(frames) + frames * self._gru_step() + self._head(frames)
