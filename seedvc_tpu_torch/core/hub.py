"""Checkpoint zoo + Hugging Face Hub fetching (port of
``seedvc_tpu/core/hub.py``).

The reference's ``hf_utils.py:5-12`` (a thin ``hf_hub_download`` wrapper)
plus the model-zoo coordinates hard-coded across its entry points
(``inference.py:48-60``, ``:95-97``, ``:67``, ``:118``,
``modules/v2/vc_wrapper.py:8-17``, ``train.py:546-551``,
``real-time-gui.py:166-167``), as one declarative registry. The files it
names are the inputs of ``python -m seedvc_tpu_torch.apps.convert_checkpoint``.

``huggingface_hub`` is an optional dependency: it is imported only in
``_download``, which raises a clear error without it. Files already in the
cache dir (the hub's cache layout, or dropped there by hand) short-circuit
the network entirely via ``local_path``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

DEFAULT_CACHE_DIR = "./checkpoints"


@dataclasses.dataclass(frozen=True)
class Artifact:
    """One downloadable checkpoint file (plus optional config sidecar)."""

    repo_id: str
    filename: str
    config_filename: Optional[str] = None


# Registry keyed by artifact name.  Coordinates mirror the reference zoo.
MODEL_ZOO: dict[str, Artifact] = {
    # v1 DiT checkpoints (reference inference.py:49-60, real-time-gui.py:166)
    "dit_whisper_small_wavenet": Artifact(
        "Plachta/Seed-VC",
        "DiT_seed_v2_uvit_whisper_small_wavenet_bigvgan_pruned.pth",
        "config_dit_mel_seed_uvit_whisper_small_wavenet.yml"),
    "dit_whisper_base_f0_44k": Artifact(
        "Plachta/Seed-VC",
        "DiT_seed_v2_uvit_whisper_base_f0_44k_bigvgan_pruned_ft_ema_v2.pth",
        "config_dit_mel_seed_uvit_whisper_base_f0_44k.yml"),
    "dit_xlsr_tiny": Artifact(
        "Plachta/Seed-VC", "DiT_uvit_tat_xlsr_ema.pth",
        "config_dit_mel_seed_uvit_xlsr_tiny.yml"),
    # v2 AR + CFM (modules/v2/vc_wrapper.py:8-10)
    "v2_cfm_small": Artifact("Plachta/Seed-VC", "v2/cfm_small.pth"),
    "v2_ar_base": Artifact("Plachta/Seed-VC", "v2/ar_base.pth"),
    # ASTRAL BSQ content extractors (vc_wrapper.py:12-14)
    "astral_bsq32": Artifact("Plachta/ASTRAL-quantization",
                             "bsq32/bsq32_light.pth"),
    "astral_bsq2048": Artifact("Plachta/ASTRAL-quantization",
                               "bsq2048/bsq2048_light.pth"),
    # speaker encoder (inference.py:95-97)
    "campplus": Artifact("funasr/campplus", "campplus_cn_common.bin"),
    # F0 extractor (inference.py:67)
    "rmvpe": Artifact("lj1995/VoiceConversionWebUI", "rmvpe.pt"),
    # vocoders (inference.py:103-137; configs/presets/*.yml vocoder names)
    "hift": Artifact("FunAudioLLM/CosyVoice-300M", "hift.pt"),
    "bigvgan_22k": Artifact("nvidia/bigvgan_v2_22khz_80band_256x",
                            "bigvgan_generator.pt", "config.json"),
    "bigvgan_44k": Artifact("nvidia/bigvgan_v2_44khz_128band_512x",
                            "bigvgan_generator.pt", "config.json"),
    # training-time timbre perturbation (train.py:546-551)
    "openvoice_converter": Artifact("myshell-ai/OpenVoiceV2",
                                    "converter/checkpoint.pth",
                                    "converter/config.json"),
    "se_db": Artifact("Plachta/Seed-VC", "se_db.pt"),
    # frozen SSL encoders (HF snapshot dirs rather than single files)
    "whisper_small": Artifact("openai/whisper-small", "model.safetensors",
                              "config.json"),
    "xlsr_300m": Artifact("facebook/wav2vec2-xls-r-300m",
                          "pytorch_model.bin", "config.json"),
    "hubert_large": Artifact("facebook/hubert-large-ll60k",
                             "pytorch_model.bin", "config.json"),
}

# Which artifacts each inference preset needs (v1 presets + the v2 stack).
PRESET_ARTIFACTS: dict[str, tuple[str, ...]] = {
    "whisper_small_wavenet": ("dit_whisper_small_wavenet", "campplus",
                              "bigvgan_22k", "whisper_small"),
    "whisper_base_f0_44k": ("dit_whisper_base_f0_44k", "campplus",
                            "bigvgan_44k", "whisper_small", "rmvpe"),
    "xlsr_tiny": ("dit_xlsr_tiny", "campplus", "hift", "xlsr_300m"),
    "v2": ("v2_cfm_small", "v2_ar_base", "astral_bsq32", "astral_bsq2048",
           "campplus", "bigvgan_22k", "hubert_large"),
}


def local_path(artifact: Artifact, cache_dir: str = DEFAULT_CACHE_DIR) -> Optional[str]:
    """Return a pre-existing local copy of ``artifact`` if present.

    Checks both a flat layout (``<cache>/<basename>``) for manually dropped
    files and the hf_hub cache layout used by :func:`fetch`.
    """
    flat = os.path.join(cache_dir, artifact.filename)
    if os.path.exists(flat):
        return flat
    flat_base = os.path.join(cache_dir, os.path.basename(artifact.filename))
    if os.path.exists(flat_base):
        return flat_base
    # hf_hub cache layout: <cache>/models--org--repo/snapshots/*/<filename>
    repo_dir = os.path.join(
        cache_dir, "models--" + artifact.repo_id.replace("/", "--"),
        "snapshots")
    if os.path.isdir(repo_dir):
        for snap in sorted(os.listdir(repo_dir)):
            cand = os.path.join(repo_dir, snap, artifact.filename)
            if os.path.exists(cand):
                return cand
    return None


def load_custom_model_from_hf(repo_id: str, model_filename: str,
                              config_filename: Optional[str] = None,
                              cache_dir: str = DEFAULT_CACHE_DIR):
    """Download (or reuse) a checkpoint from the HF hub.

    Mirrors the reference helper of the same name (``hf_utils.py:5-12``):
    returns the model path, or ``(model_path, config_path)`` when a config
    filename is given.
    """
    os.makedirs(cache_dir, exist_ok=True)
    art = Artifact(repo_id, model_filename, config_filename)
    model_path = local_path(art, cache_dir) or _download(
        repo_id, model_filename, cache_dir)
    if config_filename is None:
        return model_path
    cfg_art = Artifact(repo_id, config_filename)
    config_path = local_path(cfg_art, cache_dir) or _download(
        repo_id, config_filename, cache_dir)
    return model_path, config_path


def _download(repo_id: str, filename: str, cache_dir: str) -> str:
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is not installed and no local copy of "
            f"{repo_id}/{filename} was found under {cache_dir!r}; download "
            "the file manually into that directory.") from e
    return hf_hub_download(repo_id=repo_id, filename=filename,
                           cache_dir=cache_dir)


def fetch(name: str, cache_dir: str = DEFAULT_CACHE_DIR):
    """Fetch a zoo artifact by registry name."""
    if name not in MODEL_ZOO:
        raise KeyError(f"unknown artifact {name!r}; known: {sorted(MODEL_ZOO)}")
    art = MODEL_ZOO[name]
    return load_custom_model_from_hf(art.repo_id, art.filename,
                                     art.config_filename, cache_dir)


def fetch_preset(preset: str, cache_dir: str = DEFAULT_CACHE_DIR) -> dict:
    """Fetch every artifact a preset needs; returns {name: path(s)}."""
    if preset not in PRESET_ARTIFACTS:
        raise KeyError(
            f"unknown preset {preset!r}; known: {sorted(PRESET_ARTIFACTS)}")
    return {name: fetch(name, cache_dir) for name in PRESET_ARTIFACTS[preset]}
