"""Typed configuration schema and built-in presets.

A copy of the dataclasses and presets of ``seedvc_tpu/core/config.py``, so the
port needs no JAX. The YAML loader of the JAX package is not carried over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

@dataclass(frozen=True)
class SpectConfig:
    """STFT/mel parameters (reference ``preprocess_params.spect_params``)."""

    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None


@dataclass(frozen=True)
class PreprocessConfig:
    sr: int = 22050
    spect_params: SpectConfig = field(default_factory=SpectConfig)


@dataclass(frozen=True)
class TokenizerConfig:
    """Semantic (content) encoder selection (reference ``speech_tokenizer``)."""

    type: str = "whisper"  # whisper | xlsr | cnhubert | astral
    name: str = "openai/whisper-small"
    output_layer: int = 12  # xlsr only


@dataclass(frozen=True)
class StyleEncoderConfig:
    dim: int = 192
    campplus_path: str = "campplus_cn_common.bin"


@dataclass(frozen=True)
class VocoderConfig:
    type: str = "bigvgan"  # bigvgan | hifigan
    name: str = "nvidia/bigvgan_v2_22khz_80band_256x"


@dataclass(frozen=True)
class LengthRegulatorConfig:
    """Reference ``model_params.length_regulator`` —
    ``modules/length_regulator.py:28-89``."""

    channels: int = 512
    is_discrete: bool = False
    in_channels: int = 768
    content_codebook_size: int = 2048
    sampling_ratios: Sequence[int] = (1, 1, 1, 1)
    vector_quantize: bool = False
    n_codebooks: int = 1
    quantizer_dropout: float = 0.0
    f0_condition: bool = False
    n_f0_bins: int = 512


@dataclass(frozen=True)
class DiTConfig:
    """Reference ``model_params.DiT`` — ``modules/diffusion_transformer.py:407-482``."""

    hidden_dim: int = 512
    num_heads: int = 8
    depth: int = 13
    class_dropout_prob: float = 0.1
    block_size: int = 8192
    in_channels: int = 80
    style_condition: bool = True
    final_layer_type: str = "wavenet"  # wavenet | mlp
    target: str = "mel"
    content_dim: int = 512
    content_codebook_size: int = 1024
    content_type: str = "discrete"
    f0_condition: bool = False
    n_f0_bins: int = 512
    content_codebooks: int = 1
    is_causal: bool = False
    long_skip_connection: bool = True
    zero_prompt_speech_token: bool = False
    time_as_token: bool = False
    style_as_token: bool = False
    uvit_skip_connection: bool = True
    add_resblock_in_transformer: bool = False
    # RoPE base used by the gpt-fast transformer (reference default, `:61`).
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    # Attention branch (K1/K3 kernels or einsum, see nn.layers.Attention).
    # The block sizes are kept so configs match the JAX package's field for
    # field; the port's kernels read neither.
    use_flash_attention: bool = False
    flash_block_q: int = 1024
    flash_block_k: int = 512


@dataclass(frozen=True)
class WavenetConfig:
    hidden_dim: int = 512
    num_layers: int = 8
    kernel_size: int = 5
    dilation_rate: int = 1
    p_dropout: float = 0.2
    style_condition: bool = True


@dataclass(frozen=True)
class ModelParams:
    dit_type: str = "DiT"
    reg_loss_type: str = "l1"
    speech_tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    style_encoder: StyleEncoderConfig = field(default_factory=StyleEncoderConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    length_regulator: LengthRegulatorConfig = field(default_factory=LengthRegulatorConfig)
    DiT: DiTConfig = field(default_factory=DiTConfig)
    wavenet: WavenetConfig = field(default_factory=WavenetConfig)


@dataclass(frozen=True)
class TrainConfig:
    log_dir: str = "./runs"
    epochs: int = 1000
    batch_size: int = 2
    max_len: int = 80  # max mel frames per training sample
    base_lr: float = 1e-4
    log_interval: int = 10
    save_interval: int = 1000
    lambda_commit: float = 0.05
    lambda_codebook: float = 0.15
    grad_clip: float = 10.0


@dataclass(frozen=True)
class SeedVCConfig:
    """Top-level config for one model preset."""

    preprocess_params: PreprocessConfig = field(default_factory=PreprocessConfig)
    model_params: ModelParams = field(default_factory=ModelParams)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def dit(self) -> DiTConfig:
        return self.model_params.DiT

    @property
    def sr(self) -> int:
        return self.preprocess_params.sr

# ---------------------------------------------------------------------------
# Built-in presets mirroring the three shipped reference models
# (`configs/presets/`), so no YAML files are required at runtime.
# ---------------------------------------------------------------------------

def preset_whisper_small_wavenet() -> SeedVCConfig:
    """seed-uvit-whisper-small-wavenet: 98M DiT, 22.05 kHz, BigVGAN 80-band."""
    return SeedVCConfig(
        preprocess_params=PreprocessConfig(
            sr=22050,
            spect_params=SpectConfig(n_fft=1024, win_length=1024, hop_length=256,
                                     n_mels=80, fmin=0, fmax=None),
        ),
        model_params=ModelParams(
            speech_tokenizer=TokenizerConfig(type="whisper", name="openai/whisper-small"),
            vocoder=VocoderConfig(type="bigvgan", name="nvidia/bigvgan_v2_22khz_80band_256x"),
            length_regulator=LengthRegulatorConfig(
                channels=512, is_discrete=False, in_channels=768,
                sampling_ratios=(1, 1, 1, 1)),
            DiT=DiTConfig(
                hidden_dim=512, num_heads=8, depth=13, in_channels=80,
                final_layer_type="wavenet", content_dim=512,
                long_skip_connection=True, uvit_skip_connection=True,
                time_as_token=False, style_as_token=False,
                use_flash_attention=True,
                flash_block_q=1280, flash_block_k=1280),
            wavenet=WavenetConfig(hidden_dim=512, num_layers=8, kernel_size=5,
                                  dilation_rate=1, p_dropout=0.2),
        ),
    )


def preset_xlsr_tiny() -> SeedVCConfig:
    """seed-uvit-tat-xlsr-tiny: 25M DiT, realtime model, HiFT vocoder."""
    return SeedVCConfig(
        preprocess_params=PreprocessConfig(
            sr=22050,
            spect_params=SpectConfig(n_fft=1024, win_length=1024, hop_length=256,
                                     n_mels=80, fmin=0, fmax=8000),
        ),
        model_params=ModelParams(
            speech_tokenizer=TokenizerConfig(type="xlsr", name="facebook/wav2vec2-xls-r-300m",
                                             output_layer=12),
            vocoder=VocoderConfig(type="hifigan", name=""),
            length_regulator=LengthRegulatorConfig(
                channels=384, is_discrete=False, in_channels=1024,
                sampling_ratios=(1, 1, 1, 1), n_codebooks=2),
            DiT=DiTConfig(
                hidden_dim=384, num_heads=6, depth=9, in_channels=80,
                final_layer_type="mlp", content_dim=384,
                long_skip_connection=False, uvit_skip_connection=True,
                time_as_token=True, style_as_token=True,
                use_flash_attention=True,
                flash_block_q=1280, flash_block_k=1280),
        ),
    )


def preset_whisper_base_f0_44k() -> SeedVCConfig:
    """seed-uvit-whisper-base-f0-44k: 200M DiT, 44.1 kHz SVC model."""
    return SeedVCConfig(
        preprocess_params=PreprocessConfig(
            sr=44100,
            spect_params=SpectConfig(n_fft=2048, win_length=2048, hop_length=512,
                                     n_mels=128, fmin=0, fmax=None),
        ),
        model_params=ModelParams(
            speech_tokenizer=TokenizerConfig(type="whisper", name="openai/whisper-small"),
            vocoder=VocoderConfig(type="bigvgan", name="nvidia/bigvgan_v2_44khz_128band_512x"),
            length_regulator=LengthRegulatorConfig(
                channels=768, is_discrete=False, in_channels=768,
                sampling_ratios=(1, 1, 1, 1), f0_condition=True, n_f0_bins=256),
            DiT=DiTConfig(
                hidden_dim=768, num_heads=12, depth=17, in_channels=128,
                final_layer_type="mlp", content_dim=768, f0_condition=True,
                n_f0_bins=256, long_skip_connection=False,
                uvit_skip_connection=True, time_as_token=False,
                style_as_token=False, use_flash_attention=True,
                flash_block_q=1280, flash_block_k=1280),
            wavenet=WavenetConfig(hidden_dim=768),
        ),
    )


def _cantonese(base: SeedVCConfig) -> SeedVCConfig:
    """Cantonese presets (``configs/presets/config_cantonese*.yml``) differ
    from their base preset only in the whisper checkpoint:
    ``alvanlii/whisper-small-cantonese``."""
    mp = dataclasses.replace(
        base.model_params,
        speech_tokenizer=dataclasses.replace(
            base.model_params.speech_tokenizer,
            name="alvanlii/whisper-small-cantonese"))
    return dataclasses.replace(base, model_params=mp)


def preset_cantonese_whisper_small_wavenet() -> SeedVCConfig:
    return _cantonese(preset_whisper_small_wavenet())


def preset_cantonese_whisper_base_f0_44k() -> SeedVCConfig:
    return _cantonese(preset_whisper_base_f0_44k())


PRESETS = {
    "whisper_small_wavenet": preset_whisper_small_wavenet,
    "xlsr_tiny": preset_xlsr_tiny,
    "whisper_base_f0_44k": preset_whisper_base_f0_44k,
    "cantonese_whisper_small_wavenet": preset_cantonese_whisper_small_wavenet,
    "cantonese_whisper_base_f0_44k": preset_cantonese_whisper_base_f0_44k,
}


def get_preset(name: str) -> SeedVCConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
