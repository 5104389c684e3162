"""The reference-layout writer and the port's converters against
``transformers``' own models, at tiny configs.

- The writer (``tests/torch_ref_checkpoints.py``) gives the same key set and
  shapes as ``state_dict()`` of ``WhisperForConditionalGeneration`` (its
  ``model.encoder.*`` part), ``Wav2Vec2Model``, ``HubertModel`` and
  ``WavLMForXVector`` of the same sizes: its files have the published layout.
- On each HF model's own state dict the port's converter gives the JAX
  package's tree (same keys, shapes, dtypes; max abs difference 0), and
  that tree loads whole into the port module.
"""

import pytest
import torch

import torch_ref_checkpoints as W
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from test_torch_convert import assert_identical, side

torch.set_num_threads(1)
D, HEADS, FFN, LAYERS = 32, 4, 64, 2


def hf_whisper():
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    cfg = WhisperConfig(num_mel_bins=80, d_model=D, encoder_layers=LAYERS,
                        encoder_attention_heads=HEADS, encoder_ffn_dim=FFN,
                        max_source_positions=64, decoder_layers=1, decoder_attention_heads=HEADS,
                        decoder_ffn_dim=FFN)
    return WhisperForConditionalGeneration(cfg)


def port_whisper():
    m = side("port", "models.whisper")
    return m.WhisperEncoder(m.WhisperEncoderConfig(d_model=D, n_layers=LAYERS, n_heads=HEADS,
                                                   ffn_dim=FFN, max_positions=64))


SSL_HF = dict(hidden_size=D, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
              intermediate_size=FFN, conv_dim=(16,) * 7, feat_extract_norm="layer",
              do_stable_layer_norm=True, conv_bias=True, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4)


def hf_wav2vec2():
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    return Wav2Vec2Model(Wav2Vec2Config(**SSL_HF))


def hf_hubert():
    from transformers import HubertConfig, HubertModel

    return HubertModel(HubertConfig(**SSL_HF))


def port_ssl():
    m = side("port", "models.ssl")
    return m.SSLEncoder(m.SSLConfig(conv_dim=16, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                                    ffn_dim=FFN, pos_conv_kernel=16, pos_conv_groups=4,
                                    apply_final_norm=True))


def hf_wavlm():
    from transformers import WavLMConfig, WavLMForXVector

    return WavLMForXVector(WavLMConfig(
        hidden_size=48, num_hidden_layers=LAYERS, num_attention_heads=HEADS, intermediate_size=96,
        conv_dim=(16,) * 7, conv_bias=False, feat_extract_norm="group",
        do_stable_layer_norm=False, num_buckets=40, max_bucket_distance=80,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        use_weighted_layer_sum=True, tdnn_dim=(24, 24, 24, 24, 48),
        xvector_output_dim=20))


def port_wavlm():
    m = side("port", "models.wavlm_sv")
    return m.WavLMSV(m.WavLMSVConfig(
        conv_dim=16, d_model=48, n_layers=LAYERS, n_heads=HEADS, ffn_dim=96, num_buckets=40,
        max_distance=80, pos_conv_kernel=16, pos_conv_groups=4,
        tdnn_dims=(24, 24, 24, 24, 48), xvector_dim=20))


def encoder_keys(sd):
    return {k.replace("model.encoder.", "encoder."): v for k, v in sd.items()}


# name: (HF model, port module, writer, HF keys the writer covers, converter
#        module, converter, its args, the state dict as the CLI hands it over)
CASES = {
    "whisper": (hf_whisper, port_whisper, W.write_whisper,
                lambda k: k.startswith("model.encoder."), "whisper",
                "convert_whisper_encoder", (LAYERS,), encoder_keys),
    "wav2vec2": (hf_wav2vec2, port_ssl, W.write_ssl, lambda k: True, "ssl", "convert_ssl",
                 (LAYERS,), dict),
    "hubert": (hf_hubert, port_ssl, W.write_ssl, lambda k: True, "ssl", "convert_ssl",
               (LAYERS,), dict),
    "wavlm_sv": (hf_wavlm, port_wavlm, W.write_wavlm_sv, lambda k: True, "wavlm_sv",
                 "convert_wavlm_sv", (LAYERS,), dict),
}


@pytest.mark.parametrize("case", CASES)
def test_writer_layout_equals_transformers(case):
    hf, port, write, covers, *_ = CASES[case]
    torch.manual_seed(0)
    ref = {k: tuple(v.shape) for k, v in hf().state_dict().items() if covers(k)}
    got = {k: tuple(v.shape) for k, v in write(to_jax_params(port())).items()}
    assert sorted(got) == sorted(ref)
    assert got == ref


@pytest.mark.parametrize("case", CASES)
def test_converters_agree_on_transformers_state_dict(case):
    hf, port, _, _, modname, fn, args, handover = CASES[case]
    torch.manual_seed(0)
    sd = handover(hf().state_dict())
    tree = getattr(side("port", f"convert.{modname}"), fn)(sd, *args)
    assert_identical(tree, getattr(side("jax", f"convert.{modname}"), fn)(sd, *args))
    load_jax_params(port(), tree)
