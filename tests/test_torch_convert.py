"""The port's checkpoint converters (``seedvc_tpu_torch/convert``) against the
JAX package's (``seedvc_tpu/convert``) on the same state dicts.

Each case builds a port module from a seed at a small size, exports its
tree (``weights.to_jax_params``) and writes the reference's state dict from
it (``tests/torch_ref_checkpoints.py``). Then:

- the port's converter and the JAX one give the same tree: the same keys,
  shapes and dtypes, max abs difference 0;
- the writer's own check: the JAX converter gives the exported tree back,
  exactly, or to 1e-6 of each leaf's largest value where a weight norm was
  folded (``weight_g * v / ||v||``);
- the converted tree loads whole into the port module (``load_jax_params``
  raises on any parameter left unfilled), at small sizes and, for the v1
  presets' DiT, regulator and Whisper encoder, at full width.

The cases walk the converters' branches: the DiT's WaveNet and MLP heads,
``style_as_token``, the U-ViT skips, DDP's ``module.`` prefix; the
regulator's continuous, discrete and F0 branches; CAMPPlus's legacy keys;
both weight-norm layouts of the SSL encoders' positional conv (and none);
the v2 regulator's synthesised identity ``out_proj``; the file wrappers
(``generator``, ``model``, ``net``, ``estimator.``).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import torch_ref_checkpoints as W
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params

torch.set_num_threads(1)
FOLD_RTOL = 1e-6


def side(pkg: str, name: str):
    """``seedvc_tpu_torch.<name>`` ("port") or ``seedvc_tpu.<name>`` ("jax")."""
    return importlib.import_module(f"{'seedvc_tpu_torch' if pkg == 'port' else 'seedvc_tpu'}.{name}")


def assert_identical(a: dict, b: dict):
    fa, fb = W.flat(a), W.flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        assert type(x) is type(y) is np.ndarray, k
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape, x.dtype, y.dtype)
        assert np.array_equal(x, y), (k, float(np.abs(x - y).max()))


def unused(tree: dict) -> set:
    """Paths of a converted tree that a time-as-token DiT does not hold:
    each unconditioned norm's ``project_layer`` (``load_jax_params`` skips
    them, as flax ignores them)."""
    return {k for k in W.flat(tree) if "/project_layer/" in k}


def assert_round_trip(got: dict, tree: dict):
    fg, ft = W.flat(got), W.flat(tree)
    extra = set(fg) - set(ft)
    assert extra <= unused(got), sorted(extra - unused(got))[:4]
    fg = {k: v for k, v in fg.items() if k not in extra}
    assert sorted(fg) == sorted(ft)
    for k in fg:
        x, y = np.asarray(fg[k]), np.asarray(ft[k])
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape)
        scale = float(np.abs(y).max()) if y.size else 0.0
        assert np.abs(x - y).max(initial=0.0) <= FOLD_RTOL * scale, k


# ---------------------------------------------------------------------------
# cases: (build(pkg) -> module, cfg args(pkg), write(tree) -> state dict,
#         converter module, converter function)
def _mp(pkg, dit=None, reg=None):
    c = side(pkg, "core.config")
    d = dict(hidden_dim=64, num_heads=4, depth=5, in_channels=8, final_layer_type="wavenet",
             content_dim=16, long_skip_connection=True, uvit_skip_connection=True)
    r = dict(channels=16, in_channels=12, sampling_ratios=(1, 1))
    return c.ModelParams(DiT=c.DiTConfig(**{**d, **(dit or {})}),
                         length_regulator=c.LengthRegulatorConfig(**{**r, **(reg or {})}),
                         wavenet=c.WavenetConfig(hidden_dim=32, num_layers=2),
                         style_encoder=c.StyleEncoderConfig(dim=24))


def vc_case(dit=None, reg=None, ddp=False):
    return (lambda: side("port", "models.vc").VCModel(_mp("port", dit, reg)),
            lambda pkg: (_mp(pkg, dit, reg),),
            lambda t: W.write_vc_checkpoint(t, ddp=ddp), "dit", "convert_vc_checkpoint")


def reg_case(**reg):
    def lr(pkg):
        return side(pkg, "core.config").LengthRegulatorConfig(**reg)

    return (lambda: side("port", "models.regulator").InterpolateRegulator(lr("port")),
            lambda pkg: (side(pkg, "core.config").ModelParams(length_regulator=lr(pkg)),),
            W.write_regulator, "dit", "convert_regulator")


def full_preset_case(name):
    def mp(pkg):
        return side(pkg, "core.config").get_preset(name).model_params

    return (lambda: side("port", "models.vc").VCModel(mp("port")), lambda pkg: (mp(pkg),),
            W.write_vc_checkpoint, "dit", "convert_vc_checkpoint")


def bigvgan_cfg(pkg, **kw):
    kw = {"upsample_initial_channel": 32, "resblock_kernel_sizes": (3, 5),
          "resblock_dilation_sizes": ((1, 3), (1, 3)), **kw}
    return side(pkg, "models.bigvgan").BigVGANConfig(**kw)


def bigvgan_case(wrapped=True, **kw):
    def write(t):
        sd = W.write_bigvgan(t)
        return sd if wrapped else sd["generator"]

    return (lambda: side("port", "models.bigvgan").BigVGAN(bigvgan_cfg("port", **kw)),
            lambda pkg: (bigvgan_cfg(pkg, **kw),), write, "bigvgan", "convert_bigvgan")


def whisper_case(prefix, full=False):
    def build():
        m = side("port", "models.whisper")
        return m.WhisperEncoder(m.WHISPER_SMALL if full else m.WhisperEncoderConfig(
            d_model=32, n_layers=2, n_heads=4, ffn_dim=64, max_positions=64))

    return (build, lambda pkg: (12 if full else 2,), lambda t: W.write_whisper(t, prefix),
            "whisper", "convert_whisper_encoder")


def hift_cfg(pkg):
    return side(pkg, "models.hifigan").HiFTConfig(
        base_channels=32, resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3),) * 2,
        source_resblock_dilation_sizes=((1, 3), (1,)))


def ssl_case(style, final_norm=True):
    def build():
        m = side("port", "models.ssl")
        return m.SSLEncoder(m.SSLConfig(conv_dim=16, d_model=32, n_layers=2, n_heads=4,
                                        ffn_dim=64, pos_conv_kernel=16, pos_conv_groups=4,
                                        apply_final_norm=final_norm))

    return build, lambda pkg: (2,), lambda t: W.write_ssl(t, style), "ssl", "convert_ssl"


def wavlm_case(style):
    def build():
        m = side("port", "models.wavlm_sv")
        return m.WavLMSV(m.WavLMSVConfig(
            conv_dim=16, d_model=48, n_layers=2, n_heads=4, ffn_dim=96, num_buckets=40,
            max_distance=80, pos_conv_kernel=16, pos_conv_groups=4,
            tdnn_dims=(24, 24, 24, 24, 48), xvector_dim=20))

    return (build, lambda pkg: (2,), lambda t: W.write_wavlm_sv(t, style), "wavlm_sv",
            "convert_wavlm_sv")


def astral_case(ddp=False):
    def write(t):
        ck = W.write_astral(t)
        if ddp:
            ck["net"] = {k: {f"module.{n}": v for n, v in sd.items()} for k, sd in ck["net"].items()}
        return ck

    def build():
        m = side("port", "models.astral")
        return m.AstralQuantizer(m.AstralConfig(dim=24, intermediate_dim=48, num_blocks=2,
                                                input_dim=32, codebook_size=8))

    return build, lambda pkg: (2,), write, "astral", "convert_astral"


def dit_v2_cfg(pkg):
    return side(pkg, "models.dit_v2").DiTV2Config(hidden_dim=32, depth=2, num_heads=4,
                                                  in_channels=80, content_dim=32,
                                                  style_encoder_dim=24)


def dit_v2_case(prefix):
    def write(t):
        sd = W.write_dit_v2(t)
        return {prefix + k[len("estimator."):]: v for k, v in sd.items()}

    return (lambda: side("port", "models.dit_v2").DiTV2(dit_v2_cfg("port")),
            lambda pkg: (dit_v2_cfg(pkg),), write, "dit_v2", "convert_dit_v2")


def reg_v2_case(identity=False, **reg):
    def build():
        m = side("port", "models.regulator").InterpolateRegulator(
            side("port", "core.config").LengthRegulatorConfig(**reg))
        if identity:
            with torch.no_grad():
                m.out_proj.weight.copy_(torch.eye(reg["channels"]))
                m.out_proj.bias.zero_()
        return m

    return (build, lambda pkg: (side(pkg, "core.config").LengthRegulatorConfig(**reg),),
            W.write_regulator_v2, "dit_v2", "convert_regulator_v2")


def ar_case():
    def build():
        m = side("port", "models.ar")
        return m.ARTransformer(m.ARConfig(dim=32, n_layer=2, n_head=4, n_local_heads=2,
                                          head_dim=8, intermediate_size=64, vocab_size=33,
                                          max_seq_len=64))

    return build, lambda pkg: (2,), W.write_ar, "ar", "convert_ar"


def openvoice_case(wrapped=True):
    def build():
        m = side("port", "models.openvoice")
        cfg = m.OpenVoiceConfig(
            spec_channels=513, inter_channels=8, hidden_channels=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(4, 4),
            upsample_initial_channel=32, upsample_kernel_sizes=(8, 8), gin_channels=12)
        conv = m.ToneColorConverter(cfg)
        m.draw_post(conv)
        return conv

    def write(t):
        ck = W.write_openvoice(t)
        return ck if wrapped else ck["model"]

    return build, lambda pkg: (), write, "openvoice", "convert_openvoice"


def plain(build, write, modname, fn, args=lambda pkg: ()):
    return build, args, write, modname, fn


def _rmvpe():
    return side("port", "models.rmvpe").RMVPE_E2E(en_out_channels=2)


def _campplus():
    return side("port", "models.campplus").CAMPPlus(feat_dim=80, embedding_size=192)


CASES = {
    "dit_wavenet_uvit": vc_case(),
    "dit_mlp": vc_case(dit=dict(final_layer_type="mlp", long_skip_connection=False)),
    "dit_style_as_token_no_uvit": vc_case(dit=dict(style_as_token=True, time_as_token=True,
                                                   uvit_skip_connection=False)),
    "dit_ddp_prefix": vc_case(ddp=True),
    "dit_full_whisper_small_wavenet": full_preset_case("whisper_small_wavenet"),
    "dit_full_xlsr_tiny": full_preset_case("xlsr_tiny"),
    "regulator_continuous": reg_case(channels=16, in_channels=12, sampling_ratios=(1, 1)),
    "regulator_discrete_codebooks": reg_case(channels=16, is_discrete=True,
                                             content_codebook_size=10, n_codebooks=3,
                                             sampling_ratios=(1,)),
    "regulator_f0": reg_case(channels=16, in_channels=12, sampling_ratios=(1, 1, 1, 1),
                             f0_condition=True, n_f0_bins=32),
    "campplus": plain(_campplus, W.write_campplus, "campplus", "convert_campplus"),
    "campplus_legacy_keys": plain(_campplus, lambda t: W.write_campplus(t, legacy=True),
                                  "campplus", "convert_campplus"),
    "bigvgan_22k": bigvgan_case(),
    "bigvgan_44k_unwrapped": bigvgan_case(False, num_mels=128, upsample_rates=(8, 4, 2, 2, 2, 2),
                                          upsample_kernel_sizes=(16, 8, 4, 4, 4, 4)),
    "whisper_hf_prefix": whisper_case("encoder."),
    "whisper_bare": whisper_case(""),
    "whisper_full_small": whisper_case("encoder.", full=True),
    "rmvpe": plain(_rmvpe, W.write_rmvpe, "rmvpe", "convert_rmvpe"),
    "hift": (lambda: side("port", "models.hifigan").HiFTGenerator(hift_cfg("port")),
             lambda pkg: (hift_cfg(pkg),), W.write_hift, "hifigan", "convert_hift"),
    "ssl_weight_g": ssl_case("weight_g"),
    "ssl_parametrizations": ssl_case("parametrizations"),
    "ssl_plain_pos_conv_no_final_norm": ssl_case(None, final_norm=False),
    "wavlm_sv_weight_g": wavlm_case("weight_g"),
    "wavlm_sv_parametrizations": wavlm_case("parametrizations"),
    "astral": astral_case(),
    "astral_ddp_prefix": astral_case(ddp=True),
    "dit_v2_estimator": dit_v2_case("estimator."),
    "dit_v2_bare": dit_v2_case(""),
    "dit_v2_ddp_prefix": dit_v2_case("module.estimator."),
    "regulator_v2_cfm": reg_v2_case(channels=32, is_discrete=True, content_codebook_size=32,
                                    sampling_ratios=(1, 1, 1, 1)),
    "regulator_v2_identity_out": reg_v2_case(True, channels=32, is_discrete=True,
                                             content_codebook_size=32,
                                             sampling_ratios=(1, 1, 1, 1)),
    "regulator_v2_ar": reg_v2_case(channels=32, is_discrete=True, content_codebook_size=8,
                                   sampling_ratios=()),
    "ar": ar_case(),
    "openvoice": openvoice_case(),
    "openvoice_unwrapped": openvoice_case(False),
}


@functools.lru_cache(maxsize=1)
def converted(case: str):
    """(exported tree, port's tree, JAX's tree) of a case."""
    build, args, write, modname, fn = CASES[case]
    torch.manual_seed(0)
    tree = to_jax_params(build())
    sd = write(tree)
    port = getattr(side("port", f"convert.{modname}"), fn)(sd, *args("port"))
    ref = getattr(side("jax", f"convert.{modname}"), fn)(sd, *args("jax"))
    return tree, port, ref


def check_port_matches_jax(case):
    _, port, ref = converted(case)
    assert_identical(port, ref)


def check_writer_round_trips_through_jax(case):
    tree, _, ref = converted(case)
    assert_round_trip(ref, tree)


def check_converted_tree_loads_into_port(case):
    _, port, _ = converted(case)
    torch.manual_seed(1)
    module = CASES[case][0]()
    load_jax_params(module, port)
    assert_round_trip(port, to_jax_params(module))


CHECKS = {"port_matches_jax": check_port_matches_jax,
          "writer_round_trips": check_writer_round_trips_through_jax,
          "loads_into_port": check_converted_tree_loads_into_port}


# each case's three checks in a row, so that one conversion serves them
@pytest.mark.parametrize("case,check", [(c, k) for c in CASES for k in CHECKS],
                         ids=[f"{c}-{k}" for c in CASES for k in CHECKS])
def test_converter(case, check):
    CHECKS[check](case)


def test_identity_out_proj_is_not_written():
    """The v2 regulator's identity ``out_proj`` is the reference's
    ``nn.Identity``: no weights in the file, synthesised back by both
    converters."""
    build, args, write, modname, fn = CASES["regulator_v2_identity_out"]
    sd = write(to_jax_params(build()))
    assert not any(k.startswith("model.12.") for k in sd)
    _, port, _ = converted("regulator_v2_identity_out")
    assert np.array_equal(port["out_proj"]["kernel"], np.eye(32, dtype=np.float32))


def test_ema_is_positional_without_input_pos():
    """``ema_of`` lists each state dict's tensors in order, ``input_pos`` left
    out, as the CLI's ``--use-ema`` reads them."""
    build, *_ = CASES["dit_wavenet_uvit"]
    ck = W.write_vc_checkpoint(to_jax_params(build()), to_jax_params(build()))
    for key, sd in ck["net"].items():
        names = [n for n in sd if "input_pos" not in n]
        assert len(ck["ema"][key][0]) == len(names)
    assert "estimator.input_pos" in ck["net"]["cfm"]


def test_bf16_tensor_raises_on_both_sides():
    """numpy has no bf16: both packages' ``_np`` raise on it, and neither
    casts silently."""
    t = torch.ones(2, dtype=torch.bfloat16)
    for pkg in ("port", "jax"):
        with pytest.raises(TypeError):
            side(pkg, "convert.torch_utils")._np(t)
