"""``apps.convert_checkpoint`` end to end on the CPU, the port's beside the
JAX package's, and the ``.safetensors`` reader.

Both CLIs' preset lookups (``get_preset``, ``V2Config``, ``BIGVGAN_22K_80``)
are patched to the same tiny configs; Whisper keeps the CLI's fixed 12
layers and HuBERT its 18, at narrow width; ASTRAL its 12 blocks. One set of
reference-layout files is written from port modules built from a seed
(``tests/torch_ref_checkpoints.py``), then:

- for the v1 flags, ``--use-ema`` (with ``--hift``) and the v2 flags, the
  two CLIs write the same ``.pkl`` files, byte for byte, and print the same
  lines;
- ``--use-ema`` gives the EMA's tensors, not the net's;
- ``apps.infer --checkpoint-dir <the port's output> --device cpu`` writes
  the wave of a ``VoiceConverter`` given those trees in memory, and a DiT
  weight changed in the ``.pth`` changes it; a key missing from the
  ``.pth`` stops both CLIs with that key's name.
"""

import dataclasses
import json
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import torch_ref_checkpoints as W
from seedvc_tpu_torch.convert.torch_utils import load_safetensors
from seedvc_tpu_torch.weights import to_jax_params
from test_torch_convert import assert_identical, assert_round_trip, side

torch.set_num_threads(1)
WHISPER = dict(d_model=32, n_layers=12, n_heads=4, ffn_dim=64)
BIGVGAN = dict(upsample_initial_channel=64, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1,),))


def v1_cfg(pkg):
    c = side(pkg, "core.config")
    return c.SeedVCConfig(model_params=c.ModelParams(
        length_regulator=c.LengthRegulatorConfig(channels=32, in_channels=WHISPER["d_model"],
                                                 sampling_ratios=(1, 1)),
        DiT=c.DiTConfig(hidden_dim=64, num_heads=2, depth=3, content_dim=32,
                        final_layer_type="wavenet", long_skip_connection=True,
                        uvit_skip_connection=True),
        wavenet=c.WavenetConfig(hidden_dim=32, num_layers=2)))


def v2_cfg(pkg):
    dit = side(pkg, "models.dit_v2").DiTV2Config(hidden_dim=32, depth=2, num_heads=4,
                                                 content_dim=32, style_encoder_dim=192)
    ar = side(pkg, "models.ar").ARConfig(dim=32, n_layer=2, n_head=4, n_local_heads=2,
                                         head_dim=8, intermediate_size=64, vocab_size=33,
                                         max_seq_len=64)
    ssl = side(pkg, "models.ssl").SSLConfig(conv_dim=16, d_model=32, n_layers=18, n_heads=4,
                                            ffn_dim=64, pos_conv_kernel=16, pos_conv_groups=4)
    astral = side(pkg, "models.astral").AstralConfig
    return side(pkg, "pipelines.convert_v2").V2Config(
        dit=dit, ar=ar, ssl=ssl, wide=astral(dim=16, intermediate_dim=32, input_dim=32),
        narrow=astral(dim=16, intermediate_dim=32, input_dim=32, codebook_size=8))


def bigvgan_cfg(pkg):
    return side(pkg, "models.bigvgan").BigVGANConfig(**BIGVGAN)


@pytest.fixture
def tiny_presets(monkeypatch):
    """Both packages' CLIs look up the tiny configs."""
    for pkg in ("port", "jax"):
        v1, v2, voc = v1_cfg(pkg), v2_cfg(pkg), bigvgan_cfg(pkg)
        monkeypatch.setattr(side(pkg, "core.config"), "get_preset", lambda name, c=v1: c)
        monkeypatch.setattr(side(pkg, "pipelines.convert_v2"), "V2Config", lambda c=v2: c)
        monkeypatch.setattr(side(pkg, "models.bigvgan"), "BIGVGAN_22K_80", voc)


def port_trees() -> tuple[dict, dict]:
    """Every tree the CLI converts, from port modules built from seed 0 at
    the tiny configs, and an EMA of the DiT checkpoint that differs from it."""
    from seedvc_tpu_torch.core.config import LengthRegulatorConfig
    from seedvc_tpu_torch.models import (ar, astral, bigvgan, campplus, dit_v2, hifigan,
                                         openvoice, regulator, rmvpe, ssl, vc, wavlm_sv,
                                         whisper)

    v1, v2 = v1_cfg("port"), v2_cfg("port")
    ov = openvoice.OpenVoiceConfig(
        spec_channels=513, inter_channels=8, hidden_channels=16, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(4, 4),
        upsample_initial_channel=32, upsample_kernel_sizes=(8, 8), gin_channels=12)
    torch.manual_seed(0)
    modules = {
        "vc": vc.VCModel(v1.model_params),
        "campplus": campplus.CAMPPlus(feat_dim=80, embedding_size=192),
        "vocoder": bigvgan.BigVGAN(bigvgan_cfg("port")),
        "whisper": whisper.WhisperEncoder(whisper.WhisperEncoderConfig(**WHISPER)),
        "rmvpe": rmvpe.RMVPE_E2E(en_out_channels=2),
        "hift": hifigan.HiFTGenerator(hifigan.HiFTConfig(base_channels=16)),
        "openvoice": openvoice.draw_post(openvoice.ToneColorConverter(ov)),
        "wavlm_sv": wavlm_sv.WavLMSV(wavlm_sv.WavLMSVConfig(
            conv_dim=16, d_model=32, n_heads=4, ffn_dim=64, pos_conv_kernel=16,
            pos_conv_groups=4, tdnn_dims=(16, 16, 16, 16, 32), xvector_dim=16)),
        "narrow": astral.AstralQuantizer(v2.narrow),
        "wide": astral.AstralQuantizer(v2.wide),
        "ssl": ssl.SSLEncoder(v2.ssl),
        "dit": dit_v2.DiTV2(v2.dit),
        "cfm_reg": regulator.InterpolateRegulator(LengthRegulatorConfig(
            channels=v2.dit.content_dim, is_discrete=True,
            content_codebook_size=v2.wide.codebook_size, sampling_ratios=(1, 1, 1, 1))),
        "ar": ar.ARTransformer(v2.ar),
        "ar_reg": regulator.InterpolateRegulator(LengthRegulatorConfig(
            channels=v2.ar.dim, is_discrete=True, content_codebook_size=v2.narrow.codebook_size,
            sampling_ratios=())),
    }
    trees = {name: to_jax_params(m) for name, m in modules.items()}
    return trees, W.halved(trees["vc"])


V1_FLAGS = ("dit", "campplus", "bigvgan", "whisper", "rmvpe", "openvoice", "wavlm_sv")
EMA_FLAGS = ("dit", "hift")
V2_FLAGS = ("astral_narrow", "astral_wide", "v2_cfm", "v2_ar", "hubert")
RUNS = {"v1": (V1_FLAGS, ["--preset", "whisper_small_wavenet"]),
        "use_ema": (EMA_FLAGS, ["--use-ema"]), "v2": (V2_FLAGS, [])}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    trees, ema = port_trees()
    paths = W.write_zoo(str(tmp_path_factory.mktemp("zoo")), W.zoo_contents(trees, ema))
    return trees, ema, paths


def header(path: str) -> dict:
    """A ``.safetensors`` file's JSON header."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def run_cli(pkg: str, out: str, paths: dict, flags, extra, capsys) -> list:
    """One CLI's ``main`` on ``flags``' files; its printed lines, with the
    output directory as ``<out>``."""
    main = side(pkg, "apps.convert_checkpoint").main
    capsys.readouterr()
    main(["--out", out, *W.cli_args({f: paths[f] for f in flags}), *extra])
    return capsys.readouterr().out.replace(out, "<out>").splitlines()


def read_pkls(out: str) -> dict:
    trees = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as f:
            trees[name] = pickle.load(f)
    return trees


@pytest.mark.parametrize("run", RUNS)
def test_both_clis_write_the_same_pkls(run, zoo, tmp_path, tiny_presets, capsys):
    _, _, paths = zoo
    flags, extra = RUNS[run]
    lines = {pkg: run_cli(pkg, str(tmp_path / pkg), paths, flags, extra, capsys)
             for pkg in ("jax", "port")}
    assert lines["port"] == lines["jax"] and len(lines["port"]) >= len(flags)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    port, ref = read_pkls(str(tmp_path / "port")), read_pkls(str(tmp_path / "jax"))
    for name in names:
        assert_identical(port[name], ref[name])
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_converted_trees_are_the_written_ones(zoo, tmp_path, tiny_presets, capsys):
    """The port's CLI gives back every exported tree (exact, or to 1e-6 where
    a weight norm was folded); with ``--use-ema`` the EMA's."""
    trees, ema, paths = zoo
    for run, (flags, extra) in RUNS.items():
        run_cli("port", str(tmp_path / run), paths, flags, extra, capsys)
    got = {**read_pkls(str(tmp_path / "v1")), **read_pkls(str(tmp_path / "v2"))}
    for name, tree in trees.items():
        if name != "hift":
            assert_round_trip(got[f"{name}.pkl"], tree)
    with_ema = read_pkls(str(tmp_path / "use_ema"))
    assert_round_trip(with_ema["vc.pkl"], ema)
    assert_round_trip(with_ema["vocoder.pkl"], trees["hift"])
    a = with_ema["vc.pkl"]["cfm"]["estimator"]["cond_projection"]["kernel"]
    assert not np.array_equal(a, got["vc.pkl"]["cfm"]["estimator"]["cond_projection"]["kernel"])


# ---------------------------------------------------------------------------
# the converted directory through apps.infer
def tiny_converter(monkeypatch):
    """``apps.infer`` builds the tiny Whisper and BigVGAN at a short context."""
    from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
    from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
    from seedvc_tpu_torch.pipelines import convert

    real = convert.VoiceConverter

    def build(cfg, **kw):
        return real(cfg, whisper_cfg=WhisperEncoderConfig(**WHISPER),
                    vocoder_cfg=BigVGANConfig(**BIGVGAN), prompt_cap_frames=64,
                    context_frames=192, **kw)

    monkeypatch.setattr(convert, "VoiceConverter", build)
    return build


def wav_pair(d):
    from seedvc_tpu_torch.apps.audio_io import save_wav

    t = np.arange(16000) / 16000
    paths = str(d / "s.wav"), str(d / "r.wav")
    save_wav(paths[0], (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), 16000)
    save_wav(paths[1], (0.3 * np.sin(2 * np.pi * 240 * t[:8000])).astype(np.float32), 16000)
    return paths


def infer_wave(ckpt_dir: str, out: str, src: str, ref: str) -> np.ndarray:
    from seedvc_tpu_torch.apps import infer
    from seedvc_tpu_torch.apps.audio_io import load_wav

    infer.main(["--source", src, "--target", ref, "--output", out, "--checkpoint-dir", ckpt_dir,
                "--diffusion-steps", "2", "--device", "cpu"])
    (name,) = os.listdir(out)
    return load_wav(os.path.join(out, name))[0]


def memory_wave(build, trees: dict, src: str, ref: str, tmp) -> np.ndarray:
    """The same conversion by a converter given ``trees`` in memory, through
    the CLI's wav writer and reader."""
    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav

    vc = build(v1_cfg("port"), seed=0, device="cpu",
               **{f"{n}_params": trees[n] for n in ("vc", "whisper", "campplus", "vocoder")})
    s, s_sr = load_wav(src)
    r, r_sr = load_wav(ref)
    sr, wave, _ = vc.convert(s, s_sr, r, r_sr, diffusion_steps=2, cfg_rate=0.7, seed=0)
    save_wav(str(tmp / "memory.wav"), wave, sr)
    return load_wav(str(tmp / "memory.wav"))[0]


def test_infer_from_converted_dir_is_the_memory_converter(zoo, tmp_path, tiny_presets, capsys,
                                                          monkeypatch):
    trees, _, paths = zoo
    build = tiny_converter(monkeypatch)
    out = str(tmp_path / "ckpt")
    run_cli("port", out, paths, V1_FLAGS[:4], [], capsys)
    src, ref = wav_pair(tmp_path)
    got = infer_wave(out, str(tmp_path / "out"), src, ref)
    converted = {name[:-4]: tree for name, tree in read_pkls(out).items()}
    want = memory_wave(build, converted, src, ref, tmp_path)
    assert got.shape == want.shape and np.isfinite(got).all() and np.abs(got).max() > 0
    assert np.array_equal(got, want)

    # a planted fault: one DiT weight changed in the .pth changes the wave
    ckpt = torch.load(paths["dit"], weights_only=False)
    ckpt["net"]["cfm"]["estimator.conv2.weight"][0, 0, 0] += 1.0
    torch.save(ckpt, tmp_path / "changed.pth")
    run_cli("port", out, {**paths, "dit": str(tmp_path / "changed.pth")}, ("dit",), [], capsys)
    changed = infer_wave(out, str(tmp_path / "out2"), src, ref)
    assert np.abs(changed - want).max() > 1 / 32768


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_missing_key_stops_the_cli_naming_it(pkg, zoo, tmp_path, tiny_presets, capsys):
    _, _, paths = zoo
    ckpt = torch.load(paths["dit"], weights_only=False)
    del ckpt["net"]["cfm"]["estimator.transformer.layers.1.attention.wo.weight"]
    torch.save(ckpt, tmp_path / "missing.pth")
    with pytest.raises(KeyError, match="transformer.layers.1.attention.wo.weight"):
        run_cli(pkg, str(tmp_path / "out"), {"dit": str(tmp_path / "missing.pth")}, ("dit",),
                [], capsys)


# ---------------------------------------------------------------------------
# the .safetensors reader and writer
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}


def tensors_of(dtype) -> dict:
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    else:
        make = lambda *s: torch.randint(-2 ** 40, 2 ** 40, s, generator=g)  # noqa: E731
    return {"a.weight": make(3, 5), "b": make(7), "scalar": make(), "empty": make(0, 4),
            "odd.bias": make(1)}


@pytest.mark.parametrize("name", DTYPES)
def test_reader_reads_the_package_file(name, tmp_path):
    from safetensors.torch import save_file

    want = tensors_of(DTYPES[name])
    save_file(want, str(tmp_path / "x.safetensors"), metadata={"format": "pt", "k": "v"})
    got = load_safetensors(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v)
    assert header(str(tmp_path / "x.safetensors"))["__metadata__"] == {"format": "pt", "k": "v"}


@pytest.mark.parametrize("name", DTYPES)
def test_writer_file_reads_in_the_package(name, tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    want = tensors_of(DTYPES[name])
    W.save_safetensors(want, str(tmp_path / "x.safetensors"), {"format": "pt"})
    for got in (load_file(str(tmp_path / "x.safetensors")),
                load_safetensors(str(tmp_path / "x.safetensors"))):
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], v) and got[k].dtype == v.dtype for k, v in want.items())
    with safe_open(str(tmp_path / "x.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_reader_refuses_offsets_that_do_not_fit(tmp_path):
    W.save_safetensors({"a": torch.ones(4)}, str(tmp_path / "x.safetensors"))
    raw = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "bad.safetensors").write_bytes(raw.replace(b'"shape":[4]', b'"shape":[5]'))
    with pytest.raises(ValueError, match="do not fit"):
        load_safetensors(str(tmp_path / "bad.safetensors"))


def test_config_patch_reaches_both_clis(tiny_presets):
    """The fixture's patches are what the CLIs' lazy imports see."""
    for pkg in ("port", "jax"):
        assert side(pkg, "core.config").get_preset("x").model_params.DiT.depth == 3
        assert dataclasses.asdict(side(pkg, "pipelines.convert_v2").V2Config().ssl)[
            "n_layers"] == 18


def test_reader_copies_a_tensor_off_its_alignment(tmp_path):
    """The writer packs tensors in name order, so an f32 after three f16s
    starts at byte 6; the reader copies it out rather than view it."""
    want = {"a": torch.arange(3, dtype=torch.float16), "b": torch.tensor([1.5, -2.0])}
    W.save_safetensors(want, str(tmp_path / "x.safetensors"))
    assert header(str(tmp_path / "x.safetensors"))["b"]["data_offsets"] == [6, 14]
    got = load_safetensors(str(tmp_path / "x.safetensors"))
    assert all(torch.equal(got[k], v) for k, v in want.items())
