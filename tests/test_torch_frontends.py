"""The port's v1 front ends: ``pipelines/wrapper.py`` (``SeedVCWrapper``,
``load_params_dir``) and the CLI ``python -m seedvc_tpu_torch.apps.infer``,
on the CPU. Mirrors tests/test_pipeline.py::test_seed_vc_wrapper_facade and
tests/test_apps_frontends.py::test_infer_cli_svc_flags_plumb_through, plus
one real CLI run on a tiny F0-conditioned config."""

import pickle

import numpy as np
import pytest
import torch

import seedvc_tpu_torch.core.config as config_mod
import seedvc_tpu_torch.pipelines.convert as convert_mod
import seedvc_tpu_torch.pipelines.wrapper as wrapper_mod
from seedvc_tpu_torch.apps import infer
from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav, scan_audio_files
from seedvc_tpu_torch.core import config as pc
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.rmvpe import RMVPE, RMVPE_E2E
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig

torch.set_num_threads(1)


def test_wrapper_builds_one_converter_per_f0_mode_lazily(monkeypatch):
    built = []

    class FakeConverter:
        sr = 22050

        def __init__(self, cfg, **kw):
            built.append((cfg.model_params.DiT.f0_condition, cfg.sr, kw["device"].type))

        def convert_with_streaming(self, *a, **kw):
            assert kw["cfg_rate"] == 0.5 and kw["pitch_shift"] == 3.0
            yield 22050, np.ones(100, np.float32), {"rtf": 0.1}
            yield 22050, np.ones(50, np.float32), {"rtf": 0.2}

    monkeypatch.setattr(wrapper_mod, "VoiceConverter", FakeConverter)
    wrap = wrapper_mod.SeedVCWrapper(device="cpu")
    assert built == []
    kw = dict(inference_cfg_rate=0.5, pitch_shift=3.0)
    chunks = list(wrap.convert_voice(np.zeros(10), 22050, np.zeros(10), 22050,
                                     f0_condition=False, **kw))
    assert len(chunks) == 2 and built == [(False, 22050, "cpu")]
    (sr, out, stats), = wrap.convert_voice(np.zeros(10), 22050, np.zeros(10), 22050,
                                           f0_condition=False, stream_output=False, **kw)
    assert len(out) == 150 and stats == {"rtf": 0.2} and built == [(False, 22050, "cpu")]
    list(wrap.convert_voice(np.zeros(10), 22050, np.zeros(10), 22050, f0_condition=True, **kw))
    list(wrap.convert_voice(np.zeros(10), 22050, np.zeros(10), 22050, f0_condition=True, **kw))
    assert built == [(False, 22050, "cpu"), (True, 44100, "cpu")]


def test_load_params_dir_reads_numpy_pickles(tmp_path):
    trees = {"vc": {"cfm": {"w": np.ones((2, 3), np.float32)}},
             "rmvpe": {"fc_linear": {"bias": np.zeros(360, np.float32)}}}
    for name, tree in trees.items():
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(tree, f)
    params = wrapper_mod.load_params_dir(str(tmp_path))
    assert sorted(params) == ["rmvpe_params", "vc_params"]
    np.testing.assert_array_equal(params["vc_params"]["cfm"]["w"], trees["vc"]["cfm"]["w"])
    assert wrapper_mod.load_params_dir(None) == {}


def _wavs(tmp_path, src_s=1.0, ref_s=0.5, sr=16000):
    t = np.arange(int(src_s * sr)) / sr
    src = (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    ref = (0.3 * np.sin(2 * np.pi * 240 * t[: int(ref_s * sr)])).astype(np.float32)
    paths = str(tmp_path / "s.wav"), str(tmp_path / "r.wav")
    save_wav(paths[0], src, sr)
    save_wav(paths[1], ref, sr)
    return paths


def test_infer_cli_svc_flags_plumb_through(tmp_path, monkeypatch):
    """--f0-condition switches a non-F0 preset to whisper_base_f0_44k, and
    --auto-f0-adjust / --semi-tone-shift / --compute-dtype / --device reach
    the converter."""
    seen = {}

    class StubConverter:
        def __init__(self, cfg, **kw):
            seen.update(sr=cfg.preprocess_params.sr, **kw)

        def convert(self, src, src_sr, ref, ref_sr, **kw):
            seen.update(kw)
            return 44100, np.zeros(100, np.float32), {
                "rtf": 0.0, "audio_seconds": 0.0, "wall_seconds": 0.0,
                "chunks": 1, "stages": {"f0": {"seconds": 0.1, "calls": 1}}}

    monkeypatch.setattr(convert_mod, "VoiceConverter", StubConverter)
    src, ref = _wavs(tmp_path)
    infer.main(["--source", src, "--target", ref, "--output", str(tmp_path / "out"),
                "--f0-condition", "true", "--auto-f0-adjust", "true",
                "--semi-tone-shift", "2.0", "--compute-dtype", "float32",
                "--device", "cpu", "--profile"])
    assert seen["sr"] == 44100
    assert seen["auto_f0_adjust"] is True and seen["pitch_shift"] == 2.0
    assert seen["compute_dtype"] is torch.float32 and seen["device"] == "cpu"
    assert seen["profile"] is True
    (out,) = scan_audio_files(str(tmp_path / "out"))
    assert out.endswith("vc_s_r_1.0_25_0.7.wav")


def _tiny_f0_cfg() -> pc.SeedVCConfig:
    """tests_helpers_tiny.tiny_f0_cfg() in the port's classes."""
    return pc.SeedVCConfig(
        preprocess_params=pc.PreprocessConfig(sr=22050, spect_params=pc.SpectConfig(
            n_fft=1024, win_length=1024, hop_length=256, n_mels=80)),
        model_params=pc.ModelParams(
            length_regulator=pc.LengthRegulatorConfig(
                channels=32, is_discrete=False, in_channels=48, sampling_ratios=(1,),
                f0_condition=True, n_f0_bins=64),
            DiT=pc.DiTConfig(hidden_dim=32, num_heads=4, depth=2, in_channels=80,
                             final_layer_type="mlp", content_dim=32,
                             long_skip_connection=False, uvit_skip_connection=False,
                             f0_condition=True, n_f0_bins=64),
            wavenet=pc.WavenetConfig(hidden_dim=32, num_layers=1)))


def test_infer_cli_real_cpu_run(tmp_path, monkeypatch, capsys):
    """One real ``--device cpu`` SVC conversion through the CLI on a tiny
    config (tiny Whisper, BigVGAN and a reduced RMVPE): the wav it writes is
    at the config's rate, as long as the source's whole mel frames."""
    real = convert_mod.VoiceConverter

    def tiny(cfg, **kw):
        vc = real(cfg, whisper_cfg=WhisperEncoderConfig(d_model=48, n_layers=1, n_heads=4,
                                                        ffn_dim=96),
                  vocoder_cfg=BigVGANConfig(upsample_initial_channel=64,
                                            resblock_kernel_sizes=(3,),
                                            resblock_dilation_sizes=((1,),)),
                  prompt_cap_frames=64, context_frames=192, **kw)
        torch.manual_seed(0)
        vc.rmvpe = RMVPE(RMVPE_E2E(n_blocks=1, en_de_layers=2, inter_layers=1,
                                   en_out_channels=4).eval())
        return vc

    monkeypatch.setattr(config_mod, "get_preset", lambda name: _tiny_f0_cfg())
    monkeypatch.setattr(convert_mod, "VoiceConverter", tiny)
    src, ref = _wavs(tmp_path, src_s=1.0, ref_s=0.5)
    infer.main(["--source", src, "--target", ref, "--output", str(tmp_path / "out"),
                "--f0-condition", "true", "--auto-f0-adjust", "true",
                "--semi-tone-shift", "2", "--diffusion-steps", "2", "--device", "cpu",
                "--profile"])
    printed = capsys.readouterr().out
    assert "RTF:" in printed and "saved:" in printed and " f0 " in printed
    (out,) = scan_audio_files(str(tmp_path / "out"))
    wave, sr = load_wav(out)
    n_22k = len(convert_mod.resample_host(load_wav(src)[0], 16000, 22050))
    assert sr == 22050 and len(wave) == n_22k // 256 * 256
    assert np.isfinite(wave).all() and np.abs(wave).max() > 0


def test_scan_audio_files(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "empty").mkdir()
    for name in ("a/x.WAV", "b.flac", "c.txt", "a/d.mp3"):
        (tmp_path / name).write_bytes(b"")
    assert [p[len(str(tmp_path)) + 1:] for p in scan_audio_files(str(tmp_path))] == [
        "a/d.mp3", "a/x.WAV", "b.flac"]
    with pytest.raises(AssertionError, match="No audio files"):
        scan_audio_files(str(tmp_path / "empty"))
