"""The port's evaluation harness (``apps/metrics.py``, ``apps/baselines.py``,
``apps/eval.py``) against the JAX package's, on the CPU.

- metrics: edit distances, WER/CER, the P.808 mel features, DNSMOS's score
  over a stub ONNX session, F0 metrics and SECS equal the JAX functions';
- ``CommandBaseline`` and ``get_baseline``;
- ``OpenVoiceBaseline`` against the JAX adapter on one tiny random tree
  (tests/test_openvoice.py's config), the port fed JAX's ``PRNGKey(0)``
  noise through its ``noise_fn`` seam;
- ``eval.main`` end to end on the port with a tiny converter, stub ASR and
  DNSMOS, cache and resume, the WavLM extractor (tiny, from a pkl) and the
  OpenVoice baseline;
- ``eval.main`` of the port and of the JAX package on the same tiny trees
  (tests/test_torch_pipeline.py's converter) and the same CFM noise: the
  same ``results.json`` keys and SECS rows.

Tolerance: metrics 1e-6 (P.808 features 1e-5 absolute; f32 FFTs in other
orders); the baseline's wave 2e-4 absolute (1e-4 for f32 through the flow and
decoder, plus one int16 step of the written wav); SECS rows 1e-4 absolute
(the converted waves agree to one f16 step, 4.9e-4, as in
tests/test_torch_pipeline.py).
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import sys

import numpy as np
import pytest
import torch

import seedvc_tpu.apps.metrics as jmetrics
import seedvc_tpu.models.openvoice as jov
import seedvc_tpu.pipelines.convert as jconvert
import seedvc_tpu_torch.apps.metrics as pmetrics
import seedvc_tpu_torch.models.openvoice as pov
import seedvc_tpu_torch.models.wavlm_sv as pwavlm
import seedvc_tpu_torch.pipelines.convert as pconvert
from seedvc_tpu.apps import baselines as jbaselines
from seedvc_tpu.apps import eval as jeval
from seedvc_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from seedvc_tpu.models.wavlm_sv import WavLMSV as JWavLMSV
from seedvc_tpu.models.whisper import WhisperEncoderConfig as JWhisperEncoderConfig
from seedvc_tpu_torch.apps import baselines as pbaselines
from seedvc_tpu_torch.apps import eval as peval
from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from test_torch_pipeline import (CFG_RATE, CONTEXT, NOISE, PROMPT_CAP, VOC, WHISPER,
                                 _jax_params, _port_cfg)
from test_wavlm_sv import jax_cfg as wavlm_cfg
from tests_helpers_tiny import tiny_cfg
from torch_port_helpers import jax_init, ov_tiny_cfg, ov_tree

torch.set_num_threads(1)

SR = 22050
SECS_TOL, WAVE_TOL = 1e-4, 2e-4


def test_text_metrics_equal_jax():
    pairs = [("hello world", "hello word"), ("The cat, sat!", "the cat sat"), ("", "a b"),
             ("a b c d", ""), ("it's  fine", "its fine"), ("kitten", "sitting")]
    for ref, hyp in pairs:
        assert pmetrics.normalize_text(ref) == jmetrics.normalize_text(ref)
        assert pmetrics.wer(ref, hyp) == jmetrics.wer(ref, hyp)
        assert pmetrics.cer(ref, hyp) == jmetrics.cer(ref, hyp)
        assert pmetrics.edit_distance(ref, hyp) == jmetrics.edit_distance(ref, hyp)
    assert pmetrics.edit_distance("kitten", "sitting") == 3


def test_p808_f0_and_secs_equal_jax():
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(16000 * 2 + 123)).astype(np.float32)
    ref = jmetrics.p808_melspec(audio)
    got = pmetrics.p808_melspec(audio)
    assert got.shape == ref.shape == (201, 120) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    a = np.where(rng.random(300) < 0.3, 0.0, rng.uniform(80, 400, 300))
    b = np.where(rng.random(290) < 0.3, 0.0, a[:290] * rng.uniform(0.9, 1.1, 290))
    for x, y in ((a, b), (a, np.zeros(10))):
        ref, got = jmetrics.f0_metrics(x, y), pmetrics.f0_metrics(x, y)
        assert set(got) == set(ref) and got["voiced_frames"] == ref["voiced_frames"]
        np.testing.assert_allclose([got["f0_corr"], got["f0_rmse_cents"]],
                                   [ref["f0_corr"], ref["f0_rmse_cents"]], rtol=1e-12)
    e1, e2 = rng.standard_normal((1, 192)), rng.standard_normal(192)
    assert abs(peval.secs(torch.from_numpy(e1), e2) - jeval.secs(e1, e2)) < 1e-6


def test_dnsmos_scores_equal_jax():
    """The score's windows, hops, polynomial fit and P.808 features, over a
    stub session (onnxruntime is optional and not installed here)."""
    class Stub:
        def __init__(self, out):
            self.out, self.inputs = out, []

        def run(self, _names, feeds):
            self.inputs.append(feeds["input_1"])
            return [self.out(feeds["input_1"])]

    def scorer(cls):
        d = object.__new__(cls)
        d.sess = Stub(lambda x: np.array([[x.std() * 10, 3.0, x.mean() + 2.5]]))
        d.p808_sess = Stub(lambda x: np.array([[x.mean() + 3.0]]))
        return d

    wave = (0.1 * np.random.default_rng(1).standard_normal(16000 * 4)).astype(np.float32)
    jd, pd = scorer(jmetrics.DNSMOS), scorer(pmetrics.DNSMOS)
    ref, got = jd.score(wave), pd.score(wave)
    assert set(got) == set(ref) == {"sig", "bak", "ovrl", "p808"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
    # 4 s doubled to 16 s: seven 9.01 s windows at 1 s hops
    assert len(pd.sess.inputs) == len(jd.sess.inputs) == 7
    for a, b in zip(pd.sess.inputs + pd.p808_sess.inputs, jd.sess.inputs + jd.p808_sess.inputs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="onnxruntime"):
        pmetrics.DNSMOS("nowhere")
    with pytest.raises(ValueError, match="empty"):
        pd.score(np.zeros(0, np.float32))


def test_command_baseline(tmp_path):
    src = tmp_path / "a.wav"
    save_wav(str(src), np.zeros(100, np.float32), SR)
    with pytest.raises(ValueError, match="{reference}"):
        pbaselines.CommandBaseline("cp {source} {output}")
    b = pbaselines.get_baseline("command", template="cp {source} {output} # {reference}")
    out = tmp_path / "out dir" / "b.wav"
    out.parent.mkdir()
    assert b.convert(str(src), str(src), str(out)) == str(out)
    assert out.read_bytes() == src.read_bytes()
    with pytest.raises(KeyError, match="unknown baseline"):
        pbaselines.get_baseline("nope")
    with pytest.raises(RuntimeError, match="CosyVoice"):
        pbaselines.get_baseline("cosyvoice", repo_dir=str(tmp_path / "none"))
    # the checkout has no default, and a failed import leaves sys.path as it was
    with pytest.raises(ValueError, match="repo_dir"):
        pbaselines.get_baseline("cosyvoice")
    path = list(sys.path)
    with pytest.raises(RuntimeError, match="CosyVoice"):
        pbaselines.get_baseline("cosyvoice", repo_dir=str(tmp_path))
    assert sys.path == path


def tone(f0, secs, sr=SR, seed=0):
    t = np.arange(int(secs * sr)) / sr
    x = sum((0.3 / h) * np.sin(2 * np.pi * f0 * h * t) for h in (1, 2))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def ov_pkl(tmp_path_factory):
    path = tmp_path_factory.mktemp("ov") / "ov.pkl"
    with open(path, "wb") as f:
        pickle.dump(ov_tree(ov_tiny_cfg(jov), seed=6), f)
    return str(path)


@pytest.fixture
def tiny_ov(monkeypatch):
    jcfg, pcfg = ov_tiny_cfg(jov), ov_tiny_cfg(pov)
    monkeypatch.setattr(jov, "OpenVoiceConfig", lambda: jcfg)
    monkeypatch.setattr(pov, "OpenVoiceConfig", lambda: pcfg)


def test_openvoice_baseline_matches_jax(tmp_path, ov_pkl, tiny_ov):
    src, ref = tmp_path / "src.wav", tmp_path / "ref.wav"
    save_wav(str(src), tone(150, 1.0, 16000, seed=1), 16000)  # resampled to 22.05 kHz
    save_wav(str(ref), tone(230, 0.8, seed=2), SR)
    jb = jbaselines.OpenVoiceBaseline(ov_pkl)
    shapes = []

    def jax_noise(shape):  # the JAX adapter's draws: normal(PRNGKey(0), shape)
        shapes.append(shape)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), shape)))

    pb = pbaselines.OpenVoiceBaseline(ov_pkl, device="cpu", noise_fn=jax_noise)
    jb.convert(str(src), str(ref), str(tmp_path / "j.wav"))
    pb.convert(str(src), str(ref), str(tmp_path / "p.wav"))
    (jw, jsr), (pw, psr) = load_wav(str(tmp_path / "j.wav")), load_wav(str(tmp_path / "p.wav"))
    assert psr == jsr == SR and pw.shape == jw.shape and shapes[0][2] == 8
    assert np.abs(jw).max() > 1e-3
    np.testing.assert_allclose(pw, jw, rtol=0, atol=WAVE_TOL)
    # the default noise: a generator seeded 0, the same on every call
    pb.noise_fn = pbaselines.OpenVoiceBaseline(ov_pkl, device="cpu").noise_fn
    pb.convert(str(src), str(ref), str(tmp_path / "p1.wav"))
    pb.convert(str(src), str(ref), str(tmp_path / "p2.wav"))
    assert (tmp_path / "p1.wav").read_bytes() == (tmp_path / "p2.wav").read_bytes()


# ---------------------------------------------------------------------------
# eval.main

@pytest.fixture(scope="module")
def trees():
    return _jax_params(tiny_cfg())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    (root / "src").mkdir()
    (root / "tgt").mkdir()
    for i in range(2):
        save_wav(str(root / "src" / f"s{i}.wav"), tone(140 + 40 * i, 1.2, seed=i), SR)
    save_wav(str(root / "tgt" / "ref0.wav"), tone(220, 0.8, seed=9), SR)
    (root / "index.tsv").write_text("s0\thello world\ns1\tthe cat sat\n")
    return root


def port_converter(trees):
    return pconvert.VoiceConverter(_port_cfg(), whisper_cfg=WhisperEncoderConfig(**WHISPER),
                                   prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT,
                                   vocoder_cfg=BigVGANConfig(**VOC), device="cpu", **trees)


def _port_noise(shape):
    return torch.from_numpy(NOISE[: shape[1]][None])


def with_port_noise(vc, calls):
    convert = vc.convert

    def counted(*a, **kw):
        calls.append(1)
        return convert(*a, noise_fn=_port_noise, **kw)

    vc.convert = counted
    return vc


def test_eval_main_end_to_end(tmp_path, data, trees, monkeypatch, ov_pkl, tiny_ov):
    calls = []
    vc = with_port_noise(port_converter(trees), calls)
    seen = {}

    def make(cfg, device, **params):
        seen["device"] = device
        return vc

    monkeypatch.setattr(pconvert, "VoiceConverter", make)

    class StubASR:
        def __init__(self, model_dir, device):
            assert model_dir == "stub-asr"

        def transcribe(self, wave_16k):
            return "hello world"

    class StubDNSMOS:
        def __init__(self, model_dir):
            assert model_dir == "stub-dnsmos"

        def score(self, wave_16k):
            return {"sig": 3.4, "bak": 3.9, "ovrl": 3.1, "p808": 3.5}

    monkeypatch.setattr(pmetrics, "CTCTranscriber", StubASR)
    monkeypatch.setattr(pmetrics, "DNSMOS", StubDNSMOS)
    out = tmp_path / "out"
    argv = ["--source-dir", str(data / "src"), "--target-dir", str(data / "tgt"),
            "--output", str(out), "--diffusion-steps", "4", "--asr-model", "stub-asr",
            "--dnsmos-dir", "stub-dnsmos", "--transcripts", str(data / "index.tsv"),
            "--device", "cpu"]
    report = peval.main(argv)
    assert seen["device"] == "cpu" and len(calls) == 2
    with open(out / "results.json") as f:
        assert json.load(f) == report
    s = report["summary"]
    assert s["n"] == 2 and -1.0 <= s["mean_secs"] <= 1.0
    for key in ("mean_wer", "mean_cer", "mean_dnsmos_sig", "mean_dnsmos_ovrl",
                "mean_dnsmos_p808"):
        assert key in s, key
    assert sorted(r["wer"] for r in report["results"])[0] == 0.0  # s0's transcript matches
    assert sorted(p.name for p in out.glob("*.wav")) == ["ref0_s0.wav", "ref0_s1.wav"]

    # resume: the cached (int16) wavs are scored again, nothing is converted
    resumed = peval.main(argv)["results"]
    assert len(calls) == 2 and len(resumed) == 2
    for a, b in zip(resumed, report["results"]):
        assert {k: v for k, v in a.items() if k != "secs"} == \
            {k: v for k, v in b.items() if k != "secs"}
        assert abs(a["secs"] - b["secs"]) < SECS_TOL

    # the WavLM extractor (tiny, from a pkl) with CAMPPlus as the second column
    wcfg = wavlm_cfg()
    monkeypatch.setattr(pwavlm, "WAVLM_BASE_PLUS_SV",
                        pwavlm.WavLMSVConfig(**dataclasses.asdict(wcfg)))
    xv = tmp_path / "wavlm.pkl"
    with open(xv, "wb") as f:
        pickle.dump(jax_init(JWavLMSV(wcfg), jnp.zeros((1, 8000)), seed=5), f)
    wl = peval.main(argv[:6] + ["--device", "cpu", "--xvector-extractor", "wavlm",
                                "--xvector-checkpoint", str(xv)])
    assert len(calls) == 2 and set(wl["results"][0]) == {"source", "target", "secs",
                                                          "secs_campplus"}
    np.testing.assert_allclose([r["secs_campplus"] for r in wl["results"]],
                               [r["secs"] for r in resumed], rtol=0, atol=1e-6)

    # the OpenVoice baseline converts instead of the model
    ob = peval.main(["--source-dir", str(data / "src"), "--target-dir", str(data / "tgt"),
                     "--output", str(tmp_path / "ov"), "--device", "cpu",
                     "--baseline", "openvoice", "--baseline-checkpoint", ov_pkl])
    assert len(calls) == 2 and ob["summary"]["n"] == 2
    assert sorted(p.name for p in (tmp_path / "ov").glob("*.wav")) == [
        "ref0_s0.wav", "ref0_s1.wav"]


def test_eval_main_scores_like_jax(tmp_path, data, trees, monkeypatch):
    jvc = jconvert.VoiceConverter(tiny_cfg(), whisper_cfg=JWhisperEncoderConfig(**WHISPER),
                                  prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT,
                                  vocoder_cfg=JBigVGANConfig(**VOC), compute_dtype=jnp.float32,
                                  **trees)
    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **kw):
        if shape is not None and len(shape) == 3 and shape[-1] == 80:
            return jnp.asarray(NOISE[: shape[1]][None]).astype(dtype)
        return real_normal(key, shape, dtype, *a, **kw)

    j_convert = jvc.convert

    def j_noised(*a, **kw):
        monkeypatch.setattr(jax.random, "normal", fake_normal)
        try:
            return j_convert(*a, **kw)
        finally:
            monkeypatch.setattr(jax.random, "normal", real_normal)

    jvc.convert = j_noised
    monkeypatch.setattr(jconvert, "VoiceConverter", lambda cfg, **params: jvc)
    pvc = with_port_noise(port_converter(trees), [])
    monkeypatch.setattr(pconvert, "VoiceConverter", lambda cfg, device, **params: pvc)
    argv = ["--source-dir", str(data / "src"), "--target-dir", str(data / "tgt"),
            "--diffusion-steps", "4", "--inference-cfg-rate", str(CFG_RATE)]
    jeval.main(argv + ["--output", str(tmp_path / "j")])
    with open(tmp_path / "j" / "results.json") as f:
        ref = json.load(f)
    got = peval.main(argv + ["--output", str(tmp_path / "p"), "--device", "cpu"])
    assert set(got["summary"]) == set(ref["summary"])
    assert len(got["results"]) == len(ref["results"]) == 2
    for g, r in zip(got["results"], ref["results"]):
        assert set(g) == set(r)
        assert os.path.basename(g["source"]) == os.path.basename(r["source"])
        assert abs(g["secs"] - r["secs"]) < SECS_TOL, (g, r)
