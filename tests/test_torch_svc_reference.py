"""The port's F0-conditioned v1 path (the SVC presets) against the
benchmark's frozen plain reference (``vcbench/ref/models/rmvpe.py``,
``vcbench/ref/pipelines/convert_svc.py``) on the CPU, tiny sizes
(``vcbench/tests/fixtures/tiny_svc.json``), both filled from one seeded draw
by the benchmark's builder.

RMVPE's salience (U-Net, cuDNN-free ``nn.GRU`` scans, output layer) matches
the reference's, whose GRU runs as its equations frame by frame; the whole
F0-conditioned conversion matches the reference pipeline on the same audio
and noise; ``keep_intermediates`` leaves the wave bit for bit as it is (v1
and SVC) and keeps what the conversion computed; ``profile=True`` records
the ``f0`` spans and counters with no synchronise of its own.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from seedvc_tpu_torch.models.rmvpe import decode_f0
from seedvc_tpu_torch.models.regulator import f0_to_coarse
from seedvc_tpu_torch.pipelines import convert as pconv
from vcbench.builders import svc_converter, voice_converter
from vcbench.singing import singing_like

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parents[1] / "vcbench" / "tests" / "fixtures"
CFG = json.loads((FIXTURES / "tiny_svc.json").read_text())
SR = 22050
SEED = 2 ** 33 + 29
KW = dict(diffusion_steps=3, cfg_rate=0.7, auto_f0_adjust=False, pitch_shift=0.0)


@pytest.fixture(scope="module")
def pair():
    prog = svc_converter.program(CFG, torch.device("cpu"))
    ref = svc_converter.reference(CFG, torch.device("cpu"))
    svc_converter.fill(prog, CFG, SEED, "cpu")
    svc_converter.fill(ref, CFG, SEED, "cpu")
    return prog, ref


def _sung(seconds, seed):
    return singing_like(seconds, SR, np.random.default_rng(seed))


def _noise_fn(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda shape: torch.randn(shape, generator=g)


@pytest.mark.parametrize("seconds", [0.7, 2.3])
def test_rmvpe_salience_matches_the_reference(pair, seconds):
    """The same filled weights: the port's salience (``nn.GRU``) against the
    reference's (the GRU's equations frame by frame), over every frame."""
    prog, ref = pair
    w16 = pconv.resample_host(_sung(seconds, 3), SR, 16000)
    got = prog.rmvpe.salience(w16[None])[0].numpy()
    want = ref.salience(w16)
    assert got.shape == want.shape == (1 + len(w16) // 160, 360)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    f0 = decode_f0(got)
    assert 0 < (f0 > 1).mean() and len(np.unique(f0[f0 > 1])) > 1  # voiced and moving


@pytest.mark.parametrize("auto,shift", [(False, 0.0), (True, -3.0)])
def test_svc_conversion_matches_the_reference_pipeline(pair, auto, shift):
    prog, ref = pair
    src, refw = _sung(2.6, 5), _sung(1.2, 6)
    kw = dict(KW, auto_f0_adjust=auto, pitch_shift=shift)
    _, wave, stats = prog.convert(src, SR, refw, SR, noise_fn=_noise_fn(4),
                                  keep_intermediates=True, **kw)
    info = {}
    _, want, _ = ref.convert(src, SR, refw, SR, noise_fn=_noise_fn(4), info=info, **kw)
    assert len(wave) == len(want) > 0
    np.testing.assert_allclose(wave, want, atol=2e-3)
    kept = stats["kept"]
    _, _, src16, ref16 = ref.prepared(src, SR, refw, SR)
    from vcbench.ref.models.rmvpe import decode_f0 as ref_decode
    from vcbench.ref.pipelines.convert_svc import shift_f0
    f0_ori = ref_decode(ref.salience(ref16))
    np.testing.assert_allclose(kept["f0"]["reference"], f0_ori, rtol=1e-5)
    np.testing.assert_allclose(
        kept["f0"]["source"], shift_f0(ref_decode(ref.salience(src16)), f0_ori, auto, shift),
        rtol=1e-5)
    for c in ("cond", "prompt_cond"):
        torch.testing.assert_close(kept[c], info[c], rtol=1e-4, atol=1e-5)


def test_the_kept_intermediates_are_the_conversions(pair):
    """Keeping changes nothing of the conversion; the coarse bins are the
    regulator's of the kept F0; the reference regulator on the kept
    features and the F0 decoded from the kept salience gives the kept
    conditions back."""
    prog, ref = pair
    src, refw = _sung(2.1, 7), _sung(1.0, 8)
    _, plain, _ = prog.convert(src, SR, refw, SR, noise_fn=_noise_fn(2), **KW)
    _, wave, stats = prog.convert(src, SR, refw, SR, noise_fn=_noise_fn(2),
                                  keep_intermediates=True, **KW)
    np.testing.assert_array_equal(wave, plain)
    kept = stats["kept"]
    n_bins = CFG["preset"]["model_params"]["length_regulator"]["n_f0_bins"]
    for side in ("source", "reference"):
        f0 = torch.from_numpy(kept["f0"][side])
        assert torch.equal(kept["coarse"][side], f0_to_coarse(f0, n_bins).clamp(0, n_bins - 1))
        assert len(kept["salience"][side]) == len(kept["f0"][side])
    f0_ori = decode_f0(kept["salience"]["reference"])
    f0_alt = decode_f0(kept["salience"]["source"])
    target_len, p_len = kept["cond"].shape[1], kept["prompt_cond"].shape[1]
    for c, feats, f0, n in (("cond", "source", f0_alt, target_len),
                            ("prompt_cond", "reference", f0_ori, p_len)):
        want = ref.regulate_f0(kept["features"][feats], n, f0)
        torch.testing.assert_close(kept[c], want, rtol=1e-5, atol=1e-6)


def test_v1_keep_intermediates_leaves_the_wave_bit_for_bit():
    cfg = json.loads((FIXTURES / "tiny_v1.json").read_text())
    conv = voice_converter.program(cfg, torch.device("cpu"))
    voice_converter.fill(conv, cfg, 11, "cpu")
    src, refw = _sung(1.7, 9), _sung(1.0, 10)
    _, plain, _ = conv.convert(src, SR, refw, SR, noise_fn=_noise_fn(3), diffusion_steps=2)
    _, wave, stats = conv.convert(src, SR, refw, SR, noise_fn=_noise_fn(3), diffusion_steps=2,
                                  keep_intermediates=True)
    np.testing.assert_array_equal(wave, plain)
    kept = stats["kept"]
    assert kept["salience"] is kept["f0"] is kept["coarse"] is None
    assert kept["cond"].shape[1] == int(len(pconv.resample_host(src, SR, SR)) // 256)
    assert set(kept["features"]) == {"source", "reference"}
    _, _, stats = conv.convert(src, SR, refw, SR, diffusion_steps=2)
    assert "kept" not in stats


def test_profile_records_the_f0_spans_without_a_synchronise(pair, monkeypatch):
    prog, _ = pair
    syncs = []
    monkeypatch.setattr(pconv, "probe_ready", lambda x: syncs.append(1) or x)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronised"))
    src, refw = _sung(1.9, 11), _sung(1.1, 12)
    for profile in (True, False):
        syncs.clear()
        _, _, stats = prog.convert(src, SR, refw, SR, noise_fn=_noise_fn(1), profile=profile,
                                   keep_intermediates=True, **KW)
        st = stats["stages"]
        # the stages before the sampler and each chunk: the syncs profiling had before
        assert len(syncs) == (5 + stats["chunks"] if profile else 0)
        assert {"f0", "f0.salience", "f0.gru", "f0.decode"} <= set(st)
        n = [len(stats["kept"]["salience"][s]) for s in ("source", "reference")]
        sal = st["f0.salience"]
        assert sal["frames"] == sum(n) and sal["padded_frames"] == sum(-(-k // 32) * 32 for k in n)
        assert st["f0.gru"]["gru_steps"] == 2 * sal["padded_frames"]
        assert st["f0"]["seconds"] >= sal["seconds"] + st["f0.decode"]["seconds"]
        assert all(v["device_seconds"] is None for v in st.values())  # no card
