"""The port's OpenVoice ToneColorConverter against the JAX module, on the CPU.

The tiny config of tests/test_openvoice.py (inter 8, hidden 16, one
ResBlock, two 4x upsamplings, gin 12) on one random flax tree: every leaf,
each coupling's ``post`` included (zero in a fresh JAX init, which would make
the flow the identity and g inert), is drawn by ``jax_init``. The noise is
one numpy buffer fed to both sides.

Tolerance (f32): the linear spectrogram and ``extract_se`` 1e-5 absolute;
the ``voice_conversion`` wave 1e-4 absolute (sixteen WaveNet layers, four
couplings each way and the decoder sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.models import openvoice as jov
from seedvc_tpu_torch.models import openvoice as pov
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_port_helpers import jax_apply, ov_tiny_cfg, ov_tree

torch.set_num_threads(1)

SE_TOL, WAVE_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = ov_tiny_cfg(jov)
    tree = ov_tree(jcfg)
    assert np.abs(tree["flow"]["flows_0"]["post"]["kernel"]).max() > 0
    port = load_jax_params(pov.ToneColorConverter(ov_tiny_cfg(pov)), tree).eval()
    return jov.ToneColorConverter(jcfg), port, tree


def test_to_jax_params_gives_the_flax_tree(models):
    """The export is the load's inverse, the decoder's transposed convolutions
    included (flat ``ups_i_kernel`` (K, in, out) and ``ups_i_bias``)."""
    _, pm, tree = models
    got = to_jax_params(pm)
    assert got["dec"]["ups_0_kernel"].shape == tree["dec"]["ups_0_kernel"].shape == (8, 32, 16)
    flat = jax.tree_util.tree_leaves_with_path
    got_leaves, ref_leaves = dict(flat(got)), dict(flat(tree))
    assert got_leaves.keys() == ref_leaves.keys()
    for k, v in ref_leaves.items():
        np.testing.assert_array_equal(got_leaves[k], np.asarray(v), err_msg=str(k))


def test_linear_spectrogram_matches_jax():
    y = (np.random.default_rng(0).standard_normal((2, 8000)) * 0.2).astype(np.float32)
    ref = np.asarray(jov.linear_spectrogram(jnp.asarray(y)))
    got = pov.linear_spectrogram(torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (2, 8000 // 256, 513)
    np.testing.assert_allclose(got, ref, rtol=0, atol=SE_TOL)


def test_extract_se_and_voice_conversion_match_jax(models):
    jm, pm, tree = models
    rng = np.random.default_rng(1)
    B, T = 2, 40
    spec = np.abs(rng.standard_normal((B, T, 513))).astype(np.float32)
    lens = np.array([T, 31], np.int32)
    noise = rng.standard_normal((B, T, 8)).astype(np.float32)

    ref_se = np.asarray(jax_apply(jm, tree, jnp.asarray(spec), method=jm.extract_se))
    with torch.no_grad():
        se = pm.extract_se(torch.from_numpy(spec))
    assert se.shape == (B, 12)
    np.testing.assert_allclose(se.numpy(), ref_se, rtol=0, atol=SE_TOL)

    g_tgt = ref_se[::-1].copy()
    ref = np.asarray(jax_apply(jm, tree, jnp.asarray(spec), jnp.asarray(lens),
                               jnp.asarray(ref_se), jnp.asarray(g_tgt), jnp.asarray(noise), 0.3,
                               method=jm.voice_conversion))
    with torch.no_grad():
        got = pm.voice_conversion(torch.from_numpy(spec), torch.from_numpy(lens), se,
                                  torch.from_numpy(g_tgt), torch.from_numpy(noise), 0.3)
    assert got.shape == ref.shape == (B, T * 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=WAVE_TOL)
    # g acts through the flow: another target embedding gives another wave
    with torch.no_grad():
        same = pm.voice_conversion(torch.from_numpy(spec), torch.from_numpy(lens), se, se,
                                   torch.from_numpy(noise), 0.3)
    assert (same - got).abs().max() > 1e-3


def test_reverse_flow_undoes_forward_flow(models):
    _, pm, _ = models
    rng = np.random.default_rng(2)
    B, T = 2, 24
    z = torch.from_numpy(rng.standard_normal((B, T, 8)).astype(np.float32))
    mask = (torch.arange(T)[None, :] < torch.tensor([[T], [17]]))[..., None].float()
    z = z * mask
    g = torch.from_numpy(rng.standard_normal((B, 1, 12)).astype(np.float32))
    with torch.no_grad():
        z_p = pm.flow(z, mask, g)
        back = pm.flow(z_p, mask, g, reverse=True)
    assert (z_p - z).abs().max() > 1e-2  # the forward flow is not the identity
    np.testing.assert_allclose(back.numpy(), z.numpy(), rtol=0, atol=1e-5)


def test_fresh_flow_is_the_identity():
    pm = pov.ToneColorConverter(ov_tiny_cfg(pov))
    z = torch.randn(1, 10, 8)
    mask = torch.ones(1, 10, 1)
    with torch.no_grad():
        out = pm.flow(z, mask, torch.randn(1, 1, 12))
    # four flips of the channel axis and zero means
    torch.testing.assert_close(out, z, rtol=0, atol=0)


def test_split_segments_by_energy_matches_jax():
    sr = 16000
    rng = np.random.default_rng(0)
    loud = (rng.standard_normal(2 * sr) * 0.3).astype(np.float32)
    long = (rng.standard_normal(23 * sr // 2) * 0.3).astype(np.float32)
    silence = np.zeros(sr, np.float32)
    for wave in (np.concatenate([silence, loud, silence, loud, silence, long]),
                 np.zeros(sr, np.float32), np.zeros(10, np.float32)):
        ref = jov.split_segments_by_energy(wave, sr, min_sec=1.5)
        got = pov.split_segments_by_energy(wave, sr, min_sec=1.5)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_get_se_matches_jax(models):
    jm, pm, tree = models
    sr = 16000
    t = np.arange(2 * sr) / sr
    loud = (0.3 * (np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 440 * t))
            ).astype(np.float32)
    wave = np.concatenate([np.zeros(sr, np.float32), loud, np.zeros(sr, np.float32),
                           0.7 * loud])

    def j_extract(spec):
        return np.asarray(jax_apply(jm, tree, spec, method=jm.extract_se))

    calls = []

    def p_extract(spec):
        calls.append(tuple(spec.shape))
        with torch.no_grad():
            return pm.extract_se(spec)

    for vad in (True, False):
        calls.clear()
        ref = jov.get_se(wave, sr, j_extract, vad=vad)
        got = pov.get_se(wave, sr, p_extract, vad=vad, device="cpu")
        assert len(calls) == (2 if vad else 1)
        assert got.shape == ref.shape == (12,)
        np.testing.assert_allclose(got, ref, rtol=0, atol=SE_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pov.get_se(wave, sr, p_extract)
