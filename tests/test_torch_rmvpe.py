"""The port's RMVPE (``seedvc_tpu_torch/models/rmvpe.py``) against the JAX
module, on the CPU, with carried random weights.

A reduced ``RMVPE_E2E(n_blocks=1, en_de_layers=2, inter_layers=1,
en_out_channels=4)`` keeps every layer kind (encoder BN, residual blocks with
and without a shortcut, average pools, transposed convs, skip concats, the
3-channel head, both GRU directions, the 360-bin output) at a few channels.
Tolerances: log-mel 1e-4 (an FFT against the JAX package's DFT matmuls),
salience 1e-5 (f32 summation order). Decoded F0 is compared only on frames
whose salience maximum clears both the voicing threshold and the runner-up
bin by ``MARGIN``: elsewhere an f32 rounding may move the argmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from seedvc_tpu.models.rmvpe import RMVPE_E2E as JE2E
from seedvc_tpu.models.rmvpe import GRUCellParams
from seedvc_tpu.models.rmvpe import decode_f0 as j_decode_f0
from seedvc_tpu.models.rmvpe import rmvpe_mel as j_rmvpe_mel
from seedvc_tpu_torch.models.rmvpe import RMVPE, RMVPE_E2E, decode_f0, rmvpe_mel
from seedvc_tpu_torch.weights import load_jax_params
from torch_port_helpers import jax_apply, jax_init

torch.set_num_threads(1)

REDUCED = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4)
MARGIN = 1e-4


def _noise(n, seed, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def reduced():
    """(JAX module, flax tree, port module) with the same random weights."""
    jm = JE2E(**REDUCED)
    params = jax_init(jm, jnp.zeros((1, 32, 128)), seed=5)
    pm = load_jax_params(RMVPE_E2E(**REDUCED), params).eval()
    return jm, params, pm


def test_rmvpe_mel_matches_jax():
    wave = _noise(8000, 0)[None]
    ref = np.asarray(j_rmvpe_mel(jnp.asarray(wave)))
    out = rmvpe_mel(torch.from_numpy(wave)).numpy()
    assert out.shape == ref.shape == (1, 51, 128)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_reduced_e2e_matches_jax(reduced):
    jm, params, pm = reduced
    mel = np.random.default_rng(1).standard_normal((2, 64, 128)).astype(np.float32)
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(mel)))
    with torch.no_grad():
        out = pm(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 64, 360)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_gru_matches_jax_cell(reverse):
    """One ``nn.GRU`` direction (the backward one over the flipped time
    axis) against ``GRUCellParams``: same r, z, n gates; atol 1e-5."""
    x = np.random.default_rng(2).standard_normal((2, 40, 24)).astype(np.float32)
    jm = GRUCellParams(16, reverse=reverse)
    params = jax_init(jm, jnp.asarray(x), seed=3)
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(x)))
    gru = load_jax_params(nn.GRU(24, 16, batch_first=True), params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = (gru(xt.flip(1))[0].flip(1) if reverse else gru(xt)[0]).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_decode_f0_equals_jax():
    rng = np.random.default_rng(4)
    sal = rng.uniform(0, 1, (50, 360)).astype(np.float32) ** 8
    sal[0] = 0.0                # all-zero row: NaN mean, unvoiced
    sal[1] = 0.0
    sal[1, 0] = 0.9             # peak at the first bin (window clipped low)
    sal[2] = 0.0
    sal[2, 359] = 0.7           # peak at the last bin (window clipped high)
    sal[3] = 0.03               # exactly at the threshold: unvoiced
    sal[4] = 0.0
    sal[4, 180] = 0.0301        # just above it
    np.testing.assert_array_equal(decode_f0(sal), j_decode_f0(sal))
    np.testing.assert_array_equal(decode_f0(sal, thred=0.5), j_decode_f0(sal, thred=0.5))
    f0 = decode_f0(sal)
    assert f0[0] == 0 and f0[3] == 0 and f0[1] > 0 and f0[2] > 0 and f0[4] > 0


def _clear_frames(sal: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """Frames whose top salience clears the threshold and the runner-up by
    MARGIN."""
    top2 = np.sort(sal, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] > MARGIN) & (top2[..., 1] > thred + MARGIN)


def test_infer_from_audio_batch_pads_after_log(reduced):
    """51 frames (0.5 s): the log-mel is zero-padded to 64 frames after the
    log and both GRU directions run over the pad before the crop, as the JAX
    ``RMVPE.infer_from_audio_batch`` does. Composed here from the JAX steps
    (``rmvpe_mel`` -> pad -> ``apply`` -> crop -> ``decode_f0``). A port that
    padded only to the model's multiple of 4 (so the backward GRU starts
    elsewhere) is shown to differ."""
    jm, params, pm = reduced
    wave = _noise(8000, 6)[None]
    mel = j_rmvpe_mel(jnp.asarray(wave))
    n = mel.shape[1]
    assert n == 51
    ref_sal = np.asarray(jax_apply(jm, params, jnp.pad(mel, ((0, 0), (0, 64 - n), (0, 0)))))[:, :n]
    rm = RMVPE(pm)
    sal = rm.salience(wave).numpy()
    np.testing.assert_allclose(sal, ref_sal, atol=1e-5, rtol=0)
    f0 = rm.infer_from_audio_batch(wave)
    ref_f0 = np.stack([j_decode_f0(h) for h in ref_sal])
    clear = _clear_frames(ref_sal)
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_allclose(f0[clear], ref_f0[clear], rtol=1e-5)
    with torch.no_grad():
        short = pm(torch.nn.functional.pad(rmvpe_mel(torch.from_numpy(wave)),
                                           (0, 0, 0, 52 - n)))[:, :n].numpy()
    assert np.abs(short - ref_sal).max() > 1e-3


def test_weight_walk_rmvpe_layouts(reduced):
    """ConvTranspose2d (kh, kw, in, out) -> (in, out, kh, kw) unflipped, GRU
    (F, 3H) -> (3H, F), 2-D EvalBatchNorm -> BatchNorm2d buffers; BatchNorm's
    num_batches_tracked is not asked for; a missing leaf raises."""
    _, params, pm = reduced
    np.testing.assert_array_equal(pm.dec_0_up.weight.detach().numpy(),
                                  params["dec_0_up_kernel"].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(pm.gru_bwd.weight_ih_l0.detach().numpy(),
                                  params["gru_bwd"]["w_ih"].T)
    np.testing.assert_array_equal(pm.gru_fwd.bias_hh_l0.detach().numpy(),
                                  params["gru_fwd"]["b_hh"])
    np.testing.assert_array_equal(pm.enc_0_block_0.bn1.running_var.numpy(),
                                  params["enc_0_block_0"]["bn1"]["var"])
    np.testing.assert_array_equal(pm.encoder_bn.running_mean.numpy(),
                                  params["encoder_bn"]["mean"])
    broken = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    del broken["gru_bwd"]["b_hh"]
    with pytest.raises(KeyError, match="gru_bwd.bias_hh_l0"):
        load_jax_params(RMVPE_E2E(**REDUCED), broken)
    broken = dict(params)
    del broken["dec_1_up_kernel"]
    with pytest.raises(KeyError, match="dec_1_up.weight"):
        load_jax_params(RMVPE_E2E(**REDUCED), broken)
