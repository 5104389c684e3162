"""The port's other mesh-named collectives against the JAX package's:

- a tiny ``VoiceConverter(cfg_shard_axis="data")`` on 2 gloo ranks against
  the same converter unsharded: 1e-3 on the wave, one f16 step near 1.0
  (each rank runs one CFG branch, a batch of 1 in place of 2, so f32
  rounding may differ in the last place before the f16 output);
- ``BSQ(pmean_axis="data")`` on 2 ranks against JAX's BSQ with
  ``pmean_axis`` under ``shard_map`` over the same 4 rows on its 8-device
  CPU mesh: each rank's aux loss and the gradient of their sum, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from seedvc_tpu.nn import bsq as jbsq
from seedvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from test_torch_pipeline import CONTEXT, PROMPT_CAP, SR, VOC, WHISPER, _audio, _port_cfg
from torch_parallel_worker import spawn, start
from torch_port_helpers import jax_init

torch.set_num_threads(1)


def test_cfg_sharded_voice_converter_matches_unsharded(tmp_path):
    src, ref = _audio(200, 180.0, 0), _audio(50, 240.0, 1)
    noise = np.random.default_rng(1234).standard_normal((CONTEXT, 80)).astype(np.float32)
    out = spawn("converter", 2, tmp_path, dict(
        cfg=_port_cfg(), src=src, ref=ref, sr=SR, noise=noise,
        kw=dict(whisper_cfg=WhisperEncoderConfig(**WHISPER), vocoder_cfg=BigVGANConfig(**VOC),
                prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT)))
    assert out[None].shape == out["data"].shape and out[None].size > 0
    np.testing.assert_allclose(out["data"], out[None], atol=1e-3, rtol=0)


def test_bsq_pmean_matches_jax_shard_map(tmp_path):
    kw = dict(dim=16, codebook_size=16, commitment_loss_weight=0.25)
    x = np.random.default_rng(5).standard_normal((4, 9, 16)).astype(np.float32)
    params = jax_init(jbsq.BSQ(**kw), x, training=True, seed=3)
    wait = start("bsq", 2, tmp_path, dict(kw=kw, params=params, x=x))
    jm = jbsq.BSQ(**kw, pmean_axis="data")
    mesh = jax_make_mesh(n_data=2, n_model=4)

    def per_device(p, xs):
        return jm.apply({"params": p}, xs, training=True)[2][None]

    f = jax.shard_map(per_device, mesh=mesh, in_specs=(P(), P("data")), out_specs=P("data"))
    aux = np.asarray(jax.jit(f)(params, jnp.asarray(x)))
    grad = jax.jit(jax.grad(lambda p: f(p, jnp.asarray(x)).sum()))(params)
    out = wait()
    np.testing.assert_allclose(out["aux"], aux, atol=1e-5, rtol=0)
    ref = np.asarray(grad["project_in"]["kernel"])
    np.testing.assert_allclose(out["grad"], ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    # the mean over ranks entered: each rank's loss differs from its rows' own
    solo_fn = jax.jit(lambda xs: jbsq.BSQ(**kw).apply({"params": params}, xs, training=True)[2])
    solo = [float(solo_fn(x[i:i + 2])) for i in (0, 2)]
    assert np.abs(np.asarray(solo) - aux).max() > 1e-4
