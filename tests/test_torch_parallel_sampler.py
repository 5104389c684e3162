"""CFG-sharded sampling of the port against the JAX package's (``tests/test_multichip.py:143-230``):

- ``euler_solve(shard_axis="data")`` (the v1 CFG stack of 2) and
  ``euler_solve_multicfg(shard_axis="data")`` (the v2 3-way stack) on a
  4-rank gloo world at 2 x 2 (1 row a rank in v1; 2 and 1 in v2, XLA's
  uneven split) and 4 x 1 (ranks without a row), against the unsharded
  port run and JAX's sharded run on ``make_mesh(2, 4)`` under
  ``jax.set_mesh``, within 2e-5 (JAX's own tolerance);
- ``euler_solve``'s ``temperature`` and ``t_scheduler="cosine"`` against
  JAX's, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from seedvc_tpu.core.config import DiTConfig, LengthRegulatorConfig, ModelParams
from seedvc_tpu.models.cfm import CFM as JCFM
from seedvc_tpu.models.cfm import euler_solve as jax_euler
from seedvc_tpu.models.cfm_v2 import euler_solve_multicfg as jax_multicfg
from seedvc_tpu.models.dit_v2 import DiTV2 as JDiTV2
from seedvc_tpu.models.dit_v2 import DiTV2Config as JDiTV2Config
from seedvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seedvc_tpu_torch.models.cfm import CFM, euler_solve
from seedvc_tpu_torch.models.dit_v2 import DiTV2Config
from seedvc_tpu_torch.weights import load_jax_params
from torch_parallel_worker import start
from torch_port_helpers import port_cfg

torch.set_num_threads(1)

TOL = 2e-5
B, T, C, D = 1, 24, 16, 32
MP = ModelParams(
    length_regulator=LengthRegulatorConfig(channels=32, is_discrete=False, in_channels=32,
                                           sampling_ratios=(1,)),
    DiT=DiTConfig(hidden_dim=32, num_heads=4, depth=2, in_channels=C, final_layer_type="mlp",
                  content_dim=32, long_skip_connection=False, uvit_skip_connection=False))
V2 = JDiTV2Config(hidden_dim=32, depth=2, num_heads=4, in_channels=C, content_dim=32,
                  style_encoder_dim=24)


def _inputs():
    key = jax.random.PRNGKey(0)
    mu = jax.random.normal(key, (B, T, D))
    style = jax.random.normal(key, (B, 192))
    style24 = jax.random.normal(key, (B, 24))
    lens = jnp.full((B,), T, jnp.int32)
    prompt = jnp.asarray(np.random.default_rng(2).standard_normal((B, T, C)), jnp.float32)
    z = jnp.zeros
    cfm_vars = JCFM(MP).init(key, z((B, T, C)), prompt, lens, z((B,)), style, mu,
                             method=JCFM(MP).estimate)
    dit_vars = JDiTV2(V2).init(key, z((B, T, C)), prompt, lens, z((B,)), style24, mu)
    return key, dict(mu=mu, style=style, style24=style24, lens=lens, prompt=prompt), \
        cfm_vars, dit_vars


def _jax_runs(key, a, cfm_vars, dit_vars):
    cfm, dit = JCFM(MP), JDiTV2(V2)

    def est1(x, p, l, t, s, m):
        return cfm.apply(cfm_vars, x, p, l, t, s, m, method=cfm.estimate)

    def est2(x, p, l, t, s, m):
        return dit.apply(dit_vars, x, p, l, t, s, m)

    def v1(axis):
        return jax_euler(est1, key, a["mu"], a["lens"], a["prompt"], 4, a["style"], n_mels=C,
                         n_timesteps=3, cfg_rate=0.7, shard_axis=axis)

    def v2(axis):
        return jax_multicfg(est2, key, a["mu"], a["lens"], a["prompt"], 4, a["style24"],
                            n_mels=C, n_timesteps=3, cfg_rates=(0.6, 0.4), shard_axis=axis)

    with jax.set_mesh(jax_make_mesh(n_data=2, n_model=4)):
        return (np.asarray(jax.jit(lambda: v1("data"))()),
                np.asarray(jax.jit(lambda: v2("data"))()))


def test_cfg_sharded_samplers_match_unsharded_and_jax(tmp_path):
    key, a, cfm_vars, dit_vars = _inputs()
    noise = np.asarray(jax.random.normal(key, (B, T, C)))
    args = {k: np.asarray(v) for k, v in a.items()}
    fields = {f: getattr(V2, f) for f in V2.__dataclass_fields__}
    meshes = [(2, 2), (4, 1)]
    wait = start("sampler", 4, tmp_path, dict(
        mp=port_cfg(MP), cfm_params=jax.tree_util.tree_map(np.asarray, cfm_vars["params"]),
        v2cfg=DiTV2Config(**fields),
        dit_params=jax.tree_util.tree_map(np.asarray, dit_vars["params"]),
        args={**args, "noise": noise}, meshes=meshes))
    j1, j2 = _jax_runs(key, a, cfm_vars, dit_vars)
    out = wait()
    for name, ref in (("v1", j1), ("v2", j2)):
        np.testing.assert_allclose(out[name][None], ref, atol=TOL, err_msg=name)
        for shape in meshes:
            np.testing.assert_allclose(out[name][shape], out[name][None], atol=TOL,
                                       err_msg=f"{name} {shape} vs unsharded")
            np.testing.assert_allclose(out[name][shape], ref, atol=TOL,
                                       err_msg=f"{name} {shape} vs JAX")


def test_euler_temperature_and_cosine_match_jax():
    key, a, cfm_vars, _ = _inputs()
    cfm = JCFM(MP)

    def est(x, p, l, t, s, m):
        return cfm.apply(cfm_vars, x, p, l, t, s, m, method=cfm.estimate)

    pcfm = load_jax_params(CFM(port_cfg(MP)), jax.tree_util.tree_map(np.asarray,
                                                                      cfm_vars["params"]))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, T, C))))
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    for temperature, sched in ((0.6, "cosine"), (1.3, "linear")):
        ref = np.asarray(jax.jit(lambda: jax_euler(
            est, key, a["mu"], a["lens"], a["prompt"], 4, a["style"], n_mels=C, n_timesteps=4,
            temperature=temperature, cfg_rate=0.5, t_scheduler=sched))())
        got = euler_solve(pcfm.estimate, noise, t["mu"], t["lens"], t["prompt"], 4, t["style"],
                          n_timesteps=4, cfg_rate=0.5, temperature=temperature,
                          t_scheduler=sched).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=sched)
