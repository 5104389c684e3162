"""Sequence-sharded sampling of the port (``seq_shard_axis``) against the JAX
package's (``tests/test_multichip.py:190-284``):

- v1 with a WaveNet head, T = 32, time over ``model`` = 4 on a (1, 4) mesh
  and with the CFG stack over ``data`` on (2, 2), with
  ``use_flash_attention`` False (einsum) and True (K1's twin over each
  rank's query slab);
- v2's 3-way stack at ``DiTV2Config`` defaults (flash on), time over
  ``model``, CFG over ``data``;
- ``SeqShard.gather`` and ``SeqShard.halo`` on 3 gloo ranks, f32 and bf16.

``tests/test_torch_parallel_seq_edges.py`` holds what an even split of
T = 32 cannot show, and a tiny ``VoiceConverter``. The port's ranks are gloo processes
(``tests/torch_parallel_worker.py``). Each sharded run is held against the
port's unsharded run (1e-6 of the largest |value|: with the CFG stack split
too, every matmul runs on half the rows, which moves f32 rounding by a few
ulps) and JAX's run on ``make_mesh(2, 4)`` under ``jax.set_mesh`` (2e-5,
JAX's own tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from seedvc_tpu.core.config import DiTConfig, LengthRegulatorConfig, ModelParams, WavenetConfig
from seedvc_tpu.models.cfm import CFM as JCFM
from seedvc_tpu.models.cfm import euler_solve as jax_euler
from seedvc_tpu.models.cfm_v2 import euler_solve_multicfg as jax_multicfg
from seedvc_tpu.models.dit_v2 import DiTV2 as JDiTV2
from seedvc_tpu.models.dit_v2 import DiTV2Config as JDiTV2Config
from seedvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seedvc_tpu_torch.models.dit_v2 import DiTV2Config
from torch_parallel_worker import spawn, start
from torch_port_helpers import port_cfg

torch.set_num_threads(1)

TOL_PORT, TOL_JAX = 1e-6, 2e-5
B, C, D = 1, 16, 32
SEQ_RUNS = [((1, 4), None, "model"), ((2, 2), "data", "model")]


def _mp(flash: bool, **dit):
    """JAX's v1 sequence-sharding config (WaveNet head), with overrides."""
    wn = dit.pop("wavenet", {})
    return ModelParams(
        length_regulator=LengthRegulatorConfig(channels=32, is_discrete=False, in_channels=32,
                                               sampling_ratios=(1,)),
        DiT=DiTConfig(**{**dict(hidden_dim=32, num_heads=4, depth=2, in_channels=C,
                                final_layer_type="wavenet", content_dim=32,
                                long_skip_connection=False, uvit_skip_connection=False,
                                use_flash_attention=flash), **dit}),
        wavenet=WavenetConfig(**{**dict(hidden_dim=32, num_layers=2, kernel_size=5,
                                        p_dropout=0.0), **wn}))


def _inputs(T: int, style_dim: int, seed: int = 0):
    key = jax.random.PRNGKey(seed)
    return key, dict(mu=jax.random.normal(key, (B, T, D)),
                     style=jax.random.normal(key, (B, style_dim)),
                     lens=jnp.full((B,), T, jnp.int32),
                     prompt=jnp.asarray(np.random.default_rng(2).standard_normal((B, T, C)),
                                        jnp.float32),
                     noise=jax.random.normal(key, (B, T, C)))


def _v1(mp, T: int):
    """(JAX sampler of the axes, the worker's model entry) for v1 config mp."""
    key, a = _inputs(T, 192)
    cfm = JCFM(mp)
    z = jnp.zeros
    variables = cfm.init(key, z((B, T, C)), a["prompt"], a["lens"], z((B,)), a["style"], a["mu"],
                         method=cfm.estimate)

    def est(x, p, l, t, s, m):
        return cfm.apply(variables, x, p, l, t, s, m, method=cfm.estimate)

    def run(shard=None, seq=None):
        return jax_euler(est, key, a["mu"], a["lens"], a["prompt"], 4, a["style"], n_mels=C,
                         n_timesteps=3, cfg_rate=0.7, shard_axis=shard, seq_shard_axis=seq)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    args = {k: np.asarray(v) for k, v in a.items()}
    return run, dict(kind="v1", cfg=port_cfg(mp), params=params, args=args)


def _jax_runs(run, runs):
    """JAX unsharded, then each run's (shard, seq) axes on make_mesh(2, 4)."""
    out = {None: np.asarray(jax.jit(run)())}
    with jax.set_mesh(jax_make_mesh(n_data=2, n_model=4)):
        for _shape, shard, seq in runs:
            out[(shard, seq)] = np.asarray(jax.jit(lambda: run(shard, seq))())
    return out


def _check(name, got, ref, runs):
    np.testing.assert_allclose(got[None], ref[None], atol=TOL_JAX, rtol=0,
                               err_msg=f"{name} unsharded vs JAX")
    scale = max(1.0, float(np.abs(got[None]).max()))
    for shape, shard, seq in runs:
        tag = f"{name} {shape} shard={shard} seq={seq}"
        np.testing.assert_allclose(got[(shape, shard, seq)], got[None], atol=TOL_PORT * scale,
                                   rtol=0,
                                   err_msg=f"{tag} vs the port unsharded")
        jref = ref.get((shard, seq), ref[None])
        np.testing.assert_allclose(got[(shape, shard, seq)], jref, atol=TOL_JAX, rtol=0,
                                   err_msg=f"{tag} vs JAX")


def test_v1_seq_sharded_wavenet_matches_unsharded_and_jax(tmp_path):
    run, plain = _v1(_mp(False), 32)
    flash = {**plain, "cfg": port_cfg(_mp(True))}
    wait = start("seq_sampler", 4, tmp_path, dict(models={
        "einsum": {**plain, "runs": SEQ_RUNS}, "flash": {**flash, "runs": SEQ_RUNS}}))
    ref = _jax_runs(run, SEQ_RUNS)
    out = wait()
    for name in ("einsum", "flash"):
        _check(f"v1 {name}", out[name], ref, SEQ_RUNS)


def test_v2_seq_sharded_three_way_stack_matches_unsharded_and_jax(tmp_path):
    cfg = JDiTV2Config(hidden_dim=32, depth=2, num_heads=4, in_channels=C, content_dim=32,
                       style_encoder_dim=24)
    assert cfg.use_flash_attention  # the defaults: K1's twin on the slab
    T = 24
    key, a = _inputs(T, 24)
    dit = JDiTV2(cfg)
    z = jnp.zeros
    variables = dit.init(key, z((B, T, C)), a["prompt"], a["lens"], z((B,)), a["style"], a["mu"])

    def run(shard=None, seq=None):
        return jax_multicfg(lambda x, p, l, t, s, m: dit.apply(variables, x, p, l, t, s, m),
                            key, a["mu"], a["lens"], a["prompt"], 4, a["style"], n_mels=C,
                            n_timesteps=3, cfg_rates=(0.6, 0.4), shard_axis=shard,
                            seq_shard_axis=seq)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    wait = start("seq_sampler", 4, tmp_path, dict(models={"v2": dict(
        kind="v2", cfg=DiTV2Config(**fields),
        params=jax.tree_util.tree_map(np.asarray, variables["params"]),
        args={k: np.asarray(v) for k, v in a.items()}, runs=SEQ_RUNS)}))
    ref = _jax_runs(run, SEQ_RUNS)
    out = wait()
    _check("v2", out["v2"], ref, SEQ_RUNS)


def test_seq_gather_and_halo_on_three_ranks(tmp_path):
    """``SeqShard.gather`` returns the whole sequence and ``SeqShard.halo``
    the rank's rows of ``F.pad`` over it, bit for bit, in f32 and in bf16
    (carried as its 16-bit patterns): T = 7 over 3 ranks (3, 3, 1) with a
    pad of 4, wider than two parts, and T = 2 (1, 1, 0: an empty rank)."""
    rng = np.random.default_rng(3)
    seqs = [(rng.standard_normal((2, 7, 5)).astype(np.float32), 4),
            (rng.standard_normal((1, 2, 3)).astype(np.float32), 1)]
    out = spawn("seq_collectives", 3, tmp_path, {"seqs": seqs})
    # rank 0's view; every rank returns the same gather
    for i, (x, pad) in enumerate(seqs):
        for dtype in (torch.float32, torch.bfloat16):
            got = out[(i, str(dtype))]
            whole = torch.from_numpy(x).to(dtype)
            assert np.array_equal(got["gather"], whole.float().numpy())
            a, b = got["rows"]
            for mode in ("reflect", "constant"):
                want = F.pad(whole.transpose(1, 2), (pad, pad), mode=mode)[..., a:b + 2 * pad]
                assert np.array_equal(got[mode], want.float().numpy()), (i, dtype, mode)
