"""Ranks of the port's multi-process tests: gloo process groups on the CPU.

The JAX side of a parity test runs in the pytest process; the port's ranks
run here, in processes that import no jax (this module imports only torch,
numpy and the port). :func:`spawn` starts ``world`` processes of one case,
joined through a ``FileStore`` in the test's own directory (no port to
share among xdist workers), each process group with a 60 s timeout; it
waits at most ``timeout`` seconds and kills every rank that is left. A case
reads its inputs from ``<dir>/in.pkl`` and rank 0 writes ``<dir>/out.pkl``.

    python tests/torch_parallel_worker.py <case> <rank> <world> <dir>
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spawn(case: str, world: int, workdir, inputs: dict, timeout: float = 120.0) -> dict:
    """Run ``case`` on ``world`` ranks with ``inputs``; rank 0's outputs."""
    return start(case, world, workdir, inputs, timeout)()


def start(case: str, world: int, workdir, inputs: dict, timeout: float = 120.0):
    """Start ``case`` on ``world`` ranks; returns ``wait()``, which joins
    them (killing every rank left at ``timeout`` seconds from now) and
    returns rank 0's outputs, so the caller can work meanwhile."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for stale in ("store", "out.pkl"):
        (workdir / stale).unlink(missing_ok=True)
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("RANK", None)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), case, str(r), str(world),
                               str(workdir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    return lambda: _join(case, world, workdir, procs, deadline)


def _join(case, world, workdir, procs, deadline) -> dict:
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            try:
                outs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                outs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(o is None for o in outs) or any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{(o or 'timed out')[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{case} on {world} ranks failed:\n{tails}")
    with open(workdir / "out.pkl", "rb") as f:
        return pickle.load(f)


def _init(rank: int, world: int, workdir: Path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))


# ---------------------------------------------------------------------------
# cases: each takes (rank, world, inputs) and returns rank 0's outputs


def _tensors(tree):
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def case_v1_steps(rank, world, inp):
    """One sharded v1 step (teacher, EMA) at every (n_data, n_model, fsdp)
    of ``inp['meshes']``: loss, grad norm, the full parameters and EMA."""
    import torch

    from seedvc_tpu_torch.models.vc import TrainDraws, VCModel
    from seedvc_tpu_torch.parallel.mesh import make_mesh
    from seedvc_tpu_torch.train import optim
    from seedvc_tpu_torch.train.step import (gather_full, init_state, make_sharded_train_step,
                                             shard_state)
    from seedvc_tpu_torch.weights import load_jax_params, to_jax_params

    draws = TrainDraws(*(None if d is None else torch.from_numpy(d) for d in inp["draws"]))
    batch = _tensors(inp["batch"])
    out = {}
    for n_data, n_model, fsdp in inp["meshes"]:
        mesh = make_mesh(n_data, n_model, device_type="cpu")
        model = load_jax_params(VCModel(inp["mp"]), inp["params"])
        opt = optim.make_optimizer(1e-3, grad_clip=inp["grad_clip"])
        state = shard_state(init_state(model, opt, ema=True), mesh, fsdp=fsdp,
                            fsdp_min_elems=inp["fsdp_min_elems"], model=model)
        step = make_sharded_train_step(model, opt, mesh, teacher_params=inp["teacher"],
                                       weight_ema_decay=0.9,
                                       draws_fn=lambda _k, _s, _d: draws)
        state, m = step(state, batch, 0)
        full = gather_full(state.layout, state.params)
        ema = gather_full(state.layout, state.ema_params)
        out[(n_data, n_model, fsdp)] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _flat(to_jax_params(model, full)), "ema": _flat(to_jax_params(model, ema)),
            "tp": sorted(n for n, e in state.layout.entries.items() if e.tp is not None),
            "fsdp": sorted(n for n, e in state.layout.entries.items() if e.fsdp_dim is not None)}
    return out


def case_mesh(rank, world, inp):
    """Every rank's coordinates on each mesh shape, the error of a shape that
    does not fit, ``shard_batch``'s rows and what ``replicate`` gives."""
    import torch

    from seedvc_tpu_torch.parallel.collectives import all_gather_list
    from seedvc_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

    world_group = torch.distributed.group.WORLD
    out = {"coords": {}, "rows": {}}
    for n_data, n_model in inp["shapes"]:
        mesh = make_mesh(n_data, n_model, device_type="cpu")
        me = torch.tensor([mesh.index("data"), mesh.index("model")])
        out["coords"][(n_data, n_model)] = [c.tolist() for c in all_gather_list(me, world_group)]
        rows = shard_batch(mesh, {"x": torch.arange(8)[:, None], "n": torch.tensor(3)})
        assert int(rows["n"]) == 3
        out["rows"][(n_data, n_model)] = [r.tolist() for r in all_gather_list(
            rows["x"][:, 0].contiguous(), world_group)]
    try:
        make_mesh(3, 1)
    except ValueError as e:
        out["error"] = str(e)
    mesh = make_mesh(world, 1, device_type="cpu")
    got = replicate(mesh, {"a": torch.full((2,), float(rank)), "b": "kept"})
    out["replicated"] = [t.tolist() for t in all_gather_list(got["a"], world_group)]
    out["kept"] = got["b"]
    return out


def case_v2_steps(rank, world, inp):
    """Three steps of ``TrainerV2`` at each (n_data, n_model, fsdp) of
    ``inp['meshes']``, on the parent's batch, JAX's draws a step: each
    step's metrics and the full parameters after the last."""
    import torch

    from seedvc_tpu_torch.train.optim import local
    from seedvc_tpu_torch.train.step import gather_full
    from seedvc_tpu_torch.train.trainer_v2 import (TrainDrawsV2, TrainerV2, TrainerV2Config,
                                                   V2Modules)
    from seedvc_tpu_torch.weights import load_jax_params, to_jax_params

    draws = [TrainDrawsV2(*(torch.from_numpy(d) for d in ds)) for ds in inp["draws"]]
    full = dict(load_jax_params(V2Modules(inp["vcfg"]), inp["trainable"]).named_parameters())
    out = {}
    for n_data, n_model, fsdp in inp["meshes"]:
        tr = TrainerV2(inp["vcfg"], TrainerV2Config(**inp["tcfg"], fsdp=fsdp), n_model=n_model,
                       fsdp_min_elems=inp["fsdp_min_elems"], device="cpu",
                       draws_fn=lambda key, _s, _d: draws[key[1]])
        with torch.no_grad():
            for n, p in tr.state.params.items():
                local(p).copy_(tr.state.layout.scatter(n, full[n]))
        feats, dims = tr.prepare_batch(inp["batch"])
        metrics = [{k: float(v) for k, v in tr._device_step(feats, dims, (0, i)).items()}
                   for i in range(inp["steps"])]
        entries = tr.state.layout.entries
        out[(n_data, n_model, fsdp)] = {
            "metrics": metrics,
            "params": _flat(to_jax_params(tr.model, gather_full(tr.state.layout,
                                                                tr.state.params))),
            "tp": sorted(n for n, e in entries.items() if e.tp is not None),
            "fsdp": sorted(n for n, e in entries.items() if e.fsdp_dim is not None)}
    return out


def _cfm(inp):
    from seedvc_tpu_torch.models.cfm import CFM
    from seedvc_tpu_torch.weights import load_jax_params

    return load_jax_params(CFM(inp["mp"]), inp["cfm_params"]).eval()


def case_sampler(rank, world, inp):
    """``euler_solve`` (v1 CFG stack of 2) and ``euler_solve_multicfg`` (3
    branches) with ``shard_axis='data'`` on each mesh of ``inp['meshes']``,
    and both unsharded."""
    import torch

    from seedvc_tpu_torch.models.cfm import euler_solve
    from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg
    from seedvc_tpu_torch.models.dit_v2 import DiTV2
    from seedvc_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from seedvc_tpu_torch.weights import load_jax_params

    cfm = _cfm(inp)
    dit = load_jax_params(DiTV2(inp["v2cfg"]), inp["dit_params"]).eval()
    a = _tensors(inp["args"])

    def v1(axis):
        return euler_solve(cfm.estimate, a["noise"], a["mu"], a["lens"], a["prompt"], 4,
                           a["style"], n_timesteps=3, cfg_rate=0.7, shard_axis=axis).numpy()

    def v2(axis):
        return euler_solve_multicfg(dit, a["noise"], a["mu"], a["lens"], a["prompt"], 4,
                                    a["style24"], n_timesteps=3, cfg_rates=(0.6, 0.4),
                                    shard_axis=axis).numpy()

    out = {"v1": {None: v1(None)}, "v2": {None: v2(None)}}
    for shape in inp["meshes"]:
        with set_mesh(make_mesh(*shape, device_type="cpu")):
            out["v1"][shape], out["v2"][shape] = v1("data"), v2("data")
    return out


def case_converter(rank, world, inp):
    """A tiny ``VoiceConverter`` with ``cfg_shard_axis='data'`` on a (2, 1)
    mesh and the same converter unsharded, the same noise."""
    import numpy as np
    import torch

    from seedvc_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    noise = torch.from_numpy(inp["noise"])
    kw = dict(diffusion_steps=3, cfg_rate=0.7,
              noise_fn=lambda shape: noise[: shape[1]][None])
    out = {}
    for axis in (None, "data"):
        vc = VoiceConverter(inp["cfg"], device="cpu", cfg_shard_axis=axis, **inp["kw"])
        with set_mesh(make_mesh(world, 1, device_type="cpu")):
            out[axis] = vc.convert(inp["src"], inp["sr"], inp["ref"], inp["sr"], **kw)[1]
    assert np.isfinite(out["data"]).all()
    return out


def case_seq_sampler(rank, world, inp):
    """``euler_solve`` (v1 models) and ``euler_solve_multicfg`` (v2) of each
    model of ``inp['models']``, unsharded and at each (mesh shape,
    shard_axis, seq_shard_axis) of its ``runs``."""
    import torch

    from seedvc_tpu_torch.models.cfm import CFM, euler_solve
    from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg
    from seedvc_tpu_torch.models.dit_v2 import DiTV2
    from seedvc_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from seedvc_tpu_torch.weights import load_jax_params

    out = {}
    for name, m in inp["models"].items():
        a = _tensors(m["args"])
        if m["kind"] == "v1":
            cfm = load_jax_params(CFM(m["cfg"]), m["params"]).eval()

            def run(shard, seq, a=a, cfm=cfm):
                return euler_solve(cfm.estimate, a["noise"], a["mu"], a["lens"], a["prompt"], 4,
                                   a["style"], n_timesteps=3, cfg_rate=0.7,
                                   precompute_fn=cfm.precompute_cond, shard_axis=shard,
                                   seq_shard_axis=seq)
        else:
            dit = load_jax_params(DiTV2(m["cfg"]), m["params"]).eval()

            def run(shard, seq, a=a, dit=dit):
                return euler_solve_multicfg(dit, a["noise"], a["mu"], a["lens"], a["prompt"], 4,
                                            a["style"], n_timesteps=3, cfg_rates=(0.6, 0.4),
                                            shard_axis=shard, seq_shard_axis=seq)
        out[name] = {None: run(None, None).numpy()}
        for shape, shard, seq in m["runs"]:
            with set_mesh(make_mesh(*shape, device_type="cpu")):
                out[name][(shape, shard, seq)] = run(shard, seq).numpy()
    return out


def case_seq_collectives(rank, world, inp):
    """``SeqShard.gather`` and ``SeqShard.halo`` of this rank's part of each
    sequence of ``inp['seqs']`` (time on dim 1 for the gather, last for the
    halo) on a (1, world) mesh, in f32 and bf16."""
    import torch

    from seedvc_tpu_torch.parallel.mesh import SeqShard, make_mesh, set_mesh

    out = {}
    with set_mesh(make_mesh(1, world, device_type="cpu")):
        for i, (x, pad) in enumerate(inp["seqs"]):
            for dtype in (torch.float32, torch.bfloat16):
                whole = torch.from_numpy(x).to(dtype)
                seq = SeqShard.over("model", whole.shape[1])
                part = seq.take(whole).contiguous()
                halos = {mode: seq.halo(part.transpose(1, 2).contiguous(), pad, mode)
                         for mode in ("reflect", "constant")}
                out[(i, str(dtype))] = {"gather": seq.gather(part).float().numpy(),
                                        "rows": (seq.rows.start, seq.rows.stop),
                                        **{m: h.float().numpy() for m, h in halos.items()}}
    return out


def case_seq_converter(rank, world, inp):
    """A tiny ``VoiceConverter`` with ``seq_shard_axis='model'`` on a
    (1, world) mesh and the same converter unsharded, the same noise: each
    run's wave and the mels its sampler returned."""
    import numpy as np
    import torch

    from seedvc_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from seedvc_tpu_torch.pipelines import convert

    noise = torch.from_numpy(inp["noise"])
    kw = dict(diffusion_steps=3, cfg_rate=0.7,
              noise_fn=lambda shape: noise[: shape[1]][None])
    real, mels = convert.euler_solve, []

    def recorded(*a, **k):
        mels.append(real(*a, **k).numpy())
        return torch.from_numpy(mels[-1])
    convert.euler_solve = recorded
    out = {}
    for axis in (None, "model"):
        vc = convert.VoiceConverter(inp["cfg"], device="cpu", seq_shard_axis=axis, **inp["kw"])
        mels.clear()
        with set_mesh(make_mesh(1, world, device_type="cpu")):
            out[axis] = vc.convert(inp["src"], inp["sr"], inp["ref"], inp["sr"], **kw)[1]
        out[(axis, "mels")] = list(mels)
    assert np.isfinite(out["model"]).all()
    return out


def case_bsq(rank, world, inp):
    """``BSQ(pmean_axis='data')`` on this rank's rows: every rank's aux loss,
    and the sum over ranks of each rank's gradient of its aux loss."""
    import torch

    from seedvc_tpu_torch.nn.bsq import BSQ
    from seedvc_tpu_torch.parallel.collectives import all_gather_list, all_reduce_sum
    from seedvc_tpu_torch.parallel.mesh import make_mesh, set_mesh, shard_batch
    from seedvc_tpu_torch.weights import load_jax_params

    bsq = load_jax_params(BSQ(**inp["kw"], pmean_axis="data"), inp["params"])
    mesh = make_mesh(world, 1, device_type="cpu")
    x = shard_batch(mesh, torch.from_numpy(inp["x"]))
    with set_mesh(mesh):
        _, _, aux = bsq(x, training=True)
    aux.backward()
    world_group = torch.distributed.group.WORLD
    return {"aux": [float(t) for t in all_gather_list(aux.detach().reshape(1), world_group)],
            "grad": all_reduce_sum(bsq.project_in.weight.grad, world_group).T.numpy()}


def case_trainer(rank, world, inp):
    """The v1 ``Trainer`` at each (n_model, fsdp, openvoice) of
    ``inp['runs']``: every rank's prepared features of the batch at step 0;
    then two steps, a checkpoint at 2 and a third step (its loss and the
    full parameters and EMA after it)."""
    import numpy as np
    import torch

    import seedvc_tpu_torch.models.openvoice as pov
    from seedvc_tpu_torch.parallel.collectives import all_gather_list
    from seedvc_tpu_torch.train.step import gather_full
    from seedvc_tpu_torch.train.trainer import Trainer
    from seedvc_tpu_torch.weights import to_jax_params


    pov.OpenVoiceConfig = lambda: inp["ov_cfg"]
    world_group = torch.distributed.group.WORLD
    batch, out = inp["batch"], {}
    for n_model, fsdp, ov in inp["runs"]:
        tcfg = inp["tcfg"](run_dir=os.path.join(inp["cwd"], f"run_{n_model}_{fsdp}_{ov}"),
                           fsdp=fsdp)
        extra = dict(openvoice_params=inp["ov_tree"]) if ov else {}
        tr = Trainer(inp["cfg"], tcfg, whisper_cfg=inp["whisper"], n_model=n_model,
                     fsdp_min_elems=inp["fsdp_min_elems"], device="cpu", **extra)
        feats = tr.prepare_batch(batch, np.random.default_rng(1), step=0)
        prep = {k: [t.numpy() for t in all_gather_list(v.contiguous(), world_group)]
                for k, v in feats.items() if v.ndim >= 1}
        losses = []
        for step in range(3):
            if step == 2:
                tr.save(2)
            f = tr.prepare_batch(batch, np.random.default_rng((tcfg.seed, step)), step=step)
            tr.state, m = tr.step_fn(tr.state, f, (tcfg.seed, step), local_rows=True)
            losses.append(float(m["loss"]))
        st = tr.state
        out[(n_model, fsdp, ov)] = {
            "prep": prep, "losses": losses, "run_dir": tcfg.run_dir,
            "params": _flat(to_jax_params(tr.model, gather_full(st.layout, st.params))),
            "ema": _flat(to_jax_params(tr.model, gather_full(st.layout, st.ema_params))),
            "split": sorted(n for n, e in st.layout.entries.items())}
    return out


def case_f0_cache(rank, world, inp):
    """The f0-conditioned v1 ``Trainer`` on a (world, 1) mesh with the
    feature cache on (a reduced RMVPE): every rank's features from two
    ``prepare_batch`` calls on the same batch, the second from the cache."""
    import functools

    import numpy as np
    import torch

    import seedvc_tpu_torch.models.rmvpe as rmvpe
    from seedvc_tpu_torch.parallel.collectives import all_gather_list
    from seedvc_tpu_torch.train.trainer import Trainer

    rmvpe.RMVPE_E2E = functools.partial(rmvpe.RMVPE_E2E, **inp["rmvpe"])
    tr = Trainer(inp["cfg"], inp["tcfg"], whisper_cfg=inp["whisper"], device="cpu")
    calls = []
    for _ in range(2):
        feats = tr.prepare_batch(inp["batch"], np.random.default_rng(1), step=0)
        calls.append({k: [t.numpy() for t in all_gather_list(v.contiguous(),
                                                             torch.distributed.group.WORLD)]
                      for k, v in feats.items() if v.ndim >= 1})
    return {"calls": calls, "cached": len(tr._feat_cache)}


def _patched_v1_cli(inp):
    import dataclasses

    from seedvc_tpu_torch.core import config as config_mod
    from seedvc_tpu_torch.train import trainer as trainer_mod

    config_mod.get_preset = lambda _name: inp["cfg"]
    real = trainer_mod.Trainer
    trainer_mod.Trainer = lambda cfg, tcfg, **kw: real(cfg, dataclasses.replace(
        tcfg, mel_bucket=64, warmup_steps=1), whisper_cfg=inp["whisper"], **kw)


def case_cli(rank, world, inp):
    """``apps.train`` and ``apps.train_v2`` with each flag set of
    ``inp['flags']`` on this world (the process group is up, as a launcher
    would have it), 2 steps each: every run's losses, step and checkpoint."""
    import torch

    from seedvc_tpu_torch.apps import train as train_app
    from seedvc_tpu_torch.apps import train_v2 as train_v2_app

    _patched_v1_cli(inp)
    os.chdir(inp["cwd"])
    out = {}
    base = ["--dataset-dir", inp["wav_dir"], "--device", "cpu", "--batch-size", "2",
            "--max-steps", "2", "--log-interval", "1", "--save-interval", "2"]
    for flags in inp["flags"]:
        name = "_".join(f.strip("-") for f in flags)
        tr = train_app.main(base + ["--run-name", f"v1_{name}", "--export-dir",
                                    f"x_{name}"] + flags)
        v2 = train_v2_app.main(base + ["--run-name", f"v2_{name}", "--warmup-steps", "1"] + flags,
                               vcfg=inp["vcfg"])
        out[name] = {"v1": [float(h["loss"]) for h in tr.history], "v1_step": tr.state.step,
                     "v2": [float(h["loss"]) for h in v2.history], "v2_step": v2.state.step,
                     "mesh": dict(tr.mesh.shape)}
    torch.distributed.barrier()
    return out


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(argv):
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    sys.path[:0] = [str(ROOT), str(HERE)]
    _init(rank, world, workdir)
    import torch.distributed as dist

    with open(workdir / "in.pkl", "rb") as f:
        inputs = pickle.load(f)
    out = CASES[case](rank, world, inputs)
    if rank == 0:
        with open(workdir / "out.pkl.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(workdir / "out.pkl.tmp", workdir / "out.pkl")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
