"""The port's ``parallel/*`` against the JAX package's (``tests/test_multichip.py``
holds the JAX side on its 8-device CPU mesh):

- ``make_mesh``: the row-major (data, model) layout of a 4-rank gloo world
  at 4 x 1, 2 x 2 and 1 x 4, JAX's error for a shape that does not fit,
  ``shard_batch``'s rows and ``replicate`` (the first rank's values);
- ``logical_to_sharding``: the same spec as JAX's for every parameter of
  the same flax trees (the v1 ``VCModel``, and the v2 DiT, regulators and
  AR, whose flat ``feed_forward_w*`` match no rule), with and without the
  FSDP axis, on a 4 x 2 mesh; and the module specs the port reads from its
  own parameters (a Linear ``weight`` is the flax ``kernel`` transposed)
  equal the tree's;
- ``initialize()`` without a launcher's environment starts nothing;
- ``seq_shard_axis`` (item 3c(ii), ported: ``tests/test_torch_parallel_seq.py``)
  outside a ``set_mesh`` block raises, as ``shard_axis`` does, in both
  samplers and in a ``VoiceConverter``'s conversion.
"""

import jax
import numpy as np
import pytest
import torch

from seedvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seedvc_tpu.parallel.sharding import logical_to_sharding as jax_specs
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.cfm import euler_solve
from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg
from seedvc_tpu_torch.models.vc import VCModel
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.parallel import distributed, mesh as pmesh, sharding
from seedvc_tpu_torch.pipelines.convert import VoiceConverter
from seedvc_tpu_torch.train.trainer_v2 import V2Modules
from test_torch_pipeline import CONTEXT, PROMPT_CAP, SR, VOC, WHISPER, _audio, _port_cfg
from test_trainer_v2 import tiny_v2cfg
from torch_parallel_worker import spawn
from torch_port_helpers import port_cfg, tiny_train_cfg, v2_port_cfg, v2_trees, vc_tree

torch.set_num_threads(1)

SHAPES = [(4, 1), (2, 2), (1, 4)]


def test_make_mesh_on_four_ranks(tmp_path):
    out = spawn("mesh", 4, tmp_path, {"shapes": SHAPES})
    for n_data, n_model in SHAPES:
        # rank r sits at (r // n_model, r % n_model), as JAX reshapes devices
        assert out["coords"][(n_data, n_model)] == [[r // n_model, r % n_model]
                                                    for r in range(4)]
        jmesh = jax_make_mesh(n_data, n_model, devices=jax.devices()[:4])
        assert dict(jmesh.shape) == {"data": n_data, "model": n_model}
        rows = 8 // n_data
        assert out["rows"][(n_data, n_model)] == [
            list(range((r // n_model) * rows, (r // n_model + 1) * rows)) for r in range(4)]
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(3, 1, devices=jax.devices()[:4])
    assert out["error"] == str(jerr.value) == "mesh 3x1 != 4 devices"
    assert out["replicated"] == [[0.0, 0.0]] * 4 and out["kept"] == "kept"


def test_one_process_mesh():
    m = pmesh.make_mesh(1, 1)
    assert m.shape == {"data": 1, "model": 1} and m.device_mesh is None
    assert m.group("data") is None and m.all_group() is None
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        pmesh.make_mesh(2, 1)
    x = torch.arange(4)
    assert torch.equal(pmesh.shard_batch(m, {"x": x})["x"], x)
    with pytest.raises(ValueError, match="set_mesh"):
        pmesh.current_mesh("data")
    with pmesh.set_mesh(m):
        assert pmesh.current_mesh("data") is m


def _jax_flat_specs(tree, mesh, **kw):
    specs = jax_specs(jax.tree_util.tree_map(np.asarray, tree), mesh, **kw)
    flat = jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: hasattr(x, "spec"))
    return {".".join(str(k.key) for k in path): tuple(s.spec) for path, s in flat}


def _port_flat_specs(tree, mesh, **kw):
    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    return dict(walk(sharding.logical_to_sharding(tree, mesh, **kw), ""))


def _trees():
    jcfg = tiny_train_cfg(dit=dict(num_heads=4))
    v1 = vc_tree(jcfg.model_params, seed=3)
    vcfg = tiny_v2cfg()
    _, v2 = v2_trees(vcfg, frozen=False)
    return [("v1", v1, VCModel(port_cfg(jcfg.model_params))),
            ("v2", v2, V2Modules(v2_port_cfg(vcfg)))]


@pytest.mark.parametrize("fsdp", [None, "data"])
def test_specs_match_jax(fsdp):
    jmesh = jax_make_mesh(4, 2)
    pm = pmesh.Mesh(4, 2)
    kw = dict(fsdp_axis=fsdp, fsdp_min_elems=1024)
    for name, tree, module in _trees():
        want = _jax_flat_specs(tree, jmesh, **kw)
        got = _port_flat_specs(tree, pm, **kw)
        assert got == want, name
        # the rules split something, and (v2) leave the AR's flat FFN whole
        assert any("model" in s for s in got.values()), name
        if name == "v2":
            ffn = {k: s for k, s in got.items() if "feed_forward_w" in k}
            assert ffn and all("model" not in s for s in ffn.values())
            assert got["ar.layers_0.attention.wqkv.kernel"][1] == "model"
        # the port's own parameters give the same specs over flax dimensions
        by_module = sharding.module_specs(module, pm, **kw)
        flat = {}
        for n, p in module.named_parameters():
            path, fshape, _ = sharding.flax_view(module, n, tuple(p.shape))
            flat[path] = by_module[n][0]
            assert fshape == tuple(np.shape(_leaf(tree, path))), path
        assert flat == {k: v for k, v in want.items() if k in flat}, name
        assert set(flat) == set(want), name


def _leaf(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def test_fsdp_spec_augmentation_matches_jax():
    """test_multichip.py::test_fsdp_spec_augmentation's tree on both sides."""
    tree = {"layers_0": {"attention": {"wqkv": {"kernel": np.zeros((64, 192))}},
                         "feed_forward": {"w2": {"kernel": np.zeros((256, 64))}}},
            "embed": {"kernel": np.zeros((128, 64))}, "tiny": {"bias": np.zeros((64,))},
            "other": {"kernel": np.zeros((7, 3))}}
    for fsdp in (None, "data"):
        kw = dict(fsdp_axis=fsdp, fsdp_min_elems=1024)
        assert (_port_flat_specs(tree, pmesh.Mesh(4, 2), **kw)
                == _jax_flat_specs(tree, jax_make_mesh(4, 2), **kw))


def test_initialize_without_launcher_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(distributed, "_initialized", False)
    assert distributed.initialize() is False
    assert distributed.is_coordinator() and distributed.process_index() == 0
    assert not torch.distributed.is_initialized()


def test_seq_shard_axis_raises_item_3c_ii():
    """Item 3c(ii) is ported; what raises now is a ``seq_shard_axis`` named
    outside any ``set_mesh`` block."""
    z = torch.zeros
    with pytest.raises(ValueError, match="outside a set_mesh"):
        euler_solve(None, z(1, 4, 2), z(1, 4, 3), None, z(1, 4, 2), 0, z(1, 2), 1,
                    seq_shard_axis="model")
    with pytest.raises(ValueError, match="outside a set_mesh"):
        euler_solve_multicfg(None, z(1, 4, 2), z(1, 4, 3), None, z(1, 4, 2), 0, z(1, 2),
                             seq_shard_axis="model")
    vc = VoiceConverter(_port_cfg(), device="cpu", seq_shard_axis="model",
                        whisper_cfg=WhisperEncoderConfig(**WHISPER),
                        vocoder_cfg=BigVGANConfig(**VOC), prompt_cap_frames=PROMPT_CAP,
                        context_frames=CONTEXT)
    assert vc.seq_shard_axis == "model"
    with pytest.raises(ValueError, match="outside a set_mesh"):
        vc.convert(_audio(200, 180.0, 0), SR, _audio(50, 240.0, 1), SR, diffusion_steps=2)
