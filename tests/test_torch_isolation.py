"""The PyTorch port stands alone: no JAX, no fallbacks.

- neither ``chip_smoke.py``, ``tools/*.py``, the reference-layout writer
  ``tests/torch_ref_checkpoints.py`` (which ``chip_smoke.py`` imports), the
  multi-process tests' ranks ``tests/torch_parallel_worker.py`` nor any
  module of ``seedvc_tpu_torch`` (``parallel/*`` among them) imports ``jax``,
  ``flax`` or ``seedvc_tpu`` (AST scan, so lazy imports count too);
- the checkpoint path (``convert/*``, ``core/hub.py``,
  ``apps/convert_checkpoint.py``) imports no ``safetensors`` and
  ``huggingface_hub`` only inside ``hub._download``, and the conversion CLI
  converts a ``.safetensors`` Whisper in a process where ``safetensors``,
  ``huggingface_hub``, ``jax``, ``flax`` and ``transformers`` cannot be
  imported;
- ``VoiceConverter()``, ``SeedVCWrapper()``, ``StreamingConverter`` on a
  default converter, ``VoiceConverterV2()``, the AR's ``ARGenerator``, the
  trainers (v1 and v2), the web UI's ``ConverterRegistry()``, the OpenVoice
  baseline, and the infer, infer_v2, realtime, stream_bench, train,
  train_v2, eval and webui CLIs, given no device, and the multi-GPU entry
  points (``parallel.distributed.initialize`` under a launcher's
  environment, the trainers and their CLIs with ``n_model`` / ``fsdp``)
  raise when CUDA is absent (``device="cpu"`` / ``--device cpu`` is the only
  way to the CPU);
- the streaming path's SOLA loader never writes into ``native/`` (in
  tests/test_torch_streaming.py);
- the kernel build raises without ``nvcc``, and the wrappers refuse tensors
  that are on neither the CPU nor CUDA (the CUDA side of this is in
  tests/test_torch_cuda.py).
"""

import ast
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from seedvc_tpu_torch.apps import baselines, infer, infer_v2, realtime, stream_bench, webui
from seedvc_tpu_torch.apps import eval as eval_app
from seedvc_tpu_torch.apps import train as train_app
from seedvc_tpu_torch.apps import train_v2 as train_v2_app
from seedvc_tpu_torch.models import ar
from seedvc_tpu_torch.ops import anti_alias, attention, build
from seedvc_tpu_torch.parallel import distributed
from seedvc_tpu_torch.pipelines import convert, convert_v2, streaming, wrapper
from seedvc_tpu_torch.train import trainer, trainer_v2

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "seedvc_tpu")
PORT_FILES = (sorted((ROOT / "seedvc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").rglob("*.py")) + [ROOT / "tests/torch_ref_checkpoints.py",
                                                          ROOT / "tests/torch_parallel_worker.py"])
CHECKPOINT_FILES = (sorted((ROOT / "seedvc_tpu_torch/convert").glob("*.py"))
                    + [ROOT / "seedvc_tpu_torch/core/hub.py",
                       ROOT / "seedvc_tpu_torch/apps/convert_checkpoint.py"])


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checkpoint_path_is_in_the_scan():
    assert set(CHECKPOINT_FILES) <= set(PORT_FILES) and len(CHECKPOINT_FILES) == 16


def test_parallel_package_is_in_the_scan():
    names = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    assert names == {"__init__.py", "collectives.py", "distributed.py", "mesh.py",
                     "sharding.py"}


def _imports_by_function(path: Path):
    """(imported root, name of the enclosing function or None) of each import."""
    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
            elif isinstance(child, ast.Import):
                yield from ((a.name.split(".")[0], fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and child.level == 0:
                yield child.module.split(".")[0], fn
            else:
                yield from walk(child, fn)

    yield from walk(ast.parse(path.read_text(), str(path)), None)


@pytest.mark.parametrize("path", CHECKPOINT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_checkpoint_path_needs_no_optional_packages(path):
    for root, fn in _imports_by_function(path):
        assert root != "safetensors", f"{path.relative_to(ROOT)} imports safetensors"
        if root == "huggingface_hub":
            assert path.name == "hub.py" and fn == "_download", (path, fn)


def test_convert_cli_runs_without_optional_packages(tmp_path):
    """A 12-layer Whisper (the CLI's fixed depth) at width 8 written as
    ``model.safetensors``, converted in a process that cannot import the
    optional packages."""
    import torch_ref_checkpoints as W
    from seedvc_tpu_torch.models.whisper import WhisperEncoder, WhisperEncoderConfig
    from seedvc_tpu_torch.weights import to_jax_params

    torch.manual_seed(0)
    tree = to_jax_params(WhisperEncoder(WhisperEncoderConfig(d_model=8, n_layers=12, n_heads=2,
                                                             ffn_dim=16, max_positions=16)))
    paths = W.write_zoo(str(tmp_path), {"whisper": W.write_whisper(tree)})
    code = ("import sys\n"
            "for m in ('safetensors', 'huggingface_hub', 'jax', 'flax', 'transformers'):\n"
            "    sys.modules[m] = None\n"
            "from seedvc_tpu_torch.apps import convert_checkpoint\n"
            "import seedvc_tpu_torch.core.hub\n"
            "convert_checkpoint.main(sys.argv[1:])\n")
    out = tmp_path / "out"
    r = subprocess.run([sys.executable, "-c", code, "--out", str(out), *W.cli_args(paths)],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == f"wrote {out / 'whisper.pkl'}"
    with open(out / "whisper.pkl", "rb") as f:
        got = pickle.load(f)
    assert (got["layers_11"]["fc2"]["kernel"] == tree["layers_11"]["fc2"]["kernel"]).all()


def test_voice_converter_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.VoiceConverter()


@pytest.mark.parametrize("make", [
    lambda: convert.VoiceConverter(device="cuda"),
    lambda: wrapper.SeedVCWrapper(),
    lambda: wrapper.SeedVCWrapper(device="cuda:0"),
    lambda: infer.main(["--source", "s.wav", "--target", "r.wav", "--f0-condition", "true"]),
    lambda: streaming.StreamingConverter(convert.VoiceConverter(convert.get_preset("xlsr_tiny"))),
    lambda: realtime.main(["--reference", "r.wav", "--simulate", "s.wav", "--save-settings",
                           "false"]),
    lambda: stream_bench.main([]),
    lambda: convert_v2.VoiceConverterV2(),
    lambda: infer_v2.main(["--source", "s.wav", "--target", "r.wav"]),
    lambda: ar.ARGenerator(ar.ARTransformer(ar.ARConfig(dim=32, n_layer=1, n_head=4,
                                                        n_local_heads=2, head_dim=8,
                                                        intermediate_size=32, vocab_size=9))),
    lambda: trainer.Trainer(convert.get_preset("whisper_small_wavenet"),
                            trainer.TrainerConfig(run_dir="")),
    lambda: train_app.main(["--dataset-dir", "d"]),
    lambda: trainer_v2.TrainerV2(convert_v2.V2Config(), trainer_v2.TrainerV2Config()),
    lambda: train_v2_app.main(["--dataset-dir", "d"]),
    lambda: webui.ConverterRegistry(),
    lambda: webui.main(["--port", "0", "--warm", "10:5"]),
    lambda: eval_app.main(["--source-dir", "s", "--target-dir", "t"]),
    lambda: baselines.OpenVoiceBaseline("openvoice.pkl"),
    lambda: distributed.initialize("file:///nonexistent/store", 2, 0),
    lambda: trainer.Trainer(convert.get_preset("whisper_small_wavenet"),
                            trainer.TrainerConfig(run_dir="", fsdp=True), n_model=2),
    lambda: train_app.main(["--dataset-dir", "d", "--n-model", "2", "--fsdp"]),
    lambda: trainer_v2.TrainerV2(convert_v2.V2Config(), trainer_v2.TrainerV2Config(fsdp=True),
                                 n_model=2),
    lambda: train_v2_app.main(["--dataset-dir", "d", "--n-model", "2", "--fsdp"]),
], ids=["converter_cuda", "wrapper", "wrapper_cuda0", "infer_cli", "streaming", "realtime_cli",
        "stream_bench", "converter_v2", "infer_v2_cli", "ar_generator", "trainer", "train_cli",
        "trainer_v2", "train_v2_cli", "webui_registry", "webui_cli", "eval_cli",
        "openvoice_baseline", "dist_initialize", "trainer_multi_gpu", "train_cli_multi_gpu",
        "trainer_v2_multi_gpu", "train_v2_cli_multi_gpu"])
def test_entry_points_need_cuda_unless_cpu(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_wrapper_on_cpu_builds_nothing_until_used(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = wrapper.SeedVCWrapper(device="cpu")
    assert w.device.type == "cpu" and w._converters == {}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("attention")


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA gets an error, not
    the plain twin."""
    q = torch.empty((1, 1, 64, 64), device="meta")
    cs = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.dit_attention_fused(q, q, q, cs, cs)
    with pytest.raises(ValueError, match="unsupported device"):
        attention.dit_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        attention.dit_attention_fused_bwd(q, q, q, cs, cs, None, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        attention.dit_attention_bwd(q, q, q, None, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        anti_alias.anti_alias_snake(torch.empty((1, 4, 16), device="meta"),
                                    torch.empty(4, device="meta"), torch.empty(4, device="meta"))
