"""The PyTorch port stands alone: no JAX, no fallbacks.

- neither ``chip_smoke.py``, ``tools/*.py`` nor any module of ``seedvc_tpu_torch`` imports
  ``jax``, ``flax`` or ``seedvc_tpu`` (AST scan, so lazy imports count too);
- ``VoiceConverter()``, ``SeedVCWrapper()``, ``StreamingConverter`` on a
  default converter, ``VoiceConverterV2()``, the AR's ``ARGenerator``, the
  trainers (v1 and v2), the web UI's ``ConverterRegistry()``, the OpenVoice
  baseline, and the infer, infer_v2, realtime, stream_bench, train,
  train_v2, eval and webui CLIs, given no device,
  raise when CUDA is absent (``device="cpu"`` / ``--device cpu`` is
  the only way to the CPU);
- the streaming path's SOLA loader never writes into ``native/`` (in
  tests/test_torch_streaming.py);
- the kernel build raises without ``nvcc``, and the wrappers refuse tensors
  that are on neither the CPU nor CUDA (the CUDA side of this is in
  tests/test_torch_cuda.py).
"""

import ast
from pathlib import Path

import pytest
import torch

from seedvc_tpu_torch.apps import baselines, infer, infer_v2, realtime, stream_bench, webui
from seedvc_tpu_torch.apps import eval as eval_app
from seedvc_tpu_torch.apps import train as train_app
from seedvc_tpu_torch.apps import train_v2 as train_v2_app
from seedvc_tpu_torch.models import ar
from seedvc_tpu_torch.ops import anti_alias, attention, build
from seedvc_tpu_torch.pipelines import convert, convert_v2, streaming, wrapper
from seedvc_tpu_torch.train import trainer, trainer_v2

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "seedvc_tpu")
PORT_FILES = (sorted((ROOT / "seedvc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").rglob("*.py")))


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
], ids=["converter_cuda", "wrapper", "wrapper_cuda0", "infer_cli", "streaming", "realtime_cli",
        "stream_bench", "converter_v2", "infer_v2_cli", "ar_generator", "trainer", "train_cli",
        "trainer_v2", "train_v2_cli", "webui_registry", "webui_cli", "eval_cli",
        "openvoice_baseline"])
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
