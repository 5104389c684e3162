"""No process of the benchmark loads JAX or the JAX package, compared by
whole top-level names; the frozen reference loads nothing of the port."""

import subprocess
import sys

from vcbench.run import forbidden_modules

from conftest import REPO


def test_names_are_compared_whole():
    assert forbidden_modules(["seedvc_tpu_torch", "seedvc_tpu_torch.ops.attention"]) == []
    assert forbidden_modules(["jaxtyping", "flaxen", "seedvc_tpu2"]) == []
    assert forbidden_modules(["seedvc_tpu.models.dit", "jax", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib", "seedvc_tpu"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded("import vcbench.ref.pipelines.convert, vcbench.ref.pipelines.streaming\n"
                  "import vcbench.control")
    assert "seedvc_tpu_torch" not in top and "seedvc_tpu" not in top
    assert not {"jax", "jaxlib", "flax"} & top


def test_the_harness_and_the_port_load_no_jax():
    top = _loaded("import vcbench.run, vcbench.spec, vcbench.v1, vcbench.readers\n"
                  "from vcbench.drivers import offline, stream, train\n"
                  "from vcbench.builders import voice_converter\n"
                  "import seedvc_tpu_torch.pipelines.convert, seedvc_tpu_torch.pipelines.streaming")
    assert not {"jax", "jaxlib", "flax", "seedvc_tpu"} & top
    assert "seedvc_tpu_torch" in top


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    import ast
    bad = []
    for path in (REPO / "vcbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "seedvc_tpu")]
    assert bad == []
