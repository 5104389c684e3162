"""Build the package's CUDA sources and load them with ``ctypes``.

Each source under ``seedvc_tpu_torch/csrc/`` is compiled by ``nvcc`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds); the ``*.cuh`` headers there are shared between sources.
Libraries go to ``build/kernels/`` at the repo root, named by a hash of the
source, the headers and the flags, and are built at first use. ``build()``
starts one ``nvcc`` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"attention": "attention.cu", "attention_bwd": "attention_bwd.cu",
           "anti_alias": "anti_alias.cu", "ar_decode": "ar_decode.cu"}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
PTXAS_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    # the shared headers count too: a source may include any of them
    src = b"".join(p.read_bytes() for p in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, in
    parallel. Returns the seconds each build took; raises on any failure."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    seconds, errors = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        PTXAS_LOG[n] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
