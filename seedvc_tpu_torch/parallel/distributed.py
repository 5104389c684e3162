"""Process-group start-up (port of ``seedvc_tpu/parallel/distributed.py``).

The JAX package starts its multi-process runtime with
``jax.distributed.initialize`` from ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; after it, every device of every
host is one device of the mesh. The PyTorch idiom is one process per GPU:
a launcher such as ``torchrun --nproc-per-node N`` starts the processes and
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`initialize` reads them, binds ``cuda:LOCAL_RANK``
and joins the default process group (NCCL for cuda, gloo for the CPU). The
(data, model) mesh of :mod:`seedvc_tpu_torch.parallel.mesh` is then laid over
the group's ranks.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device=None, backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> bool:
    """Idempotent start of the default process group.

    Returns True once a process group is up, False when running as one
    process: no ``init_method`` was given and the launcher's
    ``MASTER_ADDR`` / ``WORLD_SIZE`` are not set, so callers can call this
    unconditionally before :func:`~seedvc_tpu_torch.parallel.mesh.make_mesh`.
    ``init_method`` is any ``torch.distributed`` rendezvous URL (``env://``,
    ``tcp://host:port``, ``file:///path``); ``world_size`` / ``rank`` default
    to ``WORLD_SIZE`` / ``RANK``. ``device`` (default ``cuda``): a cuda device
    binds ``cuda:LOCAL_RANK`` (or the device given with an index) and takes
    NCCL, ``cpu`` takes gloo; ``backend`` overrides that choice (gloo with
    cuda tensors lets several ranks share one card, which NCCL refuses)."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    env = os.environ
    if init_method is None:
        if not ("MASTER_ADDR" in env and "WORLD_SIZE" in env):
            return False  # one process
        init_method = "env://"
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device; pass device='cpu' for gloo on the CPU")
        index = device.index if device.index is not None else int(env.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timeout or datetime.timedelta(minutes=10))
    _initialized = True
    return True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Rank 0: the process that writes checkpoints and exports."""
    return process_index() == 0
