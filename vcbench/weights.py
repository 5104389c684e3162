"""Random weights from the seed, made on the device in a few large draws.

Each module's parameters, in ``named_parameters`` order, take consecutive
pieces of one normal draw from a ``torch.Generator`` seeded with the run's
seed; a rule list in the configuration file maps a parameter's name to the
mean and spread of its piece. The program and the reference are filled from
the same draw, so they hold the same numbers (each in its own dtype): the
port's parameter names mirror the released checkpoints' (and so the frozen
reference's), which is what keeps the two sides' draws aligned.
"""

from __future__ import annotations

import math
import re

import torch


def _scale(rules: list, name: str, p: torch.Tensor) -> tuple[float, float]:
    """(mean, std) of the first rule whose pattern matches ``name``;
    ``"fan_in"`` as std is (3 * fan_in)^-1/2, fan_in = numel / shape[0]."""
    for pattern, mean, std in rules:
        if re.search(pattern, name):
            if std == "fan_in":
                fan_in = p.numel() // max(p.shape[0], 1) if p.dim() > 1 else p.numel()
                std = 1.0 / math.sqrt(3.0 * max(fan_in, 1))
            return float(mean), float(std)
    raise KeyError(f"no init rule matches parameter {name!r}")


@torch.no_grad()
def fill(modules: dict, rules: list, seed: int, device) -> int:
    """Fill every parameter of ``modules`` ({name: nn.Module}) from the seed:
    one draw a module. Returns the number of values drawn."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    total = 0
    for mname, mod in modules.items():
        params = list(mod.named_parameters())
        n = sum(p.numel() for _, p in params)
        flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
        off = 0
        for pname, p in params:
            mean, std = _scale(rules, f"{mname}.{pname}", p)
            piece = flat[off: off + p.numel()].view(p.shape)
            p.copy_(piece * std + mean)
            off += p.numel()
        total += n
        del flat
    return total

