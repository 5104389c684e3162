"""The hand-written kernels' launch counters, read and written as one record
``{"k1", "k2", "k3"}``: ``attention.LAUNCHES`` (K1),
``anti_alias.LAUNCHES`` (K2) and ``attention.DIT_ATTENTION_LAUNCHES`` (K3).

Each wrapper adds one when Python launches its kernel. A CUDA graph breaks
that in both directions: its capture runs the wrappers, which count, while
the device runs nothing, and its replays run the captured kernels with no
wrapper called. Two rules are in use:

- The offline sampler (``models/cfm.py::EulerGraph``) keeps the counters
  equal to what the device ran: :func:`captured` measures what one replay
  launches and takes the capture's count back out, :func:`replayed` adds
  ``n`` replays' launches.
- The stream's block program (``pipelines/streaming.py``) and the AR
  decoder (``models/ar.py``) leave the capture's count in and expose
  ``graph_launches`` (what one replay launches, by :func:`counts` before and
  after the capture) and ``replays`` for their readers to combine; the AR
  decoder counts its own kernels (``ops/ar_decode.py``'s ``LAUNCHES``) the
  same way, as ``fused_launches``.
"""

from __future__ import annotations

import contextlib

from seedvc_tpu_torch.ops import anti_alias, attention


def counts() -> dict[str, int]:
    """The counters now."""
    return {"k1": attention.LAUNCHES, "k2": anti_alias.LAUNCHES,
            "k3": attention.DIT_ATTENTION_LAUNCHES}


def _set(c: dict[str, int]) -> None:
    attention.LAUNCHES, anti_alias.LAUNCHES, attention.DIT_ATTENTION_LAUNCHES = (
        c["k1"], c["k2"], c["k3"])


@contextlib.contextmanager
def captured():
    """Around a CUDA graph's capture: yields a dict that holds, on exit,
    what the captured work launches of each kernel (what one replay
    launches), and puts the counters back as they were, since the capture
    ran nothing."""
    before, launched = counts(), {}
    try:
        yield launched
    finally:
        launched.update({k: v - before[k] for k, v in counts().items()})
        _set(before)


def replayed(launched: dict[str, int], n: int) -> None:
    """Add what ``n`` replays of a graph launched, one replay launching
    ``launched`` (as :func:`captured` gave it)."""
    _set({k: v + n * launched[k] for k, v in counts().items()})
