"""k2_roofline.svc: see ``vcbench.readers.k2_roofline`` (the 44.1 kHz
vocoder's stage shapes, from the configuration)."""

from vcbench.readers import k2_roofline as read  # noqa: F401
