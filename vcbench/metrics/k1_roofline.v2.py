"""k1_roofline.v2: see ``vcbench.readers_v2.k1_roofline``."""

from vcbench.readers_v2 import k1_roofline as read  # noqa: F401
