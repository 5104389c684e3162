"""k2_roofline.v2: see ``vcbench.readers_v2.k2_roofline``."""

from vcbench.readers_v2 import k2_roofline as read  # noqa: F401
