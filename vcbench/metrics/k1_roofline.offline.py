"""k1_roofline.offline: see ``vcbench.readers.k1_roofline``."""

from vcbench.readers import k1_roofline as read  # noqa: F401
