"""k2_roofline.offline: see ``vcbench.readers.k2_roofline``."""

from vcbench.readers import k2_roofline as read  # noqa: F401
