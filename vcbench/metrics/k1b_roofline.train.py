"""k1b_roofline.train: see ``vcbench.readers.k1b_roofline``."""

from vcbench.readers import k1b_roofline as read  # noqa: F401
