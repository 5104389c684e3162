"""k1f32_roofline.train: see ``vcbench.readers.k1f32_roofline``."""

from vcbench.readers import k1f32_roofline as read  # noqa: F401
