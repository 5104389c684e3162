"""k1_roofline.svc: see ``vcbench.readers.k1_roofline`` (12 heads, from the
configuration)."""

from vcbench.readers import k1_roofline as read  # noqa: F401
