"""ar_decode_roofline.v2: see ``vcbench.readers_v2.ar_decode_roofline``."""

from vcbench.readers_v2 import ar_decode_roofline as read  # noqa: F401
