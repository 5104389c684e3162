"""convert_mfu.v2: see ``vcbench.readers_v2.convert_mfu``."""

from vcbench.readers_v2 import convert_mfu as read  # noqa: F401
