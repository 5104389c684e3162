"""device_idle.train: see ``vcbench.readers.idle_share``."""

from vcbench.readers import idle_share as read  # noqa: F401
