"""device_idle.svc: see ``vcbench.readers.idle_share``."""

from vcbench.readers import idle_share as read  # noqa: F401
