"""convert_mfu.svc: see ``vcbench.readers_svc.convert_mfu``."""

from vcbench.readers_svc import convert_mfu as read  # noqa: F401
