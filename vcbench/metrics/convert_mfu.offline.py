"""convert_mfu.offline: see ``vcbench.readers.convert_mfu``."""

from vcbench.readers import convert_mfu as read  # noqa: F401
