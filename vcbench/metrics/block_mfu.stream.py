"""block_mfu.stream: see ``vcbench.readers.block_mfu``."""

from vcbench.readers import block_mfu as read  # noqa: F401
