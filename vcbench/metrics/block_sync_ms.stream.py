"""block_sync_ms.stream: see ``vcbench.readers.block_sync_ms``."""

from vcbench.readers import block_sync_ms as read  # noqa: F401
