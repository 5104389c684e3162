"""block_host_ms.stream: see ``vcbench.spans.block_host_ms``."""

from vcbench.spans import block_host_ms as read  # noqa: F401
