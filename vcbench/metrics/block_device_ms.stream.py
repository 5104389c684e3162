"""block_device_ms.stream: see ``vcbench.spans.block_device_ms``."""

from vcbench.spans import block_device_ms as read  # noqa: F401
