"""encoder_device_ms.stream: see ``vcbench.spans.encoder_device_ms``."""

from vcbench.spans import encoder_device_ms as read  # noqa: F401
