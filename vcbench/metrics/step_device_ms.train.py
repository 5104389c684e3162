"""step_device_ms.train: see ``vcbench.spans.step_device_ms``."""

from vcbench.spans import step_device_ms as read  # noqa: F401
