"""queue_wait_ms.train: see ``vcbench.spans.queue_wait_ms``."""

from vcbench.spans import queue_wait_ms as read  # noqa: F401
