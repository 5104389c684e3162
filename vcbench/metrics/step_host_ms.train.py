"""step_host_ms.train: see ``vcbench.spans.step_host_ms``."""

from vcbench.spans import step_host_ms as read  # noqa: F401
