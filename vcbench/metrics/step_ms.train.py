"""step_ms.train: see ``vcbench.readers.step_ms``."""

from vcbench.readers import step_ms as read  # noqa: F401
