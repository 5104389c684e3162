"""prep_ms.train: see ``vcbench.readers.prep_ms``."""

from vcbench.readers import prep_ms as read  # noqa: F401
