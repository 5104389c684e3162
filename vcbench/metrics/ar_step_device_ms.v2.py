"""ar_step_device_ms.v2: see ``vcbench.readers_v2.ar_step_device_ms``."""

from vcbench.readers_v2 import ar_step_device_ms as read  # noqa: F401
