"""sampler_device_ms_per_step.v2: see ``vcbench.readers_v2.sampler_device_ms_per_step``."""

from vcbench.readers_v2 import sampler_device_ms_per_step as read  # noqa: F401
