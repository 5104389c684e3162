"""sampler_device_ms_per_step.svc: see ``vcbench.spans.sampler_device_ms_per_step``."""

from vcbench.spans import sampler_device_ms_per_step as read  # noqa: F401
