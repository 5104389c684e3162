"""sampler_host_ms_per_step.offline: see ``vcbench.spans.sampler_host_ms_per_step``."""

from vcbench.spans import sampler_host_ms_per_step as read  # noqa: F401
