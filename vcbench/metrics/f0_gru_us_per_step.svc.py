"""f0_gru_us_per_step.svc: see ``vcbench.readers_svc.f0_gru_us_per_step``."""

from vcbench.readers_svc import f0_gru_us_per_step as read  # noqa: F401
