"""f0_s_per_audio_s.svc: see ``vcbench.readers_svc.f0_s_per_audio_s``."""

from vcbench.readers_svc import f0_s_per_audio_s as read  # noqa: F401
