"""vocode_device_s_per_audio_s.svc: see ``vcbench.spans.vocode_device_s_per_audio_s``."""

from vcbench.spans import vocode_device_s_per_audio_s as read  # noqa: F401
