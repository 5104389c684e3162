"""vocode_device_s_per_audio_s.offline: see ``vcbench.spans.vocode_device_s_per_audio_s``."""

from vcbench.spans import vocode_device_s_per_audio_s as read  # noqa: F401
