"""vocode_device_s_per_audio_s.v2: see ``vcbench.readers_v2.vocode_device_s_per_audio_s``."""

from vcbench.readers_v2 import vocode_device_s_per_audio_s as read  # noqa: F401
