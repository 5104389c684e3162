"""ar_s_per_audio_s.v2: see ``vcbench.readers_v2.ar_s_per_audio_s``."""

from vcbench.readers_v2 import ar_s_per_audio_s as read  # noqa: F401
