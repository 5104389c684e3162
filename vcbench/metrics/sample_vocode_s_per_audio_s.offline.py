"""sample_vocode_s_per_audio_s.offline: see ``vcbench.readers.sample_vocode_per_audio_s``."""

from vcbench.readers import sample_vocode_per_audio_s as read  # noqa: F401
