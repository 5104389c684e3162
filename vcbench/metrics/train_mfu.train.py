"""train_mfu.train: see ``vcbench.readers.train_mfu``."""

from vcbench.readers import train_mfu as read  # noqa: F401
