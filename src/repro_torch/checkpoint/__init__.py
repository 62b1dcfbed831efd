"""Train-state checkpoints in the reference's on-disk format (``store``)."""
