"""AdamW with a cosine schedule and global-norm clipping (``adamw``)."""
