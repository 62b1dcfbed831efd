"""The training loop on one device (``trainer``)."""
