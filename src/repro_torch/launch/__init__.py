"""Entry points: the training launcher (``train``)."""
