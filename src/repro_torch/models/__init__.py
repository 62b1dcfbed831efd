"""Model definitions: ``config`` (ArchConfig), ``layers``, ``lm`` (LM), ``convert``."""
