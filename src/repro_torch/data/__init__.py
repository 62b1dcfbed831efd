"""Deterministic synthetic token stream (``pipeline``), numpy only."""
