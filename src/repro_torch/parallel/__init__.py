"""Prefill and serve steps; the sharding layers are not ported yet."""
