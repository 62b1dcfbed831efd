"""Train, prefill and serve steps; the sharding layers are not ported yet."""
