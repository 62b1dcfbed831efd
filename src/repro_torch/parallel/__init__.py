"""Train, prefill and serve steps, and the sharding layer (axis rules and sharding
profiles over DTensor); the collectives and the pipeline are not ported yet."""
