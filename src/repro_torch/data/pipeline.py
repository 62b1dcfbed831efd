"""Deterministic synthetic token pipeline, shardable per DP rank.

The port's own copy of the reference's numpy-only pipeline (same arithmetic, so
both produce the same batches for the same (seed, step)); the trainer moves the
numpy batches to the device.

Every batch is a pure function of (seed, step), so any rank — or a restarted
replacement rank after a failure — regenerates exactly its shard without
coordination.  Structure in the stream (a repeating Markov-ish walk) gives
the model something learnable so the e2e example's loss visibly drops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # modality stubs (whisper/VLM): emit fixed frame/patch embeddings
    audio_seq: int = 0
    vision_seq: int = 0
    d_model: int = 0


def modality_inputs(arch, batch: int, generator: torch.Generator,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random inputs for the modalities ``arch`` attends to, by batch key: audio
    frames for a model with an encoder, image patches for one with vision
    cross-attention, none for the others.  N(0, 0.02^2) at d_model, as
    :class:`SyntheticLM` makes them, drawn in fp32 from ``generator`` on
    ``device`` and returned in the model's dtype."""
    out = {}
    for key, n, on in (("audio_embed", arch.audio_seq, arch.encoder_layers),
                       ("vision_embed", arch.vision_seq, arch.cross_attn_every)):
        if on:
            out[key] = (torch.randn((batch, n, arch.d_model), generator=generator,
                                    device=device, dtype=torch.float32) * 0.02
                        ).to(arch.torch_dtype)
    return out


class SyntheticLM:
    """Deterministic structured token stream.

    tokens[t+1] = (a * tokens[t] + walk) % vocab with per-sequence (a, walk)
    drawn from (seed, step, row) — learnable short-range structure.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        B, S, V = c.global_batch, c.seq_len, c.vocab
        a = rng.integers(1, 5, size=(B, 1))
        start = rng.integers(0, V, size=(B, 1))
        idx = np.arange(S + 1)[None, :]
        toks = (start + a * idx) % V
        noise = rng.integers(0, V, size=(B, S + 1))
        keep = rng.random((B, S + 1)) < 0.98
        toks = np.where(keep, toks, noise).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.audio_seq:
            r = np.random.default_rng((c.seed, 7, step))
            out["audio_embed"] = (r.standard_normal(
                (B, c.audio_seq, c.d_model)) * 0.02).astype(np.float32)
        if c.vision_seq:
            r = np.random.default_rng((c.seed, 9, step))
            out["vision_embed"] = (r.standard_normal(
                (B, c.vision_seq, c.d_model)) * 0.02).astype(np.float32)
        return out

    def shard(self, step: int, rank: int, world: int,
              shares: tuple[float, ...] | None = None) -> dict[str, np.ndarray]:
        """This rank's rows — supports the planner's *uneven* batch shares
        for heterogeneous DP (paper §4.1)."""
        full = self.batch(step)
        B = self.cfg.global_batch
        if shares is None:
            lo = B * rank // world
            hi = B * (rank + 1) // world
        else:
            cuts = np.floor(np.cumsum((0.0,) + shares) * B).astype(int)
            lo, hi = cuts[rank], cuts[rank + 1]
        return {k: v[lo:hi] for k, v in full.items()}
