"""Deterministic synthetic LM data pipeline.

Port of ``src/repro/data/tokens.py``, in NumPy as the reference is, so a
batch is byte-equal to the reference's for every (seed, step).

A Zipf-distributed Markov-ish token stream with enough local structure that
cross-entropy demonstrably falls during the example training runs (pure
uniform noise would sit at ln(V) forever). Deterministic per (seed, step):
restarting from a checkpoint replays the exact same batches — this is what
makes the fault-tolerance test exact, and it is how a real deterministic
data pipeline (e.g. grain) behaves. The ``audio`` and ``vlm`` keys are
produced as the reference produces them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLMDataset", "batch_iterator"]


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"  # 'audio' and 'vlm' add modality stubs
    d_frontend: int = 0
    n_image_tokens: int = 0

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        # Zipf unigrams + a deterministic "copy previous token block" motif
        # that a causal model can learn.
        base = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64) % v
        period = 8
        for t in range(period, s + 1):
            copy_mask = (t % period) < (period // 2)
            if copy_mask:
                base[:, t] = base[:, t - period]
        tokens = base[:, :s].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        batch = {"tokens": tokens, "labels": labels}
        if self.family == "audio":
            frames = rng.normal(size=(b, s, self.d_frontend)).astype(np.float32)
            batch = {
                "frames": frames,
                "labels": (base[:, :s] % v).astype(np.int32),
                "mask": rng.random((b, s)) < 0.08,
            }
        elif self.family == "vlm":
            batch["image_embeds"] = rng.normal(
                size=(b, self.n_image_tokens, self.d_frontend)
            ).astype(np.float32)
        return batch


def batch_iterator(ds: SyntheticLMDataset, start_step: int = 0):
    step = start_step
    while True:
        yield step, ds.batch(step)
        step += 1
