"""Input sources for the session (counterpart of ``repro.data.loader``).

A source's ``batch(epoch)`` returns the epoch's over-provisioned global
batch: ``n_workers * per_worker`` sequences in worker-contiguous blocks;
the eq.-3 weights pick each worker's first b_i(t) of them at step time.
Only the on-device :class:`SyntheticSource` is ported so far.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

class InputSource:
    """Contract: ``batch(epoch)`` is deterministic in ``epoch``."""

    n_workers: int = 1
    per_worker: int = 1

    @property
    def global_batch(self) -> int:
        return self.n_workers * self.per_worker

    def batch(self, epoch: int) -> dict:
        raise NotImplementedError


class SyntheticSource(InputSource):
    """Uniform random tokens drawn on the device (LM batches).

    Epoch e draws from a ``torch.Generator`` on ``device`` seeded from
    ``(seed, e)``; labels are the tokens shifted left, the last one masked
    (-1).  The entry point runs on the card unless ``device`` says
    otherwise, and raises if there is no card.
    """

    def __init__(self, vocab_size: int, seq_len: int, n_workers: int,
                 per_worker: int, seed: int = 0, device="cuda"):
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.n_workers = int(n_workers)
        self.per_worker = int(per_worker)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def batch(self, epoch: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 1_000_003 + int(epoch))
        gb = self.global_batch
        toks = torch.randint(0, self.vocab_size, (gb, self.seq_len),
                             generator=gen, device=self.device)
        labels = torch.cat([toks[:, 1:], torch.full(
            (gb, 1), -1, dtype=toks.dtype, device=self.device)], dim=1)
        return {"tokens": toks, "labels": labels}
