"""Coded gradient redundancy: overlapping data shards, decoded through the
sequence weights (counterpart of ``repro.dist.redundancy``).

AMB's variable minibatch already tolerates workers that are only slow: a
straggler's b_i(t) shrinks and its weights vanish from the eq.-6
average.  A worker that vanishes loses every sample assigned to it.  The
gradient-coding line of work (Tandon et al.; Karakus et al.,
arXiv:1803.05397; Li et al., arXiv:1710.09990; see PAPERS.md) places
each distinct sample on ``rho`` workers so that the survivors still
cover it.  This module implements the fractional-repetition scheme with
rotated overlapping shards:

  * **Placement** (:class:`CodedAssignment`): the ``n`` workers form
    ``n / rho`` groups of ``rho``; every member of group g holds group
    g's data block, member m rotated by ``m * per / rho`` slots, so the
    partial minibatches of distinct members cover complementary slots
    before they overlap, and one member with b_i = per covers the block.
  * **Decode** (:meth:`CodedAssignment.decode_weights`,
    :func:`epoch_weights`): each included sample of a worker weighs
    ``1 / copies``, where ``copies`` counts the group members whose
    minibatches cover that distinct slot this epoch.  Every covered slot
    then weighs exactly 1 across the fleet, so the eq.-6 weighted mean
    gradient is the plain mean over the distinct covered samples, with
    no decode step: the weights go through ``lm_loss`` and the ``n b_i``
    weight column of the consensus payload.

Slot s of member m holds block slot ``(s + shift_m) % per``
(:class:`repro_torch.data.StreamSource` rolls the block by ``-shift_m``),
and the decode gathers copies at the same index.  ``rho = 1`` (or no
assignment) runs the uncoded eq.-3 ops of :func:`seq_weights_from_b`,
bit for bit.  The weights are plain torch: they reach no kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def seq_weights_from_b(b: torch.Tensor, global_batch: int,
                       n_workers: int) -> torch.Tensor:
    """(global_batch,) fp32 0/1 weights: worker i's first b_i of its
    ``global_batch // n_workers`` contiguous slots are included (eq. 3)."""
    if global_batch % n_workers:
        raise ValueError(f"global_batch {global_batch} not divisible by "
                         f"{n_workers} workers")
    per = global_batch // n_workers
    idx = torch.arange(global_batch, device=b.device)
    return ((idx % per) < b[idx // per]).float()


@dataclasses.dataclass(frozen=True)
class CodedAssignment:
    """Fractional-repetition placement of data blocks over ``n`` workers.

    Workers ``g*rho .. (g+1)*rho - 1`` form group g and all hold group g's
    block, member m rotated by ``m * per / rho`` slots; ``rho = 1`` is the
    uncoded layout.
    """

    n: int
    rho: int = 1

    def __post_init__(self):
        if self.rho < 1:
            raise ValueError(f"redundancy must be >= 1, got {self.rho}")
        if self.n % self.rho:
            raise ValueError(f"redundancy {self.rho} must divide the "
                             f"{self.n} workers (fractional-repetition "
                             f"groups)")

    @property
    def groups(self) -> int:
        return self.n // self.rho

    def group(self, i: int) -> int:
        return i // self.rho

    def data_nodes(self) -> np.ndarray:
        """Stream node per worker: the members of a group share one."""
        return np.arange(self.n) // self.rho

    def shifts(self, per: int) -> np.ndarray:
        """Rotation per worker (slots): member m of any group starts its
        minibatch at block slot ``m * per / rho``."""
        member = np.arange(self.n) % self.rho
        return (member * per) // self.rho

    def decode_weights(self, b: torch.Tensor, per: int) -> tuple:
        """(sw (n, per) fp32, bw_eff (n,) fp32) from this epoch's b_i(t).

        Worker i's slot s weighs ``1 / copies`` if ``s < b_i``, where
        ``copies`` counts the members of its group that cover the same
        distinct block slot this epoch, else 0; ``bw_eff`` is the row
        sum, and the fleet's sum is the number of distinct covered
        samples.
        """
        n, rho = self.n, self.rho
        bw = torch.clamp(b, max=per).to(torch.int32)
        if rho <= 1:
            # uncoded: the eq.-3 ops of seq_weights_from_b
            sw = seq_weights_from_b(b, n * per, n)
            return sw.reshape(n, per), bw.float()
        dev = b.device
        shift = self.shifts(per)
        slots = np.arange(per)
        # worker j covers block slot u iff its local position of u,
        # (u - shift_j) mod per, lies inside its minibatch
        local_of_block = torch.as_tensor(
            (slots[None, :] - shift[:, None]) % per, device=dev)
        covered = local_of_block < bw[:, None]                  # (n, per)
        copies = covered.reshape(self.groups, rho, per).sum(1)  # (G, per)
        # each worker's copy counts at its own (rotated) slots
        block_of_local = torch.as_tensor(
            (slots[None, :] + shift[:, None]) % per, device=dev)
        cw = torch.gather(copies.repeat_interleave(rho, dim=0), 1,
                          block_of_local)
        inside = torch.arange(per, device=dev)[None, :] < bw[:, None]
        sw = torch.where(inside,
                         1.0 / torch.clamp(cw, min=1).to(torch.float32),
                         0.0)
        # the row sums left to right, the order JAX's reduction takes,
        # so b(t) and the weight column agree with it bit for bit
        bw_eff = sw[:, 0].clone()
        for s in range(1, per):
            bw_eff += sw[:, s]
        return sw, bw_eff


def epoch_weights(b: torch.Tensor, n: int, per: int,
                  assignment: Optional[CodedAssignment] = None) -> tuple:
    """(sw (n, per), bw_eff (n,)) for one epoch, coded or uncoded.

    The one entry point of the train steps: no assignment (or ``rho =
    1``) is the eq.-3 path; a coded assignment gives the ``1/copies``
    decode weights (:meth:`CodedAssignment.decode_weights`).
    """
    if assignment is None:
        assignment = CodedAssignment(n, 1)
    if assignment.n != n:
        raise ValueError(f"assignment covers {assignment.n} workers, "
                         f"step has {n}")
    return assignment.decode_weights(b, per)
