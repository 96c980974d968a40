"""Slot engine: continuous batching over a fixed-shape decode batch
(counterpart of ``repro.serve.slots``).

The decode batch is a fixed array of ``slots`` rows sharing one
``decode_step``: per-slot KV rows and positions
(:func:`repro_torch.models.init_decode_state` with ``per_slot_pos=True``).
Requests are prefilled one at a time (batch 1), through the flash kernel
(dense; the hybrid's shared block) or the wkv scan kernel (ssm) on the
card (vlm prompts go in as
their embedding rows, ``prompt_batch``; over a model axis the
vocab-parallel lookup), and written into a free
row by :func:`repro_torch.models.insert_decode_state`; retirement (EOS or
token budget) frees the row and zeroes it
(:func:`repro_torch.models.evict_decode_state`).  Bucketing is
family-aware, as in JAX: dense prompts are right-padded to the next
power-of-two bucket (causal attention keeps the real prefix independent of
trailing pads, and the padded cache rows stay masked until decode
overwrites them); MoE prompts (pads would compete with real tokens for
expert capacity) and ssm prompts (a recurrent state absorbs pads) prefill
at their exact length.  Linear caches only: the engine refuses a sliding
window (ring caches are sized by prompt length at prefill) and the audio
family, with JAX's messages.

Over a process group (``group``, a :class:`repro_torch.dist.group.
WorkerGroup`; ``tp``, its :class:`repro_torch.dist.tp.TensorParallel`
under the serving layout when each worker spans M > 1 model ranks) the
slot rows lie on the workers as JAX's ``decode_state_specs`` puts the
batch on the worker axes: when the n workers divide the slots, worker j
owns rows ``j * slots / n`` to ``(j + 1) * slots / n`` and holds their
caches (each of its model ranks its KV heads', or its RWKV6 or Mamba2
heads' states), else every worker holds every row.  A request is prefilled by the worker that owns its slot
(its model ranks together); its first token's logits go to every rank
from the owner.  A decode round runs every worker on its rows, then one
all-gather over the group puts the whole (slots, vocab) logits on every
rank, so every rank samples the same tokens (``_Sampler`` as in one
process) and keeps the same ``active`` and ``free_slots``.  An MoE
layer of the round gathers every worker's rows of its input and
dispatches the whole slot array as one group, as JAX's decode does, so
which assignment an expert at capacity drops is decided over every slot
(``models.decode_step``'s ``group``).  Evicting a slot zeroes its row on
the owning worker only.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from ..models import (decode_step, evict_decode_state, init_decode_state,
                      insert_decode_state, prefill)
from ..models.common import ArchConfig
from .request import Request
from .sampling import SamplingSpec, sample_generator, sample_token


def bucket_len(plen: int, cache_len: int, *, exact: bool) -> int:
    """Padded prefill length for a prompt of ``plen`` tokens."""
    if exact:
        return plen
    b = 8
    while b < plen:
        b *= 2
    return min(b, cache_len)


def prompt_batch(params: dict, cfg: ArchConfig, toks: torch.Tensor,
                 tp=None) -> dict:
    """The prefill's batch for prompt tokens: ``{"tokens"}``, or under
    ``input_mode == "embeds"`` (vlm) their embedding rows as
    ``{"embeds"}``, as JAX's engine feeds a stubbed front end (with ``tp``
    the vocab-parallel lookup, ``params`` this rank's rows: every model
    rank gets the whole rows)."""
    if cfg.input_mode != "embeds":
        return {"tokens": toks}
    if tp is not None:
        return {"embeds": tp.embed(params["embed"], toks)}
    return {"embeds": params["embed"][toks]}


class _Sampler:
    """Draw n of a run: greedy, or a generator seeded from (seed, n)."""

    def __init__(self, spec: SamplingSpec, device):
        self.spec, self.device, self.n = spec, device, 0

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        self.n += 1
        gen = None if self.spec.greedy else sample_generator(
            self.spec.seed, self.n, self.device)
        return sample_token(logits, gen, temperature=self.spec.temperature,
                            top_k=self.spec.top_k)


def _finish(req: Request, tok: int, eos_id: Optional[int]) -> bool:
    """Append ``tok``; mark and report retirement (EOS or token budget)."""
    req.out_tokens.append(tok)
    if eos_id is not None and tok == eos_id:
        req.finish_reason = "eos"
    elif len(req.out_tokens) >= req.max_new_tokens:
        req.finish_reason = "length"
    return req.done


class SlotEngine:
    """Continuous batching over ``slots`` fixed-shape decode rows.

    The engine is clock-free: it moves tokens, the scheduler stamps time.
    ``decode_round`` advances every row one token (inactive rows compute
    garbage that is ignored and overwritten on insert) and returns the
    requests that retired this round.  ``params`` is the parameter dict
    the engine decodes with; the scheduler loads the fine-tuned primal
    (:meth:`load_params`) after every absorbed epoch.  Over a process group ``params``
    is this rank's blocks under the serving layout (``group``, ``tp``;
    see the module note).
    """

    def __init__(self, params: dict, cfg: ArchConfig, *, slots: int,
                 cache_len: int, sampling: Optional[SamplingSpec] = None,
                 eos_id: Optional[int] = None, group=None, tp=None):
        if cfg.family == "audio":
            raise NotImplementedError(
                "serve: audio (encoder-decoder) requests need per-request "
                "encoder features; not supported by the slot engine")
        if cfg.sliding_window > 0:
            raise NotImplementedError(
                "serve: sliding-window ring caches are sized by prompt "
                "length at prefill and cannot be slot-inserted; serve "
                "with linear caches")
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.sampling = sampling or SamplingSpec()
        self.eos_id = eos_id
        if tp is not None and tp.fsdp_axis is not None:
            raise ValueError("the slot engine reads the serving layout: a "
                             "TensorParallel with fsdp_axis=None")
        self.group, self.tp = group, tp
        self.load_params(params)
        self.device = next(iter(params.values())).device
        # this worker's slot rows [r0, r1); every row when the workers do
        # not divide the slots
        n = 1 if group is None else group.n
        self._split = slots % n == 0 and n > 1
        per = slots // n if self._split else slots
        self.r0 = group.worker * per if self._split else 0
        self.r1 = self.r0 + per
        self.state = init_decode_state(cfg, per, cache_len,
                                       per_slot_pos=True, device=self.device,
                                       tp=tp)
        self.last_tok = torch.zeros((slots,), dtype=torch.long,
                                    device=self.device)
        self.active: list[Optional[Request]] = [None] * slots
        self.free_slots: list[int] = list(range(slots))
        self.buckets: set[int] = set()     # prefill lengths used so far
        # exact-length prefill where right-padding is unsound
        self._exact_len = cfg.family not in ("dense", "vlm")
        self._sample = _Sampler(self.sampling, self.device)

    def load_params(self, params: dict) -> None:
        """Decode with ``params`` from now on (``self.params``); over a
        model axis the RWKV6 leaves a rank reads whole are gathered once
        here (``tp.serving_leaves``), not at every prefill and decode
        step, so every rank loads together."""
        self.params, self._whole = (params, frozenset()) if self.tp is None \
            else self.tp.serving_leaves(params)

    def _holding(self):
        """The model calls' context: ``tp`` takes the leaves that
        :meth:`load_params` gathered as whole."""
        return contextlib.nullcontext() if self.tp is None \
            else self.tp.holding_whole(self._whole)

    # -- capacity ----------------------------------------------------------

    @property
    def has_free(self) -> bool:
        return bool(self.free_slots)

    @property
    def active_count(self) -> int:
        return self.slots - len(self.free_slots)

    # -- over a process group ----------------------------------------------

    def _mine(self, slot: int) -> bool:
        """Whether this worker holds slot row ``slot``."""
        return self.r0 <= slot < self.r1

    def _vocab_split(self) -> bool:
        return self.tp is not None and self.tp.split("unembed")

    def _columns(self, parts: list) -> torch.Tensor:
        """A worker's model ranks' columns of the logits, in model order,
        cut to the ``vocab_size`` columns after the gather (the split
        vocabulary is the padded one; unsplit, each rank's are whole)."""
        if not self._vocab_split():
            return parts[0]
        return torch.cat(parts, dim=-1)[..., :self.cfg.vocab_size]

    def _prefill_logits(self, logits, slot: int) -> torch.Tensor:
        """The whole (1, vocab_size) prefill logits on every rank: the
        owner's model ranks gather their columns, its first rank
        broadcasts them."""
        if self.group is None:
            return logits
        if self._mine(slot):
            if self._vocab_split():
                logits = self.tp.vocab_logits(logits,
                                              self.cfg.vocab_size).contiguous()
        else:
            logits = torch.empty((1, self.cfg.vocab_size),
                                 dtype=self.params["unembed"].dtype,
                                 device=self.device)
        if self._split:
            owner = slot // (self.r1 - self.r0)
            dist.broadcast(logits, src=owner * self.group.model)
        return logits

    def _round_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole (slots, vocab_size) logits of a decode round on every
        rank, from every rank's (rows, columns) block."""
        if self.group is None:
            return logits
        parts = self.group.gather_ranks(logits)
        m = self.group.model
        workers = self.group.n if self._split else 1
        return torch.cat([self._columns(parts[j * m:(j + 1) * m])
                          for j in range(workers)], dim=0)

    # -- lifecycle ---------------------------------------------------------

    def insert(self, req: Request) -> int:
        """Prefill ``req`` into a free slot; returns its first token.

        The prompt is padded to its bucket (moe, ssm: not padded),
        prefilled at batch 1 with ``last_pos`` at the real last token, and
        written into the slot row.  The first generated token is sampled
        from the prefill logits (so TTFT is one prefill, not prefill + a
        round).
        """
        if not self.free_slots:
            raise RuntimeError("no free slot")
        if req.prompt_len + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.rid}: {req.prompt_len}+{req.max_new_tokens} "
                f"tokens exceed cache_len={self.cache_len}")
        slot = self.free_slots.pop(0)
        bucket = bucket_len(req.prompt_len, self.cache_len,
                            exact=self._exact_len)
        self.buckets.add(bucket)
        toks = torch.tensor([req.prompt + [0] * (bucket - req.prompt_len)],
                            dtype=torch.long, device=self.device)
        logits = None
        if self._mine(slot):
            with self._holding():
                logits, one = prefill(
                    self.params, self.cfg,
                    prompt_batch(self.params, self.cfg, toks, self.tp),
                    extra_capacity=self.cache_len - bucket,
                    last_pos=req.prompt_len - 1, tp=self.tp)
            insert_decode_state(self.state, one, slot - self.r0)
            del one
        tok = self._sample(self._prefill_logits(logits, slot))
        self.last_tok[slot] = tok[0]
        first = int(tok[0])
        req.slot = slot
        self.active[slot] = req
        if _finish(req, first, self.eos_id):
            self._retire(req)
        return first

    def _retire(self, req: Request) -> None:
        slot = req.slot
        if self._mine(slot):
            evict_decode_state(self.state, slot - self.r0)
        self.active[slot] = None
        self.free_slots.append(slot)

    def decode_round(self) -> list[Request]:
        """Advance every slot one token; returns requests retired now."""
        if self.active_count == 0:
            return []
        with self._holding():
            logits, self.state = decode_step(
                self.params, self.cfg, self.state,
                self.last_tok[self.r0:self.r1], tp=self.tp,
                group=self.group if self._split else None)
        self.last_tok = self._sample(self._round_logits(logits))
        toks = self.last_tok.tolist()
        finished = []
        for slot, req in enumerate(self.active):
            if req is not None and _finish(req, toks[slot], self.eos_id):
                self._retire(req)
                finished.append(req)
        return finished


def static_generate(params: dict, cfg: ArchConfig, requests: list[Request],
                    *, cache_len: int, sampling: Optional[SamplingSpec] = None,
                    eos_id: Optional[int] = None) -> list[Request]:
    """Static rebatching reference: one batch, everyone starts together.

    Prompts are right-padded to the batch max, prefilled with a
    per-request ``last_pos`` vector, then decoded with per-slot positions
    until *every* request finishes (retired rows keep burning decode
    rounds).  Clock-free: the parity reference of the slot engine.
    Mutates and returns ``requests``.  Padding to the batch max is sound
    for the dense family only: other families raise.
    """
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            "static_generate pads to the batch max prompt length, which "
            "is only sound for dense/vlm")
    device = next(iter(params.values())).device
    sample = _Sampler(sampling or SamplingSpec(), device)
    maxlen = max(r.prompt_len for r in requests)
    toks = torch.tensor([r.prompt + [0] * (maxlen - r.prompt_len)
                         for r in requests], dtype=torch.long, device=device)
    last_pos = torch.tensor([r.prompt_len - 1 for r in requests],
                            dtype=torch.long, device=device)
    logits, state = prefill(params, cfg, prompt_batch(params, cfg, toks),
                            extra_capacity=cache_len - maxlen,
                            last_pos=last_pos)
    tok = sample(logits)
    for r, t in zip(requests, tok.tolist()):
        _finish(r, t, eos_id)
    while any(not r.done for r in requests):
        logits, state = decode_step(params, cfg, state, tok)
        tok = sample(logits)
        for r, t in zip(requests, tok.tolist()):
            if not r.done:
                _finish(r, t, eos_id)
    return requests
