"""Batched serving engine: continuous-batching prefill + decode, as the
reference's ``repro/serve/engine.py``.

A static (B, S_max) KV footprint with per-slot dynamic lengths — the
paged-lite layout the decode_attention kernel masks against.  Requests join
free slots (prefill teacher-forces the prompt through ``decode_step`` so the
cache layout is identical to decode), then the engine steps all slots in
lockstep; finished slots free immediately (continuous batching).  Idle slots
step too, as in the reference, so their lengths grow past ``max_seq`` in
long runs: the cache write is then a no-op and every slot counts as valid,
as the reference's one-hot write and length mask make it.

One host sync per step: the greedy tokens come back to the host (the
reference's ``np.asarray(argmax)``).  Steps run under
``torch.inference_mode()``.

Spans (``core.trace.scope``): ``serve.admit`` around admission,
``serve.step`` around the step's device work (the model's spans nest in
it), ``serve.sync`` around the step's one sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import trace
from ..core.trace import Metrics
from ..data.tokenizer import EOS
from ..models.model import Model, _needs_memory


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: list[int]
    max_new_tokens: int = 16
    out_ids: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, params: dict, *, max_batch: int = 8,
                 max_seq: int = 512, greedy: bool = True):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.greedy = greedy
        self.cache = model.cache_init(max_batch, max_seq)
        self.slots: list[Request | None] = [None] * max_batch
        self._pending: list[Request] = []
        self._next_feed = np.zeros(max_batch, np.int32)     # token to feed next
        self._prompt_pos = np.zeros(max_batch, np.int64)    # progress in prompt
        # the reference decodes a model with cross layers against a zero
        # memory of (max_batch, cross_memory_len, d), never encoded
        # (ROADMAP Queue 3, known divergences); it is the same every step
        self._memory = None
        if _needs_memory(model.cfg):
            cfg = model.cfg
            self._memory = torch.zeros((max_batch, cfg.cross_memory_len, cfg.d_model),
                                       dtype=torch.bfloat16, device=model.device)
        self.metrics = Metrics("serve", steps=0, tokens_out=0, prefill_tokens=0)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def _admit(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and self._pending:
                req = self._pending.pop(0)
                self.slots[i] = req
                self._reset_slot(i)
                self._prompt_pos[i] = 0
                self._next_feed[i] = req.prompt_ids[0]

    def _reset_slot(self, i: int) -> None:
        """Zero slot i's state in every layer (attention K/V, local ring
        buffers, the RG-LRU's h and conv_buf) and its length.  Length gating
        makes stale K/V inert, but a recurrent state carries into the next
        request, so it must be zeroed.  The reference picks lanes by shape
        and, at max_batch equal to the number of scanned layer repeats,
        zeroes layer i of every slot instead (ROADMAP, known divergences);
        the port's per-layer caches make the lanes explicit."""
        with torch.inference_mode():
            for c in self.cache["layers"]:
                for t in c.values():
                    t[i].zero_()
            self.cache["length"][i] = 0

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One lockstep decode over all slots; returns #active."""
        with trace.scope("serve.admit", "serve"):
            self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        with trace.scope("serve.step", "serve"), torch.inference_mode():
            feed = torch.from_numpy(self._next_feed.copy()).to(self.model.device)
            logits, self.cache = self.model.decode_step(self.params, feed, self.cache,
                                                        self._memory)
            with trace.scope("serve.sync", "serve"):
                next_tok = logits.argmax(dim=-1).cpu().numpy()    # the step's sync
        self.metrics.inc("steps")

        for i in active:
            req = self.slots[i]
            self._prompt_pos[i] += 1
            if self._prompt_pos[i] < len(req.prompt_ids):
                # still prefilling: teacher-force the next prompt token
                self._next_feed[i] = req.prompt_ids[self._prompt_pos[i]]
                self.metrics.inc("prefill_tokens")
                continue
            tok = int(next_tok[i])
            req.out_ids.append(tok)
            self.metrics.inc("tokens_out")
            self._next_feed[i] = tok
            if tok == EOS or len(req.out_ids) >= req.max_new_tokens:
                req.done = True
                self.slots[i] = None            # continuous batching: free now
        return len(active)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self._pending:
                return
        raise TimeoutError("serving did not drain")
