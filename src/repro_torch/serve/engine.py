"""Continuous-batching serving engine over ZeRO-3 sharded parameters (port
of ``repro/serve/engine.py``).

A fixed pool of batch slots, each holding one request at its own sequence
position.  Every engine iteration runs ONE decode call for the whole pool
with a per-row position vector: admitted requests stream their prompt
tokens through the same call (the degenerate case of chunked prefill),
active requests consume their last sampled token, and empty slots are
harmless (a slot's cache row returns to the empty cache when a request
is admitted).
Parameters stay sharded at rest and are gathered per layer inside the
step.  Sampling (argmax by default) runs on the device; one host transfer
of the pool's sampled tokens per iteration drives the bookkeeping.

The engine runs decode steps only, so it refuses a model whose cache has a
``memory`` leaf (the encoder-decoder's encoded frames, which only
``prefill`` writes): it would attend to the empty cache's zero memory.
The reference's engine serves that zero memory (ROADMAP Queue 3).  The
VLM keeps no memory in its cache (each decode step re-encodes
``batch["patches"]``), so the engine serves it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..models.cache import tree_map


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (len,) integer token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0        # next position to write in this row
    cursor: int = 0     # prompt tokens already consumed


class ServeEngine:
    def __init__(self, runtime, model, params, *, pool: int = 4,
                 max_len: int = 256, extras: dict | None = None,
                 sample: Callable | None = None):
        if "memory" in model.cache_batch_dims():
            raise ValueError(
                f"ServeEngine runs decode steps only and no encoder: "
                f"{type(model).__name__}'s cache holds a 'memory' leaf that "
                f"only prefill writes, so every request would attend to a "
                f"zero memory; serve it with make_prefill_step and "
                f"make_decode_step")
        self.rt = runtime
        self.model = model
        self.params = params
        self.pool = pool
        self.max_len = max_len
        self.extras = extras or {}
        self.sample = sample or (lambda logits: torch.argmax(logits, -1))
        # this rank's part of the pool's cache: its rows (and KV head slot)
        self.cache = runtime.init_cache(pool, max_len)
        self._rows = runtime.batch_slice(pool)
        self.slots = [_Slot() for _ in range(pool)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._decode = runtime.make_decode_step()

    # ------------------------------------------------------------------ #
    def submit(self, req: Request):
        self.queue.append(req)

    def _reset_row(self, row: int):
        """Return a slot's cache row to the empty cache, every leaf at the
        model's ``cache_fill`` (``pos`` -1, so stale entries of a previous
        occupant can never attend; a recurrent state at its start, so a
        new request does not continue the previous one's), on the rank
        that holds the slot's row (its rows ``[lo, hi)`` of the pool).  The
        reference resets ``pos`` alone, and a recurrent model's request
        admitted into a used slot starts from its predecessor's state
        (ROADMAP Queue 3)."""
        lo, hi = self._rows
        if not lo <= row < hi:
            return
        tree_map(lambda leaf, bdim, fill: leaf.select(bdim, row - lo)
                 .fill_(fill), self.cache, self.model.cache_batch_dims(),
                 self.model.cache_fill())

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot.req is None and self.queue:
                self._reset_row(i)
                self.slots[i] = _Slot(req=self.queue.popleft())

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One engine iteration (one decode call for the whole pool).
        Returns the number of active slots."""
        self._admit()
        toks = np.zeros((self.pool, 1), np.int64)
        pos = np.zeros((self.pool,), np.int64)
        active = []
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            active.append(i)
            pos[i] = s.pos
            if s.cursor < len(s.req.prompt):
                toks[i, 0] = int(s.req.prompt[s.cursor])
            else:
                toks[i, 0] = s.req.out[-1]
        if not active:
            return 0
        dev = self.rt.device
        batch = {"tokens": torch.from_numpy(toks).to(dev), **self.extras}
        logits, self.cache = self._decode(self.params, batch, self.cache,
                                          torch.from_numpy(pos).to(dev))
        sampled = self.sample(logits).cpu().numpy()
        for i in active:
            s = self.slots[i]
            s.pos += 1
            if s.cursor < len(s.req.prompt):
                s.cursor += 1
                if s.cursor < len(s.req.prompt):
                    continue  # still streaming the prompt; logits unused
            s.req.out.append(int(sampled[i, 0]))
            if len(s.req.out) >= s.req.max_new or s.pos >= self.max_len - 1:
                s.req.done = True
                self.finished.append(s.req)
                self.slots[i] = _Slot()
        return len(active)

    def run(self, max_steps: int = 100_000):
        steps = 0
        while (self.queue or any(s.req for s in self.slots)) and \
                steps < max_steps:
            self.step()
            steps += 1
        return self.finished
