"""Continuous-batching serving engine for the LM.

The port of the JAX package's ``serving/engine.py``, a slot scheduler
over one batched KV cache:

* fixed ``n_slots`` decode batch; every engine step decodes ONE token
  for every slot, empty ones too (per-slot cache lengths — new requests
  join mid-flight without stalling running ones);
* prompt admission runs a B=1 prefill of the exact prompt length
  (recurrent archs' states must not see pad tokens) and splices the
  resulting cache into the slot (batch is axis 0 of every tensor of
  every layer's cache: KV, Mamba, RWKV);
* slots free on EOS / max_tokens and are immediately reusable.

Decoder-only archs (dense / MoE / SSM / hybrid); whisper's
encoder-decoder and internvl2's vision prefix are driven through
``Model.prefill`` / ``decode_step`` instead.  The engine works under
``torch.inference_mode()`` on the model's device.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.serving import sampler as smp


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int = -1                  # -1: never stops early
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int = -1
    t_submit: Optional[float] = None  # time.perf_counter() at submit()
    t_admit: Optional[float] = None   # ... as it leaves the queue


class ServingEngine:
    @torch.inference_mode()
    def __init__(self, model: Model, *, n_slots: int = 4,
                 max_len: int = 512, temperature: float = 0.0,
                 seed: int = 0):
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.temperature = temperature
        self.cache = model.init_cache(n_slots, max_len)
        self.cache_len = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.queue: deque[Request] = deque()
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.tokens_out = 0

    # --- admission -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request; raises ValueError on a prompt the model
        cannot take (empty, a token outside the vocabulary, or no room
        in the cache for a generated token)."""
        vocab = self.model.cfg.vocab_size
        if not req.prompt or not all(0 <= t < vocab for t in req.prompt):
            raise ValueError(f"request {req.rid}: the prompt must be 1 or "
                             f"more tokens in [0, {vocab})")
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"request {req.rid}: {len(req.prompt)} prompt "
                             f"tokens leave no room in a cache of max_len "
                             f"{self.max_len}")
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _splice(self, slot: int, one_cache: dict) -> None:
        """Write a B=1 cache into batch position ``slot`` of every tensor
        of every layer's cache (batch is axis 0 of each kind)."""
        for big, small in zip(self.cache["decoder"], one_cache["decoder"]):
            for kind, tensors in small.items():
                for name, t in tensors.items():
                    big[kind][name][slot] = t[0]

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            req.t_admit = time.perf_counter()
            toks = torch.tensor([req.prompt], dtype=torch.int64,
                                device=self.device)
            logits, cache1, clen = self.model.prefill(toks, self.max_len)
            tok = self._sample(logits)[0]
            self._splice(slot, cache1)
            self.cache_len[slot] = int(clen)
            self.last_token[slot] = int(tok)
            req.slot = slot
            req.output.append(int(tok))
            self.slot_req[slot] = req
            self.tokens_out += 1
            self._finish_if_done(req)

    # --- decode --------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.temperature <= 0.0:
            return smp.greedy(logits).cpu().numpy()
        return smp.temperature(self.gen, logits,
                               self.temperature).cpu().numpy()

    def _finish_if_done(self, req: Request) -> None:
        if req.done or req.slot < 0:
            return
        if (len(req.output) >= req.max_new_tokens
                or req.output[-1] == req.eos_id
                or self.cache_len[req.slot] >= self.max_len - 1):
            req.done = True
            self.slot_req[req.slot] = None
            req.slot = -1

    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: admit + batched decode.  Returns the
        number of tokens produced."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = torch.from_numpy(self.last_token[:, None]).to(self.device)
        clen = torch.from_numpy(self.cache_len).to(self.device)
        logits, self.cache = self.model.decode_step(tokens, self.cache, clen)
        toks = self._sample(logits)
        produced = 0
        for i in active:
            req = self.slot_req[i]
            self.cache_len[i] += 1
            self.last_token[i] = int(toks[i])
            req.output.append(int(toks[i]))
            produced += 1
            self._finish_if_done(req)
        self.steps += 1
        self.tokens_out += produced
        return produced

    def run(self, requests: list[Request], max_steps: int = 10_000
            ) -> list[Request]:
        for r in requests:
            self.submit(r)
        steps = 0
        while (any(not r.done for r in requests)
               and steps < max_steps):
            self.step()
            steps += 1
        return requests
