"""Batched serving engine: continuous-batching-lite over prefill/decode steps.

* A fixed decode batch of ``slots``; finished or empty slots refill from the
  request queue each cycle (per-slot KV regions are written independently,
  so admission is a host-side decision — the decode step never re-plans).
* Prefill runs per admitted request, right-padded to a bucket length, and
  its KV rows are scattered into the slot's region.

The engine core (queue, slot bookkeeping, sampling, metrics) is model-
agnostic: all model execution goes through a *token-path adapter* with four
methods — ``init_cache`` / ``prefill`` / ``decode`` / ``scatter``.  The one
adapter so far is :class:`repro_torch.serving.token_path.CompiledTokenAdapter`
(the PQ-IR lane, on the token path's device).  ``repro``'s default opaque
model adapter waits for the port of ``models/``, so ``adapter=`` is required.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..backend.plan import bucket_multiple
from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    # filled by the engine:
    generated: Optional[List[int]] = None
    done: bool = False
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4
    max_len: int = 256
    prefill_bucket: int = 32  # prompts right-padded to a multiple of this
    greedy: bool = True
    temperature: float = 1.0  # sampling path only (greedy=False)
    top_k: int = 0  # 0 ⇒ sample the full vocab
    seed: int = 0  # host-side sampling rng seed


#: Module-level fallback sampler state: callers that don't thread an rng
#: (the engine always does — see ``ServeEngine._select``) draw from one
#: seeded stream instead of a fresh ``default_rng()`` per call, so unseeded
#: use is reproducible run-to-run.  Reset it with :func:`seed_sampler`.
_FALLBACK_RNG = np.random.default_rng(0)


def seed_sampler(seed: int) -> None:
    """Re-seed the module fallback rng used when ``sample_token`` is called
    without an explicit generator."""
    global _FALLBACK_RNG
    _FALLBACK_RNG = np.random.default_rng(seed)


def sample_token(
    logits: np.ndarray,
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Sample one token id from a logits row (host-side, numpy).

    ``temperature <= 0`` degenerates to argmax; ``top_k > 0`` restricts
    sampling to the k highest logits (ties at the k-th value are all kept,
    so the candidate set is never smaller than k).  Without an explicit
    ``rng`` the seeded module fallback stream is used (:func:`seed_sampler`),
    never a fresh unseeded generator per call."""
    z = np.asarray(logits, np.float64).reshape(-1)
    if temperature <= 0.0:
        return int(z.argmax())
    if top_k and top_k < z.size:
        kth = np.partition(z, -top_k)[-top_k]
        z = np.where(z >= kth, z, -np.inf)
    z = z / temperature
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    rng = rng if rng is not None else _FALLBACK_RNG
    return int(rng.choice(z.size, p=p))


class ServeEngine:
    def __init__(
        self,
        ecfg: Optional[EngineConfig] = None,
        *,
        adapter=None,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        if ecfg is None:
            raise ValueError("ServeEngine requires an EngineConfig")
        if adapter is None:
            raise ValueError(
                "ServeEngine needs adapter= (e.g. CompiledTokenAdapter): the opaque "
                "model adapter is not ported yet"
            )
        # cache length must cover the largest prefill bucket (same round-up-
        # to-multiple policy the compiled-model grid uses for sequence axes)
        ecfg = dataclasses.replace(
            ecfg, max_len=bucket_multiple(ecfg.max_len, ecfg.prefill_bucket)
        )
        self.ecfg = ecfg
        self.adapter = adapter
        self.cfg = getattr(adapter, "cfg", None)
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.slot_pos = np.zeros((ecfg.slots,), np.int32)
        self.slot_live = np.zeros((ecfg.slots,), bool)
        self.slot_budget = np.zeros((ecfg.slots,), np.int32)
        self.cache = adapter.init_cache(ecfg.slots, ecfg.max_len)
        self._rng = np.random.default_rng(ecfg.seed)
        # per-instance registry unless the caller injects a shared one
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics = {"decode_steps": 0, "prefills": 0, "completed": 0}

    def _count(self, key: str, n: int = 1) -> None:
        """One accounting site: the flat alias dict and the canonical
        ``engine.<key>`` registry counter move together."""
        self.metrics[key] += n
        self.registry.counter(f"engine.{key}").inc(n)

    def _select(self, logits_row) -> int:
        """Next-token choice for one slot: argmax (greedy, on the row's
        device; the first maximum wins, as numpy's does) or
        temperature/top-k sampling on the host."""
        if self.ecfg.greedy:
            return int(torch.argmax(torch.as_tensor(logits_row)))
        return sample_token(
            torch.as_tensor(logits_row).cpu().numpy(),
            temperature=self.ecfg.temperature,
            top_k=self.ecfg.top_k,
            rng=self._rng,
        )

    # -- request lifecycle ----------------------------------------------------
    def submit(self, req: Request) -> None:
        """Admission-time validation, then enqueue: reject at the boundary,
        never let a bad request reach the batched hot loop."""
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError("prompt must contain at least one token")
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        bucket = bucket_multiple(plen, self.ecfg.prefill_bucket)
        if bucket > self.ecfg.max_len or (req.max_new_tokens > 1 and plen >= self.ecfg.max_len):
            # a prefill bucket beyond the per-slot KV cache (or a decode
            # position at max_len) would clip the cache write — reject instead
            raise ValueError(
                f"prompt of {plen} tokens (prefill bucket {bucket}) does not fit the "
                f"per-slot KV cache (max_len={self.ecfg.max_len}); shorten the prompt "
                "or raise EngineConfig.max_len"
            )
        req.t_submit = time.monotonic()
        req.generated = []
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.ecfg.slots):
            # a request whose budget is exhausted by the prefill token never
            # occupies the slot, so keep admitting until it is actually filled
            while not self.slot_live[slot] and self.queue:
                req = self.queue.popleft()
                plen = len(req.prompt)
                bucket = bucket_multiple(plen, self.ecfg.prefill_bucket)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :plen] = req.prompt
                # prefill writes [0, bucket); only [0, plen) is meaningful — the
                # causal mask means padding beyond plen is never attended by
                # positions < plen, and decode continues exactly at plen.
                with _trace.span("engine.prefill", uid=req.uid, plen=plen, bucket=bucket):
                    first_logits, pcache = self.adapter.prefill(
                        padded, plen, self.ecfg.max_len
                    )
                tok = self._select(first_logits)
                req.generated.append(tok)
                req.t_first = time.monotonic()
                self._count("prefills")
                if req.max_new_tokens <= 1:
                    # the prefill token already spent the whole budget: done at
                    # admit — decoding the slot once more would emit a second
                    # token and violate max_new_tokens
                    req.done = True
                    req.t_done = req.t_first
                    self._count("completed")
                    continue
                self.cache = self.adapter.scatter(self.cache, slot, pcache)
                self.active[slot] = req
                self.slot_pos[slot] = plen
                self.slot_live[slot] = True
                self.slot_budget[slot] = req.max_new_tokens - 1

    # -- main loop --------------------------------------------------------------
    def step(self) -> None:
        """One engine cycle: admit + one batched decode step."""
        self._admit()
        if not self.slot_live.any():
            return
        toks = np.zeros((self.ecfg.slots, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.generated[-1]
        with _trace.span("engine.decode", live=int(self.slot_live.sum())):
            logits, self.cache = self.adapter.decode(toks, self.slot_pos, self.cache)
        self._count("decode_steps")
        if self.ecfg.greedy:
            # argmax on the device: transfers `slots` ints, not slots×vocab floats
            nxt = torch.argmax(torch.as_tensor(logits), dim=-1).cpu().numpy()
            pick = lambda slot: int(nxt[slot])  # noqa: E731
        else:
            logits_np = torch.as_tensor(logits).cpu().numpy()
            pick = lambda slot: self._select(logits_np[slot])  # noqa: E731
        for slot in list(self.active):
            if not self.slot_live[slot]:
                continue
            req = self.active[slot]
            req.generated.append(pick(slot))
            self.slot_pos[slot] += 1
            self.slot_budget[slot] -= 1
            if self.slot_budget[slot] <= 0 or self.slot_pos[slot] >= self.ecfg.max_len - 1:
                req.done = True
                req.t_done = time.monotonic()
                self._count("completed")
                self.slot_live[slot] = False
                del self.active[slot]

    def run_until_drained(self, max_cycles: int = 10_000) -> None:
        for _ in range(max_cycles):
            if not self.queue and not self.active:
                return
            self.step()
        raise RuntimeError("serve loop did not drain")
