"""Batched serving engine: continuous-batching-lite over prefill/decode steps.

* A fixed decode batch of ``slots``; finished or empty slots refill from the
  request queue each cycle (per-slot KV regions are written independently,
  so admission is a host-side decision — the decode step never re-plans).
* Prefill runs per admitted request, right-padded to a bucket length, and
  its KV rows are scattered into the slot's region.
* ``kv_cache_dtype="int8"`` serves with the paper's symmetric int8 cache.

The engine core (queue, slot bookkeeping, sampling, metrics) is model-
agnostic: all model execution goes through a *token-path adapter* with four
methods — ``init_cache`` / ``prefill`` / ``decode`` / ``scatter``.  Two
adapters exist:

* :class:`OpaqueModelAdapter` (default) — ``repro_torch.models.model``
  prefill/decode in eager PyTorch on the parameters' device, one prefill
  closure per prompt bucket in a bounded :class:`PlanCache`;
* :class:`repro_torch.serving.token_path.CompiledTokenAdapter` — the PQ-IR
  lane: prefill and decode are compiled plans sharing one ``PlanCache``, the
  KV cache is the plan's persistent int8 state slots.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..backend.plan import PlanCache, bucket_multiple
from ..configs.base import ModelConfig
from ..core.compile import resolve_device
from ..models import model as M
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
    # resident prefill closures (LRU beyond); None = one per reachable
    # prompt bucket (max_len // prefill_bucket)
    prefill_cache_size: Optional[int] = None


def _prefill_capacity(ecfg: "EngineConfig") -> int:
    """Resolve the prefill-cache bound: explicit config wins, else one slot
    per reachable prompt bucket (prompts are padded to multiples of
    ``prefill_bucket`` and capped by ``max_len``)."""
    if ecfg.prefill_cache_size is not None:
        return ecfg.prefill_cache_size
    return max(1, ecfg.max_len // ecfg.prefill_bucket)


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


class OpaqueModelAdapter:
    """The model zoo's token path behind the adapter seam: ``repro_torch.
    models.model`` prefill and decode, eager, on the parameters' device.

    The weights are cast to ``compute_dtype`` once, here (``repro`` casts
    them on every traced call, which eager PyTorch would pay as a copy of
    every weight every step); the f32 masters stay for the logits readout,
    as ``repro``'s.  One prefill closure per prompt bucket lives in a
    bounded :class:`PlanCache` (``scope="prefill"``), whose hit/miss/evict
    counts surface in the engine metrics as ``repro``'s jitted-prefill
    cache does.
    """

    def __init__(self, params, cfg: ModelConfig, *, compute_dtype=torch.float32,
                 prefill_cache_capacity: int = 8) -> None:
        self.params = params
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = resolve_device(params["embed"]["table"].device)
        self._cast = M.cast_params(params, compute_dtype)
        self.prefill_cache: PlanCache = PlanCache(prefill_cache_capacity, scope="prefill")

    def _decode(self, tokens, pos, cache):
        return M.decode_step(self.params, tokens, pos, cache, self.cfg,
                             compute_dtype=self.compute_dtype, cast=self._cast)

    def init_cache(self, slots: int, max_len: int):
        return M.init_cache(self.cfg, slots, max_len, device=self.device)

    def _prefill_fn(self, plen: int):
        fn = self.prefill_cache.get(plen)
        if fn is None:
            cfg, dt, cast = self.cfg, self.compute_dtype, self._cast

            def fn(params, tokens, cache):
                return M.prefill(params, {"tokens": tokens}, cfg, cache, compute_dtype=dt,
                                 q_chunk=min(plen, 512), kv_chunk=min(plen, 512), cast=cast)

            self.prefill_cache.put(plen, fn)
        return fn

    def prefill(self, padded: np.ndarray, plen: int, max_len: int):
        """Run one right-padded prompt ``(1, bucket)``; returns the logits row
        for the true last prompt token and the single-request KV cache."""
        bucket = padded.shape[1]
        pcache = M.init_cache(self.cfg, 1, max_len, device=self.device)
        tokens = torch.as_tensor(padded, device=self.device)
        logits, pcache = self._prefill_fn(bucket)(self.params, tokens, pcache)
        return self._logits_at(padded, plen, logits, pcache)

    def _logits_at(self, padded, plen, last_logits, pcache):
        """Logits for the true last prompt token: a bucket longer than the
        prompt re-decodes token ``plen - 1`` at its position."""
        if plen == padded.shape[1]:
            return last_logits[0], pcache
        tok = torch.as_tensor(padded[:, plen - 1: plen], device=self.device)
        pos = torch.full((1,), plen - 1, dtype=torch.int32, device=self.device)
        logits, _ = self._decode(tok, pos, pcache)
        return logits[0], pcache

    def decode(self, toks: np.ndarray, pos: np.ndarray, cache):
        """One batched decode step over all slots; positions are per-slot."""
        return self._decode(torch.as_tensor(toks, device=self.device),
                            torch.as_tensor(pos, device=self.device), cache)

    def scatter(self, cache, slot: int, pcache):
        """Write a prefilled single-request cache into one slot's region, in
        place: the cache tensors belong to the engine (fresh outputs of the
        last decode step, or of ``init_cache``)."""
        def scat(path, dst):
            src = pcache
            for key in path:
                src = src[key]
            if dst.ndim == src.ndim and dst.shape[1:] == src.shape[1:] and src.shape[0] == 1:
                dst[slot: slot + 1].copy_(src)
            else:  # stacked layer dim first: (L, B, ...) — batch is axis 1
                dst[:, slot: slot + 1].copy_(src)
            return dst

        return M.tree_map(scat, cache)


class ServeEngine:
    def __init__(
        self,
        params=None,
        cfg: Optional[ModelConfig] = None,
        ecfg: Optional[EngineConfig] = None,
        *,
        compute_dtype=torch.float32,
        registry: Optional[MetricsRegistry] = None,
        adapter=None,
    ) -> None:
        if ecfg is None:
            raise ValueError("ServeEngine requires an EngineConfig")
        # cache length must cover the largest prefill bucket (same round-up-
        # to-multiple policy the compiled-model grid uses for sequence axes)
        ecfg = dataclasses.replace(
            ecfg, max_len=bucket_multiple(ecfg.max_len, ecfg.prefill_bucket)
        )
        self.ecfg = ecfg
        if adapter is None:
            if params is None or cfg is None:
                raise ValueError(
                    "ServeEngine needs either (params, cfg) for the default "
                    "OpaqueModelAdapter or an explicit adapter="
                )
            adapter = OpaqueModelAdapter(
                params, cfg, compute_dtype=compute_dtype,
                prefill_cache_capacity=_prefill_capacity(ecfg),
            )
        self.adapter = adapter
        self.params = getattr(adapter, "params", params)
        self.cfg = getattr(adapter, "cfg", cfg)
        self.compute_dtype = compute_dtype
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.slot_pos = np.zeros((ecfg.slots,), np.int32)
        self.slot_live = np.zeros((ecfg.slots,), bool)
        self.slot_budget = np.zeros((ecfg.slots,), np.int32)
        self.cache = adapter.init_cache(ecfg.slots, ecfg.max_len)
        self._rng = np.random.default_rng(ecfg.seed)
        # per-instance registry unless the caller injects a shared one; the
        # adapter's prefill cache (when it keeps one) publishes its canonical
        # cache.prefill.* gauges, and the flat prefill_cache_* keys below are
        # read-only aliases
        self.registry = registry if registry is not None else MetricsRegistry()
        self._prefill_cache: Optional[PlanCache] = getattr(adapter, "prefill_cache", None)
        if self._prefill_cache is not None:
            self._prefill_cache.attach_metrics(self.registry)
        self.metrics = {
            "decode_steps": 0,
            "prefills": 0,
            "completed": 0,
            "prefill_cache_size": 0,
            "prefill_cache_hits": 0,
            "prefill_cache_evictions": 0,
            "prefill_cache_hit_rate": 0.0,
        }

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

    def _sync_cache_metrics(self) -> None:
        if self._prefill_cache is None:
            return
        stats = self._prefill_cache.stats
        self.metrics["prefill_cache_size"] = stats["size"]
        self.metrics["prefill_cache_hits"] = stats["hits"]
        self.metrics["prefill_cache_evictions"] = stats["evictions"]
        self.metrics["prefill_cache_hit_rate"] = stats["hit_rate"]

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
                with (_trace.span("engine.prefill", uid=req.uid, plen=plen, bucket=bucket)
                      if _trace.enabled else _trace.NULL_SPAN):
                    first_logits, pcache = self.adapter.prefill(
                        padded, plen, self.ecfg.max_len
                    )
                self._sync_cache_metrics()
                # the host waits here for the prefill to finish on the device
                with _trace.span("engine.prefill.wait"):
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
        with (_trace.span("engine.decode", live=int(self.slot_live.sum()))
              if _trace.enabled else _trace.NULL_SPAN):
            logits, self.cache = self.adapter.decode(toks, self.slot_pos, self.cache)
        self._count("decode_steps")
        # the host waits here for the decode step to finish on the device
        with _trace.span("engine.decode.wait"):
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
