"""The token engine's closed loop: clients, stamps and the calls it drove.

Each client holds one request at a time and sends its next as soon as the
last one finished. Every token is stamped on the host clock when the engine
appends it to its request, which the engine does right after the device
result reached the host (its argmax ``.cpu()`` or ``int()``): the end of the
engine call that produced it. A thin probe between the engine and the
program's adapter records the shapes it drove (prefill lengths and buckets,
decode positions), which ``work/<config>.py`` turns into operations and
bytes, and puts host marks around each call when the run is traced.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np

from . import stats
from .traffic import EngineTraffic, bucket, check_sample


class StampList(list):
    """A request's ``generated`` list that stamps each appended token."""

    def __init__(self, items=()) -> None:
        super().__init__(items)
        self.stamps: List[float] = [float("nan")] * len(self)

    def append(self, tok) -> None:
        super().append(tok)
        self.stamps.append(time.perf_counter())


def stamped(request_cls):
    """The program's request class, with ``generated`` kept as a
    :class:`StampList` whatever list the engine assigns."""

    class StampedRequest(request_cls):
        def __setattr__(self, name, value):
            if name == "generated" and isinstance(value, list) and not isinstance(value, StampList):
                value = StampList(value)
            super().__setattr__(name, value)

    return StampedRequest


class AdapterProbe:
    """Passes every call to the program's adapter, logging what was driven."""

    def __init__(self, inner, annotate) -> None:
        self.inner = inner
        self.annotate = annotate
        self.engine = None
        self.recording = False
        self.calls: List[tuple] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def init_cache(self, slots, max_len):
        return self.inner.init_cache(slots, max_len)

    def prefill(self, padded, plen, max_len):
        if self.recording:
            self.calls.append(("prefill", int(plen), int(padded.shape[1])))
        with self.annotate("engine.prefill"):
            return self.inner.prefill(padded, plen, max_len)

    def decode(self, toks, pos, cache):
        if self.recording:
            self.calls.append(("decode", np.array(pos, np.int64), self.engine.slot_live.copy()))
        with self.annotate("engine.decode"):
            return self.inner.decode(toks, pos, cache)

    def scatter(self, cache, slot, pcache):
        return self.inner.scatter(cache, slot, pcache)


class EngineLoop:
    def __init__(self, system, mix: Dict, traffic: EngineTraffic, sync) -> None:
        from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

        self.system, self.mix, self.traffic, self.sync = system, mix, traffic, sync
        self.annotate = lambda name: contextlib.nullcontext()
        self.probe = AdapterProbe(system.adapter, lambda name: self.annotate(name))
        ecfg = EngineConfig(slots=int(mix["slots"]), max_len=int(mix["max_len"]),
                            prefill_bucket=int(mix["prefill_bucket"]), greedy=True)
        self.engine = ServeEngine(ecfg=ecfg, adapter=self.probe)
        self.probe.engine = self.engine
        self.Request = stamped(Request)
        self.clients: List = [None] * int(mix["clients"])
        self.requests: List = []
        self.ahead: List[tuple] = []  # drawn by warm(), sent first by prime()
        self.window = (0.0, 0.0)

    # -- set-up ---------------------------------------------------------------
    def warm(self) -> None:
        """One prefill at every bucket the mix can send that priming will
        not: with the first request of each client drawn ahead, the buckets
        of those prompts are left to the prime, which prefills each of them
        and runs the decode step at the engine's (slots, max_len)."""
        ad, eng = self.probe.inner, self.engine
        self.ahead = [self.traffic.next() for _ in self.clients]
        b = int(self.mix["prefill_bucket"])
        primed = {bucket(len(prompt), b) for prompt, _ in self.ahead}
        for n in self.traffic.prefill_buckets():
            if n not in primed:
                ad.prefill(np.ones((1, n), np.int32), n, eng.ecfg.max_len)
                self.sync()

    def prime(self) -> None:
        """``together``: every client sends at once and one engine cycle
        admits them all (their prompts become the requests' caches);
        ``staggered``: client i sends at cycle ``i * stagger_cycles``, so
        requests end in different cycles from then on."""
        n = len(self.clients)
        if self.mix["prime"] == "together":
            for c in range(n):
                self._send(c)
            self.cycle()
            return
        k = int(self.mix["stagger_cycles"])
        for cyc in range((n - 1) * k + 1):
            if cyc % k == 0:
                self._send(cyc // k)
            self.cycle()

    # -- the loop -------------------------------------------------------------
    def _send(self, client: int) -> None:
        prompt, budget = self.ahead.pop(0) if self.ahead else self.traffic.next()
        req = self.Request(uid=len(self.requests), prompt=prompt, max_new_tokens=int(budget))
        req.t_sent = time.perf_counter()
        self.engine.submit(req)
        self.clients[client] = req
        self.requests.append(req)

    def cycle(self) -> None:
        with self.annotate("engine.step"):
            self.engine.step()
        with self.annotate("clients.send"):
            for c, req in enumerate(self.clients):
                if req is not None and req.done:
                    self._send(c)

    def run(self, seconds: float) -> None:
        self.probe.recording = True
        t0 = time.perf_counter()
        while True:
            self.cycle()
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        self.window = (t0, t)
        self.probe.recording = False

    @property
    def calls(self) -> List[tuple]:
        return self.probe.calls

    # -- what the window shows ---------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        lo, hi = self.window
        tokens, gaps, ttft = 0, [], []
        for r in self.requests:
            st = r.generated.stamps
            tokens += sum(1 for s in st if lo <= s <= hi)
            gaps += [b - a for a, b in zip(st, st[1:]) if a >= lo and b <= hi]
            if st and lo <= st[0] <= hi:
                ttft.append(st[0] - r.t_sent)
        out = {"tokens_per_s": stats.rate(tokens, hi - lo)}
        if gaps:
            out["itl_p95_ms"] = stats.percentile(gaps, 95.0) * 1e3
        if ttft:
            out["ttft_p90_ms"] = stats.percentile(ttft, 90.0) * 1e3
        self.counts = {"tokens": tokens, "gaps": len(gaps), "first_tokens": len(ttft)}
        return out

    def attempted(self) -> int:
        """Requests the window served or was sent: a token or a send inside."""
        lo, hi = self.window
        return sum(1 for r in self.requests
                   if lo <= r.t_sent <= hi or any(lo <= s <= hi for s in r.generated.stamps))

    def served(self, seed: int) -> List[Dict]:
        """What the comparison judges: every request still in its slot, with
        the slot's int8 KV rows, and a sample drawn from the seed of the
        others that were served a token, the longest among them; each with
        its prompt and served tokens."""
        eng = self.engine
        slot_of = {id(req): slot for slot, req in eng.active.items()}
        done = [r for r in self.requests if len(r.generated) > 0 and id(r) not in slot_of]
        pick = check_sample(len(done), int(self.mix["check_requests"]),
                            [len(r.prompt) + len(r.generated) for r in done], seed)
        out = []
        for r in [done[i] for i in pick] + [eng.active[s] for s in sorted(eng.active)]:
            item = {"uid": r.uid, "prompt": np.asarray(r.prompt, np.int64),
                    "tokens": [int(t) for t in r.generated], "kv": None}
            slot = slot_of.get(id(r))
            if slot is not None:
                n = int(eng.slot_pos[slot])
                if n != len(r.prompt) + len(r.generated) - 1:
                    raise AssertionError(f"slot {slot} holds {n} rows for request {r.uid}")
                item["kv"] = self.system.kv_rows(eng.cache, slot, n)
            out.append(item)
        return out
