"""The batching server's closed loop: clients sending examples of a pool.

Each client holds one request at a time and sends its next example as soon
as the server returned the last. A request is stamped done on the host clock
when ``step()`` returns it, which is after its batch's outputs reached the
host. The window's answers are kept with the pool index they answer, so the
reference can judge every one of them; the requests still queued when the
window closes are served after it and judged too, but not counted.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np

from . import stats
from .traffic import ServerTraffic


class ServerLoop:
    def __init__(self, system, mix: Dict, traffic: ServerTraffic, pool: np.ndarray, sync) -> None:
        from repro_torch.serving.compiled import CompiledModelServer, CompiledServerConfig

        self.system, self.mix, self.traffic, self.pool, self.sync = system, mix, traffic, pool, sync
        self.annotate = lambda name: contextlib.nullcontext()
        cm = system.cm
        run = getattr(cm.run, "__wrapped__", cm.run)

        def annotated_run(feeds):
            with self.annotate("CompiledModel.run"):
                return run(feeds)

        annotated_run.__wrapped__ = run
        cm.run = annotated_run
        self.max_batch = int(mix["max_batch"])
        self.srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=self.max_batch))
        self.out_name = cm.output_names[0]
        self.sent: Dict[int, tuple] = {}  # uid -> (client, pool index, time sent)
        self.answers: List[tuple] = []  # (pool index, outputs, time done) in the window
        self.calls: List[tuple] = []
        self.recording = False
        self.window = (0.0, 0.0)

    def _send(self, client: int) -> None:
        idx = self.traffic.next()
        req = self.srv.submit(self.pool[idx])
        self.sent[req.uid] = (client, idx, time.perf_counter())

    def warm(self) -> None:
        """One batch at ``max_batch``: the only bucket the window uses."""
        for i in range(self.max_batch):
            self.srv.submit(self.pool[i % len(self.pool)])
        self.srv.run_until_drained()
        self.sync()

    def prime(self) -> None:
        for c in range(int(self.mix["clients"])):
            self._send(c)

    def cycle(self) -> None:
        with self.annotate("serve.step"):
            done = self.srv.step()
        t = time.perf_counter()
        if self.recording:
            self.calls.append(("batch", len(done)))
        with self.annotate("clients.send"):
            for req in done:
                client, idx, _ = self.sent.pop(req.uid)
                self.answers.append((idx, req.outputs[self.out_name], t))
                self._send(client)

    def run(self, seconds: float) -> None:
        self.recording = True
        t0 = time.perf_counter()
        while True:
            self.cycle()
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        self.window = (t0, t)
        self.recording = False

    def drain(self) -> None:
        """Serve the requests in flight at the close and keep their answers
        for the comparison, sending no more."""
        for req in self.srv.run_until_drained():
            _, idx, _ = self.sent.pop(req.uid)
            self.answers.append((idx, req.outputs[self.out_name], time.perf_counter()))

    def metrics(self) -> Dict[str, float]:
        lo, hi = self.window
        done = sum(1 for _, _, t in self.answers if lo <= t <= hi)
        self.counts = {"images": done}
        return {"images_per_s": stats.rate(done, hi - lo)}

    def attempted(self) -> int:
        """Requests answered in the window or in flight at its close."""
        lo, _ = self.window
        return sum(1 for _, _, t in self.answers if t >= lo)

    def served(self, seed: int) -> Dict:
        """The pool and every answer due in the window: (pool index, codes)."""
        lo, _ = self.window
        return {"pool": self.pool, "answers": [(i, np.asarray(o)) for i, o, t in self.answers if t >= lo]}
