"""A ``torch.profiler`` trace read as device intervals and host marks.

Device events are the kernels, copies and fills the card ran; host marks
are the ``record_function`` ranges that the closed loops put around each call
into the program (named after the program's own spans). Times are seconds
from the trace's first event, on the profiler's one clock.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

WINDOW_MARK = "portbench.window"


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "copy"
    if low.startswith("memset"):
        return "fill"
    return "kernel"


class Timeline:
    def __init__(self, prof, marks=()) -> None:
        """``prof``: a finished ``torch.profiler.profile``; ``marks``: the
        names of the host ranges to keep."""
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        keep = set(marks) | {WINDOW_MARK}
        raw_dev, raw_marks = [], []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or name in keep or name.startswith("ProfilerStep"):
                    continue
                raw_dev.append((name, e.start_ns(), e.duration_ns()))
            elif name in keep:
                raw_marks.append((name, e.start_ns(), e.duration_ns()))
        starts = [s for _, s, _ in raw_dev] + [s for _, s, _ in raw_marks]
        t0 = min(starts) if starts else 0
        #: (name, kind, start s, end s), by start
        self.device: List[Tuple[str, str, float, float]] = sorted(
            ((n, _kind(n), (s - t0) / 1e9, (s - t0 + d) / 1e9) for n, s, d in raw_dev),
            key=lambda r: r[2],
        )
        #: (name, start s, end s), by start
        self.marks: List[Tuple[str, float, float]] = sorted(
            ((n, (s - t0) / 1e9, (s - t0 + d) / 1e9) for n, s, d in raw_marks), key=lambda r: r[1]
        )
        wins = [(a, b) for n, a, b in self.marks if n == WINDOW_MARK]
        if len(wins) != 1:
            raise ValueError(f"the trace holds {len(wins)} '{WINDOW_MARK}' ranges, want 1")
        self.lo, self.hi = wins[0]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.marks if n == name and a >= self.lo and b <= self.hi]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device activity inside the window, as intervals."""
        out: List[List[float]] = []
        for _, _, a, b in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def label_at(self, t: float) -> str:
        """The innermost host mark open at ``t`` (the window when none)."""
        best: Optional[Tuple[str, float, float]] = None
        for n, a, b in self.marks:
            if a > t:
                break
            if b >= t and (best is None or a >= best[1]):
                best = (n, a, b)
        return best[0] if best else "outside"

    def idle_by_label(self) -> Dict[str, float]:
        """Idle seconds inside the window, by what the host was doing (the
        innermost mark open at each gap's middle)."""
        out: Dict[str, float] = {}
        edge = self.lo
        for a, b in self.busy() + [(self.hi, self.hi)]:
            if a > edge:
                key = self.label_at((a + edge) / 2)
                out[key] = out.get(key, 0.0) + (a - edge)
            edge = max(edge, b)
        return out

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, _, a, b in self.device:
            if a >= self.lo and b <= self.hi:
                out[n] = out.get(n, 0.0) + (b - a)
        return out

    def kernel_seconds(self, part: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``part``, inside the window."""
        s, n = 0.0, 0
        for name, kind, a, b in self.device:
            if kind == "kernel" and part in name and a >= self.lo and b <= self.hi:
                s += b - a
                n += 1
        return s, n

    def kernels_in(self, a: float, b: float) -> int:
        return sum(1 for _, k, s, e in self.device if k == "kernel" and s >= a and e <= b)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.seconds_by_name().items(), key=lambda r: -r[1])[:top]
        gaps = sorted(self.idle_by_label().items(), key=lambda r: -r[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
