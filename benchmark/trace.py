"""Reduction of one torch.profiler window to what the per-layer readers
read: the device operations with their times, the device time launched
inside each of the benchmark's ranges and by the autograd engine, the
device's busy time as the union of its operations' intervals, and the
longest idle gaps with what the host was doing meanwhile.

The benchmark marks the window with the range ``bench.window`` and the
calls into each layer with ranges named ``bench.<layer>``; nothing inside
the program is read but kernel names.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "bench.window"
PREFIX = "bench."


class Trace:
    """One profiled window. Times are in seconds."""

    def __init__(self, prof):
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        cpu = [e for e in events if e.device_type != cuda]
        cpu_names = {e.name for e in cpu}
        windows = [e for e in cpu if e.name == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"trace: {len(windows)} '{WINDOW}' ranges")
        w = windows[0]
        self.t0, self.t1 = w.time_range.start, w.time_range.end    # us
        self.main_thread = w.thread
        self.window_s = (self.t1 - self.t0) * 1e-6
        # device operations: kernels, copies and sets (the device's copies
        # of host ranges carry a host event's name and are left out)
        ops = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == cuda and e.name not in cpu_names
               and e.time_range.end > self.t0 and e.time_range.start < self.t1]
        self.ops = [(n, max(s, self.t0), min(t, self.t1)) for n, s, t in ops]
        # device time by the range its launch ran in
        # (range or None, launched by the autograd engine, name, seconds)
        self.launched: List[Tuple[Optional[str], bool, str, float]] = []
        for e in cpu:
            if not e.kernels or not (self.t0 <= e.time_range.start <= self.t1):
                continue
            rng, p = None, e
            while p is not None:
                if p.name.startswith(PREFIX) and p.name != WINDOW:
                    rng = p.name
                    break
                p = p.cpu_parent
            for k in e.kernels:
                if k.name not in cpu_names:
                    self.launched.append((rng, e.thread != self.main_thread,
                                          k.name, k.duration * 1e-6))
        self._host = sorted(
            ((e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.thread == self.main_thread and e.name != WINDOW
             and e.time_range.end > self.t0 and e.time_range.start < self.t1),
            key=lambda t: t[0])
        self._busy = self._union()

    # ---------------------------------------------------------------- reads

    def device_s(self, match=None) -> float:
        """Summed device time of the operations whose name ``match``
        accepts (all with None)."""
        return sum(t - s for n, s, t in self.ops
                   if match is None or match(n)) * 1e-6

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def range_s(self, name: str, match=None) -> float:
        """Device time of the operations (those ``match`` accepts) launched
        inside range ``name``."""
        return sum(s for r, _, n, s in self.launched
                   if r == name and (match is None or match(n)))

    def engine_s(self) -> float:
        """Device time of the operations the autograd engine launched
        (from its own threads)."""
        return sum(s for _, engine, _, s in self.launched if engine)

    def busy_s(self) -> float:
        """Time in the window in which some device operation ran."""
        return sum(t - s for s, t in self._busy) * 1e-6

    def _union(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, t in sorted(self.ops, key=lambda o: o[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [tuple(m) for m in merged]

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        total: Dict[str, float] = collections.defaultdict(float)
        for name, s, t in self.ops:
            total[name[:160]] += (t - s) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10, scan: int = 400
                  ) -> List[Tuple[str, float]]:
        """The idle time of the ``scan`` longest gaps, summed by what the
        main thread was doing at each gap's middle (its innermost range and
        innermost operation); the ``n`` largest sums."""
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(
            0, len(edges) - 1, 2) if edges[i + 1] > edges[i]), reverse=True)
        starts = np.array([h[0] for h in self._host]) if self._host else \
            np.zeros(0)
        ends = np.array([h[1] for h in self._host]) if self._host else \
            np.zeros(0)
        total: Dict[str, float] = collections.defaultdict(float)
        for length, s in gaps[:scan]:
            mid = s + length / 2
            hi = int(np.searchsorted(starts, mid, side="right"))
            inside = [i for i in np.nonzero(ends[:hi] >= mid)[0]]
            rng = [self._host[i] for i in inside
                   if self._host[i][2].startswith(PREFIX)]
            ops = [self._host[i] for i in inside
                   if not self._host[i][2].startswith(PREFIX)]
            inner = lambda xs: min(xs, key=lambda h: h[1] - h[0])[2] \
                if xs else "-"
            total[f"{inner(rng)} / {inner(ops)}"[:160]] += length * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]
