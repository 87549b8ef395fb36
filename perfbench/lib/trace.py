"""The traced run's device slice: ``torch.profiler`` (CPU and CUDA) over
whole serve-loop iterations inside the measured window, chosen by decode
step count. The harness wraps the engine's step entry points (the direct
store's ``DecodeGraph.step``, the offload plane's ``decode_step``) for the
window of a ``--trace 1`` run only; the wrapper counts steps across the
window's ``serve`` calls and opens the profiler at the entry of step
``start`` and closes it, after a device sync, at the entry of step
``start + steps``. So a slice holds exactly ``steps`` loop iterations: each
step with the harvest, flush and admission work that follows it.

Beside the active rows, the slice counts the staging-buffer tokens each
active row attends at each of its steps, by the engine's own rule: a row
holds ``local`` tokens once admitted (``graft``, wrapped too; every mix's
prompts are longer than the sink and the local window), one more at each
of its steps, and ``update_segment`` fewer after a flush, which follows the
step at which it reaches ``local + update_segment``.

The profiler on the card has lost some or all of a session's device
records (a few sessions in a row). A slice that saw no device kernel is
discarded and tried again later in the window, up to ``attempts`` times;
if none records a kernel, the run fails rather than read an idle share."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Slice:
    steps: int                       # decode steps in the slice
    rows: int                        # active rows summed over those steps
    staged: int                      # their staging-buffer tokens, summed
    window_s: float                  # host wall time of the slice
    busy_s: float                    # union of device operation intervals
    ops: List[Tuple[str, float]]     # device seconds by name, longest first
    gaps: List[Tuple[str, float]]    # idle seconds by what the host ran
    attempts: int


@dataclass
class Slicer:
    local: int = 64                  # the configuration's wave_index budgets
    update_segment: int = 1024
    start: int = 64
    steps: int = 24
    attempts: int = 4
    result: Optional[Slice] = None
    tries: int = 0
    _count: int = 0
    _rows: int = 0
    _staged_sum: int = 0
    _staged: Dict[int, int] = field(default_factory=dict)   # by slot
    _prof: object = None
    _t0: float = 0.0
    _open_at: int = 0
    _saved: Dict = field(default_factory=dict)

    def install(self) -> None:
        from repro_torch.serving import engine, graphs
        self._open_at = self.start
        orig_step = graphs.DecodeGraph.step
        orig_off = engine._OffloadPlane.decode_step
        orig_graft = engine.graft
        self._saved = {"step": orig_step, "off": orig_off,
                       "graft": orig_graft}
        slicer = self

        def graft(big, small, slot):
            slicer._staged[slot] = slicer.local
            return orig_graft(big, small, slot)

        def step(graph, active, state):
            slicer._tick(active)
            return orig_step(graph, active, state)

        def decode_step(plane, state, tokens_dev, active):
            slicer._tick(active)
            return orig_off(plane, state, tokens_dev, active)
        graphs.DecodeGraph.step = step
        engine._OffloadPlane.decode_step = decode_step
        engine.graft = graft

    def uninstall(self) -> None:
        from repro_torch.serving import engine, graphs
        if self._prof is not None:          # the window ended mid-slice
            self._prof.stop()
            self._prof = None
        if self._saved:
            graphs.DecodeGraph.step = self._saved["step"]
            engine._OffloadPlane.decode_step = self._saved["off"]
            engine.graft = self._saved["graft"]
            self._saved = {}

    def _tick(self, active) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        n = self._count
        self._count += 1
        if self.result is not None or self.tries >= self.attempts:
            return
        if n == self._open_at:
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
            self._rows = self._staged_sum = 0
            self._t0 = time.perf_counter()
        elif n == self._open_at + self.steps and self._prof is not None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self._t0
            self._prof.stop()
            prof, self._prof = self._prof, None
            self.tries += 1
            sl = analyse(prof, self.steps, self._rows, self._staged_sum,
                         wall, self.tries)
            if sl is not None:
                self.result = sl
            else:
                self._open_at = n + self.steps
        staged = self.stage(active)
        if self._prof is not None:
            self._rows += int(active.sum())
            self._staged_sum += staged

    def stage(self, active) -> int:
        """One step of the active rows: each appends a token to its staging
        buffer and attends all of it; returns their tokens, summed. A row
        that reaches ``local + update_segment`` is flushed after the step."""
        total = 0
        for i in map(int, active.nonzero()[0]):
            s = self._staged.get(i, self.local) + 1
            total += s
            if s >= self.local + self.update_segment:
                s -= self.update_segment
            self._staged[i] = s
        return total


def analyse(prof, steps: int, rows: int, staged: int, wall: float,
            tries: int) -> Optional[Slice]:
    """Busy time, device operations by name and idle gaps by host activity
    of one profiled slice; None when it holds no device operation."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.events():
        iv = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            dev.append((iv[0], iv[1], ev.name))
        elif ev.device_type == DeviceType.CPU and iv[1] > iv[0]:
            host.append((iv[0], iv[1], ev.name))
    if not dev:
        return None
    dev.sort()
    by_name: Dict[str, float] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    # the slice's edges on the profiler's clock: its first and last host event
    lo = min(min(h[0] for h in host), dev[0][0]) if host else dev[0][0]
    hi = max(max(h[1] for h in host), cur_e) if host else cur_e
    gaps = [(lo, dev[0][0])] + gaps + [(cur_e, hi)]
    idle = label_gaps([g for g in gaps if g[1] > g[0]], host)
    return Slice(steps=steps, rows=rows, staged=staged, window_s=wall,
                 busy_s=busy * 1e-6,
                 ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
                 gaps=idle, attempts=tries)


def label_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost host event open at each gap's
    midpoint ("host idle" where none is), longest first. One sweep over the
    host events sorted by start."""
    host = sorted(host)
    out: Dict[str, float] = {}
    active, i = [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        best = min(active, key=lambda h: h[1] - h[0], default=None)
        label = best[2] if best else "host idle"
        out[label] = out.get(label, 0.0) + (e - s) * 1e-6
    return sorted(out.items(), key=lambda kv: -kv[1])
