"""retrosched — RL301-RL305 happens-before model checks over the port's
offload decode schedule.

Counterpart of ``repro/analysis/schedule_check.py``: the same rules, held to
the port's ``SERVE_STAGES`` and its ``_OffloadPlane``.

The event/effects model lives in ``schedule_model``; this module holds the
rules. ``check_trace`` runs them over a ``ScheduleTrace`` — recorded from a
real serve run (``ScheduleRecorder`` hooks ``_OffloadPlane.trace``) or seeded
from an op-sequence fixture (``schedule_model.build_trace``); both paths
resolve effects through the same ``SERVE_STAGES`` declarations, so a fixture
exercises exactly the model the engine is held to.

Rules (error unless noted):

* RL301 — a dispatch reads the miss staging tail (or a host-built payload)
  whose same-step write has not happened-before it;
* RL302 — a deferred-admission drain remapped the ClusterMappingTable but no
  ``cache_upd`` consumed its admission queue before the next attend on that
  layer (the device cache lags the table: translated slot ids point at
  whatever the evicted cluster left behind);
* RL303 — a host-space write lands in a device buffer while a dispatched
  reader of that buffer is not yet proven complete (no sync edge);
* RL304 — (advice) the pipeline-opportunity detector: a blocking readback
  with an idle host-order gap while independent host work sits just before
  the producer — that work could legally overlap the sync;
* RL305 — a donated buffer is read or re-donated before being rebound.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.schedule_model import (Event, ScheduleRecorder,
                                           ScheduleTrace, buffer_base,
                                           buffer_space)

ENGINE_PATH = "src/repro_torch/serving/engine.py"


def _finding(rule: str, event: Event, message: str,
             severity: str = "error") -> Finding:
    qual = f"{event.op}" + (f"/L{event.layer}" if event.layer >= 0 else "")
    return Finding(rule, ENGINE_PATH, 0, qual, message, severity=severity)


def _last_host_writer(tr: ScheduleTrace, buf: str,
                      before_seq: int) -> Optional[Event]:
    best = None
    for e in tr.events:
        if e.seq >= before_seq:
            break
        if e.kind == "host" and buf in e.writes:
            best = e
    return best


# ----------------------------------------------------------------- RL301
def _check_staging_order(tr: ScheduleTrace, out: List[Finding]) -> None:
    for d in tr.dispatches:
        for buf in d.reads:
            if buf in d.writes:
                continue        # read-modify-write: the event IS the stager
            if buffer_base(buf) == "cache_tail":
                w = tr.last_device_writer(buf, d.seq)
                if w is None or w.step != d.step or w.layer != d.layer:
                    stale = "no staging write at all" if w is None else \
                        f"last write is {w.qual()}"
                    out.append(_finding(
                        "RL301", d,
                        f"{d.qual()} reads the miss staging tail {buf} but "
                        f"this step's staging write has not landed on the "
                        f"stream before it ({stale}) — the attend would "
                        f"consume the previous step's staged clusters"))
            elif buffer_space(buf) == "link":
                t = _last_host_writer(tr, buf, d.seq)
                if t is None or t.step != d.step or t.layer != d.layer:
                    src = "never built" if t is None else \
                        f"last built by {t.qual()}"
                    out.append(_finding(
                        "RL301", d,
                        f"{d.qual()} consumes host-built payload {buf} "
                        f"({src}) — the dispatch was issued before this "
                        f"step's translate produced it"))


# ----------------------------------------------------------------- RL302
def _check_mirror_edge(tr: ScheduleTrace, out: List[Finding]) -> None:
    for i, e in enumerate(tr.events):
        if e.op != "drain_admissions":
            continue
        for buf in e.writes:
            if buffer_base(buf) != "adm_queue":
                continue
            consumed = False
            for f in tr.events[i + 1:]:
                if f.op == "cache_upd" and buf in f.reads:
                    consumed = True
                if f.op == "attend_fn" and f.layer == e.layer:
                    if not consumed:
                        out.append(_finding(
                            "RL302", e,
                            f"{e.qual()} remapped mapping-table entries and "
                            f"queued {buf}, but no cache_upd consumed the "
                            f"queue before {f.qual()} — translated slot ids "
                            f"point at clusters the device cache no longer "
                            f"holds"))
                    break


# ----------------------------------------------------------------- RL303
def _check_inflight_overwrite(tr: ScheduleTrace, out: List[Finding]) -> None:
    pos = tr.stream_pos()
    for e in tr.events:
        if e.kind != "host":
            continue
        dev_writes = [b for b in e.writes if buffer_space(b) == "device"]
        if not dev_writes:
            continue
        done = tr.completed_stream_prefix(e.seq)
        for buf in dev_writes:
            inflight = [d for d in tr.dispatches
                        if d.seq < e.seq and buf in d.reads
                        and pos[d.seq] >= done]
            if inflight:
                out.append(_finding(
                    "RL303", e,
                    f"{e.qual()} writes device buffer {buf} off the stream "
                    f"while {inflight[-1].qual()} (dispatched, not proven "
                    f"complete by any sync) still reads it — route the "
                    f"mirror through a jitted stage so the stream orders "
                    f"them"))


# ----------------------------------------------------------------- RL304
def _check_pipeline_opportunity(tr: ScheduleTrace,
                                out: List[Finding]) -> None:
    pos = tr.stream_pos()
    for s in tr.events:
        if s.kind != "sync":
            continue
        producer = None
        for buf in s.reads:
            if buffer_space(buf) != "device":
                continue
            w = tr.last_device_writer(buf, s.seq)
            if w is not None and (producer is None
                                  or pos[w.seq] > pos[producer.seq]):
                producer = w
        if producer is None:
            continue
        gap_work = [e for e in tr.events
                    if producer.seq < e.seq < s.seq
                    and e.kind == "host" and e.writes]
        if gap_work:
            continue                # the sync already overlaps host work
        hoistable = None
        for e in tr.events:
            if e.seq >= producer.seq:
                break
            if e.kind == "host" and e.writes and e.step == producer.step:
                hoistable = e
        if hoistable is None or tr.depends(hoistable, producer):
            continue
        out.append(_finding(
            "RL304", s,
            f"{s.qual()} blocks with an idle host while {hoistable.qual()} "
            f"(no dependency path into {producer.qual()}) sits before the "
            f"producer — dispatch {producer.op} first and run "
            f"{hoistable.op} inside the gap to overlap the readback",
            severity="advice"))


# ----------------------------------------------------------------- RL305
def _check_donation_reuse(tr: ScheduleTrace, out: List[Finding]) -> None:
    for i, e in enumerate(tr.events):
        for buf in e.donates:
            if buf in e.writes or buf in e.passes:
                continue            # rebound by the donating op itself
            for f in tr.events[i + 1:]:
                if buf in f.writes or buf in f.passes:
                    break           # rebound before any reuse
                if buf in f.reads or buf in f.donates:
                    out.append(_finding(
                        "RL305", f,
                        f"{f.qual()} uses {buf} after {e.qual()} donated it "
                        f"without rebinding — once layers overlap the "
                        f"buffer is clobbered device memory"))
                    break


_CHECKS: List[Callable[[ScheduleTrace, List[Finding]], None]] = [
    _check_staging_order, _check_mirror_edge, _check_inflight_overwrite,
    _check_pipeline_opportunity, _check_donation_reuse,
]


def check_trace(trace: ScheduleTrace) -> List[Finding]:
    """All RL3xx rules over one schedule, deduped by fingerprint (per-step
    repeats of one defect collapse to a single finding)."""
    raw: List[Finding] = []
    for check in _CHECKS:
        check(trace, raw)
    seen, out = set(), []
    for f in raw:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out


def schedule_findings(trace: Optional[ScheduleTrace]) -> List[Finding]:
    """``check_trace`` with the recorded-nothing case surfaced as its own
    error: an offload serve run that produced no events means the trace
    hooks were removed or the plane was bypassed, and the schedule is
    unverified."""
    if trace is None or not trace.events:
        return [Finding(
            "RL301", ENGINE_PATH, 0, "_OffloadPlane",
            "offload serve run recorded no schedule events — trace hooks "
            "missing, so the decode schedule cannot be certified")]
    return check_trace(trace)


# --------------------------------------------------------------- fixtures
def reference_schedule(n_layers: int = 2, steps: int = 2, *,
                       pipelined: bool = True, warm: bool = False,
                       drop_mirror: bool = False) -> List[tuple]:
    """The offload decode schedule as ``(step, layer, op, kind[, extras])``
    tuples. ``pipelined=True`` is the shipped engine order (layer l+1's rank
    dispatched and readback started before layer l's drain);
    ``pipelined=False`` is the pre-pipeline order that RL304 flags;
    ``warm=True`` drains nothing (all hits); ``drop_mirror=True`` seeds the
    RL302 bug (admissions queued but staged with ``cache_stage``)."""
    sched: List[tuple] = []
    for t in range(steps):
        sched.append((t, -1, "embed_tokens", "dispatch"))
        if pipelined:
            sched.append((t, 0, "rank_fn", "dispatch"))
            sched.append((t, 0, "readback_start", "host"))
        for layer in range(n_layers):
            if not pipelined:
                sched.append((t, layer, "rank_fn", "dispatch"))
            sched.append((t, layer, "readback_ids", "sync"))
            sched.append((t, layer, "translate", "host"))
            upd = "cache_upd" if (t > 0 and not warm and not drop_mirror) \
                else "cache_stage"
            sched.append((t, layer, upd, "dispatch"))
            sched.append((t, layer, "attend_fn", "dispatch"))
            if pipelined and layer + 1 < n_layers:
                sched.append((t, layer + 1, "rank_fn", "dispatch"))
                sched.append((t, layer + 1, "readback_start", "host"))
            sched.append((t, layer, "drain_admissions", "host",
                          {"queued": not warm}))
        sched.append((t, -1, "unembed_logits", "dispatch"))
    return sched


# ----------------------------------------------------------- live serve run
def run_schedule_checks(verbose=None, device="cpu") -> List[Finding]:
    """Standalone gate: record the schedule of a real tiny offload serve of
    the port and model-check it. The lint CLI reaches the same check through
    ``stage_check.run_contract_checks`` (one recorder wraps its offload
    run); this entrypoint serves tests and ad-hoc use."""
    from repro_torch.analysis.stage_check import (LENGTHS, MAX_NEW, _requests,
                                                  _tiny_setup)
    from repro_torch.serving.engine import ServeEngine
    log = verbose or (lambda *_: None)
    cfg, params = _tiny_setup(device)
    log("retrosched: recording offload serve schedule")
    with ScheduleRecorder() as rec:
        engine = ServeEngine(cfg, params, gen_headroom=256,
                             admission="chunked", offload=True,
                             temperature=0.0, device=device)
        engine.serve(_requests(LENGTHS, MAX_NEW), batch_size=2, seed=0)
    log("retrosched: model-checking the recorded schedule")
    return schedule_findings(rec.trace)
