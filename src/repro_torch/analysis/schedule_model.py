"""retrosched event/effects model of the port: the happens-before graph of
the offload decode schedule (rules RL301-RL305 live in ``schedule_check``).

A copy of ``repro/analysis/schedule_model.py``, held to the port's stage
table: ``ScheduleRecorder`` hooks the port's ``_OffloadPlane.trace`` no-op
(``repro_torch/serving/engine.py``), which the plane calls in the
reference's program order, and ``build_trace`` resolves effects through the
port's ``SERVE_STAGES``.

The offload control plane interleaves four actors: the single device stream
(the stage's pieces, replayed or run eagerly in launch order), the host
thread (translation, deferred-admission drains, payload packing), the
host->device copies staged before each piece, and the device->host
readbacks (the only points where the host learns device state). Each
``SERVE_STAGES`` entry names its *effects*: the abstract buffers a stage
reads, writes, donates, or passes through, and the memory space each buffer
lives in. From a recorded schedule this module builds the event list the
model checker runs over.

Happens-before, as the checker uses it:

* host events (including launch *issuance*) are totally ordered by ``seq``;
* device *execution* of launches is totally ordered by launch order (one
  in-order stream);
* a launch executes after its own issuance (so after every earlier host
  event);
* a ``sync`` event on a device value completes after the producing launch
  executed and, stream order being total, after every launch issued before
  the producer.

Buffers are strings like ``"cache_body[3]"``: a base name from
``BUFFER_SPACE`` plus the layer instance. Stage declarations use ``[l]``
(the event's layer) or ``[*]`` (every layer); layer-free buffers
(``hidden``, ``tokens``) have no suffix.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Memory space of each abstract buffer, by base name. "device" buffers are
# only legally written by dispatched stages (the stream serializes them);
# "host" buffers are only touched by host-thread ops; "link" buffers are
# host-built payloads consumed by a dispatch at issuance (the host->device
# transfer is part of the dispatch).
BUFFER_SPACE: Dict[str, str] = {
    # device
    "hidden": "device", "live": "device", "ids": "device", "ctx": "device",
    "cache_body": "device", "cache_tail": "device", "logits": "device",
    "tokens": "device", "serve_state": "device", "slot_state": "device",
    "chunk_state": "device", "prompt": "device", "flush_blocks": "device",
    # host
    "ids_host": "host", "cmt": "host", "host_store": "host",
    "pending": "host", "adm_queue": "host",
    # host-built, consumed by a dispatch at issuance ("valid" is the
    # per-cluster fetch-validity mask of the degraded decode path: built by
    # translate, read by the same step's attend — RL301 certifies the order)
    "slots": "link", "miss": "link", "valid": "link",
}

# Host control-plane ops of the offload decode step. These are not device
# stages (no donate/budget contract) but they ARE schedule events; the
# engine registers them in SERVE_STAGES with space="host" so the whole
# schedule contract lives in one table.
HOST_OP_KINDS = ("host", "sync")


def buffer_base(buf: str) -> str:
    return buf.split("[", 1)[0]


def buffer_space(buf: str) -> str:
    return BUFFER_SPACE.get(buffer_base(buf), "host")


@dataclass(frozen=True)
class Event:
    """One schedule event with fully resolved effects.

    ``kind``: "dispatch" (device stage, issued here, executed on the stream),
    "host" (host-thread compute), or "sync" (host blocks on a device value).
    ``passes`` are donated-and-carried buffers: the output aliases the input
    bit-for-bit (``cache_stage`` passing the cache body through), which
    rebinds the reference without counting as a data write.
    """
    seq: int
    step: int
    layer: int
    op: str
    kind: str
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()
    donates: Tuple[str, ...] = ()
    passes: Tuple[str, ...] = ()

    def qual(self) -> str:
        at = f"@step{self.step}" + (f"/L{self.layer}" if self.layer >= 0
                                    else "")
        return f"{self.op}{at}"


def _resolve_one(name: str, layer: int, n_layers: int) -> Tuple[str, ...]:
    if name.endswith("[l]"):
        if layer < 0:
            raise ValueError(f"effect {name!r} needs a layer, event has none")
        return (f"{name[:-3]}[{layer}]",)
    if name.endswith("[*]"):
        return tuple(f"{name[:-3]}[{i}]" for i in range(n_layers))
    return (name,)


def resolve_effects(effects: Dict[str, Sequence[str]], layer: int,
                    n_layers: int) -> Dict[str, Tuple[str, ...]]:
    """Substitute ``[l]``/``[*]`` placeholders for one event instance."""
    out: Dict[str, Tuple[str, ...]] = {}
    for slot in ("reads", "writes", "donates", "passes"):
        resolved: List[str] = []
        for name in effects.get(slot, ()):
            resolved.extend(_resolve_one(name, layer, n_layers))
        out[slot] = tuple(resolved)
    return out


def make_event(seq: int, step: int, layer: int, op: str, kind: str,
               n_layers: int, stage_table: Dict[str, Dict[str, Any]],
               extras: Optional[Dict[str, Any]] = None) -> Event:
    """Build one resolved event from a stage-table entry (or raw effects
    passed via ``extras["effects"]`` for ops outside the table — used by the
    selftest fixtures to seed pathological schedules)."""
    extras = extras or {}
    if "effects" in extras:
        effects = dict(extras["effects"])
    else:
        contract = stage_table.get(op)
        if contract is None or "effects" not in contract:
            raise KeyError(f"op {op!r} has no effects declaration in the "
                           f"stage table — every schedule event must declare "
                           f"its effects (see SERVE_STAGES)")
        effects = dict(contract["effects"])
    eff = resolve_effects(effects, layer, n_layers)
    # dynamic refinement: a drain that queued nothing remapped nothing (its
    # writes would otherwise claim an admission mirror that never exists,
    # tripping RL302 on every warm-cache step)
    if extras.get("queued") is False:
        eff["writes"] = tuple(b for b in eff["writes"]
                              if buffer_base(b) not in ("adm_queue", "cmt"))
    return Event(seq=seq, step=step, layer=layer, op=op, kind=kind,
                 reads=eff["reads"], writes=eff["writes"],
                 donates=eff["donates"], passes=eff["passes"])


@dataclass
class ScheduleTrace:
    """A recorded (or seeded) schedule: events in host order, plus the
    derived device-stream order of the dispatches."""
    n_layers: int
    events: List[Event] = field(default_factory=list)

    @property
    def dispatches(self) -> List[Event]:
        return [e for e in self.events if e.kind == "dispatch"]

    def stream_pos(self) -> Dict[int, int]:
        """seq -> position on the device stream (dispatches only)."""
        return {e.seq: i for i, e in enumerate(self.dispatches)}

    def last_device_writer(self, buf: str, before_seq: int
                           ) -> Optional[Event]:
        """Latest dispatch (stream order == host issuance order) writing or
        passing ``buf`` issued before ``before_seq``."""
        best = None
        for e in self.dispatches:
            if e.seq >= before_seq:
                break
            if buf in e.writes or buf in e.passes:
                best = e
        return best

    def completed_stream_prefix(self, at_seq: int) -> int:
        """Number of leading stream dispatches PROVEN complete at host time
        ``at_seq``: the largest stream position synced on, plus one. A sync
        on a value produced by dispatch P proves every dispatch issued up to
        and including P has executed."""
        pos = self.stream_pos()
        done = 0
        for e in self.events:
            if e.seq >= at_seq:
                break
            if e.kind != "sync":
                continue
            for buf in e.reads:
                if buffer_space(buf) != "device":
                    continue
                prod = self.last_device_writer(buf, e.seq)
                if prod is not None:
                    done = max(done, pos[prod.seq] + 1)
        return done

    def depends(self, a: Event, b: Event) -> bool:
        """True if a dependency chain (RAW/WAR/WAW through intermediate
        events) forces ``a`` to stay before ``b`` in host order."""
        assert a.seq < b.seq
        window = [e for e in self.events if a.seq <= e.seq <= b.seq]
        live = set(a.writes) | set(a.passes)
        if not live:
            return False
        for e in window[1:]:
            touched = set(e.reads) | set(e.writes) | set(e.donates)
            if live & touched:
                if e is b:
                    return True
                live |= set(e.writes) | set(e.passes)
        # WAR: b writes something a reads
        return bool((set(a.reads) | set(a.donates))
                    & (set(b.writes) | set(b.donates)))


class ScheduleRecorder:
    """Context manager hooking the real ``_OffloadPlane.trace`` no-op so a
    live offload serve run records its schedule (the StageRecorder idiom of
    the stage pass, applied to the control plane)."""

    def __init__(self) -> None:
        self.trace: Optional[ScheduleTrace] = None
        self._raw: List[Tuple[int, int, str, str, Dict[str, Any]]] = []

    def __enter__(self) -> "ScheduleRecorder":
        from repro_torch.serving import engine as _engine
        self._engine = _engine
        self._orig = _engine._OffloadPlane.trace
        recorder = self

        def tracing(plane, op, layer, kind, step, **extras):
            if recorder.trace is None:
                recorder.trace = ScheduleTrace(n_layers=plane.L)
            recorder._raw.append((step, layer, op, kind, extras))

        _engine._OffloadPlane.trace = tracing
        return self

    def __exit__(self, *exc) -> None:
        self._engine._OffloadPlane.trace = self._orig
        if self.trace is not None:
            table = self._engine.SERVE_STAGES
            for seq, (step, layer, op, kind, extras) in enumerate(self._raw):
                self.trace.events.append(make_event(
                    seq, step, layer, op, kind, self.trace.n_layers,
                    table, extras))


def build_trace(schedule: Iterable[Tuple], n_layers: int,
                stage_table: Optional[Dict[str, Dict[str, Any]]] = None
                ) -> ScheduleTrace:
    """Build a trace from ``(step, layer, op, kind[, extras])`` tuples — the
    fixture path: selftests seed good/bad schedules through the same
    resolver the recorder uses, so a fixture exercises exactly the model the
    real engine is held to."""
    if stage_table is None:
        from repro_torch.serving.engine import SERVE_STAGES
        stage_table = SERVE_STAGES
    trace = ScheduleTrace(n_layers=n_layers)
    for seq, item in enumerate(schedule):
        step, layer, op, kind = item[:4]
        extras = item[4] if len(item) > 4 else None
        trace.events.append(make_event(seq, step, layer, op, kind, n_layers,
                                       stage_table, extras))
    return trace
