"""The port's wave buffer (``repro_torch/core/wave_buffer.py``) against the
reference's on the same seeded sequences of ``translate`` / ``assemble`` /
``apply_updates`` / ``store_rows`` calls: slots, hits, payloads, ``ok``
masks, admissions, checksums, the mapping table, the replacement state and
every ``BufferStats`` field must be equal. The scenarios of
``tests/test_wave_buffer.py`` run as parametrised cases, then a seeded soak
over every policy, cache size and fault profile."""
import dataclasses

import numpy as np
import pytest

from repro.core import wave_buffer as RWB
from repro_torch.core import wave_buffer as PWB

CAP, HD = 4, 2
D = 2 * CAP * HD + CAP            # a packed [K | V | pos] row


def _host(n, seed=0):
    rng = np.random.default_rng(seed)
    host = rng.standard_normal((n, D)).astype(np.float32)
    host[:, 2 * CAP * HD:] = rng.integers(-1, 500, (n, CAP))
    return host


def _scripted(mod, fail_first=0, latency_s=0.0):
    """A transport of module ``mod`` that fails the first ``fail_first``
    attempts of every cluster and charges ``latency_s`` per fetch."""

    class Scripted(mod.LinkTransport):
        def __init__(self):
            self.attempts = {}

        def fetch(self, store, cid):
            n = self.attempts.get(cid, 0)
            self.attempts[cid] = n + 1
            if n < fail_first:
                raise mod.TransientFault(f"scripted failure {n} for {cid}")
            return store[cid], latency_s

    return Scripted()


def _transport(mod, spec):
    if spec is None:
        return None
    kind, kw = spec
    if kind == "scripted":
        return _scripted(mod, **kw)
    if kind == "link":
        return mod.LinkTransport()
    return mod.FaultyTransport(mod.FaultProfile.parse(kw))


def _snapshot(buf):
    return dict(slot=buf.table.cache_slot.copy(),
                host_block=buf.table.host_block.copy(),
                owner=buf.cache_owner.copy(), cache=buf.cache.copy(),
                stamp=buf.stamp.copy(), ref_bit=buf.ref_bit.copy(),
                hand=buf.clock_hand, tick=buf.tick,
                checksums=buf.checksums.copy(), host=buf.kv_host.copy(),
                pending=sorted(buf._pending_map),
                n_pending=len(buf._pending),
                stats=dataclasses.asdict(buf.stats),
                hit_ratio=buf.stats.hit_ratio,
                effective=buf.stats.effective_hit_ratio,
                passthrough=buf.passthrough,
                bytes_per_cluster=buf.bytes_per_cluster)


def _run(mod, n, cache, ops, policy="lru", transport=None, **kw):
    """Drive one buffer of module ``mod`` through ``ops``; record every
    result, every exception (by class name and message) and a snapshot
    after each op."""
    host = _host(n)
    trace = []
    try:
        buf = mod.WaveBuffer(host, cache_clusters=cache, policy=policy,
                             transport=_transport(mod, transport), **kw)
    except Exception as e:                          # noqa: BLE001
        return [("init", type(e).__name__, str(e))]
    for op, *a in ops:
        try:
            if op == "translate":
                ids, deadline = a
                out = buf.translate(np.asarray(ids), deadline_s=deadline)
            elif op == "assemble":
                out = buf.assemble(np.asarray(a[0]))
            elif op == "apply":
                out = buf.apply_updates()
            elif op == "store":                     # a flush's rows
                start, scale = a
                rows = buf.kv_host[start:start + 2] * scale + 1.0
                out = buf.store_rows(start, rows)
            elif op == "raw_write":                 # bypasses store_rows
                buf.kv_host[a[0]] += 1.0
                out = None
            else:
                raise AssertionError(op)
            trace.append((op, out))
        except Exception as e:                      # noqa: BLE001
            trace.append((op, type(e).__name__, str(e)))
        trace.append(("state", _snapshot(buf)))
    return trace


def _equal(a, b, where="trace"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            f"{where}: {a!r} vs {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


def _check(n, cache, ops, **kw):
    ref = _run(RWB, n, cache, ops, **kw)
    port = _run(PWB, n, cache, ops, **kw)
    _equal(ref, port)
    return port


def T(ids, deadline=None):
    return ("translate", list(ids), deadline)


def A(ids):
    return ("assemble", list(ids))


APPLY = ("apply",)

# the scenarios of tests/test_wave_buffer.py: (n, cache, ops, options)
SCENARIOS = {
    "miss_then_hit": (64, 8, [A([3, 7, 9]), APPLY, A([3, 7, 9])], {}),
    "no_hit_before_update": (64, 8, [A([1]), A([1]), APPLY, A([1])], {}),
    "repeat_miss_not_double_counted": (
        32, 8, [A([3, 5]), A([5, 3, 7]), APPLY, A([3, 5, 7]), A([9])], {}),
    "lru_eviction_order": (
        32, 4, [A([0]), APPLY, A([1]), APPLY, A([2]), APPLY, A([3]), APPLY,
                A([0]), A([10]), APPLY], {}),
    "admit_more_uniques_lru": (64, 8, [A(range(24)), APPLY, A(range(24))],
                               {}),
    "admit_more_uniques_fifo": (64, 8, [A(range(24)), APPLY, A(range(24))],
                                dict(policy="fifo")),
    "admit_more_uniques_clock": (64, 8, [A(range(24)), APPLY, A(range(24))],
                                 dict(policy="clock")),
    "admit_clip_request_order": (64, 2, [A([50, 9, 30, 3, 40]), APPLY], {}),
    "admit_clip_duplicates": (64, 2, [A([7, 5, 7, 1]), APPLY], {}),
    "pending_hit_accounting": (32, 8, [A([3, 5]), A([5, 3]), APPLY,
                                       A([3, 5])], {}),
    "negative_cache_rejected": (64, -1, [], {}),
    "apply_updates_returns_admissions": (32, 4, [A([3, 9]), APPLY, APPLY],
                                         {}),
    "transfer_accounting": (16, 4, [A([0, 1]), APPLY, A([0, 1])], {}),
    "pending_map_cleared": (16, 4, [T([3, 5]), APPLY, T([3])], {}),
    "window_refetch_under_eviction": (
        16, 2, [T([0, 1]), APPLY, T([2, 3]), APPLY, ("store", 0, 1000.0),
                T([0])], {}),
    "pending_hits_scoped_to_window": (16, 0, [T([7]), T([7]), APPLY,
                                              T([7])], {}),
    "out_of_range_rejected": (16, 4, [T([3, 16]), T([-17])], {}),
    "transient_retried_to_success": (
        16, 4, [T([5]), APPLY], dict(transport=("scripted",
                                                dict(fail_first=2)),
                                     max_retries=2)),
    "retry_exhaustion_then_reconcile": (
        16, 4, [T([5, 7]), APPLY, T([5])],
        dict(transport=("scripted", dict(fail_first=3)), max_retries=2)),
    "deadline_fails_slow_fetches": (
        16, 4, [T([3], 0.1), T([3], 0.5)],
        dict(transport=("scripted", dict(latency_s=0.2)))),
    "deadline_shared_across_misses": (
        16, 4, [T([0, 1, 2, 3], 0.5)],
        dict(transport=("scripted", dict(latency_s=0.2)))),
    "corrupt_caught_by_checksum": (
        16, 4, [T([2])], dict(transport=("faulty", "corrupt=1.0,seed=0"),
                              max_retries=1)),
    "store_rows_refreshes_checksums": (
        16, 4, [("store", 4, 2.0), T([4, 5]), APPLY, ("raw_write", 6),
                T([6])], dict(transport=("link", None))),
    "fatal_propagates": (16, 4, [T([1])],
                         dict(transport=("faulty", "fatal=1.0,seed=0"))),
    "zero_rate_faulty_is_clean": (16, 4, [A([1, 2, 3])],
                                  dict(transport=("faulty", "seed=0"))),
}
for _p in ("lru", "fifo", "clock"):
    for _c in (0, 1):
        SCENARIOS[f"zero_one_slot_{_p}_{_c}"] = (
            32, _c, [A(np.random.default_rng(0).choice(32, 4, replace=False))
                     if i % 2 == 0 else APPLY for i in range(20)]
            + [A([7]), A([7])], dict(policy=_p))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    n, cache, ops, kw = SCENARIOS[name]
    trace = _check(n, cache, ops, **kw)
    assert trace                                 # something was recorded


def _soak_ops(n, seed, deadline):
    """A seeded decode-like sequence: lookups with repeats, a deferred
    update every few steps, and a flush's store every ten."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(40):
        ids = rng.integers(0, n, size=int(rng.integers(1, 7)))
        ops.append(T(ids, deadline) if step % 4 else A(ids))
        if step % 3 == 2:
            ops.append(APPLY)
        if step % 10 == 9:
            ops.append(("store", int(rng.integers(0, n - 2)), 0.5))
    return ops


PROFILES = {
    "clean": (None, None, {}),
    "transient": ("transient=0.3,seed=3", None, dict(max_retries=2)),
    "corrupt": ("corrupt=0.2,seed=4", None, dict(max_retries=1)),
    "spike": ("spike=0.4,latency_s=0.001,seed=5", 0.03, {}),
    "fatal": ("fatal=0.02,transient=0.1,seed=6", None, {}),
    "deadline": ("transient=0.25,spike=0.2,latency_s=0.002,seed=7", 0.004,
                 dict(max_retries=3, backoff_s=1e-3)),
}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("cache", [0, 1, 8, 32])
@pytest.mark.parametrize("policy", ["lru", "fifo", "clock"])
def test_soak_matches_reference(policy, cache, profile):
    spec, deadline, kw = PROFILES[profile]
    transport = None if spec is None else ("faulty", spec)
    trace = _check(32, cache, _soak_ops(32, 11, deadline), policy=policy,
                   transport=transport, **kw)
    stats = trace[-1][1]["stats"]
    assert stats["lookups"] > 0
    if profile in ("transient", "deadline"):
        assert stats["faults"] > 0


def test_fault_profile_parse_matches_reference():
    for spec in ("transient=0.2,corrupt=0.01,seed=3", "spike=0.5,seed=9",
                 " fatal=1.0 , latency_s=0.5,", ""):
        assert dataclasses.asdict(PWB.FaultProfile.parse(spec)) == \
            dataclasses.asdict(RWB.FaultProfile.parse(spec))
    with pytest.raises(ValueError, match="unknown fault-profile field"):
        PWB.FaultProfile.parse("bogus=1")


def test_mapping_table_and_stats_merge():
    for mod in (RWB, PWB):
        t = mod.ClusterMappingTable(8, 3)
        t.cache_slot[[2, 5]] = [1, 0]
        slot, blk = t.lookup(np.array([2, 5, 7]))
        assert slot.tolist() == [1, 0, -1] and blk.tolist() == [6, 15, 21]
    a, b = PWB.BufferStats(lookups=3, hits=1), PWB.BufferStats(lookups=2,
                                                                pending_hits=1)
    a.merge(b)
    assert (a.lookups, a.hits, a.pending_hits) == (5, 1, 1)
    assert [f.name for f in dataclasses.fields(PWB.BufferStats)] == \
        [f.name for f in dataclasses.fields(RWB.BufferStats)]
