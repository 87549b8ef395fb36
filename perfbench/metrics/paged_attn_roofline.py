"""The wave-attention kernel's share of its roofline in the profiled
slice, in percent: the least time the slice's attention calls need (bytes
or f32 operations, counted from the cell's zone plan for each active row
of each layer and step, with the staging-buffer tokens each row holds at
that step) over the device time of the paged kernel's split and combine
launches. Layer: kernels."""
from perfbench.roofline import bounds

NAMES = ("PagedSrc", "combine_kernel")


def read(run):
    sl = run.slice
    if sl is None:
        return None
    dev = sum(s for n, s in sl.ops if any(t in n for t in NAMES))
    if dev <= 0:
        return None
    cfg = run.cfg
    nbytes, flops = bounds.paged_call_terms(
        sl.rows, sl.staged, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
        cfg.head_dim, run.plan, bounds.retro_of(run.conf["wave_index"]))
    least, _ = bounds.bound(nbytes * cfg.n_layers, flops * cfg.n_layers)
    return 100.0 * least / dev
