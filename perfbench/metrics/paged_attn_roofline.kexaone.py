"""The wave-attention kernel's share of its roofline in the profiled
slice, in percent, counted over the layers that run it: the global layers
only (the sliding layers attend their ring in plain operations, not in
this kernel). Otherwise as ``paged_attn_roofline.py``: the least time of
the slice's attention calls from the cell's zone plan, each active row's
staging-buffer tokens at each step, over the device time of the paged
kernel's split and combine launches. Layer: kernels."""
from perfbench.roofline import bounds, kexaone

NAMES = ("PagedSrc", "combine_kernel")


def read(run):
    sl = run.slice
    if sl is None:
        return None
    dev = sum(s for n, s in sl.ops if any(t in n for t in NAMES))
    if dev <= 0:
        return None
    cfg = run.cfg
    n_global = kexaone.kinds(run.conf)[1]
    nbytes, flops = bounds.paged_call_terms(
        sl.rows, sl.staged, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
        cfg.head_dim, run.plan, bounds.retro_of(run.conf["wave_index"]))
    least, _ = bounds.bound(nbytes * n_global, flops * n_global)
    return 100.0 * least / dev
