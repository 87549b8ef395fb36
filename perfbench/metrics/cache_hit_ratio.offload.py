"""Share of the offload plane's block-cache lookups that hit, over the
window, in percent (the wave buffers' counters). Layer: wave buffer."""


def read(run):
    look = sum(m.cache.lookups for m in run.calls)
    return 100.0 * sum(m.cache.hits for m in run.calls) / look \
        if look else None
