"""Bytes fetched from host memory over the link per delivered token, over
the window, in MB (the wave buffers' counters). Layer: wave buffer."""


def read(run):
    toks = sum(m.tokens_out for m in run.calls)
    return sum(m.cache.bytes_over_link for m in run.calls) / toks / 1e6 \
        if toks else None
