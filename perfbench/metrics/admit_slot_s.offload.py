"""Seconds a request's cluster stores take to reach host memory at its
admission: the ``admit_slot`` spans (packing on the card, the copy to the
host, a wave buffer a layer and head) over the admitted requests, in the
window's first call served again with the program's spans on
(``perfbench/lib/spanned.py``). Layer: wave buffer."""
from perfbench.lib import spanned


def read(run):
    m = spanned.call(run)
    if m is None:
        return None
    n = m.spans.count("admit_slot")
    return m.spans.seconds("admit_slot") / n if n else None
