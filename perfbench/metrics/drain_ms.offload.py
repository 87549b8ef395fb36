"""The offload plane's host time draining deferred cache admissions a
decode step, in ms: the ``drain_admissions`` spans of every layer over the
decode steps, in the window's first call served again with the program's
spans on (``perfbench/lib/spanned.py``). Layer: wave buffer."""
from perfbench.lib import spanned


def read(run):
    return spanned.step_ms(run, "drain_admissions")
