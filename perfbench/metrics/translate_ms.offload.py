"""The offload plane's host time translating retrieved cluster ids a
decode step, in ms: the ``translate`` spans of every layer (cache lookups,
miss fetches from the host stores with their checksums) over the decode
steps, in the window's first call served again with the program's spans on
(``perfbench/lib/spanned.py``). Layer: wave buffer."""
from perfbench.lib import spanned


def read(run):
    return spanned.step_ms(run, "translate")
