"""Blocking admission's prompt tokens over the card's seconds in the
expert share's FFN: the ``prefill.moe`` device spans (router, the held
experts' grouped rows, the shared expert, of every MoE layer), in the
window's first call served again with the program's spans on
(``perfbench/lib/spanned.py``). Where the program has no such span it
reads nothing. Layer: admission and index build."""
from perfbench.lib import spanned


def read(run):
    m = spanned.call(run)
    if m is None or not m.spans.count("prefill.moe"):
        return None
    return spanned.prompt_tok_s(run, "prefill.moe")
