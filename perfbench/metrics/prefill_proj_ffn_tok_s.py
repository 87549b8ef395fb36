"""Blocking admission's prompt tokens over the card's seconds in each
layer outside its attention and index build: the self time of the
``prefill.layer`` device spans (norms, the projections, the FFN or MoE),
in the window's first call served again with the program's spans on
(``perfbench/lib/spanned.py``). Layer: admission and index build."""
from perfbench.lib import spanned


def read(run):
    return spanned.prompt_tok_s(run, "prefill.layer", own=True)
