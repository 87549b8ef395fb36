"""Blocking admission's prompt tokens over the card's seconds building the
wave index: the ``prefill.index`` device spans (``build_kv``: the
segmented k-means and the stores of every layer), in the window's first
call served again with the program's spans on
(``perfbench/lib/spanned.py``). Layer: admission and index build."""
from perfbench.lib import spanned


def read(run):
    return spanned.prompt_tok_s(run, "prefill.index")
