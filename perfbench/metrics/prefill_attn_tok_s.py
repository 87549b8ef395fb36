"""Blocking admission's prompt tokens over the card's seconds in its
attention: the ``prefill.attn`` device spans (the flash or block-sparse
attention of every layer), in the window's first call served again with
the program's spans on (``perfbench/lib/spanned.py``). Layer: admission
and index build."""
from perfbench.lib import spanned


def read(run):
    return spanned.prompt_tok_s(run, "prefill.attn")
