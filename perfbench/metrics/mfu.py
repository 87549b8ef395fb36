"""Model FLOPs of the window's work over its wall time and the card's
dense bf16 peak, in percent: each served request's prompt (blocks, causal
attention, one head call) and decoded tokens (blocks, head, the attention
of its zones), counted from the published sizes. Layer: model step."""
from perfbench.roofline import bounds


def read(run):
    retro = bounds.retro_of(run.conf["wave_index"])
    work = sum(bounds.served_flops(run.conf, len(r.prompt), len(r.out_tokens),
                                   run.plan, retro)
               for r in run.requests)
    return 100.0 * work / (run.window_s * bounds.BF16_FLOPS)
