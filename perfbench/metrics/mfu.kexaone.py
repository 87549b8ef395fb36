"""Model FLOPs of the window's work on this card over its wall time and
the card's dense bf16 peak, in percent: each served request's prompt and
decoded tokens through the stage's blocks (the held experts' expected
share of each token's routed experts, the shared expert, the dense layer),
windowed attention on sliding layers and the wave index's zones on global
ones, counted from the published sizes (``roofline/kexaone.py``). Layer:
model step."""
from perfbench.roofline import bounds, kexaone


def read(run):
    retro = bounds.retro_of(run.conf["wave_index"])
    work = sum(kexaone.served_flops(run.conf, len(r.prompt),
                                    len(r.out_tokens), run.plan, retro)
               for r in run.requests)
    return 100.0 * work / (run.window_s * bounds.BF16_FLOPS)
