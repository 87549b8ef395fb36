"""Blocking admission's prompt tokens per second over the window: the
engine's prefill token count over its admission time (each admission
iteration ends in the first-token sync). Layer: admission and index build."""


def read(run):
    s = sum(m.prefill_s for m in run.calls)
    return sum(m.prefill_tokens for m in run.calls) / s if s > 0 else None
