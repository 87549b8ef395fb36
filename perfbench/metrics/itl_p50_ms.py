"""Median gap between consecutive token deliveries of continuing
requests, pooled over the window's calls, in ms. Layer: compiled decode
stage (a replayed step with the harvest around it)."""
import numpy as np


def read(run):
    steps = [s for m in run.calls for s in m.step_s]
    return float(np.percentile(steps, 50)) * 1e3 if steps else None
