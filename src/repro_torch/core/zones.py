"""Tripartite zone planning (paper Sec. 4.2). Port of ``repro/core/zones.py``."""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.configs.base import RetroConfig
from repro_torch.core.wave_index import max_clusters, prefill_layout


class ZonePlan(NamedTuple):
    m_max: int          # static cluster-store size
    r: int              # retrieval-zone clusters
    e: int              # estimation-zone clusters
    sink: int
    local_buf: int      # staging buffer (local window + update segment)


def plan_zones(seq_len: int, retro: RetroConfig, gen_headroom: int = 4096) -> ZonePlan:
    """Prompts shorter than sink + local degrade to a steady-zone-only plan
    (r = e = 0)."""
    _, _, m_prefill = prefill_layout(seq_len, retro)
    m_max = max_clusters(seq_len, retro, gen_headroom)
    r = min(retro.r_clusters(seq_len), m_prefill)
    e = min(retro.e_clusters(seq_len), max(0, m_prefill - r))
    return ZonePlan(m_max=m_max, r=r, e=e, sink=retro.sink,
                    local_buf=retro.local + retro.update_segment)
