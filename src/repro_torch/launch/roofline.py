"""Roofline terms of a traced step on the H100. Port of
``repro/launch/roofline.py``:

    compute term    = FLOPs per device / peak bf16 FLOP/s
    memory term     = bytes per device / HBM bandwidth
    collective term = collective bytes per device / NVLink bandwidth

The reference reads XLA's cost analysis of a compiled, partitioned module
and parses collectives out of its HLO. Here the numbers come from a trace
of the eager step (``launch/dryrun.py``): FLOPs from
``torch.utils.flop_counter``, bytes as every op's operands and results
(an unfused count: eager PyTorch writes every intermediate), and the
collectives from the tally ``core/distributed.py`` keeps
(``collective_tally``). The constants are the H100 data sheet's
(``launch/mesh.py``); the 'model' axis lies inside one NVLink node on every
mesh of ``mesh.py``, so collectives are charged at NVLink's rate.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Tuple

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(tally: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum a ``collective_tally`` record by kind, plus ``total``."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in tally:
        out[kind] += int(nbytes)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_ratio: float            # MODEL_FLOPS / (traced FLOPs * chips)
    peak_mem_bytes: float = 0.0
    note: str = ""

    def as_dict(self):
        return asdict(self)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS convention: 6·N·D train, 2·N·D forward (N = active
    parameters, D = tokens; decode: one token a sequence)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch


def derive(cfg: ModelConfig, shape: InputShape, mesh_name: str, chips: int,
           cost: Dict, coll: Dict[str, int], peak_mem: float = 0.0,
           note: str = "") -> Roofline:
    """``cost``: per-device ``flops`` and ``bytes accessed``; ``coll``: per
    device collective bytes (``collective_bytes``)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0))
    cs = flops / PEAK_FLOPS_BF16
    ms = byts / HBM_BW
    ls = cb / NVLINK_BW
    dom = max((("compute", cs), ("memory", ms), ("collective", ls)),
              key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    ratio = mf / max(flops * chips, 1.0)
    return Roofline(arch=cfg.arch_id, shape=shape.name, mesh=mesh_name,
                    chips=chips, flops_per_chip=flops, bytes_per_chip=byts,
                    coll_bytes_per_chip=cb, compute_s=cs, memory_s=ms,
                    collective_s=ls, dominant=dom, model_flops_global=mf,
                    useful_ratio=ratio, peak_mem_bytes=peak_mem, note=note)
