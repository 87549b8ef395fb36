"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix and the metrics it
reports; ``perfbench/cells/<cell>.json`` holds the engine's arguments, the
batch, the warm-up and the check; ``perfbench/configs/<config>.json`` the
published sizes and the port's fields; ``perfbench/traffic/<mix>.json`` the
mix's parameters; ``perfbench/metrics/<metric>.py`` each per-layer reader
(``<quantity>.py`` for a name split by cell, ``<quantity>.<part>``, that
has no reader of its own).
Adding any of them is adding a file."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise ValueError(f"no workload {name!r} in BENCHMARK.json")


def cell(name: str) -> Dict:
    return _json(BENCH / "cells" / f"{name}.json")


def config(name: str) -> Dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def metrics(bench: Dict, kind: str, cell_name: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` key, and those whose list names the cell."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def base(name: str) -> str:
    """The quantity a metric's name splits by cell (``out_tok_s`` of
    ``out_tok_s.offload``)."""
    return name.split(".")[0]


def reader(name: str) -> Callable:
    """``read`` of ``perfbench/metrics/<name>.py``; a name split by cell
    that has no file of its own is read by its quantity's reader."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{base(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(name: str):
    """The plain reference module ``perfbench/reference/<name>.py``."""
    return importlib.import_module(f"perfbench.reference.{name}")


def model_config(conf: Dict):
    """The port's ``ModelConfig`` from a configuration file's ``port``
    fields (``attn`` and ``moe`` as their dataclasses) and its
    ``wave_index`` budgets (the ``RetroConfig``)."""
    from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,
                                          RetroConfig)
    fields = dict(conf["port"])
    attn = dict(fields.pop("attn"))
    attn["pattern"] = tuple(attn.get("pattern", ("g",)))
    moe = fields.pop("moe", None)
    return ModelConfig(arch_id=conf["name"], attn=AttnConfig(**attn),
                       moe=MoEConfig(**moe) if moe else None,
                       retro=RetroConfig(**conf["wave_index"]),
                       source=conf["source"], **fields)
