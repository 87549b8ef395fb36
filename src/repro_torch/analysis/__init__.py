"""retrolint for the PyTorch/CUDA port: static and trace-time contract
checking of the serve hot path, the CUDA kernels and the captured stages.

Counterpart of ``repro/analysis``; the same 22 rules (RL001-RL406), each
checked against what its hazard is in PyTorch and CUDA on an H100:

* ``ast_rules``     — source lint of ``src/repro_torch`` (host syncs in
                      hot-path functions, tensor branches in captured
                      bodies, graphs built inside loops, aliases read across
                      an in-place stage);
* ``kernel_check``  — the CUDA sources and their launchers (mbarrier ring
                      discipline, launch-geometry purity, shared-memory
                      budget, 16-bit transcendentals, the cast inventory);
* ``stage_check``   — the ``SERVE_STAGES`` contract over two recorded serves
                      (syncs and host copies in stages, in-place updates,
                      graph builds and captures, missed in-place updates);
* ``schedule_check``— the happens-before model of the offload schedule;
* ``numerics_check``— the f32 numerics contract over the decode targets,
                      traced on fake CUDA tensors.

Run all of it with ``python -m repro_torch.launch.lint`` (``--help``,
``--explain <rule>``); ``README.md`` beside this file documents the rules.
"""
from repro_torch.analysis.findings import (RULES, Finding, explain_rule,
                                           load_baseline, write_baseline)

__all__ = ["Finding", "RULES", "explain_rule", "load_baseline",
           "write_baseline"]
