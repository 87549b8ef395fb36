"""retrolint CLI of the port — the static + trace-time hot-path contract gate
of ``src/repro_torch`` (counterpart of ``repro/launch/lint.py``).

    python -m repro_torch.launch.lint                  # full gate
    python -m repro_torch.launch.lint --no-trace       # static passes only
    python -m repro_torch.launch.lint --explain RL201  # a rule and its fix
    python -m repro_torch.launch.lint --selftest       # every rule vs fixtures
    python -m repro_torch.launch.lint --write-baseline # suppress findings
    python -m repro_torch.launch.lint --json           # findings as JSON
    python -m repro_torch.launch.lint --json-out f.json  # also to a file
    python -m repro_torch.launch.lint --github         # ::error annotations

Exit status: 0 when no unsuppressed error-severity finding remains (advice
never gates), 1 otherwise, 2 on usage errors. Suppression layers (narrowest
wins): `# retrolint: sync(<reason>)` / `# retrolint: ignore(RLxxx: <reason>)`
pragmas on the flagged line, then the checked-in
``lint_baseline_torch.txt`` (never the reference's ``lint_baseline.txt``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

from repro_torch.analysis import ast_rules, kernel_check
from repro_torch.analysis.findings import (BASELINE_NAME, RULES, Finding,
                                           apply_baseline, explain_rule,
                                           load_baseline, write_baseline)


def _repo_root(start: str) -> str:
    d = os.path.abspath(start)
    while d != os.path.dirname(d):
        if os.path.isdir(os.path.join(d, "src", "repro_torch")):
            return d
        d = os.path.dirname(d)
    return os.path.abspath(start)


def _parse_geometry(spec: str) -> Dict[str, int]:
    geom: Dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, val = part.partition("=")
        try:
            geom[name.strip()] = int(val)
        except ValueError:
            raise SystemExit(f"bad --geometry entry {part!r} "
                             f"(want name=int,name=int,...)") from None
    return geom


def _finding_json(f: Finding) -> Dict:
    return {"rule": f.rule, "path": f.path, "line": f.line,
            "qualname": f.qualname, "message": f.message,
            "severity": f.severity, "fingerprint": f.fingerprint}


def _github_annotation(f: Finding) -> str:
    """One GitHub Actions workflow command per finding — surfaced inline on
    the PR diff by the runner. Newlines/percent must be URL-escaped per the
    workflow-command spec."""
    level = "error" if f.severity == "error" else "notice"
    msg = (f"({f.qualname}) {f.message}"
           .replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A"))
    title = f"retrolint {f.rule}"
    return (f"::{level} file={f.path},line={max(f.line, 1)},"
            f"title={title}::{msg}")


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="static + trace-time hot-path contract checks")
    ap.add_argument("--root", default=".",
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--explain", metavar="RULE",
                    help="print a rule's rationale and fix guidance")
    ap.add_argument("--selftest", action="store_true",
                    help="run every rule against its known-good/bad fixtures")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the trace passes (no serve runs: AST + "
                         "kernel passes only)")
    ap.add_argument("--baseline", default=None,
                    help="suppression baseline file "
                         f"(default: <root>/{BASELINE_NAME})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline to suppress current findings")
    ap.add_argument("--geometry", default="",
                    help="shared-memory estimate geometry overrides, "
                         "name=int,... (defaults: "
                         f"{kernel_check.GEOMETRY_DEFAULTS})")
    ap.add_argument("--smem-budget", type=int,
                    default=kernel_check.DEFAULT_SMEM_BUDGET,
                    help="shared memory per block in bytes for RL203 "
                         "(default: the H100's 227 KiB)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON object on stdout instead "
                         "of the human listing")
    ap.add_argument("--json-out", metavar="PATH", default=None,
                    help="additionally write the --json document to PATH "
                         "(the RL406 cast-site inventory among it)")
    ap.add_argument("--github", action="store_true",
                    help="additionally emit GitHub Actions ::error/::notice "
                         "workflow commands (inline PR annotations)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print findings, no progress")
    args = ap.parse_args(argv)

    if args.explain:
        text = explain_rule(args.explain.upper())
        if text is None:
            print(f"unknown rule {args.explain!r}; known: "
                  f"{', '.join(sorted(RULES))}", file=sys.stderr)
            return 2
        print(text)
        return 0

    log = (lambda *_: None) if args.quiet else \
        (lambda *m: print(*m, file=sys.stderr))

    if args.selftest:
        from repro_torch.analysis.selftest import run_selftests
        log("retrolint: running rule self-tests")
        fails = run_selftests()
        if args.as_json:
            print(json.dumps({"selftest_failures": fails,
                              "ok": not fails}, indent=2))
            return 1 if fails else 0
        for f in fails:
            print(f"SELFTEST FAIL: {f}")
        print(f"retrolint selftest: "
              f"{'FAILED' if fails else 'ok'} ({len(fails)} failures)")
        return 1 if fails else 0

    root = _repo_root(args.root)
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    geometry = _parse_geometry(args.geometry)
    findings: List[Finding] = []

    log(f"retrolint: AST pass over {root}/src/repro_torch")
    findings += ast_rules.lint_tree(root)
    log("retrolint: CUDA kernel pass")
    findings += kernel_check.check_tree(root, geometry=geometry,
                                        smem_budget=args.smem_budget)
    if not args.no_trace:
        from repro_torch.analysis.numerics_check import run_numerics_checks
        from repro_torch.analysis.stage_check import run_contract_checks
        findings += run_contract_checks(verbose=log)
        log("retrolint: retronum precision-flow pass (RL401-RL406)")
        findings += run_numerics_checks(verbose=log)

    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"baseline written: {baseline_path} "
              f"({sum(f.severity == 'error' for f in findings)} entries)")
        return 0

    visible = apply_baseline(findings, load_baseline(baseline_path))
    errors = [f for f in visible if f.severity == "error"]
    advice = [f for f in visible if f.severity != "error"]
    ordered = sorted(visible, key=lambda f: (f.path, f.line, f.rule))
    suppressed = len(findings) - len(visible)
    doc = {"findings": [_finding_json(f) for f in ordered],
           "errors": len(errors), "advice": len(advice),
           "baselined": suppressed, "ok": not errors}
    if args.as_json:
        print(json.dumps(doc, indent=2))
    else:
        for f in ordered:
            print(f.render())
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(doc, fh, indent=2)
            fh.write("\n")
        log(f"retrolint: JSON findings written to {args.json_out}")
    if args.github:
        for f in ordered:
            print(_github_annotation(f))
    log(f"retrolint: {len(errors)} error(s), {len(advice)} advice, "
        f"{suppressed} baselined")
    if errors:
        log("retrolint: FAILED — `--explain <rule>` explains a finding; "
            "a pragma or the baseline suppresses a sanctioned one")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
