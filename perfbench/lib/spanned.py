"""The program's spans, for the per-layer readers of a traced run.

The window runs with the engine's spans off, in a traced run as in any
other. A reader of spans calls ``call(run)``: after the window and before
the check, the same engine serves the window's first call again (the same
requests, the same batch) with its spans on (``ServeEngine.spans``), once
a run however many readers ask (kept as ``run.spanned``). The readers read
that call's ``ServeMetrics``, whose ``spans`` holds the call's spans
(``repro_torch.spans.Spans``: sums by name, self time). Where the program
records no spans (an engine without them) there is nothing to read and
every reader returns None."""
from perfbench.lib import bench


def call(run):
    """The metrics of the window's first call served again with spans on,
    or None where the program has no spans."""
    from repro_torch.serving.engine import ServeMetrics
    if "spans" not in ServeMetrics.__dataclass_fields__ \
            or run.engine is None or not run.calls:
        return None
    if getattr(run, "spanned", None) is None:
        n = len(run.requests) // len(run.calls)
        reqs = bench.make_requests([(r.prompt, r.max_new_tokens)
                                    for r in run.requests[:n]])
        run.engine.spans = True
        try:
            run.spanned = run.engine.serve(reqs, run.cell["batch"])
        finally:
            run.engine.spans = False
            bench.free(run.engine)
    return run.spanned


def prompt_tok_s(run, name: str, own: bool = False):
    """Prompt tokens admitted over the seconds (``own``: self seconds) of
    the spans named ``name``."""
    m = call(run)
    if m is None:
        return None
    s = m.spans.self_seconds(name) if own else m.spans.seconds(name)
    return m.prefill_tokens / s if s > 0 else None


def step_ms(run, name: str):
    """Milliseconds of the spans named ``name`` a decode step."""
    m = call(run)
    if m is None or not m.steps:
        return None
    return 1e3 * m.spans.seconds(name) / m.steps
