"""Share of the expert share's decode rows that carry a routed token, in
percent: token-expert pairs routed to the experts held here over the rows
their fixed-capacity buffers computed, over the window's decode steps
(``ServeMetrics.moe_rows_routed`` / ``moe_rows_computed``, counted on the
card inside the captured step). Where the program has no such counters it
reads nothing. Layer: MoE FFN."""


def read(run):
    computed = sum(getattr(m, "moe_rows_computed", 0) for m in run.calls)
    if not computed:
        return None
    return 100.0 * sum(m.moe_rows_routed for m in run.calls) / computed
