"""The expert share's decode FFN at its share of the roofline, at the
cell's decode batch, in percent. After the window, the program's share
layer of the first MoE layer runs as the captured decode step runs it
(``share_apply(..., step=True)``, captured once in a CUDA graph) on
``BATCHES`` batches of unit-RMS hidden states, each the cell's decode
batch, drawn from a generator of fixed seed (the same inputs on every run)
into the graph's input, timed with CUDA events over ``REPS`` replays a
batch. (Eager calls at B 16 are paced by the host's launches, which swing
from run to run.) The least time of a batch is the bytes of the
held experts its tokens route to (their router's top-k with its bias,
worked out here), the shared expert, the router and the activations, over
HBM bandwidth (``roofline/kexaone.py::share_bytes``); the reading is the
batches' least times over their measured times, so how many held experts
one batch happens to reach moves it little. Where the program has no
share layer it reads nothing. Layer: MoE FFN."""
import torch

from perfbench.roofline import bounds, kexaone

REPS = 20
BATCHES = 16
SEED = 20260101


def read(run):
    try:
        from repro_torch.models.moe import share_apply
    except ImportError:
        return None
    if run.cfg.moe is None or getattr(run.device, "type", run.device) != "cuda":
        return None
    lp = next(lp["moe"] for lp in run.weights["layers"] if "moe" in lp)
    B, D = run.cell["batch"], run.cfg.d_model
    pub = run.conf
    lo = pub["first_held_expert"]
    gen = torch.Generator(device=run.device).manual_seed(SEED)
    x = torch.zeros((B, D), device=run.device, dtype=lp["w_up"].dtype)
    least = sec = 0.0
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                share_apply(lp, x, run.cfg.moe, run.cfg.act, step=True)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            share_apply(lp, x, run.cfg.moe, run.cfg.act, step=True)
        for _ in range(BATCHES):
            x.copy_(torch.randn((B, D), generator=gen, device=run.device))
            sel = torch.sigmoid(x.float() @ lp["router"].float()) \
                + lp["router_bias"].float()
            top = torch.topk(sel, pub["num_experts_per_tok"], dim=-1).indices
            held = top[(top >= lo) & (top < lo + pub["num_experts"])]
            used = int(torch.unique(held).numel())
            least += bounds.bound(kexaone.share_bytes(used, pub, B), 0)[0]
            graph.replay()
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(REPS):
                graph.replay()
            b.record()
            b.synchronize()
            sec += a.elapsed_time(b) / 1e3 / REPS
    return 100.0 * least / sec
