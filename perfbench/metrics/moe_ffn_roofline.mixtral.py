"""The MoE FFN's share of its roofline at the cell's decode batch, in
percent. After the window, the port's MoE FFN of layer 0 runs on the
batch's worth of seeded unit-RMS hidden states, timed with CUDA events
over 20 calls after a warm-up; the least time is the bytes of the experts
these tokens route to (their router's top-k, worked out here), the router
and the activations, over HBM bandwidth. Layer: MoE FFN."""
import torch

from perfbench.roofline import bounds

REPS = 20


def read(run):
    from repro_torch.models.moe import moe_apply
    if run.cfg.moe is None or getattr(run.device, "type", run.device) != "cuda":
        return None
    lp = run.weights["layers"][0]["moe"]
    B, D = run.cell["batch"], run.cfg.d_model
    gen = torch.Generator(device=run.device).manual_seed(run.seed % 2**64)
    x = torch.randn((B, D), generator=gen, device=run.device) \
        .to(lp["w_up"].dtype)
    top = torch.topk(torch.softmax(x.float() @ lp["router"].float(), -1),
                     run.cfg.moe.top_k, dim=-1).indices
    used = int(torch.unique(top).numel())
    with torch.inference_mode():
        for _ in range(3):
            moe_apply(lp, x, run.cfg.moe, run.cfg.act)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            moe_apply(lp, x, run.cfg.moe, run.cfg.act)
        b.record()
        b.synchronize()
    sec = a.elapsed_time(b) / 1e3 / REPS
    nbytes = bounds.moe_bytes(used, run.cfg.moe.num_experts, D,
                              run.cfg.moe.d_expert, B)
    return 100.0 * bounds.bound(nbytes, 0)[0] / sec
