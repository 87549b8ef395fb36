"""The yardstick's arithmetic: the H100's peaks, the least time of a piece of
work, the wave-attention call's bytes and operations from the zone plan,
the MoE FFN's bytes, and the model FLOPs of a served token.

Frozen copies, so that a change to the program cannot move the yardstick:

* ``bound`` and ``paged_call_terms`` follow ``chip_smoke.py::bound`` and
  ``chip_smoke.py::kernel_bound`` (the repository's chip smoke script). The
  smoke script counts from a call's tensors; here the same terms are counted
  from the zone plan, so the bound is what the algorithm needs at a given
  context, whatever implements it.
* ``zone_plan`` follows ``repro_torch/core/zones.py::plan_zones`` with
  ``repro_torch/core/wave_index.py::prefill_layout`` / ``max_clusters``.
* ``moe_bytes`` follows the bound of ``chip_smoke.py::moe_ffn_step``
  (expert weights over HBM bandwidth), counting only the experts that the
  routed tokens use, plus the activations read and written.

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

# NVIDIA H100 SXM data sheet (dense rates, 700 W).
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS
          ) -> Tuple[float, str]:
    """(least seconds on an H100, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Retro(NamedTuple):
    """RetroInfer's zone budgets (the program's RetroConfig defaults)."""
    avg_cluster: int = 16
    cluster_cap: int = 32
    prefill_segment: int = 8192
    update_segment: int = 1024
    sink: int = 4
    local: int = 64
    retrieval_frac: float = 0.018
    estimation_frac: float = 0.232


def retro_of(wave_index: Dict) -> Retro:
    """The budgets of a configuration file's ``wave_index``."""
    return Retro(**{k: wave_index[k] for k in Retro._fields})


class Plan(NamedTuple):
    m_max: int          # cluster-store size
    r: int              # retrieval-zone clusters
    e: int              # estimation-zone clusters
    sink: int
    local_buf: int      # staging buffer (local window + update segment)


def prefill_clusters(seq_len: int, retro: Retro = Retro()) -> int:
    """Clusters the prefill of a ``seq_len`` prompt makes: segments of the
    region between the sink and the local window."""
    region = max(0, seq_len - retro.sink - retro.local)
    n_full = region // retro.prefill_segment
    tail = region - n_full * retro.prefill_segment
    m = n_full * (retro.prefill_segment // retro.avg_cluster)
    if tail > 0:
        m += max(1, tail // retro.avg_cluster)
    return m


def zone_plan(max_ctx: int, gen_headroom: int, retro: Retro = Retro()
              ) -> Plan:
    m_prefill = prefill_clusters(max_ctx, retro)
    m = m_prefill + (gen_headroom // retro.update_segment) * (
        retro.update_segment // retro.avg_cluster)
    m_max = max(256, -(-m // 256) * 256)
    n = max(1, max_ctx // retro.avg_cluster)
    r = min(max(1, round(n * retro.retrieval_frac)), m_prefill)
    e = min(max(1, round(n * retro.estimation_frac)), max(0, m_prefill - r))
    return Plan(m_max, r, e, retro.sink, retro.local + retro.update_segment)


def paged_call_terms(rows: int, staged: int, n_kv: int, group: int, hd: int,
                     plan: Plan, retro: Retro = Retro(), store_bytes: int = 2
                     ) -> Tuple[float, float]:
    """(bytes, f32 operations) of wave-attention calls over ``rows``
    decoding rows that attend ``staged`` staging-buffer tokens between
    them (the local window and the tokens generated since the last flush,
    as each row holds them at its step). Per (row, KV head): the sink and
    the r retrieved clusters at their mean size, K and V once each, the
    member positions of the retrieved clusters, the ids, liveness and row
    bounds, q, the estimation zone's logits, scores and value sums (e + r
    entries: the overflow correction adds one per retrieved cluster), the
    output; per staged token and KV head its K, V and position.
    Operations: 4 G hd per attended token, 2 G hd per estimation entry."""
    n_tok = plan.sink + plan.r * retro.avg_cluster
    E = plan.e + plan.r
    per_row = (n_tok * 2 * hd * store_bytes
               + plan.r * retro.cluster_cap * 4
               + (2 * plan.r + 2) * 4
               + group * hd * 4
               + 2 * group * E * 4
               + E * hd * 4
               + group * hd * 4)
    per_staged = 2 * hd * store_bytes + 4
    flops_row = n_tok * 4 * group * hd + group * E * 2 * hd
    nbytes = rows * per_row + staged * per_staged
    flops = rows * flops_row + staged * 4 * group * hd
    return n_kv * nbytes, n_kv * flops


def moe_bytes(experts_used: int, n_experts: int, d_model: int, d_expert: int,
              tokens: int, weight_bytes: int = 2, act_bytes: int = 2) -> float:
    """Bytes a MoE FFN call must move: the gate, up and down matrices of
    each expert that some token routes to, the f32 router, and the tokens'
    activations in and out."""
    weights = experts_used * 3 * d_model * d_expert * weight_bytes
    return weights + d_model * n_experts * 4 + tokens * 2 * d_model * act_bytes


def matmul_params(pub: Dict) -> Tuple[int, int]:
    """(active parameters of the transformer blocks a token runs through,
    parameters of the output head) from a published config: the attention
    projections, the gated MLP or the top-k experts and the router."""
    d, L = pub["hidden_size"], pub["num_hidden_layers"]
    hd = pub.get("head_dim") or d // pub["num_attention_heads"]
    hq, hkv = pub["num_attention_heads"], pub["num_key_value_heads"]
    attn = d * (hq + 2 * hkv) * hd + hq * hd * d
    if "num_local_experts" in pub:
        ffn = (pub["num_experts_per_tok"] * 3 * d * pub["intermediate_size"]
               + d * pub["num_local_experts"])
    else:
        ffn = 3 * d * pub["intermediate_size"]
    return L * (attn + ffn), d * pub["vocab_size"]


def served_flops(pub: Dict, prompt_len: int, n_out: int, plan: Plan,
                 retro: Retro = Retro()) -> float:
    """Model FLOPs a served request needs: every prompt token through the
    blocks with causal attention over the prompt and one head call; then
    each of the n_out - 1 decoded tokens through the blocks and the head,
    with the attention of its zones (ranking over the live clusters, the
    exact tokens of the sink, the staging buffer and the retrieval zone,
    the estimation entries)."""
    blocks, head = matmul_params(pub)
    d, L = pub["hidden_size"], pub["num_hidden_layers"]
    hq = pub["num_attention_heads"]
    hd = pub.get("head_dim") or d // hq
    flops = 2 * blocks * prompt_len + 2 * head
    flops += L * 4 * hq * hd * prompt_len * (prompt_len + 1) / 2
    # the engine's staging buffer: the local window after admission, one
    # token more a step (the decoded token attends itself), and a flush of
    # update_segment tokens into new clusters after the step that fills it
    sink = min(retro.sink, prompt_len)
    staged = min(retro.local, max(prompt_len - retro.sink, 0))
    m_live = prefill_clusters(prompt_len, retro)
    for _ in range(max(0, n_out - 1)):
        staged += 1
        r = min(plan.r, m_live)
        e = min(plan.e, m_live - r)
        n_tok = sink + staged + r * retro.avg_cluster
        attn = hq * hd * (2 * m_live + 4 * n_tok + 2 * (e + r))
        flops += 2 * blocks + 2 * head + L * attn
        if staged >= retro.local + retro.update_segment:
            staged -= retro.update_segment
            m_live += retro.update_segment // retro.avg_cluster
    return flops
