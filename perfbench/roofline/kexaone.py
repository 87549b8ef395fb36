"""The yardstick's arithmetic for K-EXAONE's stage (``configs/k-exaone-
236b-stage24.json``): the share layer's bytes, the layer kinds, and the
model FLOPs of a served token on this card, from the published sizes.

Frozen like ``bounds.py``, whose peaks, ``bound``, ``Plan`` and
``prefill_clusters`` it uses. What differs from ``bounds.py``'s counts:

* the expert layer is a share: the router scores ``published_num_experts``
  and each token takes ``num_experts_per_tok``, but only the experts held
  here (the file's ``num_experts``) run, beside the shared expert;
* a leading dense layer (``first_k_dense_replace``) runs the MLP of width
  ``intermediate_size``;
* sliding layers attend the last ``sliding_window`` positions exactly;
  global layers attend the whole prompt at admission and the wave index's
  zones when decoding.

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, Tuple

from perfbench.roofline.bounds import Plan, Retro, prefill_clusters


def kinds(pub: Dict) -> Tuple[int, int]:
    """(sliding layers, global layers) of the stage's layers."""
    types = pub["layer_types"][:pub["num_hidden_layers"]]
    n_sliding = sum(t == "sliding_attention" for t in types)
    return n_sliding, len(types) - n_sliding


def share_bytes(experts_used: int, pub: Dict, tokens: int,
                weight_bytes: int = 2, act_bytes: int = 2) -> float:
    """Bytes a share-layer call must move: the gate, up and down matrices
    of each held expert some token routes to and of the shared expert, the
    f32 router over all published experts and its f32 selection bias, and
    the tokens' activations in and out."""
    d, f = pub["hidden_size"], pub["moe_intermediate_size"]
    n_pub = pub["published_num_experts"]
    shared = pub["num_shared_experts"] * 3 * d * f * weight_bytes
    return (experts_used * 3 * d * f * weight_bytes + shared
            + (d + 1) * n_pub * 4 + tokens * 2 * d * act_bytes)


def matmul_params(pub: Dict) -> Tuple[float, int]:
    """(matmul parameters the card runs a token through, in expectation,
    parameters of the output head): the attention projections of every
    layer, the dense layers' MLP, and on each MoE layer the router, the
    shared expert and the held experts the token routes to (k of the
    published experts, a share held here of them)."""
    d, L = pub["hidden_size"], pub["num_hidden_layers"]
    hd, hq = pub["head_dim"], pub["num_attention_heads"]
    hkv = pub["num_key_value_heads"]
    n_dense = min(pub["first_k_dense_replace"], L)
    n_pub = pub["published_num_experts"]
    attn = d * (hq + 2 * hkv) * hd + hq * hd * d
    routed = pub["num_experts_per_tok"] * pub["num_experts"] / n_pub
    moe = (routed + pub["num_shared_experts"]) * 3 * d \
        * pub["moe_intermediate_size"] + d * n_pub
    return (L * attn + n_dense * 3 * d * pub["intermediate_size"]
            + (L - n_dense) * moe, d * pub["vocab_size"])


def served_flops(pub: Dict, prompt_len: int, n_out: int, plan: Plan,
                 retro: Retro) -> float:
    """Model FLOPs a served request needs on this card: every prompt
    token through the blocks with causal attention (windowed on sliding
    layers) and one head call; then each of the n_out - 1 decoded tokens
    through the blocks and the head, with a sliding layer's window and a
    global layer's zones (as ``bounds.served_flops`` counts them)."""
    blocks, head = matmul_params(pub)
    hd, hq = pub["head_dim"], pub["num_attention_heads"]
    w = pub["sliding_window"]
    n_sl, n_gl = kinds(pub)
    a = 4 * hq * hd                       # per attended (query, key) pair
    flops = 2 * blocks * prompt_len + 2 * head
    flops += n_gl * a * prompt_len * (prompt_len + 1) / 2
    full = max(0, prompt_len - w)          # queries that see a whole window
    flops += n_sl * a * (full * w + sum(min(t + 1, w)
                                        for t in range(prompt_len - full)))
    sink = min(retro.sink, prompt_len)
    staged = min(retro.local, max(prompt_len - retro.sink, 0))
    m_live = prefill_clusters(prompt_len, retro)
    for i in range(max(0, n_out - 1)):
        staged += 1
        r = min(plan.r, m_live)
        e = min(plan.e, m_live - r)
        n_tok = sink + staged + r * retro.avg_cluster
        zones = hq * hd * (2 * m_live + 4 * n_tok + 2 * (e + r))
        flops += 2 * blocks + 2 * head + n_gl * zones \
            + n_sl * a * min(prompt_len + i + 1, w)
        if staged >= retro.local + retro.update_segment:
            staged -= retro.update_segment
            m_live += retro.update_segment // retro.avg_cluster
    return flops
