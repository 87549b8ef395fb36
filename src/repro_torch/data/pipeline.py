"""Synthetic data pipeline (no external datasets).

Port of ``repro/data/pipeline.py``: numpy only, so a seed gives the
reference's arrays bit for bit. The trainer moves a batch to its device.

Two generators:

* ``lm_batches`` — Zipf-distributed token streams with local Markov structure
  (so losses are learnable, not pure noise) for the training substrate.
* ``needle_prompt`` — RULER/NIAH-style structured prompts: a long "haystack"
  with key-value "needles" planted at controlled depths. Used by the accuracy
  benchmarks to reproduce the paper's retrieval-quality experiments, since the
  retrieval difficulty (scattered important tokens) matches Fig. 3.

Deterministic given seed. Batches are dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


def _zipf_markov(rng: np.random.Generator, n: int, vocab: int,
                 alpha: float = 1.2, repeat_p: float = 0.3) -> np.ndarray:
    """Zipfian unigram with a copy-previous channel => learnable structure."""
    ranks = np.arange(1, vocab + 1)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    base = rng.choice(vocab, size=n, p=probs)
    copy = rng.random(n) < repeat_p
    out = base.copy()
    for i in range(1, n):
        if copy[i]:
            out[i] = out[i - 1]
    return out.astype(np.int32)


def lm_batches(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               frontend_dim: Optional[int] = None) -> Iterator[Dict]:
    """Infinite iterator of {tokens, targets, [patch_embeds|frames]}."""
    rng = np.random.default_rng(seed)
    while True:
        toks = np.stack([_zipf_markov(rng, seq + 1, cfg.vocab)
                         for _ in range(batch)])
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (batch, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        yield out


def shard_batch(batch: Dict, n_hosts: int, host_id: int) -> Dict:
    """Static per-host slicing of the global batch (data-parallel input)."""
    def sl(a):
        per = a.shape[0] // n_hosts
        return a[host_id * per:(host_id + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# structured retrieval workloads (accuracy benchmarks)
# ---------------------------------------------------------------------------

def needle_prompt(vocab: int, seq: int, n_needles: int, seed: int = 0,
                  needle_span: int = 8) -> Tuple[np.ndarray, List[int]]:
    """A haystack of filler tokens with ``n_needles`` rare-token spans planted
    at scattered depths. Returns (tokens (seq,), needle_positions)."""
    rng = np.random.default_rng(seed)
    filler_vocab = max(16, vocab // 4)
    toks = rng.integers(0, filler_vocab, size=seq)
    needle_tok = vocab - 1 - np.arange(n_needles)         # rare ids
    positions = np.sort(rng.choice(
        np.arange(seq // 10, seq - seq // 10), size=n_needles, replace=False))
    for i, p in enumerate(positions):
        toks[p:p + needle_span] = needle_tok[i]
    return toks.astype(np.int32), positions.tolist()


def clustered_keys(n: int, hd: int, n_hot: int = 4, seed: int = 0,
                   noise: float = 0.25) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic post-RoPE-like key field with planted 'important' directions.

    Returns (keys (n, hd), query (hd,), hot_mask (n,)). ``n_hot`` scattered
    stretches of keys are aligned with the query (high inner product) — the
    dynamic-sparsity structure of paper Fig. 3 — the rest is segment-locally
    correlated background (the RoPE spatial locality of Sec. 4.2).
    """
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(hd)
    q /= np.linalg.norm(q)
    scale = np.sqrt(hd)                 # realistic key norms (~sqrt(d))
    seg = max(32, n // 64)
    keys = np.empty((n, hd), np.float32)
    for s in range(0, n, seg):
        center = rng.standard_normal(hd)
        center /= np.linalg.norm(center)
        e = min(n, s + seg)
        keys[s:e] = scale * (center + noise * rng.standard_normal((e - s, hd)))
    hot = np.zeros(n, bool)
    for p in rng.choice(n - 16, size=n_hot, replace=False):
        # hot spans score ~5 sigma above background after 1/sqrt(d) scaling
        keys[p:p + 16] = scale * (5.0 * q
                                  + noise * rng.standard_normal((16, hd)))
        hot[p:p + 16] = True
    return keys.astype(np.float32), q.astype(np.float32), hot


def assoc_recall_batch(rng: np.random.Generator, batch: int, n_pairs: int,
                       vocab: int, seq: Optional[int] = None,
                       query_of: Optional[int] = None):
    """Associative-recall (NIAH-style) task: ``k1 v1 k2 v2 ... kq -> vq``.

    Keys live in [2, vocab/2), values in [vocab/2, vocab). The prompt ends
    with a repeated query key; the target is its value. This is the miniature
    form of the paper's needle-retrieval evaluation — important tokens (the
    queried pair) are scattered at arbitrary depth.

    Returns (tokens (B, T), targets (B,)) with T = 2*n_pairs + 1 (padded to
    ``seq`` with filler token 1 in front if given).
    """
    lo_k, hi_k = 2, vocab // 2
    lo_v, hi_v = vocab // 2, vocab
    T = 2 * n_pairs + 1
    toks = np.ones((batch, seq or T), np.int32)
    targets = np.zeros((batch,), np.int32)
    for b in range(batch):
        keys = rng.choice(np.arange(lo_k, hi_k), size=n_pairs, replace=False)
        vals = rng.integers(lo_v, hi_v, size=n_pairs)
        qi = int(rng.integers(0, n_pairs)) if query_of is None else query_of
        body = np.empty(T, np.int32)
        body[0:2 * n_pairs:2] = keys
        body[1:2 * n_pairs:2] = vals
        body[-1] = keys[qi]
        toks[b, -T:] = body
        targets[b] = vals[qi]
    return toks, targets
