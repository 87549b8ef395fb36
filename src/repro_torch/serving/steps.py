"""The step functions of the launcher and the dry-run. Port of
``repro/serving/steps.py``. The shapes of the assigned suite:

  * train_4k    -> train_step(state, batch) -> (state, metrics)
  * prefill_32k -> prefill_step(params, batch) -> (logits, state)
                   (builds the wave index)
  * decode_32k / long_500k -> serve_step(params, state, token, active=None)
                   -> (logits, state)  (one new token)

The decode attention impl is the config's (``cfg.retro.attn_impl``), as in
the reference. Every step updates its state in place (where JAX donates).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.zones import plan_zones
from repro_torch.models import model as M
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import make_train_step


def _plan(cfg: ModelConfig, seq_len: int, gen_headroom: int):
    return plan_zones(seq_len, cfg.retro, gen_headroom) \
        if cfg.family != "ssm" else None


def make_prefill_step(cfg: ModelConfig, seq_len: int, *,
                      runtime: str = "retro",
                      gen_headroom: int = 4096) -> Callable:
    plan = _plan(cfg, seq_len, gen_headroom)

    def prefill_step(params, batch):
        return M.apply_prefill(params, cfg, batch, runtime=runtime, plan=plan,
                               gen_headroom=gen_headroom)

    return prefill_step


def make_serve_step(cfg: ModelConfig, seq_len: int, *, runtime: str = "retro",
                    gen_headroom: int = 4096) -> Callable:
    plan = _plan(cfg, seq_len, gen_headroom)

    def serve_step(params, state, token, active=None):
        """``active``: optional (B,) bool continuous-batching slot mask —
        free slots skip their KV append so per-row counters never drift."""
        return M.apply_decode(params, cfg, state, token, runtime=runtime,
                              plan=plan, seq_len=seq_len,
                              gen_headroom=gen_headroom, active=active)

    return serve_step


def make_serve_step_split(cfg: ModelConfig, seq_len: int, *,
                          gen_headroom: int = 4096, group=None) -> Callable:
    """Hot/cold-split retro decode (the attention families):
    ``serve_step(params, cold, hot, token) -> (logits, hot)``, cold and hot
    from ``transformer.split_state``. ``group``: a process group over which
    the cold cluster axis is sharded (sharded retrieval; the reference's
    ``mesh``); it runs the "jnp" attention path, so a config whose
    ``attn_impl`` is another raises here. The reference's ``unroll`` has no
    counterpart: the port's layer loop is always unrolled."""
    from repro_torch.core.attention import resolve_attn_impl
    from repro_torch.models import transformer
    if cfg.family not in M.ATTN_FAMILIES:
        raise ValueError(f"the split decode step needs an attention family "
                         f"{M.ATTN_FAMILIES}, not {cfg.family!r}")
    if group is not None:
        transformer.check_group_impl("retro",
                                     resolve_attn_impl(cfg.retro.attn_impl))
    plan = plan_zones(seq_len, cfg.retro, gen_headroom)

    def serve_step(params, cold, hot, token):
        return transformer.decode_step_split(params, cfg, cold, hot, token,
                                             plan=plan, group=group)

    return serve_step


def make_step(cfg: ModelConfig, shape: InputShape, *, runtime: str = "retro",
              opt_cfg: Optional[AdamWConfig] = None,
              gen_headroom: int = 4096) -> Callable:
    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg or AdamWConfig())
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape.seq_len, runtime=runtime,
                                 gen_headroom=gen_headroom)
    return make_serve_step(cfg, shape.seq_len, runtime=runtime,
                           gen_headroom=gen_headroom)
