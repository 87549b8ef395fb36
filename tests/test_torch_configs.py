"""Port configs equal the JAX package's, field by field.

The port's dataclasses carry, after the reference's fields, port-only ones
(``configs/base.py``: the ring cache, QK norm and RoPE placement on
``AttnConfig``, the share layer on ``MoEConfig``, the norm placement and
leading dense layers on ``ModelConfig``), which the reference, a frozen
package, cannot have. So each parity check compares the reference's
fields (names, order, defaults, values, nested dataclasses too), and
holds every port-only field of a ported config at its default."""
import dataclasses

import pytest
import torch

from repro.configs import gemma2_2b as ref_gemma
from repro.configs import registry as ref_registry
from repro.configs.base import RetroConfig as RefRetro
from repro_torch.configs import gemma2_2b, registry
from repro_torch.configs.base import RetroConfig
from repro_torch.core import wave_index as port_wi
from repro_torch.core import zones as port_zones

torch.set_num_threads(2)


def _default(f: dataclasses.Field):
    return f.default_factory() if f.default is dataclasses.MISSING \
        else f.default


def _same_as_reference(port, ref):
    """``port`` holds ``ref``'s fields first, in order, with equal values
    (nested dataclasses compared alike), and every port-only field after
    them at its default."""
    pf, rf = dataclasses.fields(port), dataclasses.fields(ref)
    assert [f.name for f in pf[:len(rf)]] == [f.name for f in rf]
    for f in pf[len(rf):]:
        assert getattr(port, f.name) == _default(f), f.name
    for f in rf:
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same_as_reference(a, b)
        else:
            assert a == b, f.name


def _same_defaults(port_cls, ref_cls):
    """The reference's fields, in order, with its defaults, first."""
    pf, rf = dataclasses.fields(port_cls), dataclasses.fields(ref_cls)
    assert [(f.name, f.default) for f in pf[:len(rf)]] == \
        [(f.name, f.default) for f in rf]


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_gemma2_2b_fields_match(which):
    port = gemma2_2b.CONFIG if which == "CONFIG" else gemma2_2b.reduced()
    ref = ref_gemma.CONFIG if which == "CONFIG" else ref_gemma.reduced()
    _same_as_reference(port, ref)
    assert port.layer_kinds() == ref.layer_kinds()


def test_registry_lookups():
    _same_as_reference(registry.SMOKE_RETRO, ref_registry.SMOKE_RETRO)
    assert registry.get_config("gemma2-2b") == gemma2_2b.CONFIG
    assert registry.reduced_config("gemma2_2b") == gemma2_2b.reduced()


@pytest.mark.parametrize("seq_len", [24, 100, 640, 9000, 16384, 70000])
def test_zone_plan_and_layout_match(seq_len):
    from repro.core import wave_index as ref_wi
    from repro.core import zones as ref_zones
    for port_r, ref_r in ((RetroConfig(), RefRetro()),
                          (registry.SMOKE_RETRO, ref_registry.SMOKE_RETRO)):
        assert port_wi.prefill_layout(seq_len, port_r) == \
            ref_wi.prefill_layout(seq_len, ref_r)
        assert port_wi.max_clusters(seq_len, port_r, 1024) == \
            ref_wi.max_clusters(seq_len, ref_r, 1024)
        assert port_wi.local_buffer_size(port_r) == \
            ref_wi.local_buffer_size(ref_r)
        assert tuple(port_zones.plan_zones(seq_len, port_r, 512)) == \
            tuple(ref_zones.plan_zones(seq_len, ref_r, 512))


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
@pytest.mark.parametrize("arch", ["gemma2_9b", "gemma3_1b", "minitron_8b",
                                  "mixtral_8x22b", "kimi_k2_1t_a32b",
                                  "llava_next_34b"])
def test_dense_config_fields_match(arch, which):
    """The other three ``family="dense"`` configs and the moe (mixtral,
    kimi) and vlm (llava) ones, published and reduced, field-equal to the
    reference's, under both their names."""
    port = registry.get_config(arch) if which == "CONFIG" \
        else registry.reduced_config(arch)
    ref = ref_registry.get_config(arch) if which == "CONFIG" \
        else ref_registry.reduced_config(arch)
    _same_as_reference(port, ref)
    assert port.layer_kinds() == ref.layer_kinds()
    alias = arch.replace("_", "-")
    assert registry.ALIASES[alias] == arch
    assert (registry.get_config(alias) if which == "CONFIG"
            else registry.reduced_config(alias)) == port


def test_moe_config_fields_match():
    """``MoEConfig``: the reference's fields, in order, with its
    defaults (and ``AttnConfig``'s, ``ModelConfig``'s likewise); the
    port-only ones after them default to the reference's layer."""
    from repro.configs.base import AttnConfig as RefAttn
    from repro.configs.base import ModelConfig as RefModel
    from repro.configs.base import MoEConfig as RefMoE
    from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig
    _same_defaults(MoEConfig, RefMoE)
    _same_defaults(AttnConfig, RefAttn)
    _same_defaults(ModelConfig, RefModel)
    _same_as_reference(MoEConfig(8, 2, 16384), RefMoE(8, 2, 16384))
    assert MoEConfig(8, 2, 16384).routed == 8


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_3b", "whisper_tiny"])
def test_non_attention_config_fields_match(arch, which):
    """The hybrid (zamba2), ssm (rwkv6) and audio (whisper) configs,
    published and reduced, field-equal to the reference's (``ssm`` an
    ``SSMConfig`` with the reference's fields), under both their names."""
    port = registry.get_config(arch) if which == "CONFIG" \
        else registry.reduced_config(arch)
    ref = ref_registry.get_config(arch) if which == "CONFIG" \
        else ref_registry.reduced_config(arch)
    _same_as_reference(port, ref)
    assert port.layer_kinds() == ref.layer_kinds()
    alias = {"zamba2_1p2b": "zamba2-1.2b", "rwkv6_3b": "rwkv6-3b",
             "whisper_tiny": "whisper-tiny"}[arch]
    assert registry.ALIASES[alias] == arch
    assert (registry.get_config(alias) if which == "CONFIG"
            else registry.reduced_config(alias)) == port


def test_ssm_config_fields_match():
    from repro.configs.base import SSMConfig as RefSSM
    from repro_torch.configs.base import SSMConfig
    assert [(f.name, f.default) for f in dataclasses.fields(SSMConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(RefSSM)]
    _same_defaults(SSMConfig, RefSSM)

