"""The port's model configs (`repro_torch.configs`, `models/config.py`)
against the reference's: every arch id resolves to the same fields,
reduces to the same smoke variant, and counts the same parameters."""

import dataclasses

import pytest

pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402


def test_registry_is_the_same():
    assert pconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert pconfigs.ALIASES == rconfigs.ALIASES
    for alias, arch in pconfigs.ALIASES.items():
        assert pconfigs.get_config(alias).name == \
            pconfigs.get_config(arch).name
    with pytest.raises(KeyError):
        pconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_config_fields_reduce_and_counts(arch):
    r, p = rconfigs.get_config(arch), pconfigs.get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for name in ("q_dim", "kv_dim", "ssm_inner", "ssm_heads",
                 "uses_attention", "uses_ssm", "uses_moe",
                 "supports_long_decode"):
        assert getattr(p, name) == getattr(r, name), name
    assert p.param_count() == r.param_count()
    assert p.active_param_count() == r.active_param_count()
    rr, pr = rconfigs.reduce(r), pconfigs.reduce(p)
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert pr.param_count() == rr.param_count()
    assert pr.active_param_count() == rr.active_param_count()
    pr.validate()


def test_yi_9b_size():
    cfg = pconfigs.get_config("yi-9b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (48, 4096, 32, 4, 128, 11008, 64000)
    assert cfg.param_count() == 8_829_407_232
