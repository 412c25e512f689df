"""The port's `--set key=value` and JSON machinery
(`repro_torch.config_cli`) on the port's `FLConfig` and `ModelConfig`,
mirroring `tests/test_config_cli.py` and held against `repro.config_cli`
on the same inputs: equal values, equal JSON text, equal errors. One
difference is deliberate: the reference cannot coerce a field annotated
``X | None`` (FLConfig's ``trace``, ``multiplicity``, ``ckpt_dir``); the
port can.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

from repro import config_cli as rcli  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.fl.trainer import FLConfig as RConfig  # noqa: E402
from repro.models.config import ModelConfig as RModel  # noqa: E402

from repro_torch import config_cli as pcli  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.fl import FLConfig as PConfig  # noqa: E402
from repro_torch.models.config import ModelConfig as PModel  # noqa: E402


def _both(fn_p, fn_r):
    """(port result or error message, reference result or message)."""
    out = []
    for fn in (fn_p, fn_r):
        try:
            out.append(("ok", fn()))
        except Exception as e:  # noqa: BLE001
            out.append((type(e).__name__, str(e)))
    return out


FL_OVERRIDES = [["lr=0.1", "rounds=7", "topology=ring", "t=3"],
                ["momentum=0.9", "seed=4", "alpha=0.25", "gossip=ring"],
                ["nope=1"], ["oops"], ["rounds=x"], ["lr=1e-3 "]]


@pytest.mark.parametrize("overrides", FL_OVERRIDES)
def test_fl_overrides_equal(overrides):
    p, r = _both(lambda: pcli.apply_overrides(PConfig(), overrides),
                 lambda: rcli.apply_overrides(RConfig(), overrides))
    if p[0] == "ok":
        assert r[0] == "ok"
        assert pcli.to_json(p[1]) == rcli.to_json(r[1])
    else:
        assert p[0] in ("OverrideError", "ValueError") and p == r


MODEL_OVERRIDES = [["num_layers=2", "mlp_act=gelu"], ["mlp_act=tanh"],
                   ["qkv_bias=true", "tie_embeddings=0"],
                   ["qkv_bias=maybe"], ["frontend=vision"]]


@pytest.mark.parametrize("overrides", MODEL_OVERRIDES)
@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-1b-a400m"])
def test_model_overrides_equal(arch, overrides):
    p, r = _both(lambda: pcli.apply_overrides(pget_config(arch), overrides),
                 lambda: rcli.apply_overrides(rget_config(arch), overrides))
    if p[0] == "ok":
        assert r[0] == "ok"
        assert dataclasses.asdict(p[1]) == dataclasses.asdict(r[1])
        assert pcli.to_json(p[1]) == rcli.to_json(r[1])
    else:
        assert p == r


def test_override_basic_types():
    cfg = pcli.apply_overrides(PConfig(), ["lr=0.1", "rounds=7",
                                           "topology=ring", "t=3"])
    assert cfg.lr == 0.1 and cfg.rounds == 7
    assert cfg.topology == "ring" and cfg.t == 3
    with pytest.raises(pcli.OverrideError, match="unknown field"):
        pcli.apply_overrides(PConfig(), ["nope=1"])
    with pytest.raises(pcli.OverrideError, match="key=value"):
        pcli.apply_overrides(PConfig(), ["oops"])
    with pytest.raises(pcli.OverrideError, match="not a dataclass"):
        pcli.apply_overrides({"lr": 1}, ["lr=2"])


def test_optional_fields_coerce():
    """``X | None`` fields, which the reference refuses."""
    cfg = pcli.apply_overrides(PConfig(), ["trace=run.json",
                                           "multiplicity=1,2,3",
                                           "ckpt_dir=ckpt"])
    assert cfg.trace == "run.json" and cfg.ckpt_dir == "ckpt"
    assert cfg.multiplicity == (1, 2, 3)
    with pytest.raises(rcli.OverrideError, match="cannot coerce"):
        rcli.apply_overrides(RConfig(), ["trace=run.json"])


def test_json_round_trips(tmp_path):
    """save/load of the port's configs: the files are the reference's
    bytes, and each package loads the other's file to an equal config."""
    for cfg, rcfg, cls, rcls in (
            (pcli.apply_overrides(pget_config("granite-moe-1b-a400m"),
                                  ["num_layers=3"]),
             rcli.apply_overrides(rget_config("granite-moe-1b-a400m"),
                                  ["num_layers=3"]), PModel, RModel),
            (PConfig(topology="multigraph", t=8, lr=0.02),
             RConfig(topology="multigraph", t=8, lr=0.02), PConfig,
             RConfig)):
        p, r = tmp_path / "p.json", tmp_path / "r.json"
        pcli.save(cfg, p)
        rcli.save(rcfg, r)
        assert p.read_bytes() == r.read_bytes()
        assert pcli.load(cls, p) == cfg
        assert pcli.load(cls, r) == cfg
        assert dataclasses.asdict(rcli.load(rcls, p)) == \
            dataclasses.asdict(rcfg)
    # a tuple behind ``| None`` comes back a tuple (the reference's
    # `load` leaves it a list, so its config compares unequal)
    cfg = PConfig(multiplicity=(1, 2), trace="t.json")
    pcli.save(cfg, tmp_path / "m.json")
    assert pcli.load(PConfig, tmp_path / "m.json") == cfg
