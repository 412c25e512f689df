"""The benchmark's arithmetic against counts by hand and against the
smoke test's byte count."""

import json

import numpy as np
import pytest
import torch

from bench import harness, yardstick

CONFIGS = harness.BENCH / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_femnist_flops_by_hand():
    cfg = _cfg("femnist_cnn")
    by_hand = {
        "c1": 2 * 5 * 5 * 1 * 32 * 28 * 28,       # 1,254,400
        "c2": 2 * 5 * 5 * 32 * 64 * 14 * 14,      # 20,070,400
        "fc1": 2 * (7 * 7 * 64) * 384,            # 2,408,448
        "fc2": 2 * 384 * 62,                      # 47,616
    }
    got = {x["name"]: yardstick.layer_flops(x)
           for x in cfg["flops"]["layers"]}
    assert got == by_hand
    fwd = sum(by_hand.values())
    assert yardstick.train_flops_per_sample(cfg) == 3 * fwd - by_hand["c1"]
    assert yardstick.train_flops_per_sample(cfg) == 70_088_192
    assert yardstick.round_flops(cfg, 87) == 70_088_192 * 32 * 87


def test_resnet_flops_by_hand():
    cfg = _cfg("inat_resnet")
    by_hand = {"stem": 2 * 9 * 3 * 64 * 32 * 32}
    cin, hw = 64, 32
    for si, (cout, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                         (512, 2)]):
        for bi in range(2):
            s = stride if bi == 0 else 1
            hw //= s
            by_hand[f"s{si}b{bi}.c1"] = 2 * 9 * cin * cout * hw * hw
            by_hand[f"s{si}b{bi}.c2"] = 2 * 9 * cout * cout * hw * hw
            if s != 1 or cin != cout:
                by_hand[f"s{si}b{bi}.proj"] = 2 * cin * cout * hw * hw
            cin = cout
    by_hand["fc"] = 2 * 512 * 1010
    got = {x["name"]: yardstick.layer_flops(x)
           for x in cfg["flops"]["layers"]}
    assert got == by_hand
    assert yardstick.train_flops_per_sample(cfg) == \
        3 * sum(by_hand.values()) - by_hand["stem"]
    assert yardstick.train_flops_per_sample(cfg) == 3_332_069_376


@pytest.mark.parametrize("name", ["femnist_cnn", "inat_resnet"])
def test_param_counts(name):
    from repro_torch.models.small import SMALL_MODELS, param_count
    cfg = _cfg(name)
    assert yardstick.param_count(cfg) == cfg["params"]
    assert param_count(SMALL_MODELS[name].init(torch.Generator())) == \
        cfg["params"]


@pytest.mark.parametrize("n,e,t", [
    (11, 22, 1_280_478), (87, 174, 1_280_478), (11, 22, 11_685_170),
    (11, 22, 4_099), (4, 0, 64)])
def test_fused_work_matches_the_smoke(n, e, t):
    """On a segment as the flat runtime builds it (sources and a strong
    mask, the fresh rows w's own, no edge rows)."""
    import chip_smoke
    from repro_torch.kernels.gossip_combine.ref import Segment

    rng = np.random.default_rng(n + e)
    # a thin stand-in of each tensor: the count reads shapes, the row
    # pointer and the strong mask
    w = torch.zeros(()).expand(n, t)
    buf = torch.zeros(()).expand(e, t)
    dst = np.sort(rng.integers(0, n, e))
    row_ptr = torch.as_tensor(np.searchsorted(dst, np.arange(n + 1)),
                              dtype=torch.int32)
    seg = Segment(w, buf, torch.zeros(e), row_ptr, torch.zeros(n),
                  src=torch.zeros(e, dtype=torch.int32),
                  strong=torch.as_tensor(rng.random(e) < 0.6))
    assert yardstick.fused_work(n, e, t) == chip_smoke._fused_work([seg])


def test_card_peaks():
    row = yardstick.card_peaks("NVIDIA H100 80GB HBM3")
    assert row["hbm_bytes_per_s"] == 3.35e12 and row["fp32_flops"] == 67e12
    assert yardstick.card_peaks("NVIDIA H100 PCIe")["fp32_flops"] == 51e12
    with pytest.raises(KeyError):
        yardstick.card_peaks("NVIDIA A100")
