"""Every family through the sharded program's dry run: each architecture's
reduced config in bf16, prefill and decode at batch 8 on the (2, 2) debug
mesh, and for one architecture of each family decode at batch 1 too
(whose cache layout puts the sequence over "data"), and the prefix
families' prefill on (2, 2, 2), where the batch is split over ("pod",
"data"), each as rank 0 of a fake world: the step runs (status ok) and
its collectives are counted."""

import dataclasses

import pytest

from repro_torch.configs import ARCH_IDS, get_config, reduce
from repro_torch.launch import dryrun
from repro_torch.launch.specs import InputShape
from _torch_fl_parity import one_thread  # noqa: F401

SHAPES = {"prefill": InputShape("prefill", "prefill", 64, 8),
          "decode": InputShape("decode", "decode", 64, 8),
          "decode_b1": InputShape("decode_b1", "decode", 64, 1)}


def _cfg(arch):
    return dataclasses.replace(reduce(get_config(arch)), dtype="bfloat16")


def _check(rep, mesh_shape):
    assert rep["status"] == "ok", rep.get("error")
    assert rep["mesh_shape"] == mesh_shape
    assert rep["collectives"]["total_bytes"] > 0
    assert rep["memory"]["argument_bytes"] > 0


#: one architecture of each family also decodes a batch of 1
B1_ARCHS = ("yi_9b", "gemma3_27b", "granite_moe_1b", "paligemma_3b",
            "mamba2_370m", "zamba2_1p2b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_runs_sharded(arch):
    for name, shape in SHAPES.items():
        if name == "decode_b1" and arch not in B1_ARCHS:
            continue
        _check(dryrun.dry_pair(_cfg(arch), shape, "h100x256", debug=True),
               [2, 2])


@pytest.mark.parametrize("arch", ["paligemma_3b", "musicgen_large"])
def test_prefill_over_pods(arch):
    _check(dryrun.dry_pair(_cfg(arch), SHAPES["prefill"], "h100x512",
                           debug=True), [2, 2, 2])
