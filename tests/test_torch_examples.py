"""The port's host-side and training examples (`examples_torch/`) on the
CPU against the reference's (`examples/`): `topology_comparison`'s
stdout equal to the reference script's, string for string;
`quickstart`'s sections 1-5 equal to the lines the reference script
prints before its section 6 (whose `sum()` assertion fails under Python
>= 3.12, so its exit is not relied on), and its section 7 run to its
end; `fl_llm_finetune` at 4 rounds and 3 silos, its simulated columns
exactly what the reference's host timing code gives for the same
`TrainConfig`, its losses bit-equal to the port's
`run_reduced_fl(mesh=1, lora_rank=4)`. Every example raises without a
card unless it is given ``--device``.
"""

import dataclasses
import tempfile

import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_examples import load_port, run_reference  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401

EXAMPLES = ("topology_comparison", "quickstart", "serve_decode",
            "continuous_batching", "fl_llm_finetune")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_port(name).main([])


def test_topology_comparison_stdout_equals_reference(capsys, monkeypatch):
    load_port("topology_comparison").main(["--device", "cpu"])
    port = capsys.readouterr().out
    run_reference(monkeypatch, "topology_comparison")
    assert port == capsys.readouterr().out
    assert port.startswith("mean cycle time (ms) over 800 rounds")


class _Stop(Exception):
    pass


def test_quickstart_sections_1_to_5_equal_reference(capsys, monkeypatch,
                                                    tmp_path):
    from repro import obs as robs
    from repro.launch import train as rtrain
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = load_port("quickstart").main(["--device", "cpu"])
    port = capsys.readouterr().out
    # the reference writes its trace to /tmp itself: skip the write, and
    # stop it before its section 7 trains
    monkeypatch.setattr(robs, "write_trace", lambda path, rec: None)

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(rtrain, "run_reduced_fl", stop)
    with pytest.raises((AssertionError, _Stop)):
        run_reference(monkeypatch, "quickstart")
    ref = capsys.readouterr().out
    head, sep, _ = port.partition("\ntrace: ")
    assert sep and ref.startswith(head) and ref[len(head):].strip() == ""
    assert head.count("\n") >= 25
    # sections 6 and 7 ran to their ends
    assert (tmp_path / "quickstart_trace.json").is_file()
    assert res["trace_path"] == str(tmp_path / "quickstart_trace.json")
    assert len(res["train"]["losses"]) == 3
    assert list(res["fleet"].regions) == ["na", "eu", "asia"]
    s = res["serving"]
    assert s["arrived"] > 0 and s["completed"] == s["arrived"]
    assert port.rstrip().endswith(
        f"tokens/s={s['tokens_per_s']:.0f}")


FINETUNE = dict(rounds=4, silos=3, lora_rank=4, arch="mamba2-370m")


def _reference_sim(topology: str) -> dict:
    """The reference's simulated columns for the example's TrainConfig:
    its host timing code on the LoRA delta's flat row."""
    from repro import configs as rconfigs
    from repro.core.delay import FEMNIST
    from repro.core.simulator import simulate
    from repro.fl import lora as rlora
    from repro.launch import train as rtrain
    from repro.models import transformer as rtf
    from repro.networks.registry import get_network
    cfg = rtrain.TrainConfig(arch=FINETUNE["arch"], topology=topology,
                             silos=FINETUNE["silos"],
                             rounds=FINETUNE["rounds"], lr=5e-2,
                             mesh="auto", lora_rank=FINETUNE["lora_rank"])
    mcfg = rconfigs.reduce(rconfigs.get_config(cfg.arch))
    template = jax.eval_shape(lambda k: rtf.init_params(mcfg, k),
                              jax.random.PRNGKey(0))
    param_bytes = rlora.lora_size(template, cfg.lora_rank) * 4
    wl = dataclasses.replace(FEMNIST, name=cfg.arch,
                             model_size_mbits=param_bytes * 8 / 1e6)
    net = rtrain._sub_network(get_network(cfg.network), cfg.silos)
    sim = simulate(topology, net, wl, num_rounds=cfg.rounds,
                   **({"t": cfg.t} if topology == "multigraph" else {}))
    return {"sim_mean_cycle_ms": sim.mean_cycle_ms,
            "sim_total_time_s": sim.total_time_s}


def test_fl_llm_finetune_sim_exact_and_losses_bit_equal(capsys):
    from repro_torch.launch.train import TrainConfig, run_reduced_fl
    mod = load_port("fl_llm_finetune")
    res = mod.main(["--rounds", str(FINETUNE["rounds"]), "--silos",
                    str(FINETUNE["silos"]), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[:2]] == list(mod.TOPOLOGIES)
    assert lines[-1].startswith("wall-clock speedup vs RING: x")
    for topo in mod.TOPOLOGIES:
        got = res[topo]
        for key, want in _reference_sim(topo).items():
            assert got[key] == want, (topo, key)
        mesh1 = run_reduced_fl(TrainConfig(
            arch=FINETUNE["arch"], topology=topo, silos=FINETUNE["silos"],
            rounds=FINETUNE["rounds"], lr=5e-2, mesh=1,
            lora_rank=FINETUNE["lora_rank"]), device="cpu")
        assert got["losses"] == mesh1["losses"], topo
        assert len(got["losses"]) == FINETUNE["rounds"]
