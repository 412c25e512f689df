"""The port's sweep (`repro_torch.core.sweep`) against
`repro.core.sweep`: the grid's cells, the four formatted tables
(Table 1, Table 3, TTA and scenario) as strings, `attach_scenario`
under drift, the port's `consistency_check` and its CLI. Every number
in the cells is numpy on both sides, so cells and tables are equal
exactly; only the host timings (`construct_ms`, `eval_ms`) differ.
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import sweep as rsweep  # noqa: E402

from repro_torch.core import sweep as psweep  # noqa: E402
from repro_torch.faults import get_scenario  # noqa: E402

QUICK = dict(networks=("gaia", "geant"), workloads=("femnist",),
             t_values=(3, 5), num_rounds=700)
HOST = ("construct_ms", "eval_ms")


def _rows(cells):
    return [{k: v for k, v in c.row().items() if k not in HOST}
            for c in cells]


@pytest.fixture(scope="module")
def quick_cells():
    return (psweep.run_sweep(psweep.SweepConfig(**QUICK)),
            rsweep.run_sweep(rsweep.SweepConfig(**QUICK)))


def test_config_and_constants_equal():
    assert dataclasses.asdict(psweep.SweepConfig()) == \
        dataclasses.asdict(rsweep.SweepConfig())
    assert (psweep.PAPER_TOPOLOGIES, psweep.PAPER_NETWORKS,
            psweep.PAPER_WORKLOADS) == (rsweep.PAPER_TOPOLOGIES,
                                        rsweep.PAPER_NETWORKS,
                                        rsweep.PAPER_WORKLOADS)


def test_run_sweep_cells_equal(quick_cells):
    got, want = quick_cells
    assert len(got) == len(want) == 16
    assert _rows(got) == _rows(want)
    for c in got:
        assert c.construct_ms >= 0 and c.eval_ms >= 0
    oracle = psweep.run_sweep(psweep.SweepConfig(**QUICK), batched=False,
                              shared=False)
    assert [c.report for c in oracle] == [c.report for c in got]


def test_tables_equal(quick_cells):
    """Table 1 and Table 3 as strings, and the TTA and scenario tables
    on the same filled-in columns."""
    got, want = quick_cells
    assert psweep.format_table1(got) == rsweep.format_table1(want)
    assert psweep.format_table3(got) == rsweep.format_table3(want)
    assert "iso_rounds" in psweep.format_table3(got)
    tta = dict(tta_s=1.25, tta_final_acc=0.5, tta_target_loss=3.75)
    pt = [dataclasses.replace(c, **tta) if c.t else c for c in got]
    rt = [dataclasses.replace(c, **tta) if c.t else c for c in want]
    assert psweep.format_tta(pt) == rsweep.format_tta(rt)
    assert _rows(pt) == _rows(rt)
    assert psweep.format_table1([]) == rsweep.format_table1([])


def test_attach_scenario_drift_equal(quick_cells):
    got, want = quick_cells
    pcfg = psweep.SweepConfig(**QUICK, scenario="drift")
    rcfg = rsweep.SweepConfig(**QUICK, scenario="drift")
    pa = psweep.attach_scenario(got, pcfg)
    ra = rsweep.attach_scenario(want, rcfg)
    assert _rows(pa) == _rows(ra)
    assert psweep.format_scenario(pa) == rsweep.format_scenario(ra)
    for c in pa:
        assert c.scenario == "drift"
        assert np.isfinite(c.scenario_total_s)
        assert c.scenario_total_s >= c.report.total_time_s


@pytest.mark.parametrize("name", ["nominal", "drift", "diurnal", "flash",
                                  "churn"])
def test_scenario_cycle_times_equal(name):
    """Per-round faulted series of every cell (recurrence and cyclic)
    equal the reference's; the nominal series is `cycle_times`."""
    from repro.faults import get_scenario as rget_scenario

    cfg = psweep.SweepConfig(**QUICK)
    pplans, _ = psweep.build_sweep_plans(cfg)
    rplans, _ = rsweep.build_sweep_plans(rsweep.SweepConfig(**QUICK))
    for p, r in zip(pplans, rplans):
        got = psweep.scenario_cycle_times(p, get_scenario(name), 300)
        want = rsweep.scenario_cycle_times(r, rget_scenario(name), 300)
        np.testing.assert_array_equal(got, want)
        if name == "nominal":
            np.testing.assert_array_equal(got, p.cycle_times(300))


def test_consistency_check_passes(capsys):
    psweep.consistency_check(psweep.SweepConfig(**QUICK), device="cpu")
    out = capsys.readouterr().out
    assert "consistency_check OK: 16 cells bit-exact" in out
    assert "matcha trainer==report@700r" in out
    assert "torch==numpy==per-cell reports" in out
    with pytest.raises(ValueError, match="backend"):
        psweep.run_sweep(psweep.SweepConfig(**QUICK, backend="jax"))


def test_cli(tmp_path, capsys):
    psweep.main(["--quick", "--check", "--device", "cpu"])
    assert "consistency_check OK: 14 cells" in capsys.readouterr().out
    out = tmp_path / "cells.json"
    psweep.main(["--quick", "--rounds", "300", "--scenario", "drift",
                 "--json", str(out)])
    text = capsys.readouterr().out
    rsweep.main(["--quick", "--rounds", "300", "--scenario", "drift"])
    rtext = capsys.readouterr().out
    cut = "\n\n14 cells in "
    assert text[:text.index(cut)] == rtext[:rtext.index(cut)]
    assert "simulated, of the paper's network model" in text
    assert "scenario 'drift'" in text
    rows = json.loads(out.read_text())
    assert len(rows) == 14 and rows[-1]["scenario"] == "drift"
    with pytest.raises(SystemExit):
        psweep.main(["--backend", "jax"])
