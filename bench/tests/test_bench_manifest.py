"""`BENCHMARK.json` against the benchmark's contract: names, units, keys,
the files each entry is found by, bounds, and the run length's budget."""

import json
import re

import pytest

from bench import check, harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token|filters|"
                   r"size)")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in MANIFEST["configs"]:
        assert set(c) == KEYS["config"]
    for w in MANIFEST["workloads"]:
        assert set(w) == KEYS["workload"]
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


def test_names_units_and_text():
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [x["name"] for x in MANIFEST[g]]
        assert len(names) == len(set(names)), g
        for x in MANIFEST[g]:
            assert NAME.match(x["name"]), x["name"]
            if "unit" in x:
                assert UNIT.match(x["unit"]), x["unit"]
                assert x["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in x:
                    assert _text(x[key]), (x["name"], key)
    metrics = [x["name"] for g in ("end_to_end", "per_layer")
               for x in MANIFEST[g]]
    assert len(metrics) == len(set(metrics))
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word or (ROOT / word).exists():
            assert any(word == p or word.startswith(p + "/")
                       for p in paths), word


def test_every_file_is_found_by_name():
    paths = MANIFEST["paths"]
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in paths)
        assert (ROOT / c["file"]).is_file()
        assert (ROOT / c["file"]).with_suffix(".py").is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
    for w in MANIFEST["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.check_rounds <= cell.traffic["rounds"]
        assert {"loss_rel_gap", "sim_gap_ms"} <= set(cell.limits) \
            <= set(check.NUMBERS)
    for m in MANIFEST["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_moves_targets_are_reported_by_their_cells():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    # every cell's untraced line reports round_ms and setup_s
    assert set(e2e) == {"round_ms", "setup_s"}
    assert all("workloads" not in m for m in e2e.values())
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        assert any(w in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"])


def test_metric_sources_and_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert _text(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])


@pytest.mark.parametrize("cells", [24])
def test_run_seconds_fits_the_check_budget(cells):
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * cells
    assert runs * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
