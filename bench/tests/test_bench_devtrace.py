"""The traced stretch's arithmetic and the per-layer readers on records
made up by hand."""

import json

import pytest

from bench import devtrace, harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
DTOH = "Memcpy DtoH (Device -> Pageable)"


def _td(**over):
    kw = dict(
        rounds=2, window_us=1000.0,
        device_ops=[("Memcpy HtoD (Pageable -> Device)", 0, 10),
                    ("sgemm", 100, 300), ("conv_fprop", 250, 400),
                    ("edge_aggregate_kernel", 400, 450), (DTOH, 450, 452),
                    ("conv_fprop", 600, 700), (DTOH, 700, 701)],
        host_spans=[("compile+dispatch", 5000, 5460), ("eval", 5580, 5705)],
        host_offset_us=-4996.0, edge_bound_us=40.0, round_flops=10 ** 9,
        window_round_ms=2.0, peak_flops=67e12)
    kw.update(over)
    return devtrace.TraceData(**kw)


def test_union_counts_overlaps_once():
    td = _td()
    busy, gaps = devtrace.union_busy(td.device_ops, td.window_us)
    assert busy == 10 + 300 + 52 + 101
    assert gaps == [(10, 100), (452, 600), (701, 1000.0)]


def test_alignment_by_the_synced_spans():
    td = _td()
    off = devtrace.align_host_spans(td.host_spans, td.device_ops)
    assert off == pytest.approx(701 - 5705)  # the last copy, the last eval
    extra = td.device_ops + [(DTOH, 200, 230)]
    assert devtrace.align_host_spans(td.host_spans, extra) == off
    far = [("compile+dispatch", 3000, 3460), ("eval", 5580, 5705)]
    assert devtrace.align_host_spans(far, td.device_ops) is None
    assert devtrace.align_host_spans(td.host_spans, []) is None


def test_readers():
    td = _td()
    read = {m["name"]: harness.load_reader(m["name"])(td)
            for m in MANIFEST["per_layer"]}
    assert read["launches_per_round"] == 4 / 2
    assert read["local_sgd_device_ms"] == pytest.approx(
        (200 + 150 + 100) / 1e3 / 2)
    assert read["edge_aggregate_roofline"] == pytest.approx(80.0)
    assert read["idle_share"] == pytest.approx(100 * (1 - 463 / 1000))
    assert read["fl_host_ms"] == pytest.approx((5705 - 460) / 1e3 / 2)
    assert read["round_mfu"] == pytest.approx(100 * 1e9 / 2e-3 / 67e12)
    assert read["fl_run_prep_ms"] == 0.0  # the first copy opens the stretch


def test_run_prep_ends_at_the_first_device_record():
    td = _td()
    late = [(name, s + 300, e + 300) for name, s, e in td.device_ops]
    read = harness.load_reader("fl_run_prep_ms")
    assert read(_td(device_ops=late)) == pytest.approx(300 / 1e3 / 2)


def test_readers_find_nothing_to_read():
    td = _td(device_ops=[], host_spans=[], rounds=2, host_offset_us=None)
    for name in ("launches_per_round", "local_sgd_device_ms",
                 "edge_aggregate_roofline", "idle_share", "fl_host_ms",
                 "fl_run_prep_ms"):
        assert harness.load_reader(name)(td) is None


def test_breakdown_names_gaps_by_host_span():
    td = _td(host_offset_us=-4990.0)
    b = devtrace.breakdown(td)
    assert [n for n, _ in b["device_ops"][:2]] == ["conv_fprop", "sgemm"]
    assert len(b["idle_gaps"]) == 3 and b["idle_gaps"][0][1] == 299e-6
    labels = [name for name, _ in b["idle_gaps"]]
    assert labels == ["run end (report, trace file)",
                      "between spans (sampling, staging)",
                      "compile+dispatch"]
    assert devtrace.breakdown(_td(host_offset_us=None))["idle_gaps"][0][0] \
        == "unattributed"
