"""The port's observability CLI (`python -m repro_torch.obs`) against
`python -m repro.obs`: the `trace` command's JSON and JSONL are the
reference's bytes for the same arguments, with and without
``--scenario``; `convert` and `validate` print and exit the same.
Everything here is host-side numpy and JSON.
"""

import json

import pytest

pytest.importorskip("jax")

from repro.obs import __main__ as rmain  # noqa: E402

from repro_torch.obs import __main__ as pmain  # noqa: E402

TRACE_CASES = [
    [],
    ["--scenario", "drift"],
    ["--scenario", "outage", "--rounds", "40"],
    ["--scenario", "flash", "--network", "geant", "--t", "3"],
    ["--topology", "ring", "--workload", "inaturalist", "--rounds", "12"],
    ["--topology", "matcha", "--seed", "2", "--rounds", "16"],
    ["--network", "amazon", "--workload", "sentiment140", "--t", "4"],
]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("args", TRACE_CASES,
                         ids=["default", "drift", "outage", "flash-geant",
                              "ring", "matcha", "amazon"])
def test_trace_bytes_equal(tmp_path, capsys, args):
    outs = {}
    for tag, main in (("p", pmain.main), ("r", rmain.main)):
        out, jsonl = tmp_path / f"{tag}.json", tmp_path / f"{tag}.jsonl"
        rc, text, _ = _run(main, ["trace", *args, "--out", str(out),
                                  "--jsonl", str(jsonl)], capsys)
        assert rc == 0
        summary = json.loads(text)
        summary.pop("out")
        outs[tag] = (out.read_bytes(), jsonl.read_bytes(), summary)
    assert outs["p"] == outs["r"]
    obj = json.loads(outs["p"][0])
    assert obj["traceEvents"] and outs["p"][2]["events"] > 0


def test_convert_and_validate_equal(tmp_path, capsys):
    jsonl = tmp_path / "run.jsonl"
    assert pmain.main(["trace", "--scenario", "churn", "--rounds", "8",
                       "--out", str(tmp_path / "t.json"),
                       "--jsonl", str(jsonl)]) == 0
    capsys.readouterr()
    got = _run(pmain.main, ["convert", str(jsonl), str(tmp_path / "p.json")],
               capsys)
    want = _run(rmain.main, ["convert", str(jsonl),
                             str(tmp_path / "r.json")], capsys)
    assert got[0] == want[0] == 0
    assert json.loads(got[1])["events"] == json.loads(want[1])["events"]
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "pid": 1, "ts": -1, "dur": 1}]}))
    junk = tmp_path / "junk.json"
    junk.write_text("{not json")
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps([{"name": "a", "us_per_call": 1.0, "ts": 2},
                                 {"name": "b", "us_per_call": "x", "ts": 1}]))
    good_bench = tmp_path / "good.json"
    good_bench.write_text(json.dumps([{"name": "a", "us_per_call": 3}]))
    for argv in (["validate", str(tmp_path / "p.json")],
                 ["validate", str(bad), str(junk)],
                 ["validate", "--bench", str(bench), str(good_bench)],
                 ["validate", str(tmp_path / "p.json"), "--bench",
                  str(good_bench)]):
        got = _run(pmain.main, argv, capsys)
        want = _run(rmain.main, argv, capsys)
        assert got[:2] == want[:2], argv
        assert got[2].replace("repro_torch", "repro") == want[2], argv
    with pytest.raises(SystemExit):
        pmain.main(["validate"])


def test_validate_bench_rows_equal():
    cases = [[], {"name": "a"}, [{"us_per_call": 1}],
             [{"name": "a", "us_per_call": "fast"}],
             [{"name": "a", "us_per_call": 1, "ts": 5},
              {"name": "b", "us_per_call": 2, "ts": 4}],
             [{"name": "a", "us_per_call": 1}, {"name": "b",
                                                "us_per_call": True}],
             [3, {"name": "", "us_per_call": 1, "ts": "x"}]]
    for rows in cases:
        assert pmain.validate_bench_rows(rows) == \
            rmain.validate_bench_rows(rows)
