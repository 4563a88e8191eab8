"""The port's Chrome-trace validator (``repro_torch.obs.validate``) against the
reference's (``repro.obs.validate``): ``tests/test_obs.py``'s validator
cases through the port's, and on the same files, the hand-made ones and the
traces the port's own CLIs export (``kcore_run --trace``, ``kcore_serve
--trace``), the two ``main``s give the same exit code and the same report."""

import json

import pytest

from repro.obs import validate as ref
from repro_torch.obs import validate as V


def _ev(name, ts, dur, tid=1, **args):
    ev = {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def test_validator_accepts_nested_rejects_partial_overlap():
    ok = {"traceEvents": [_ev("a", 0, 100), _ev("b", 10, 20),
                          _ev("c", 40, 20), _ev("d", 200, 5)]}
    s = V.validate_chrome_trace(ok)
    assert s["events"] == 4 and s["max_depth"] == 2
    assert s == ref.validate_chrome_trace(ok)
    bad = {"traceEvents": [_ev("a", 0, 100), _ev("b", 50, 100)]}
    with pytest.raises(V.TraceValidationError, match="overlap"):
        V.validate_chrome_trace(bad)


@pytest.mark.parametrize("ev", [
    {"ph": "X", "ts": 0, "dur": 1, "pid": 1, "tid": 1},          # no name
    _ev("a", -1, 5),                                             # negative ts
    _ev("a", 0, -5),                                             # negative dur
    {**_ev("a", 0, 1), "ph": "B"},                               # wrong phase
    {**_ev("a", 0, 1), "pid": "x"},                              # pid type
    {**_ev("a", 0, 1), "args": [1]},                             # args type
])
def test_validator_rejects_malformed_events(ev):
    with pytest.raises(V.TraceValidationError) as got:
        V.validate_chrome_trace({"traceEvents": [ev]})
    with pytest.raises(ref.TraceValidationError) as want:
        ref.validate_chrome_trace({"traceEvents": [ev]})
    assert str(got.value) == str(want.value)
    assert issubclass(V.TraceValidationError, ValueError)


def test_span_tree_coverage_direct_children_only():
    evs = [_ev("batch", 0, 100), _ev("patch", 0, 30),
           _ev("converge", 30, 60), _ev("inner", 35, 10)]
    (cov,) = V.span_tree_coverage(evs, "batch")
    # inner is a grandchild: only patch + converge count, 90/100
    assert cov["coverage"] == pytest.approx(0.9)
    assert cov["children"] == ["converge", "patch"]
    assert V.span_tree_coverage(evs, "batch") == ref.span_tree_coverage(evs, "batch")
    assert V._nesting_sweep(evs) == ref._nesting_sweep(evs)


def test_validator_cli(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(
        {"traceEvents": [_ev("batch", 0, 100), _ev("patch", 0, 99)]}))
    assert V.main([str(good), "--require-span", "batch", "--min-coverage", "0.95"]) == 0
    assert V.main([str(good), "--require-span", "missing"]) == 1
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert V.main([str(bad)]) == 1
    low = tmp_path / "low.json"
    low.write_text(json.dumps(
        {"traceEvents": [_ev("batch", 0, 100), _ev("patch", 0, 10)]}))
    assert V.main([str(low), "--require-span", "batch", "--min-coverage", "0.95"]) == 1
    with pytest.raises(SystemExit):
        V.main([str(good), "--min-coverage", "0.5"])      # needs --require-span


def _both(argv, capsys):
    rc = V.main(argv)
    got = capsys.readouterr()
    rc_ref = ref.main(argv)
    want = capsys.readouterr()
    return (rc, got.out, got.err), (rc_ref, want.out, want.err)


def _cases(tmp_path):
    files = {
        "good": {"traceEvents": [_ev("batch", 0, 100), _ev("patch", 0, 99)]},
        "low": {"traceEvents": [_ev("batch", 0, 100), _ev("patch", 0, 10)]},
        "overlap": {"traceEvents": [_ev("a", 0, 100), _ev("b", 50, 100)]},
        "malformed": {"traceEvents": [_ev("a", -1, 5)]},
        "no_events": {"events": []},
    }
    paths = {}
    for name, doc in files.items():
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(doc))
    paths["not_json"] = tmp_path / "not.json"
    paths["not_json"].write_text("{not json")
    paths["missing"] = tmp_path / "missing.json"
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("flags", [[], ["--require-span", "batch"],
                                   ["--require-span", "batch", "--min-coverage", "0.95"],
                                   ["--require-span", "nothing"]])
def test_main_agrees_with_the_reference_on_hand_made_files(flags, tmp_path, capsys):
    paths = _cases(tmp_path)
    for name, path in paths.items():
        got, want = _both([path, *flags], capsys)
        assert got == want, name
    got, want = _both([*paths.values(), *flags], capsys)
    assert got == want


def test_main_agrees_with_the_reference_on_the_port_cli_traces(tmp_path, capsys):
    """The reference CI's two gates on traces the port's CLIs export on the
    CPU: ``kcore.decompose`` required of a fused ``kcore_run``, ``batch`` at
    coverage 0.95 of the CI's windowed ``kcore_serve`` replay and of a
    static-churn one."""
    from repro_torch.launch import kcore_run, kcore_serve
    from repro_torch.obs import trace

    run_trace, ci_trace, churn_trace = (str(tmp_path / f"{n}.json")
                                        for n in ("run", "ci", "churn"))
    runs = [(kcore_run.main, ["--graph", "FC", "--scale", "0.05", "--fused", "--json",
                              "--trace", run_trace]),
            (kcore_serve.main, ["--events", "ba", "--n", "2000", "--window", "3000", "--stride",
                                "1000", "--batches", "4", "--queries", "200", "--frontier",
                                "fused", "--verify", "--trace", ci_trace]),
            (kcore_serve.main, ["--graph", "ba", "--n", "500", "--batches", "2", "--queries",
                                "1000", "--frontier", "fused", "--verify", "--trace",
                                churn_trace])]
    try:
        for main, argv in runs:          # each trace holds its own run only
            trace.reset()
            main([*argv, "--device", "cpu"])
    finally:
        trace.disable()
        trace.reset()
    capsys.readouterr()
    gates = [([run_trace, "--require-span", "kcore.decompose"], 0),
             ([ci_trace, "--require-span", "batch", "--min-coverage", "0.95"], 0),
             ([churn_trace, "--require-span", "batch", "--min-coverage", "0.95"], 0),
             ([run_trace, "--require-span", "batch"], 1)]
    for argv, rc in gates:
        got, want = _both(argv, capsys)
        assert got == want, argv
        assert got[0] == rc, (argv, got)
    cov = V.span_tree_coverage(json.load(open(ci_trace))["traceEvents"], "batch")
    assert len(cov) == 4 and all(c["children"] for c in cov)
