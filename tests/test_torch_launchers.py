"""The paper's example launchers and the dry-run tools of the port.

``repro_torch.launch.quickstart`` and ``paper_experiments`` print, with
``--device cpu``, the reference examples' stdout byte for byte (the
examples run in this process with ``sys.argv`` set). ``launch.dryrun``
counts the k-core cell on one shard and on the pod meshes without a card
(every other cell: ``tests/test_torch_step_cost.py``), and refuses what is
not ported (an LM, GNN or DIN cell on a pod mesh, ``hillclimb``'s
``din_fullshard``) naming ROADMAP.md Queue A item 12; ``hillclimb --list``
names the reference's variants.
"""

import pathlib
import runpy
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUNS = [["--graph", "EEN"], ["--graph", "chain", "--n", "500"],
        ["--graph", "FC", "--scale", "0.05"], ["--graph", "PTBR", "--scale", "0.05"]]


def _example_stdout(name, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", RUNS, ids=lambda a: "_".join(a[1::2]))
def test_paper_experiments_prints_the_example_byte_for_byte(argv, monkeypatch, capsys):
    from repro_torch.launch import paper_experiments

    want = _example_stdout("paper_experiments.py", argv, monkeypatch, capsys)
    paper_experiments.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert "=== Table I row" in want and "=== Fig 10 analogue" in want


def test_quickstart_prints_the_example_byte_for_byte(monkeypatch, capsys):
    from repro_torch.launch import quickstart

    want = _example_stdout("quickstart.py", [], monkeypatch, capsys)
    quickstart.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert want.startswith("Fig-1 cores :")


def test_report_takes_the_cores_it_is_given(capsys):
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.graph import generators as gen
    from repro_torch.launch import paper_experiments

    g = gen.snap_analogue("EEN", scale=0.1, seed=0)
    core = bz_core_numbers(g)
    res = paper_experiments.report(g, device="cpu", core_ref=core, name="EEN")
    assert (res.core == core).all()
    assert "=== Table I row (EEN) ===" in capsys.readouterr().out
    wrong = core.copy()
    wrong[0] += 1
    with pytest.raises(AssertionError):
        paper_experiments.report(g, device="cpu", core_ref=wrong)


def test_launchers_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from repro_torch.launch import dryrun, paper_experiments, quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (quickstart.main, paper_experiments.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(RuntimeError, match="--run needs a CUDA device"):
        dryrun.main(["--arch", "din", "--shape", "serve_p99", "--run"])
    with pytest.raises(RuntimeError, match="--run needs a CUDA device"):
        dryrun.run_cell("din", "serve_p99", save=False, run=True)


@pytest.mark.parametrize("mesh,chips", [("1", 1), ("pod1", 256), ("pod2", 512)])
def test_dryrun_kcore_cell(mesh, chips):
    from repro_torch.core.kcore import _bs_iters
    from repro_torch.graph.generators import SNAP_BY_ABBREV
    from repro_torch.launch import dryrun

    rec = dryrun.run_kcore_cell("LJ1", mesh, save=False)
    assert rec["status"] == "OK", rec.get("traceback")
    entry = SNAP_BY_ABBREV["LJ1"]
    assert (rec["chips"], rec["n"], rec["arcs"]) == (chips, entry.n, 2 * entry.m)
    assert rec["bs_iters"] == _bs_iters(entry.max_deg)
    assert rec["by_kernel"]["segment_sum"]["calls"] == rec["bs_iters"]
    V = -(-entry.n // chips)
    coll = rec["collectives"]
    if chips == 1:
        assert coll["total_bytes"] == 0.0
    else:
        # one all-gather of the int32 estimates, one all-reduce of the two counts (int64)
        assert coll["counts"] == {"all-gather": 1, "all-reduce": 1}
        ring = (chips - 1) / chips
        assert coll["bytes_by_kind"]["all-gather"] == pytest.approx(4 * V * chips * ring)
        assert coll["bytes_by_kind"]["all-reduce"] == pytest.approx(2 * 16 * ring)
        assert rec["roofline"]["coll_bytes"] == pytest.approx(coll["total_bytes"] * chips)


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_dryrun_pod_cells_name_item_12(mesh, tmp_path, monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    for arch, shape in (("qwen1.5-0.5b", "train_4k"), ("graphcast", "full_graph_sm"),
                        ("din", "serve_bulk")):
        rec = dryrun.run_cell(arch, shape, mesh)
        assert rec["status"] == "FAIL"
        assert "ROADMAP.md Queue A item 12" in rec["error"]
    assert len(list(tmp_path.glob(f"*_{mesh}.json"))) == 3


def test_hillclimb_lists_and_measures_the_variants(capsys):
    from repro_torch.launch import hillclimb

    names = ["mixtral_base", "mixtral_cap110", "mixtral_dots_remat", "mixtral_cap110_dots",
             "mixtral_micro4_dots", "mixtral_alldots", "mixtral_alldots_m64",
             "graphcast_products", "din_train", "qwen2moe_base", "qwen2moe_cap105",
             "din_fullshard"]
    hillclimb.main(["--list"])
    assert capsys.readouterr().out.split() == names
    hillclimb.main(["din_train", "graphcast_products"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["din_train", "graphcast_products"]
    res = hillclimb.VARIANTS["din_train"]()
    assert set(res) == {"compute_s", "memory_s", "collective_s", "dominant", "mem_GB",
                        "compile_s"}
    assert res["collective_s"] == "not measured"
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 12"):
        hillclimb.VARIANTS["din_fullshard"]()


@pytest.mark.parametrize("name", ["flash_call", "kcore_block_gs", "din_train", "moe_train",
                                  "graphcast_molecule", "lm_serve"])
def test_path_timing_times_each_path_on_the_cpu(name):
    from repro_torch.launch import path_timing

    rec = path_timing.worker([name], "cpu", small=True)
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["package"] == str(ROOT / "src" / "repro_torch")
    assert rec[name]["wall_s"] > 0
    assert all(v > 0 for k, v in rec[name].items())


def test_path_timing_alternates_parent_and_change(tmp_path, capsys):
    import json

    from repro_torch.launch import path_timing

    out = tmp_path / "ab.jsonl"
    assert path_timing.main(["--parent", str(ROOT), "--paths", "flash_call", "--device", "cpu",
                             "--small", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["side"] for r in recs] == ["parent", "change", "change", "parent"]
    assert {r["package"] for r in recs} == {str(ROOT / "src" / "repro_torch")}
    assert all(r["flash_call"]["serve_ms"] > 0 for r in recs)


def test_path_timing_needs_a_card_or_the_cpu():
    from repro_torch.launch import path_timing

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        path_timing.worker(["flash_call"], None, small=True)
