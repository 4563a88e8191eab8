"""The port's ``kcore_run --device cpu --json`` against the JAX CLI.

Both CLIs run as subprocesses on the same seeded graph; every accounting
field of their JSON reports must be equal (timings, the dispatch name and
the port's added ``device`` field are not accounting), and so must their
``--metrics`` registries (but the walls' values and the port's own
``stage`` phase) and their ``--flight`` rings and health verdicts.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACCOUNTING = ("graph", "n", "m", "avg_deg", "max_deg", "max_core", "mode", "backend", "fused",
              "mesh", "correct_vs_BZ", "rounds", "converged", "total_messages", "work_bound",
              "messages_over_bound", "messages_per_round", "active_per_round", "heartbeats",
              "simulated_runtime_s")


def _run(module, *argv, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=300)


def _report(out):
    assert out.returncode == 0, out.stderr
    text = out.stdout
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


@pytest.mark.parametrize("argv", [
    ("--graph", "FC", "--scale", "0.05", "--fused"),
    ("--graph", "EEN", "--scale", "0.02"),
    ("--graph", "chain", "--n", "300", "--fused"),
    ("--graph", "FC", "--scale", "0.05", "--mode", "block_gs"),
    ("--graph", "EEN", "--scale", "0.02", "--backend", "ell_pallas"),
    ("--graph", "ba", "--n", "400", "--backend", "ell", "--fused"),
], ids=["FC-fused", "EEN-host", "chain-fused", "FC-block_gs", "EEN-ell_pallas", "ba-ell-fused"])
def test_cli_report_equals_the_jax_cli(argv):
    port = _report(_run("repro_torch.launch.kcore_run", *argv, "--device", "cpu", "--json"))
    ref = _report(_run("repro.launch.kcore_run", *argv, "--json"))
    assert {k: port[k] for k in ACCOUNTING} == {k: ref[k] for k in ACCOUNTING}
    assert set(ref) <= set(port)
    assert port["device"] == "cpu" and port["dispatch"] == "torch"


def test_cli_trace_and_flight_outputs(tmp_path):
    out = _run("repro_torch.launch.kcore_run", "--graph", "FC", "--scale", "0.05", "--fused",
               "--device", "cpu", "--trace", str(tmp_path / "t.json"),
               "--flight", str(tmp_path / "f.json"))
    assert out.returncode == 0, out.stderr
    names = {e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"kcore.decompose", "fused-converge", "device-converge", "stats-reconstruct"} <= names
    flight = json.loads((tmp_path / "f.json").read_text())
    assert flight["runs"] == 1 and flight["rounds_recorded"] > 1


@pytest.mark.parametrize("argv,mesh", [
    (("--graph", "FC", "--scale", "0.05"), 4),
    (("--graph", "ba", "--n", "400", "--fused"), 2),
], ids=["FC-mesh4-host", "ba-mesh2-fused"])
def test_cli_mesh_report_equals_the_jax_cli(argv, mesh):
    argv = (*argv, "--mesh", str(mesh))
    port = _report(_run("repro_torch.launch.kcore_run", *argv, "--device", "cpu", "--json"))
    ref = _report(_run("repro.launch.kcore_run", *argv, "--json"))
    assert {k: port[k] for k in ACCOUNTING} == {k: ref[k] for k in ACCOUNTING}
    assert port["correct_vs_BZ"] and port["mesh"] == mesh
    assert set(port["phase_s"]) - {"stage"} == set(ref["phase_s"])


@pytest.mark.parametrize("argv", [("--mesh", "2", "--mode", "block_gs"),
                                  ("--mesh", "2", "--backend", "ell")])
def test_cli_mesh_refusals_equal_the_jax_cli(argv):
    port = _run("repro_torch.launch.kcore_run", "--graph", "chain", "--n", "30", "--device",
                "cpu", *argv)
    ref = _run("repro.launch.kcore_run", "--graph", "chain", "--n", "30", *argv)
    assert port.returncode == ref.returncode == 2
    assert port.stderr.splitlines()[-1] == ref.stderr.splitlines()[-1]
    assert "--mesh supports --mode jacobi --backend segment only" in port.stderr


# the block-cycling telemetry each package measures on its own clock and process
OOC_OWN = ("peak_rss_bytes", "ms_per_round")


@pytest.mark.parametrize("argv", [
    ("--graph", "FC", "--scale", "0.05", "--mem-budget", "4096"),
    ("--graph", "ba", "--n", "400", "--blocks", "4"),
    ("--graph", "chain", "--n", "200"),
], ids=["FC-budget", "ba-blocks", "chain-default"])
def test_cli_out_of_core_report_equals_the_jax_cli(argv):
    port = _report(_run("repro_torch.launch.kcore_run", *argv, "--out-of-core", "--device", "cpu",
                        "--json"))
    ref = _report(_run("repro.launch.kcore_run", *argv, "--out-of-core", "--json"))
    assert {k: port[k] for k in ACCOUNTING} == {k: ref[k] for k in ACCOUNTING}
    assert port["correct_vs_BZ"] and set(ref) <= set(port)
    assert set(port["phase_s"]) == set(ref["phase_s"]) == {"converge"}
    got, want = dict(port["out_of_core"]), dict(ref["out_of_core"])
    for k in OOC_OWN:
        assert got.pop(k) > 0 and want.pop(k) > 0, k
    assert got == want
    assert port["device"] == "cpu" and port["dispatch"] == "torch"


@pytest.mark.parametrize("argv", [
    ("--out-of-core", "--fused"), ("--out-of-core", "--mode", "block_gs"),
    ("--out-of-core", "--backend", "ell"), ("--out-of-core", "--mesh", "2"),
    ("--mem-budget", "4096"), ("--blocks", "4"),
])
def test_cli_out_of_core_refusals_equal_the_jax_cli(argv):
    port = _run("repro_torch.launch.kcore_run", "--graph", "chain", "--n", "30", "--device",
                "cpu", *argv)
    ref = _run("repro.launch.kcore_run", "--graph", "chain", "--n", "30", *argv)
    assert port.returncode == ref.returncode == 2
    assert port.stderr.splitlines()[-1] == ref.stderr.splitlines()[-1]
    assert "--out-of-core" in port.stderr or "require" in port.stderr


def test_cli_out_of_core_without_a_card_fails_unless_cpu_is_asked():
    argv = ("--graph", "chain", "--n", "20", "--out-of-core", "--blocks", "2")
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.kcore_run", *argv],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.kcore_run", *argv,
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "out_of_core: {'n_blocks': 2" in out.stdout


def _objects(text):
    """Every top-level JSON object printed in ``text``, in order."""
    dec, out, i = json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        obj, end = dec.raw_decode(text, i)
        out.append(obj)
        i = end
    return out


# gauges whose values are walls; the port's ``stage`` phase has no reference twin
WALL_GAUGES = ("kcore_wall_seconds", "kcore_compile_seconds", "kcore_phase_seconds")


def _series(registry_json):
    return {(name, json.dumps(s["labels"], sort_keys=True)): (s["type"], s.get("value"))
            for name, series in registry_json.items() for s in series}


@pytest.mark.parametrize("argv", [("--graph", "FC", "--scale", "0.05", "--fused"),
                                  ("--graph", "EEN", "--scale", "0.02")], ids=["fused", "host"])
def test_cli_metrics_equal_the_jax_cli(argv):
    port = _objects(_run("repro_torch.launch.kcore_run", *argv, "--device", "cpu", "--json",
                         "--metrics").stdout)
    ref = _objects(_run("repro.launch.kcore_run", *argv, "--json", "--metrics").stdout)
    assert {k: port[0][k] for k in ACCOUNTING} == {k: ref[0][k] for k in ACCOUNTING}
    got, want = _series(port[1]["metrics"]), _series(ref[1]["metrics"])
    extra = set(got) - set(want)
    assert extra == {("kcore_phase_seconds", json.dumps({"graph": argv[1], "phase": "stage"}))}
    for key, (kind, value) in want.items():
        assert got[key][0] == kind, key
        if key[0] not in WALL_GAUGES:
            assert got[key][1] == value, key
    assert got[("kcore_rounds_total", json.dumps({"graph": argv[1]}))][1] == port[0]["rounds"]
    assert got[("obs_health_status", "{}")][1] == 1.0


def test_cli_metrics_prometheus_and_files(tmp_path):
    base = ("--graph", "chain", "--n", "200", "--device", "cpu", "--metrics-format", "prom")
    out = _run("repro_torch.launch.kcore_run", *base, "--metrics-out", str(tmp_path / "m.prom"))
    assert out.returncode == 0, out.stderr
    text = (tmp_path / "m.prom").read_text()
    assert 'kcore_rounds_total{graph="chain"} 100.0' in text
    assert "# TYPE kcore_messages_total counter" in text and text in out.stdout
    assert f"metrics: {tmp_path / 'm.prom'} (prom)" in out.stdout
    out = _run("repro_torch.launch.kcore_run", "--graph", "chain", "--n", "200", "--device", "cpu",
               "--metrics-out", str(tmp_path / "m.json"))
    assert out.returncode == 0, out.stderr
    saved = json.loads((tmp_path / "m.json").read_text())["metrics"]
    assert saved["kcore_rounds_total"][0]["value"] == 100.0


def test_cli_flight_and_health_equal_the_jax_cli(tmp_path):
    argv = ("--graph", "ba", "--n", "400", "--fused")
    port = _run("repro_torch.launch.kcore_run", *argv, "--device", "cpu",
                "--flight", str(tmp_path / "p.json"))
    ref = _run("repro.launch.kcore_run", *argv, "--flight", str(tmp_path / "r.json"))
    assert port.returncode == ref.returncode == 0, port.stderr
    assert port.stdout.splitlines()[-1].replace("p.json", "") == \
        ref.stdout.splitlines()[-1].replace("r.json", "")
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "r.json"))
    assert got["health"] == want["health"] and got["health"]["status"] == "ok"
    assert got["health"]["runs_seen"] == 1
    for k in ("capacity", "runs", "rounds_recorded", "dropped"):
        assert got[k] == want[k], k
    keys = ("run", "engine", "mode", "batch", "round", "frontier", "messages", "changed",
            "est_rises", "drop_hist", "est_sum")
    assert [{k: r[k] for k in keys} for r in got["records"]] == \
        [{k: r[k] for k in keys} for r in want["records"]]


def test_cli_refuses_fused_block_gs_as_the_reference_does():
    out = _run("repro_torch.launch.kcore_run", "--graph", "chain", "--n", "30", "--device", "cpu",
               "--mode", "block_gs", "--fused")
    assert out.returncode != 0 and "requires mode='jacobi'" in out.stderr


def test_cli_without_a_card_fails_unless_cpu_is_asked():
    env_out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kcore_run", "--graph", "chain", "--n", "20"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
             "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""})
    assert env_out.returncode != 0
    assert "no CUDA device" in env_out.stderr


# ------------------------------ serve ------------------------------------- #

def test_serve_cli_on_the_cpu_prints_its_lines():
    out = _run("repro_torch.launch.serve", "--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
               "--batch", "2", "--prompt-len", "16", "--gen", "4")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=qwen1.5-0.5b-smoke served batch=2 prompt=16 generated=4 "
                               "tokens in ")
    assert lines[0].endswith(" tok/s)")
    sample = json.loads(lines[1].removeprefix("sample: "))
    assert len(sample) == 4 and all(0 <= t < 512 for t in sample)
    assert lines[2].startswith("device: cpu") and "ms/token" in lines[2]


def test_serve_cli_without_a_card_fails_unless_cpu_is_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b", "--smoke"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
             "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("arch", ["schnet"])
def test_serve_cli_refuses_what_is_not_ported(arch):
    """Every LM id is ported; the GNN ids are too (item 12), and the LM
    serve CLI refuses them as another family, naming their launcher."""
    out = _run("repro_torch.launch.serve", "--arch", arch, "--device", "cpu")
    assert out.returncode == 2
    assert f"--arch {arch} is a gnn model" in out.stderr
    assert "repro_torch.launch.graphcast_weather" in out.stderr


@pytest.mark.parametrize("arch,prompt", [("qwen2-moe-a2.7b", 16), ("mixtral-8x22b", 40)])
def test_serve_cli_serves_the_moe_smoke_configs_on_the_cpu(arch, prompt):
    """The MoE SMOKE configs through the serve CLI; Mixtral's prompt of 40
    passes its window of 32, so the cache rolls from the first decode step."""
    out = _run("repro_torch.launch.serve", "--arch", arch, "--smoke", "--device", "cpu",
               "--batch", "2", "--prompt-len", str(prompt), "--gen", "6")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke served batch=2 prompt={prompt} generated=6 ")
    sample = json.loads(lines[1].removeprefix("sample: "))
    assert len(sample) == 6 and all(0 <= t < 512 for t in sample)
    assert lines[2].startswith("device: cpu") and "ms/token" in lines[2]


# ------------------------------ graphcast_weather ------------------------- #

def test_graphcast_weather_cli_trains_then_rolls_out_on_the_cpu():
    out = _run("repro_torch.launch.graphcast_weather", "--smoke", "--device", "cpu",
               "--train-steps", "3")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    first, last = (float(x) for x in lines[0].removeprefix("weather next-state MSE: ")
                   .split(" -> "))
    assert 0 < last < first
    assert lines[1] == "3-step rollout finite: True shape: (84, 8)"
    assert lines[2].startswith("device: cpu") and "graphcast-smoke: train " in lines[2]
    assert lines[2].count("ms a step") == 2 and "peak device memory not measured" in lines[2]
    bad = _run("repro_torch.launch.graphcast_weather", "--smoke", "--device", "cpu",
               "--train-steps", "-1")
    assert bad.returncode == 2 and "--train-steps" in bad.stderr


# ------------------------------ din_serve --------------------------------- #

def test_din_serve_cli_on_the_cpu_prints_its_lines():
    out = _run("repro_torch.launch.din_serve", "--smoke", "--device", "cpu", "--train-steps", "3",
               "--batch", "64", "--n-candidates", "700", "--top-k", "5")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 4
    first, last = (float(x) for x in lines[0].removeprefix("train: loss ").split(" -> "))
    assert 0 < first < 2 and 0 < last < 2
    assert lines[1].startswith("serve batch=64: ") and " ms, mean ctr 0." in lines[1]
    ids = json.loads(lines[2].removeprefix("retrieval top-5 candidate ids: "))
    assert len(ids) == len(set(ids)) == 5 and all(0 <= i < 1024 for i in ids)
    assert lines[3].startswith("device: cpu") and "din-smoke" in lines[3]
    assert "peak device memory not measured" in lines[3]


def test_din_serve_cli_names_the_serve_shape():
    out = _run("repro_torch.launch.din_serve", "--smoke", "--device", "cpu", "--train-steps", "1",
               "--n-candidates", "100", "--top-k", "3")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[1].startswith("serve_p99 batch=512: ")


def test_din_serve_cli_without_a_card_fails_unless_cpu_is_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.din_serve", "--smoke"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
             "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_serve_cli_sends_din_to_its_own_launcher():
    out = _run("repro_torch.launch.serve", "--arch", "din", "--device", "cpu")
    assert out.returncode == 2
    assert "repro_torch.launch.din_serve" in out.stderr


# ------------------------------ kcore_serve ------------------------------- #

# columns and header fields that are walls (or name the device)
SERVE_WALLS = ("patch_s", "query_s")
STATS_WALLS = ("query_wall_s", "update_wall_s", "snapshot_age_s", "latency")
SERVE_ARGS = ("--n", "500", "--batches", "3", "--queries", "2000", "--verify")


def _serve_table(out):
    """The run's lines with the walls taken out: header fields, CSV rows as
    dicts, the ``# asof_boundaries=`` line, and ``# final_stats=`` with its
    counters (and each op's request count) but no wall."""
    import ast

    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    cols = next(line for line in lines if line.startswith("tick,")).split(",")
    table = {"columns": cols, "rows": [], "header": None, "asof": None, "stats": None}
    for line in lines:
        if line.startswith(("# graph=", "# events=")):
            table["header"] = [f for f in line.split()
                               if not f.startswith(("init_wall_s=", "device="))]
        elif line[:1].isdigit():
            row = dict(zip(cols, line.split(",")))
            assert row.get("verified") == "True"
            table["rows"].append({k: v for k, v in row.items() if k not in SERVE_WALLS})
        elif line.startswith("# asof_boundaries="):
            table["asof"] = line
        elif line.startswith("# final_stats="):
            stats = ast.literal_eval(line.removeprefix("# final_stats="))
            counts = {op: s["count"] for op, s in stats["latency"].items()}
            table["stats"] = {**{k: v for k, v in stats.items() if k not in STATS_WALLS},
                              "counts": counts}
    return table


@pytest.mark.parametrize("concurrent", [(), ("--concurrent", "2")], ids=["serial", "concurrent"])
@pytest.mark.parametrize("source", [("--graph", "ba"), ("--events", "ba")], ids=["static", "events"])
def test_serve_cli_rows_equal_the_jax_cli(source, concurrent):
    argv = (*source, *SERVE_ARGS, *concurrent)
    port = _run("repro_torch.launch.kcore_serve", *argv, "--device", "cpu")
    ref = _run("repro.launch.kcore_serve", *argv)
    got, want = _serve_table(port), _serve_table(ref)
    assert got == want
    assert len(got["rows"]) == 3 and (got["asof"] is not None) == (source[0] == "--events")
    assert any(line.startswith("# ") and line.endswith(" device=cpu")
               for line in port.stdout.splitlines())


@pytest.mark.parametrize("source", [("--graph", "ba", "--concurrent", "2"), ("--events", "ba")],
                         ids=["static-concurrent", "events"])
def test_serve_cli_resumes_a_checkpoint_in_lockstep(tmp_path, source):
    """Stopped after 2 ticks, resumed to 4 from its checkpoint: the rows of an
    uninterrupted 4-tick run of the reference CLI."""
    base = (*source, "--n", "500", "--queries", "2000", "--verify")
    ck = str(tmp_path / "ck")
    first = _run("repro_torch.launch.kcore_serve", *base, "--batches", "2", "--device", "cpu",
                 "--checkpoint-dir", ck)
    assert "# checkpoint: step 2 -> " in first.stdout, first.stderr
    rest = _run("repro_torch.launch.kcore_serve", *base, "--batches", "4", "--device", "cpu",
                "--checkpoint-dir", ck)
    assert "# resumed: step 2 from " in rest.stdout
    want = _serve_table(_run("repro.launch.kcore_serve", *base, "--batches", "4"))
    got = _serve_table(first)["rows"] + _serve_table(rest)["rows"]
    assert got == want["rows"] and [r["tick"] for r in got] == ["0", "1", "2", "3"]


def test_serve_cli_drains_on_sigterm_and_serves_http_while_it_runs(tmp_path):
    """SIGTERM ends the loop after its current tick, saves a checkpoint and
    exits 0; while it ran, /query/* and /healthz answered. A resumed run
    continues with the uninterrupted run's rows."""
    import signal
    import urllib.request

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"))
    ck = str(tmp_path / "ck")
    base = ("--graph", "ba", "--n", "500", "--queries", "500", "--device", "cpu", "--verify")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.kcore_serve", *base, "--batches", "100000",
         "--concurrent", "2", "--listen", "0", "--checkpoint-dir", ck],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        url, lines = None, []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("# obs: listening on "):
                url = line.split()[4]
            if line[:1].isdigit():
                break
        assert url is not None, "".join(lines)
        with urllib.request.urlopen(url + "/query/max_k", timeout=5) as resp:
            assert resp.status == 200 and json.loads(resp.read())["ok"] is True
        with urllib.request.urlopen(url + "/healthz", timeout=5) as resp:
            assert resp.status == 200
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    text = "".join(lines) + rest
    assert "# signal 15: draining after current tick" in text
    ticks = sum(1 for line in text.splitlines() if line[:1].isdigit())
    assert f"# checkpoint: step {ticks} -> " in text
    resumed = _run("repro_torch.launch.kcore_serve", *base, "--batches", str(ticks + 1),
                   "--checkpoint-dir", ck)
    assert f"# resumed: step {ticks} from " in resumed.stdout
    want = _serve_table(_run("repro_torch.launch.kcore_serve", *base, "--batches",
                             str(ticks + 1)))["rows"][-1]
    assert _serve_table(resumed)["rows"] == [want]


@pytest.mark.parametrize("argv", [("--graph", "ba", "--mesh", "2"),
                                  ("--graph", "ba", "--frontier", "sharded"),
                                  ("--events", "ba", "--mesh", "2", "--frontier", "fused")],
                         ids=["mesh", "frontier-sharded", "events-mesh-fused"])
def test_serve_cli_mesh_rows_equal_the_jax_cli(argv):
    port = _run("repro_torch.launch.kcore_serve", *argv, *SERVE_ARGS, "--device", "cpu")
    ref = _run("repro.launch.kcore_serve", *argv, *SERVE_ARGS)
    got, want = _serve_table(port), _serve_table(ref)
    assert got == want
    assert len(got["rows"]) == 3
    mesh = argv[argv.index("--mesh") + 1] if "--mesh" in argv else "1"
    assert f"mesh={mesh}" in got["header"]
    assert {row["mode"] for row in got["rows"]} <= {"sharded", "fused_sharded"}


def test_serve_cli_without_a_card_fails_unless_cpu_is_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kcore_serve", "--graph", "ba", "--n", "50",
         "--batches", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
             "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "tick," not in out.stdout
