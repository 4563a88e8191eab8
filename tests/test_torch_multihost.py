"""The port's sharded engine across processes: two gloo ranks
(``repro_torch.distribution.compat.init_multiprocess`` + ``global_mesh``),
each holding 2 shards of a 4-shard mesh, run the fused sharded
decomposition; both must equal the single-process run and the reference
bit for bit, and the host loop must refuse the mesh.

Each rank is its own interpreter (the ranks import neither ``jax`` nor the
reference), rendezvousing on a free localhost port, with a process-group
timeout and a timeout on each subprocess so that ranks out of step fail
instead of hanging.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from repro.core import bz_core_numbers as jax_bz
from repro.core import kcore_decompose as jax_decompose
from repro.graph import generators as jax_gen

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATS = ("messages_per_round", "active_per_round", "changed_per_round")

_RANK_SCRIPT = r"""
import json, sys
import torch
from repro_torch.distribution import compat

rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
compat.init_multiprocess(f"127.0.0.1:{port}", nproc, rank, timeout_s=60)
compat.init_multiprocess(f"127.0.0.1:{port}", nproc, rank)      # a repeat is a no-op
assert compat.is_multiprocess()
mesh = compat.global_mesh("shard", local_shards=2, device="cpu")
assert compat.is_multiprocess_mesh(mesh) and mesh.size == 4
assert (mesh.local_shards, mesh.shard_offset) == (2, 2 * rank)

# the collectives: shards in rank order, bool masks through uint8, sums
x = compat.stage_to_mesh(torch.arange(12, dtype=torch.int32).reshape(4, 3).numpy(), mesh)
gathered = compat.all_gather(x, mesh)
mask = compat.all_gather(torch.tensor([rank == 0, True]), mesh)
total = compat.psum(torch.tensor([rank + 1, 10]), mesh)

from repro_torch.core.kcore import kcore_decompose_sharded
from repro_torch.graph import generators as gen

g = gen.barabasi_albert(300, 3, seed=7)
try:
    kcore_decompose_sharded(g, mesh, ("shard",))
    raise SystemExit("expected ValueError for the host loop on a multi-process mesh")
except ValueError as e:
    refused = str(e)
res = kcore_decompose_sharded(g, mesh, ("shard",), fused=True)
print(json.dumps({
    "rank": rank, "gathered": gathered.tolist(), "mask": mask.tolist(),
    "total": total.tolist(), "refused": refused, "core": res.core.tolist(),
    "rounds": res.rounds, "converged": res.converged, "device": str(mesh.device),
    **{k: getattr(res.stats, k).tolist() for k in %r}}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(nproc: int = 2) -> list[dict]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT % (STATS,), str(r), str(nproc),
                               str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


@pytest.fixture(scope="module")
def reports():
    return _run_ranks()


def test_collectives_gather_in_shard_order_and_sum(reports):
    for rank, rep in enumerate(reports):
        assert rep["rank"] == rank and rep["device"] == "cpu"
        assert rep["gathered"] == np.arange(12).reshape(4, 3).tolist()
        assert rep["mask"] == [True, True, False, True]
        assert rep["total"] == [3, 20]


def test_fused_sharded_spans_two_processes(reports):
    g = jax_gen.barabasi_albert(300, 3, seed=7)
    ref = jax_decompose(g)
    for rep in reports:
        np.testing.assert_array_equal(rep["core"], ref.core)
        np.testing.assert_array_equal(rep["core"], jax_bz(g))
        assert (rep["rounds"], rep["converged"]) == (ref.rounds, ref.converged)
        for k in STATS:
            np.testing.assert_array_equal(rep[k], getattr(ref.stats, k), err_msg=k)


def test_host_loop_refuses_a_multi_process_mesh(reports):
    assert [rep["refused"] for rep in reports] == ["multi-process meshes require fused=True"] * 2
