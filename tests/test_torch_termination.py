"""The port's termination models (``repro_torch.core.termination``) against
``repro.core.termination`` on the bills of ``tests/test_substrate.py``'s
``test_termination_models`` (and a few more): equal dictionaries from the
heartbeat model, the BSP all-reduce cost and the Dijkstra-Scholten estimate."""

import dataclasses

import pytest

from repro.core import kcore_decompose as jax_kcore_decompose
from repro.core import termination as jax_term
from repro.graph import generators as jax_gen
from repro_torch.core import termination
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import generators as gen

GRAPHS = {
    "ba200": lambda G: G.barabasi_albert(200, 3, seed=0),
    "chain50": lambda G: G.chain(50),
    "FC": lambda G: G.snap_analogue("FC", 0.02, seed=0),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_models_equal_the_reference(name):
    stats = kcore_decompose(GRAPHS[name](gen), device="cpu").stats
    want_stats = jax_kcore_decompose(GRAPHS[name](jax_gen)).stats
    hb = termination.HeartbeatModel()
    assert dataclasses.asdict(hb) == dataclasses.asdict(jax_term.HeartbeatModel())
    for round_time_s in (0.01, 1.0, 25.0):
        got = hb.overhead(stats, round_time_s=round_time_s)
        assert got == jax_term.HeartbeatModel().overhead(want_stats, round_time_s=round_time_s)
        assert got["total_heartbeats"] > 0
    short = termination.HeartbeatModel(heartbeat_interval_s=0.5, silence_timeout_s=2.0)
    assert short.overhead(stats, 1.0) == jax_term.HeartbeatModel(
        heartbeat_interval_s=0.5, silence_timeout_s=2.0).overhead(want_stats, 1.0)
    for n_devices in (1, 2, 8, 256, 1000):
        got = termination.bsp_termination_cost(stats, n_devices=n_devices)
        assert got == jax_term.bsp_termination_cost(want_stats, n_devices=n_devices)
        assert got["allreduces"] == stats.rounds
    ds = termination.dijkstra_scholten_estimate(stats)
    assert ds == jax_term.dijkstra_scholten_estimate(want_stats)
    assert ds["signal_messages"] == stats.total_messages
