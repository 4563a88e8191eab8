"""The port's k-truss copy (``repro_torch.core.ktruss``) against
``repro.core.ktruss`` on the inputs of ``tests/test_ktruss.py``: the same
truss numbers from peeling and from the BSP iteration, and the same
per-round message bill."""

import numpy as np
import pytest

from repro.core import ktruss as jax_ktruss
from repro.graph import generators as jax_gen
from repro.graph.structs import Graph as JaxGraph
from repro_torch.core import ktruss
from repro_torch.graph import generators as gen
from repro_torch.graph.structs import Graph

STATS = ("messages_per_round", "active_per_round", "changed_per_round")
GRAPHS = {
    "K5": lambda G, _S: G.complete(5),
    "triangle+tail": lambda _G, S: S.from_edges([(0, 1), (1, 2), (0, 2), (2, 3)], n=4),
    **{f"er40-{s}": (lambda s: lambda G, _S: G.erdos_renyi(40, 140, seed=s))(s) for s in range(3)},
    "ba60": lambda G, _S: G.barabasi_albert(60, 3, seed=4),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_truss_numbers_and_bills_equal_the_reference(name):
    g, jg = GRAPHS[name](gen, Graph), GRAPHS[name](jax_gen, JaxGraph)
    peel = ktruss.ktruss_peeling(g)
    assert peel == jax_ktruss.ktruss_peeling(jg)
    est, stats = ktruss.ktruss_bsp(g)
    want_est, want_stats = jax_ktruss.ktruss_bsp(jg)
    assert est == want_est == peel
    for k in STATS:
        np.testing.assert_array_equal(getattr(stats, k), getattr(want_stats, k), err_msg=k)
    assert stats.rounds >= 1
    if name == "K5":
        assert set(peel.values()) == {5}
    if name == "triangle+tail":
        assert peel == {(0, 1): 3, (0, 2): 3, (1, 2): 3, (2, 3): 2}


@pytest.mark.parametrize("cap", [1, 2])
def test_bsp_round_cap_equals_the_reference(cap):
    est, stats = ktruss.ktruss_bsp(gen.erdos_renyi(40, 140, seed=0), max_rounds=cap)
    want_est, want_stats = jax_ktruss.ktruss_bsp(jax_gen.erdos_renyi(40, 140, seed=0),
                                                 max_rounds=cap)
    assert est == want_est
    for k in STATS:
        np.testing.assert_array_equal(getattr(stats, k), getattr(want_stats, k), err_msg=k)
