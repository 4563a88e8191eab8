"""The port's graph IO (``repro_torch.graph.io``, the paper's dataCleanse
rules) against ``repro.graph.io`` on the inputs of ``tests/test_graph_io.py``:
the same graphs, arrays and JSON text."""

import numpy as np
import pytest

from repro.graph import io as jax_io
from repro.graph.structs import Graph as JaxGraph
from repro_torch.graph import io
from repro_torch.graph.structs import Graph

ARRAYS = ("src", "dst", "offsets", "deg")


def _assert_same(g, want):
    assert (g.n, g.m) == (want.n, want.m)
    for k in ARRAYS:
        a, b = getattr(g, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (g.dst < max(g.n, 1)).all()


@pytest.mark.parametrize("text", [
    '{"0": [5]}', "{}", '{"0": [1, 1, 2], "1": [0], "3": []}', '{"2": [0, 1], "7": [7]}'])
def test_json_adjacency_equals_the_reference(text):
    g = io.parse_json_adjacency(text)
    _assert_same(g, jax_io.parse_json_adjacency(text))
    assert io.to_json_adjacency(g) == jax_io.to_json_adjacency(jax_io.parse_json_adjacency(text))
    if text == '{"0": [5]}':
        assert g.n == 6 and list(g.neighbors(0)) == [5] and list(g.neighbors(5)) == [0]


def test_json_adjacency_round_trip(tmp_path):
    edges = [(0, 1), (1, 2), (2, 0), (2, 3)]
    g = Graph.from_edges(edges, n=5)
    text = io.to_json_adjacency(g)
    assert text == jax_io.to_json_adjacency(JaxGraph.from_edges(edges, n=5))
    _assert_same(io.parse_json_adjacency(text), g)
    io.save_json_adjacency(g, str(tmp_path / "g.json"))
    _assert_same(io.parse_json_adjacency((tmp_path / "g.json").read_text()), g)


@pytest.mark.parametrize("text", [
    "# header\n0 1\n1,2\n% alt comment\n2\t0\n", "0 1 999\n1 2\n2 0 7 8\n", "0 1 100\n1 2 101\n",
    "# nothing here\n%\n\n", "3 3\n4 1\n1 4\n"])
def test_edge_lists_equal_the_reference(text, tmp_path):
    _assert_same(io.parse_edge_list(text), jax_io.parse_edge_list(text))
    _assert_same(io.parse_edge_list(text, n=9), jax_io.parse_edge_list(text, n=9))
    p = tmp_path / "e.txt"
    p.write_text(text)
    _assert_same(io.load_edge_list(str(p)), jax_io.load_edge_list(str(p)))


def test_chunked_loading_equals_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    e = rng.integers(0, 500, size=(3000, 2))
    p = tmp_path / "edges.txt"
    p.write_text("\n".join(["# snap header", "% alt comment", *(f"{u}\t{v}" for u, v in e)]) + "\n")
    want = jax_io.parse_edge_list(p.read_text())
    for chunk_bytes in (1 << 24, 4096, 64):
        _assert_same(io.load_edge_list(str(p), chunk_bytes=chunk_bytes), want)
        chunks = list(io.iter_edge_chunks(str(p), chunk_bytes))
        ref_chunks = list(jax_io.iter_edge_chunks(str(p), chunk_bytes))
        assert len(chunks) == len(ref_chunks)
        for a, b in zip(chunks, ref_chunks):
            np.testing.assert_array_equal(a, b)
        assert sum(len(c) for c in chunks) == len(e)
