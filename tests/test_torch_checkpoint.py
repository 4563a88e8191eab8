"""The port's checkpointing (``repro_torch.checkpoint``): round trips, atomic
commit, the layout it shares with ``repro.checkpoint``, and warm restarts of
the streaming engine and of a windowed replay that continue in lockstep
(``tests/test_checkpoint_engine.py``'s checks, on the port)."""

import json

import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.graph import generators as jax_gen
from repro.streaming import delta as jax_delta
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core.bz import bz_core_numbers
from repro_torch.graph import generators as gen
from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine, random_churn_batch
from repro_torch.streaming.delta import PatchableCSR
from repro_torch.temporal import WindowedKCoreEngine, temporal_barabasi_albert
from repro_torch.temporal.replay import record_step

SLOTS = ("row_off", "src", "dst", "live", "hole", "deg")


def _state(rng):
    return {
        "b": {"z": rng.integers(0, 9, (3, 4)).astype(np.int32),
              "a": np.asarray(7, np.int64)},
        "a": [rng.random(5), torch.arange(6, dtype=torch.int32).reshape(2, 3)],
        "c": np.zeros((0, 2), bool),
    }


def test_save_latest_restore_round_trip(tmp_path):
    state = _state(np.random.default_rng(0))
    assert latest_step(tmp_path) is None and latest_step(tmp_path / "missing") is None
    path = save_checkpoint(tmp_path, 3, state)
    assert path.endswith("step_000000003")
    save_checkpoint(tmp_path, 12, state)
    assert latest_step(tmp_path) == 12
    out, step = restore_checkpoint(tmp_path, state)
    assert step == 12
    np.testing.assert_array_equal(out["b"]["z"], state["b"]["z"])
    assert out["b"]["z"].dtype == np.int32 and isinstance(out["b"]["z"], np.ndarray)
    assert int(out["b"]["a"]) == 7 and out["c"].shape == (0, 2) and out["c"].dtype == bool
    np.testing.assert_array_equal(out["a"][0], state["a"][0])
    t = out["a"][1]
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.dtype == torch.int32
    assert torch.equal(t, state["a"][1])
    out3, step3 = restore_checkpoint(tmp_path, state, step=3)
    assert step3 == 3 and out3.keys() == state.keys()
    manifest = json.loads((tmp_path / "step_000000012" / "manifest.json").read_text())
    assert manifest["n_leaves"] == 5 and manifest["step"] == 12
    # leaves in jax.tree's order: dict keys sorted, lists in order
    assert manifest["shapes"] == [[5], [2, 3], [], [3, 4], [0, 2]]
    assert manifest["dtypes"] == ["float64", "int32", "int64", "int32", "bool"]


def test_uncommitted_tmp_directory_is_ignored(tmp_path):
    state = _state(np.random.default_rng(1))
    save_checkpoint(tmp_path, 5, state)
    (tmp_path / "step_000000009.tmp").mkdir()        # a crash mid-write
    assert latest_step(tmp_path) == 5
    assert restore_checkpoint(tmp_path, state)[1] == 5
    save_checkpoint(tmp_path, 5, {"x": np.ones(2)})  # rewriting a step replaces it
    assert restore_checkpoint(tmp_path, {"x": np.zeros(2)})[0]["x"].tolist() == [1.0, 1.0]


def test_restore_refuses_a_leaf_count_mismatch_and_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, {"x": np.zeros(1)})
    save_checkpoint(tmp_path, 0, {"x": np.zeros(1), "y": np.zeros(2)})
    with pytest.raises(ValueError, match="leaf count mismatch"):
        restore_checkpoint(tmp_path, {"x": np.zeros(1)})
    with pytest.raises(ValueError, match="leaf count mismatch"):
        restore_checkpoint(tmp_path, {"x": np.zeros(1), "y": [np.zeros(2), np.zeros(3)]})


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_patchable_csr_checkpoint_crosses_the_packages(tmp_path, writer):
    """A PatchableCSR state written by one package's ``save_checkpoint``
    restores through the other's, bit for bit: the layout is shared."""
    g_ref = jax_gen.barabasi_albert(150, 3, seed=0)
    ref = jax_delta.PatchableCSR(g_ref, slack=0.5, min_slack=2)
    ref.apply_batch(jax_delta.random_churn_batch(g_ref, 20, 20, np.random.default_rng(3)))
    port = PatchableCSR.from_state(ref.state_dict(), slack=0.5, min_slack=2)
    if writer == "reference":
        jax_save(tmp_path, 4, ref.state_dict())
        state, step = restore_checkpoint(tmp_path, port.state_dict())
        restored = PatchableCSR.from_state(state, slack=0.5, min_slack=2)
    else:
        save_checkpoint(tmp_path, 4, port.state_dict())
        state, step = jax_restore(tmp_path, ref.state_dict())
        restored = jax_delta.PatchableCSR.from_state(
            {k: np.asarray(v) for k, v in state.items()}, slack=0.5, min_slack=2)
    assert step == 4
    for k in SLOTS:
        np.testing.assert_array_equal(getattr(restored, k), getattr(ref, k), err_msg=k)
    assert (restored.dead, restored.compactions, restored.m) == (ref.dead, ref.compactions, ref.m)
    manifest = json.loads((tmp_path / "step_000000004" / "manifest.json").read_text())
    assert manifest["n_leaves"] == 8
    assert manifest["dtypes"] == [str(np.asarray(v).dtype) for _, v in
                                  sorted(ref.state_dict().items())]


def _assert_lockstep(a, b, ra, rb):
    np.testing.assert_array_equal(a.core, b.core)
    np.testing.assert_array_equal(ra.stats.messages_per_round, rb.stats.messages_per_round)
    np.testing.assert_array_equal(ra.stats.active_per_round, rb.stats.active_per_round)
    assert (ra.rounds, ra.region_size, ra.seed_changed, ra.mode, ra.seed_strategy,
            ra.csr_compactions) == (rb.rounds, rb.region_size, rb.seed_changed, rb.mode,
                                    rb.seed_strategy, rb.csr_compactions)


def test_engine_checkpoint_round_trip(tmp_path):
    """Checkpoint mid-stream, restore, and both engines agree batch by batch:
    the same cores (BZ-exact), the same CSR slots, no decomposition."""
    rng = np.random.default_rng(1)
    eng = StreamingKCoreEngine(gen.barabasi_albert(200, 3, seed=1),
                               StreamingConfig(frontier="fused"), device="cpu")
    for _ in range(3):
        eng.apply_batch(random_churn_batch(eng.graph, 8, 8, rng))
    save_checkpoint(tmp_path, eng.batches_applied, eng.state_dict())
    state, step = restore_checkpoint(tmp_path, eng.state_dict())
    assert step == 3
    eng2 = StreamingKCoreEngine.from_state_dict(state, StreamingConfig(frontier="fused"),
                                                device="cpu")
    assert eng2.init_result is None and eng2.batches_applied == eng.batches_applied
    np.testing.assert_array_equal(eng2.core, eng.core)
    for k in SLOTS:
        np.testing.assert_array_equal(getattr(eng2.csr, k), getattr(eng.csr, k))
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        ra = eng.apply_batch(random_churn_batch(eng.graph, 6, 6, rng_a))
        rb = eng2.apply_batch(random_churn_batch(eng2.graph, 6, 6, rng_b))
        _assert_lockstep(eng, eng2, ra, rb)
        np.testing.assert_array_equal(eng2.core, bz_core_numbers(eng2.graph))


def test_restore_across_frontier_modes(tmp_path):
    """A checkpoint is mode-agnostic: state captured under one frontier
    restores under another (all modes are exact-equal)."""
    eng = StreamingKCoreEngine(gen.erdos_renyi(n=150, m=600, seed=2),
                               StreamingConfig(frontier="dense"), device="cpu")
    eng.apply_batch(random_churn_batch(eng.graph, 5, 5, np.random.default_rng(3)))
    save_checkpoint(tmp_path, eng.batches_applied, eng.state_dict())
    state, _ = restore_checkpoint(tmp_path, eng.state_dict())
    eng2 = StreamingKCoreEngine.from_state_dict(state, StreamingConfig(frontier="compact"),
                                                device="cpu")
    np.testing.assert_array_equal(eng2.core, eng.core)
    batch = random_churn_batch(eng2.graph, 5, 5, np.random.default_rng(4))
    ra, rb = eng.apply_batch(batch), eng2.apply_batch(batch)
    assert rb.mode == "compact"
    np.testing.assert_array_equal(ra.core, rb.core)
    np.testing.assert_array_equal(ra.stats.messages_per_round, rb.stats.messages_per_round)
    np.testing.assert_array_equal(eng2.core, bz_core_numbers(eng2.graph))


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_window_checkpoint_resumes_the_replay_in_lockstep(tmp_path, mode):
    """A window checkpointed mid-replay and restored into a fresh
    ``WindowedKCoreEngine`` over the same log continues with the same
    batches, cores and bills as the window that was never stopped."""
    log = temporal_barabasi_albert(300, 3, seed=2, remove_frac=0.15)
    config = StreamingConfig(frontier=mode)
    a = WindowedKCoreEngine(log, 240, 60, config=config, device="cpu")
    for _ in range(4):
        a.advance()
    save_checkpoint(tmp_path, a.steps_taken, a.state_dict())
    b = WindowedKCoreEngine(log, 240, 60, config=config, device="cpu")
    state, step = restore_checkpoint(tmp_path, b.state_dict())
    assert step == 4
    b.load_state_dict(state)
    assert b.engine.init_result is None and b.steps_taken == 4 and b.bounds == a.bounds
    np.testing.assert_array_equal(b.window_edges, a.window_edges)
    assert not b.window_edges.flags.writeable
    while not a.done:
        wa, wb = a.advance(), b.advance()
        assert (wa.step, wa.lo, wa.hi, wa.m) == (wb.step, wb.lo, wb.hi, wb.m)
        np.testing.assert_array_equal(wa.batch.insert, wb.batch.insert)
        np.testing.assert_array_equal(wa.batch.delete, wb.batch.delete)
        _assert_lockstep(a, b, wa.result, wb.result)
        ra, rb = record_step(wa, 0.0, None), record_step(wb, 0.0, None)
        assert (ra.messages, ra.rounds, ra.core_max, ra.csr_dead_frac) == \
            (rb.messages, rb.rounds, rb.core_max, rb.csr_dead_frac)
    assert b.done and b.steps_taken == a.steps_taken > 6
    np.testing.assert_array_equal(b.core, bz_core_numbers(b.window_graph()))
