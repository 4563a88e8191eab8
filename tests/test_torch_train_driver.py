"""The port's data pipeline, fault-tolerant driver and training launchers
against the JAX package's, on the CPU.

- ``synth_lm_batch`` is bit-equal to the reference's over a grid of (seed,
  step) and shapes.
- The driver's failure and restart is bit-exact: a scalar state (the port of
  ``tests/test_substrate.py::test_driver_failure_restart_bitexact``, held to
  equality where the reference test allows rel 1e-6) and an LM's
  ``[params, opt_state]`` (parameters, moments, count and every logged
  loss).
- Straggler flags follow the reference's rule.
- A checkpoint of the driver's state written by either package restores in
  the other, leaf for leaf and dtype for dtype.
- ``python -m repro_torch.launch.train`` against ``repro.launch.train`` with
  the same flags, both from JAX's seed-0 weights (written for the port as a
  step-0 checkpoint in its ``--ckpt-dir``, where its driver resumes): the
  same steps and stragglers, and the first and last logged loss within 1e-3
  (each a float32 loss of bf16 logits; ``tests/test_torch_lm_train.py``
  holds a loss to 1e-3 and observed 30 steps within 9e-5).
"""

import pathlib
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs import get_smoke as jax_smoke
from repro.data import lm_batch_stream as jax_stream, synth_lm_batch as jax_synth
from repro.models.transformer import model as JM
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.data import lm_batch_stream, synth_lm_batch
from repro_torch.launch import train as T
from repro_torch.launch import train_lm_e2e
from repro_torch.models.transformer.convert import opt_state_from_jax, params_from_jax
from repro_torch.runtime import HostFailure, TrainDriver, TrainDriverConfig, make_failure_injector
from repro_torch.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("vocab,batch,seq", [(512, 4, 64), (151936, 2, 33), (8192, 8, 128),
                                             (64, 1, 1)])
def test_synth_lm_batch_is_bit_equal_to_the_reference(vocab, batch, seq):
    for seed in (0, 1, 7, 12345):
        for step in (0, 1, 2, 17, 999):
            got, want = synth_lm_batch(vocab, batch, seq, seed=seed, step=step), \
                jax_synth(vocab, batch, seq, seed=seed, step=step)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    s, r = lm_batch_stream(vocab, batch, seq, seed=3, start_step=5), \
        jax_stream(vocab, batch, seq, seed=3, start_step=5)
    for _ in range(3):
        for a, b in zip(next(s), next(r)):
            assert np.array_equal(a, b)


def _scalar_driver(ckdir, fail_at=None):
    def step_fn(state, batch):
        return state * 0.9 + batch, {"loss": state}

    def batch_fn(i):
        return torch.tensor(i % 5, dtype=torch.float32) * 0.01

    cfg = TrainDriverConfig(total_steps=30, checkpoint_every=5, checkpoint_dir=str(ckdir),
                            log_every=100)
    inj = make_failure_injector(fail_at) if fail_at else None
    return TrainDriver(step_fn, torch.tensor(1.0), batch_fn, cfg, failure_injector=inj)


def test_driver_failure_restart_bitexact(tmp_path):
    """Train 30 steps; crash at 17; restart from step 15; the final state
    equals an uninterrupted run's bit for bit."""
    ref = _scalar_driver(tmp_path / "ref")
    ref.run()
    d1 = _scalar_driver(tmp_path / "fail", fail_at=17)
    with pytest.raises(HostFailure, match="step 17"):
        d1.run()
    assert latest_step(tmp_path / "fail") == 15
    d2 = _scalar_driver(tmp_path / "fail")
    assert d2.maybe_restore() and d2.step == 15
    d2 = _scalar_driver(tmp_path / "fail")
    report = d2.run()
    assert report["final_step"] == 30 and torch.equal(d2.state, ref.state)
    assert d2.restore_wall is not None and len(d2.save_walls) == 3   # steps 20, 25, 30


def test_lm_driver_failure_restart_is_bit_exact(tmp_path):
    """The SMOKE LM through the driver: fail after the checkpoint of step 2,
    relaunch, finish step 5; parameters, AdamW moments and count, and every
    logged loss equal an uninterrupted run's."""
    cfg = get_smoke("qwen1.5-0.5b")
    dev = torch.device("cpu")

    def driver(ckdir, fail_at=None):
        return TrainDriver(T.make_step_fn(cfg, 5), T.make_state(cfg, 0, dev),
                           T.make_batch_fn(cfg.vocab, 4, 32, 0, dev),
                           TrainDriverConfig(total_steps=5, checkpoint_every=2,
                                             checkpoint_dir=str(ckdir), log_every=1),
                           failure_injector=make_failure_injector(fail_at) if fail_at else None)

    ref = driver(tmp_path / "ref")
    want = ref.run()
    first = driver(tmp_path / "fail", fail_at=3)
    with pytest.raises(HostFailure):
        first.run()
    second = driver(tmp_path / "fail")
    got = second.run()
    assert second.restore_wall is not None and got["final_step"] == 5
    logged = first.metrics_log[:2] + second.metrics_log
    assert [m["step"] for m in logged] == [1, 2, 3, 4, 5] == [m["step"] for m in want["metrics"]]
    assert [m["loss"] for m in logged] == [m["loss"] for m in want["metrics"]]
    for a, b in zip(leaves(second.state), leaves(ref.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert second.state[1]["count"].dtype == torch.int32 and int(second.state[1]["count"]) == 5


def test_straggler_flags(tmp_path):
    """A step longer than 3x the median of the last 50 is flagged, once more
    than 5 steps are timed: step 8 is, step 2 (the third timed) is not."""
    slow = {2: 1.0, 8: 1.0}

    def step_fn(state, batch):
        time.sleep(slow.get(batch, 0.05))
        return state, {"loss": torch.tensor(0.0)}

    d = TrainDriver(step_fn, [torch.zeros(1)], lambda i: i,
                    TrainDriverConfig(total_steps=12, checkpoint_every=100,
                                      checkpoint_dir=str(tmp_path), log_every=100))
    assert d.run()["stragglers"] == [8]
    assert len(d.step_times) == 12 and latest_step(tmp_path) == 12


def test_driver_refuses_a_tuple_state():
    with pytest.raises(TypeError, match="not a tuple"):
        TrainDriver(lambda s, b: (s, {}), (torch.zeros(1), torch.zeros(1)), lambda i: i,
                    TrainDriverConfig())


def _jax_state(cfg):
    params = JM.init_params(cfg, jax.random.key(0))
    return params, jax_adamw_init(params)


def test_driver_checkpoints_cross_between_the_packages(tmp_path):
    """``[params, opt_state]`` saved by the port restores into the
    reference's ``(params, opt_state)`` and the other way, every leaf equal
    in value and dtype (the AdamW count int32)."""
    cfg, pcfg = jax_smoke("yi-34b"), get_smoke("yi-34b")
    jstate = _jax_state(cfg)
    jstate = (jstate[0], dict(jstate[1], count=jnp.int32(7)))
    save = jax.tree.map(np.asarray, jstate)
    pstate = [params_from_jax(save[0], pcfg, device="cpu"),
              opt_state_from_jax(save[1], pcfg, device="cpu")]
    # port -> reference
    save_checkpoint(tmp_path / "p", 3, pstate)
    back, step = jax_checkpoint.restore_checkpoint(tmp_path / "p", jstate)
    assert step == 3
    for a, b in zip(jax.tree.leaves(back), leaves(pstate)):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())
    # reference -> port
    jax_checkpoint.save_checkpoint(tmp_path / "j", 4, jstate)
    like = T.make_state(pcfg, 1, torch.device("cpu"))
    got, step = restore_checkpoint(tmp_path / "j", like)
    assert step == 4 and isinstance(got, list)
    for a, b in zip(leaves(got), jax.tree.leaves(jstate)):
        assert a.numpy().dtype == np.asarray(b).dtype and np.array_equal(a.numpy(), np.asarray(b))
    assert int(got[1]["count"]) == 7 and got[1]["count"].dtype == torch.int32


def _last_line(text: str) -> dict:
    m = re.search(r"arch=(\S+) steps=(\d+) loss: (\S+) -> (\S+) stragglers=(\d+)",
                  text.strip().splitlines()[-1])
    assert m, text
    return {"arch": m[1], "steps": int(m[2]), "first": float(m[3]), "last": float(m[4]),
            "stragglers": int(m[5])}


def test_train_launcher_matches_the_reference(tmp_path, monkeypatch, capsys):
    flags = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "20", "--batch", "4", "--seq", "64"]
    import repro.launch.train as jax_train

    monkeypatch.setattr(sys, "argv", ["train", *flags, "--ckpt-dir", str(tmp_path / "jax")])
    jax_train.main()
    want = _last_line(capsys.readouterr().out)
    # JAX's seed-0 weights and fresh AdamW state as the port's step-0 checkpoint
    jax_checkpoint.save_checkpoint(tmp_path / "port", 0, _jax_state(jax_smoke("qwen1.5-0.5b")))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *flags, "--device",
                          "cpu", "--ckpt-dir", str(tmp_path / "port")], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2].startswith("device: cpu") and "ms a step" in lines[-2]
    got = _last_line(out.stdout)
    assert (got["arch"], got["steps"], got["stragglers"]) == \
        ("qwen1.5-0.5b-smoke", want["steps"], want["stragglers"]) == ("qwen1.5-0.5b-smoke", 20, 0)
    assert abs(got["first"] - want["first"]) <= 1e-3 and abs(got["last"] - want["last"]) <= 1e-3
    assert latest_step(tmp_path / "port") == 20


def test_train_launcher_with_no_logged_loss_exits_with_a_message(tmp_path, capsys):
    """Fewer than 10 steps log no loss: the reference raises IndexError, the
    port exits with a message (ROADMAP.md Queue C)."""
    flags = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "3", "--batch", "2", "--seq", "16"]
    with pytest.raises(SystemExit, match="no loss was logged"):
        T.main([*flags, "--device", "cpu", "--ckpt-dir", str(tmp_path / "p")])
    import repro.launch.train as jax_train

    with pytest.raises(IndexError):
        old = sys.argv
        sys.argv = ["train", *flags, "--ckpt-dir", str(tmp_path / "j")]
        try:
            jax_train.main()
        finally:
            sys.argv = old


def test_train_launcher_refuses_what_it_does_not_run():
    for argv, code in [(["--arch", "din", "--smoke", "--device", "cpu"], "LM family"),
                       (["--arch", "no-such-arch", "--device", "cpu"], None)]:
        with pytest.raises(SystemExit) as e:
            T.parse_args(argv)
        if code:
            assert code in str(e.value)


def test_train_lm_e2e_learns_in_a_few_steps(tmp_path, capsys):
    train_lm_e2e.main(["--layers", "2", "--d-model", "128", "--steps", "10", "--batch", "4",
                       "--seq", "64", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("params: 1.4M") and "loss curve:" in out
    first, last = map(float, re.search(r"OK: (\S+) -> (\S+)", out).groups())
    assert last < first
    assert latest_step(tmp_path) == 10


def test_restore_reads_the_archive_in_place_and_checks_its_crcs(tmp_path):
    """The memory-mapped restore gives ``np.load``'s arrays for leaves of
    every kind (float16 to int64 at unaligned offsets in the archive, a
    Fortran-ordered array, an empty tensor, a 0-d bool), and refuses an
    archive whose bytes changed after the save."""
    import zipfile

    state = {"a": torch.arange(5.0), "b": [torch.ones(2, 3, dtype=torch.float16),
                                           np.arange(4, dtype=np.int64)],
             "c": torch.tensor(7, dtype=torch.int32), "e": torch.zeros(0, 3),
             "f": np.asfortranarray(np.arange(6.0).reshape(2, 3)), "g": np.bool_(True)}
    save_checkpoint(tmp_path, 1, state)
    path = tmp_path / "step_000000001" / "arrays.npz"
    with zipfile.ZipFile(path) as zf:
        assert all(i.compress_type == zipfile.ZIP_STORED for i in zf.infolist())
    got, step = restore_checkpoint(tmp_path, state)
    with np.load(path) as want:
        for i, (a, ref) in enumerate(zip(leaves(got), leaves(state))):
            w = want[f"leaf_{i}"]
            assert isinstance(a, torch.Tensor) == isinstance(ref, torch.Tensor)
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            assert a.dtype == w.dtype and a.shape == w.shape and np.array_equal(a, w)
    assert got["f"].flags.f_contiguous and step == 1
    raw = bytearray(path.read_bytes())
    at = bytes(raw).index(np.arange(5, dtype=np.float32).tobytes())   # leaf "a"'s data
    raw[at + 9] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32 mismatch in leaf_0"):
        restore_checkpoint(tmp_path, state)
