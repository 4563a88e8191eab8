"""Fault-tolerant training driver (the port of ``repro.runtime.driver``).

  * checkpoint/restart: a periodic save through ``repro_torch.checkpoint``
    (atomic commit); a start always resumes from the newest COMMITTED step.
  * failure handling: ``make_failure_injector`` simulates a host loss at a
    given step (it raises ``HostFailure``); a relaunched driver restores and
    continues, and the continuation is bit-exact: the data are a function of
    the step, the restored state holds the saved dtypes, and the float
    segment sum adds in a fixed order.
  * straggler flags: each step's wall ends with a synchronize of the card
    (``block_until_ready`` in the reference); a step longer than
    ``straggler_factor`` x the median of the last 50 is flagged once more
    than 5 steps are timed.

The state is a tree of dicts, lists and tensors (``repro_torch.tree``): the
reference's ``(params, opt_state)`` tuple is the list ``[params,
opt_state]`` here. A tuple is refused, since ``tree.leaves`` takes it as one
leaf; a list walks as ``jax.tree`` walks the tuple, so checkpoints keep the
reference's leaf order and cross between the packages both ways. There is
no ``state_shardings`` (no mesh; ROADMAP.md Queue A item 12b).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainDriverConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    straggler_factor: float = 3.0      # step_time > factor x median -> flag


def _sync(state) -> None:
    """Wait for the card the state's first tensor lives on, if any."""
    first = next((x for x in leaves(state) if isinstance(x, torch.Tensor)), None)
    if first is not None and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)


class TrainDriver:
    def __init__(self, step_fn: Callable, init_state, batch_fn: Callable,
                 config: TrainDriverConfig,
                 failure_injector: Callable[[int], None] | None = None):
        """step_fn(state, batch) -> (state, metrics);
        batch_fn(step) -> batch (deterministic in step)."""
        if isinstance(init_state, tuple):
            raise TypeError("the driver's state must be a tree of dicts, lists and tensors; "
                            "pass [params, opt_state], not a tuple")
        self.step_fn = step_fn
        self.state = init_state
        self.batch_fn = batch_fn
        self.cfg = config
        self.failure_injector = failure_injector
        self.step = 0
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.metrics_log: list[dict] = []
        self.save_walls: list[float] = []
        self.restore_wall: float | None = None

    # -------------------------------------------------------------- #
    def maybe_restore(self) -> bool:
        if latest_step(self.cfg.checkpoint_dir) is None:
            return False
        t0 = time.perf_counter()
        self.state, self.step = restore_checkpoint(self.cfg.checkpoint_dir, self.state)
        _sync(self.state)
        self.restore_wall = time.perf_counter() - t0
        return True

    def run(self) -> dict:
        self.maybe_restore()
        while self.step < self.cfg.total_steps:
            if self.failure_injector is not None:
                self.failure_injector(self.step)   # may raise HostFailure
            t0 = time.perf_counter()
            batch = self.batch_fn(self.step)
            self.state, metrics = self.step_fn(self.state, batch)
            _sync(self.state)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > self.cfg.straggler_factor * med:
                self.stragglers.append(self.step)
            self.step += 1
            if self.step % self.cfg.checkpoint_every == 0 or \
                    self.step == self.cfg.total_steps:
                t1 = time.perf_counter()
                save_checkpoint(self.cfg.checkpoint_dir, self.step, self.state)
                self.save_walls.append(time.perf_counter() - t1)
            if self.step % self.cfg.log_every == 0:
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()} |
                    {"step": self.step, "step_time_s": dt})
        return {
            "final_step": self.step,
            "stragglers": self.stragglers,
            "metrics": self.metrics_log,
        }


class HostFailure(RuntimeError):
    """Simulated node loss."""


def make_failure_injector(fail_at_step: int):
    fired = {"done": False}

    def inject(step: int) -> None:
        if step == fail_at_step and not fired["done"]:
            fired["done"] = True
            raise HostFailure(f"simulated host loss at step {step}")

    return inject
