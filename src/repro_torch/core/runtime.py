"""Fused convergence runtime: the round loop with its bills on the device.

The port of ``repro.core.runtime`` (``FusedOutcome``, ``_finish``,
``fused_converge_dense``, ``fused_converge_sharded``).
``kcore_decompose(..., fused=True)`` and ``kcore_decompose_sharded(...,
fused=True)`` run the paper's from-scratch decomposition through here (seed
= degrees, frontier = everyone), the streaming engine each batch's
re-convergence (seed = warm-start bound, frontier = the batch's touched
set). Per round the loop keeps messages, changed and receiver counts in
device buffers and reads back the round's changed and receiver counts
(summed over the processes of a mesh); the host reconstructs the
exact per-round ``MessageStats`` at the end, bit-equal to what the host loop
appends round by round. The loop is driven from the host: a CUDA graph or a
persistent kernel that keeps the stop test on the device is later work.

Every fused run is observable: a ``fused-converge`` span wraps the run with
``stage`` (host-to-device copies), ``device-converge`` (the loop, ended by a
device synchronize so the span owns the device wall) and
``stats-reconstruct`` children. The phase walls are also measured
unconditionally into ``FusedOutcome`` (a few ``perf_counter`` reads per run).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.kcore import _fused_sharded_convergence, fused_round_stats
from repro_torch.distribution import compat
from repro_torch.kernels import _build
from repro_torch.obs import flight, trace


@dataclasses.dataclass
class FusedOutcome:
    """Host-side result of one fused convergence run.

    ``msgs`` / ``changed`` / ``recv`` cover exactly the PRODUCTIVE rounds —
    the arrays a host round loop would have appended — while ``rounds``
    counts every executed superstep including the final unproductive one
    (the host-loop convention).
    """

    est: np.ndarray  # (n,) int32 final estimates (exact cores on convergence)
    rounds: int
    converged: bool
    msgs: np.ndarray  # (k,) int64 messages per productive round
    changed: np.ndarray  # (k,) int64 senders per productive round
    recv: np.ndarray  # (k,) int64 receivers per productive round
    # phase walls (always measured):
    device_s: float = 0.0  # the loop, ended by a device synchronize
    reconstruct_s: float = 0.0  # host-side stats/est reconstruction
    compile_delta: int = 0  # kernel-library builds this run caused
    compile_s: float = 0.0  # ... and the wall nvcc spent on them
    # which superstep ran: "kernel" (CUDA kernels) or "torch" (plain
    # versions on the CPU). Execution placement only.
    dispatch: str = "torch"
    stage_s: float = 0.0  # staging arcs and ELL tiles on the device


def _finish(span, raw, t_dev, builds0, bsecs0, est_of, dispatch, frontier1=None,
            seed=None, stage_s=0.0):
    """Shared tail of a fused run: time phases, reconstruct, record."""
    t0 = time.perf_counter()
    r, stop, final_act, mb, cb, rb = raw
    _k, m_r, c_r, r_r, converged = fused_round_stats(r, stop, final_act, mb, cb, rb)
    est = est_of()
    reconstruct_s = time.perf_counter() - t0
    outcome = FusedOutcome(
        est=est,
        rounds=int(r),
        converged=converged,
        msgs=m_r,
        changed=c_r,
        recv=r_r,
        device_s=t_dev,
        reconstruct_s=reconstruct_s,
        compile_delta=_build.build_count() - builds0,
        compile_s=_build.build_seconds() - bsecs0,
        dispatch=dispatch,
        stage_s=stage_s,
    )
    span.set(
        rounds=outcome.rounds,
        messages=int(outcome.msgs.sum()),
        converged=outcome.converged,
        compile_delta=outcome.compile_delta,
        compile_s=round(outcome.compile_s, 6),
    )
    # flight capture, reconstructed post-hoc from the stat buffers: exactly
    # the rounds a host loop would have recorded, same accounting arrays
    rec = flight.recorder()
    if rec.active:
        rec.record_fused_rounds(
            outcome.msgs,
            outcome.changed,
            outcome.recv,
            frontier1=int(frontier1) if frontier1 is not None else (
                int(outcome.recv[0]) if len(outcome.recv) else 0
            ),
            device_s=t_dev,
            compiles=outcome.compile_delta,
            dispatch=dispatch,
            seed=seed,
            final=est,
        )
    return outcome


def _flight_inputs(seed, active, frontier1):
    """The flight recorder's round-1 frontier and a host copy of the seed,
    resolved before any device work: the accounting frontier (callers pass
    it when their loop's activation differs from the accounting convention)
    and the seed for the aggregate drop histogram. ``(frontier1, None)``
    when the recorder is off."""
    if not flight.recorder().active:
        return frontier1, None
    if frontier1 is None:
        frontier1 = int(np.asarray(active).sum())
    return frontier1, np.asarray(seed, np.int64).copy()


def fused_converge_dense(seed, active, src, dst, arc_mask, deg, *, n, n_iters, max_rounds,
                         device=None, ell=None, frontier1=None, row_ptr=None):
    """Single-device fused convergence over arc arrays, from an arbitrary
    seed and frontier. ``arc_mask`` None: every arc is live. With
    ``row_ptr`` given, ``(src, dst, row_ptr)`` is already the triple of
    ``dispatch.stage_arcs`` on the device (the streaming engine stages its
    live arcs once a batch) and is used as it is.

    ``src`` must be sorted (CSR order). With the static degree-bucketed
    ``ell`` layout the h-index runs through the ``kcore_hindex`` route
    (from-scratch decompositions only: every arc live, degree-0 vertices at
    estimate 0); with ``ell=None`` through the segment-sum binary search.
    ``device`` defaults to CUDA (see ``platform.resolve_device``).
    Accounting is bit-equal across routes and devices.
    """
    builds0, bsecs0 = _build.build_count(), _build.build_seconds()
    plan = _dispatch.resolve_plan(device)
    dev = plan.device
    frontier1, seed_np = _flight_inputs(seed, active, frontier1)
    with trace.span("fused-converge", n=n, max_rounds=max_rounds, dispatch=plan.kind) as span:
        with trace.span("stage"):
            t0 = time.perf_counter()
            prog = _dispatch.fused_convergence_program(n, n_iters, max_rounds, plan, src, dst,
                                                       ell=ell, row_ptr=row_ptr)
            inputs = (
                torch.as_tensor(seed, dtype=torch.int32, device=dev),
                None if arc_mask is None else torch.as_tensor(arc_mask, dtype=torch.bool,
                                                              device=dev),
                torch.as_tensor(active, dtype=torch.bool, device=dev),
                torch.as_tensor(deg, dtype=torch.int32, device=dev),
            )
            stage_s = time.perf_counter() - t0
        with trace.span("device-converge"):
            t0 = time.perf_counter()
            est_t, r, stop, final_act, mb, cb, rb = prog(*inputs)
            # synchronize INSIDE the span: kernels run asynchronously, and
            # without it the device wall would land on the first host copy
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_dev = time.perf_counter() - t0
        with trace.span("stats-reconstruct"):
            return _finish(
                span,
                (r, stop, final_act, mb, cb, rb),
                t_dev,
                builds0,
                bsecs0,
                lambda: est_t.cpu().numpy().astype(np.int32),
                plan.kind,
                frontier1=frontier1,
                seed=seed_np,
                stage_s=stage_s,
            )


def fused_converge_sharded(seed, active, sg, mesh, axis_names, *, n, n_iters, max_rounds,
                           frontier1=None):
    """Fused convergence with the masked sharded superstep inside, on the
    mesh's device.

    ``sg`` is a ``graph.partition.ShardedGraph`` over the mesh's shards
    (``shard_graph`` for the static engine, ``shard_arc_arrays`` over the
    live CSR arcs for the streaming engine); ``seed``/``active`` are plain
    (n,) host vectors, padded to the shard layout here. On a mesh across
    processes every rank calls this with the same graph and host vectors:
    each stages only its own shards (``compat.stage_to_mesh``), the
    per-round counts are summed over the ranks, and the estimates come back
    through ``compat.fetch_replicated``. Same ``FusedOutcome`` as
    ``fused_converge_dense``; accounting is bit-equal to every single-process
    mode.
    """
    from repro_torch.core import dispatch as _dispatch

    builds0, bsecs0 = _build.build_count(), _build.build_seconds()
    plan = _dispatch.resolve_plan(mesh.device)
    frontier1, seed_np = _flight_inputs(seed, active, frontier1)
    with trace.span("fused-converge", n=n, max_rounds=max_rounds, dispatch=plan.kind,
                    mesh_devices=sg.n_shards,
                    multiprocess=compat.is_multiprocess_mesh(mesh)) as span:
        with trace.span("stage"):
            t0 = time.perf_counter()
            st = _dispatch.stage_shards(sg, mesh, axis_names)
            shape = (sg.n_shards, sg.verts_per_shard)
            est_p = np.zeros(sg.n_pad, np.int32)
            est_p[:n] = seed
            act_p = np.zeros(sg.n_pad, bool)
            act_p[:n] = active
            est = compat.stage_to_mesh(est_p.reshape(shape), mesh).reshape(-1)
            act = compat.stage_to_mesh(act_p.reshape(shape), mesh).reshape(-1)
            stage_s = time.perf_counter() - t0
        with trace.span("device-converge"):
            t0 = time.perf_counter()
            est_t, r, stop, final_act, mb, cb, rb = _fused_sharded_convergence(
                st, n_iters, max_rounds)(est, act)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            t_dev = time.perf_counter() - t0
        with trace.span("stats-reconstruct"):
            return _finish(
                span,
                (r, stop, final_act, mb, cb, rb),
                t_dev,
                builds0,
                bsecs0,
                lambda: compat.fetch_replicated(est_t, mesh)[:n].astype(np.int32),
                plan.kind,
                frontier1=frontier1,
                seed=seed_np,
                stage_s=stage_s,
            )
