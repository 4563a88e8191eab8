"""Distributed k-core decomposition — the paper's algorithm, in PyTorch.

The port of ``repro.core.kcore`` for the paper's from-scratch decomposition.
Montresor-style locality iteration: every vertex keeps a monotonically
decreasing estimate, initialized to its degree; each round it recomputes

    est'(u) = H( { min(est(v), est(u)) : v in adj(u) } )

where H is the h-index operator, and "sends" its new value to all neighbors
when it decreased. The fixpoint equals the exact core numbers (locality
theorem, §II.B of the paper).

Execution modes, as in the reference:

  * ``jacobi``   — paper-faithful synchronous rounds. Every backend
                   (``segment``, ``ell``, ``ell_pallas``) runs the same
                   superstep here: the h-index of every degree-bucket row
                   through ``kcore_hindex`` (the reference's ELL layout) and
                   the receivers through ``segment_sum``; the backend only
                   names the run. Driven by a host loop that reads each
                   round's changed vector back (``kcore_decompose``), or by
                   the fused loop whose per-round bills stay on the device
                   (``fused_convergence`` and ``core/runtime.py``).
  * ``block_gs`` — beyond-paper block-Gauss-Seidel: ``n_blocks`` vertex
                   blocks swept in order within a round, each reading the
                   estimates the blocks before it wrote (the binary search
                   with ``segment_sum`` hit counts per block). Host loop only.

Distribution: ``kcore_decompose_sharded`` runs the jacobi superstep over a
mesh of shards (``distribution/compat.py``): vertex state split by
contiguous range, arcs co-located with their source (``graph/partition.py``),
one all_gather of the estimate vector per round (this IS the paper's message
broadcast), counts purely local over the process's shards stacked into one
CSR, termination a sum over the mesh. On one process the gathers and sums
are the shards' own arrays; across processes they are gloo collectives.

``core/dispatch.py`` builds the supersteps: on CUDA they run the
hand-written kernels, on the CPU their plain PyTorch versions. Cores and
per-round ``MessageStats`` are bit-equal to the reference's in every mode.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.messages import MessageStats
from repro_torch.distribution import compat
from repro_torch.graph.structs import Graph, build_ell
from repro_torch.kernels import _build
from repro_torch.kernels.kcore_hindex.ref import hindex_rows_ref  # noqa: F401  (binary-search oracle)
from repro_torch.kernels.segment_sum.ops import segment_sum
from repro_torch.obs import flight as _flight
from repro_torch.obs import trace as _trace
from repro_torch.platform import resolve_device

MODES = ("jacobi", "block_gs")
BACKENDS = ("segment", "ell", "ell_pallas")


# ---------------------------------------------------------------------- #
# Config / result
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class KCoreConfig:
    mode: str = "jacobi"            # "jacobi" | "block_gs"
    backend: str = "segment"        # "segment" | "ell" | "ell_pallas"
    n_blocks: int = 8               # block_gs sweep granularity
    max_rounds: int | None = None   # None → n + 1 (the worst-case depth)
    widths: tuple[int, ...] = (8, 32, 128, 512, 2048)   # ELL bucket widths
    # run the round loop with its per-round bills kept on the device
    # (core/runtime.py) instead of reading each round's changed vector back;
    # jacobi only, and accounting is bit-equal either way
    fused: bool = False


@dataclasses.dataclass
class KCoreResult:
    core: np.ndarray
    rounds: int
    converged: bool
    stats: MessageStats
    # kernel-library builds this decomposition caused (nvcc runs; 0 = every
    # kernel was already built), and the wall they took
    recompiles: int = 0
    compile_s: float = 0.0
    # per-phase wall breakdown (seconds): "stage" (ELL layout and host-to-
    # device copies), then "converge" for the host loop, or the fused
    # runtime's "device-converge" and "host-reconstruct"
    phase_s: dict = dataclasses.field(default_factory=dict)
    # which superstep ran: "kernel" (the CUDA kernels) or "torch" (their
    # plain versions, on the CPU) — bills are bit-equal either way
    dispatch: str = "torch"


def _bs_iters(max_deg: int) -> int:
    """Static binary-search iteration count covering estimates in [0, maxdeg]."""
    return max(int(np.ceil(np.log2(max_deg + 1))) + 1, 1)


# ---------------------------------------------------------------------- #
# The masked Jacobi superstep — segment route
# ---------------------------------------------------------------------- #

def _hindex_by_bsearch(est, est_dst_masked, src, row_ptr, n_iters):
    """Vectorized per-vertex h-index via binary search.

    For every vertex u, finds max k in [0, est_u] with
    |{arcs (u,v): est_v >= k}| >= k. Arcs are sorted by source with CSR
    offsets ``row_ptr``; ``est_dst_masked`` must be 0 on dead arcs (so they
    never count for k >= 1). The hit counts are segment sums.
    """
    lo = torch.zeros_like(est)
    hi = est
    for _ in range(n_iters):
        mid = (lo + hi + 1) // 2
        mid_src = mid.index_select(0, src)
        hit = (est_dst_masked >= mid_src) & (mid_src > 0)
        ok = segment_sum(hit.to(torch.int32), row_ptr) >= mid
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo


def _receivers(changed, dst, row_ptr, arc_mask=None):
    """Who receives a message next round: u such that a live neighbor
    changed — a segment sum of ``changed[dst]`` over u's arcs
    (``arc_mask`` None: every arc is live)."""
    hit = changed.index_select(0, dst)
    if arc_mask is not None:
        hit &= arc_mask
    return segment_sum(hit.to(torch.int32), row_ptr) > 0


def _finish_round(est, h, active, dst, row_ptr, arc_mask):
    """Apply the h-index to the active vertices; bill senders and receivers."""
    new_est = torch.where(active, h, est)
    changed = new_est < est
    return new_est, changed, _receivers(changed, dst, row_ptr, arc_mask)


def masked_round_segment(est, src, dst, row_ptr, arc_mask, active, n_iters):
    """One frontier-masked Jacobi superstep. Returns (new_est, changed, recv).

    Only vertices with ``active`` True recompute their h-index; everyone else
    keeps their estimate. With ``active`` all-True this is the paper's plain
    synchronous superstep. The masked form is exact for the monotone
    locality operator (an inactive vertex's inputs are unchanged).
    ``arc_mask`` None: every arc is live.
    """
    est_dst = est.index_select(0, dst)
    if arc_mask is not None:
        est_dst = torch.where(arc_mask, est_dst, 0)
    h = _hindex_by_bsearch(est, est_dst, src, row_ptr, n_iters)
    return _finish_round(est, h, active, dst, row_ptr, arc_mask)


# ---------------------------------------------------------------------- #
# Fused convergence — bills stay on the device
# ---------------------------------------------------------------------- #

def _fused_loop(round_body, est, active, deg, max_rounds, psum=lambda t: t):
    """Run ``round_body(est, active) -> (est', changed, recv)`` to the fixpoint.

    The reference's ``lax.while_loop`` contract, driven from the host: per
    executed round r three ``(max_rounds,)`` int32 device buffers receive
    messages (Σ deg over changed vertices), the changed count and the
    receiver count; the next frontier is this round's receivers. The host
    reads the round's changed and receiver counts once a round (changed
    anything? receivers left?), where the reference's loop tests the same
    on the device. On a mesh across processes ``psum`` sums the counts over
    the ranks before they are stored or read, so every rank leaves on the
    same round.

    Returns ``(est', rounds, stopped, final_active, msgs_buf, changed_buf,
    recv_buf)``: ``rounds`` counts every executed superstep including a
    final unproductive one, ``stopped`` is True iff the loop exited on an
    unproductive round, ``final_active`` is the exit frontier size.
    """
    bufs = torch.zeros((3, max_rounds), dtype=torch.int32, device=est.device)
    act, r, stop = active, 0, False
    n_active = int(psum(act.sum()))
    go = max_rounds > 0 and n_active > 0
    while go:
        est_new, changed, recv = round_body(est, act)
        counts = psum(torch.stack([torch.where(changed, deg, 0).sum(), changed.sum(),
                                   recv.sum()]))
        bufs[:, r] = counts
        n_changed, n_active = counts[1:].tolist()
        est, act, r = est_new, recv, r + 1
        stop = not n_changed
        go = not stop and r < max_rounds and n_active > 0
    return est, r, stop, n_active, bufs[0], bufs[1], bufs[2]


def fused_convergence(est, src, dst, row_ptr, arc_mask, active, deg,
                      n_iters, max_rounds):
    """Run masked Jacobi supersteps (segment route) to the fixpoint, with the
    per-round stat buffers on the device. Same contract as the reference's
    ``fused_convergence``; see ``_fused_loop``."""
    def body(e, a):
        return masked_round_segment(e, src, dst, row_ptr, arc_mask, a, n_iters)

    return _fused_loop(body, est, active, deg, max_rounds)


def _host_int64(buf: torch.Tensor, k: int) -> np.ndarray:
    return buf[:k].cpu().numpy().astype(np.int64)


def fused_round_stats(rounds, stopped, final_active,
                      msgs_buf, changed_buf, recv_buf):
    """Host-side reconstruction of per-round accounting from fused buffers.

    Returns ``(k, msgs, changed, recv, converged)``: ``k`` is the number of
    PRODUCTIVE rounds (the prefix whose changed count is non-zero — once a
    round changes nothing the loop stops, so productive rounds are always a
    prefix) and the three ``(k,)`` int64 arrays are exactly what the host
    loop would have appended round by round.
    """
    rounds = int(rounds)
    cb = _host_int64(changed_buf, rounds)
    k = int((cb > 0).sum())
    converged = bool(stopped) or int(final_active) == 0
    return (k, _host_int64(msgs_buf, k), cb[:k], _host_int64(recv_buf, k),
            converged)


# ---------------------------------------------------------------------- #
# Driver
# ---------------------------------------------------------------------- #

def kcore_decompose(g: Graph, config: KCoreConfig = KCoreConfig(), *,
                    fused: bool | None = None,
                    device: str | torch.device | None = None) -> KCoreResult:
    """Run distributed k-core decomposition to the fixpoint on one device.

    ``device`` defaults to CUDA and raises ``RuntimeError`` when there is
    none; pass ``device="cpu"`` to run the plain PyTorch versions of the
    kernels. Per-round message/active accounting follows the paper exactly
    (see core/messages.py). ``fused=True`` (keyword override of
    ``config.fused``) keeps the per-round bills on the device and
    reconstructs them afterwards, bit-equal to the host loop; it is
    jacobi-only (``ValueError`` otherwise), and the backend is only a name
    there, as in the reference.
    """
    dev = resolve_device(device)
    use_fused = config.fused if fused is None else fused
    if use_fused and config.mode != "jacobi":
        raise ValueError(f"fused=True requires mode='jacobi' (got {config.mode!r})")
    if config.mode not in MODES or (config.mode == "jacobi" and config.backend not in BACKENDS):
        raise ValueError(f"unsupported combo mode={config.mode} backend={config.backend}")
    with _trace.span("kcore.decompose", n=g.n, m=g.m, mode=config.mode,
                     backend=config.backend, fused=bool(use_fused),
                     device=str(dev)) as _sp:
        res = _decompose_body(g, config, use_fused, dev)
        _sp.set(rounds=res.rounds, messages=res.stats.total_messages,
                converged=res.converged, recompiles=res.recompiles,
                compile_s=round(res.compile_s, 6), dispatch=res.dispatch)
    return res


def _decompose_body(g: Graph, config: KCoreConfig, use_fused: bool,
                    dev: torch.device) -> KCoreResult:
    from repro_torch.core import dispatch as _dispatch

    builds0, bsecs0 = _build.build_count(), _build.build_seconds()
    plan = _dispatch.resolve_plan(dev)
    phase_s: dict = {}
    n = g.n
    if n == 0:
        return KCoreResult(core=np.zeros(0, np.int32), rounds=0,
                           converged=True,
                           stats=MessageStats(*(np.zeros(0, np.int64),) * 3),
                           dispatch=plan.kind)
    n_iters = _bs_iters(g.max_deg)
    max_rounds = config.max_rounds if config.max_rounds is not None else n + 1
    deg64 = g.deg.astype(np.int64)

    msgs = [int(deg64.sum())]             # round 0: degree broadcast = 2m
    # active[r] = vertices recomputing in round r. Round 0: all (they all
    # broadcast); round 1: every vertex that received the degree broadcast.
    active = [n, int((g.deg > 0).sum())]
    changed_counts = [n]

    # flight recorder: one run per decomposition, round 0 = the degree
    # broadcast. Disabled path = one attribute read; every est host copy
    # and per-round clock below is guarded by rec.active.
    rec = _flight.recorder()
    if rec.active:
        rec.start_run(
            "static",
            "fused" if use_fused else f"{config.mode}/{config.backend}",
            n=n)
        rec.record_round(active[0], msgs[0], changed_counts[0], est=g.deg)

    t_stage = time.perf_counter()
    if use_fused:
        from repro_torch.core.runtime import fused_converge_dense

        # static fully-live adjacency + degree seed: the ELL h-index route is
        # exact here (degree-0 vertices sit in no bucket and keep estimate 0)
        ell = build_ell(g, widths=config.widths)
        phase_s["stage"] = time.perf_counter() - t_stage
        # from-scratch seeding: est = degrees, frontier = every vertex.
        # frontier1: the loop activates everyone but the accounting bills
        # only (deg>0) receivers in round 1 — pass the accounting value so
        # flight records match the host loop bit-for-bit
        outcome = fused_converge_dense(
            g.deg, np.ones(n, bool), g.src, g.dst, None, g.deg,
            n=n, n_iters=n_iters, max_rounds=max_rounds,
            device=dev, ell=ell, frontier1=active[1])
        rounds, converged = outcome.rounds, outcome.converged
        msgs.extend(outcome.msgs.tolist())
        changed_counts.extend(outcome.changed.tolist())
        active.extend(outcome.recv.tolist())
        core = outcome.est
        phase_s["stage"] += outcome.stage_s
        phase_s["device-converge"] = outcome.device_s
        phase_s["host-reconstruct"] = outcome.reconstruct_s

    else:
        if config.mode == "block_gs":
            step = _dispatch.block_gs_round_program(n, g.src, g.dst, max(1, config.n_blocks),
                                                    n_iters, plan)
        else:
            prog = _dispatch.masked_round_program(n, n_iters, plan, g.src, g.dst,
                                                  ell=build_ell(g, widths=config.widths))
            everyone = torch.ones(n, dtype=torch.bool, device=dev)

            def step(est):
                return prog(est, None, everyone)

        est = torch.from_numpy(g.deg).to(dev)
        phase_s["stage"] = time.perf_counter() - t_stage
        rounds, converged = 0, False
        t_conv = time.perf_counter()
        while rounds < max_rounds:
            t_r = time.perf_counter() if rec.active else 0.0
            with _trace.span("kcore.round", round=rounds) as rsp:
                new_est, changed, recv = step(est)
                rounds += 1
                ch_np = changed.cpu().numpy()
                if not ch_np.any():
                    converged = True
                    break
                msgs.append(int(deg64[ch_np].sum()))
                changed_counts.append(int(ch_np.sum()))
                active.append(int(recv.sum()))
                rsp.set(messages=msgs[-1], changed=changed_counts[-1])
                if rec.active:
                    rec.record_round(
                        active[rounds], msgs[-1], changed_counts[-1],
                        est=new_est.cpu().numpy(), prev_est=est.cpu().numpy(),
                        host_s=time.perf_counter() - t_r,
                        dispatch=plan.kind)
                est = new_est
        phase_s["converge"] = time.perf_counter() - t_conv
        core = est.cpu().numpy().astype(np.int32)

    stats = MessageStats(
        messages_per_round=np.asarray(msgs, np.int64),
        active_per_round=np.asarray(active[: len(msgs)], np.int64),
        changed_per_round=np.asarray(changed_counts[: len(msgs)], np.int64),
    )
    if rec.active:
        rec.end_run(converged=converged, messages=int(stats.total_messages))
    return KCoreResult(core=core, rounds=rounds, converged=converged,
                       stats=stats,
                       recompiles=_build.build_count() - builds0,
                       compile_s=_build.build_seconds() - bsecs0,
                       phase_s=phase_s, dispatch=plan.kind)


# ---------------------------------------------------------------------- #
# Sharded superstep — the paper's distributed model
# ---------------------------------------------------------------------- #

def _sharded_round(st, est, active, n_iters, receivers=True):
    """One masked Jacobi superstep over the shards this process holds.

    ``st`` is ``dispatch.stage_shards``' staging of the layout contract of
    ``graph/partition.py`` (the local shards stacked into one CSR);
    ``est``/``active`` are the local shards' ``(L*V,)`` state (``active``
    None: everyone). Per round: one all_gather of the estimates over the
    mesh (the paper's message broadcast), ``est[dst]`` for the local arcs,
    the h-index by ``n_iters`` segment sums over the stacked local rows, and
    with ``receivers`` a 1-bit all_gather of the changed mask whose segment
    sum marks next round's receivers. Returns ``(est', changed, recv)``,
    all local (``recv`` None without ``receivers``).
    """
    mesh = st.mesh
    est_dst = torch.where(st.arc_mask, compat.all_gather(est, mesh).index_select(0, st.dst), 0)
    h = _hindex_by_bsearch(est, est_dst, st.src, st.row_ptr, n_iters)
    new = h if active is None else torch.where(active, h, est)
    changed = new < est
    if not receivers:
        return new, changed, None
    return new, changed, _receivers(compat.all_gather(changed, mesh), st.dst, st.row_ptr,
                                    st.arc_mask)


def _masked_sharded_superstep(st, n_iters):
    """Frontier-masked sharded superstep ``superstep(est, active) -> (est',
    changed, recv, msgs)`` over staged shards: est', changed and recv local,
    msgs (Σ deg over changed vertices) summed over the mesh. The streaming
    engine iterates it on a mesh."""
    def superstep(est, active):
        new, changed, recv = _sharded_round(st, est, active, n_iters)
        return new, changed, recv, compat.psum(torch.where(changed, st.deg, 0).sum(), st.mesh)

    return superstep


def make_sharded_superstep(sg, mesh, axis_names, n_iters: int, masked: bool = False):
    """Build a superstep over a mesh; returns ``(superstep, staged)``.

    ``sg`` is a ``graph.partition.ShardedGraph`` over ``mesh``'s shards;
    its arrays are staged once here (``dispatch.stage_shards``), where the
    reference passes them to its jitted shard_map on every call. State is
    the local shards' ``(L*V,)`` estimate vector. Per round: the est
    all_gather, est[dst] for local arcs, n_iters local segment sums (the
    binary-search h-index) and a psum of (messages, changed-any), the
    paper's heartbeat/termination. ``superstep(est) -> (est', msgs, any)``;
    with ``masked=True`` ``superstep(est, active) -> (est', changed, recv,
    msgs)`` (see ``_masked_sharded_superstep``).
    """
    from repro_torch.core import dispatch as _dispatch

    st = _dispatch.stage_shards(sg, mesh, axis_names)
    if masked:
        return _masked_sharded_superstep(st, n_iters), st

    def superstep(est):
        new, changed, _ = _sharded_round(st, est, None, n_iters, receivers=False)
        msgs, n_changed = compat.psum(
            torch.stack([torch.where(changed, st.deg, 0).sum(), changed.sum()]), mesh)
        return new, msgs, n_changed > 0

    return superstep, st


def _fused_sharded_convergence(st, n_iters: int, max_rounds: int):
    """Fused convergence over staged shards: ``prog(est, active) -> (est',
    rounds, stopped, final_active, msgs_buf, changed_buf, recv_buf)``, the
    contract of ``fused_convergence`` with est' local and the rest summed
    over the mesh. Per round the cross-process traffic is one est
    all_gather, one 1-bit changed all_gather and one psum of the round's
    three counts, whose sums every rank reads to decide the stop alike."""
    def prog(est, active):
        return _fused_loop(lambda e, a: _sharded_round(st, e, a, n_iters), est, active, st.deg,
                           max_rounds, psum=lambda t: compat.psum(t, st.mesh))

    return prog


def kcore_decompose_sharded(g: Graph, mesh, axis_names, max_rounds: int | None = None,
                            fused: bool = False) -> KCoreResult:
    """Run the sharded engine to convergence on ``mesh`` (any shard count,
    one shard included), on the mesh's device.

    Cores, rounds and per-round bills equal ``kcore_decompose``'s. The host
    loop reads each round's counts back; ``fused=True`` keeps them on the
    device (``core.runtime.fused_converge_sharded``). A mesh across
    processes takes the fused loop only (``ValueError`` otherwise).
    ``phase_s``: ``stage`` (the partition and its copy to the device), then
    ``converge``, or ``device-converge`` and ``host-reconstruct`` fused.
    """
    from repro_torch.core import dispatch as _dispatch
    from repro_torch.graph.partition import balance_report, shard_graph
    from repro_torch.obs import metrics as _metrics

    if compat.is_multiprocess_mesh(mesh) and not fused:
        # the host loop reads every round's state on one process
        raise ValueError("multi-process meshes require fused=True")
    builds0, bsecs0 = _build.build_count(), _build.build_seconds()
    plan = _dispatch.resolve_plan(mesh.device)
    n_dev = compat.shard_count(mesh, axis_names)
    t_stage = time.perf_counter()
    sg = shard_graph(g, n_dev)
    phase_s = {"stage": time.perf_counter() - t_stage}
    # straggler visibility: a round's wall is the slowest shard's
    _metrics.gauge("kcore_shard_imbalance").set(balance_report(sg)["imbalance"])
    n_iters = _bs_iters(g.max_deg)

    deg64 = g.deg.astype(np.int64)
    msgs = [int(deg64.sum())]
    active = [g.n, int((g.deg > 0).sum())]
    changed_counts = [g.n]
    cap = max_rounds if max_rounds is not None else g.n + 1

    rec = _flight.recorder()
    if rec.active:
        rec.start_run("static", "fused_sharded" if fused else "sharded", n=g.n)
        rec.record_round(active[0], msgs[0], changed_counts[0], est=g.deg)

    with _trace.span("kcore.decompose", n=g.n, m=g.m, mode="sharded", mesh_devices=n_dev,
                     fused=bool(fused), device=str(mesh.device)) as _sp:
        if fused:
            from repro_torch.core.runtime import fused_converge_sharded

            outcome = fused_converge_sharded(
                g.deg, np.ones(g.n, bool), sg, mesh, tuple(axis_names),
                n=g.n, n_iters=n_iters, max_rounds=cap, frontier1=active[1])
            rounds, converged = outcome.rounds, outcome.converged
            msgs.extend(outcome.msgs.tolist())
            changed_counts.extend(outcome.changed.tolist())
            active.extend(outcome.recv.tolist())
            core = outcome.est
            phase_s["stage"] += outcome.stage_s
            phase_s["device-converge"] = outcome.device_s
            phase_s["host-reconstruct"] = outcome.reconstruct_s
        else:
            t_stage = time.perf_counter()
            superstep, _ = make_sharded_superstep(sg, mesh, axis_names, n_iters, masked=True)
            est = compat.stage_to_mesh(sg.deg, mesh).reshape(-1)
            everyone = torch.ones_like(est, dtype=torch.bool)
            phase_s["stage"] += time.perf_counter() - t_stage
            rounds, converged = 0, False
            t_conv = time.perf_counter()
            while rounds < cap:
                t_r = time.perf_counter() if rec.active else 0.0
                with _trace.span("kcore.round", round=rounds) as rsp:
                    new_est, changed, recv, m = superstep(est, everyone)
                    rounds += 1
                    m, c, a = torch.stack([m, changed.sum(), recv.sum()]).tolist()
                    if not c:
                        converged = True
                        break
                    msgs.append(m)
                    changed_counts.append(c)
                    active.append(a)
                    rsp.set(messages=m, changed=c)
                    if rec.active:
                        rec.record_round(
                            a, m, c, est=compat.fetch_replicated(new_est, mesh)[: g.n],
                            prev_est=compat.fetch_replicated(est, mesh)[: g.n],
                            host_s=time.perf_counter() - t_r, dispatch=plan.kind)
                    est = new_est
            phase_s["converge"] = time.perf_counter() - t_conv
            core = compat.fetch_replicated(est, mesh)[: g.n].astype(np.int32)
        _sp.set(rounds=rounds, converged=converged,
                messages=int(np.asarray(msgs, np.int64).sum()))
    stats = MessageStats(np.asarray(msgs, np.int64),
                         np.asarray(active[: len(msgs)], np.int64),
                         np.asarray(changed_counts[: len(msgs)], np.int64))
    if rec.active:
        rec.end_run(converged=converged, messages=int(stats.total_messages))
    return KCoreResult(core=core, rounds=rounds, converged=converged, stats=stats,
                       recompiles=_build.build_count() - builds0,
                       compile_s=_build.build_seconds() - bsecs0,
                       phase_s=phase_s, dispatch=plan.kind)
