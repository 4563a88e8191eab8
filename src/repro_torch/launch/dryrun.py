"""The dry-run: what each cell's step costs, counted without running it (the
port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell of the registry the port's step
is built at the cell's full global shape on ``meta`` tensors (no memory, no
card) and run once under ``launch.step_cost``: its FLOPs and bytes, every
hand-written kernel's booked calls and work, the argument and output bytes
from the shapes, and the roofline terms on one H100 (``launch.roofline``).
The reference compiles each cell for a TPU pod and reads XLA's memory and
cost analyses; the port has no compiler to ask, so the temporaries are
"not measured" on ``meta``, and ``fits_card`` holds the arguments and
outputs against the card's memory where a card is present.

``--run`` executes a cell on the card after a warm-up call, from random
weights and data made from ``--seed``: one call timed (its wall, the peak
device memory, ``max_memory_allocated`` after ``reset_peak_memory_stats``,
and each kernel's launches) and one counted (the FLOPs and bytes counted on
the card, equal to the ``meta`` count, and the kernels' bookings), and the
share of the roofline bound the wall achieves. ``--batch N`` cuts the cell's global batch
to N and the record says so (``reduced``). A cell whose arguments do not fit
the card is recorded so and not run. ``--run`` with no card fails.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kcore --graph LJ1 --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch din --shape serve_bulk --run

``--mesh`` is ``1`` (one card, the default), or ``pod1``/``pod2``, the
reference's 16x16 and 2x16x16 meshes: the k-core cell runs its sharded
superstep over that many shards of one card (``launch.mesh``), with the
collectives' bytes from ``distribution.collectives``; an LM, GNN
or DIN cell on a pod mesh fails, naming ROADMAP.md Queue A item 12b (the
two-axis mesh and the pod-mesh dry-run; the GNN family's flat sharding runs
on one card's shards, ``models/gnn/common.py``, but is not counted on the
pod meshes). Records go to ``experiments/dryrun_torch/``
(listed in ``.gitignore``), one JSON file a cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_shapes, shape_by_name
from repro_torch.distribution.collectives import collective_bytes
from repro_torch.launch import roofline
from repro_torch.launch.step_cost import StepCounter

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESHES = ("1", "pod1", "pod2")
_MESH = "ROADMAP.md Queue A item 12b (the two-axis mesh and the pod-mesh dry-run)"

# long_500k needs sub-quadratic attention: only mixtral (SWA) runs it.
SKIP = {
    ("qwen2-moe-a2.7b", "long_500k"): "full attention (no sub-quadratic path)",
    ("yi-34b", "long_500k"): "full attention (no sub-quadratic path)",
    ("granite-34b", "long_500k"): "full attention (no sub-quadratic path)",
    ("qwen1.5-0.5b", "long_500k"): "full attention (no sub-quadratic path)",
}

_BATCH_KEY = {"lm": "global_batch", "recsys": "batch", "gnn": "batch"}


@dataclasses.dataclass
class Cell:
    """A built cell: ``step(*args)`` is one step."""

    step: object
    args: tuple


def _meta_tree(spec):
    """A shape spec tree (tuples of ints as leaves) as float32 ``meta``
    tensors."""
    if isinstance(spec, dict):
        return {k: _meta_tree(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_meta_tree(v) for v in spec]
    if spec is None:
        return None
    return torch.empty(spec, dtype=torch.float32, device="meta")


def _tensor(shape, dtype, device, gen, high: int | None = None):
    """A ``meta`` tensor, or on a real device random data: integers in
    [0, ``high``), floats N(0, 1), booleans True."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if dtype == torch.bool:
        return torch.ones(shape, dtype=dtype, device=device)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return torch.randint(0, max(int(high), 1), shape, generator=gen, device=device, dtype=dtype)


def _cut(shape, family: str, batch: int | None):
    if batch is None:
        return shape
    key = _BATCH_KEY[family]
    if key not in shape.params:
        raise ValueError(f"shape {shape.name} has no batch to cut")
    return dataclasses.replace(shape, params={**shape.params, key: int(batch)})


def build_cell(arch: str, shape_name: str, mesh=None, *, device="meta", batch: int | None = None,
               seed: int = 0, cfg=None) -> Cell:
    """The cell's step and arguments on ``device`` (``meta``: shapes only;
    else random weights and data from ``seed``), at the cell's global shape
    or with its batch cut to ``batch``. ``cfg`` replaces the registry's
    config (``launch/hillclimb.py``'s variants). A mesh raises, naming item 12b."""
    if mesh is not None:
        raise NotImplementedError(f"{arch} x {shape_name} on a pod mesh is not ported yet: {_MESH}")
    cfg = get_config(arch) if cfg is None else cfg
    shape = _cut(shape_by_name(arch, shape_name), cfg.family, batch)
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "lm":
        return _lm_cell(cfg, shape, dev, gen, seed)
    if cfg.family == "gnn":
        return _gnn_cell(cfg, shape, dev, gen, seed)
    return _din_cell(cfg, shape, dev, gen, seed)


def _lm_cell(cfg, shape, dev, gen, seed) -> Cell:
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer import steps as S
    from repro_torch.optim import adamw_init

    step, specs, _, _ = S.build_step(cfg, shape)
    if dev.type == "meta":
        params = S.param_shapes(cfg)
    else:
        params = M.init_params(cfg, seed, device=dev, on_device=True)
    B, T = shape.params["global_batch"], shape.params["seq_len"]
    tok = _tensor((B, T), torch.int32, dev, gen, cfg.vocab)
    if shape.kind == "train":
        labels = _tensor((B, T), torch.int32, dev, gen, cfg.vocab)
        return Cell(step, (params, adamw_init(params), tok, labels))
    if shape.kind == "prefill":
        return Cell(step, (params, tok))
    (cshape, cdt) = specs["cache"]["k"]
    cache = {k: _tensor(cshape, cdt, dev, gen) for k in ("k", "v")}
    # the decode step at the cache's last position
    return Cell(step, (params, tok[:, :1], cache, T - 1))


def _gnn_cell(cfg, shape, dev, gen, seed) -> Cell:
    from repro_torch.models.gnn import steps as S
    from repro_torch.optim import adamw_init

    train_step, specs, _, _ = S.build_train(cfg, shape, None)
    bspecs = specs["batch"]
    n_nodes = bspecs["node_mask"][0][0]
    n_graphs = shape.params.get("batch", 1) if shape.kind == "molecule" else 1
    n_classes = S.n_classes_for(shape)
    high = {"src": n_nodes, "dst": n_nodes, "graph_id": n_graphs,
            "species": cfg.params.get("n_species", 4),
            "labels": n_classes}
    batch = {k: _tensor(s, dt, dev, gen, high.get(k)) for k, (s, dt) in bspecs.items()}
    if dev.type == "meta":
        params = _meta_tree(specs["_params"])
    else:
        d_in = bspecs["feats"][0][1] if "feats" in bspecs else None
        params = S.init_params(cfg, seed, d_in, n_classes, device=dev)
    # the layout is built once for a batch, outside the step, as the launchers build it
    layout = S.edge_layout(cfg, batch)

    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, layout=layout)

    return Cell(step, (params, adamw_init(params), batch))


def _din_cell(cfg, shape, dev, gen, seed) -> Cell:
    from repro_torch.models.recsys import din
    from repro_torch.models.recsys import steps as S
    from repro_torch.optim import adamw_init

    if dev.type == "meta":
        params = _meta_tree(din.param_spec(cfg))
        batch = {k: _tensor(s, dt, dev, gen) for k, (s, dt) in S.batch_specs(cfg, shape).items()}
    else:
        params = din.init_params(cfg, seed, device=dev)
        batch = S.batch_to(S.synth_batch(cfg, shape, seed), dev)
    if shape.kind == "train":
        return Cell(S.make_train_step(cfg), (params, adamw_init(params), batch))
    step = S.make_retrieval_step(cfg) if shape.kind == "retrieval" else S.make_serve_step(cfg)
    return Cell(step, (params, batch))


def _tree_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_tree_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tree_bytes(v) for v in x)
    return 0


def _card_memory() -> int | None:
    return torch.cuda.get_device_properties(0).total_memory if torch.cuda.is_available() else None


def _memory(args_bytes: int, out_bytes: int) -> dict:
    total = _card_memory()
    live = args_bytes + out_bytes
    return {"argument_size_in_bytes": args_bytes, "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": "not measured", "args_and_outputs_bytes": live,
            "card_bytes": total if total is not None else "not measured",
            "fits_card": bool(live < total) if total is not None else "not measured"}


def count_cell(cell: Cell, chips: int = 1) -> dict:
    """Run ``cell`` once under a ``StepCounter``; the record's cost fields."""
    counter = StepCounter()
    with collective_bytes() as coll, counter:
        out = cell.step(*cell.args)
    roof = roofline.Roofline(flops=counter.flops, hbm_bytes=counter.bytes,
                             coll_bytes=coll["total_bytes"] * chips, chips=chips,
                             flops_by_dtype=counter.flops_by_dtype)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "flops_by_dtype": counter.flops_by_dtype, "by_kind": counter.by_kind,
            "by_kernel": counter.by_kernel, "roofline": roof.to_dict(), "bound_s": roof.bound_s,
            "collectives": coll, "memory": _memory(_tree_bytes(cell.args), _tree_bytes(out))}


def _zero(x):
    if isinstance(x, dict):
        return {k: _zero(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_zero(v) for v in x]
    return 0 if isinstance(x, (int, float)) and not isinstance(x, bool) else x


def _combine(f11, f21, f12, f22, L: int, M: int):
    """The bilinear extension of a count made at (layers, microbatches) of
    (1, 1), (2, 1), (1, 2) and (2, 2) to (L, M), field by field."""
    if isinstance(f11, dict):      # a key missing at one depth counts 0 there
        fs = (f11, f21, f12, f22)
        keys = dict.fromkeys(k for f in fs for k in f)
        return {k: _combine(*(f.get(k, _zero(next(g[k] for g in fs if k in g))) for f in fs),
                            L, M) for k in keys}
    if isinstance(f11, list):
        return [_combine(*x, L, M) for x in zip(f11, f21, f12, f22)]
    if isinstance(f11, bool) or not isinstance(f11, (int, float)):
        return f11
    return f11 + (L - 1) * (f21 - f11) + (M - 1) * (f12 - f11) + \
        (L - 1) * (M - 1) * (f22 - f21 - f12 + f11)


def meta_count(arch: str, shape_name: str, mesh=None, *, batch: int | None = None,
               cfg=None) -> dict:
    """``count_cell`` of the cell on ``meta``. An LM's layers are identical,
    and so are its microbatches, so its count is affine in each: it is
    counted at 1 and 2 layers and 1 and 2 microbatches (at the cell's
    microbatch size and every width) and extended to the config's depth and
    microbatch count, which gives the count of the full step exactly, in
    seconds instead of minutes. The other families are counted whole."""
    cfg = get_config(arch) if cfg is None else cfg
    if cfg.family != "lm" or mesh is not None:
        return count_cell(build_cell(arch, shape_name, mesh, batch=batch, cfg=cfg))
    shape = _cut(shape_by_name(arch, shape_name), "lm", batch)
    L, M = cfg.n_layers, max(cfg.train_microbatches, 1) if shape.kind == "train" else 1
    B = shape.params["global_batch"]
    if B % M:
        raise ValueError(f"global batch {B} is not a multiple of {M} microbatches")
    counts = {}
    for layers, micro in ((1, 1), (2, 1), (1, 2), (2, 2)):
        part = dataclasses.replace(cfg, n_layers=layers, train_microbatches=micro)
        counts[layers, micro] = count_cell(build_cell(arch, shape_name, batch=B // M * micro,
                                                      cfg=part))
    rec = _combine(counts[1, 1], counts[2, 1], counts[1, 2], counts[2, 2], L, M)
    roof = roofline.Roofline(flops=rec["flops"], hbm_bytes=rec["bytes"], coll_bytes=0.0,
                             chips=1, flops_by_dtype=rec["flops_by_dtype"])
    mem = rec["memory"]
    rec.update(roofline=roof.to_dict(), bound_s=roof.bound_s,
               memory=_memory(mem["argument_size_in_bytes"], mem["output_size_in_bytes"]),
               counted_at="1 and 2 layers and microbatches, extended to "
                          f"{L} layers and {M} microbatches")
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str = "1", save: bool = True, *,
             run: bool = False, batch: int | None = None, seed: int = 0, cfg=None) -> dict:
    """One cell's record: the ``meta`` count and, with ``run``, one timed
    step on the card. Failures are recorded, not raised (``status`` FAIL)."""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if batch is not None:
        rec["reduced"] = {"global_batch": batch}
    if (arch, shape_name) in SKIP:
        rec.update(status="SKIP", reason=SKIP[(arch, shape_name)])
        if save:
            _save(rec)
        return rec
    if run and not torch.cuda.is_available():
        raise RuntimeError("--run needs a CUDA device; without one only the meta count runs")
    t0 = time.perf_counter()
    try:
        mesh = None if mesh_name == "1" else _pod(mesh_name)
        rec.update(status="OK", chips=1, **meta_count(arch, shape_name, mesh, batch=batch, cfg=cfg))
        rec["count_s"] = time.perf_counter() - t0
        if run:
            rec["run"] = run_on_card(arch, shape_name, rec, batch=batch, seed=seed, cfg=cfg)
    except Exception as e:  # noqa: BLE001 (record the failure, don't crash --all)
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if save:
        _save(rec)
    return rec


def _kernel_launches() -> dict:
    from repro_torch.kernels.embedding_bag import ops as bag
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk

    return {"kcore_hindex": hk.launches, "segment_sum": sk.launches,
            "segment_sum_float": sk.float_launches, "flash_attention": fa.launches,
            "embedding_bag": bag.launches}


def run_on_card(arch: str, shape_name: str, meta: dict, *, batch=None, seed: int = 0,
                cfg=None, device=None) -> dict:
    """The cell on the card (``device``; the CPU only for a rehearsal): a
    warm-up call, a timed call (the wall, its kernels' launches, the peak
    device memory: ``max_memory_allocated`` after
    ``reset_peak_memory_stats``, and above what the arguments held) and a
    counted call (its count against ``meta``'s, each kernel's bookings
    beside the timed call's launches), and the share of the roofline bound
    the wall achieves."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else \
        torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        need = meta["memory"]["argument_size_in_bytes"]
        free, _ = torch.cuda.mem_get_info(dev)
        if need >= free:
            return {"status": "does not fit", "argument_bytes": need, "free_bytes": free}
    try:
        cell = build_cell(arch, shape_name, device=dev, batch=batch, seed=seed, cfg=cfg)
        cell.step(*cell.args)                                     # warm-up: builds, caches
        if on_card:
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        # the timed call runs without the counter, whose Python hook on every op would be
        # timed too; the counted call follows it
        before = _kernel_launches()
        t0 = time.perf_counter()
        out = cell.step(*cell.args)
        if on_card:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in _kernel_launches().items() if v != before[k]}
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        del out
        counter = StepCounter()
        with counter:
            cell.step(*cell.args)
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return {"status": "does not fit", "error": str(e).splitlines()[0]}
    del cell
    if on_card:
        torch.cuda.empty_cache()
    bound = meta["bound_s"]
    return {"status": "OK", "device": str(dev), "wall_s": wall,
            "peak_bytes": peak if on_card else "not measured",
            "peak_above_args_bytes": peak - held if on_card else "not measured",
            "flops": counter.flops, "bytes": counter.bytes, "by_kernel": counter.by_kernel,
            "launches": launches,
            "same_count_as_meta": counter.flops == meta["flops"] and counter.bytes == meta["bytes"],
            "bookings_equal_launches": on_card and all(
                launches.get(k, 0) == v["calls"] for k, v in counter.by_kernel.items()),
            "bound_s": bound, "roofline_share": bound / wall,
            "dominant": meta["roofline"]["dominant"]}


def _pod(mesh_name: str):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=mesh_name == "pod2", device="meta")


def _save(rec: dict) -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json".replace("/", "-")
    (OUT_DIR / name).write_text(json.dumps(rec, indent=1, default=str))


# ---------------------------------------------------------------------- #
# k-core engine cells (the paper's own workload)
# ---------------------------------------------------------------------- #

def run_kcore_cell(graph_abbrev: str, mesh_name: str = "1", save: bool = True) -> dict:
    """The sharded superstep (``core.kcore.sharded_superstep``) over the
    shards of ``mesh_name``, on ``meta`` shards of the graph's original
    sizes (``SNAP_BY_ABBREV``): one superstep's count, its collectives, and
    the roofline terms."""
    from repro_torch.core.dispatch import StagedShards
    from repro_torch.core.kcore import _bs_iters, sharded_superstep
    from repro_torch.distribution.compat import Mesh
    from repro_torch.graph.generators import SNAP_BY_ABBREV

    rec = {"arch": "kcore", "shape": graph_abbrev, "mesh": mesh_name}
    t0 = time.perf_counter()
    try:
        mesh = (Mesh((1,), ("data",), torch.device("meta")) if mesh_name == "1"
                else _pod(mesh_name))
        chips = mesh.size
        entry = SNAP_BY_ABBREV[graph_abbrev]
        n, arcs = entry.n, 2 * entry.m
        V, A = -(-n // chips), -(-arcs // chips)

        def meta(size, dtype):
            return torch.empty(size, dtype=dtype, device="meta")

        st = StagedShards(mesh, V, meta(chips * A, torch.int32), meta(chips * A, torch.int32),
                          meta(chips * V + 1, torch.int64), meta(chips * A, torch.bool),
                          meta(chips * V, torch.int32))
        n_iters = _bs_iters(entry.max_deg)
        cell = Cell(sharded_superstep(st, n_iters), (meta(chips * V, torch.int32),))
        rec.update(status="OK", chips=chips, n=n, arcs=arcs, bs_iters=n_iters,
                   **count_cell(cell, chips))
        staged = _tree_bytes((st.src, st.dst, st.row_ptr, st.arc_mask, st.deg))
        rec["memory"] = _memory(_tree_bytes(cell.args) + staged,
                                rec["memory"]["output_size_in_bytes"])
        rec["count_s"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if save:
        _save(rec)
    return rec


def summary_line(rec: dict) -> str:
    """One line of a record: status, cell, sizes, count, dominant term, and
    the run on the card where there was one."""
    live = rec.get("memory", {}).get("args_and_outputs_bytes", 0)
    line = (f"[{rec['status']}] {rec['arch']} x {rec['shape']} x {rec['mesh']} "
            f"args+outs={live / 1e9:.2f}GB flops={rec.get('flops', 0):.4e} "
            f"bytes={rec.get('bytes', 0):.4e} "
            f"dominant={rec.get('roofline', {}).get('dominant', '')} "
            f"{rec.get('reason') or rec.get('error') or ''}")
    run = rec.get("run")
    if run and run["status"] == "OK":
        line += (f" | run: wall {run['wall_s'] * 1e3:.3f} ms, peak {run['peak_bytes']} B, "
                 f"share {run['roofline_share']:.2%} of the {run['dominant']} bound, count "
                 f"equal to meta {run['same_count_as_meta']}, bookings equal launches "
                 f"{run['bookings_equal_launches']}")
    elif run:
        line += f" | run: {run['status']}"
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--graph", default=None, help="kcore: SNAP abbrev")
    ap.add_argument("--mesh", default="1", choices=MESHES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--run", action="store_true",
                    help="also run each cell once on the card (fails without one)")
    ap.add_argument("--batch", type=int, default=None, help="cut the global batch to this")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.run and not torch.cuda.is_available():
        raise RuntimeError("--run needs a CUDA device; without one only the meta count runs")
    if args.run:
        from repro_torch.platform import device_summary

        card = device_summary()
        print(f"device: {card['name']} (power limit {card['power_limit']})")

    cells: list[tuple[str, str]] = []
    if args.all:
        cells = [(arch, s.name) for arch in ARCH_IDS for s in get_shapes(arch)]
    elif args.arch == "kcore":
        rec = run_kcore_cell(args.graph or "FC", args.mesh)
        print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=1,
                         default=str))
        return
    else:
        shapes = [args.shape] if args.shape else [s.name for s in get_shapes(args.arch)]
        cells = [(args.arch, s) for s in shapes]
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.mesh, run=args.run, batch=args.batch, seed=args.seed)
        print(summary_line(rec), flush=True)


if __name__ == "__main__":
    main()
