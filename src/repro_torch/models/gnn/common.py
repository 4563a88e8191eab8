"""Shared GNN substrate of the port (the counterpart of ``repro.models.gnn.common``).

Message passing is a gather of node rows by arc and a segment sum of the
arcs' messages by destination. The segment sum is the float form of the
segment-sum kernel (``kernels/segment_sum``): ``scatter_sum(values, layout)``
takes a ``SegmentLayout`` of the destinations, built once per graph or batch
(``segment_layout``) and passed through the models, where the reference's
``scatter_sum(values, index, n)`` takes the ids themselves.

All four assigned shapes lower to one batch layout, a dict of numpy arrays
built by ``batch_from_graph``, ``batch_molecules`` or ``batch_from_sampled``
(equal to the reference's for the same seed) and moved to a device by
``batch_to``:

  feats (N, d_feat) | species (N,) | positions (N, 3)
  src, dst (E,) int32 | edge_mask (E,) bool | node_mask (N,) bool
  graph_id (N,) int32 | labels (N,) int32 or (G,) float32

Layers are a list of ``{"w": (in, out), "b": (out,)}`` dicts in the
reference's layout: weights drawn N(0, 1/in) from a ``torch.Generator``,
zero biases, SiLU between layers and none after the last.

Activations of GraphCast's generic mode and of MACE are bf16
(``COMPUTE_DTYPE``), as in the reference, unless the parameters are float64:
then the model runs in float64 throughout, geometry included (the yardstick
evaluation a result is held against). float32 matmuls keep PyTorch's default
on the card, TF32 off.

On a flat mesh (``set_flat_sharding(mesh, axes)``, a ``distribution.compat``
mesh of one process or of several gloo processes) node and arc arrays are
sharded by rows over every shard, as the reference shards them: an array
of more than 1,024 rows (``build_train``'s rule) is held as this process's
row blocks, a smaller one whole (on one process every array is whole). The
models then take ``MeshLayout``s where they took ids: ``mesh_arcs`` for the
arcs' sources and destinations, ``mesh_layout`` for other segment ids (the
molecules' pooling), built once per graph from the whole ids.
``scatter_sum`` and ``gather_rows(_multi)`` take the reference's branches
by its conditions (common.py:43, :78), counted in ``BRANCHES``:

* the sharded scatter (E >= 4096 arcs, n % D == 0): each shard's float32
  partial of its E/D arcs into all n rows (one float kernel launch a local
  shard), then ``compat.reduce_scatter``, which adds the D partials of each
  row block in shard order and rounds once;
* the sharded gather (n % D == 0 and each index's length % D == 0): one
  all-gather of the rows and a local take; its backward is the sharded
  scatter of the gradients (each shard's partials over its slice of every
  index, added, then the reduce-scatter);
* otherwise as one device would: the values or rows gathered whole where
  they are held as row blocks, the single-device sum or take, and this
  process's rows kept where the result is held as row blocks.

Gradients follow ``distribution/compat.py``'s rule (a whole tensor's as
shares over the processes). ``constrain_rows`` is the identity: the port
holds every array in its placement by construction, where the reference
asks GSPMD for it.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distribution import compat
from repro_torch.graph.structs import Graph
from repro_torch.kernels.segment_sum import ops as _seg
from repro_torch.kernels.segment_sum.ops import SegmentLayout, segment_layout

COMPUTE_DTYPE = torch.bfloat16   # GNN activation dtype (params stay float32)

_PLAIN = {"on": False}


def compute_dtype(params_leaf: torch.Tensor) -> torch.dtype:
    """bf16, or float64 when the parameters are float64."""
    return torch.float64 if params_leaf.dtype == torch.float64 else COMPUTE_DTYPE


@contextmanager
def plain_scatter():
    """Inside, ``scatter_sum`` takes the kernel's plain version on every
    device: the route a kernel's result is held against, and the route of a
    float64 evaluation on the card. No model path enters it by itself."""
    before = _PLAIN["on"]
    _PLAIN["on"] = True
    try:
        yield
    finally:
        _PLAIN["on"] = before


SHARDED_SCATTER_MIN = 4096   # the reference's sharded scatter needs E >= this (common.py:43)
BLOCK_ROWS_MIN = 1024        # build_train's flat spec: arrays of more rows are sharded

# Flat row-sharding context (the reference's ``_FLAT_AXES_SHARDING``): the
# mesh and axes ``set_flat_sharding`` set, None without a mesh.
_FLAT_AXES_SHARDING: dict = {"mesh": None, "axes": None}

# Calls of each branch on this process: BRANCHES[op][branch], op "scatter" or
# "gather", branch "sharded" or "unsharded". Calls without a mesh are not counted.
BRANCHES = {op: {"sharded": 0, "unsharded": 0} for op in ("scatter", "gather")}


def reset_branches() -> None:
    for counts in BRANCHES.values():
        counts.update(sharded=0, unsharded=0)


def set_flat_sharding(mesh, axes) -> None:
    """Set (or, with ``mesh`` None, clear) the flat row-sharding context:
    node and arc arrays sharded over every axis of ``mesh``, which ``axes``
    must name (``compat.shard_count``)."""
    if mesh is not None:
        if not isinstance(mesh, compat.Mesh):
            raise TypeError(f"set_flat_sharding takes a distribution.compat Mesh, not "
                            f"{type(mesh).__name__}")
        compat.shard_count(mesh, tuple(axes or ()))
    _FLAT_AXES_SHARDING["mesh"] = mesh
    _FLAT_AXES_SHARDING["axes"] = tuple(axes) if axes else None


def flat_mesh():
    """The mesh ``set_flat_sharding`` set, or None."""
    return _FLAT_AXES_SHARDING["mesh"]


def _mesh_size(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n


def constrain_rows(x: torch.Tensor) -> torch.Tensor:
    """The identity. The reference shards dim 0 over every mesh axis here
    (a GSPMD constraint); the port's arrays are already in their placement
    (the module docstring)."""
    return x


def held_as_blocks(rows: int, mesh) -> bool:
    """Whether an array of ``rows`` rows (the whole array's count) lives on
    ``mesh`` as each process's row blocks rather than whole: on a mesh of
    several processes, above ``BLOCK_ROWS_MIN`` rows."""
    return mesh.world > 1 and rows > BLOCK_ROWS_MIN


@dataclasses.dataclass(frozen=True, eq=False)
class MeshLayout:
    """Segment ids on a flat mesh: ``E`` ids in [0, ``n``) (the whole
    array's), ``local_ids`` those of this process's arcs (all E where the
    arcs are held whole), and the layouts the branches need: ``shards``, one
    ``SegmentLayout`` a local shard over its E/D arcs with the whole rows'
    ids (where n and E divide by the D shards), and ``whole``, the
    ``SegmentLayout`` of all E ids (where a branch sums as one device
    would)."""

    mesh: compat.Mesh
    n: int
    E: int
    local_ids: torch.Tensor
    shards: tuple
    whole: SegmentLayout | None

    @property
    def arcs_local(self) -> bool:
        return held_as_blocks(self.E, self.mesh)

    @property
    def rows_local(self) -> bool:
        return held_as_blocks(self.n, self.mesh)

    @property
    def first_row(self) -> int:
        """The whole array's index of this process's first row."""
        return self.mesh.rank * (self.n // self.mesh.world) if self.rows_local else 0


@dataclasses.dataclass(frozen=True, eq=False)
class MeshArcs:
    """A graph's arcs on a flat mesh: the ``MeshLayout``s of their sources
    and destinations over its nodes. ``scatter_sum`` reads ``dst``."""

    src: MeshLayout
    dst: MeshLayout


def mesh_layout(ids, n: int, mesh) -> MeshLayout:
    """The ``MeshLayout`` of a whole array of segment ids ``ids`` (numpy or
    a tensor; every process holds all of it) over ``n`` rows, on ``mesh``'s
    device."""
    D = _mesh_size(mesh)
    ids = torch.as_tensor(ids).to(device=mesh.device, dtype=torch.int64)
    E = ids.shape[0]
    for rows, what in ((E, "arcs"), (n, "rows")):
        if held_as_blocks(rows, mesh) and rows % D:
            raise ValueError(f"{rows} {what} cannot be held as row blocks of {D} shards")
    shards, whole = (), None
    if E % D == 0 and n % D == 0:
        per, lo = E // D, mesh.shard_offset * (E // D)
        shards = tuple(segment_layout(ids[lo + j * per: lo + (j + 1) * per], n)
                       for j in range(mesh.local_shards))
    if E < SHARDED_SCATTER_MIN or n % D or E % D:
        whole = segment_layout(ids, n)
    local = _own_rows(ids, mesh) if held_as_blocks(E, mesh) else ids
    return MeshLayout(mesh=mesh, n=int(n), E=int(E), local_ids=local, shards=shards, whole=whole)


def mesh_arcs(src, dst, n: int, mesh) -> MeshArcs:
    """The ``MeshArcs`` of whole arrays of arc sources and destinations over
    ``n`` nodes."""
    return MeshArcs(src=mesh_layout(src, n, mesh), dst=mesh_layout(dst, n, mesh))


def _on_mesh(layout: MeshLayout):
    mesh = flat_mesh()
    if mesh is None or mesh is not layout.mesh:
        raise ValueError("a MeshLayout needs set_flat_sharding of the mesh it was built for")
    return mesh


def _check_rows(x: torch.Tensor, rows: int, local: bool, mesh, what: str) -> None:
    want = rows // mesh.world if local else rows
    if x.shape[0] != want:
        raise ValueError(f"{what} has {x.shape[0]} rows; this process holds {want} of {rows}")


def _own_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    rows = x.shape[0] // mesh.world
    return x[mesh.rank * rows: (mesh.rank + 1) * rows]


def _partial(values: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """A shard's unrounded sum (float32; float64 for float64 values)."""
    if _PLAIN["on"]:
        wide = torch.float64 if values.dtype == torch.float64 else torch.float32
        return _seg.segment_sum_float_ref(values.to(wide), layout.ids, layout.n)
    return _seg.segment_sum_float_partial(values, layout)


def _sum(values: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    if _PLAIN["on"]:
        return _seg.segment_sum_float_ref(values, layout.ids, layout.n)
    return _seg.segment_sum_float(values, layout)


def _mesh_scatter(values: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    """``scatter_sum`` of (E, F) or (E,) ``values`` on a flat mesh: the
    reference's branches (the module docstring)."""
    mesh = _on_mesh(layout)
    D = _mesh_size(mesh)
    _check_rows(values, layout.E, layout.arcs_local, mesh, "scatter values")
    if layout.E < SHARDED_SCATTER_MIN or layout.n % D:
        BRANCHES["scatter"]["unsharded"] += 1
        whole = compat.all_gather(values, mesh) if layout.arcs_local else values
        out = _sum(whole, layout.whole)
        return _own_rows(out, mesh) if layout.rows_local else out
    BRANCHES["scatter"]["sharded"] += 1
    if layout.E % D:
        raise ValueError(f"the sharded scatter cannot split {layout.E} arcs over {D} shards "
                         "(nor can the reference's shard_map)")
    per = layout.E // D
    parts = torch.stack([_partial(values[j * per:(j + 1) * per], lay)
                         for j, lay in enumerate(layout.shards)])
    out = compat.reduce_scatter(parts, mesh, values.dtype)
    return compat.all_gather(out, mesh) if mesh.world > 1 and not layout.rows_local else out


def scatter_sum(values: torch.Tensor, layout) -> torch.Tensor:
    """Segment-sum messages ``values`` (E, ...) into ``layout.n`` rows (n, ...):
    through a ``SegmentLayout`` without a mesh, or on the flat mesh through a
    ``MeshLayout`` (or a ``MeshArcs``' ``dst``; the module docstring)."""
    if isinstance(layout, MeshArcs):
        layout = layout.dst
    if isinstance(layout, MeshLayout):
        flat = values.reshape(values.shape[0], -1) if values.dim() > 2 else values
        out = _mesh_scatter(flat, layout)
        return out.reshape(out.shape[0], *values.shape[1:])
    if flat_mesh() is not None:
        raise ValueError("a flat mesh is set: scatter_sum takes the batch's MeshLayouts "
                         "(steps.mesh_layouts)")
    if _PLAIN["on"]:
        return _seg.segment_sum_float_ref(values, layout.ids, layout.n)
    flat = values.reshape(values.shape[0], -1) if values.dim() > 2 else values
    return _seg.segment_sum_float(flat, layout).reshape(layout.n, *values.shape[1:])


def scatter_mean(values: torch.Tensor, layout, eps: float = 1e-9):
    s = scatter_sum(values, layout)
    cnt = scatter_sum(values.new_ones(values.shape[:1]), layout)
    return s / (cnt[:, None] + eps) if values.dim() > 1 else s / (cnt + eps)


class _ShardedGather(torch.autograd.Function):
    """The sharded gather of (rows, F) ``h``: forward, the row blocks
    all-gathered where ``h`` is held as them, and each index's local take;
    backward, each local shard's float32 partials of every index's
    gradients (its slice of their arcs) added in index order, then
    ``compat.reduce_scatter`` into h's rows."""

    @staticmethod
    def forward(ctx, h, *layouts):
        ctx.layouts, ctx.dtype = layouts, h.dtype
        mesh = layouts[0].mesh
        # one process: notes the all-gather and returns h, whose rows are all there
        whole = compat.all_gather(h, mesh) if layouts[0].rows_local or mesh.world == 1 else h
        return tuple(whole.index_select(0, lay.local_ids) for lay in layouts)

    @staticmethod
    def backward(ctx, *grads):
        lay0 = ctx.layouts[0]
        mesh = lay0.mesh
        D, L = _mesh_size(mesh), mesh.local_shards
        parts = [None] * L
        for lay, g in zip(ctx.layouts, grads):
            per = lay.E // D
            if mesh.world > 1 and not lay.arcs_local:    # shares of whole arcs: add them up
                g = compat.psum(g, mesh)[mesh.shard_offset * per:(mesh.shard_offset + L) * per]
            for j in range(L):
                p = _partial(g[j * per:(j + 1) * per], lay.shards[j])
                parts[j] = p if parts[j] is None else parts[j] + p
        dh = compat.reduce_scatter(torch.stack(parts), mesh, ctx.dtype)
        if mesh.world > 1 and not lay0.rows_local:       # h held whole: this process's share
            blk = lay0.n // D
            share = dh.new_zeros((lay0.n, *dh.shape[1:]))
            share[mesh.shard_offset * blk:(mesh.shard_offset + L) * blk] = dh
            dh = share
        return (dh, *([None] * len(ctx.layouts)))


def gather_rows(h: torch.Tensor, idx) -> torch.Tensor:
    """h[idx]: ``idx`` the ids (a tensor), or on a flat mesh their
    ``MeshLayout``."""
    return gather_rows_multi(h, (idx,))[0]


def gather_rows_multi(h: torch.Tensor, idxs: tuple) -> tuple:
    """h's rows for several index vectors, from one all-gather on a flat
    mesh: ``idxs`` all tensors of ids, or all ``MeshLayout``s over h's rows
    (the reference's branches, the module docstring)."""
    if not all(isinstance(i, MeshLayout) for i in idxs):
        if flat_mesh() is not None:
            raise ValueError("a flat mesh is set: gather_rows takes the batch's MeshLayouts "
                             "(steps.mesh_layouts)")
        return tuple(h.index_select(0, i) for i in idxs)
    lay0 = idxs[0]
    mesh = _on_mesh(lay0)
    D = _mesh_size(mesh)
    if any(lay.n != lay0.n or lay.mesh is not mesh for lay in idxs):
        raise ValueError("gather_rows_multi's layouts must index one array's rows on one mesh")
    _check_rows(h, lay0.n, lay0.rows_local, mesh, "gathered rows")
    if lay0.n % D or any(lay.E % D for lay in idxs):
        BRANCHES["gather"]["unsharded"] += 1
        whole = compat.all_gather(h, mesh) if lay0.rows_local else h
        return tuple(whole.index_select(0, lay.local_ids) for lay in idxs)
    BRANCHES["gather"]["sharded"] += 1
    outs = _ShardedGather.apply(h.reshape(h.shape[0], -1), *idxs)
    return tuple(o.reshape(o.shape[0], *h.shape[1:]) for o in outs)


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32, device=None) -> list[dict]:
    """One ``{"w", "b"}`` dict per pair of consecutive ``sizes``; the draws
    come from ``gen``, on its device, in layer order."""
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, dtype=dtype, device=device) * (1.0 / math.sqrt(a))
        layers.append({"w": w, "b": torch.zeros((b,), dtype=dtype, device=device)})
    return layers


def mlp_spec(sizes) -> list[dict]:
    """The shapes ``mlp_init(gen, sizes)`` draws."""
    return [{"w": (a, b), "b": (b,)} for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(layers: list[dict], x: torch.Tensor, act=F.silu, final_act: bool = False):
    """``x @ w + b`` per layer, ``act`` between layers (and after the last
    with ``final_act``). Outside autograd the activation runs in place, which
    saves one activation-sized buffer a layer."""
    for i, layer in enumerate(layers):
        x = F.linear(x, layer["w"].to(x.dtype).t(), layer["b"].to(x.dtype))
        if i < len(layers) - 1 or final_act:
            x = act(x, inplace=True) if act is F.silu and not torch.is_grad_enabled() else act(x)
    return x


def layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis, in float32 (float64 for float64), no affine."""
    xf = x.float() if x.dtype != torch.float64 else x
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------- #
# Radial bases
# ---------------------------------------------------------------------- #

def gaussian_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """SchNet-style Gaussian radial basis."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype, device=dist.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (dist[..., None] - centers) ** 2)


def bessel_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """MACE/NequIP Bessel basis with smooth cutoff envelope."""
    d = dist.clamp_min(1e-6)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=dist.dtype, device=dist.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d
    x = (dist / cutoff).clamp(0, 1)[..., None]
    envelope = 1 - 10 * x**3 + 15 * x**4 - 6 * x**5   # polynomial cutoff p=3
    return basis * envelope


def positions_for(h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Positions as the model reads them: float64 in a float64 evaluation,
    as given (float32) otherwise."""
    return positions.to(torch.float64) if h.dtype == torch.float64 else positions


def arc_ids(batch: dict, layout) -> tuple:
    """What the gathers take for the arcs' sources and destinations: the
    batch's ``src`` and ``dst``, or on a flat mesh the ``MeshArcs``' layouts
    of them."""
    if isinstance(layout, MeshArcs):
        return layout.src, layout.dst
    return batch["src"], batch["dst"]


def dst_layout(batch: dict) -> SegmentLayout:
    """The layout of a batch's arc destinations over its nodes."""
    return segment_layout(batch["dst"], batch["node_mask"].shape[0])


def graph_layout(batch: dict, n_graphs: int) -> SegmentLayout:
    """The layout of a batch's node-to-graph ids (energy pooling)."""
    return segment_layout(batch["graph_id"], n_graphs)


def params_to(params, device=None, dtype=None):
    """A copy of a parameter tree on ``device`` (and in ``dtype``, where
    given); ``None`` entries (no ``proj_in``) stay ``None``."""
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    return None if params is None else params.to(device=device, dtype=dtype)


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``, dtypes kept
    (``n_seeds`` stays an int)."""
    return {k: int(v) if k == "n_seeds" else torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------- #
# Batch builders (host-side, numpy; equal to the reference's for a seed)
# ---------------------------------------------------------------------- #

def batch_from_graph(g: Graph, d_feat: int, n_classes: int, seed: int = 0,
                     with_positions: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    batch = {
        "src": g.src.astype(np.int32),
        "dst": g.dst.astype(np.int32),
        "edge_mask": np.ones(g.num_arcs, bool),
        "node_mask": np.ones(g.n, bool),
        "graph_id": np.zeros(g.n, np.int32),
        "feats": rng.normal(size=(g.n, d_feat)).astype(np.float32),
        "labels": rng.integers(0, n_classes, g.n).astype(np.int32),
    }
    if with_positions:
        batch["positions"] = rng.normal(size=(g.n, 3)).astype(np.float32) * 3
        batch["species"] = rng.integers(0, 4, g.n).astype(np.int32)
    return batch


def batch_molecules(n_mols: int, n_nodes: int, n_edges: int, n_species: int,
                    seed: int = 0) -> dict:
    """Disjoint union of n_mols random molecules (fixed nodes/edges each)."""
    rng = np.random.default_rng(seed)
    N = n_mols * n_nodes
    offsets = np.repeat(np.arange(n_mols) * n_nodes, n_edges)
    e = rng.integers(0, n_nodes, size=(n_mols * n_edges, 2))
    # symmetric arcs: both directions
    src = np.concatenate([e[:, 0] + offsets, e[:, 1] + offsets]).astype(np.int32)
    dst = np.concatenate([e[:, 1] + offsets, e[:, 0] + offsets]).astype(np.int32)
    keep = src != dst
    return {
        "src": np.where(keep, src, 0),
        "dst": np.where(keep, dst, 0),
        "edge_mask": keep,
        "node_mask": np.ones(N, bool),
        "graph_id": np.repeat(np.arange(n_mols), n_nodes).astype(np.int32),
        "positions": rng.normal(size=(N, 3)).astype(np.float32) * 2,
        "species": rng.integers(0, n_species, N).astype(np.int32),
        "labels": rng.normal(size=(n_mols,)).astype(np.float32),  # energies
    }


def batch_from_sampled(g: Graph, sub, d_feat: int, n_classes: int,
                       feats: np.ndarray | None = None,
                       labels: np.ndarray | None = None,
                       seed: int = 0) -> dict:
    """Flatten a sampler.SampledSubgraph into one padded edge-list batch.

    Nodes = concatenation of all sampler layers (seeds first). Predictions
    read the seed prefix."""
    rng = np.random.default_rng(seed)
    layer_sizes = [ln.shape[0] for ln in sub.layer_nodes]
    starts = np.concatenate([[0], np.cumsum(layer_sizes)[:-1]])
    all_nodes = np.concatenate(sub.layer_nodes)
    node_mask = all_nodes >= 0
    safe = np.where(node_mask, all_nodes, 0)
    srcs, dsts, masks = [], [], []
    for h, blk in enumerate(sub.blocks):
        dsts.append(blk.dst_index + starts[h])
        srcs.append(blk.src_index + starts[h + 1])
        masks.append(blk.mask)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    emask = np.concatenate(masks)
    if feats is None:
        feats = rng.normal(size=(len(all_nodes), d_feat)).astype(np.float32)
    else:
        feats = feats[safe] * node_mask[:, None]
    if labels is None:
        labels = rng.integers(0, n_classes, len(all_nodes)).astype(np.int32)
    else:
        labels = labels[safe]
    return {
        # message direction: sampled neighbor (layer h+1) -> requester (h)
        "src": src, "dst": dst,
        "edge_mask": emask,
        "node_mask": node_mask,
        "graph_id": np.zeros(len(all_nodes), np.int32),
        "feats": feats.astype(np.float32),
        "labels": labels,
        "positions": rng.normal(size=(len(all_nodes), 3)).astype(np.float32),
        "species": rng.integers(0, 4, len(all_nodes)).astype(np.int32),
        "n_seeds": np.int32(layer_sizes[0]),
    }
