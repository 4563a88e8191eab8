"""Sharding specs on a ``distribution.compat`` mesh (the part of
``repro.distribution.sharding`` that the GNN family's ``build_train``
returns).

``P`` is a ``PartitionSpec``: one entry a dimension, each an axis name, a
tuple of names (the dimension sharded over all of them, flattened) or None
(not sharded); ``P()`` is replicated. ``NamedSharding`` binds a spec to a
compat ``Mesh``. They describe placements; the GNN path realises them itself
(``models/gnn/steps.stage_batch``, ``models/gnn/common.py``'s row blocks).

``ShardingRules``, ``lm_rules``, ``lm_param_specs`` and ``constrain`` come
with the LM slice, which needs a two-axis (``data`` x ``model``) mesh:
ROADMAP.md Queue A item 12b.
"""

from __future__ import annotations

import dataclasses

from repro_torch.distribution.compat import Mesh


class P(tuple):
    """A partition spec: ``P(entry, ...)``, a tuple of its entries, a tuple
    of one name taken as the name (equal to ``jax.sharding.PartitionSpec``'s
    tuple of the same entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> tuple[str, ...]:
        """Every axis name the spec shards over."""
        out = []
        for e in self:
            out.extend(e if isinstance(e, tuple) else (() if e is None else (e,)))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh``: every axis it names is one of the mesh's."""

    mesh: Mesh
    spec: P

    def __post_init__(self):
        unknown = set(self.spec.axes()) - set(self.mesh.axis_names)
        if unknown:
            raise ValueError(f"spec {self.spec} names {sorted(unknown)}, not axes of the mesh "
                             f"{self.mesh.axis_names}")
