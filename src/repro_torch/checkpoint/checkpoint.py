"""Checkpointing with atomic commit (the port of ``repro.checkpoint.checkpoint``).

Layout: ``<dir>/step_<N>.tmp/`` -> (write ``arrays.npz`` + ``manifest.json``)
-> atomic rename to ``<dir>/step_<N>/``. A crash mid-write leaves only a
``.tmp`` directory, which ``latest_step`` and ``restore_checkpoint`` ignore:
a restart resumes from the last COMMITTED step.

``arrays.npz`` holds one full array per leaf, ``leaf_0`` ... ``leaf_{k-1}``, in
the order ``repro_torch.tree.leaves`` walks the state: dict keys sorted,
lists in order, as ``jax.tree`` walks the reference's pytrees. So a
checkpoint written by the reference restores here and one written here
restores in the reference, for state made of dicts, lists and arrays (the
engines' state dicts are). One difference: ``tree.leaves`` takes a tuple as
one leaf where ``jax.tree`` walks into it, so a state holding tuples would
not share the layout.

The manifest's ``treedef`` is a description for readers; restoring takes
the structure from ``like``. Each restored leaf takes the kind of its
``like`` leaf: a tensor comes back as a tensor on that tensor's device,
anything else as a numpy array.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _treedef(tree) -> str:
    """A readable description of ``tree``'s structure (manifest only)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(x) for x in tree) + "]"
    return "*"


def save_checkpoint(directory: str | os.PathLike, step: int, state) -> str:
    """Write ``state`` as step ``step`` under ``directory``; returns the
    committed step directory."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"step_{step:09d}.tmp"
    final = d / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = [_to_numpy(x) for x in leaves(state)]
    np.savez(tmp / "arrays.npz", **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "treedef": _treedef(state),
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    return str(final)


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest committed step under ``directory``, or None."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str | os.PathLike, like, step: int | None = None):
    """Restore into the structure of ``like``; returns ``(state, step)``.

    ``step`` None takes the newest committed step. Raises
    ``FileNotFoundError`` when there is none, and ``ValueError`` when the
    checkpoint's leaf count differs from ``like``'s.
    """
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {d}")
    final = d / f"step_{step:09d}"
    like_leaves = leaves(like)
    with np.load(final / "arrays.npz") as data:
        if len(like_leaves) != len(data.files):
            raise ValueError(f"leaf count mismatch: ckpt {len(data.files)} "
                             f"vs target {len(like_leaves)}")
        out = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
    out = [torch.as_tensor(a, device=ref.device) if isinstance(ref, torch.Tensor) else a
           for a, ref in zip(out, like_leaves)]
    return unflatten(like, out), step
