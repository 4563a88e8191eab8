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

A restore reads the members of ``arrays.npz`` (stored uncompressed, as
``np.savez`` writes them in both packages) in place from a memory map,
checking each one's CRC-32 in a pool of threads while the arrays are copied
out, instead of streaming them through ``np.load``: the same arrays and the
same integrity check, several times faster for the multi-GB state of a
full-width LM. A compressed member is refused.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os
import pathlib
import shutil
import struct
import zipfile
import zlib

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
    path = final / "arrays.npz"
    members = _stored_members(path)
    if len(like_leaves) != len(members):
        raise ValueError(f"leaf count mismatch: ckpt {len(members)} "
                         f"vs target {len(like_leaves)}")
    return unflatten(like, _read_stored(path, members, like_leaves)), step


def _stored_members(path) -> dict:
    """``{name: (offset, size, crc)}`` of the data of each member of the zip
    archive at ``path``; a compressed member raises ``ValueError``."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed; checkpoints are "
                                 f"written by np.savez, uncompressed")
            f.seek(info.header_offset)
            head = f.read(30)
            if head[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: bad local header for {info.filename}")
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            out[info.filename] = (info.header_offset + 30 + name_len + extra_len,
                                  info.file_size, info.CRC)
    return out


def _npy_view(raw: np.ndarray) -> np.ndarray:
    """The array an ``.npy`` image ``raw`` (uint8) holds, as a view of it."""
    fp = io.BytesIO(raw[:min(raw.size, 1 << 16)].tobytes())
    version = np.lib.format.read_magic(fp)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(fp)
    if dtype.hasobject:
        raise ValueError("object arrays are not checkpoint leaves")
    n = int(np.prod(shape)) * dtype.itemsize
    flat = raw[fp.tell():fp.tell() + n].view(dtype)
    return flat.reshape(shape, order="F" if fortran else "C")


def _read_stored(path, members: dict, like_leaves: list) -> list:
    """Each ``leaf_i`` of the stored archive at ``path`` as its ``like``
    leaf's kind, read from a memory map; every member's CRC-32 is checked
    (in threads, which ``zlib`` lets run without the interpreter lock)."""
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    spans = [members[f"leaf_{i}.npy"] for i in range(len(like_leaves))]

    def crc_ok(span):
        off, size, crc = span
        return zlib.crc32(buf[off:off + size]) == crc

    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        crcs = pool.map(crc_ok, spans)
        out = []
        for (off, size, _), ref in zip(spans, like_leaves):
            a = _npy_view(buf[off:off + size])
            out.append(torch.from_numpy(a).to(ref.device, copy=True)
                       if isinstance(ref, torch.Tensor) else np.array(a))
        bad = [i for i, ok in enumerate(crcs) if not ok]
    del buf
    if bad:
        raise ValueError(f"{path}: CRC-32 mismatch in leaf_{bad[0]}")
    return out
