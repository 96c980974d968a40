"""Tree checkpoints: npz arrays plus a JSON manifest, in the JAX
package's on-disk layout (counterpart of ``repro.ckpt.checkpoint``).

Layout: ``<dir>/step_<n:08d>/arrays.npz`` + ``manifest.json``.  A tree is
nested dicts, lists and tuples of tensors, numpy arrays and Python
numbers.  Each leaf is keyed by its ``/``-joined path: dict keys as they
are, list and tuple slots by index.  A dotted key is a flattened path:
the port's parameter dicts name JAX's nested leaves ``blocks.ln1``, and
they are written ``blocks/ln1``, as JAX's nested tree writes them, so a
checkpoint carries across the two packages both ways.  bfloat16 leaves
are written as a uint16 view marked ``"bfloat16"`` (npz has no bf16).
The write goes to a temporary directory, then a rename.

Both directions move one leaf at a time: the save streams each leaf into
the archive as it comes off its device, and :func:`load_checkpoint_into`
copies each leaf into a live tree in place, so neither holds a second
copy of the tree, on the host or on the card.

One process per worker: a state's per-worker leaves (those under
``row_keys``) hold a rank's (1, ...) row.  :func:`save_checkpoint` with a
``group`` writes from rank 0 alone, each such leaf as the (n, ...) array
the one-process state holds, its rows gathered to rank 0 one at a time
and streamed into the member; :func:`load_checkpoint_into` with ``row``
reads that rank's row of each such member by its offset in the stored
archive, never the whole leaf.  The layout is the same either way, so a
checkpoint carries between one process, ranks and JAX.

A worker spread over a model axis (``blocks``, a
:class:`repro_torch.dist.tp.CheckpointBlocks`): every rank holds its
block of each leaf, and of each per-worker row.  The save still writes
whole leaves from global rank 0: each leaf is gathered whole over "data"
and "model" one at a time, a per-worker row whole over its worker's model
ranks, and then, as at model 1, rank 0 takes every worker's row from the
workers' first model ranks one at a time.  On restore each rank reads the
whole leaf (a per-worker leaf: its worker's row) and keeps its block.  So
no rank holds more than one whole leaf at a time, and a checkpoint
carries between one process and ranks at any (data, model).
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import tempfile
import zipfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _leaves(tree, prefix: str = ""):
    """(path, leaf) pairs in tree order; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{str(k).replace('.', '/')}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


class _Stage:
    """One host buffer that a save copies each device leaf into, kept
    and grown to the largest leaf, so that no leaf faults fresh pages
    in."""

    def __init__(self):
        self.buf = torch.empty(0, dtype=torch.uint8)

    def host(self, leaf: torch.Tensor) -> torch.Tensor:
        """A host copy of ``leaf`` (as is, if it is on the host), a view
        of the buffer valid until the next call."""
        if leaf.device.type == "cpu":
            return leaf
        n = leaf.numel() * leaf.element_size()
        if self.buf.numel() < n:
            self.buf = torch.empty(0, dtype=torch.uint8)
            self.buf = torch.empty(n, dtype=torch.uint8)
        return self.buf[:n].view(leaf.dtype).view(leaf.shape).copy_(leaf)


def _to_numpy(leaf, stage: _Stage) -> tuple:
    """(array, manifest dtype) of one leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = stage.host(leaf.detach())
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_array(f, arr: np.ndarray) -> None:
    """``arr`` as a .npy member: its header, then its bytes in one
    write."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    np.lib.format.write_array_header_1_0(
        f, np.lib.format.header_data_from_array_1_0(arr))
    f.write(memoryview(arr.reshape(-1)).cast("B"))


def _is_row_leaf(key: str, row_keys) -> bool:
    return key.split("/", 1)[0] in row_keys


def _write_rows(f, group, row: torch.Tensor, stage: _Stage) -> str:
    """Rank 0's side of a per-worker leaf (``row``: its own worker's row):
    the .npy header of the (n, ...) array, then every worker's row as it
    arrives; returns the manifest dtype."""
    dtype = {}

    def sink(worker: int, row: torch.Tensor) -> None:
        arr, dtype["name"] = _to_numpy(row, stage)
        if worker == 0:
            np.lib.format.write_array_header_1_0(f, {
                "descr": np.lib.format.dtype_to_descr(arr.dtype),
                "fortran_order": False,
                "shape": (group.n,) + tuple(arr.shape)})
        f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))

    group.gather_to_root(row, sink)
    return dtype["name"]


def _whole(key: str, leaf, group, row_keys, blocks):
    """(whether ``key`` is a per-worker leaf, this worker's whole row of
    it or the whole leaf): the collectives over "data" and "model" that
    ``blocks`` runs (none without it)."""
    if group is not None and _is_row_leaf(key, row_keys):
        row = leaf[0]
        return True, row if blocks is None else blocks.whole_row(key, row)
    return False, leaf if blocks is None else blocks.whole(key, leaf)


def save_checkpoint(directory: str | os.PathLike, step: int,
                    tree: Any, group=None, row_keys=(),
                    blocks=None) -> Optional[Path]:
    """Write ``tree`` as ``<directory>/step_<step:08d>``; returns that path.

    With ``group`` every rank calls it: a leaf under a key of ``row_keys``
    is this rank's (1, ...) row of an (n, ...) leaf, gathered to rank 0,
    which writes the archive (the other ranks return None).  With
    ``blocks`` (a worker over a model axis) each leaf, and each row, is
    this rank's block of it, gathered whole first (see the module note).
    """
    if group is not None and (group.worker != 0 or group.m != 0):
        for key, leaf in _leaves(tree):
            is_row, whole = _whole(key, leaf, group, row_keys, blocks)
            if is_row and group.m == 0:
                group.gather_to_root(whole)
            del whole
        return None
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    try:
        # np.savez's archive (stored, zip64 members ``<key>.npy``), written
        # leaf by leaf
        stage = _Stage()
        with zipfile.ZipFile(tmp / "arrays.npz", "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in _leaves(tree):
                is_row, whole = _whole(key, leaf, group, row_keys, blocks)
                with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                    if is_row:
                        manifest["leaves"][key] = _write_rows(f, group,
                                                              whole, stage)
                        continue
                    arr, manifest["leaves"][key] = _to_numpy(whole, stage)
                    _write_array(f, arr)
                    del arr
                del whole
        del stage
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = directory / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        return final
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    """The highest saved step under ``directory``, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")]
    return max(steps) if steps else None


class _Reader:
    """The leaves of ``<directory>/step_<step:08d>`` as host tensors.

    A stored member (every member the port writes) is read by its offset
    in the archive straight into one host buffer that the reader keeps
    and reuses (grown to the largest leaf read), so a restore faults no
    fresh pages in and runs no CRC pass leaf by leaf; what a read returns
    is a view of that buffer, valid until the next read.  A compressed
    member goes through numpy, whole."""

    def __init__(self, directory, step: int):
        d = Path(directory) / f"step_{step:08d}"
        self.manifest = json.loads((d / "manifest.json").read_text())
        self.path = d / "arrays.npz"
        self.data = np.load(self.path)
        self._stage = np.empty(0, np.uint8)

    def _tensor(self, key: str, arr: np.ndarray) -> torch.Tensor:
        if self.manifest["leaves"][key] == _BF16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    def _array(self, key: str, r: Optional[int] = None) -> np.ndarray:
        """Member ``key`` (its row ``r`` of the (n, ...) array), read into
        the reused buffer when the member is stored."""
        info = self.data.zip.getinfo(f"{key}.npy")
        if info.compress_type != zipfile.ZIP_STORED:
            arr = self.data[key]
            return arr if r is None else arr[r]
        with open(self.path, "rb") as f:
            f.seek(info.header_offset + 26)
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f) if version ==
                (1, 0) else np.lib.format.read_array_header_2_0(f))
            if fortran and r is None:
                return self.data[key]
            if r is not None:
                if fortran or not 0 <= r < shape[0]:
                    raise ValueError(f"{key}: no row {r} in a stored "
                                     f"{shape} array (fortran {fortran})")
                shape = shape[1:]
                f.seek(r * math.prod(shape) * dtype.itemsize, os.SEEK_CUR)
            nbytes = math.prod(shape) * dtype.itemsize
            if self._stage.size < nbytes:
                self._stage = np.empty(0, np.uint8)
                self._stage = np.empty(nbytes, np.uint8)
            view = memoryview(self._stage[:nbytes])
            got = 0
            while got < nbytes:
                k = f.readinto(view[got:])
                if not k:
                    raise ValueError(f"{key}: the archive ends inside the "
                                     f"member")
                got += k
        return self._stage[:nbytes].view(dtype).reshape(shape)

    def __call__(self, key: str, leaf, cut=None) -> torch.Tensor:
        """Leaf ``key`` (``cut`` of it), checked against the shape of
        ``leaf``."""
        got = self._tensor(key, self._array(key))
        if cut is not None:
            got = cut(key, got)
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(got.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(got.shape)} != {shape}")
        return got

    def row(self, key: str, r: int, leaf: torch.Tensor,
            cut=None) -> torch.Tensor:
        """Row ``r`` of the (n, ...) leaf ``key`` (``cut`` of it), read by
        its offset in the stored member, checked against the (1, ...)
        ``leaf``."""
        got = self._tensor(key, self._array(key, r))
        if cut is not None:
            got = cut(key, got)
        want = tuple(leaf.shape[1:])
        if leaf.shape[0] != 1 or tuple(got.shape) != want:
            raise ValueError(f"{key}: row shape {tuple(got.shape)} != "
                             f"{want} (a leaf of {tuple(leaf.shape)})")
        return got


def load_checkpoint(directory: str | os.PathLike, step: int,
                    like: Any) -> Any:
    """Read ``<directory>/step_<step:08d>`` into the structure of ``like``.

    Each tensor leaf lands on the device and in the dtype of the matching
    ``like`` leaf (a shape mismatch raises); a Python number comes back as
    the same type; any other leaf as a numpy array.
    """
    read = _Reader(directory, step)

    def leaf_of(key, leaf):
        got = read(key, leaf)             # a view of the reader's buffer
        if isinstance(leaf, torch.Tensor):
            return got.to(device=leaf.device, dtype=leaf.dtype, copy=True)
        if isinstance(leaf, (bool, int, float)):
            return type(leaf)(got.item())
        return got.numpy().copy()

    def rebuild(tree, prefix: str = ""):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{str(k).replace('.', '/')}/")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        return leaf_of(prefix[:-1], tree)

    return rebuild(like)


@torch.no_grad()
def load_checkpoint_into(directory: str | os.PathLike, step: int,
                         tree: Any, row: Optional[int] = None,
                         row_keys=(), blocks=None) -> Any:
    """Read ``<directory>/step_<step:08d>`` into ``tree`` in place.

    One leaf at a time: a tensor leaf is overwritten (``copy_``, so it
    keeps its identity, device and dtype, and only one leaf's host copy
    is live); a number in a dict or list is replaced.  A shape mismatch
    raises.  With ``row`` (one process per worker) a leaf under a key of
    ``row_keys`` is a (1, ...) tensor that takes row ``row`` of the
    stored (n, ...) leaf.  With ``blocks`` (a worker over a model axis)
    a tensor leaf takes this rank's block of the stored leaf, or of the
    stored row.  Returns ``tree``.
    """
    read = _Reader(directory, step)
    cut = None if blocks is None else blocks.cut
    cut_row = None if blocks is None else blocks.cut_row

    def land(node, prefix: str) -> None:
        if isinstance(node, dict):
            items = [(k, f"{prefix}{str(k).replace('.', '/')}/")
                     for k in node]
        else:
            items = [(i, f"{prefix}{i}/") for i in range(len(node))]
        for k, path in items:
            leaf = node[k]
            if leaf is None:
                continue
            if isinstance(leaf, (dict, list, tuple)):
                land(leaf, path)
            elif isinstance(leaf, torch.Tensor):
                if row is not None and _is_row_leaf(path, row_keys):
                    leaf[0].copy_(read.row(path[:-1], row, leaf, cut_row))
                else:
                    leaf.copy_(read(path[:-1], leaf, cut))
            elif isinstance(leaf, (bool, int, float)):
                node[k] = type(leaf)(read(path[:-1], leaf).item())
            else:
                leaf[...] = read(path[:-1], leaf).numpy()

    land(tree, "")
    return tree
