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
"""
from __future__ import annotations

import json
import os
import shutil
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


def _to_numpy(leaf) -> tuple:
    """(array, manifest dtype) of one leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
        arr = leaf.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str | os.PathLike, step: int,
                    tree: Any) -> Path:
    """Write ``tree`` as ``<directory>/step_<step:08d>``; returns that path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    try:
        # np.savez's archive (stored, zip64 members ``<key>.npy``), written
        # leaf by leaf
        with zipfile.ZipFile(tmp / "arrays.npz", "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in _leaves(tree):
                arr, manifest["leaves"][key] = _to_numpy(leaf)
                with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(arr))
                del arr
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
    """The leaves of ``<directory>/step_<step:08d>`` as host tensors."""

    def __init__(self, directory, step: int):
        d = Path(directory) / f"step_{step:08d}"
        self.manifest = json.loads((d / "manifest.json").read_text())
        self.data = np.load(d / "arrays.npz")

    def __call__(self, key: str, leaf) -> torch.Tensor:
        """Leaf ``key``, checked against the shape of ``leaf``."""
        arr = self.data[key]
        if self.manifest["leaves"][key] == _BF16:
            got = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            got = torch.from_numpy(arr)
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(got.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(got.shape)} != {shape}")
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
        got = read(key, leaf)
        if isinstance(leaf, torch.Tensor):
            return got.to(device=leaf.device, dtype=leaf.dtype)
        if isinstance(leaf, (bool, int, float)):
            return type(leaf)(got.item())
        return got.numpy()

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
                         tree: Any) -> Any:
    """Read ``<directory>/step_<step:08d>`` into ``tree`` in place.

    One leaf at a time: a tensor leaf is overwritten (``copy_``, so it
    keeps its identity, device and dtype, and only one leaf's host copy
    is live); a number in a dict or list is replaced.  A shape mismatch
    raises.  Returns ``tree``.
    """
    read = _Reader(directory, step)

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
                leaf.copy_(read(path[:-1], leaf))
            elif isinstance(leaf, (bool, int, float)):
                node[k] = type(leaf)(read(path[:-1], leaf).item())
            else:
                leaf[...] = read(path[:-1], leaf).numpy()

    land(tree, "")
    return tree
