"""Atomic checkpoints of nested dicts of tensors: save, manifest, restore
onto a device (counterpart of ``repro.checkpoint.checkpoint``).

The on-disk format is the reference's: one ``.npy`` per leaf, named by
its key path with ``/`` replaced by ``__``, and a ``manifest.json``
holding ``step``, ``keys`` (per leaf its file, shape and dtype, or the
empty-dict marker) and any ``extra_meta``.  A save writes a ``.tmp``
directory and renames it into place, so a crash mid-save never leaves a
half-written checkpoint where :func:`latest_step` and :func:`restore`
look; a stale ``.tmp`` directory is ignored.

Dtypes are numpy's names (``float32``, ``int32``), so fp32 and integer
checkpoints pass between this package and the reference both ways.
bfloat16 has no numpy dtype (``Tensor.numpy()`` refuses it): its leaves
are stored as their uint16 bits under the dtype ``"bfloat16"``, and
restore reads those bits back, as it does the reference's own bf16 files
(numpy saves those as ``'<V2'``, two opaque bytes).

``restore`` places every leaf on ``device`` in place of the reference's
``NamedSharding``s; like every entry point of the port it defaults to the
card and raises without one unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.device import resolve_device

SEP = "/"
BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix[:-1] + "{}"] = None   # empty-dict marker
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(SEP)
        if parts[-1].endswith("{}"):      # empty-dict marker
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            if parts[-1] != "{}":
                node.setdefault(parts[-1][:-2], {})
            continue
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the array written to disk, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:                     # uint16 bits, or the reference's V2
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str, step: int, state_tree, extra_meta: dict | None = None):
    """Atomic checkpoint of a tree of dicts whose leaves are tensors (on
    any device), numpy arrays or scalars."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state_tree)
    manifest = {"step": int(step), "keys": {}, **(extra_meta or {})}
    for path, leaf in flat.items():
        if path.endswith("{}"):           # empty-dict structure marker
            manifest["keys"][path] = {"empty": True}
            continue
        arr, dtype = _host(leaf)
        fname = path.replace(SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["keys"][path] = {"file": fname, "shape": list(arr.shape),
                                  "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int | None = None, device="cuda"):
    """Load a checkpoint (the newest complete one when ``step`` is None)
    as a tree of tensors on ``device``; returns ``(tree, manifest)``, or
    ``(None, None)`` when there is none."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for path, meta in manifest["keys"].items():
        flat[path] = (None if meta.get("empty") else _tensor(
            np.load(os.path.join(d, meta["file"])), meta["dtype"], dev))
    return _unflatten(flat), manifest


def prune(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted([int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                    if d.startswith("step_") and not d.endswith(".tmp")])
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
