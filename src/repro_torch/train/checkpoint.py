"""Checkpoint / restart in the JAX reference's on-disk format (a port of
its ``train/checkpoint.py``).

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per leaf of the state
plus ``index.json`` (``step`` and, per leaf, ``name``, ``file``,
``shape``, ``dtype``).  Leaf names are the reference's: the path keys
joined by ``__`` (a ``TrainState``'s children ``0`` and ``1``, an
``OptState``'s ``.step`` / ``.m`` / ``.v``, dict keys sorted), so the
two packages read each other's checkpoints.  ``.npy`` has no bfloat16
without ``ml_dtypes``, which the port does not use: a bf16 leaf is
stored as its ``uint16`` bits with ``"bfloat16"`` in the index, and
restored bit for bit.

Saves copy every leaf to the host at call time; the file writes run on
a daemon thread unless ``blocking`` (async checkpointing: the training
loop, which updates its state in place, keeps stepping).  Writes go to
``step_<N>.tmp`` and are renamed when complete, so ``latest_step`` only
sees whole checkpoints.  ``restore`` loads every leaf onto the device
and dtype of the matching leaf of ``state_like``; restoring under a
sharding (``shardings=``) waits for ROADMAP 'Waiting 2'.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import OptState

_SHARDINGS = "ROADMAP 'Modules to port', Waiting 2: distribution"


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in the reference's order, or
    None for a leaf."""
    from repro_torch.train.loop import TrainState
    if isinstance(tree, TrainState):
        return [("0", tree.params), ("1", tree.opt_state)]
    if isinstance(tree, OptState):
        return [(f".{f}", getattr(tree, f)) for f in OptState._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten_with_names(tree: Any, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, torch.Tensor]]:
    kids = _children(tree)
    if kids is None:
        return [("__".join(prefix) or "leaf", tree)]
    return [named for k, c in kids
            for named in _flatten_with_names(c, prefix + (k,))]


def _rebuild(tree: Any, leaves: Dict[str, torch.Tensor],
             prefix: Tuple[str, ...] = ()) -> Any:
    """``tree`` with every leaf replaced by ``leaves[its name]``."""
    from repro_torch.train.loop import TrainState
    kids = _children(tree)
    if kids is None:
        return leaves["__".join(prefix) or "leaf"]
    new = [_rebuild(c, leaves, prefix + (k,)) for k, c in kids]
    if isinstance(tree, TrainState):
        return TrainState(*new)
    if isinstance(tree, OptState):
        return OptState(*new)
    if isinstance(tree, dict):
        return {k: v for (k, _), v in zip(kids, new)}
    return type(tree)(new)


def _to_host(x: Any) -> np.ndarray:
    """A copy of ``x`` on the host as numpy (bf16 as its uint16 bits)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(ckpt_dir: str, step: int, state: Any, *,
         blocking: bool = True) -> threading.Thread:
    """Write ``state`` under ``ckpt_dir/step_<step>``.  With
    ``blocking=False`` the device-to-host copy happens now but the file
    writes run on a daemon thread (join the returned thread)."""
    named = _flatten_with_names(state)
    host = [(n, _to_host(x),
             "bfloat16" if isinstance(x, torch.Tensor)
             and x.dtype == torch.bfloat16 else None) for n, x in named]

    def _write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        index: Dict[str, Any] = {"step": step, "leaves": []}
        for i, (name, arr, dtype) in enumerate(host):
            fn = f"{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            index["leaves"].append({"name": name, "file": fn,
                                    "shape": list(arr.shape),
                                    "dtype": dtype or str(arr.dtype)})
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "index.json"))]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str, like: torch.Tensor
               ) -> torch.Tensor:
    arr = np.array(arr, order="C")      # (ascontiguousarray makes 0-d 1-d)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, state_like: Any,
            shardings: Optional[Any] = None) -> Any:
    """Rebuild ``state_like``-shaped state from disk, each leaf on the
    device and in the dtype of ``state_like``'s leaf of the same name;
    a shape that differs raises."""
    if shardings is not None:
        raise NotImplementedError(
            f"restore(shardings=) is not ported yet ({_SHARDINGS})")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    by_name = {e["name"]: e for e in index["leaves"]}
    out = {}
    for name, like in _flatten_with_names(state_like):
        entry = by_name[name]
        arr = np.load(os.path.join(path, entry["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {name}: shape {arr.shape}, "
                             f"the state has {tuple(like.shape)}")
        out[name] = _from_host(arr, entry["dtype"], like)
    return _rebuild(state_like, out)
