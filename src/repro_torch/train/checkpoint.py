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
and dtype of the matching leaf of ``state_like``.

Sharded state (``DTensor`` leaves, a sharded train step's): ``save``
(every rank calls it) writes the same files from rank 0, each leaf
gathered one shard at a time straight into its memory-mapped ``.npy``
(rank 0 receives each other rank's block in turn; no rank ever holds a
whole leaf, in device memory or on the host), during the call.
``restore(shardings=)`` maps each leaf's file and reads only this rank's
block of it (``logical.local_box``), which becomes the local tensor of a
DTensor laid out by the matching ``NamedSharding``
(``train.loop.state_shardings``) on the CURRENT mesh: the reference's
elastic resharding by ``device_put`` per leaf, so a checkpoint written
by one rank restarts on a (2, 2) mesh and back.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.logical import local_box
from repro_torch.train.optimizer import OptState


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


def _host_bits(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bf16 as its uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_host(x: Any) -> np.ndarray:
    """A copy of ``x`` on the host as numpy (bf16 as its uint16 bits)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    return _host_bits(x.detach().to("cpu", copy=True))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _gather_into(path: Optional[str], x: DTensor) -> None:
    """Write the sharded leaf ``x`` to the ``.npy`` file ``path`` on
    rank 0 (``path`` None elsewhere), one block at a time: each distinct
    block is sent by the first rank (in mesh order) that holds it and
    copied into the memory-mapped file, so no rank holds the whole
    leaf.  Every rank of ``x``'s mesh calls it."""
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    pl, shape = tuple(x.placements), tuple(x.shape)
    local = x.to_local().detach()
    me = dist.get_rank()
    out = None
    if path is not None:
        out = np.lib.format.open_memmap(path, mode="w+", shape=shape,
                                        dtype=_np_dtype(x.dtype))
    seen = set()
    for coord in np.ndindex(*mesh.shape):
        box = local_box(shape, mesh, pl, coord)
        if box in seen or 0 in box[1]:
            continue
        seen.add(box)
        owner = int(mesh.mesh[coord])
        if me == owner and out is None:
            dist.send(local.contiguous(), dst=0)
        if out is None:
            continue
        if me == owner:
            blk = local
        else:
            blk = torch.empty(box[1], dtype=local.dtype, device=local.device)
            dist.recv(blk, src=owner)
        region = tuple(slice(o, o + n) for o, n in zip(*box))
        out[region] = _host_bits(blk.to("cpu"))
    if out is not None:
        out.flush()


def save(ckpt_dir: str, step: int, state: Any, *,
         blocking: bool = True) -> threading.Thread:
    """Write ``state`` under ``ckpt_dir/step_<step>``.  With
    ``blocking=False`` the device-to-host copy happens now but the file
    writes run on a daemon thread (join the returned thread).  Sharded
    leaves are written from rank 0 during the call, one shard at a time
    (every rank calls it); the rest, the index and the rename follow on
    the thread."""
    named = _flatten_with_names(state)
    sharded = any(isinstance(x, DTensor) for _, x in named)
    writer = not sharded or dist.get_rank() == 0
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if writer:
        os.makedirs(tmp, exist_ok=True)
    index: Dict[str, Any] = {"step": step, "leaves": []}
    host = []
    for i, (name, x) in enumerate(named):
        fn = f"{i:05d}.npy"
        bf16 = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
        if isinstance(x, DTensor):
            _gather_into(os.path.join(tmp, fn) if writer else None, x)
            shape, dtype = list(x.shape), str(_np_dtype(x.dtype))
        elif writer:
            arr = _to_host(x)
            shape, dtype = list(arr.shape), str(arr.dtype)
            host.append((fn, arr))
        else:
            continue
        index["leaves"].append({"name": name, "file": fn, "shape": shape,
                                "dtype": "bfloat16" if bf16 else dtype})

    def _write():
        if not writer:
            return
        for fn, arr in host:
            np.save(os.path.join(tmp, fn), arr)
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
    """Rebuild ``state_like``-shaped state from disk, each leaf in the
    dtype of ``state_like``'s leaf of the same name and on its device;
    with ``shardings`` (a NamedSharding tree of the state's structure),
    each leaf a DTensor laid out by its sharding on the current mesh,
    of which this rank reads only its own block from the file (every
    rank calls it).  A shape that differs raises."""
    shard_of = dict(_flatten_with_names(shardings)) \
        if shardings is not None else {}
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    by_name = {e["name"]: e for e in index["leaves"]}
    out = {}
    for name, like in _flatten_with_names(state_like):
        entry = by_name[name]
        arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {name}: shape {arr.shape}, "
                             f"the state has {tuple(like.shape)}")
        if name in shard_of:
            sh = shard_of[name]
            mesh, pl = sh.mesh, sh.placements
            box = local_box(arr.shape, mesh, pl)
            block = arr[tuple(slice(o, o + n) for o, n in zip(*box))]
            local = _from_host(block, entry["dtype"], torch.empty(
                (), dtype=like.dtype, device=mesh.device_type))
            out[name] = DTensor.from_local(
                local, mesh, pl, run_check=False, shape=arr.shape,
                stride=torch.empty(arr.shape, device="meta").stride())
        else:
            out[name] = _from_host(arr, entry["dtype"], like)
    return _rebuild(state_like, out)
