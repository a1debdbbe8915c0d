"""The port of ``repro.checkpoint.ckpt``.

A state is a tree of tensors: nested dicts, named tuples (the optimizer's
:class:`~repro_torch.optim.OptState`) and lists.  A leaf's key is its path
joined by ``/``, spelled as the reference's ``jax`` tree paths print: a dict
key as itself, a named-tuple field as ``.name``, a list index as its
number.  A train state ``{"params": p, "opt": OptState}`` therefore writes
``params/embed``, ``opt/.step``, ``opt/.mu/embed``, ... as the reference
does.  numpy has no bfloat16: a bfloat16 leaf is written as float32
(exactly), and a load casts every array to its template leaf's dtype.

A DTensor leaf (a state sharded over a ``DeviceMesh``) is saved whole: every
rank of the mesh gathers it (a collective, so every rank snapshots the same
tree), and only the rank whose manager writes (``writer=True``, rank 0)
writes it.  A DTensor leaf of the template restores as this rank's shard of
the whole array, so a checkpoint does not depend on the mesh that wrote it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.errors import detached


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` for every leaf of ``tree``."""
    if isinstance(tree, dict):
        kids = ((str(k), v) for k, v in tree.items())
    elif _is_namedtuple(tree):
        kids = ((f".{f}", getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        kids = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _paths(v, f"{prefix}/{k}" if prefix else k)


def map_state(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` over ``tree``, keeping its structure."""
    join = lambda k: f"{prefix}/{k}" if prefix else k
    if isinstance(tree, dict):
        return {k: map_state(fn, v, join(str(k))) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_state(fn, getattr(tree, f), join(f".{f}")) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_state(fn, v, join(str(i))) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_host(leaf, copy: bool = False) -> np.ndarray:
    """``leaf`` as a host array.  With ``copy``, one that later in-place
    updates of ``leaf`` do not reach: ``.numpy()`` of a float32 CPU tensor
    shares its memory (a bfloat16 or CUDA leaf is copied anyway)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if isinstance(leaf, DTensor):  # collective: every rank of its mesh gathers it
            leaf = leaf.full_tensor()
            copy = False  # a fresh tensor
        if leaf.dtype == torch.bfloat16:
            return leaf.float().cpu().numpy()
        host = leaf.cpu().numpy()
        return host.copy() if copy and leaf.device.type == "cpu" else host
    return np.array(leaf) if copy else np.asarray(leaf)


def flatten_state(tree, copy: bool = False) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a host array, by its checkpoint key."""
    return {key: _to_host(leaf, copy) for key, leaf in _paths(tree)}


def _unflatten_into(template, arrays: Dict[str, np.ndarray], device: torch.device):
    def leaf(key, like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {key}: shape {arr.shape} != expected {tuple(like.shape)}")
        t = torch.as_tensor(arr).to(device=device, dtype=like.dtype)
        if not isinstance(like, DTensor):
            return t
        from repro_torch.models.sharding import from_whole

        return from_whole(t, like.device_mesh, like.placements)

    return map_state(leaf, template)


def save_checkpoint(directory: str, step: int, state, extra: Optional[dict] = None) -> str:
    """Atomic synchronous save. ``state`` is a tree of tensors (or numpy arrays)."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = flatten_state(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": int(step), "extra": extra or {}, "n_leaves": len(arrays)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def _steps(directory: str) -> list:
    return [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def load_checkpoint(directory: str, template, step: Optional[int] = None,
                    device: DeviceLike = None) -> Tuple[Any, dict]:
    """Restore ``template``-shaped state onto ``device`` (default: the CUDA
    device).  ``template`` gives each leaf's shape and dtype; its leaves may
    be meta tensors."""
    device = resolve_device(device)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return _unflatten_into(template, arrays, device), manifest


class CheckpointManager:
    """Async checkpointing: the state is snapshot to host numpy on the
    caller's thread, then written on a worker thread.  A failed write is
    raised by the next :meth:`wait` (and so by the next save), with its
    traceback's text as a note: the traceback itself would hold the worker's
    frames, and through them the whole host snapshot, until then."""

    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.directory = directory
        self.keep = keep
        #: whether this manager writes; a mesh's other ranks only take part
        #: in gathering the snapshot
        self.writer = writer
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, state, extra: Optional[dict] = None) -> None:
        self.wait()  # bound outstanding writes to one
        snapshot = map_state(lambda _, leaf: _to_host(leaf, copy=True), state)  # host copy now
        if not self.writer:
            return

        def _work():
            try:
                save_checkpoint(self.directory, step, snapshot, extra)
                self._gc()
            except Exception as e:  # handed to the caller by wait()
                self._error = detached(e)

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def restore(self, template, step: Optional[int] = None, device: DeviceLike = None):
        return load_checkpoint(self.directory, template, step, device)
