"""A process group that stages every collective through host memory around gloo.

Gloo's collectives run on host tensors.  On CUDA tensors some of them have a
path and some do not: on torch 2.11 the all-gather that DTensor issues
(``_functional_collectives.all_gather_tensor``) ends the process with a
segmentation fault (``repro_torch.launch.mesh.GLOO_CUDA_MISSING``).  One
card cannot hold a NCCL world of two ranks either, so a DTensor program of
several ranks on one card needs a group that moves CUDA tensors through the
host itself.

:class:`StagedProcessGroup` is that group, registered with
``torch.distributed`` under the backend name :data:`BACKEND`
(:func:`register`).  Each instance wraps a ``ProcessGroupGloo`` on the store,
rank and size it is given.  A collective copies every input into a fresh
host buffer (and allocates a host buffer for every output), runs the same
collective of the gloo group on those buffers, waits for it, copies the
outputs back into the caller's tensors and returns a completed ``Work``
whose future holds them.  The host buffers of CUDA tensors are pinned (the
CUDA caching host allocator keeps them for the next call of that size).
Host tensors take the same path as CUDA tensors, so a world of CPU ranks
tests the code that CUDA ranks run.  Reductions
happen inside gloo, on the same host data, so a staged world gives the bits
of a plain gloo world.  An error of gloo propagates as it is: nothing is
retried, and nothing is carried to another device.

Point-to-point ``send`` / ``recv`` are the exception: a gloo send completes
only once its peer has posted the receive, so they return a ``Work`` whose
``wait`` waits for gloo and then copies the received bytes back.

The group implements the collectives the port's DTensor programs, launchers
and exchange issue, under the names of both torch 2.11 and 2.13
(``_allgather_base`` is ``all_gather_single`` in 2.13, and so on); a
collective it lacks raises from ``torch.distributed`` as on any backend.

:data:`STATS` counts, per collective name, this process's staged calls,
their host-wall seconds (copies and gloo) and the bytes they staged in and
out; :func:`stats` reads it.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import torch
import torch.distributed as dist

#: the backend name a process group, ``run_world`` or ``make_exchange_group``
#: is given for this group
BACKEND = "staged"

#: collectives whose first argument is their output, each under its torch
#: 2.11 and its 2.13 name (a name the installed torch lacks is never
#: called): the functional collectives' coalesced all-gather and
#: reduce-scatter and their all-to-all, ``torch.distributed``'s all-gathers,
#: reduce-scatter and gather, and DTensor's scatter
_OUT_FIRST = (
    "allgather", "_allgather_base", "all_gather_single", "allgather_into_tensor_coalesced",
    "all_gather_single_coalesced", "_reduce_scatter_base", "reduce_scatter_single",
    "reduce_scatter_tensor_coalesced", "reduce_scatter_single_coalesced", "alltoall_base", "all_to_all_single",
    "gather", "scatter",
)
#: collectives whose first argument is both their input and their output
_IN_PLACE = ("allreduce", "broadcast")

#: per collective name: calls, host-wall seconds and bytes staged (in + out)
STATS: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)


def stats() -> Dict[str, dict]:
    """This process's staged collectives so far: ``{name: {"calls",
    "seconds", "bytes"}}``."""
    return {name: dict(c) for name, c in STATS.items()}


def _count(name: str, t0: float, *trees) -> None:
    c = STATS[name]
    c["calls"] += 1
    c["seconds"] += time.perf_counter() - t0
    c["bytes"] += sum(t.numel() * t.element_size() for tree in trees for t in _tensors(tree))


def register() -> None:
    """Register :data:`BACKEND` with ``torch.distributed`` in this process
    (for CPU and CUDA tensors); a second call does nothing."""
    if hasattr(dist.Backend, BACKEND.upper()):
        return
    dist.Backend.register_backend(BACKEND, _create, extended_api=True, devices=["cpu", "cuda"])


def _create(opts, backend_options=None) -> "StagedProcessGroup":
    return StagedProcessGroup(opts.store, opts.group_rank, opts.group_size, opts.timeout, opts.group_id)


def _host(x, copy: bool):
    """``x`` (a tensor or nested lists of them) as fresh contiguous host
    tensors, pinned for CUDA tensors: holding ``x``'s values where ``copy``,
    else uninitialised."""
    if isinstance(x, torch.Tensor):
        buf = torch.empty(x.shape, dtype=x.dtype, device="cpu", pin_memory=x.is_cuda)
        return buf.copy_(x) if copy else buf
    if isinstance(x, (list, tuple)):
        return [_host(y, copy) for y in x]
    return x


def _copy_back(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_back(d, s)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _completed(out) -> dist.Work:
    """A finished ``Work`` whose future holds ``out`` (its CUDA devices
    declared, as a future holding CUDA tensors must)."""
    from torch._C._distributed_c10d import _create_work_from_future

    devices = sorted({t.device for t in _tensors(out) if t.device.type == "cuda"}, key=str)
    fut = torch.futures.Future(devices=devices or None)
    fut.set_result(out)
    return _create_work_from_future(fut)


def _staged(name: str, in_place: bool):
    def collective(self, out, *args, **kwargs):
        t0 = time.perf_counter()
        host_out = _host(out, copy=in_place)
        getattr(self._gloo, name)(host_out, *(_host(a, copy=True) for a in args), **kwargs).wait()
        _copy_back(out, host_out)
        _count(name, t0, out, args)
        return _completed(out)

    collective.__name__ = collective.__qualname__ = name
    collective.__doc__ = f"``{name}`` of gloo on host copies; the outputs copied back into the caller's."
    return collective


class _Pending(dist.Work):
    """A point-to-point ``Work`` of gloo: ``wait`` waits for it, then runs
    ``done`` (the copy of a received buffer into the caller's tensors)."""

    def __init__(self, work, done=None):
        super().__init__()
        self._work, self._done = work, done

    def wait(self, timeout=None) -> bool:
        self._work.wait()
        if self._done is not None:
            self._done()
            self._done = None
        return True

    def is_completed(self) -> bool:
        return self._done is None and self._work.is_completed()


class StagedProcessGroup(dist.ProcessGroup):
    """A process group of ``size`` ranks over ``store`` whose collectives
    stage their tensors, of any device, through host memory around a gloo
    group (see the module's docstring)."""

    def __init__(self, store, rank: int, size: int, timeout, name: str):
        super().__init__(rank, size)
        self._name = name
        gloo = dist.ProcessGroupGloo(store, rank, size, timeout=timeout)
        # a ProcessGroup over the gloo backend takes every collective by its
        # ProcessGroup name, as this group is called
        self._gloo = dist.ProcessGroup(store, rank, size)
        self._gloo._register_backend(torch.device("cpu"), dist.ProcessGroup.BackendType.GLOO, gloo)
        self._gloo._set_default_backend(dist.ProcessGroup.BackendType.GLOO)

    @property
    def group_name(self) -> str:
        # the functional collectives look a group up by this name
        return self._name

    def getBackendName(self) -> str:
        return BACKEND

    for _name in _OUT_FIRST:
        locals()[_name] = _staged(_name, in_place=False)
    for _name in _IN_PLACE:
        locals()[_name] = _staged(_name, in_place=True)
    del _name

    def barrier(self, *args, **kwargs) -> dist.Work:
        self._gloo.barrier(*args, **kwargs).wait()
        return _completed([])

    def send(self, tensors, dst: int, tag: int) -> dist.Work:
        return _Pending(self._gloo.send(_host(tensors, copy=True), dst, tag))

    def recv(self, tensors, src: int, tag: int) -> dist.Work:
        host = _host(tensors, copy=False)
        return _Pending(self._gloo.recv(host, src, tag), lambda: _copy_back(tensors, host))
