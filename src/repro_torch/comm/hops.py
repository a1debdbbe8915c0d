"""Staged hops of a per-rank program over a process group.

A program that one rank runs over an
:class:`~repro_torch.comm.topology.ExchangeGroup` (the exchange of
:class:`~repro_torch.comm.strategies._RankProgram`, the reduction tree of
:func:`~repro_torch.comm.hierarchical.dot_tree_steps`) is written as a
generator: it computes on the device up to its next collective, yields a
:class:`Hop` that names the device tensors to send and the device tensors to
fill, and goes on once they are filled.  The hop itself runs on the host:
its send tensors are copied there, the gloo collective moves them, and what
arrived is copied into its receive tensors.

So the device work between two hops reads and writes only tensors that
stay where they are, and a CUDA graph can be captured around each stretch
of it (:mod:`repro_torch.solve.fused`); :func:`run_hops` drives the same
generator eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass(eq=False)
class Hop:
    """One collective of a per-rank program.

    ``kind`` is one of

    * ``"a2a"``: ``all_to_all_single`` of ``sends[0]`` (``[groups, nbytes]``,
      equal splits) on ``group``, into ``recvs[0]``;
    * ``"p2p"``: tagged point-to-point transfers on the world, one per entry
      of ``transfers``: ``(send or None, dst, recv or None, src, tag)``;
    * ``"all_gather"``: ``sends[0]`` from every rank of ``group``, in rank
      order, into ``recvs[0]``;
    * ``"all_reduce"``: ``sends[0]`` reduced by ``op`` (``"max"`` or
      ``"sum"``) over ``group`` (``None``: the world), into ``recvs[0]``.

    A receive tensor holds as many elements of the send's dtype as arrive
    (any contiguous shape: they land in its flat view).  A p2p hop with no
    transfers moves nothing on this rank (:attr:`empty`).
    """

    kind: str
    sends: Tuple[torch.Tensor, ...] = ()
    recvs: Tuple[torch.Tensor, ...] = ()
    group: object = None
    transfers: Tuple[tuple, ...] = ()
    op: str = "sum"

    @property
    def empty(self) -> bool:
        return self.kind == "p2p" and not self.transfers

    def stage(self) -> Callable[[], None]:
        """Copy the sends to the host and issue the collective; returns the
        function that waits for it and copies what arrived into the receive
        tensors (until then the hop is in flight)."""
        import torch.distributed as dist

        lands: List[tuple] = []
        works: list = []
        if self.kind == "p2p":
            ops = []
            for send, dst, recv, src, tag in self.transfers:
                if send is not None:
                    ops.append(dist.P2POp(dist.isend, send.cpu(), dst, tag=tag))
                if recv is not None:
                    host = torch.empty(recv.shape, dtype=recv.dtype)
                    ops.append(dist.P2POp(dist.irecv, host, src, tag=tag))
                    lands.append((recv, host))
            if ops:
                works = dist.batch_isend_irecv(ops)
        else:
            send, = self.sends
            recv, = self.recvs
            host = send.cpu()
            if self.kind == "a2a":
                got = torch.empty_like(host)
                works = [dist.all_to_all_single(got, host, group=self.group, async_op=True)]
            elif self.kind == "all_gather":
                parts = [torch.empty_like(host) for _ in range(recv.numel() // max(host.numel(), 1))]
                works = [dist.all_gather(parts, host, group=self.group, async_op=True)]
                got = parts
            elif self.kind == "all_reduce":
                host = host.clone() if host is send else host  # the send stays as it was
                reduce_op = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[self.op]
                works = [dist.all_reduce(host, op=reduce_op, group=self.group, async_op=True)]
                got = host
            else:
                raise ValueError(f"unknown hop kind {self.kind!r}")
            lands.append((recv, got))

        def finish() -> None:
            for w in works:
                w.wait()
            for recv, got in lands:
                flat = torch.cat([g.reshape(-1) for g in got]) if isinstance(got, list) else got.reshape(-1)
                recv.view(-1).copy_(flat)

        return finish

    def run(self) -> None:
        """Stage the hop, wait for it and land what arrived."""
        self.stage()()


def run_hops(steps, finish: Optional[Callable[[], None]] = None):
    """Drive a hop generator to its end, each hop run before the program
    goes on, and return what it returns.  ``finish`` is the :meth:`Hop.stage`
    of the hop the generator yielded last, left in flight by the caller."""
    try:
        if finish is None:
            hop = next(steps)
        else:
            finish()
            hop = steps.send(None)
        while True:
            hop.run()
            hop = steps.send(None)
    except StopIteration as stop:
        return stop.value


def no_hops(value):
    """``value`` as a hop generator that yields nothing (a program of
    stacked ranks, which needs no collective)."""
    return value
    yield  # pragma: no cover  (makes this a generator)
