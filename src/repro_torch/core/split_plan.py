"""Algorithm 1: setup for Split node-aware communication.

Faithful port of the paper's Algorithm 1.  Given per-rank receive lists, the
world topology (ranks -> nodes) and a user ``message_cap``, the planner:

1. splits messages by origin (on-node vs off-node)           [line 8]
2. plans the on-node exchange ("local_comm")                 [line 9]
3. groups off-node messages by origin node                   [line 10]
4. computes the Table 1 parameters                           [line 11]
5. resolves the effective ``message_cap``                    [lines 12-17]:
     - if ``max_IN_recv_size < message_cap``: conglomerate all inter-node
       receives into one message per origin node
     - elif ``total_IN_recv_vol / message_cap > PPN``: raise the cap to
       ``ceil(total_IN_recv_vol / PPN)``
     - then split inter-node receives into chunks of at most the cap
6. assigns chunks to on-node ranks: receives in descending size order
   starting at local rank 0; sends in ascending order from rank PPN-1
   [line 18], keeping every process active.
7. emits the redistribution plans ("local_Rcomm", "local_Scomm") and the
   inter-node exchange plan ("global_comm")                  [lines 19-21]

The output is a static :class:`SplitPlan` -- the JAX analogue of the four MPI
sub-communicators -- consumed by :mod:`repro_torch.comm.strategies` and by the
performance models.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.patterns import CommPattern, Message


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One inter-node chunk after conglomeration/splitting.

    ``origin_node -> dest_node`` carrying ``nbytes``; ``senders`` /
    ``receiver`` are the global ranks assigned by line 18; ``parts`` lists
    the (original message, byte range) pairs packed into this chunk so the
    redistribution plans can route every byte to its true destination.
    """

    origin_node: int
    dest_node: int
    nbytes: int
    sender: int
    receiver: int
    parts: Tuple[Tuple[Message, int, int], ...]  # (orig msg, offset, length)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Static result of Algorithm 1 for one node's receives (all nodes)."""

    pattern: CommPattern
    message_cap: int                      # user-provided cap
    effective_cap: Dict[int, int]         # per receiving node (lines 12-17)
    local_messages: Tuple[Message, ...]   # on-node origin (local_comm)
    chunks: Tuple[Chunk, ...]             # inter-node exchange (global_comm)

    # Derived plans (redistribution communicators):
    def send_redistribution(self) -> List[Tuple[int, int, int]]:
        """local_Scomm: (owner_rank -> sender_rank, nbytes) moves on the
        origin node to stage chunk bytes on their assigned senders."""
        moves = []
        for c in self.chunks:
            for msg, off, length in c.parts:
                if msg.src != c.sender:
                    moves.append((msg.src, c.sender, length))
        return moves

    def recv_redistribution(self) -> List[Tuple[int, int, int]]:
        """local_Rcomm: (receiver_rank -> final dst_rank, nbytes) moves on
        the destination node after the inter-node exchange."""
        moves = []
        for c in self.chunks:
            for msg, off, length in c.parts:
                if msg.dst != c.receiver:
                    moves.append((c.receiver, msg.dst, length))
        return moves

    # ------------------------------------------------------------------
    def total_inter_node_bytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    def chunks_received_by(self, rank: int) -> List[Chunk]:
        return [c for c in self.chunks if c.receiver == rank]

    def chunks_sent_by(self, rank: int) -> List[Chunk]:
        return [c for c in self.chunks if c.sender == rank]


def build_split_plan(pattern: CommPattern, message_cap: int) -> SplitPlan:
    """Run Algorithm 1 over every node's receive lists."""
    if message_cap <= 0:
        raise ValueError("message_cap must be positive")
    ppn = pattern.ppn

    # Line 8: split messages by origin.
    local_msgs = tuple(
        m for m in pattern.messages if pattern.node_of(m.src) == pattern.node_of(m.dst)
    )
    inter = pattern.inter_node_messages()

    # Group inter-node messages by receiving node, then by origin node
    # (line 10).
    by_recv_node: Dict[int, Dict[int, List[Message]]] = defaultdict(lambda: defaultdict(list))
    for m in inter:
        by_recv_node[pattern.node_of(m.dst)][pattern.node_of(m.src)].append(m)

    all_chunks: List[Chunk] = []
    effective_cap: Dict[int, int] = {}

    for recv_node, by_origin in sorted(by_recv_node.items()):
        # Line 11: Table 1 parameters for this node.
        per_origin_vol = {o: sum(m.nbytes for m in msgs) for o, msgs in by_origin.items()}
        total_in_recv_vol = sum(per_origin_vol.values())
        max_in_recv_size = max(per_origin_vol.values())

        # Lines 12-17: resolve the effective cap.
        if max_in_recv_size < message_cap:
            cap = max(max_in_recv_size, 1)  # conglomerate: one msg per origin node
        elif total_in_recv_vol / message_cap > ppn:
            cap = math.ceil(total_in_recv_vol / ppn)  # line 16
        else:
            cap = message_cap
        effective_cap[recv_node] = cap

        # Conglomerate per origin node, then split to chunks of <= cap.
        raw_chunks: List[Tuple[int, int, List[Tuple[Message, int, int]]]] = []
        for origin in sorted(by_origin):
            msgs = sorted(by_origin[origin], key=lambda m: (m.dst, m.src))
            parts: List[Tuple[Message, int, int]] = []
            size = 0
            for m in msgs:
                off = 0
                while off < m.nbytes:
                    take = min(cap - size, m.nbytes - off)
                    parts.append((m, off, take))
                    size += take
                    off += take
                    if size == cap:
                        raw_chunks.append((origin, size, parts))
                        parts, size = [], 0
            if size or (not parts and not raw_chunks):
                if size:
                    raw_chunks.append((origin, size, parts))

        # Line 18: receives in descending size from local rank 0; sends in
        # ascending order from local rank PPN-1 (per origin node).
        raw_chunks.sort(key=lambda t: -t[1])
        node_base = recv_node * ppn
        send_counters: Dict[int, int] = defaultdict(int)
        for i, (origin, size, parts) in enumerate(raw_chunks):
            receiver = node_base + (i % ppn)
            k = send_counters[origin]
            sender = origin * ppn + (ppn - 1 - (k % ppn))
            send_counters[origin] += 1
            all_chunks.append(
                Chunk(
                    origin_node=origin,
                    dest_node=recv_node,
                    nbytes=size,
                    sender=sender,
                    receiver=receiver,
                    parts=tuple(parts),
                )
            )

    return SplitPlan(
        pattern=pattern,
        message_cap=message_cap,
        effective_cap=effective_cap,
        local_messages=local_msgs,
        chunks=tuple(all_chunks),
    )


# ---------------------------------------------------------------------------
# Interior / boundary row split (the overlap enabler, paper §4.6 discussion)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowPhaseSplit:
    """Each rank's rows partitioned for split-phase (overlapped) compute.

    A row is *interior* when it depends only on entries its own rank holds
    -- its compute can run while the inter-node exchange is in flight -- and
    *boundary* when it reads halo data and must wait for
    ``ExchangeHandle.finish()``.  Row-tile granularity matters on TPU: the
    blocked-ELL kernels compute whole ``tile_rows`` tiles, so a tile is
    interior only if *every* row in it is (``interior_tiles``); any halo
    dependency promotes the whole tile to the boundary phase.

    Attributes:
      interior: ``[nranks, L]`` bool, True for halo-independent rows.
      interior_tiles: ``[nranks, ntiles]`` bool at kernel tile granularity.
      tile_rows: the row-tile size the tile masks were computed for.
    """

    interior: np.ndarray
    interior_tiles: np.ndarray
    tile_rows: int

    @property
    def boundary(self) -> np.ndarray:
        return ~self.interior

    @property
    def boundary_tiles(self) -> np.ndarray:
        return ~self.interior_tiles

    @property
    def interior_fraction(self) -> float:
        """Fraction of rows whose compute overlaps the inter-node phase
        (the x-axis of ``benchmarks/bench_overlap.py``)."""
        return float(self.interior.mean()) if self.interior.size else 0.0

    @property
    def interior_tile_fraction(self) -> float:
        """Fraction of *tiles* that overlap -- what the kernels actually
        skip; always <= ``interior_fraction``."""
        return (
            float(self.interior_tiles.mean()) if self.interior_tiles.size else 0.0
        )


def split_rows(halo_dependent: np.ndarray, tile_rows: int) -> RowPhaseSplit:
    """Partition rows into interior/boundary sets from a dependency mask.

    ``halo_dependent[r, i]`` is True when row ``i`` of rank ``r`` reads at
    least one off-rank (halo) entry -- for the SpMV case this is "row has a
    nonzero in the off-rank ELL block".  ``tile_rows`` is the kernel's
    row-tile size; rows are padded up to a whole number of tiles and padding
    rows count as interior (they compute zeros either way).
    """
    if halo_dependent.ndim != 2:
        raise ValueError(
            f"halo_dependent must be [nranks, rows], got {halo_dependent.shape}"
        )
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    dep = np.asarray(halo_dependent, dtype=bool)
    nranks, L = dep.shape
    ntiles = -(-L // tile_rows) if L else 0
    pad = ntiles * tile_rows - L
    padded = np.pad(dep, ((0, 0), (0, pad)))
    tile_dep = padded.reshape(nranks, ntiles, tile_rows).any(axis=2)
    return RowPhaseSplit(
        interior=~dep, interior_tiles=~tile_dep, tile_rows=tile_rows
    )
