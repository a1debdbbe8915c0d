"""Irregular point-to-point communication pattern descriptors.

A :class:`CommPattern` is the setup-time description of "who sends how many
bytes to whom" -- the input both to the performance models (via
:meth:`CommPattern.stats`, computing the paper's Table 7 parameters) and to
the strategy planners in :mod:`repro_torch.core.split_plan` / :mod:`repro_torch.comm`.

Ranks are global process/chip ids; the node (pod) of a rank is
``rank // ppn``.  This mirrors the paper's SpMV setting where GPU ``i`` holds
row block ``i`` and the pattern is induced by the off-diagonal sparsity.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Tuple

from repro_torch.core.perfmodel import PatternStats


@dataclasses.dataclass(frozen=True)
class Message:
    src: int
    dst: int
    nbytes: int

    def __post_init__(self) -> None:
        if self.nbytes < 0:
            raise ValueError("message size must be non-negative")


@dataclasses.dataclass(frozen=True)
class CommPattern:
    """A static irregular communication pattern over ``nranks`` ranks."""

    nranks: int
    ppn: int  # ranks per node (chips per pod)
    messages: Tuple[Message, ...]

    # ------------------------------------------------------------------
    @staticmethod
    def from_messages(nranks: int, ppn: int, messages: Iterable[Message | Tuple[int, int, int]]) -> "CommPattern":
        msgs = tuple(m if isinstance(m, Message) else Message(*m) for m in messages)
        for m in msgs:
            if not (0 <= m.src < nranks and 0 <= m.dst < nranks):
                raise ValueError(f"message {m} out of range for nranks={nranks}")
        return CommPattern(nranks=nranks, ppn=ppn, messages=msgs)

    # ------------------------------------------------------------------
    @property
    def nnodes(self) -> int:
        return (self.nranks + self.ppn - 1) // self.ppn

    def node_of(self, rank: int) -> int:
        return rank // self.ppn

    def local_rank(self, rank: int) -> int:
        return rank % self.ppn

    # ------------------------------------------------------------------
    def inter_node_messages(self) -> List[Message]:
        return [m for m in self.messages if self.node_of(m.src) != self.node_of(m.dst)]

    def recv_lists(self) -> Dict[int, List[Message]]:
        """Per-destination-rank receive lists (Algorithm 1 input ``l_recv``)."""
        out: Dict[int, List[Message]] = defaultdict(list)
        for m in self.messages:
            out[m.dst].append(m)
        return dict(out)

    # ------------------------------------------------------------------
    def stats(self) -> PatternStats:
        """Compute the paper's Table 7 parameters for this pattern.

        All parameters are worst-case ("max over ...") as in the paper, since
        the measured quantity is the max time over any single process.

        Byte terms are per element; for batched ``k``-column payloads widen
        the result via :meth:`~repro_torch.core.perfmodel.PatternStats.widened`
        (or pass ``payload_width`` to the advisor, the single widening entry
        point -- widening both here and there would scale bytes by ``k**2``).
        """
        bytes_by_src: Dict[int, int] = defaultdict(int)
        msgs_by_src: Dict[int, int] = defaultdict(int)
        bytes_injected_by_node: Dict[int, int] = defaultdict(int)
        bytes_by_node_pair: Dict[Tuple[int, int], int] = defaultdict(int)
        msgs_by_node_pair: Dict[Tuple[int, int], int] = defaultdict(int)
        dest_nodes_by_src: Dict[int, set] = defaultdict(set)
        dest_nodes_by_node: Dict[int, set] = defaultdict(set)

        for m in self.inter_node_messages():
            sn, dn = self.node_of(m.src), self.node_of(m.dst)
            bytes_by_src[m.src] += m.nbytes
            msgs_by_src[m.src] += 1
            bytes_injected_by_node[sn] += m.nbytes
            bytes_by_node_pair[(sn, dn)] += m.nbytes
            msgs_by_node_pair[(sn, dn)] += 1
            dest_nodes_by_src[m.src].add(dn)
            dest_nodes_by_node[sn].add(dn)

        def _max(d: Mapping, default=0):
            return max(d.values()) if d else default

        return PatternStats(
            s_proc=float(_max(bytes_by_src)),
            s_node=float(_max(bytes_injected_by_node)),
            s_node_node=float(_max(bytes_by_node_pair)),
            m_proc_node=int(_max({k: len(v) for k, v in dest_nodes_by_src.items()})),
            m_node_node=int(_max(msgs_by_node_pair)),
            m_proc=int(_max(msgs_by_src)),
            num_dest_nodes=int(_max({k: len(v) for k, v in dest_nodes_by_node.items()})),
        )


# ---------------------------------------------------------------------------
# Scenario generators (paper §4.6, Fig 4.3)
# ---------------------------------------------------------------------------


def figure43_pattern(
    nbytes_per_msg: int,
    n_inter_node_msgs: int,
    n_dest_nodes: int,
    ppn: int = 4,
) -> CommPattern:
    """The Fig 4.3 scenario: one node sends ``n_inter_node_msgs`` messages of
    ``nbytes_per_msg`` bytes, spread evenly over its on-node GPUs, to
    ``n_dest_nodes`` destination nodes (round-robin over destination ranks).
    """
    nranks = (n_dest_nodes + 1) * ppn
    msgs = []
    for i in range(n_inter_node_msgs):
        src = i % ppn  # node 0 ranks
        dnode = 1 + (i % n_dest_nodes)
        dst = dnode * ppn + (i // n_dest_nodes) % ppn
        msgs.append(Message(src, dst, nbytes_per_msg))
    return CommPattern.from_messages(nranks, ppn, msgs)
