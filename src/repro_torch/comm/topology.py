"""Pod topology helpers: the paper's node hierarchy.

A :class:`PodTopology` describes a machine as ``npods`` pods of ``ppn``
ranks (the paper's nodes of PPN processes).  World rank ``r`` lives on pod
``r // ppn`` with pod-local rank ``r % ppn``.  In the port every rank is one
row of a stacked ``[nranks, ...]`` tensor on one device, laid out row-major
over ``("pod", "local")``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

POD_AXIS = "pod"
LOCAL_AXIS = "local"
WORLD_AXES: Tuple[str, str] = (POD_AXIS, LOCAL_AXIS)


@dataclasses.dataclass(frozen=True)
class PodTopology:
    npods: int
    ppn: int  # chips per pod

    @property
    def nranks(self) -> int:
        return self.npods * self.ppn

    def pod_of(self, rank: int) -> int:
        return rank // self.ppn

    def local_of(self, rank: int) -> int:
        return rank % self.ppn

    def rank_of(self, pod: int, local: int) -> int:
        return pod * self.ppn + local

    # ------------------------------------------------------------------
    def agent_local(self, src_pod: int, dst_pod: int) -> int:
        """Pod-local rank of the 3-Step agent for the (src, dst) pod pair.

        The paper pairs "all processes with a receiving process on distinct
        nodes [to] ensure every process remains active"; ``(src+dst) % ppn``
        spreads agent duty over pod-local ranks so different pod pairs use
        different chips.
        """
        return (src_pod + dst_pod) % self.ppn

    def pod_shift_rounds(self) -> List[int]:
        """Inter-pod exchange rounds: pod shifts ``1 .. npods-1``."""
        return list(range(1, self.npods))

