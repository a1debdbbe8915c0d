"""Hardware path-parameter registries (paper §3, Tables 2-4).

The paper measures postal-model parameters (``alpha`` latency [s], ``beta``
per-byte cost [s/B]) for every data-flow path on a Lassen node, split by the
physical locality of the two endpoints (on-socket / on-node / off-node), the
messaging protocol (short / eager / rendezvous), and the memory space
(CPU <-> CPU vs GPU <-> GPU), plus ``cudaMemcpyAsync`` staging-copy costs and
the NIC injection-bandwidth limit ``R_N``.

Two registries are provided:

* ``LASSEN`` -- the paper's measured values, verbatim from Tables 2, 3, 4.
  Used by the paper-figure reproduction benchmarks so that model outputs are
  exact reproductions of the paper's predictions.
* ``TPU_V5E_POD`` -- the TPU adaptation (DESIGN.md section 2).  The "node"
  becomes a 16x16-chip ICI pod; on-socket ~ 1-hop ICI, on-node ~ multi-hop
  ICI, off-node ~ inter-pod DCI; the staging copy becomes an HBM
  read/write bounce; the NIC injection limit becomes the per-pod DCI egress
  limit.  Values are spec-derived (no TPU hardware in this container) and
  clearly marked as such.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple


class Locality(enum.Enum):
    """Relative location of two communicating endpoints (paper Fig 2.5)."""

    ON_SOCKET = "on-socket"
    ON_NODE = "on-node"
    OFF_NODE = "off-node"


class Protocol(enum.Enum):
    """MPI messaging protocol classes (paper §3)."""

    SHORT = "short"
    EAGER = "eager"
    RENDEZVOUS = "rendezvous"


class Space(enum.Enum):
    """Memory space of the communicating endpoints."""

    CPU = "cpu"
    GPU = "gpu"  # on TPU: "device-direct" logical path


@dataclasses.dataclass(frozen=True)
class PathParams:
    """Postal-model parameters for one data-flow path: ``T = alpha + beta*s``."""

    alpha: float  # latency [s]
    beta: float  # inverse bandwidth [s/B]

    def time(self, nbytes: float) -> float:
        return self.alpha + self.beta * float(nbytes)


@dataclasses.dataclass(frozen=True)
class CopyParams:
    """Staging-copy parameters (paper Table 3): host<->device bounce."""

    h2d: PathParams
    d2h: PathParams


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Everything the paper's models need for one machine.

    Attributes:
      name: registry key.
      paths: ``(space, protocol, locality) -> PathParams`` (paper Table 2).
      copy: ``nprocs -> CopyParams`` for staged-through-host copies
        (paper Table 3; keys 1 and 4 on Lassen).
      rn_inv: inverse NIC/egress injection bandwidth ``1/R_N`` [s/B]
        (paper Table 4).
      gpus_per_socket: ``gps`` in eq. (4.1).
      sockets_per_node: 2 on Lassen; 1 for a TPU pod (flat ICI domain).
      procs_per_socket: ``pps`` in eq. (4.2).
      short_max / eager_max: protocol cutoffs in bytes (``short`` unused for
        GPU paths, as on Lassen).
    """

    name: str
    paths: Dict[Tuple[Space, Protocol, Locality], PathParams]
    copy: Dict[int, CopyParams]
    rn_inv: float
    gpus_per_socket: int
    sockets_per_node: int
    procs_per_socket: int
    short_max: int = 512
    eager_max: int = 65536

    # ------------------------------------------------------------------
    @property
    def gpus_per_node(self) -> int:
        return self.gpus_per_socket * self.sockets_per_node

    @property
    def procs_per_node(self) -> int:
        """PPN: maximum processes available for Split strategies."""
        return self.procs_per_socket * self.sockets_per_node

    @property
    def r_n(self) -> float:
        """NIC / pod-egress injection bandwidth [B/s]."""
        return 1.0 / self.rn_inv

    # ------------------------------------------------------------------
    def protocol_for(self, nbytes: float, space: Space) -> Protocol:
        """Pick the protocol class by message size (paper §3).

        The short protocol is not used for device-aware messages on Lassen;
        we keep that behaviour for every registry.
        """
        if space is Space.CPU and nbytes <= self.short_max:
            return Protocol.SHORT
        if nbytes <= self.eager_max:
            return Protocol.EAGER
        return Protocol.RENDEZVOUS

    def path(self, space: Space, locality: Locality, nbytes: float) -> PathParams:
        """Postal parameters for a message of ``nbytes`` over one path."""
        proto = self.protocol_for(nbytes, space)
        return self.paths[(space, proto, locality)]


# ---------------------------------------------------------------------------
# Lassen: measured parameters, verbatim from paper Tables 2, 3, 4.
# ---------------------------------------------------------------------------

_L = Locality
_P = Protocol
_S = Space

LASSEN = MachineParams(
    name="lassen",
    paths={
        # CPU, short                     on-socket      on-node       off-node
        (_S.CPU, _P.SHORT, _L.ON_SOCKET): PathParams(3.67e-07, 1.32e-10),
        (_S.CPU, _P.SHORT, _L.ON_NODE): PathParams(9.25e-07, 1.19e-09),
        (_S.CPU, _P.SHORT, _L.OFF_NODE): PathParams(1.89e-06, 6.88e-10),
        # CPU, eager
        (_S.CPU, _P.EAGER, _L.ON_SOCKET): PathParams(4.61e-07, 7.12e-11),
        (_S.CPU, _P.EAGER, _L.ON_NODE): PathParams(1.17e-06, 2.18e-10),
        (_S.CPU, _P.EAGER, _L.OFF_NODE): PathParams(2.44e-06, 3.79e-10),
        # CPU, rendezvous
        (_S.CPU, _P.RENDEZVOUS, _L.ON_SOCKET): PathParams(3.15e-06, 3.40e-11),
        (_S.CPU, _P.RENDEZVOUS, _L.ON_NODE): PathParams(6.77e-06, 1.49e-10),
        (_S.CPU, _P.RENDEZVOUS, _L.OFF_NODE): PathParams(7.76e-06, 7.97e-11),
        # GPU, eager (no short protocol for device-aware messages)
        (_S.GPU, _P.EAGER, _L.ON_SOCKET): PathParams(1.87e-06, 5.79e-11),
        (_S.GPU, _P.EAGER, _L.ON_NODE): PathParams(2.02e-05, 2.15e-10),
        (_S.GPU, _P.EAGER, _L.OFF_NODE): PathParams(8.95e-06, 1.72e-10),
        # GPU, rendezvous
        (_S.GPU, _P.RENDEZVOUS, _L.ON_SOCKET): PathParams(1.82e-05, 1.46e-11),
        (_S.GPU, _P.RENDEZVOUS, _L.ON_NODE): PathParams(1.93e-05, 2.39e-11),
        (_S.GPU, _P.RENDEZVOUS, _L.OFF_NODE): PathParams(1.10e-05, 1.72e-10),
    },
    copy={
        # paper Table 3: columns are (H2D, D2H)
        1: CopyParams(h2d=PathParams(1.30e-05, 1.85e-11), d2h=PathParams(1.27e-05, 1.96e-11)),
        4: CopyParams(h2d=PathParams(1.52e-05, 5.52e-10), d2h=PathParams(1.47e-05, 1.50e-10)),
    },
    rn_inv=4.19e-11,  # paper Table 4, inter-CPU
    gpus_per_socket=2,
    sockets_per_node=2,
    procs_per_socket=20,
)


# ---------------------------------------------------------------------------
# TPU v5e pod: spec-derived adaptation (DESIGN.md section 2).
# ---------------------------------------------------------------------------

# Roofline constants (also used by benchmarks/bench_roofline.py).
TPU_V5E_PEAK_BF16_FLOPS = 197e12  # [FLOP/s] per chip
TPU_V5E_HBM_BW = 819e9  # [B/s] per chip
TPU_V5E_ICI_LINK_BW = 50e9  # [B/s] per ICI link (assignment constant)
TPU_V5E_HBM_BYTES = 16 * 2**30  # 16 GiB HBM per chip
TPU_V5E_VMEM_BYTES = 128 * 2**20  # ~128 MiB VMEM per chip

_ICI_HOP_LAT = 1.0e-06  # [s] per ICI hop incl. software overhead
_ICI_BETA = 1.0 / TPU_V5E_ICI_LINK_BW  # 2.0e-11 s/B on the contended link
_DCI_LAT = 1.0e-05  # [s] inter-pod (data-center network)
_DCI_CHIP_BW = 6.25e9  # [B/s] per-chip share of pod egress (50 Gb/s)
_POD_EGRESS_BW = 4.0e11  # [B/s] total pod egress ("NIC" analogue, 400 GB/s)
_HBM_BETA = 1.0 / TPU_V5E_HBM_BW

TPU_V5E_POD = MachineParams(
    name="tpu_v5e_pod",
    paths={
        # "CPU" space = staged/fused logical path over the fabric.
        # on-socket ~ 1-hop ICI neighbour, on-node ~ multi-hop intra-pod ICI
        # (mean 8 hops on a 16x16 torus), off-node ~ inter-pod DCI.
        (_S.CPU, _P.SHORT, _L.ON_SOCKET): PathParams(_ICI_HOP_LAT, _ICI_BETA),
        (_S.CPU, _P.SHORT, _L.ON_NODE): PathParams(8 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.CPU, _P.SHORT, _L.OFF_NODE): PathParams(_DCI_LAT, 1.0 / _DCI_CHIP_BW),
        (_S.CPU, _P.EAGER, _L.ON_SOCKET): PathParams(_ICI_HOP_LAT, _ICI_BETA),
        (_S.CPU, _P.EAGER, _L.ON_NODE): PathParams(8 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.CPU, _P.EAGER, _L.OFF_NODE): PathParams(_DCI_LAT, 1.0 / _DCI_CHIP_BW),
        (_S.CPU, _P.RENDEZVOUS, _L.ON_SOCKET): PathParams(2 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.CPU, _P.RENDEZVOUS, _L.ON_NODE): PathParams(16 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.CPU, _P.RENDEZVOUS, _L.OFF_NODE): PathParams(2 * _DCI_LAT, 1.0 / _DCI_CHIP_BW),
        # "GPU" space = device-direct logical send (un-fused XLA collective
        # over the joint mesh): same wires, higher per-message software cost
        # because each fine-grained message becomes its own collective step.
        (_S.GPU, _P.EAGER, _L.ON_SOCKET): PathParams(3 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.GPU, _P.EAGER, _L.ON_NODE): PathParams(12 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.GPU, _P.EAGER, _L.OFF_NODE): PathParams(2 * _DCI_LAT, 1.0 / _DCI_CHIP_BW),
        (_S.GPU, _P.RENDEZVOUS, _L.ON_SOCKET): PathParams(6 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.GPU, _P.RENDEZVOUS, _L.ON_NODE): PathParams(24 * _ICI_HOP_LAT, _ICI_BETA),
        (_S.GPU, _P.RENDEZVOUS, _L.OFF_NODE): PathParams(3 * _DCI_LAT, 1.0 / _DCI_CHIP_BW),
    },
    copy={
        # staging bounce = HBM read + write (DMA setup latency + 2x HBM beta)
        1: CopyParams(
            h2d=PathParams(2.0e-06, _HBM_BETA),
            d2h=PathParams(2.0e-06, _HBM_BETA),
        ),
        # sharded staging buffer read from 4 chips ("duplicate device
        # pointer" analogue): 4 concurrent DMA streams contending on HBM.
        4: CopyParams(
            h2d=PathParams(2.5e-06, 4 * _HBM_BETA),
            d2h=PathParams(2.5e-06, 2 * _HBM_BETA),
        ),
    },
    rn_inv=1.0 / _POD_EGRESS_BW,
    gpus_per_socket=256,  # chips per "socket" == chips per pod (flat domain)
    sockets_per_node=1,
    procs_per_socket=256,
    short_max=512,
    eager_max=65536,
)


REGISTRY: Dict[str, MachineParams] = {
    LASSEN.name: LASSEN,
    TPU_V5E_POD.name: TPU_V5E_POD,
}


def get_machine(name: str) -> MachineParams:
    try:
        return REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown machine {name!r}; known: {sorted(REGISTRY)}") from e
