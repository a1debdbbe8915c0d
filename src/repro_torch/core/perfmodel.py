"""Performance models for node-aware irregular point-to-point communication.

Implements, faithfully, the models of paper §2.2 / §4:

* eq. (2.1)  postal model            ``T = alpha + beta * s``
* eq. (2.2)  max-rate model          ``T = alpha*m + max(ppn*s/R_N, s/R_b)``
* eq. (4.1)  T_on        -- worst-case on-node gather/redistribute (3-Step, 2-Step)
* eq. (4.2)  T_on-split  -- on-node distribute for the Split strategies
* eq. (4.3)  T_off       -- staged-through-host inter-node (max-rate form)
* eq. (4.4)  T_off-DA    -- device-aware inter-node (postal form)
* eq. (4.5)  T_copy      -- staging copies between device and host
* Table 6    composite models for all (strategy x transport) pairs

plus the Table 7 pattern statistics consumed by the composites (computed by
:mod:`repro_torch.core.patterns`), plus the overlap-aware extension used by the
split-phase execution path: :func:`predict_phases` factors each Table 6
composite into its on-node and inter-node terms, and
:func:`predict_overlapped` evaluates

    ``T = T_local_comm + max(T_inter_comm, T_interior_compute) + T_boundary``

-- the split-phase pipeline where interior compute hides behind the
inter-node phase (paper §4.6 closing discussion; Bienz et al., "Modeling
Data Movement Performance on Heterogeneous Architectures").

Wire codecs (:mod:`repro_torch.comm.wire`) extend every composite with a third
lever: a :class:`WireModel` scales the inter-node *byte* terms by its
compression ratio (message counts and every on-node term are untouched --
exactly the executor's behaviour, which encodes only DCI-crossing
segments) and adds an unhideable encode+decode compute term to the local
phase.  ``predict(..., wire=...)`` / ``predict_phases`` /
``predict_overlapped`` stay mutually consistent:
``predict_phases(...).total == predict(...)`` for every codec.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

from repro_torch.core.hardware import (
    CopyParams,
    Locality,
    MachineParams,
    Space,
)


class Strategy(enum.Enum):
    """Node-aware strategies modeled by the paper (Table 5)."""

    STANDARD = "standard"
    THREE_STEP = "three_step"
    TWO_STEP = "two_step"
    TWO_STEP_ONE = "two_step_1"  # best-case 2-Step (single active GPU), Fig 4.3
    SPLIT_MD = "split_md"
    SPLIT_DD = "split_dd"


class Transport(enum.Enum):
    DEVICE_AWARE = "device_aware"
    STAGED_HOST = "staged_host"


#: (strategy, transport) pairs the paper models (Table 5). Split strategies
#: are staged-through-host only ("device-aware communication does not apply").
MODELED_PAIRS = [
    (Strategy.STANDARD, Transport.STAGED_HOST),
    (Strategy.STANDARD, Transport.DEVICE_AWARE),
    (Strategy.THREE_STEP, Transport.STAGED_HOST),
    (Strategy.THREE_STEP, Transport.DEVICE_AWARE),
    (Strategy.TWO_STEP, Transport.STAGED_HOST),
    (Strategy.TWO_STEP, Transport.DEVICE_AWARE),
    (Strategy.SPLIT_MD, Transport.STAGED_HOST),
    (Strategy.SPLIT_DD, Transport.STAGED_HOST),
]


def modeled_pairs(
    include_two_step_one: bool = False,
) -> "list[Tuple[Strategy, Transport]]":
    """The candidate (strategy, transport) pairs -- the ONE enumeration the
    advisor and :func:`predict_all` share, so the optional best-case 2-Step
    extension cannot drift between them."""
    pairs = list(MODELED_PAIRS)
    if include_two_step_one:
        pairs += [
            (Strategy.TWO_STEP_ONE, Transport.STAGED_HOST),
            (Strategy.TWO_STEP_ONE, Transport.DEVICE_AWARE),
        ]
    return pairs


@dataclasses.dataclass(frozen=True)
class PatternStats:
    """Table 7 parameters (plus ``s_node_total`` used by the Split row).

    Attributes:
      s_proc: max bytes sent by a single process/GPU.
      s_node: max bytes injected into the network by a single node.
      s_node_node: max bytes sent between any two nodes.
      m_proc_node: max number of nodes to which a single process sends.
      m_node_node: max number of messages between any two nodes.
      m_proc: max number of messages sent by a single process (standard).
      num_dest_nodes: number of destination nodes for the max-injecting node.
    """

    s_proc: float
    s_node: float
    s_node_node: float
    m_proc_node: int
    m_node_node: int
    m_proc: int
    num_dest_nodes: int

    def scaled(self, keep: float) -> "PatternStats":
        """Scale data volumes by ``keep`` (duplicate-data removal, §4.6)."""
        return dataclasses.replace(
            self,
            s_proc=self.s_proc * keep,
            s_node=self.s_node * keep,
            s_node_node=self.s_node_node * keep,
        )

    def widened(self, payload_width: int) -> "PatternStats":
        """Byte terms for a batched payload of ``payload_width`` columns.

        A batched exchange ships ``k`` feature columns per element under one
        plan (multi-vector SpMM, batched serving), so every byte volume grows
        ``k``-fold while the message counts stay fixed: the per-message
        ``alpha`` terms amortize across columns and the models slide from the
        message-count-bound regime toward the bandwidth-bound regime as ``k``
        grows (Bienz et al.; the heterogeneous-communication survey's batched
        payload lever).

        >>> s = PatternStats(s_proc=100.0, s_node=400.0, s_node_node=200.0,
        ...                  m_proc_node=4, m_node_node=8, m_proc=16,
        ...                  num_dest_nodes=4)
        >>> w = s.widened(8)
        >>> (w.s_proc, w.s_node)      # byte terms scale by k ...
        (800.0, 3200.0)
        >>> (w.m_proc, w.m_node_node) # ... message counts do not
        (16, 8)
        >>> s.widened(1) is s
        True
        """
        if payload_width < 1:
            raise ValueError(f"payload_width must be >= 1, got {payload_width}")
        if payload_width == 1:
            return self
        return self.scaled(float(payload_width))


def dispatch_stats(counts, ppn: int, elem_bytes: int = 4) -> PatternStats:
    """Table 7 stats straight from a measured ``[nranks, nranks]`` count matrix.

    ``counts[s, d]`` is the number of elements rank ``s`` sends to rank ``d``
    (an expert-load histogram for MoE token dispatch: tokens routed from data
    shard ``s`` to the shard owning the chosen expert).  This is the
    histogram-driven advisor input of the paper lineage ("Improving
    Performance Models for Irregular Point-to-Point Communication"): measured
    per-pair traffic instead of an assumed-uniform all-to-all.  The diagonal
    (self traffic) never hits the network and is ignored.

    One vectorized numpy pass; semantically identical to building a
    :class:`~repro_torch.core.patterns.CommPattern` with one message per nonzero
    off-diagonal pair and calling ``.stats()`` (pinned by a test).
    """
    import numpy as np

    c = np.asarray(counts, dtype=np.float64)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"counts must be a square matrix, got {c.shape}")
    if (c < 0).any():
        raise ValueError("counts must be non-negative")
    n = c.shape[0]
    if n % ppn:
        raise ValueError(f"nranks {n} not divisible by ppn {ppn}")
    nn = n // ppn
    b = c * float(elem_bytes)
    node = np.arange(n) // ppn
    inter = node[:, None] != node[None, :]  # inter-node pair mask
    bi = np.where(inter, b, 0.0)
    mi = np.where(inter, c > 0, False)
    # per-node-pair block sums / counts: [nn, ppn, nn, ppn] -> [nn, nn]
    b4 = bi.reshape(nn, ppn, nn, ppn)
    m4 = mi.reshape(nn, ppn, nn, ppn)
    pair_bytes = b4.sum(axis=(1, 3))
    pair_msgs = m4.sum(axis=(1, 3))
    dest_nodes_by_src = (m4.any(axis=3)).astype(np.int64)  # [nn, ppn, nn]
    return PatternStats(
        s_proc=float(bi.sum(axis=1).max(initial=0.0)),
        s_node=float(pair_bytes.sum(axis=1).max(initial=0.0)),
        s_node_node=float(pair_bytes.max(initial=0.0)),
        m_proc_node=int(dest_nodes_by_src.sum(axis=2).max(initial=0)),
        m_node_node=int(pair_msgs.max(initial=0)),
        m_proc=int(mi.sum(axis=1).max(initial=0)),
        num_dest_nodes=int(dest_nodes_by_src.any(axis=1).sum(axis=1).max(initial=0)),
    )


# ---------------------------------------------------------------------------
# Wire codec models (inter-node byte compression, repro_torch.comm.wire)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireModel:
    """Model parameters of one inter-pod wire codec.

    Attributes:
      codec: executable codec name (``repro_torch.comm.wire.WIRE_CODECS``).
      ratio: inter-node byte multiplier (0.5 for 16-bit wires; the int8
        entry carries a little extra for the per-block float32 scales).
      alpha: per-exchange encode+decode launch overhead, seconds.
      beta: per-byte codec compute cost, seconds/byte, paid once for the
        encode pass and once for the decode pass over the max node
        injection volume ``s_node`` (the quantizer's extra amax sweep is
        folded into the int8 beta).

    The codec compute term is *unhideable*: encoding must finish before the
    inter-node dispatch and decoding starts after arrival, so
    :func:`predict_phases` charges it to the local phase and the split-phase
    pipeline of :func:`predict_overlapped` cannot hide it.
    """

    codec: str
    ratio: float
    alpha: float
    beta: float


#: model constants per executable codec.  Recorded at pin time next to the
#: machine registry numbers: 16-bit casts halve DCI bytes and stream the
#: payload once per side at on-device memory bandwidth (~1 TB/s); int8
#: quarters the bytes (plus ~1% for scales) but pays an extra amax sweep.
WIRE_MODELS: Dict[str, WireModel] = {
    "none": WireModel("none", 1.0, 0.0, 0.0),
    "bf16": WireModel("bf16", 0.5, 1.0e-6, 1.0e-12),
    "f16": WireModel("f16", 0.5, 1.0e-6, 1.0e-12),
    "int8": WireModel("int8", 0.26, 1.0e-6, 2.0e-12),
}


def get_wire(wire: "WireModel | str | None") -> WireModel:
    """Normalize a codec name / model / ``None`` to a :class:`WireModel`."""
    if wire is None:
        return WIRE_MODELS["none"]
    if isinstance(wire, WireModel):
        return wire
    try:
        return WIRE_MODELS[wire]
    except KeyError as e:
        # ValueError to match the executor-side validation (wire.check_codec,
        # IrregularExchange, execute_numpy): callers catch one exception type
        # for a bad user-supplied codec name
        raise ValueError(
            f"unknown wire codec {wire!r}; known: {sorted(WIRE_MODELS)}"
        ) from e


def t_codec(wire: "WireModel | str | None", s_node: float) -> float:
    """Encode+decode compute of one exchange (0 for the ``none`` codec)."""
    w = get_wire(wire)
    if w.codec == "none":
        return 0.0
    return w.alpha + 2.0 * w.beta * float(s_node)


# ---------------------------------------------------------------------------
# Primitive models
# ---------------------------------------------------------------------------


def postal(alpha: float, beta: float, nbytes: float, nmsgs: int = 1) -> float:
    """Eq. (2.1): ``T = alpha + beta*s`` (per message, ``nmsgs`` messages)."""
    return alpha * nmsgs + beta * float(nbytes)


def max_rate(
    alpha: float,
    beta: float,
    nmsgs: int,
    s_proc: float,
    s_node: float,
    rn_inv: float,
) -> float:
    """Eq. (2.2)/(4.3): ``T = alpha*m + max(s_node/R_N, s_proc*beta)``.

    ``s_node/R_N`` is the node injection-bandwidth bound; ``s_proc*beta`` is
    the per-process transport bound.  When the node is injecting less than
    the NIC limit this reduces to the postal model.
    """
    return alpha * nmsgs + max(s_node * rn_inv, s_proc * beta)


# ---------------------------------------------------------------------------
# Sub-models (paper §4.1-§4.4)
# ---------------------------------------------------------------------------


def t_on(machine: MachineParams, space: Space, s: float) -> float:
    """Eq. (4.1): worst-case on-node gather or redistribute for 3-/2-Step.

    ``(gps-1)`` on-socket messages plus ``gps`` on-node messages of size
    ``s`` (the max contribution of a single GPU).
    """
    gps = machine.gpus_per_socket
    p_sock = machine.path(space, Locality.ON_SOCKET, s)
    p_node = machine.path(space, Locality.ON_NODE, s)
    t = (gps - 1) * (p_sock.alpha + p_sock.beta * s)
    if machine.sockets_per_node > 1:
        t += gps * (p_node.alpha + p_node.beta * s)
    return t


def t_on_split(machine: MachineParams, s_total: float, ppg: int) -> float:
    """Eq. (4.2): on-node distribute/redistribute for the Split strategies.

    Worst case: a single GPU holds all ``s_total`` inter-node bytes, staged on
    ``ppg`` host processes, and must spread them over all ``PPN`` on-node
    processes in chunks of ``s_total/PPN``: each staging process sends
    ``pps/ppg - 1`` on-socket and ``pps/ppg`` off-socket/on-node messages
    (19 + 20 on Lassen with ppg=1).  Staging is always through host
    processes, so CPU path parameters apply.
    """
    pps = machine.procs_per_socket
    ppn = machine.procs_per_node
    chunk = s_total / ppn
    n_sock = pps // ppg - 1
    n_node = pps // ppg if machine.sockets_per_node > 1 else 0
    p_sock = machine.path(Space.CPU, Locality.ON_SOCKET, chunk)
    t = n_sock * (p_sock.alpha + p_sock.beta * chunk)
    if n_node:
        p_node = machine.path(Space.CPU, Locality.ON_NODE, chunk)
        t += n_node * (p_node.alpha + p_node.beta * chunk)
    return t


def t_off(
    machine: MachineParams,
    nmsgs: int,
    s_proc: float,
    s_node: float,
    msg_size: Optional[float] = None,
) -> float:
    """Eq. (4.3): staged-through-host inter-node communication (max-rate).

    ``msg_size`` selects the protocol class (defaults to ``s_proc``).
    """
    p = machine.path(Space.CPU, Locality.OFF_NODE, msg_size if msg_size is not None else s_proc)
    return max_rate(p.alpha, p.beta, nmsgs, s_proc, s_node, machine.rn_inv)


def t_off_da(machine: MachineParams, nmsgs: int, s: float, msg_size: Optional[float] = None) -> float:
    """Eq. (4.4): device-aware inter-node communication (postal)."""
    p = machine.path(Space.GPU, Locality.OFF_NODE, msg_size if msg_size is not None else s)
    return p.alpha * nmsgs + s * p.beta


def t_copy(copy: CopyParams, s_send: float, s_recv: float) -> float:
    """Eq. (4.5): device<->host staging copies."""
    return (
        copy.h2d.alpha
        + copy.h2d.beta * s_send
        + copy.d2h.alpha
        + copy.d2h.beta * s_recv
    )


# ---------------------------------------------------------------------------
# Table 6 composites
# ---------------------------------------------------------------------------


def predict(
    machine: MachineParams,
    strategy: Strategy,
    transport: Transport,
    stats: PatternStats,
    wire: "WireModel | str | None" = None,
) -> float:
    """Predicted time for one (strategy, transport) pair -- paper Table 6.

    ``wire`` selects an inter-node codec (:data:`WIRE_MODELS`): byte terms
    of the inter-node phase scale by its compression ratio and the local
    phase pays :func:`t_codec`; consistent with :func:`predict_phases` by
    construction (``predict == predict_phases(...).total``).
    """
    w = get_wire(wire)
    if w.codec != "none":
        return predict_phases(machine, strategy, transport, stats, wire=w).total
    return _predict_base(machine, strategy, transport, stats)


def _predict_base(
    machine: MachineParams,
    strategy: Strategy,
    transport: Transport,
    stats: PatternStats,
) -> float:
    ppn = machine.procs_per_node

    if strategy is Strategy.STANDARD:
        if transport is Transport.STAGED_HOST:
            # Max-rate model (2.2), staged through host: CPU off-node params.
            msg = stats.s_proc / max(stats.m_proc, 1)
            p = machine.path(Space.CPU, Locality.OFF_NODE, msg)
            return max_rate(p.alpha, p.beta, stats.m_proc, stats.s_proc, stats.s_node, machine.rn_inv)
        # Postal model (2.1), device-aware: GPU off-node params.
        msg = stats.s_proc / max(stats.m_proc, 1)
        p = machine.path(Space.GPU, Locality.OFF_NODE, msg)
        return p.alpha * stats.m_proc + p.beta * stats.s_proc

    if strategy is Strategy.THREE_STEP:
        if transport is Transport.STAGED_HOST:
            return (
                t_off(machine, stats.m_node_node, stats.s_node_node, stats.s_node,
                      msg_size=stats.s_node_node)
                + 2.0 * t_on(machine, Space.CPU, stats.s_node_node)
                + t_copy(machine.copy[1], stats.s_proc, stats.s_node_node)
            )
        return (
            t_off_da(machine, stats.m_node_node, stats.s_node_node)
            + 2.0 * t_on(machine, Space.GPU, stats.s_node_node)
        )

    if strategy in (Strategy.TWO_STEP, Strategy.TWO_STEP_ONE):
        # 2-Step All: every GPU sends to its pair on each destination node.
        # 2-Step 1 (best case): all inter-node data originates on one GPU that
        # is already paired with the destination -- on-node phase vanishes.
        if transport is Transport.STAGED_HOST:
            t = t_off(machine, stats.m_proc_node, stats.s_proc, stats.s_node,
                      msg_size=stats.s_proc / max(stats.m_proc_node, 1))
            if strategy is Strategy.TWO_STEP:
                t += t_on(machine, Space.CPU, stats.s_proc)
            return t + t_copy(machine.copy[1], stats.s_proc, stats.s_node_node)
        t = t_off_da(machine, stats.m_proc_node, stats.s_proc,
                     msg_size=stats.s_proc / max(stats.m_proc_node, 1))
        if strategy is Strategy.TWO_STEP:
            t += t_on(machine, Space.GPU, stats.s_proc)
        return t

    if strategy in (Strategy.SPLIT_MD, Strategy.SPLIT_DD):
        if transport is not Transport.STAGED_HOST:
            raise ValueError("device-aware transport does not apply to Split (paper Table 5)")
        ppg = 1 if strategy is Strategy.SPLIT_MD else 4
        s_split = stats.s_node / ppn
        return (
            t_off(machine, stats.m_proc_node, s_split, stats.s_node, msg_size=s_split)
            + 2.0 * t_on_split(machine, stats.s_node, ppg)
            + t_copy(machine.copy[ppg], stats.s_proc, stats.s_node_node)
        )

    raise ValueError(f"unknown strategy {strategy}")


# ---------------------------------------------------------------------------
# Overlap-aware extension (split-phase execution)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhaseTimes:
    """A Table 6 composite factored into its two communication phases.

    ``local`` collects every on-node term (gathers, redistributes, staging
    copies) -- the part of the exchange that cannot be hidden because the
    split-phase pipeline needs it before interior compute starts; ``inter``
    is the inter-node transport term -- the part that runs concurrently with
    interior compute when the execution path overlaps
    (:meth:`repro_torch.sparse.spmv.DistributedSpMV` with ``overlap=True``).
    """

    local: float
    inter: float

    @property
    def total(self) -> float:
        return self.local + self.inter


def predict_phases(
    machine: MachineParams,
    strategy: Strategy,
    transport: Transport,
    stats: PatternStats,
    wire: "WireModel | str | None" = None,
) -> PhaseTimes:
    """Factor the Table 6 composite into (on-node, inter-node) terms.

    Invariant (pinned by tests): ``phases.local + phases.inter`` equals
    :func:`predict` for every modeled pair and every wire codec.

    With a ``wire`` codec the inter phase is evaluated on ratio-scaled byte
    stats (message counts untouched -- the codec shrinks bytes, not
    messages) and the local phase pays the unhideable :func:`t_codec`
    encode+decode term.
    """
    w = get_wire(wire)
    base = _predict_phases_base(machine, strategy, transport, stats)
    if w.codec == "none":
        return base
    inter = _predict_phases_base(
        machine, strategy, transport, stats.scaled(w.ratio)
    ).inter
    return PhaseTimes(local=base.local + t_codec(w, stats.s_node), inter=inter)


def _predict_phases_base(
    machine: MachineParams,
    strategy: Strategy,
    transport: Transport,
    stats: PatternStats,
) -> PhaseTimes:
    ppn = machine.procs_per_node

    if strategy is Strategy.STANDARD:
        return PhaseTimes(
            local=0.0, inter=_predict_base(machine, strategy, transport, stats)
        )

    if strategy is Strategy.THREE_STEP:
        if transport is Transport.STAGED_HOST:
            return PhaseTimes(
                local=2.0 * t_on(machine, Space.CPU, stats.s_node_node)
                + t_copy(machine.copy[1], stats.s_proc, stats.s_node_node),
                inter=t_off(machine, stats.m_node_node, stats.s_node_node,
                            stats.s_node, msg_size=stats.s_node_node),
            )
        return PhaseTimes(
            local=2.0 * t_on(machine, Space.GPU, stats.s_node_node),
            inter=t_off_da(machine, stats.m_node_node, stats.s_node_node),
        )

    if strategy in (Strategy.TWO_STEP, Strategy.TWO_STEP_ONE):
        on_space = Space.CPU if transport is Transport.STAGED_HOST else Space.GPU
        local = (
            t_on(machine, on_space, stats.s_proc)
            if strategy is Strategy.TWO_STEP
            else 0.0
        )
        if transport is Transport.STAGED_HOST:
            local += t_copy(machine.copy[1], stats.s_proc, stats.s_node_node)
            inter = t_off(machine, stats.m_proc_node, stats.s_proc, stats.s_node,
                          msg_size=stats.s_proc / max(stats.m_proc_node, 1))
        else:
            inter = t_off_da(machine, stats.m_proc_node, stats.s_proc,
                             msg_size=stats.s_proc / max(stats.m_proc_node, 1))
        return PhaseTimes(local=local, inter=inter)

    if strategy in (Strategy.SPLIT_MD, Strategy.SPLIT_DD):
        if transport is not Transport.STAGED_HOST:
            raise ValueError("device-aware transport does not apply to Split (paper Table 5)")
        ppg = 1 if strategy is Strategy.SPLIT_MD else 4
        s_split = stats.s_node / ppn
        return PhaseTimes(
            local=2.0 * t_on_split(machine, stats.s_node, ppg)
            + t_copy(machine.copy[ppg], stats.s_proc, stats.s_node_node),
            inter=t_off(machine, stats.m_proc_node, s_split, stats.s_node,
                        msg_size=s_split),
        )

    raise ValueError(f"unknown strategy {strategy}")


def predict_overlapped(
    machine: MachineParams,
    strategy: Strategy,
    transport: Transport,
    stats: PatternStats,
    t_interior: float,
    t_boundary: float,
    wire: "WireModel | str | None" = None,
) -> float:
    """Split-phase pipeline time with interior compute hiding the inter-node
    phase: ``T = T_local + max(T_inter, T_interior) + T_boundary``.

    ``t_interior`` / ``t_boundary`` are the interior-tile and boundary-tile
    local compute times in seconds (e.g. from a measured per-step compute
    time scaled by :attr:`repro_torch.core.split_plan.RowPhaseSplit.interior_tile_fraction`).
    The non-overlapped counterpart of the same step is
    ``predict(...) + t_interior + t_boundary``.  A ``wire`` codec shrinks
    the hideable inter phase but its :func:`t_codec` term lands in
    ``T_local`` -- compression buys less once compute already hides the
    inter-node time.
    """
    if t_interior < 0 or t_boundary < 0:
        raise ValueError("compute times must be non-negative")
    ph = predict_phases(machine, strategy, transport, stats, wire=wire)
    return ph.local + max(ph.inter, t_interior) + t_boundary


# ---------------------------------------------------------------------------
# Iteration-amortized extension (solver workloads)
# ---------------------------------------------------------------------------

#: metadata-exchange rounds paid once at communicator construction.  The
#: standard strategy posts its receive lists directly (one round); the
#: node-aware strategies additionally gather per-process destination lists
#: on-node and scatter the redistribution maps back (two more rounds --
#: the communicator-construction phase of §2.3); Split runs Algorithm 1's
#: chunk-assignment negotiation on top (one more).
SETUP_META_ROUNDS: Dict[Strategy, int] = {
    Strategy.STANDARD: 1,
    Strategy.THREE_STEP: 3,
    Strategy.TWO_STEP: 3,
    Strategy.TWO_STEP_ONE: 3,
    Strategy.SPLIT_MD: 4,
    Strategy.SPLIT_DD: 4,
}


def _log2ceil(n: int) -> int:
    return max(1, (max(int(n), 1) - 1).bit_length())


def predict_setup(
    machine: MachineParams,
    strategy: Strategy,
    transport: Transport,
    stats: PatternStats,
) -> float:
    """One-time communicator-construction cost for a (strategy, transport).

    The paper's closing discussion (and Bienz et al.'s irregular-p2p
    modeling) notes node-aware strategies only pay off once their setup --
    exchanging index metadata and building the node communicator -- is
    amortized over many identical exchanges.  Modeled as:

    * ``SETUP_META_ROUNDS[strategy]`` metadata exchanges costed at the
      strategy's own Table 6 composite (index lists are 4-byte tokens, the
      same volume as one ``k=1`` payload), plus
    * for node-aware strategies, one on-node gather + scatter of the
      per-process maps (eq. 4.1) and a per-node-pair count agreement over a
      log-depth inter-node tree.

    Call with **unwidened** stats: metadata volume does not scale with the
    batched payload width ``k``.
    """
    t = SETUP_META_ROUNDS[strategy] * predict(machine, strategy, transport, stats)
    if strategy is not Strategy.STANDARD:
        space = Space.GPU if transport is Transport.DEVICE_AWARE else Space.CPU
        t += 2.0 * t_on(machine, space, stats.s_proc)
        p = machine.path(Space.CPU, Locality.OFF_NODE, 8.0)
        t += 2.0 * _log2ceil(stats.num_dest_nodes) * p.alpha
    return t


def predict_reduction(
    machine: MachineParams,
    stats: PatternStats,
    nbytes: float = 8.0,
) -> float:
    """Latency of one node-aware hierarchical scalar all-reduce.

    The solver's dot products follow the same hierarchy as the exchange
    strategies (``repro_torch.comm.hierarchical.dot_hierarchical``): a log-depth
    on-node tree over the PPN processes, then a log-depth inter-node tree
    over the destination-node set, then the on-node broadcast back.  The
    payload is ``nbytes`` (one float64 scalar by default), so every term is
    latency-bound.  Strategy-independent: it shifts all solver totals
    equally but keeps per-iteration predictions honest.
    """
    p_on = machine.path(Space.CPU, Locality.ON_SOCKET, nbytes)
    p_off = machine.path(Space.CPU, Locality.OFF_NODE, nbytes)
    on = 2.0 * _log2ceil(machine.procs_per_node) * (p_on.alpha + p_on.beta * nbytes)
    off = _log2ceil(stats.num_dest_nodes) * (p_off.alpha + p_off.beta * nbytes)
    return on + off


@dataclasses.dataclass(frozen=True)
class LaunchModel:
    """Host-side dispatch overheads of an iterative solve.

    The host-driven Krylov loop (:mod:`repro_torch.solve.krylov`) re-enters the
    runtime several times per iteration -- one jitted dispatch per exchange
    phase, matvec kernel, and scalar reduction -- and each re-entry costs a
    fixed host round-trip ``t_launch`` regardless of payload (the classic
    argument for triggered operations / on-NIC progress in the paper's
    lineage: move control flow next to the data and the per-message host
    wake-ups vanish).  The fused whole-solve program
    (:mod:`repro_torch.solve.fused`) pays instead ONE trace+compile ``t_trace`` at
    first use plus a single ``t_launch``, after which every iteration runs
    inside one ``lax.while_loop`` with zero host involvement.

    Attributes:
      t_launch: per-dispatch host overhead, seconds (Python -> runtime ->
        device doorbell round-trip; ~tens of microseconds).
      t_trace: one-time trace + XLA-compile cost of the fused whole-solve
        program, seconds (amortized by the fused-program cache across
        solves with the same (pattern, strategy, codec, dtype) key).
    """

    t_launch: float = 50e-6
    t_trace: float = 25e-3


def launches_per_iter(
    matvecs_per_iter: float = 1.0,
    reductions_per_iter: float = 2.0,
    overlap: bool = False,
) -> float:
    """Host dispatches per host-driven solver iteration.

    A barrier matvec is two dispatches (halo exchange program, then the
    SpMV kernel); a split-phase matvec is five (remote-plan exchange,
    local-plan exchange, interior SpMV, halo merge, boundary SpMV) -- the
    overlap that hides wire time on device costs extra host launches.  Every
    hierarchical dot product is one more jitted collective dispatch.
    """
    per_matvec = 5.0 if overlap else 2.0
    return matvecs_per_iter * per_matvec + reductions_per_iter


def predict_solver(
    machine: MachineParams,
    strategy: Strategy,
    transport: Transport,
    stats: PatternStats,
    iters: int,
    reductions_per_iter: float = 2.0,
    t_interior: float = 0.0,
    t_boundary: float = 0.0,
    overlap: bool = False,
    setup_stats: Optional[PatternStats] = None,
    fused: Optional[bool] = None,
    launch: Optional[LaunchModel] = None,
    matvecs_per_iter: float = 1.0,
) -> Tuple[float, float, float]:
    """(setup, per-iteration, total) time of an ``iters``-iteration solve.

    ``total = setup + iters * (T_step + reductions_per_iter * T_red)`` where
    ``T_step`` is the Table 6 composite plus compute (barrier) or
    :func:`predict_overlapped` (split-phase), and ``setup`` is
    :func:`predict_setup` evaluated on ``setup_stats`` (defaults to
    ``stats``; pass the unwidened stats when ``stats`` is payload-widened).

    ``fused`` selects the execution front-end modeled by ``launch`` (a
    :class:`LaunchModel`): ``None`` (default) models communication and
    compute only -- the paper's launch-overhead-free accounting, byte-
    identical to the pre-fusion model; ``False`` charges the host-driven
    loop ``t_launch`` per dispatch, :func:`launches_per_iter` dispatches per
    iteration; ``True`` charges the fused whole-solve program one
    ``t_trace + t_launch`` up front and nothing per iteration.  The
    crossover ``iters ~ t_trace / (launches * t_launch)`` is what
    ``advise_solver(fused="auto")`` exposes.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    setup = predict_setup(machine, strategy, transport, setup_stats or stats)
    if overlap:
        step = predict_overlapped(
            machine, strategy, transport, stats, t_interior, t_boundary
        )
    else:
        step = predict(machine, strategy, transport, stats) + t_interior + t_boundary
    per_iter = step + reductions_per_iter * predict_reduction(machine, stats)
    if fused is not None:
        lm = launch if launch is not None else LaunchModel()
        if fused:
            setup += lm.t_trace + lm.t_launch
        else:
            per_iter += lm.t_launch * launches_per_iter(
                matvecs_per_iter, reductions_per_iter, overlap
            )
    return setup, per_iter, setup + iters * per_iter


def predict_all(
    machine: MachineParams,
    stats: PatternStats,
    include_two_step_one: bool = False,
    wire: "WireModel | str | None" = None,
) -> Dict[Tuple[Strategy, Transport], float]:
    """Evaluate every modeled (strategy, transport) pair for one pattern."""
    out: Dict[Tuple[Strategy, Transport], float] = {}
    for strategy, transport in modeled_pairs(include_two_step_one):
        out[(strategy, transport)] = predict(
            machine, strategy, transport, stats, wire=wire
        )
    return out
