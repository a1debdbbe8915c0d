"""Mixture-of-Experts layer with capacity dispatch over stacked ranks.

The port of ``repro.models.moe``.  Token -> expert routing is the LM
incarnation of the paper's irregular point-to-point pattern: per step, every
data shard sends a data-dependent subset of its tokens to the shards owning
their experts.  Where the reference runs the expert-parallel shards under
``shard_map`` on a device mesh, the port holds every rank of a
:class:`~repro_torch.comm.PodTopology` on one device, stacked on a leading
``[nranks, ...]`` axis (the layout of the port's exchange), and the caller
passes the topology at call time in place of the reference's mesh:

* ``topo=None`` (or one rank): :meth:`MoELayer._dispatch_local`, the
  reference's single-device path -- what ``LMModel`` serves on one card;
* ``mesh=`` a ``DeviceMesh`` whose expert-parallel axes (``ep_axis``, one
  name or a tuple) have more than one chip: with ``dispatch="all_to_all"``
  :meth:`MoELayer._dispatch_shard_map`, the reference's
  ``_dispatch_shard_map`` itself, one rank per chip under ``local_map`` with
  the all-to-alls as ``torch.distributed`` collectives; with
  ``dispatch="exchange"`` (whose ``ep_axis`` is the ``("pod", "local")``
  world, as in the reference) :meth:`MoELayer._dispatch_exchange_mesh`, the
  reference's ``_dispatch_exchange`` on that mesh: both hops planned
  :class:`~repro_torch.comm.IrregularExchange` programs over the mesh's
  process groups;
* ``dispatch="all_to_all"``: :meth:`MoELayer._dispatch_all_to_all`, the
  reference's ``_dispatch_shard_map``: the batch is block-sharded over the
  ranks, expert ``e`` lives on rank ``e // (n_experts / nranks)``, and each
  ``jax.lax.all_to_all(..., tiled=True)`` becomes a block transpose of the
  stacked send buffer;
* ``dispatch="exchange"``: :meth:`MoELayer._dispatch_exchange`, the same
  routing math with both hops planned as node-aware
  :class:`~repro_torch.comm.IrregularExchange` programs over the measured
  (bucketed) routing pattern (:mod:`repro_torch.models.moe_dispatch`);
  bitwise the all-to-all path for ``wire="none"``.

Dispatch is capacity-based: assignments beyond ``capacity_factor`` per
expert (local path) or per (src shard, dst shard) slot block (the sharded
paths, with the reference's floor of 8 slots and its second capacity stage
per local expert) are dropped, standard GShard/Switch practice.  Routing is
gather-based; the only scatters are 1-D integer inverse-permutation builds
whose duplicate writes all land in a dead slot that is sliced off.

Each layer keeps a :class:`RoutingTally` of the assignments it routed and
dropped (summed on the device, read only when a caller asks), and, on the
exchange path, of the slots the hops shipped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.comm.topology import WORLD_AXES, PodTopology, exchange_group_of_mesh
from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import MLP, dot
from repro_torch.models.moe_dispatch import MoEDispatcher
from repro_torch.models.sharding import ParamSpec

#: the dispatch paths of a sharded call (``topo`` with more than one rank)
DISPATCH_MODES = ("all_to_all", "exchange")


@dataclasses.dataclass
class RoutingTally:
    """Running counts of one layer's routing over its calls.

    ``routed`` counts token-expert assignments and ``shipped`` the slots the
    exchange hops carried (both host integers, from shapes and plans);
    ``dropped`` the assignments a capacity stage dropped, kept as a device
    scalar so that counting never waits for the device.
    """

    calls: int = 0
    routed: int = 0
    shipped: int = 0
    dropped: Optional[torch.Tensor] = None

    def add(self, routed: int, dropped: torch.Tensor, shipped: int = 0) -> None:
        self.calls += 1
        self.routed += routed
        self.shipped += shipped
        self.dropped = dropped if self.dropped is None else self.dropped + dropped

    def read(self) -> dict:
        """The counts as host integers (one device read)."""
        dropped = 0 if self.dropped is None else int(self.dropped)
        return {"calls": self.calls, "routed": self.routed, "dropped": dropped, "shipped": self.shipped}

    def reset(self) -> None:
        self.calls = self.routed = self.shipped = 0
        self.dropped = None


def _inverse(slot: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Which assignment fills each of ``size`` slots, ``fill`` where none does.

    ``slot [..., t]`` holds each assignment's slot in ``[0, size]``; ``size``
    is the drop slot, whose (duplicate) writers are sliced off.  Returns
    ``[..., size]`` int64.
    """
    t = slot.shape[-1]
    src = torch.arange(t, device=slot.device).expand(slot.shape)
    inv = torch.full((*slot.shape[:-1], size + 1), fill, dtype=torch.int64, device=slot.device)
    return inv.scatter_(-1, slot, src)[..., :-1]


def _pad_row(x: torch.Tensor, value=0) -> torch.Tensor:
    """``x [n, L, ...]`` with one more row of ``value`` at index ``L``."""
    pad = torch.full((x.shape[0], 1, *x.shape[2:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank gather: ``out[r, j] = x[r, idx[r, j]]`` for ``x [n, L, ...]``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


@dataclasses.dataclass(frozen=True)
class MoELayer:
    d_model: int
    cfg: MoEConfig
    act: str = "silu"
    #: expert-parallel mesh axis of a ``mesh`` call, or a tuple of axes
    #: (e.g. ``("pod", "local")`` to run dispatch over the whole exchange
    #: mesh); ``dispatch="exchange"`` turns the default into the latter
    ep_axis: Union[str, Tuple[str, ...]] = "data"
    #: sharded path: "all_to_all" (the block-transpose baseline) or
    #: "exchange" (node-aware IrregularExchange hops, planned per measured
    #: routing pattern -- see repro_torch.models.moe_dispatch)
    dispatch: str = "all_to_all"
    #: exchange strategy: "auto" (advisor-picked from the measured routing
    #: histogram) or one of repro_torch.comm.STRATEGY_NAMES
    strategy: str = "auto"
    #: inter-pod wire codec for the exchange path ("none" = full precision)
    wire: str = "none"
    #: slot granularity for routing-count bucketing (plan-cache stability)
    route_quantum: int = 8
    #: lazily-created per-layer dispatcher; not part of identity
    dispatcher: Optional[MoEDispatcher] = dataclasses.field(default=None, compare=False)
    tally: RoutingTally = dataclasses.field(default_factory=RoutingTally, compare=False)

    def __post_init__(self) -> None:
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch must be 'all_to_all' or 'exchange', got {self.dispatch!r}")
        if self.dispatch == "exchange" and self.ep_axis == "data":
            # exchange dispatch runs over the ("pod", "local") exchange mesh
            object.__setattr__(self, "ep_axis", WORLD_AXES)

    def params(self) -> dict:
        E, M, F_ = self.cfg.n_experts, self.d_model, self.cfg.d_ff_expert
        p = {
            "router": ParamSpec((M, E), ("fsdp", None)),
            "w_in": ParamSpec((E, M, F_), ("experts", None, "mlp")),
            "w_gate": ParamSpec((E, M, F_), ("experts", None, "mlp")),
            "w_out": ParamSpec((E, F_, M), ("experts", "mlp", None)),
        }
        if self.cfg.n_shared:
            p["shared"] = self._shared().params()
        return p

    def _shared(self) -> MLP:
        return MLP(self.d_model, self.cfg.d_ff_expert * self.cfg.n_shared, self.act)

    # ------------------------------------------------------------------
    def route(self, params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(top_p, top_e)``, each ``[B, S, k]``: the router's softmax in
        float32, its top-k experts and their renormalised weights."""
        logits = dot(x, params["router"].to(x.dtype))
        probs = torch.softmax(logits.float(), dim=-1)
        top_p, top_e = torch.topk(probs, self.cfg.top_k, dim=-1)
        return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e

    def _ep_axes(self) -> Tuple[str, ...]:
        return self.ep_axis if isinstance(self.ep_axis, tuple) else (self.ep_axis,)

    def _ep_size(self, mesh) -> int:
        """Expert-parallel degree of ``mesh``: the product over the ep axes;
        1 when any of them is absent."""
        axes = self._ep_axes()
        if mesh is None or any(a not in mesh.mesh_dim_names for a in axes):
            return 1
        return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)

    def __call__(self, params, x: torch.Tensor, topo: Optional[PodTopology] = None, mesh=None) -> torch.Tensor:
        """x: [B, S, M].  Routed experts + optional shared experts.

        ``topo`` places the experts and the batch on its stacked ranks; with
        ``None`` or one rank the layer runs the single-device path.  ``mesh``
        (parameters and ``x`` DTensors on it) runs the expert-parallel
        dispatch over its ``ep_axis``, as the reference does on its mesh: the
        all-to-all, or the exchange over a ``("pod", "local")`` mesh.
        """
        sharded = self._ep_size(mesh) > 1
        # the exchange's errors come before the router reads x
        shapes = self._mesh_shapes(x.shape, mesh) if sharded and self.dispatch == "exchange" else None
        top_p, top_e = self.route(params, x)
        if shapes is not None:
            routed = self._dispatch_exchange_mesh(params, x, top_p, top_e, mesh, shapes)
        elif sharded:
            routed = self._dispatch_shard_map(params, x, top_p, top_e, mesh)
        elif topo is None or topo.nranks == 1:
            routed = self._dispatch_local(params, x, top_p, top_e)
        elif self.dispatch == "exchange":
            routed = self._dispatch_exchange(params, x, top_p, top_e, topo)
        else:
            routed = self._dispatch_all_to_all(params, x, top_p, top_e, topo)
        if self.cfg.n_shared:
            routed = routed + self._shared()(params["shared"], x)
        return routed

    # ------------------------------------------------------------------
    def _expert_ffn(self, w_in, w_gate, w_out, xe: torch.Tensor) -> torch.Tensor:
        """Batched per-expert SwiGLU FFN. xe: [E, C, M] -> [E, C, M]."""
        h = torch.bmm(xe, w_in.to(xe.dtype))
        g = torch.bmm(xe, w_gate.to(xe.dtype))
        return torch.bmm(F.silu(g) * h, w_out.to(xe.dtype))

    @staticmethod
    def _fill_capacity(eid: torch.Tensor, cap: int):
        """Position of each assignment within its bin; ``>= cap`` means dropped.

        eid: ``[..., T]`` bin ids (each leading index is one rank).  Returns
        ``(pos_in_bin, keep)``, both ``[..., T]``.  A stable argsort groups
        each bin's assignments in arrival order, the position within the run
        is ``index - run start`` (a ``cummax`` over run-start indices), and
        an inverse scatter restores assignment order -- the reference's
        construction, so the positions are its own.
        """
        t = eid.shape[-1]
        order = torch.argsort(eid, dim=-1, stable=True)
        idx = torch.arange(t, device=eid.device).expand(eid.shape)
        sorted_eid = eid.gather(-1, order)
        is_start = torch.ones(eid.shape, dtype=torch.bool, device=eid.device)
        is_start[..., 1:] = sorted_eid[..., 1:] != sorted_eid[..., :-1]
        start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
        pos = torch.empty_like(order).scatter_(-1, order, idx - start)
        return pos, pos < cap

    # -- single-device path ------------------------------------------------
    def _dispatch_local(self, params, x, top_p, top_e) -> torch.Tensor:
        cfg = self.cfg
        B, S, M = x.shape
        E, k = cfg.n_experts, cfg.top_k
        T = B * S * k
        xt = x.reshape(B * S, M)
        xt = xt.repeat_interleave(k, dim=0) if k > 1 else xt  # [T, M]
        eid = top_e.reshape(T)
        w = top_p.reshape(T).to(x.dtype)
        cap = max(int(T / E * cfg.capacity_factor), 1)
        pos, keep = self._fill_capacity(eid, cap)
        slot = torch.where(keep, eid * cap + pos, E * cap)  # drop slot
        buf = _pad_row(xt[None])[0][_inverse(slot, E * cap, T)]
        ye = self._expert_ffn(params["w_in"], params["w_gate"], params["w_out"], buf.view(E, cap, M))
        yt = _pad_row(ye.reshape(1, E * cap, M))[0][slot] * w[:, None]
        self.tally.add(T, (~keep).sum())
        return yt.reshape(B * S, k, M).sum(1).reshape(B, S, M)

    # -- expert-parallel paths over stacked ranks ---------------------------
    def _shard_shapes(self, B: int, S: int, topo: PodTopology) -> Tuple[int, int, int, int]:
        """``(n, e_local, t, cap)`` of a sharded call, with the reference's
        divisibility checks (its messages, the topology in place of the
        mesh axes)."""
        cfg = self.cfg
        n = topo.nranks
        if cfg.n_experts % n:
            raise ValueError(
                f"n_experts={cfg.n_experts} is not divisible by the "
                f"expert-parallel degree {n} (topology {topo.npods}x{topo.ppn}); "
                f"choose n_experts as a multiple of {n}"
            )
        if B % n:
            raise ValueError(
                f"dispatch={self.dispatch!r} shards the batch over all {n} ranks; "
                f"batch {B} is not divisible by {n}"
            )
        t = B // n * S * cfg.top_k
        # capacity per (src shard -> dst shard) slot block; the floor of 8
        # keeps decode-time (tiny t) routing essentially drop-free
        return n, cfg.n_experts // n, t, max(int(t / n * cfg.capacity_factor), 8)

    def _stage_send(self, x, top_p, top_e, n: int, e_local: int, t: int, cap: int, ranks: Optional[int] = None):
        """Per rank: the ``[n * cap]`` send slots (token rows and local expert
        ids, dead slots zero / ``e_local``), each assignment's slot, its
        weight, and its destination rank.  ``ranks`` (default ``n``) is how
        many of the ``n`` ranks are stacked here: one under a mesh, where each
        chip runs its own."""
        ranks = n if ranks is None else ranks
        M, k = x.shape[-1], self.cfg.top_k
        xt = x.reshape(ranks, -1, M)
        xt = xt.repeat_interleave(k, dim=1) if k > 1 else xt  # [ranks, t, M]
        eid = top_e.reshape(ranks, t)
        w = top_p.reshape(ranks, t).to(x.dtype)
        dst = eid // e_local
        pos, keep = self._fill_capacity(dst, cap)
        slot = torch.where(keep, dst * cap + pos, n * cap)
        inv = _inverse(slot, n * cap, t)
        send = _take(_pad_row(xt), inv)
        send_e = _take(_pad_row((eid % e_local).to(torch.int32), e_local), inv)
        return send, send_e, slot, w, dst, (~keep).sum()

    def _stage_expert(self, params, recv, recv_e, n: int, e_local: int, cap: int):
        """Bin the received slots into the local experts (the second capacity
        stage), run them, and lay their outputs back out in the received
        slot order (the return hop's send buffer).  Returns ``(back, dropped)``."""
        M, ranks = recv.shape[-1], recv.shape[0]
        cap2 = max(int(n * cap / e_local), 1)
        bin_id = torch.clamp(recv_e, max=e_local)  # dead slots -> drop bin
        pos2, keep2 = self._fill_capacity(bin_id, cap2)
        live = recv_e < e_local
        keep2 &= live
        slot2 = torch.where(keep2, bin_id.long() * cap2 + pos2, e_local * cap2)
        buf = _take(_pad_row(recv), _inverse(slot2, e_local * cap2, n * cap))
        ye = self._expert_ffn(params["w_in"], params["w_gate"], params["w_out"],
                              buf.view(ranks * e_local, cap2, M)).view(ranks, e_local * cap2, M)
        return _take(_pad_row(ye), slot2), (live & ~keep2).sum()

    @staticmethod
    def _stage_combine(ret, slot, w, B: int, S: int, k: int):
        """Weight each assignment's returned row and sum its top-k."""
        M = ret.shape[-1]
        yt = _take(_pad_row(ret), slot) * w[..., None]
        return yt.reshape(B * S, k, M).sum(1).reshape(B, S, M)

    @staticmethod
    def _all_to_all(buf: torch.Tensor, n: int) -> torch.Tensor:
        """The tiled all-to-all over stacked ranks: block ``d`` of rank ``s``
        becomes block ``s`` of rank ``d``."""
        return buf.reshape(n, n, -1, *buf.shape[2:]).transpose(0, 1).reshape(buf.shape)

    def _dispatch_all_to_all(self, params, x, top_p, top_e, topo) -> torch.Tensor:
        B, S, _ = x.shape
        n, e_local, t, cap = self._shard_shapes(B, S, topo)
        send, send_e, slot, w, _, drop1 = self._stage_send(x, top_p, top_e, n, e_local, t, cap)
        recv, recv_e = self._all_to_all(send, n), self._all_to_all(send_e, n)
        back, drop2 = self._stage_expert(params, recv, recv_e, n, e_local, cap)
        out = self._stage_combine(self._all_to_all(back, n), slot, w, B, S, self.cfg.top_k)
        self.tally.add(n * t, drop1 + drop2)
        return out.to(x.dtype)

    # -- expert-parallel all-to-all on a DeviceMesh -------------------------
    def _dispatch_shard_map(self, params, x, top_p, top_e, mesh) -> torch.Tensor:
        """The reference's ``_dispatch_shard_map``: one rank per chip, under
        ``local_map`` (the counterpart of ``shard_map``).

        Tokens are sharded over ``("pod", ep)`` where present (over the ep
        axes alone when ``ep_axis`` is a tuple), experts over the ep axes and
        each expert's FFN dim over ``model``.  Each chip runs the two
        capacity stages of the stacked path on its own tokens
        (:meth:`_stage_send`, :meth:`_stage_expert` with one stacked rank);
        the hops are ``all_to_all_single`` over the ep axes (a tuple of axes
        flattened into one group, row-major as the reference's), and the
        expert outputs, partial sums over the ``model`` shards of F, are
        summed once on the combined ``[b, S, M]`` output, as in the
        reference.
        """
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor.experimental import local_map

        cfg = self.cfg
        ep = self.ep_axis
        nd = self._ep_size(mesh)
        if cfg.n_experts % nd:
            raise ValueError(
                f"n_experts={cfg.n_experts} is not divisible by the "
                f"expert-parallel degree {nd} (mesh axis {ep!r}); choose "
                f"n_experts as a multiple of {nd}, or drop ep_axis from the "
                "mesh to run the replicated local path"
            )
        e_local = cfg.n_experts // nd
        names = mesh.mesh_dim_names
        axes = self._ep_axes()
        ep_group = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
        batch_axes = axes if isinstance(ep, tuple) else ("pod", ep)
        k = cfg.top_k
        model = mesh["model"] if "model" in names and mesh.size(names.index("model")) > 1 else None

        def a2a(t):
            out = funcol.all_to_all_single(t.contiguous(), None, None, ep_group)
            return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out

        def body(xl, pl, el, w_in, w_gate, w_out):
            b, S, M = xl.shape
            t = b * S * k
            # capacity per (src shard -> dst shard) slot; the floor of 8 keeps
            # decode-time (tiny t) routing essentially drop-free
            cap = max(int(t / nd * cfg.capacity_factor), 8)
            send, send_e, slot, w, _, drop1 = self._stage_send(xl, pl, el, nd, e_local, t, cap, ranks=1)
            recv, recv_e = a2a(send[0])[None], a2a(send_e[0])[None]
            back, drop2 = self._stage_expert({"w_in": w_in, "w_gate": w_gate, "w_out": w_out},
                                             recv, recv_e, nd, e_local, cap)
            out = self._stage_combine(a2a(back[0])[None], slot, w, b, S, k)
            self.tally.add(t, drop1 + drop2)
            if model is not None:
                out = funcol.all_reduce(out, "sum", model)
                out = out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out
            return out.to(xl.dtype)

        x_place = tuple(Shard(0) if a in batch_axes else Replicate() for a in names)
        w_place = tuple(Shard(0) if a in axes else Shard(2) if a == "model" else Replicate() for a in names)
        wo_place = tuple(Shard(0) if a in axes else Shard(1) if a == "model" else Replicate() for a in names)
        return local_map(
            body, out_placements=list(x_place),
            in_placements=(x_place, x_place, x_place, w_place, w_place, wo_place),
            device_mesh=mesh, redistribute_inputs=True,
        )(x, top_p, top_e, params["w_in"], params["w_gate"], params["w_out"])

    # -- node-aware exchange dispatch ----------------------------------------
    def _get_dispatcher(self, topo: PodTopology, device, group=None) -> MoEDispatcher:
        if self.dispatcher is None or self.dispatcher.group != group:
            disp = MoEDispatcher(topo, strategy=self.strategy, wire=self.wire,
                                 quantum=self.route_quantum, device=device, group=group)
            object.__setattr__(self, "dispatcher", disp)
        return self.dispatcher

    def _device_maps(self, bundle, cap: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bundle's splice maps on ``device``, moved once per bundle (one
        bundle per capacity is current: the bucketer of that block size)."""
        memo = self.__dict__.setdefault("_map_memo", {})
        key = (cap, str(device))
        got = memo.get(key)
        if got is None or got[0] is not bundle:
            maps = tuple(torch.as_tensor(m, dtype=torch.int64, device=device)
                         for m in (bundle.map_dispatch, bundle.map_return))
            got = memo[key] = (bundle, *maps)
        return got[1], got[2]

    def _dispatch_exchange(self, params, x, top_p, top_e, topo) -> torch.Tensor:
        """Capacity dispatch with both hops on the node-aware exchange stack.

        Same routing math as :meth:`_dispatch_all_to_all`, in three stages
        with the block transposes replaced by planned
        :class:`~repro_torch.comm.IrregularExchange` hops over the measured
        (bucketed) routing pattern, so skewed traffic ships only the occupied
        slot prefix per pair, the advisor can pick the strategy per pattern,
        and wire codecs apply to the inter-pod segments.  The per-pair count
        matrix is read by the host each batch (one ``[n, n]`` transfer); it
        keys the bucketer and feeds the dispatcher's load histogram.

        Bitwise the all-to-all path for ``wire="none"``: kept assignments
        occupy the block prefix (at most the quantized width), and every slot
        the all-to-all carries as dead (zero row / sentinel expert id) is
        reproduced by the splice maps' sentinel row.
        """
        B, S, M = x.shape
        n, e_local, t, cap = self._shard_shapes(B, S, topo)
        send, send_e, slot, w, dst, drop1 = self._stage_send(x, top_p, top_e, n, e_local, t, cap)
        # the [n, n] count matrix of assignments by (src, dst)
        rank = torch.arange(n, device=x.device)[:, None]
        counts = torch.bincount((rank * n + dst).reshape(-1), minlength=n * n).view(n, n)

        # host read of the measured [n, n] histogram: the price of planning
        # communication for the traffic we actually have
        step = self._get_dispatcher(topo, x.device).step(counts.cpu().numpy(), cap, payload_width=M)
        map_d, map_r = self._device_maps(step.bundle, cap, x.device)
        out, drop2 = self._exchange_hops(params, send, send_e, slot, w, step, map_d, map_r, (n, e_local, cap),
                                         B, S)
        shipped = 2 * int(step.bundle.widths.sum())
        self.tally.add(n * t, drop1 + drop2, shipped)
        return out.to(x.dtype)

    def _exchange_hops(self, params, send, send_e, slot, w, step, map_d, map_r, shape: tuple, B: int, S: int):
        """The dispatch hop, the splice into the ``[n * cap]`` slot layout,
        the experts, the return hop and the combine, on the ranks stacked in
        ``send`` (``map_d`` / ``map_r`` their rows of the bundle's splice
        maps).  Returns ``(out [B, S, M], dropped)``."""
        n, e_local, cap = shape
        ex_d, ex_r = step.exchange_dispatch, step.exchange_return
        if ex_d is not None:
            halo_x, halo_e = ex_d(send), ex_d(send_e)
        else:
            halo_x, halo_e = send[:, :0], send_e[:, :0]
        # splice the canonical exchange receive into the [n * cap] slot
        # layout; the sentinel row reproduces the all-to-all's dead slots
        recv = _take(_pad_row(torch.cat([send, halo_x], dim=1)), map_d)
        recv_e = _take(_pad_row(torch.cat([send_e, halo_e], dim=1), e_local), map_d)
        back, drop2 = self._stage_expert(params, recv, recv_e, n, e_local, cap)

        halo_b = ex_r(back) if ex_r is not None else back[:, :0]
        ret = _take(_pad_row(torch.cat([back, halo_b], dim=1)), map_r)
        return self._stage_combine(ret, slot, w, B, S, self.cfg.top_k), drop2

    # -- node-aware exchange dispatch on a ("pod", "local") DeviceMesh -------
    def _mesh_shapes(self, shape, mesh) -> Tuple[int, int, int, int]:
        """``(n, e_local, t, cap)`` of an exchange dispatch on ``mesh`` for
        ``x`` of global ``shape``, with the reference's three errors."""
        cfg = self.cfg
        names = tuple(mesh.mesh_dim_names)
        if names != WORLD_AXES:
            raise ValueError(f'dispatch="exchange" needs the ("pod", "local") exchange mesh, got axes {names}')
        n = mesh.size()
        if cfg.n_experts % n:
            raise ValueError(
                f"n_experts={cfg.n_experts} is not divisible by the "
                f"expert-parallel degree {n} (mesh axes {WORLD_AXES!r}); "
                f"choose n_experts as a multiple of {n}"
            )
        B, S, _ = shape
        if B % n:
            raise ValueError(f'dispatch="exchange" shards the batch over all {n} ranks; batch {B} is not divisible by {n}')
        t = B // n * S * cfg.top_k
        return n, cfg.n_experts // n, t, max(int(t / n * cfg.capacity_factor), 8)

    def _dispatch_exchange_mesh(self, params, x, top_p, top_e, mesh, shapes) -> torch.Tensor:
        """The reference's ``_dispatch_exchange`` on its ``("pod", "local")``
        mesh: one rank per process, under ``local_map``.

        Tokens and experts are sharded over both axes (rank ``pod * ppn +
        local`` holds batch block and expert block of that index).  Each rank
        runs :meth:`_stage_send` on its own tokens, forms its row of the
        ``[n, n]`` count matrix and all-gathers the matrix on the host (the
        reference's one host read of the counts per batch), so every rank
        buckets the same counts and plans the same exchanges -- a rank that
        planned another would leave the next collective unmatched.  The two
        hops are :class:`~repro_torch.comm.IrregularExchange` programs over
        the mesh's own ``local`` and ``pod`` process groups
        (:func:`~repro_torch.comm.topology.exchange_group_of_mesh`), on this
        rank's ``[1, n * cap, M]`` buffers, then the stacked path's splice,
        experts and combine.  Bitwise the mesh all-to-all
        (:meth:`_dispatch_shard_map` with the same ``ep_axis``) for
        ``wire="none"``.  The tally counts this rank's assignments, drops and
        the slots it sends on both hops; summed over the ranks they are the
        stacked path's.
        """
        import torch.distributed as dist
        from torch.distributed.tensor.experimental import local_map

        n, e_local, t, cap = shapes
        S, M = x.shape[1:]
        group = exchange_group_of_mesh(mesh)
        r = group.rank

        def body(xl, pl, el, w_in, w_gate, w_out):
            send, send_e, slot, w, dst, drop1 = self._stage_send(xl, pl, el, n, e_local, t, cap, ranks=1)
            row = torch.bincount(dst.reshape(-1), minlength=n).cpu()
            rows = [torch.empty_like(row) for _ in range(n)]
            dist.all_gather(rows, row)
            step = self._get_dispatcher(group.topo, xl.device, group).step(
                torch.stack(rows).numpy(), cap, payload_width=M)
            map_d, map_r = self._device_maps(step.bundle, cap, xl.device)
            out, drop2 = self._exchange_hops({"w_in": w_in, "w_gate": w_gate, "w_out": w_out}, send, send_e,
                                             slot, w, step, map_d[r : r + 1], map_r[r : r + 1], (n, e_local, cap),
                                             xl.shape[0], S)
            widths = step.bundle.widths
            self.tally.add(t, drop1 + drop2, int(widths[r].sum() + widths[:, r].sum()))
            return out.to(xl.dtype)

        place = (Shard(0), Shard(0))
        return local_map(body, out_placements=list(place), in_placements=(place,) * 6, device_mesh=mesh,
                         redistribute_inputs=True)(x, top_p, top_e, params["w_in"], params["w_gate"],
                                                   params["w_out"])
