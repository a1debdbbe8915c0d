"""The original pure-Python token-list planner, kept as an oracle for plans.

A numpy copy of the reference's ``repro/comm/_legacy_planner.py``: the
pre-vectorization ``_Planner`` (token tuples in Python lists, per-token dict
lookups in ``_positions``).  It produces byte-for-byte the same stage
programs as the vectorized planner in :mod:`repro_torch.comm.exchange`, so
tests can cross-check the vectorized planner's stage programs and byte
accounting against an independent implementation, and a planning benchmark
can time it as the baseline.

Do not use it on hot paths -- planning here is O(nranks x buflen) Python
loops per stage.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.comm.exchange import (
    PAD,
    A2ALocal,
    A2APod,
    ExchangePattern,
    Gather,
    PermuteWorld,
    Stage,
    StagePlan,
    Token,
    simulate_stage,
)


class _LegacyPlanner:
    """Builds stages while tracking the symbolic buffer state (token lists)."""

    def __init__(self, pattern: ExchangePattern):
        self.pattern = pattern
        self.topo = pattern.topo
        self.local = [
            [(r, e) for e in range(pattern.local_size)]
            for r in range(self.topo.nranks)
        ]
        self.buf: List[List[Optional[Token]]] = [[] for _ in range(self.topo.nranks)]
        self.stages: List[Stage] = []
        self.intra_payload = 0
        self.inter_payload = 0
        self.wire_intra = 0
        self.wire_inter = 0

    # -- position lookup ------------------------------------------------
    def _positions(self, r: int) -> Dict[Token, int]:
        pos: Dict[Token, int] = {}
        ext = self.buf[r] + self.local[r]
        for i, t in enumerate(ext):
            if t is not None and t not in pos:
                pos[t] = i
        return pos

    def _apply(self, stage: Stage) -> None:
        self.stages.append(stage)
        self.buf = simulate_stage(self.topo, stage, self.buf, self.local)

    # -- stage emitters ---------------------------------------------------
    def gather(self, select: Callable[[int], List[Optional[Token]]], width: Optional[int] = None) -> None:
        nranks = self.topo.nranks
        rows = [select(r) for r in range(nranks)]
        K = width if width is not None else max((len(x) for x in rows), default=0)
        K = max(K, 1)
        idx = np.zeros((nranks, K), dtype=np.int32)
        for r in range(nranks):
            pos = self._positions(r)
            sentinel = len(self.buf[r]) + len(self.local[r])
            for k in range(K):
                tok = rows[r][k] if k < len(rows[r]) else PAD
                if tok is PAD:
                    idx[r, k] = sentinel
                else:
                    if tok not in pos:
                        raise AssertionError(
                            f"planner bug: token {tok} not held by rank {r}"
                        )
                    idx[r, k] = pos[tok]
        self._apply(Gather(idx=idx))

    def a2a_local(self, elem_bytes: int) -> None:
        buflen = len(self.buf[0])
        assert buflen % self.topo.ppn == 0
        blk = buflen // self.topo.ppn
        for r in range(self.topo.nranks):
            l = self.topo.local_of(r)
            for j in range(self.topo.ppn):
                if j == l:
                    continue  # self block does not hit the wire
                seg = self.buf[r][j * blk : (j + 1) * blk]
                self.intra_payload += sum(t is not None for t in seg) * elem_bytes
                self.wire_intra += blk * elem_bytes
        self._apply(A2ALocal(buflen=buflen))

    def a2a_pod(self, elem_bytes: int) -> None:
        buflen = len(self.buf[0])
        assert buflen % self.topo.npods == 0
        blk = buflen // self.topo.npods
        for r in range(self.topo.nranks):
            p = self.topo.pod_of(r)
            for q in range(self.topo.npods):
                if q == p:
                    continue
                seg = self.buf[r][q * blk : (q + 1) * blk]
                self.inter_payload += sum(t is not None for t in seg) * elem_bytes
                self.wire_inter += blk * elem_bytes
        self._apply(A2APod(buflen=buflen))

    def permute_world(
        self,
        rounds: List[Dict[int, Tuple[int, List[Token]]]],
        elem_bytes: int,
    ) -> None:
        """``rounds[i][src] = (dst, tokens)``: src sends tokens to dst."""
        nranks = self.topo.nranks
        perm_list, blks, sels = [], [], []
        for rnd in rounds:
            blk = max((len(toks) for _, toks in rnd.values()), default=0)
            blk = max(blk, 1)
            sel = np.zeros((nranks, blk), dtype=np.int32)
            perm = []
            for r in range(nranks):
                pos = self._positions(r)
                sentinel = len(self.buf[r]) + len(self.local[r])
                if r in rnd:
                    dst, toks = rnd[r]
                    perm.append((r, dst))
                    inter = self.topo.pod_of(r) != self.topo.pod_of(dst)
                    payload = len(toks) * elem_bytes
                    if inter:
                        self.inter_payload += payload
                        self.wire_inter += blk * elem_bytes
                    else:
                        self.intra_payload += payload
                        self.wire_intra += blk * elem_bytes
                    for k in range(blk):
                        sel[r, k] = pos[toks[k]] if k < len(toks) else sentinel
                else:
                    sel[r, :] = len(self.buf[r]) + len(self.local[r])
            perm_list.append(tuple(perm))
            blks.append(blk)
            sels.append(sel)
        self._apply(
            PermuteWorld(rounds=tuple(perm_list), blks=tuple(blks), sels=tuple(sels))
        )

    # -- shared epilogue ---------------------------------------------------
    def redistribute_and_finish(self, elem_bytes: int, extra_local_direct: bool) -> None:
        """Intra-pod redistribution (local_Rcomm) + canonical projection."""
        topo, pat = self.topo, self.pattern
        rows: List[List[List[Optional[Token]]]] = []
        for r in range(topo.nranks):
            p = topo.pod_of(r)
            pos = self._positions(r)
            held = set(t for t in pos if extra_local_direct or t[0] != r)
            blocks = []
            for j in range(topo.ppn):
                d = topo.rank_of(p, j)
                if d == r:
                    # self block: stays on-device (never hits the wire), but
                    # must carry tokens this rank holds *for itself*, because
                    # the gather replaces the buffer.  Own local elements are
                    # always reachable via ext, so exclude them.
                    want = [
                        t for t in pat.canonical_tokens(d) if t in held and t[0] != r
                    ]
                else:
                    want = [t for t in pat.canonical_tokens(d) if t in held]
                blocks.append(sorted(set(want)))
            rows.append(blocks)
        B = max(max(len(b) for b in blocks) for blocks in rows)
        B = max(B, 1)

        def sel(r: int) -> List[Optional[Token]]:
            out: List[Optional[Token]] = []
            for b in rows[r]:
                out.extend(b)
                out.extend([PAD] * (B - len(b)))
            return out

        self.gather(sel, width=B * topo.ppn)
        self.a2a_local(elem_bytes)
        self.finish_canonical()

    def finish_canonical(self) -> None:
        pat = self.pattern
        H = max(pat.max_recv_size(), 1)
        self.gather(lambda r: list(pat.canonical_tokens(r)), width=H)

    def build(self, strategy: str) -> StagePlan:
        pat = self.pattern
        # verify delivery
        for r in range(self.topo.nranks):
            want = pat.canonical_tokens(r)
            got = self.buf[r][: len(want)]
            if got != want:
                raise AssertionError(
                    f"strategy {strategy}: rank {r} canonical mismatch"
                )
        return StagePlan(
            strategy=strategy,
            pattern=pat,
            stages=tuple(self.stages),
            out_size=max(pat.max_recv_size(), 1),
            intra_pod_bytes=self.intra_payload,
            inter_pod_bytes=self.inter_payload,
            wire_intra_pod_bytes=self.wire_intra,
            wire_inter_pod_bytes=self.wire_inter,
        )


# ---------------------------------------------------------------------------
# Strategy planners (token-list versions)
# ---------------------------------------------------------------------------


def plan_standard(pattern: ExchangePattern, elem_bytes: int = 4) -> StagePlan:
    """Standard communication: dense per-(src,dst) exchange."""
    topo = pattern.topo
    pl = _LegacyPlanner(pattern)
    by_pair: Dict[Tuple[int, int], List[Token]] = defaultdict(list)
    for n in pattern.needs:
        by_pair[(n.src, n.dst)] = [(n.src, e) for e in n.idx]
    B = max((len(v) for v in by_pair.values()), default=0)
    B = max(B, 1)

    # layout [npods, ppn, B] by destination (pod, local)
    def sel(r: int) -> List[Optional[Token]]:
        out: List[Optional[Token]] = []
        for d in range(topo.nranks):
            toks = by_pair.get((r, d), [])
            out.extend(toks)
            out.extend([PAD] * (B - len(toks)))
        return out

    pl.gather(sel, width=topo.nranks * B)
    pl.a2a_pod(elem_bytes)
    # transpose [q, j, B] -> [j, q, B] so A2ALocal blocks are contiguous
    buf = pl.buf

    def transpose_sel(r: int) -> List[Optional[Token]]:
        row = buf[r]
        out: List[Optional[Token]] = []
        for j in range(topo.ppn):
            for q in range(topo.npods):
                base = (q * topo.ppn + j) * B
                out.extend(row[base : base + B])
        return out

    pl.gather(transpose_sel, width=topo.nranks * B)
    pl.a2a_local(elem_bytes)
    pl.finish_canonical()
    return pl.build("standard")


def plan_two_step(pattern: ExchangePattern, elem_bytes: int = 4) -> StagePlan:
    """2-Step: per-(src rank -> dst pod) fused, deduped messages (§2.3.2)."""
    topo = pattern.topo
    pl = _LegacyPlanner(pattern)
    fused: Dict[Tuple[int, int], List[Token]] = {}
    for r in range(topo.nranks):
        for p in range(topo.npods):
            fused[(r, p)] = [(r, e) for e in pattern.dedup_for_pod(r, p)]
    B = max((len(v) for v in fused.values()), default=0)
    B = max(B, 1)

    def sel(r: int) -> List[Optional[Token]]:
        out: List[Optional[Token]] = []
        for p in range(topo.npods):
            toks = fused[(r, p)] if p != topo.pod_of(r) else []
            out.extend(toks)
            out.extend([PAD] * (B - len(toks)))
        return out

    pl.gather(sel, width=topo.npods * B)
    pl.a2a_pod(elem_bytes)
    pl.redistribute_and_finish(elem_bytes, extra_local_direct=True)
    return pl.build("two_step")


def plan_three_step(pattern: ExchangePattern, elem_bytes: int = 4) -> StagePlan:
    """3-Step: gather to the pair agent, one fused inter-pod message per pod
    pair, intra-pod redistribution (§2.3.1)."""
    topo = pattern.topo
    pl = _LegacyPlanner(pattern)
    # deduped contribution of each rank to each foreign pod
    contrib: Dict[Tuple[int, int], List[Token]] = {}
    for r in range(topo.nranks):
        for p in range(topo.npods):
            if p == topo.pod_of(r):
                continue
            contrib[(r, p)] = [(r, e) for e in pattern.dedup_for_pod(r, p)]

    # step 1: route contributions to the (src pod, dst pod) agent
    rows: Dict[int, List[List[Optional[Token]]]] = {}
    for r in range(topo.nranks):
        q = topo.pod_of(r)
        blocks: List[List[Optional[Token]]] = [[] for _ in range(topo.ppn)]
        for p in range(topo.npods):
            if p == q:
                continue
            blocks[topo.agent_local(q, p)].extend(contrib[(r, p)])
        rows[r] = blocks
    B1 = max(max(len(b) for b in blocks) for blocks in rows.values())
    B1 = max(B1, 1)

    def sel1(r: int) -> List[Optional[Token]]:
        out: List[Optional[Token]] = []
        for b in rows[r]:
            out.extend(b)
            out.extend([PAD] * (B1 - len(b)))
        return out

    pl.gather(sel1, width=B1 * topo.ppn)
    pl.a2a_local(elem_bytes)

    # step 2: one fused message per pod pair, spread over shifts
    rounds = []
    for d in topo.pod_shift_rounds():
        rnd: Dict[int, Tuple[int, List[Token]]] = {}
        for q in range(topo.npods):
            p = (q + d) % topo.npods
            a = topo.agent_local(q, p)
            src = topo.rank_of(q, a)
            dst = topo.rank_of(p, a)
            toks: List[Token] = []
            for l in range(topo.ppn):
                toks.extend(contrib[(topo.rank_of(q, l), p)])
            rnd[src] = (dst, sorted(set(toks)))
        rounds.append(rnd)
    pl.permute_world(rounds, elem_bytes)
    pl.redistribute_and_finish(elem_bytes, extra_local_direct=True)
    return pl.build("three_step")


def _greedy_rounds(
    chunks: List[Tuple[int, int, List[Token]]]
) -> List[Dict[int, Tuple[int, List[Token]]]]:
    """Edge-color the chunk multigraph into rounds (largest chunks first)."""
    remaining = sorted(chunks, key=lambda c: -len(c[2]))
    rounds = []
    while remaining:
        used_s, used_d = set(), set()
        rnd: Dict[int, Tuple[int, List[Token]]] = {}
        rest = []
        for s, d, toks in remaining:
            if s in used_s or d in used_d:
                rest.append((s, d, toks))
                continue
            used_s.add(s)
            used_d.add(d)
            rnd[s] = (d, toks)
        rounds.append(rnd)
        remaining = rest
    return rounds


def plan_split(
    pattern: ExchangePattern,
    message_cap_bytes: int,
    elem_bytes: int = 4,
) -> StagePlan:
    """Split node-aware communication (paper §2.3.3 / Algorithm 1)."""
    topo = pattern.topo
    pl = _LegacyPlanner(pattern)

    # per recv pod: per origin pod: owner-major deduped token list
    chunks: List[Tuple[int, int, List[Token]]] = []  # (sender, receiver, tokens)
    stage0_rows: Dict[int, List[List[Optional[Token]]]] = {
        r: [[] for _ in range(topo.ppn)] for r in range(topo.nranks)
    }
    for recv_pod in range(topo.npods):
        per_origin: Dict[int, List[Token]] = {}
        for origin in range(topo.npods):
            if origin == recv_pod:
                continue
            toks: List[Token] = []
            for l in range(topo.ppn):
                src = topo.rank_of(origin, l)
                toks.extend((src, e) for e in pattern.dedup_for_pod(src, recv_pod))
            if toks:
                per_origin[origin] = toks
        if not per_origin:
            continue
        vols = {o: len(t) * elem_bytes for o, t in per_origin.items()}
        total = sum(vols.values())
        biggest = max(vols.values())
        # Algorithm 1, lines 12-17
        if biggest < message_cap_bytes:
            cap = biggest  # conglomerate: one message per origin pod
        elif total / message_cap_bytes > topo.ppn:
            cap = -(-total // topo.ppn)  # ceil
        else:
            cap = message_cap_bytes
        cap_elems = max(cap // elem_bytes, 1)

        raw: List[Tuple[int, List[Token]]] = []  # (origin, chunk tokens)
        for origin in sorted(per_origin):
            toks = per_origin[origin]
            for i in range(0, len(toks), cap_elems):
                raw.append((origin, toks[i : i + cap_elems]))
        # line 18: receives descending from local 0; sends from local ppn-1
        raw.sort(key=lambda t: -len(t[1]))
        send_counter: Dict[int, int] = defaultdict(int)
        for i, (origin, toks) in enumerate(raw):
            receiver = topo.rank_of(recv_pod, i % topo.ppn)
            k = send_counter[origin]
            sender = topo.rank_of(origin, topo.ppn - 1 - (k % topo.ppn))
            send_counter[origin] += 1
            chunks.append((sender, receiver, toks))
            # stage 0 (local_Scomm): owners stage chunk bytes on the sender
            for tok in toks:
                owner = tok[0]
                if owner != sender:
                    stage0_rows[owner][topo.local_of(sender)].append(tok)

    B0 = max(
        (len(b) for blocks in stage0_rows.values() for b in blocks), default=0
    )
    B0 = max(B0, 1)

    def sel0(r: int) -> List[Optional[Token]]:
        out: List[Optional[Token]] = []
        for b in stage0_rows[r]:
            out.extend(b)
            out.extend([PAD] * (B0 - len(b)))
        return out

    pl.gather(sel0, width=B0 * topo.ppn)
    pl.a2a_local(elem_bytes)
    pl.permute_world(_greedy_rounds(chunks), elem_bytes)
    pl.redistribute_and_finish(elem_bytes, extra_local_direct=True)
    return pl.build("split")


PLANNERS: Dict[str, Callable[..., StagePlan]] = {
    "standard": plan_standard,
    "two_step": plan_two_step,
    "three_step": plan_three_step,
    "split": plan_split,
}


def plan(strategy: str, pattern: ExchangePattern, *, message_cap_bytes: int = 16384, elem_bytes: int = 4) -> StagePlan:
    if strategy == "split":
        return plan_split(pattern, message_cap_bytes, elem_bytes)
    try:
        return PLANNERS[strategy](pattern, elem_bytes)
    except KeyError as e:
        raise KeyError(f"unknown strategy {strategy!r}; known: {sorted(PLANNERS)}") from e
