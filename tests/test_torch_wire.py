"""The port's wire codecs, int8 quantizer and hierarchical collectives
against the JAX package's.

* ``IrregularExchange(device="cpu", wire=c)`` -- barrier and split-phase,
  fused and unfused, every strategy and codec, scalar and batched payloads
  -- delivers bitwise what the port's ``execute_numpy(wire=c)`` and the
  reference's ``repro.comm.execute_numpy(wire=c)`` deliver (split-phase:
  the ``merge_split_phase`` of the two numpy phases, since a lossy codec's
  int8 blocks are the inter-pod sub-exchange's own).
* The numpy oracle's bfloat16 cast (:func:`round_to_bf16`) is bitwise
  ``ml_dtypes``' and torch's.
* ``int8_quantize`` / ``int8_dequantize`` / ``finite_amax`` /
  ``int8_scale`` are bitwise ``repro.comm.compression``'s on float32.
* The :class:`Compressor` and ``dot_hierarchical`` hold
  ``tests/test_compression.py``'s and ``tests/test_system.py``'s
  tolerances; the hierarchical collectives equal their flat forms.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.comm import compression as ref_compression
from repro.comm import exchange as ref_exchange
from repro.comm import wire as ref_wire
from repro.comm.fusion import fuse as ref_fuse
from repro.comm.topology import PodTopology as RefTopology
from repro_torch.comm import (
    STRATEGY_NAMES,
    WIRE_CODECS,
    Compressor,
    IrregularExchange,
    PodTopology,
    all_gather_hierarchical,
    all_to_all_hierarchical,
    dot_hierarchical,
    execute_numpy,
    finite_amax,
    init_residuals,
    int8_dequantize,
    int8_quantize,
    int8_scale,
    merge_split_phase,
    psum_flat,
    psum_hierarchical,
    random_pattern,
    split_phase,
    sync_grad_tree,
)
from repro_torch.comm import wire
from repro_torch.solve import TorchReductions, cg, spd_system
from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like

TOPO = PodTopology(npods=3, ppn=2)
REF_TOPO = RefTopology(npods=3, ppn=2)
L = 7


def _patterns(seed=0):
    port = random_pattern(np.random.default_rng(seed), TOPO, local_size=L, p_connect=0.7, max_elems=5)
    ref = ref_exchange.random_pattern(
        np.random.default_rng(seed), REF_TOPO, local_size=L, p_connect=0.7, max_elems=5
    )
    return port, ref


def _payload(shape, seed=0):
    """Values spread over many binades, with inf/nan and a value beyond
    float16's range, so every codec rounds, saturates and flags."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[3], flat[11], flat[17] = np.inf, np.nan, 7e4
    return x


@pytest.mark.parametrize("wire_codec", WIRE_CODECS)
@pytest.mark.parametrize("mode", ["barrier", "split"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
def test_exchange_codec_matches_execute_numpy(strategy, fused, mode, wire_codec):
    port, ref = _patterns(0)
    for feat in ((), (3,)):
        local = _payload((TOPO.nranks, L) + feat, seed=len(feat))
        ex = IrregularExchange(port, strategy, device="cpu", wire=wire_codec, fuse_program=fused,
                               message_cap_bytes=48)
        if mode == "barrier":
            got = ex(local).numpy()
            want = execute_numpy(ex.plan, local, wire_codec)
            ref_plan = ref_exchange.plan(strategy, ref, message_cap_bytes=48)
            if fused:
                ref_plan = ref_fuse(ref_plan)
            ref_want = ref_exchange.execute_numpy(ref_plan, local, wire_codec)
        else:
            got = ex.start(local).finish().numpy()
            sp = split_phase(port)
            remote = IrregularExchange(sp.remote, strategy, device="cpu", fuse_program=fused,
                                       message_cap_bytes=48).plan
            local_plan = IrregularExchange(sp.local, "local", device="cpu", fuse_program=fused).plan
            want = merge_split_phase(
                sp, execute_numpy(local_plan, local), execute_numpy(remote, local, wire_codec)
            )
            rsp = ref_exchange.split_phase(ref)
            ref_remote = ref_exchange.plan(strategy, rsp.remote, message_cap_bytes=48)
            ref_local = ref_exchange.plan_local(rsp.local)
            if fused:
                ref_remote, ref_local = ref_fuse(ref_remote), ref_fuse(ref_local)
            ref_want = ref_exchange.merge_split_phase(
                rsp,
                ref_exchange.execute_numpy(ref_local, local),
                ref_exchange.execute_numpy(ref_remote, local, wire_codec),
            )
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref_want)
        if wire_codec != "none" and mode == "barrier" and strategy != "standard":
            # the codec really ran: something crossed pods and was rounded
            assert not np.array_equal(got, execute_numpy(ex.plan, local))


@pytest.mark.parametrize("wire_codec", WIRE_CODECS)
def test_wire_bytes_match_reference(wire_codec):
    port, ref = _patterns(2)
    for strategy in STRATEGY_NAMES:
        ex = IrregularExchange(port, strategy, device="cpu", wire=wire_codec)
        ref_plan = ref_exchange.plan(strategy, ref)
        assert ex.wire_bytes == ref_wire.scaled_wire_bytes(ref_fuse(ref_plan), wire_codec)


def test_round_to_bf16_is_ml_dtypes_and_torch():
    x = _payload((4096,), seed=5)
    x = np.concatenate([x, np.float32([-np.inf, 3.3e38, -3.39e38, 1e-40, -0.0, 65519.0, 1.0, 2.0])])
    got = wire.round_to_bf16(x)
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    t = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, t)
    for codec in ("bf16", "f16", "int8"):
        np.testing.assert_array_equal(
            wire.roundtrip_np(x.reshape(-1, 8), codec, 1), ref_wire.roundtrip_np(x.reshape(-1, 8), codec, 1)
        )


# ---------------------------------------------------------------------------
# The int8 quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nonfinite_code", [None, wire.INT8_NONFINITE])
def test_int8_quantizer_bitwise_reference(nonfinite_code):
    import jax.numpy as jnp

    x = _payload((6, 40), seed=7)
    xt = torch.from_numpy(x)
    amax = finite_amax(xt, dim=1)
    ref_amax = ref_compression.finite_amax(jnp.asarray(x), axis=1)
    np.testing.assert_array_equal(amax.numpy(), np.asarray(ref_amax))
    scale = int8_scale(amax, wire.QMAX)
    ref_scale = ref_compression.int8_scale(ref_amax, wire.QMAX)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
    q = int8_quantize(xt, scale[:, None], wire.QMAX, nonfinite_code=nonfinite_code)
    ref_q = ref_compression.int8_quantize(
        jnp.asarray(x), ref_scale[:, None], wire.QMAX, nonfinite_code=nonfinite_code
    )
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    deq = int8_dequantize(q, scale[:, None], nonfinite_code=nonfinite_code)
    ref_deq = ref_compression.int8_dequantize(ref_q, ref_scale[:, None], nonfinite_code=nonfinite_code)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(ref_deq))
    # and the wire's numpy round-trip is this quantizer
    if nonfinite_code is not None:
        np.testing.assert_array_equal(deq.numpy(), wire.roundtrip_np(x, "int8", 1))


def _round_trip(x: torch.Tensor):
    """compress -> (one pod's sum) -> decompress, plus the residual."""
    comp = Compressor()
    q, scale = comp.compress(x[None])
    out = comp.decompress(q.to(torch.int32).sum(dim=0), scale)
    residual = x - comp.decompress(q[0].to(torch.int32), scale)
    return out, residual


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_compressor_round_trip_keeps_dtype(dtype):
    x = torch.linspace(-1.0, 1.0, 32, dtype=dtype)
    out, res = _round_trip(x)
    assert out.dtype == dtype and res.dtype == dtype
    z, zres = _round_trip(torch.zeros(16, dtype=dtype))
    assert torch.isfinite(z).all() and torch.isfinite(zres).all()


def test_compressor_reconstructs_and_never_poisons_neighbours():
    x = torch.linspace(-3.0, 3.0, 64)
    out, res = _round_trip(x)
    # |error| <= scale / 2 per element (tests/test_compression.py: atol 3/127)
    torch.testing.assert_close(out, x, rtol=0, atol=3.0 / 127)
    torch.testing.assert_close(out + res, x, rtol=1e-6, atol=1e-6)
    y = x.clone()
    y[5], y[9] = float("inf"), float("nan")
    out, res = _round_trip(y)
    finite = torch.isfinite(y)
    torch.testing.assert_close(out[finite], y[finite], rtol=0, atol=3.0 / 127)
    assert not torch.isfinite(res[~finite]).any()


def test_compressor_matches_reference_round_trip():
    """The same one-pod round trip as ``tests/test_compression.py`` through
    the reference's shard_map Compressor: bitwise in float32."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map

    x = np.linspace(-3.0, 3.0, 64, dtype=np.float32) ** 3
    comp = ref_compression.Compressor()

    def body(v):
        q, scale = comp.compress(v[0], "pod")
        return comp.decompress(jax.lax.psum(q.astype(jnp.int32), "pod"), scale)[None]

    mesh = jax.make_mesh((1,), ("pod",))
    ref_out = jax.jit(shard_map(body, mesh=mesh, in_specs=P("pod"), out_specs=P("pod")))(x[None])
    out, _ = _round_trip(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out)[0])


# ---------------------------------------------------------------------------
# Hierarchical collectives and reductions
# ---------------------------------------------------------------------------

HTOPO = PodTopology(npods=2, ppn=4)


def test_dot_hierarchical_with_and_without_compressor():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(HTOPO.nranks, 50)).astype(np.float32)
    y = rng.normal(size=(HTOPO.nranks, 50)).astype(np.float32)
    exact = float(x.astype(np.float64).reshape(-1) @ y.astype(np.float64).reshape(-1))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    plain = float(dot_hierarchical(xt, yt, HTOPO))
    # float32 partials summed in another order than a float64 dot
    assert plain == pytest.approx(exact, rel=1e-5, abs=1e-4)
    comp = float(dot_hierarchical(xt, yt, HTOPO, Compressor()))
    pods = (x.astype(np.float64) * y).reshape(HTOPO.npods, -1).sum(axis=1)
    # one int8 quantum of the largest pod partial per pod, at most
    bound = HTOPO.npods * np.abs(pods).max() / 127 / 2 * 1.01
    assert abs(comp - exact) <= bound
    # the solver's backend: the float64 tree, compressed or not
    assert TorchReductions(HTOPO).dot(xt, yt) == pytest.approx(exact, rel=1e-12)
    c64 = TorchReductions(HTOPO, compressor=Compressor()).dot(xt, yt)
    assert abs(c64 - exact) <= bound and c64 != TorchReductions(HTOPO).dot(xt, yt)


def test_compressed_reductions_still_converge():
    """``tests/test_solver.py``'s compressed-reduction CG: converges, just
    less tightly (1e-4)."""
    rng = np.random.default_rng(0)
    A = spd_system(thermal_like(64, rng))
    part = partition_csr(A, HTOPO)
    b = rng.normal(size=(HTOPO.nranks, part.rows_per_rank)).astype(np.float32)
    op = DistributedSpMV(part, strategy="two_step", device="cpu")
    res = cg(op, b, tol=1e-4, maxiter=200, reductions=TorchReductions(HTOPO, compressor=Compressor()))
    assert res.converged, res.final_residual


def test_psum_and_all_to_all_hierarchical_equal_flat():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(HTOPO.nranks, 5, 3)).astype(np.float32))
    a = psum_hierarchical(x, HTOPO)
    b = psum_flat(x, HTOPO)
    assert a.shape == (HTOPO.npods, HTOPO.ppn, 5, 3)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)  # tests/test_system.py
    torch.testing.assert_close(a[1, 2], x.sum(dim=0), rtol=1e-6, atol=1e-6)
    n = HTOPO.nranks
    v = torch.arange(n * n * 2, dtype=torch.float32).reshape(n, n * 2, 1)
    flat = v.reshape(n, n, 2, 1).transpose(0, 1).reshape(n, n * 2, 1)
    got = all_to_all_hierarchical(v, HTOPO).reshape(n, n * 2, 1)
    assert torch.equal(got, flat)
    g = all_gather_hierarchical(v[:, :2], HTOPO)
    want = v[:, :2].reshape(HTOPO.npods, HTOPO.ppn, 2, 1).transpose(0, 1).reshape(-1, 1)
    assert torch.equal(g[0, 0], want) and torch.equal(g[1, 3], want)


def test_compressed_psum_and_gradient_tree():
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(HTOPO.nranks, 16)).astype(np.float32))
    res0 = init_residuals({"w": xs.reshape(HTOPO.npods, HTOPO.ppn, 16)}, HTOPO)["w"]
    assert res0.shape == (HTOPO.npods, HTOPO.ppn, 4) and not res0.any()
    out, res = psum_hierarchical(xs, HTOPO, Compressor(), res0)
    true = xs.sum(dim=0)
    rel = float((out[0, 0] - true).abs().max() / true.abs().max())
    assert rel < 0.02, rel  # tests/test_system.py
    assert torch.isfinite(res).all()
    grads = {"a": xs.reshape(HTOPO.npods, HTOPO.ppn, 16), "b": [xs[:, :3].reshape(2, 4, 3)]}
    flat = sync_grad_tree(grads, HTOPO, mode="flat")
    hier = sync_grad_tree(grads, HTOPO)
    torch.testing.assert_close(hier["a"], flat["a"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hier["b"][0], flat["b"][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(flat["a"][0, 0], true / HTOPO.nranks)
    comp, new_res = sync_grad_tree(grads, HTOPO, compressor=Compressor(),
                                   residuals=init_residuals(grads, HTOPO))
    assert set(new_res) == {"a", "b"} and new_res["b"][0].shape == (2, 4, 1)
    assert float((comp["a"][0, 0] - true / HTOPO.nranks).abs().max()) < 0.02 * float(true.abs().max())
    with pytest.raises(ValueError, match="mode"):
        sync_grad_tree(grads, HTOPO, mode="ring")
