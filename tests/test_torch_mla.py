"""The port's MLA layer (``repro_torch.models.mla``) against the JAX reference.

The same numpy weights and inputs go through ``repro.models.mla.MLAttention``
and its port at a small size (d_model 64, 4 heads, latent rank 32, rope 16,
nope 16, v 16: q/k heads 32 wide, v heads 16), in float32, within 1e-4:

* ``latent`` (the cache entry) and ``queries``;
* the prefill: the port's ``impl="kernel"`` (on the CPU the plain version
  of B3, at q/k width 32 and v width 16) against the reference's
  ``impl="chunked"``, because the reference's Pallas kernel sizes v by q's
  width and so has no MLA route;
* the absorbed ``decode`` over a prefilled latent cache.

And the port's own identity: absorbed decode over the latent cache of a
prompt equals the last row of the expanded attention over the prompt and the
new token.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as RefMLAConfig
from repro.models.mla import MLAttention as RefMLA
from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.mla import MLAttention
from repro_torch.models.sharding import tree_items

M, H, B, S = 64, 4, 2, 12
CFG = dict(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=16, v_head_dim=16)
TOL = 1e-4


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, name = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[name] = v
    return out


@pytest.fixture(scope="module")
def layers():
    """(reference layer, port layer, numpy weights) on one seed."""
    port = MLAttention(M, H, MLAConfig(**CFG), rope_theta=1e4)
    ref = RefMLA(M, H, RefMLAConfig(**CFG), rope_theta=1e4)
    rng = np.random.default_rng(0)
    flat = {}
    for key, spec in tree_items(port.params()):
        if spec.init == "ones":  # the latent norm's scale
            flat[key] = (1.0 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        else:
            flat[key] = (rng.standard_normal(spec.shape) * spec.std()).astype(np.float32)
    return ref, port, _nest(flat)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _both(params):
    """The numpy weights as (jax arrays, torch tensors)."""
    return _map(jnp.asarray, params), _map(torch.as_tensor, params)


def _inputs(seed=1, n=S):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, M)).astype(np.float32), np.arange(n)[None, :]


def test_latent_and_queries_match_reference(layers):
    ref, port, params = layers
    jp, tp = _both(params)
    x, pos = _inputs()
    want = ref.latent(jp, jnp.asarray(x), jnp.asarray(pos))
    got = port.latent(tp, torch.as_tensor(x), torch.as_tensor(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    want = ref.queries(jp, jnp.asarray(x), jnp.asarray(pos))
    got = port.queries(tp, torch.as_tensor(x), torch.as_tensor(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_prefill_kernel_route_matches_reference_chunked(layers):
    ref, port, params = layers
    jp, tp = _both(params)
    x, pos = _inputs()
    want = np.asarray(ref(jp, jnp.asarray(x), jnp.asarray(pos), impl="chunked"))
    n0 = FA.flash_attention.launches
    got = port(tp, torch.as_tensor(x), torch.as_tensor(pos), impl="kernel")
    assert FA.flash_attention.launches == n0  # the CPU route launches nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the expanded K/V the kernel route sees: q/k 32 wide, v 16
    c_kv, k_rope = port.latent(tp, torch.as_tensor(x), torch.as_tensor(pos))
    k, v = port.expand(tp, c_kv, k_rope)
    assert k.shape == (B, S, H, 32) and v.shape == (B, S, H, 16)
    for impl in ("dot", "chunked"):
        np.testing.assert_allclose(port(tp, torch.as_tensor(x), torch.as_tensor(pos), impl=impl).numpy(),
                                   want, rtol=TOL, atol=TOL)


def _prefilled_cache(port, tp, x, pos, max_len):
    c_kv, k_rope = port.latent(tp, torch.as_tensor(x), torch.as_tensor(pos))
    cache = port.init_cache(B, max_len, torch.float32, "cpu")
    cache["c_kv"][:, : x.shape[1]] = c_kv
    cache["k_rope"][:, : x.shape[1]] = k_rope
    return cache


def test_absorbed_decode_matches_reference(layers):
    ref, port, params = layers
    jp, tp = _both(params)
    x, pos = _inputs()
    cache = _prefilled_cache(port, tp, x, pos, S + 4)
    xn = np.random.default_rng(2).standard_normal((B, 1, M)).astype(np.float32)
    npos = np.full((B, 1), S)
    want, want_upd = ref.decode(jp, jnp.asarray(xn), jnp.asarray(npos),
                                {k: jnp.asarray(v.numpy()) for k, v in cache.items()}, jnp.int32(S))
    got, upd = port.decode(tp, torch.as_tensor(xn), torch.as_tensor(npos), cache, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert sorted(upd) == sorted(want_upd) == ["c_kv_new", "k_rope_new"]
    for name in upd:
        np.testing.assert_allclose(upd[name].numpy(), np.asarray(want_upd[name]), rtol=TOL, atol=TOL)


def test_absorbed_decode_equals_expanded_attention_last_row(layers):
    """The port's own identity: attention over the latent cache of a prompt
    plus the new token (absorbed) equals the expanded attention's last row."""
    _, port, params = layers
    tp = _both(params)[1]
    x, pos = _inputs(seed=3, n=S + 1)
    full = port(tp, torch.as_tensor(x), torch.as_tensor(pos), impl="kernel")
    cache = _prefilled_cache(port, tp, x[:, :S], pos[:, :S], S + 1)
    got, _ = port.decode(tp, torch.as_tensor(x[:, S:]), torch.as_tensor(pos[:, S:]).expand(B, 1), cache, S)
    torch.testing.assert_close(got[:, 0], full[:, S], rtol=TOL, atol=TOL)
