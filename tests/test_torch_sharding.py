"""The port's mesh rules (``repro_torch.models.sharding``) against the reference's.

For every leaf of ``param_specs()`` of the ten archs, at the tiny and full
presets, on the reference's two production meshes and the 2x4 host mesh,
the port's ``spec_for`` equals ``repro.models.sharding.spec_for`` exactly;
so do the activation specs the anchors use, the decode cache's specs by key
name (``cache_shardings``) and the token ids' (``batch_sharding``), with and
without ``REPRO_EMBED_SHARD=data``.  The reference side runs on
``jax.sharding.AbstractMesh``: the rules read only axis names and sizes, so
no device is needed on either side.
"""

import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.launch.train import tiny as ref_tiny
from repro.models import LMModel as RefModel
from repro.models import sharding as ref_sh
from repro.runtime.trainer import batch_sharding as ref_batch_sharding
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.presets import tiny
from repro_torch.models import sharding as sh
from repro_torch.models.lm import LMModel
from repro_torch.runtime.trainer import batch_sharding

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "host": ((2, 4), ("data", "model")),
}
PRESETS = {"tiny": (tiny, ref_tiny), "full": (lambda c: c, lambda c: c)}


def _meshes(name):
    shape, names = MESHES[name]
    return dict(zip(names, shape)), AbstractMesh(shape, names)


def _models(arch, preset, tp):
    port, ref = PRESETS[preset]
    return LMModel(port(get_config(arch)), tp=tp), RefModel(ref(ref_config(arch)), tp=tp)


@pytest.fixture(scope="module")
def ref_cache_shardings():
    """``repro.launch.dryrun.cache_shardings``; importing the module sets
    ``XLA_FLAGS`` for 512 devices, which must not outlive the import here."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import cache_shardings
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return cache_shardings


@pytest.fixture(params=["default", "embed_data"])
def embed_rule(request, monkeypatch):
    if request.param == "embed_data":
        monkeypatch.setenv("REPRO_EMBED_SHARD", "data")
    else:
        monkeypatch.delenv("REPRO_EMBED_SHARD", raising=False)
    return request.param


def test_default_rules_are_the_references():
    assert sh.DEFAULT_RULES == ref_sh.DEFAULT_RULES


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_for_mesh_match(mesh, embed_rule):
    sizes, ref_mesh = _meshes(mesh)
    rules = sh.rules_for_mesh(sizes)
    assert rules == ref_sh.rules_for_mesh(ref_mesh)
    assert (rules["embed"] == ("data",)) == (embed_rule == "embed_data")
    over = {"experts": ("pod", "data"), "vocab": None}
    assert sh.rules_for_mesh(sizes, over) == ref_sh.rules_for_mesh(ref_mesh, over)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, preset, mesh):
    sizes, ref_mesh = _meshes(mesh)
    model, ref = _models(arch, preset, sizes["model"])
    rules, ref_rules = sh.rules_for_mesh(sizes), ref_sh.rules_for_mesh(ref_mesh)
    ref_specs = dict(sh.tree_items(jax.tree.map(lambda ps: ps, ref.param_specs(),
                                                 is_leaf=lambda x: isinstance(x, ref_sh.ParamSpec))))
    specs = dict(sh.tree_items(model.param_specs()))
    assert sorted(specs) == sorted(ref_specs)
    place = dict(sh.tree_items(sh.param_shardings(model.param_specs(), sizes, rules)))
    for key, ps in specs.items():
        rp = ref_specs[key]
        assert (ps.shape, ps.logical) == (rp.shape, rp.logical), key
        spec = sh.spec_for(sizes, rules, ps.logical, ps.shape)
        assert spec == ref_sh.spec_for(ref_mesh, ref_rules, rp.logical, rp.shape), key
        assert place[key] == sh.placements(sizes, spec), key
        # each placement divides its dim by its mesh axis: the local shape
        local = list(ps.shape)
        for size, p in zip(sizes.values(), place[key]):
            if p.is_shard():
                local[p.dim] //= size
        assert tuple(local) == sh.local_shape(sizes, spec, ps.shape), key
        assert math.prod(local) * math.prod(sizes.values()) >= math.prod(ps.shape), key


def _activations(model, B, S):
    """(logical axes, shape) of every activation the sharded path anchors or splits."""
    cfg = model.cfg
    hp = model.segments[0].block.self_attn.attn.n_heads if model.segments[0].block.self_attn else cfg.n_heads
    D, M = cfg.resolved_head_dim, cfg.d_model
    out = [
        (("batch", "seq_sp", "embed"), (B, S, M)),
        (("batch", None, "embed"), (B, 1, M)),
        (("batch", None, "vocab"), (B, S, model.vocab)),
        (("batch", None, "heads", None), (B, S, hp, D)),
        (("batch", None, "kv_heads", None), (B, S, cfg.n_kv_heads, D)),
        (("batch", None, None), (B, max(model.ctx_len(), 1), M)),
    ]
    for ndim in (4, 5):  # the decode cache's new entries
        out.append((("layers", "batch") + (None,) * (ndim - 2), (cfg.n_layers, B) + (1,) * (ndim - 2)))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_and_batch_specs_match_the_reference(arch, mesh, embed_rule):
    sizes, ref_mesh = _meshes(mesh)
    model = LMModel(get_config(arch), tp=sizes["model"])
    rules, ref_rules = sh.rules_for_mesh(sizes), ref_sh.rules_for_mesh(ref_mesh)
    for shape in list(SHAPES.values()) + [None]:
        B, S = (shape.global_batch, shape.seq_len) if shape else (4, 32)
        for logical, dims in _activations(model, B, S):
            assert sh.spec_for(sizes, rules, logical, dims) == ref_sh.spec_for(ref_mesh, ref_rules, logical, dims), \
                (logical, dims)
        ref_spec = ref_batch_sharding(ref_mesh, ref_rules, B, S).spec
        assert sh.spec_for(sizes, rules, ("batch", "seq"), (B, S)) == ref_spec
        assert batch_sharding(sizes, rules, B, S) == sh.placements(sizes, ref_spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference(arch, mesh, ref_cache_shardings):
    sizes, ref_mesh = _meshes(mesh)
    model, ref = _models(arch, "full", sizes["model"])
    rules, ref_rules = sh.rules_for_mesh(sizes), ref_sh.rules_for_mesh(ref_mesh)
    B, S = 128, 4096
    ref_cache = jax.eval_shape(lambda: ref.init_cache(B, S, jnp.bfloat16))
    want = {k: v.spec for k, v in sh.tree_items(ref_cache_shardings(ref_cache, ref_mesh, ref_rules))}
    cache = model.init_cache(B, S, device="meta")
    got = dict(sh.tree_items(dryrun.cache_shardings(cache, sizes, rules)))
    assert sorted(got) == sorted(want)
    for key, t in sh.tree_items(cache):
        spec = sh.spec_for(sizes, rules, dryrun.cache_logical(key.rsplit(".", 1)[-1], t.ndim), t.shape)
        assert spec == want[key], key
        assert got[key] == sh.placements(sizes, spec), key


def test_spec_for_keeps_a_dividing_prefix_of_the_batch_axes():
    sizes = {"pod": 2, "data": 16, "model": 16}
    rules = sh.rules_for_mesh(sizes)
    assert sh.spec_for(sizes, rules, ("batch", None), (64, 8)) == (("pod", "data"), None)
    assert sh.spec_for(sizes, rules, ("batch", None), (2, 8)) == (("pod",), None)  # a tuple, as the reference's
    assert sh.spec_for(sizes, rules, ("batch", None), (1, 8)) == (None, None)
    assert sh.spec_for(sizes, rules, ("heads", "mlp"), (25, 32)) == (None, "model")
    assert sh.placements(sizes, sh.PartitionSpec(("pod", "data"), "model"))[2].is_shard(1)
    with pytest.raises(ValueError, match="order"):
        sh.placements(sizes, sh.PartitionSpec(("data", "pod"), None))


@pytest.mark.parametrize("mesh", [None, {"data": 1, "model": 1}])
def test_constrain_is_a_no_op_without_a_mesh_or_on_one_device(mesh):
    x = torch.randn(4, 8, 16)
    rules = sh.rules_for_mesh(mesh or {"data": 1, "model": 1})
    assert sh.constrain(x, mesh, rules, ("batch", "seq_sp", "embed")) is x
    params = {"w": x}
    assert sh.gather_fsdp(params, {"w": sh.ParamSpec((4, 8, 16), ("fsdp", None, None))}, mesh) is params
