"""Model-size presets: ``tiny`` (CPU tests), ``100m`` and ``full``.

Copies of the presets of ``repro.launch.train``: each keeps an
architecture's family and block structure and changes only its widths,
depth and vocabulary.  ``full`` is the published configuration as it is.
"""

from __future__ import annotations

import dataclasses


def tiny(cfg):
    kw = dict(
        n_layers=2, d_model=128, d_ff=256 if cfg.d_ff else 0, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=32, vocab_size=1024,
        dtype="float32", cross_context=16 if cfg.cross_context else 0,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2, d_ff_expert=64,
                                        first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.mla:
        kw["mla"] = dataclasses.replace(cfg.mla, kv_lora_rank=32, rope_head_dim=16,
                                        nope_head_dim=32, v_head_dim=32)
        kw["head_dim"] = 48
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk=16)
    if cfg.encoder:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2, context=16)
    if cfg.window:
        kw["window"] = 32
    return dataclasses.replace(cfg, **kw)


def small_100m(cfg):
    """~100M-parameter config."""
    kw = dict(n_layers=8, d_model=512, d_ff=1536 if cfg.d_ff else 0, n_heads=8,
              n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=64, vocab_size=32768,
              dtype="float32")
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=64, head_dim=32, chunk=64)
    return dataclasses.replace(cfg, **kw)


PRESETS = {"tiny": tiny, "100m": small_100m, "full": lambda c: c}
