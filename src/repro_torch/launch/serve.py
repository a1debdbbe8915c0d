"""Batched serving: prefill a prompt batch, then decode greedily.

The port's counterpart of ``python -m repro.launch.serve``, with the kernels
switched on:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --preset full \\
        --batch 4 --prompt-len 4096 --gen 32            # one CUDA GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --preset tiny \\
        --device cpu                                    # the plain versions, on the host

1. build ``LMModel`` for the architecture at the preset's size;
2. draw the parameters on the device from a ``torch.Generator`` seeded by
   ``--seed``, in the config's dtype;
3. prefill the prompts (``--impl kernel``: the CUDA kernels B3 and B4 in every
   layer; ``chunked`` / ``dot``: plain torch ops);
4. re-home the prefill cache into buffers ``prompt_len + gen`` deep;
5. decode ``--gen`` tokens greedily with plain torch ops.

Without ``--device`` it runs on the CUDA device and raises where there is
none.  The MoE routing advice waits for ROADMAP A.4, and so do
``--simulate-serving`` and ``--chaos``: the reference drives the serving
simulator from the MoE routing counts of ``--advise-dispatch``.  The
simulator itself is ported (``repro_torch.serving``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import HEAD_DIMS, head_dim_supported
from repro_torch.launch.presets import PRESETS
from repro_torch.models.lm import LMModel
from repro_torch.models.sharding import tree_items


def build(arch: str, preset: str = "tiny", seed: int = 0, device: DeviceLike = None,
          dtype: Optional[torch.dtype] = None):
    """``(model, params)``: the model at ``preset`` with parameters drawn on
    ``device`` from a generator seeded by ``seed``.

    ``dtype`` (default: the config's) sets the model's activation dtype and
    its weights' together; one seed draws the same weights in every dtype.
    """
    device = resolve_device(device)
    cfg = PRESETS[preset](get_config(arch))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=str(dtype).removeprefix("torch."))
    model = LMModel(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, model.init(gen, device=device)


def make_prompts(vocab_size: int, batch: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """``[batch, prompt_len]`` token ids from ``np.random.default_rng(seed)``,
    as the reference's launcher draws them."""
    return np.random.default_rng(seed).integers(0, vocab_size, (batch, prompt_len))


def rehome_cache(model: LMModel, cache: dict, batch: int, max_len: int) -> dict:
    """The prefill cache copied into zeroed buffers ``max_len`` deep (window
    rings and SSM states keep their shape)."""
    _, first = next(tree_items(cache))
    full = model.init_cache(batch, max_len, model.dtype, first.device)

    def blend(dst, src):
        dst[tuple(slice(0, s) for s in src.shape)] = src.to(dst.dtype)
        return dst

    return _zip_map(blend, full, cache)


def _zip_map(fn, a, b):
    return {k: _zip_map(fn, a[k], b[k]) if isinstance(a[k], dict) else fn(a[k], b[k]) for k in a}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_kernel_heads(model: LMModel) -> None:
    """Raise, naming the config, where the attention kernel B3 cannot take
    the model's head width on a CUDA device."""
    D = model.attention_head_dim
    if D is not None and not head_dim_supported(D):
        raise ValueError(
            f"{model.cfg.name}: head_dim {D} is not one the flash_attention kernel takes {HEAD_DIMS}"
        )


@torch.inference_mode()
def generate(model: LMModel, params: dict, prompts: torch.Tensor, gen: int, impl: str = "kernel") -> dict:
    """Prefill ``prompts [B, S]`` with ``impl``, then ``gen`` greedy tokens.

    Returns ``tokens [B, gen]``, ``logits`` (one float32 ``[B, vocab]`` per
    generated token: the prefill's last position, then each decode step's),
    and the host-clock seconds of the prefill (cache re-homing included) and
    of the decode loop.
    """
    device = prompts.device
    if impl == "kernel" and device.type == "cuda":
        check_kernel_heads(model)
    B, S = prompts.shape
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, impl=impl)
    cache = rehome_cache(model, cache, B, S + gen)
    _sync(device)
    t1 = time.perf_counter()
    step_logits = [logits[:, -1].float()]
    token = step_logits[0].argmax(dim=-1)[:, None]
    outs = [token]
    for t in range(gen - 1):
        logits, cache = model.decode_step(params, token, cache, S + t)
        step_logits.append(logits[:, 0].float())
        token = step_logits[-1].argmax(dim=-1)[:, None]
        outs.append(token)
    tokens = torch.cat(outs, dim=1)
    _sync(device)
    t2 = time.perf_counter()
    return {"tokens": tokens, "logits": step_logits, "prefill_s": t1 - t0, "decode_s": t2 - t1, "cache": cache}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b", choices=ARCH_IDS)
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", choices=("kernel", "chunked", "dot"), default="kernel")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--advise-dispatch", action="store_true", help="not ported yet (ROADMAP A.4)")
    ap.add_argument("--simulate-serving", type=int, default=0, metavar="N",
                    help="needs --advise-dispatch (MoE), not ported yet (ROADMAP A.4)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="needs --advise-dispatch (MoE), not ported yet (ROADMAP A.4)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.advise_dispatch:
        raise NotImplementedError("--advise-dispatch needs the MoE layers, not ported yet (ROADMAP A.4)")
    if args.simulate_serving:
        raise NotImplementedError(
            "--simulate-serving simulates the MoE routing of --advise-dispatch, not ported yet (ROADMAP A.4)")
    if args.chaos is not None:
        raise NotImplementedError(
            "--chaos storms the MoE serving simulation of --advise-dispatch, not ported yet (ROADMAP A.4)")
    model, params = build(args.arch, args.preset, args.seed, args.device)
    device = params["embed"].device
    prompts = make_prompts(model.cfg.vocab_size, args.batch, args.prompt_len, args.seed)
    out = generate(model, params, torch.as_tensor(prompts, device=device), args.gen, impl=args.impl)
    print(f"{model.cfg.name} ({args.preset}, {model.param_count():,} parameters) on {device}: "
          f"prefill {args.batch}x{args.prompt_len} in {out['prefill_s']:.3f}s; "
          f"decoded {args.gen} tokens/seq in {out['decode_s']:.3f}s")
    print("generated:", out["tokens"].cpu().numpy()[:, :10])
    return out


if __name__ == "__main__":
    main()
