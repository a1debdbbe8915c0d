"""Serve a small model with batched requests: prefill + greedy decode.

The port's counterpart of ``examples/serve_lm.py``: the same options and
lines, plus ``--device``.  The model is the architecture's ``tiny`` preset
with weights drawn from a ``torch.Generator`` seeded 0
(:func:`repro_torch.launch.serve.build`), and the prompts (and a ``vlm`` /
``enc_dec`` model's stub context) from ``np.random.default_rng(0)``, as the
reference draws them.  The loop is :func:`repro_torch.launch.serve.generate`:
the prefill runs the kernels (``impl="kernel"``: B3 in every attention, B4 in
every SSM mixer; the reference prefills with its plain ``chunked`` ops), the
cache is re-homed into buffers ``prompt_len + gen`` deep, and decode writes
it in place.  On the card a head width B3 does not take raises; nothing
falls back to the plain ops.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen3-32b --batch 4
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-780m --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device_option, counts_launches, run
from repro_torch.launch.serve import build, generate, make_context, report_dispatch
from repro_torch.models.lm import LMModel


def serve(cfg, params: dict, prompts: torch.Tensor, ctx: Optional[torch.Tensor], gen: int,
          advise_dispatch: bool = False, npods: int = 2, ppn: int = 4) -> dict:
    """The example's loop and report for the model ``cfg`` on ``params``
    (any weights: the tests carry the reference's over): prefill ``prompts
    [B, S]`` (with the stub context ``ctx``), ``gen`` greedy tokens, and with
    ``advise_dispatch`` the dispatch advice on the served tokens.  Returns
    :func:`generate`'s ``tokens`` and ``logits`` and, where asked,
    ``dispatch`` (``counts``, ``advice``)."""
    model = LMModel(cfg)
    B, S = prompts.shape
    out = generate(model, params, prompts, gen, impl="kernel", ctx=ctx)
    tput = B * (gen - 1) / out["decode_s"]
    tokens = out["tokens"].cpu().numpy()
    print(f"{cfg.name}: prefill {B}x{S} in {out['prefill_s']:.2f}s; "
          f"decode {gen} steps in {out['decode_s']:.2f}s ({tput:.1f} tok/s)")
    print("sample:", tokens[0][:16])
    if advise_dispatch:
        served = np.concatenate([prompts.cpu().numpy(), tokens], axis=1)
        out["dispatch"] = report_dispatch(params, cfg, served, npods, ppn)
    return out


@counts_launches
def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--advise-dispatch", action="store_true",
                    help="rank exchange strategies for the measured MoE "
                         "routing histogram (MoE archs only)")
    ap.add_argument("--npods", type=int, default=2)
    ap.add_argument("--ppn", type=int, default=4)
    add_device_option(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model, params = build(args.arch, "tiny", seed=0, device=device)
    cfg = model.cfg
    prompts, ctx = make_context(cfg.vocab_size, args.batch, args.prompt_len, model.ctx_len(),
                                cfg.d_model, seed=0)
    return serve(cfg, params, torch.as_tensor(prompts, device=device),
                 None if ctx is None else torch.as_tensor(ctx, device=device), args.gen,
                 args.advise_dispatch, args.npods, args.ppn)


if __name__ == "__main__":
    run(main)
