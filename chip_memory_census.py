#!/usr/bin/env python3
"""Device memory left behind by each phase of ``chip_smoke.py``, on one GPU.

    python3 chip_memory_census.py                        # every phase, in order
    python3 chip_memory_census.py build,serve_moe,serve_mla

Runs the named phases of ``chip_smoke.PHASES`` in their order (the serve
phases need nothing from ``setup``). After each one, before the collector
runs, it prints the bytes still allocated and the CUDA storages that live
Python tensors reach. If those storages pass 1 GiB, it also prints who
holds the largest of them. Then it runs ``gc.collect()`` and prints what
stays allocated. Memory that is allocated but reached by no live tensor,
and freed by the collector, belongs to objects kept only by a reference
cycle.
"""
from __future__ import annotations

import gc
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

GIB = 2**30


def describe(obj) -> str:
    if isinstance(obj, types.FrameType):
        return f"frame {obj.f_code.co_name}:{obj.f_lineno}"
    if isinstance(obj, types.FunctionType):
        return f"function {obj.__qualname__}"
    if isinstance(obj, dict):
        return f"dict keys={list(obj)[:6]}"
    if isinstance(obj, (list, tuple)):
        return f"{type(obj).__name__} len={len(obj)}"
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


def print_holders(obj, depth: int, seen: set, indent: int) -> None:
    """Up to four referrers of ``obj`` per level, ``depth`` levels up."""
    if depth == 0:
        return
    here = ("print_holders", "census")
    refs = [r for r in gc.get_referrers(obj)
            if not (isinstance(r, types.FrameType) and r.f_code.co_name in here)]
    for r in refs[:4]:
        if id(r) in seen:
            continue
        seen.add(id(r))
        print(" " * indent + describe(r), flush=True)
        print_holders(r, depth - 1, seen, indent + 2)


def census(tag: str) -> None:
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    reached, largest, ptrs = 0, None, set()
    for obj in gc.get_objects():
        if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
            continue
        storage = obj.untyped_storage()
        if storage.data_ptr() in ptrs:
            continue
        ptrs.add(storage.data_ptr())
        reached += storage.nbytes()
        if largest is None or storage.nbytes() > largest[0]:
            largest = (storage.nbytes(), obj)
    print(f"[census] {tag}: {allocated / GIB:.2f} GiB allocated, "
          f"{reached / GIB:.2f} GiB reached by live tensors", flush=True)
    if reached > GIB:
        nbytes, tensor = largest
        print(f"[census]   largest {tuple(tensor.shape)} {tensor.dtype} {nbytes / GIB:.2f} GiB, held by:", flush=True)
        print_holders(tensor, 5, {id(largest)}, 4)
        del tensor
    largest = None
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[census] {tag}: {torch.cuda.memory_allocated() / GIB:.2f} GiB allocated after gc.collect()",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_memory_census: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = dict(chip_smoke.PHASES)
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(phases)
    unknown = [n for n in names if n not in phases]
    if unknown:
        print(f"chip_memory_census: unknown phases {unknown}; known: {list(phases)}", file=sys.stderr)
        return 2
    ctx = {"details": {}}
    for name in names:
        phases[name](ctx)
        census("after " + name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
