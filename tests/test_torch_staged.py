"""The staged process group (``repro_torch.comm.staged``) against plain gloo.

The staged group copies every tensor of a collective into a host buffer,
runs gloo's collective there and copies the outputs back, so that DTensor
programs run on CUDA ranks of one card.  Here its worlds are 4 CPU processes
spawned by ``world.run_world`` (rendezvous through a ``file://`` store in a
temporary directory, with a timeout), the very code CUDA ranks run, held
bitwise to the same worlds over plain gloo:

* each collective a DTensor program issues (``world.PROBES``);
* hymba-1.5b tiny served with ``--mesh 2x2 --impl chunked`` (greedy tokens
  and the gathered prefill logits) and stablelm-3b tiny trained with
  ``--mesh 2x2`` (the loss history), each by the launcher over the staged
  group against a launcher rank's program over plain gloo;
* gloo's own error (an all-gather output of the wrong size on one rank)
  reaches the caller as ``WorldError``, raised through the staged group.
"""

import pytest

from repro_torch.comm import staged
from repro_torch.launch import serve, train, world

BACKENDS = ("gloo", staged.BACKEND)
MESH = ["--mesh", "2x2"]
SERVE = ["--arch", "hymba-1.5b", "--preset", "tiny", "--device", "cpu", "--impl", "chunked", *MESH]
TRAIN = ["--arch", "stablelm-3b", "--preset", "tiny", "--device", "cpu", "--steps", "4", *MESH]


@pytest.fixture(scope="module")
def probes():
    return {b: world.run_world(world.collectives, 4, device="cpu", backend=b, timeout_s=120.0) for b in BACKENDS}


@pytest.mark.parametrize("name", world.PROBES)
def test_staged_collective_gives_plain_gloo_values(probes, name):
    for plain, mine in zip(probes["gloo"], probes[staged.BACKEND]):
        assert mine[name]["backend"] == staged.BACKEND and plain[name]["backend"] == "gloo"
        assert mine[name]["ok"] and mine[name]["values"] == plain[name]["values"], (mine[name], plain[name])


def _plain_gloo_launcher(module: str, argv: list) -> list:
    """Every rank of the launcher's ``--mesh`` world as ``run_launcher``
    spawns it, but over plain gloo."""
    return world.run_world(world._launcher_rank, 4, device="cpu", backend="gloo", timeout_s=240.0,
                           args=(module, argv))


def test_serve_on_the_staged_group_is_plain_gloo_bitwise():
    got = serve.main(SERVE)["ranks"]
    want = _plain_gloo_launcher("repro_torch.launch.serve", SERVE)
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"], g["rank"]
        assert g["prefill_logits"] == w["prefill_logits"], g["rank"]
    assert all(g["tokens"] == got[0]["tokens"] for g in got)


def test_train_on_the_staged_group_is_plain_gloo_bitwise():
    got = train.main(TRAIN)["ranks"]
    want = _plain_gloo_launcher("repro_torch.launch.train", TRAIN)
    for g, w in zip(got, want):
        assert [h["step"] for h in g["history"]] == [1, 2, 3, 4]
        assert [h["loss"] for h in g["history"]] == [h["loss"] for h in w["history"]], g["rank"]


def test_gloo_error_propagates_through_the_staged_group():
    """Rank 1 hands the all-gather an output one element short: gloo raises
    there, inside the staged group, and the world ends with that rank's
    error (nothing retried, nothing swallowed)."""
    with pytest.raises(world.WorldError) as info:
        world.run_world(world.collective, 4, device="cpu", backend=staged.BACKEND, timeout_s=60.0,
                        args=("all_gather_c10d", 1))
    assert info.value.rank == 1
    assert "staged.py" in info.value.traceback and "RuntimeError" in info.value.traceback, info.value.traceback


def test_register_twice_does_nothing():
    staged.register()
    staged.register()
    import torch.distributed as dist

    assert dist.Backend.STAGED == staged.BACKEND
