"""The whole CG iteration's share of the card's peak: the least time of one
textbook float32 iteration (its product and each vector operand of its
dots and axpys read once and written once; bound by bytes, so the peak is
the HBM rate) over the window's wall ms per iteration."""

from portbench.metrics import counts


def read(run):
    it = run.window.get("iterations", 0)
    if not it:
        return None
    bound = counts.bound_s(counts.cg_iteration_bytes(run.counts), counts.cg_iteration_flops(run.counts),
                           run.peaks)
    return 100.0 * bound * it / run.window["elapsed_s"]
