"""One whole serving batch's share of the card's peak: the least time of
the profiled stretch's batches (the matrix once per batch, the batch's
vectors in and out; bound by bytes, so the peak is the HBM rate) over the
time the card was busy in the stretch.  The open loop leaves the card idle
between batches by design; ``idle_share`` reads that part."""

from portbench.metrics import counts


def read(run):
    widths = run.profile.extra.get("batch_widths") if run.profile is not None else None
    busy = run.profile.busy_s() if run.profile is not None else 0.0
    if not widths or busy <= 0:
        return None
    bound = sum(counts.bound_s(counts.spmv_bytes(run.counts, w), counts.spmv_flops(run.counts, w),
                               run.peaks) for w in widths)
    return 100.0 * bound / busy
