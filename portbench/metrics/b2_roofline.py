"""Kernel B2's share of its roofline (:func:`counts.kernel_share`): a batch
launches B2 twice, once on the on-rank block and once on the halo block,
each product as wide as the batch."""

from portbench.metrics import counts


def read(run):
    widths = run.profile.extra.get("batch_widths") if run.profile is not None else None
    return counts.kernel_share(run, "spmm_ell_kernel", launches_per_product=2, widths=widths)
