"""Kernel B1's share of its roofline (:func:`counts.kernel_share`): an SpMV
launches B1 twice, once on the on-rank block and once on the halo block,
each product one vector wide."""

from portbench.metrics import counts


def read(run):
    return counts.kernel_share(run, "spmv_ell_kernel", launches_per_product=2)
