"""Set-up seconds: from the start of the process (imports, CUDA's start,
the kernels' build or load, the inputs, the partition, the warm-up and any
capture) to the start of the window, on the host's clock."""


def read(run):
    return run.setup_s
