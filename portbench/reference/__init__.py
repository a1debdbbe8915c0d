"""The plain reference the benchmark judges the program by: CSR products and
textbook CG in plain PyTorch, on the benchmark's own CSR arrays.  It
imports nothing of the program and takes nothing the program made."""

from portbench.reference.csr import DeviceCSR, cg, csr_matmul

__all__ = ["DeviceCSR", "cg", "csr_matmul"]
