"""PyTorch/CUDA port of the node-aware irregular exchange system.

Mirrors the JAX package ``repro`` subpackage by subpackage (``comm``,
``core``, ``kernels``, ``sparse``, ``solve``) without importing it.  All
ranks live as one stacked tensor on one device; entry points take
``device=`` and run on the CUDA device unless the caller asks for the CPU.
"""
