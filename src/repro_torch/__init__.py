"""PyTorch/CUDA port of the node-aware irregular exchange system.

Mirrors the JAX package ``repro`` subpackage by subpackage (``comm``,
``core``, ``kernels``, ``sparse``, ``solve``, ``configs``, ``models``,
``launch``) without importing it.  In the solve path all ranks live as one
stacked tensor on one device; the model path serves the ``dense``, ``ssm``
and ``hybrid`` families.  Entry points take ``device=`` and run on the CUDA
device unless the caller asks for the CPU.
"""
