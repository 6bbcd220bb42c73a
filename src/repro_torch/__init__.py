"""PyTorch / CUDA port of the serving and training stacks (NVIDIA H100).

The JAX package ``repro`` stays the reference; this package imports
neither it nor JAX.  ``repro_torch.X.Y`` is the counterpart of
``repro.X.Y`` with the same public names and tensor layouts; every Pallas
TPU kernel on the ported path is a CUDA kernel written for Hopper under
``repro_torch.kernels``.  Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``, which runs the kernels' plain
PyTorch versions.
"""
