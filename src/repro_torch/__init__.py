"""PyTorch/CUDA port of the Optimized Cuckoo Filter (``repro``).

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU, where the kernels' plain PyTorch versions run.
"""
