"""PyTorch / CUDA port of cpecan_signal_tpu for NVIDIA Hopper (H100).

The JAX package ``cpecan_signal_tpu`` stays the reference.  This package
shares its jax-free host layers (``constants``, ``core/``, ``io/``,
``anchor/``, ``models/``) and re-implements every jax-importing module on
the threeState signal-alignment path on top of torch, with the three Pallas
wavefront kernels (``ops/pallas_fb.py``) rewritten as hand-written CUDA C++
kernels in ``csrc/fb_sm3.cu``.  Importing it never loads jax.
"""
