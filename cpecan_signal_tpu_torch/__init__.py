"""PyTorch / CUDA port of cpecan_signal_tpu for NVIDIA Hopper (H100).

The JAX package ``cpecan_signal_tpu`` stays the reference; this package
imports nothing of it.  The jax-free host layers it needs (``constants``,
``core/``, ``io/``, ``anchor/``, ``models/``, ``em/accumulators.py``,
``utils/checkpoint.py``) are its own copies at the same relative paths, and
every jax-importing module on its paths is re-implemented on torch: threeState
signal alignment and threeState EM training, with the Pallas wavefront
kernels (``ops/pallas_fb.py``) rewritten as hand-written CUDA C++ kernels in
``csrc/fb_sm3.cu``.  Importing it never loads jax.
"""
