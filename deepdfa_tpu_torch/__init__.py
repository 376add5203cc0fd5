"""deepdfa_tpu_torch: the PyTorch/CUDA port of deepdfa_tpu.

The JAX package (``deepdfa_tpu``) stays the reference; this package keeps
its module layout and names so each counterpart is easy to find, but it
imports only torch and numpy — never jax, flax or anything of
``deepdfa_tpu``. Entry points run on ``cuda`` unless the caller asks for
``device="cpu"``; the hand-written Hopper kernels live in ``csrc/`` and
are built at first use (``ops/_build.py``).
"""
