"""celebbasis_tpu_torch: the PyTorch/CUDA port of ``celebbasis_tpu``.

Same directory layout and public names as the JAX package, so the counterpart
of a module is found by its path.  Imports ``torch`` and never ``jax``,
``flax`` or ``celebbasis_tpu``.  Entry points run on ``cuda`` unless the
caller asks for ``device="cpu"``.
"""
__version__ = "0.1.0"
