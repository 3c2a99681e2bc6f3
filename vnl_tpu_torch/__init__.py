"""vnl_tpu_torch: the PyTorch + CUDA port of vnl_tpu.

The JAX package ``vnl_tpu`` stays the reference; this package imports
nothing of it.  Slice 1 covers the rodent-tracking rollout: batched
physics with the position stage (kernel A) and the CG contact solve
(kernel B) as hand-written Hopper kernels (``csrc/``), the
``RodentTracking`` env, the intention policy and ``generate_unroll``.
Entry points run on ``cuda`` unless the caller passes another device.
"""
