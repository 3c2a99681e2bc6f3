"""vnl_tpu_torch: the PyTorch + CUDA port of vnl_tpu.

The JAX package ``vnl_tpu`` stays the reference; this package imports
nothing of it.  Ported so far: the batched physics with its position
stage (kernel A, or unfused on kernel C, the SPD sweep inverse) and the CG
contact solve (kernel B) as hand-written Hopper kernels (``csrc/``), the
``RodentTracking`` env and the training wrappers, the intention policy and
value network, and the intention-PPO learner (``training.train``) with its
evaluator.  Entry points run on ``cuda`` unless the caller passes another
device.
"""
