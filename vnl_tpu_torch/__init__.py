"""vnl_tpu_torch: the PyTorch + CUDA port of vnl_tpu.

The JAX package ``vnl_tpu`` stays the reference; this package imports
nothing of it.  Ported so far: the batched physics with its position
stage (kernel A, or unfused on kernel C, the SPD sweep inverse), the
narrowphase (kernel E), the constraint assembly (kernel D) and the CG
contact solve (kernel B) as hand-written Hopper kernels (``csrc/``; each
kernel's one entry is ``ops.KERNELS``, its wrapper ``ops/<name>.py``), the
``RodentTracking`` and ``RodentMultiClipTracking`` envs and the training
wrappers, the intention policy and value network, the intention-PPO
learner (``training.train``) with its evaluator, full-state checkpoints
and eval callback, the MJCF compiler (``mjcf``), clip IO and
preprocessing (``data``), the training command line
(``python -m vnl_tpu_torch.train``), the humanoid and ant envs, rendering
(``render``: the eval overlay video, skins, the batched egocentric
camera), the walker metadata (``envs.walker``), the profiler hooks
(``utils.profiler``) and data parallelism over torch.distributed
(``parallel``, ``train(num_devices=)``, one process per GPU).  Entry
points run on ``cuda`` unless the caller passes another device.
"""
