"""Offline rendering of eval rollouts and the batched egocentric camera
(PyTorch counterpart of vnl_tpu/render): a software ray-caster that casts
chunks of frames as tensor ops on the renderer's device, agent-vs-
reference ghost overlay videos, MuJoCo binary skins, and a camera that
renders every env of a batched ``Data`` at once."""

from vnl_tpu_torch.render.jit_camera import make_egocentric_camera
from vnl_tpu_torch.render.software import (SoftwareRenderer, render_egocentric,
                                           render_overlay_video,
                                           render_trajectory)
