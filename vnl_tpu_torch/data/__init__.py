"""Mocap data layer of the port (PyTorch counterpart of vnl_tpu/data):
reference clips and the clip library, clip IO, preprocessing on the port's
batched kinematics, and the multi-clip recording pipeline."""

from vnl_tpu_torch.data.reference_clip import ClipLibrary, ReferenceClip
from vnl_tpu_torch.data.io import load_clip, load_stac_qpos
from vnl_tpu_torch.data.preprocess import (
    compute_velocity_from_kinematics,
    extract_features,
    make_static_clip,
    process_clip,
)
from vnl_tpu_torch.data.pipeline import (
    ClipCollection,
    load_features_h5,
    process_recording,
    save_clip_pickle,
    save_features_h5,
)
