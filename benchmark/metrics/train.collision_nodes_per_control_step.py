"""CUDA-graph nodes of the collision stage in one control step: the
``collision`` part of the control-step graph's capture report
(vnl_tpu_torch.utils.graphs.REPORTS, ``parts``), read at the capture.
None where the program keeps no nodes by part."""


def read(ctx):
    from vnl_tpu_torch.utils import graphs
    for report in reversed(graphs.REPORTS):
        if report.get("name") == "control_step":
            parts = report.get("parts")
            return None if not parts else parts.get("collision")
    return None
