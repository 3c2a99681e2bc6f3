"""CUDA-graph nodes of GAE in one SGD update: the ``gae`` part of the
SGD-update graph's capture report (vnl_tpu_torch.utils.graphs.REPORTS,
``parts``), read at the capture.  None where the program tags no such
part."""


def read(ctx):
    from vnl_tpu_torch.utils import graphs
    for report in reversed(graphs.REPORTS):
        if report.get("name") == "sgd_update":
            return (report.get("parts") or {}).get("gae")
    return None
