"""Constraint rows of the system that kernel B solves in a substep (limits
and four facets a contact slot): ``solve_rows`` of the control-step
graph's capture report (vnl_tpu_torch.utils.graphs.REPORTS), read at the
capture.  None where the program notes no such count."""


def read(ctx):
    from vnl_tpu_torch.utils import graphs
    for report in reversed(graphs.REPORTS):
        if report.get("name") == "control_step":
            return report.get("solve_rows")
    return None
