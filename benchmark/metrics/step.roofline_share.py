"""step.roofline_share (%): the step's roofline bound over its wall time in
the traced stretch: for each op, the larger of its operations over its
peak and its bytes over the memory rate (``costs.op_cost``), summed over a
call, times the calls in the stretch, over the stretch's wall time."""

from benchmark import costs


def read(r):
    if r.trace is None or not r.trace["calls"]:
        return None
    step = costs.step_costs(r.graph, r.peaks)
    return 100.0 * step["bound_s"] * r.trace["calls"] / r.trace["window_s"]
