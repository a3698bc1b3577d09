"""step.mfu (%): the whole step's share of the card's peak in the traced
stretch: for each op of the optimized graph, its operations over the peak of
its precision (``costs.op_cost``), summed over a call, times the calls in the
stretch, over the stretch's wall time."""

from benchmark import costs


def read(r):
    if r.trace is None or not r.trace["calls"]:
        return None
    step = costs.step_costs(r.graph, r.peaks)
    return 100.0 * step["compute_s"] * r.trace["calls"] / r.trace["window_s"]
