"""kernels.dw_roofline (%): the int8 depthwise kernel's bound over its
device time in the traced stretch, counted as ``kernels.gemm_roofline`` is,
from the depthwise convs the optimized graph tags ``"cuda"``
(``costs.dw_cost``) and the launches matching ``PATTERN``."""

from benchmark import costs

PATTERN = "dw_conv_kernel"
OPS = ("depthwise_conv2d",)


def read(r):
    if r.trace is None:
        return None
    ops = costs.routed(r.graph, OPS)
    if not ops:
        return None
    found = [v for k, v in r.trace["kernels"].items() if PATTERN in k]
    launches, seconds = sum(v[0] for v in found), sum(v[1] for v in found)
    if not launches:
        raise RuntimeError(f"the graph routes {len(ops)} ops to the depthwise kernel and "
                           f"the trace holds no kernel matching {PATTERN!r}")
    bound = sum(costs.dw_cost(r.graph, op, r.peaks) for op in ops) / len(ops)
    return 100.0 * bound * launches / seconds
