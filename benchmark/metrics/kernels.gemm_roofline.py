"""kernels.gemm_roofline (%): the int8 GEMM's bound over its device time in
the traced stretch.  The ops the optimized graph routes to the GEMM (an fc,
mul or conv tagged ``"cuda"``) give each launch's bound from its (M, K, N)
(``costs.gemm_cost``); the launches found in the trace by ``PATTERN`` times
the mean bound a launch, over those launches' device time."""

from benchmark import costs

PATTERN = "int8_gemm_kernel"
OPS = ("conv2d", "fc", "mul")


def read(r):
    if r.trace is None:
        return None
    ops = costs.routed(r.graph, OPS)
    if not ops:
        return None
    found = [v for k, v in r.trace["kernels"].items() if PATTERN in k]
    launches, seconds = sum(v[0] for v in found), sum(v[1] for v in found)
    if not launches:
        raise RuntimeError(f"the graph routes {len(ops)} ops to the GEMM and the trace "
                           f"holds no kernel matching {PATTERN!r}")
    bound = sum(costs.gemm_cost(r.graph, op, r.peaks) for op in ops) / len(ops)
    return 100.0 * bound * launches / seconds
