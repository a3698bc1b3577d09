"""kernels.attention_ms (ms): device time a call in the attention's float
work: the act x act matmuls (``Q·Kᵀ``, ``P·V``) on cuBLAS and the softmax
kernels (the classifier's softmax, a (batch, classes) pass, among them),
over the calls in the traced stretch.  A kernel counts when its name,
lower-cased, holds one of ``PATTERNS`` and is not the port's int8 GEMM
(``PORT_GEMM``, whose name holds ``gemm_``).  None where the optimized
graph runs no float ``matmul``."""

PATTERNS = ("xmma_gemm", "cutlass", "sgemm", "gemm_", "softmax")
PORT_GEMM = "int8_gemm_kernel"
MATMULS = ("matmul", "matmul_v2", "bmm")


def read(r):
    if r.trace is None or not r.trace["calls"]:
        return None
    n = sum(1 for op in r.graph.ops
            if op.op_type in MATMULS and not op.attrs.get("enable_int8"))
    if not n:
        return None
    found = [v for k, v in r.trace["kernels"].items()
             if PORT_GEMM not in k and any(p in k.lower() for p in PATTERNS)]
    if not found:
        raise RuntimeError(f"the graph runs {n} float matmuls and the trace holds no kernel "
                           f"matching {PATTERNS}")
    return 1e3 * sum(v[1] for v in found) / r.trace["calls"]
