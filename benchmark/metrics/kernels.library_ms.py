"""kernels.library_ms (ms): device time a call in kernels the port did not
write (cuDNN, cuBLAS, ATen copies and elementwise kernels): every kernel in
the traced stretch whose name matches none of ``PORT``, over the calls in
it.  Copies and sets issued as such (``Memcpy``, ``Memset``) are not
kernels and are not counted."""

PORT = ("int8_gemm_kernel", "dw_conv_kernel", "dw_pw_fused_kernel", "nms_keep_kernel",
        "set_conditional_kernel")


def read(r):
    if r.trace is None or not r.trace["calls"]:
        return None
    s = sum(v[1] for k, v in r.trace["kernels"].items() if not any(p in k for p in PORT))
    return 1e3 * s / r.trace["calls"]
