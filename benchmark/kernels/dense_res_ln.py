"""K2 / K11 in bfloat16, the attention output epilogue LayerNorm(res +
drop(x W + b)) in one kernel, ``csrc/dense_res_ln.cu``.  FLOPs 2 * N * Din
* H; bytes x, W and the residual read, y written once.  One launch an
operation."""

DEVICE_KERNELS = r"dense_ln_kernel"
LAUNCHERS = r"smx_dense_(dropout_)?res_ln$"


def work(op, es):
    if op["kind"] != "dense_ln" or not op["fused"] or es != 2:
        return None
    n, din, dout = op["rows"], op["d_in"], op["d_out"]
    return 2.0 * n * din * dout, (n * din + din * dout + 2.0 * n * dout) \
        * es, 1
