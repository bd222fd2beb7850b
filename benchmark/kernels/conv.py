"""K6, one stride-2 extractor layer, conv + bias (+ LayerNorm) + GELU,
``csrc/conv_ln_gelu.cu``.  FLOPs 2 * N_out * k * C_in * C_out; bytes x and
the kernel read, y written once.  One launch a layer."""

DEVICE_KERNELS = r"conv_kernel"
LAUNCHERS = r"smx_conv_ln_gelu"


def work(op, es):
    if op["kind"] != "conv" or not op["fused"]:
        return None
    rows, c_in, c_out = op["rows"], op["c_in"], op["c_out"]
    return op["flops"], (rows * op["t_in"] * c_in + c_in * c_out * op["k"]
                         + rows * op["t_out"] * c_out) * es, 1
