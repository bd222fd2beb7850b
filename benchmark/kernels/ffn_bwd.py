"""K8, the FFN backward (the pre-activation recomputed, then dx, dW1, dW2),
``csrc/ffn_bwd.cu``.  FLOPs 10 * N * H * F; bytes x, W1, W2 and dy read,
dx written in the compute dtype, dW1 and dW2 in float32, once each.  Two
launches an operation: the recompute, then the products."""

DEVICE_KERNELS = r"(ffn_bwd_reduce|products(_f32)?|recompute(_f32)?)_kernel"
LAUNCHERS = r"smx_ffn_(dropout_)?bwd_"


def work(op, es):
    if op["kind"] != "ffn" or not op["fused"] or not op["backward"]:
        return None
    n, h, f = op["rows"], op["h"], op["f"]
    return 10.0 * n * h * f, (3.0 * n * h + 2.0 * h * f) * es \
        + 8.0 * h * f, 2
