"""K7 / K15, attention backward (the delta pass, then dk / dv and dq),
``csrc/attention_bwd.cu``.  FLOPs 10 * pairs * width (the scores
recomputed, then dv, dp, dq, dk); bytes q, k, v, o and dO read, dq, dk, dv
written once.  One launch (``smx_attention_bwd`` or its dropout twin)
runs the three passes."""

DEVICE_KERNELS = r"(attention_bwd_\w*|dkdv|dq)_kernel"
LAUNCHERS = r"smx_attention(_dropout)?_bwd"


def work(op, es):
    if op["kind"] != "attention" or not op["fused"] or not op["backward"]:
        return None
    return 10.0 * op["pairs"] * op["width"], 8.0 * op["rows"] * op["tq"] \
        * op["width"] * es, 1
