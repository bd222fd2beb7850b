"""K10, a dropout mask of {0, 1 / (1 - rate)} in float32,
``csrc/dropout_mask.cu``.  No FLOPs; bytes the mask written once.  One launch a mask."""

DEVICE_KERNELS = r"dropout_mask_kernel"
LAUNCHERS = r"smx_dropout_mask"


def work(op, es):
    if op["kind"] != "dropout_mask":
        return None
    return 0.0, 4.0 * op["rows"] * op["cols"], 1
