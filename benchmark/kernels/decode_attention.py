"""K4, one cached decode step's attention over the keys it may attend,
``csrc/decode_attention.cu``.  FLOPs 4 * attended keys * width; bytes the
attended keys and values read, the queries read and the output written
once.  One launch an operation."""

DEVICE_KERNELS = r"decode_(attention|cluster)_kernel"
LAUNCHERS = r"smx_decode_attention"


def work(op, es):
    if op["kind"] != "decode_attention":
        return None
    return op["flops"], (2.0 * op["keys"] + 2.0 * op["rows"]) \
        * op["width"] * es, 1
