"""K1 / K14, attention forward with the key mask (and the probability
mask), ``csrc/attention_fwd.cu``: the fused self-attention of the speech
layers, the text encoder and the teacher-forced decoder.  FLOPs 4 * pairs
* width (scores and values); bytes q, k, v read and the output written
once.  One launch an operation."""

DEVICE_KERNELS = r"attention_fwd_\w*kernel"
LAUNCHERS = r"smx_attention(_dropout)?_fwd"


def work(op, es):
    if op["kind"] != "attention" or not op["fused"]:
        return None
    return 4.0 * op["pairs"] * op["width"], 4.0 * op["rows"] * op["tq"] \
        * op["width"] * es, 1
