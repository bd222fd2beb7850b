"""K3 / K9 / K12 / K13 (the FFN blocks, up and down passes and the
LayerNorm rows) in every dtype, and K2 / K11 (the attention output
epilogue) in float32, ``csrc/ffn_fwd.cu``.  FFN: FLOPs 4 * N * H * F;
bytes x, W1, W2 read and y written once.  Epilogue: FLOPs 2 * N * Din * H;
bytes x, W and the residual read, y written once.  Launches: an FFN block
its up and down passes and, ending in the residual LayerNorm, the row
pass; the forward that a fused post-LN block's backward runs again its up
and down passes; the f32 epilogue one."""

DEVICE_KERNELS = r"(ffn_pass|res_ln_rows)_kernel"
LAUNCHERS = r"smx_(ffn_(dropout_)?(up|down|down_res)|res_ln_rows|" \
    r"dense_(dropout_)?res_ln_f32)"


def work(op, es):
    if not op.get("fused"):
        return None
    if op["kind"] == "ffn":
        n, h, f = op["rows"], op["h"], op["f"]
        runs = 3 if op["res_ln"] and not op.get("recompute") else 2
        return 4.0 * n * h * f, (2.0 * n * h + 2.0 * h * f) * es, runs
    if op["kind"] == "dense_ln" and es == 4:
        n, din, dout = op["rows"], op["d_in"], op["d_out"]
        return 2.0 * n * din * dout, (n * din + din * dout + 2.0 * n * dout) \
            * es, 1
    return None
