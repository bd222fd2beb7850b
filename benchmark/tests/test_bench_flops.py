"""The counts of ``benchmark/flops.py`` and of the kernel families against
hand counts for one layer of each kind."""

import pytest

from benchmark import core, flops

W2V = {"conv_dims": [512] * 3, "conv_kernels": [10, 3, 2],
       "conv_strides": [5, 2, 2], "hidden_size": 768, "num_layers": 1,
       "num_heads": 12, "ffn_dim": 3072, "pos_conv_kernel": 128,
       "pos_conv_groups": 16, "do_stable_layer_norm": False,
       "extractor_impl": "fused"}
BART = {"hidden_size": 768, "ffn_dim": 3072, "num_heads": 12,
        "encoder_layers": 1, "decoder_layers": 1, "vocab_size": 1000}


def _cfg(**enc):
    return {"encoder": {**W2V, **enc}, "decoder": BART, "down_scale": 2}


def _sum(ops, kind, **match):
    return sum(o["flops"] for o in ops if o["kind"] == kind and all(
        o.get(k) == v for k, v in match.items()))


def test_speech_encoder_by_hand():
    b, padded = 2, 2000
    samples = [1500, 2000]
    ops, t, frames = flops.speech_encoder(_cfg(), b, padded, samples)
    t0 = (2000 - 10) // 5 + 1                 # 399
    t1 = (t0 - 3) // 2 + 1                    # 199
    t2 = (t1 - 2) // 2 + 1                    # 99
    assert [o["t_out"] for o in ops if o["kind"] == "conv"][:3] == \
        [t0, t1, t2]
    assert _sum(ops, "conv", fused=True) == 2 * b * t1 * 3 * 512 * 512 + \
        2 * b * t2 * 2 * 512 * 512
    # layer 0 (C_in 1) and the library convs are not the fused kernel's
    assert [o["fused"] for o in ops if o["kind"] == "conv"] == \
        [False, True, True, False, False]
    f0 = [(n - 10) // 5 + 1 for n in samples]
    f2 = [((x - 3) // 2 + 1 - 2) // 2 + 1 for x in f0]
    att = [o for o in ops if o["kind"] == "attention"][0]
    assert att["pairs"] == t2 * sum(f2)
    assert att["flops"] == 4 * t2 * sum(f2) * 768
    n = b * t2
    assert _sum(ops, "ffn") == 4 * n * 768 * 3072
    assert _sum(ops, "dense_ln") == 2 * n * 768 * 768
    assert frames == [x // 2 for x in f2]       # after the length adapter
    assert t == (t2 - 2) // 2 + 1


def test_layerdrop_removes_the_layer():
    ops, _, _ = flops.speech_encoder(_cfg(num_layers=3), 2, 2000,
                                     [2000, 2000], skipped=[1])
    assert sum(o["kind"] == "attention" for o in ops) == 2


def test_decoder_by_hand():
    b, steps, t_enc, frames = 4, 3, 10, [10, 8, 6, 4]
    ops = flops.cached_decode(BART, b, steps, t_enc, frames)
    dec = [o for o in ops if o["kind"] == "decode_attention"]
    # per step: self over step + 1 keys, cross over the valid frames
    assert [o["keys"] for o in dec] == [4, 28, 8, 28, 12, 28]
    assert _sum(ops, "dense") == (
        2 * 2 * b * t_enc * 768 * 768                  # cross K / V once
        + steps * (4 * 2 * b * 768 * 768               # q k v, cross q
                   + 2 * b * 768 * 1000))              # the head
    causal = flops._attention(2, 768, 4, [4, 4], True, True, True)
    assert causal["pairs"] == 2 * (1 + 2 + 3 + 4)


def test_training_counts_three_forwards():
    cfg = _cfg()
    ops = flops.train_ops(cfg, 2, 2000, [2000, 2000], 8, [], False)
    assert flops.model_flops(ops, True) == 3 * sum(o["flops"] for o in ops)


@pytest.mark.parametrize("dtype,es", [("float32", 4), ("bfloat16", 2)])
def test_family_bounds_by_hand(dtype, es):
    fams = core.families()
    ffn = {"kind": "ffn", "flops": 0, "rows": 1000, "h": 768, "f": 3072,
           "fused": True, "dropout": False, "backward": True, "res_ln": True}
    assert fams["ffn_fwd"].work(ffn, es) == (
        4.0 * 1000 * 768 * 3072, (2.0 * 1000 * 768 + 2.0 * 768 * 3072) * es,
        3)
    assert fams["ffn_bwd"].work(ffn, es)[0] == 10.0 * 1000 * 768 * 3072
    dense_ln = {"kind": "dense_ln", "rows": 1000, "d_in": 768,
                "d_out": 768, "fused": True}
    owner = "ffn_fwd" if es == 4 else "dense_res_ln"
    others = [f for f in fams if f != owner]
    assert fams[owner].work(dense_ln, es)[0] == 2.0 * 1000 * 768 * 768
    assert all(fams[f].work(dense_ln, es) is None for f in others)
    plain = dict(ffn, fused=False)
    assert all(m.work(plain, es) is None for m in fams.values())


def test_roofline_sums_what_each_family_claims():
    op = {"kind": "attention", "flops": 0, "pairs": 10 ** 6, "width": 768,
          "rows": 2, "tq": 1000, "fused": True, "backward": False}
    out = core.roofline([[op]], {"void attention_fwd_f32_kernel<64, false>"
                                 "(params)": 0.5, "cutlass_gemm": 1.0},
                        {"smx_attention_fwd": 1}, "float32")
    fwd = out["attention_fwd"]
    assert fwd["ops"] == 1 and fwd["launches"] == 1
    assert fwd["device_s"] == 0.5
    assert fwd["bound_s"] == max(4e6 * 768 / 495e12, 4 * 2 * 1000 * 768 * 4
                                 / 3.35e12)
    assert out["attention_bwd"]["ops"] == 0
    assert out["ffn_bwd"]["device_s"] == 0.0


def _launches(ops, es):
    """{family: launches its work() counts over ops}."""
    out = {}
    for fam, mod in core.families().items():
        out[fam] = sum(w[2] for w in (mod.work(op, es) for op in ops) if w)
    return out


def test_launches_of_a_post_ln_train_layer_by_hand():
    """One post-LN speech layer of a training step with dropout, f32: K1
    forward and K7 / K15 backward once; the f32 epilogue one launch, the
    FFN block up, down and rows, the backward's recompute up and down; K8
    recompute and products; K10 for the epilogue's and the block's output
    masks, and for the projection and the positional conv's dropout."""
    ops, _, _ = flops.speech_encoder(_cfg(), 2, 100000, [100000] * 2,
                                     train=True, dropout=True)
    got = _launches(ops, 4)
    assert got["attention_fwd"] == 1 and got["attention_bwd"] == 1
    assert got["ffn_fwd"] == 1 + 3 + 2
    assert got["ffn_bwd"] == 2
    assert got["dropout_mask"] == 2 + 2
    assert got["conv"] == 2                   # extractor layers 1 and 2
    # in bfloat16 the epilogue is the dense_res_ln family's
    got = _launches(ops, 2)
    assert got["ffn_fwd"] == 3 + 2 and got["dense_res_ln"] == 1


def test_a_family_at_odds_with_the_counters_is_left_out():
    from benchmark import readers
    op = {"kind": "attention", "flops": 0, "pairs": 10 ** 6, "width": 768,
          "rows": 2, "tq": 1000, "fused": True, "backward": False}
    dev = {"void attention_fwd_f32_kernel<64, false>(params)": 0.5,
           "void conv_kernel<float, 128, false>(ConvArgs)": 0.25}
    conv = {"kind": "conv", "flops": 1e9, "rows": 1, "t_in": 10,
            "t_out": 5, "c_in": 4, "c_out": 4, "k": 2, "fused": True}
    agree = core.roofline([[op, conv]], dev, {"smx_attention_fwd": 1,
                                              "smx_conv_ln_gelu": 1},
                          "float32")
    # the gate moved: the port launched the attention kernel twice
    odd = core.roofline([[op, conv]], dev, {"smx_attention_fwd": 2,
                                            "smx_conv_ln_gelu": 1},
                        "float32")
    assert agree["attention_fwd"]["bound_s"] > 0
    assert odd["attention_fwd"]["bound_s"] is None
    assert odd["attention_fwd"]["counted"] == 1
    assert odd["conv"]["bound_s"] == agree["conv"]["bound_s"]
    conv_only = 100 * agree["conv"]["bound_s"] / 0.25
    assert readers.kernel_roofline({"families": odd}) == conv_only
    assert readers.kernel_roofline({"families": agree}) != conv_only
