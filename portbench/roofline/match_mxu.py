"""match_mxu (every alignment stored): one-hot contraction.  Per (row,
alignment, pattern): 2 x 4P flops on the tensor cores.  Bytes: the
one-hot rows and the used pattern columns read once, one f32 score per
(row, alignment, pattern) written once.  The call's operands are padded
(rows of 4P channels to a multiple of 128, alignments to a tile), so P
and the F - P + 1 alignments come from the configuration."""

from portbench.roofline import used_columns

WRAPPER = ("repro_torch.kernels.match_mxu", "match_mxu")


def describe(args, kw):
    ref, pat = args[0], args[1]
    return {"R": ref.shape[0], "F4": ref.shape[1], "pat": pat}


def work(d, geom):
    P = geom["read_chars"]
    L = geom["fragment_chars"] - P + 1
    R, Q, K = d["R"], used_columns(d["pat"]), 4 * P
    return {"bf16_flop": 2.0 * R * L * Q * K,
            "bytes": 2.0 * (R * d["F4"] + K * Q) + 4.0 * R * L * Q}
