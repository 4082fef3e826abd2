"""match_mxu_best: one-hot contraction with the best alignment reduced in
the epilogue.  Per (row, alignment, pattern): 2 x 4P flops on the tensor
cores (P chars, 4 one-hot channels).  Bytes: the one-hot rows and the
used pattern columns read once, (rows, patterns) best offset and score
written once as int32."""

from portbench.roofline import used_columns

WRAPPER = ("repro_torch.kernels.match_mxu", "match_mxu_best")


def describe(args, kw):
    ref, pat = args[0], args[1]
    return {"R": ref.shape[0], "F4": ref.shape[1], "pat": pat,
            "n_locs": int(kw["n_locs"]), "n_k": int(kw["n_k"])}


def work(d, geom):
    R, L, K = d["R"], d["n_locs"], d["n_k"]
    Q = used_columns(d["pat"])
    return {"bf16_flop": 2.0 * R * L * Q * K,
            "bytes": 2.0 * (R * d["F4"] + K * Q) + 8.0 * R * Q}
