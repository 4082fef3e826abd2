"""RC4-style bulk stream cipher on the bit-parallel engine (paper Table 4),
on the PyTorch/CUDA port.

Generates an RC4 keystream (host-side PRGA), then runs the bulk XOR
encrypt/decrypt over many message rows with the port's bitwise kernel
(``bitwise.cu`` on the card) --
the same row-parallel computation CRAM-PM performs in the RC4 benchmark --
and reports the substrate cost-model projection.

The twin of ``crypto_rc4.py``: the same seeds, sizes, printed lines and
asserts, on ``repro_torch``; ``main(device="cpu")`` runs the plain
version on the CPU.

Run:  PYTHONPATH=src python examples/crypto_rc4_torch.py
"""

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core.tech import LONG_TERM, NEAR_TERM
from repro_torch.kernels import ops


def rc4_keystream(key: bytes, n: int) -> np.ndarray:
    s = list(range(256))
    j = 0
    for i in range(256):
        j = (j + s[i] + key[i % len(key)]) % 256
        s[i], s[j] = s[j], s[i]
    out = np.empty(n, np.uint8)
    i = j = 0
    for t in range(n):
        i = (i + 1) % 256
        j = (j + s[i]) % 256
        s[i], s[j] = s[j], s[i]
        out[t] = s[(s[i] + s[j]) % 256]
    return out


def main(device=None) -> None:
    rng = np.random.default_rng(0)
    n_rows, row_words = 4096, 8            # 248-bit segments, padded to 256
    text = rng.integers(0, 2**32, (n_rows, row_words),
                        dtype=np.uint64).astype(np.uint32)
    ks = rc4_keystream(b"repro-key", n_rows * row_words * 4)
    key = ks.view(np.uint32).reshape(n_rows, row_words)

    cipher = ops.bitwise("XOR", text, key, device=device)
    plain = ops.bitwise("XOR", cipher, key, device=device)
    plain = plain.cpu().numpy().view(np.uint32)     # int32 carriers
    assert np.array_equal(plain, text)
    print(f"encrypt/decrypt round-trip over {n_rows} rows x "
          f"{row_words*32} bits: OK")

    app = cm.table4_apps()["RC4"]
    for tech in (NEAR_TERM, LONG_TERM):
        r = cm.app_cram_run(app, tech)
        nmp = cm.app_nmp_run(app)
        print(f"CRAM-PM {tech.name:9s}: {r.match_rate:.4g} segments/s "
              f"({r.match_rate/nmp.match_rate:.0f}x NMP)")


if __name__ == "__main__":
    main()
