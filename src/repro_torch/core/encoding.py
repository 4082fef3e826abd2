"""DNA character encodings + SWAR bit packing (port of ``repro.core.encoding``).

numpy only, copied from the JAX package so the port imports nothing of
it.  The paper uses a 2-bit encoding for the DNA alphabet {A, C, G, T}
(Sec. 3.1); the packed form feeds the SWAR kernels (uint32 words, 16
chars/word), the bit planes (``codes_to_bits``) the CRAM array's row
layout (``core.matcher``), and ``encode_bytes`` byte text.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

DNA_ALPHABET = "ACGT"
DNA_CODE: Dict[str, int] = {c: i for i, c in enumerate(DNA_ALPHABET)}
DNA_BITS = 2

# IUPAC ambiguity codes as 4-bit accept masks: bit c set <=> DNA code c
# (A=0, C=1, G=2, T=3) is accepted at that position.  These are the
# per-position accept sets consumed by the predicate API
# (``repro_torch.match.query``); N is the full wildcard.  U (RNA) reads
# as T.
IUPAC_MASKS: Dict[str, int] = {
    "A": 0b0001, "C": 0b0010, "G": 0b0100, "T": 0b1000, "U": 0b1000,
    "R": 0b0101, "Y": 0b1010, "S": 0b0110, "W": 0b1001,
    "K": 0b1100, "M": 0b0011,
    "B": 0b1110, "D": 0b1101, "H": 0b1011, "V": 0b0111,
    "N": 0b1111,
}


def encode_dna(s: str) -> np.ndarray:
    """String over ACGT -> uint8 codes (values 0..3).

    Raises ``ValueError`` on any other character: silently folding unknown
    bases to 'A' fabricates matches.  Ambiguity codes (N, R, ...) are not
    losses of information to be papered over -- encode them with
    ``encode_iupac`` and match through the predicate API.
    """
    lut = np.full(256, 255, np.uint8)
    for c, v in DNA_CODE.items():
        lut[ord(c)] = v
        lut[ord(c.lower())] = v
    raw = np.frombuffer(s.encode(), np.uint8)
    codes = lut[raw]
    if (codes == 255).any():
        # Name offenders from the byte buffer: string indices are char
        # offsets, not byte offsets (multi-byte chars would misindex).
        bad = sorted({chr(b) for b in raw[codes == 255][:8]})
        raise ValueError(
            f"encode_dna: invalid character(s) {bad} -- not in ACGT. "
            "Use encode_iupac for ambiguity codes (N, R, Y, ...)")
    return codes


def encode_iupac(s: str) -> np.ndarray:
    """IUPAC string -> uint8 per-position accept masks (values 1..15).

    Bit ``c`` of position ``i`` is set iff DNA code ``c`` is accepted there;
    plain ACGT positions become one-hot masks, ``N`` becomes 0b1111.  Feed
    the result to ``MatchQuery.iupac`` / ``from_masks``.
    """
    lut = np.zeros(256, np.uint8)
    for c, m in IUPAC_MASKS.items():
        lut[ord(c)] = m
        lut[ord(c.lower())] = m
    raw = np.frombuffer(s.encode(), np.uint8)
    masks = lut[raw]
    if (masks == 0).any():
        bad = sorted({chr(b) for b in raw[masks == 0][:8]})
        raise ValueError(f"encode_iupac: invalid IUPAC character(s) {bad}")
    return masks


def decode_dna(codes: np.ndarray) -> str:
    return "".join(DNA_ALPHABET[c] for c in np.asarray(codes))


def random_dna(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def codes_to_bits(codes: np.ndarray, bits: int = DNA_BITS) -> np.ndarray:
    """(..., n) codes -> (..., n*bits) bit planes, LSB-first per character.

    This is the CRAM row layout: each character occupies `bits` adjacent
    cells (Sec. 3.1: "each character-level comparison entails two bit-level
    comparisons")."""
    codes = np.asarray(codes)
    out = np.zeros(codes.shape + (bits,), np.uint8)
    for b in range(bits):
        out[..., b] = (codes >> b) & 1
    return out.reshape(codes.shape[:-1] + (codes.shape[-1] * bits,))


def bits_to_codes(bitarr: np.ndarray, bits: int = DNA_BITS) -> np.ndarray:
    bitarr = np.asarray(bitarr)
    n = bitarr.shape[-1] // bits
    grouped = bitarr.reshape(bitarr.shape[:-1] + (n, bits))
    weights = (1 << np.arange(bits)).astype(np.uint8)
    return (grouped * weights).sum(-1).astype(np.uint8)


def pack_codes_u32(codes: np.ndarray, bits: int = DNA_BITS) -> np.ndarray:
    """(..., n) char codes -> (..., ceil(n/cpw)) uint32 SWAR words.

    Characters are packed LSB-first: char i occupies bits [i*bits, (i+1)*bits)
    of word i // cpw.  Tail lanes are zero-padded (caller masks them).
    """
    codes = np.asarray(codes, np.uint32)
    cpw = 32 // bits
    n = codes.shape[-1]
    n_words = -(-n // cpw)
    padded = np.zeros(codes.shape[:-1] + (n_words * cpw,), np.uint32)
    padded[..., :n] = codes
    lanes = padded.reshape(padded.shape[:-1] + (n_words, cpw))
    shifts = (np.arange(cpw, dtype=np.uint32) * bits).astype(np.uint32)
    return (lanes << shifts).sum(-1, dtype=np.uint64).astype(np.uint32)


def unpack_codes_u32(words: np.ndarray, n: int, bits: int = DNA_BITS) -> np.ndarray:
    words = np.asarray(words, np.uint32)
    cpw = 32 // bits
    shifts = (np.arange(cpw, dtype=np.uint32) * bits).astype(np.uint32)
    lanes = (words[..., :, None] >> shifts) & np.uint32((1 << bits) - 1)
    flat = lanes.reshape(words.shape[:-1] + (words.shape[-1] * cpw,))
    return flat[..., :n].astype(np.uint8)


def encode_bytes(s: bytes) -> np.ndarray:
    return np.frombuffer(s, np.uint8)


def fold_reference(ref_codes: np.ndarray, fragment_len: int,
                   pattern_len: int) -> np.ndarray:
    """Fold a long reference into overlapping per-row fragments (Sec. 3.1-3.2).

    Adjacent fragments overlap by pattern_len - 1 characters so alignments
    spanning a row boundary are still observed ("row replication at array
    boundaries", Sec. 3.2).  Returns (n_rows, fragment_len) uint8; the tail is
    padded with 0 ('A') codes.
    """
    ref_codes = np.asarray(ref_codes, np.uint8)
    step = fragment_len - (pattern_len - 1)
    if step <= 0:
        raise ValueError("fragment_len must exceed pattern_len - 1")
    n_rows = max(1, -(-max(len(ref_codes) - (pattern_len - 1), 1) // step))
    out = np.zeros((n_rows, fragment_len), np.uint8)
    for r in range(n_rows):
        chunk = ref_codes[r * step: r * step + fragment_len]
        out[r, :len(chunk)] = chunk
    return out
