"""The corrupt containers of tests/test_fuzz.py, for the port: its record
generator (a copy of _random_fastq, held to the original by
test_torch_fuzz.py), its config and seeds, and the check of one decode.
test_torch_fuzz.py runs them on the CPU, test_torch_cuda.py and
chip_smoke.py on the card, where jax is absent: this module imports
neither jax nor the JAX package."""

import numpy as np

from phyngsc_tpu_torch.config import CodecConfig

#: tests/test_fuzz.py's CFG
CFG_KW = dict(subblock_input_bytes=16 << 10, records_per_substream=8)
CFG = CodecConfig(**CFG_KW)

#: the designed rejections of a corrupt container (container framing and
#: range ValueErrors, BitReader EOFError); anything else is a fault
CORRUPT_ERRORS = (ValueError, EOFError)


def random_fastq(rng: np.random.Generator, n: int, *, iupac=0.0, qmax=74,
                 var_len=True, messy_titles=False) -> bytes:
    """tests/test_fuzz.py _random_fastq, the same records from the same
    rng."""
    alphabet = b"ACGT" + (b"NYRWSKM" if iupac else b"")
    probs = None
    if iupac:
        probs = np.full(len(alphabet), iupac / (len(alphabet) - 4))
        probs[:4] = (1 - iupac) / 4
    out = bytearray()
    for i in range(n):
        L = int(rng.integers(1, 80)) if var_len else 36
        if messy_titles:
            tl = int(rng.integers(1, 30))
            title = bytes(rng.integers(33, 127, size=tl).astype(np.uint8))
            title = b"@" + title.replace(b"\n", b"_")
        else:
            title = b"@FUZZ.%d run=%d" % (i, int(rng.integers(0, 9)))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=L, p=probs)
        qual = rng.integers(33, qmax + 1, size=L).astype(np.uint8)
        out += title + b"\n" + seq.tobytes() + b"\n+\n" + qual.tobytes() + b"\n"
    return bytes(out)


def bitflip_corpus():
    """(rng, data) of test_bitflip_fuzz_never_crashes: 120 records, 2%
    IUPAC; the rng then gives the flips (flips())."""
    rng = np.random.default_rng(1234)
    return rng, random_fastq(rng, 120, iupac=0.02)


def flips(rng: np.random.Generator, blob: bytes, trials: int = 120):
    """test_bitflip_fuzz_never_crashes' flips of `blob`: (pos, bit, the
    mutated container) for each trial."""
    for _ in range(trials):
        pos = int(rng.integers(0, len(blob)))
        bit = int(rng.integers(0, 8))
        mutated = bytearray(blob)
        mutated[pos] ^= 1 << bit
        yield pos, bit, bytes(mutated)


def outcome(decode, blob: bytes, data: bytes) -> str:
    """decode(blob) under the fuzz contract: "ok" where it gives `data`
    back, the exception's name where it raises a designed rejection;
    AssertionError on other bytes, any other exception propagates."""
    try:
        back = decode(blob)
    except CORRUPT_ERRORS as e:
        return type(e).__name__
    assert back == data, "silent corruption: other bytes and no error"
    return "ok"
