"""A well-formed container whose lanes hold more than 2^16 words.

auto_substream looks only at the first record, so a variable-length
long-read file whose first read is short keeps G = 64, and a lane of 64
reads of several kbp outgrows 2^16 words. phyngsc_tpu decodes such a
container (its walk gate routes it to the XLA decode); the port walks it on
the plane like any other, and must give back the input bytes."""

import numpy as np

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.pipeline.decompress import decompress_bytes as jax_decompress
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from test_torch_pipeline import _parsed


def _fastq(lens, seed):
    """Reads of the given lengths, bases and phred+33 qualities uniform."""
    rng = np.random.default_rng(seed)
    recs = []
    for i, n in enumerate(lens):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
        qual = rng.integers(33, 127, n).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), qual.tobytes()))
    return b"".join(recs)


def test_lanes_past_2_16_words_decode():
    data = _fastq([100] + [5400] * 63, 71)
    blob = compress_bytes(data, CodecConfig(), 1, device="cpu")
    (p,) = _parsed(blob)
    assert p.G == 64 and p.variable
    assert int(p.q_sub.max()) > 1 << 16
    assert decompress_bytes(blob, device="cpu") == data
    assert jax_decompress(blob) == data
