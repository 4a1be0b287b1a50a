"""The corpora of the card's widened-race test (tests/test_torch_cuda.py
test_round_trips_with_delayed_task_streams) and the SHA-256 of the JAX
package's container of each, which tests/test_torch_async.py holds true on
the CPU (the card has no jax). Small sub-blocks, so that many are in
flight at once."""

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq

KW = dict(subblock_input_bytes=32 << 10, records_per_substream=16)
#: name -> (corpus, CodecConfig keywords)
CORPORA = {
    "ERR005195": (lambda: synthesize_fastq(2500, read_len=36, seed=31,
                                           ambiguity_rate=0.01), KW),
    "variable-length": (lambda: synthesize_fastq(
        1200, read_len=100, seed=32, variable_length=True), KW),
    "2 shards": (lambda: synthesize_fastq(2500, read_len=36, seed=31,
                                          ambiguity_rate=0.01),
                 dict(KW, data_shards=2)),
}
#: name -> SHA-256 of phyngsc_tpu's compress_bytes(corpus, cfg, 1)
SHA256 = {
    "ERR005195":
        "21517c1b0e3096fb48864898e6f91c85609cfb5648fc6e7dc48a197a5b0f7095",
    "variable-length":
        "6086cefcb65b1c3efab04c1b86ea99eb1bfc3a2775c2050f847f97a29565da3c",
    # the 1-shard container: the buckets do not change at 2 shards
    "2 shards":
        "21517c1b0e3096fb48864898e6f91c85609cfb5648fc6e7dc48a197a5b0f7095",
}


def config(name: str) -> CodecConfig:
    return CodecConfig(**CORPORA[name][1])
