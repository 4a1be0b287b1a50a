"""phyngsc_tpu_torch — the PyTorch / CUDA port of phyngsc_tpu.

Runs the single-device compress -> decompress round trip of every input
phyngsc_tpu takes on one device (uniform or variable lengths, long reads,
SOLiD colour space) on an NVIDIA H100, with the K1-K5 kernels hand-written
in CUDA under csrc/, and writes the same .ngsct container as phyngsc_tpu,
byte for byte. The entry points are phyngsc_tpu's: compress_bytes /
decompress_bytes, the bounded-memory compress_file / decompress_file, and
the command line (python -m phyngsc_tpu_torch). Every one takes an explicit
device; CPU tensors take each kernel's plain PyTorch version. The package
imports nothing of phyngsc_tpu: the host code it shares with it (config,
FASTQ indexing, bit I/O, Huffman tables, container framing, .ngsc import
and export, region partitioning, the native-runtime loader) is copied under
the same paths here, each copy naming its source on its first line.
"""

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq

__all__ = ["CodecConfig", "synthesize_fastq"]
