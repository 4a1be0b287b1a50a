"""phyngsc_tpu_torch — the PyTorch / CUDA port of phyngsc_tpu.

Runs the single-device compress -> decompress round trip of every input
phyngsc_tpu takes on one device (uniform or variable lengths, long reads,
SOLiD colour space) on an NVIDIA H100, with the K1-K4 kernels hand-written
in CUDA under csrc/, and writes the same .ngsct container as phyngsc_tpu,
byte for byte. Every pipeline entry point
takes an explicit `device`; CPU tensors take each kernel's plain PyTorch
version. Host code without jax (config, FASTQ indexing, bit I/O, Huffman
tables, container framing) is shared with phyngsc_tpu.
"""

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.utils.fastq import synthesize_fastq

__all__ = ["CodecConfig", "synthesize_fastq"]
