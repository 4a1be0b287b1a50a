"""Command-line driver of the PyTorch / CUDA port (port of phyngsc_tpu/cli.py).

    python -m phyngsc_tpu_torch compress   in.fastq out.ngsct [--writers P] [...]
    python -m phyngsc_tpu_torch decompress in.ngsct out.fastq
    python -m phyngsc_tpu_torch verify     in.fastq            (round-trip check)
    python -m phyngsc_tpu_torch import-ngsc in.ngsc out.fastq
    python -m phyngsc_tpu_torch export-ngsc in.fastq out.ngsc

The subcommands and flags are phyngsc_tpu's, and the containers are the
same bytes. --device picks the device of the codec's tensor work: "cuda"
(the default) raises without a card, "cpu" runs the kernels' plain PyTorch
versions. --profile DIR writes a torch.profiler trace. .ngsc import and
export run the port's copies of phyngsc_tpu's container modules.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.device import resolve


def _add_codec_flags(p: argparse.ArgumentParser) -> None:
    d = CodecConfig()
    p.add_argument("--block-size", type=int, default=d.block_size,
                   help="container block size in bytes (default 8 MiB)")
    p.add_argument("--subblock-bytes", type=int, default=d.subblock_input_bytes,
                   help="raw input bytes per sub-block / device batch")
    p.add_argument("--substream-records", type=int,
                   default=d.records_per_substream,
                   help="records per decode substream")
    p.add_argument("--max-code-len", type=int, default=d.max_code_len,
                   help="Huffman code length cap (<= 12)")


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the codec: cuda (default; raises "
                        "without a card) or cpu")


def _cfg_from(args) -> CodecConfig:
    return CodecConfig(
        block_size=args.block_size,
        subblock_input_bytes=args.subblock_bytes,
        records_per_substream=args.substream_records,
        max_code_len=args.max_code_len,
        data_shards=getattr(args, "data_shards", 1),
    )


@contextlib.contextmanager
def _profile(trace_dir, device):
    """torch.profiler trace of the scope (host, and the card's kernels on a
    CUDA device) written to trace_dir/trace.json; no-op without a dir."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[I] profiler trace written to {path}")


def _same_files(a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(8 << 20)
            if x != fb.read(8 << 20):
                return False
            if not x:
                return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="phyngsc_tpu_torch",
        description="FASTQ compressor, PyTorch / CUDA port of phyngsc_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="FASTQ → .ngsct")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--writers", type=int, default=1,
                   help="number of logical writers (file regions)")
    c.add_argument("--data-shards", type=int, default=1,
                   help="shard stream encoders over this many devices "
                        "(a later slice of the port: > 1 raises)")
    c.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace to DIR")
    _add_codec_flags(c)
    _add_device_flag(c)

    d = sub.add_parser("decompress", help=".ngsct → FASTQ")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--data-shards", type=int, default=1,
                   help="shard the decode over N devices (a later slice of "
                        "the port: > 1 raises)")
    _add_device_flag(d)

    imp = sub.add_parser(
        "import-ngsc",
        help="decode a reference phyNGSC .ngsc container to FASTQ")
    imp.add_argument("input")
    imp.add_argument("output")

    exp = sub.add_parser(
        "export-ngsc",
        help="write a reference-format phyNGSC .ngsc container from FASTQ")
    exp.add_argument("input")
    exp.add_argument("output")

    v = sub.add_parser("verify",
                       help="compress+decompress+compare (streams via temp "
                            "files — flat memory at any input size)")
    v.add_argument("input")
    v.add_argument("--writers", type=int, default=1)
    _add_codec_flags(v)
    _add_device_flag(v)

    args = ap.parse_args(argv)

    if args.cmd == "compress":
        from phyngsc_tpu_torch.pipeline.compress import compress_file

        device = resolve(args.device)
        stats: list = []
        t0 = time.perf_counter()
        with _profile(args.profile, device):
            compress_file(args.input, args.output, _cfg_from(args),
                          args.writers, stats, device)
        dt = time.perf_counter() - t0
        for s in stats:
            print(f"[I] writer {s.writer_id}: {s.seconds:.3f}s "
                  f"blocks={s.n_blocks} subblocks={s.n_subblocks} "
                  f"in={s.input_bytes} out={s.output_bytes}")
        total_in = sum(s.input_bytes for s in stats)
        print(f"[I] total {dt:.3f}s  {total_in / max(dt, 1e-9) / 1e6:.2f} MB/s")
        return 0

    if args.cmd == "decompress":
        from phyngsc_tpu_torch.pipeline.decompress import decompress_file

        device = resolve(args.device)
        t0 = time.perf_counter()
        cfg = (CodecConfig(data_shards=args.data_shards)
               if args.data_shards > 1 else None)
        decompress_file(args.input, args.output, cfg, device)
        print(f"[I] decompressed in {time.perf_counter() - t0:.3f}s")
        return 0

    if args.cmd == "import-ngsc":
        from phyngsc_tpu_torch.container.ngsc_import import import_ngsc_file

        t0 = time.perf_counter()
        n = import_ngsc_file(args.input, args.output)
        print(f"[I] imported {n} FASTQ bytes from .ngsc in "
              f"{time.perf_counter() - t0:.3f}s")
        return 0

    if args.cmd == "export-ngsc":
        from phyngsc_tpu_torch.container.ngsc_export import export_ngsc_file

        t0 = time.perf_counter()
        n = export_ngsc_file(args.input, args.output)
        print(f"[I] exported {n} .ngsc bytes in "
              f"{time.perf_counter() - t0:.3f}s")
        return 0

    if args.cmd == "verify":
        # disk-streamed round trip: memmapped compress -> temp container ->
        # pwrite decompress -> chunked compare, so memory stays flat
        from phyngsc_tpu_torch.pipeline.compress import compress_file
        from phyngsc_tpu_torch.pipeline.decompress import decompress_file

        device = resolve(args.device)
        in_size = os.path.getsize(args.input)
        with tempfile.TemporaryDirectory(
                dir=os.path.dirname(os.path.abspath(args.input))) as td:
            comp_path = os.path.join(td, "verify.ngsct")
            back_path = os.path.join(td, "verify.fastq")
            compress_file(args.input, comp_path, _cfg_from(args),
                          args.writers, None, device)
            comp_size = os.path.getsize(comp_path)
            decompress_file(comp_path, back_path, None, device)
            ok = _same_files(args.input, back_path)
        ratio = in_size / max(comp_size, 1)
        print(f"[I] round-trip {'OK' if ok else 'FAILED'}  "
              f"{in_size} → {comp_size} bytes  ratio {ratio:.3f}x")
        return 0 if ok else 1

    return 2


if __name__ == "__main__":
    sys.exit(main())
