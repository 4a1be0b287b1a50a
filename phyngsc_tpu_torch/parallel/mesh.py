"""Device mesh + sharded encode and decode (port of phyngsc_tpu/parallel/mesh.py).

The reference's process/thread hierarchy (MPI rank = file region, OpenMP
thread = buffer chunk, SURVEY §1) maps onto a 2-D grid of torch devices:

- `data` (rows of the grid) — records. Each shard owns a contiguous record
  range whose substreams are self-contained, so per-shard packed words
  concatenate into one container stream.
- `seq` (columns) — read positions. Per-position histograms are independent
  across positions (tasks.cpp:590-605), so the statistics pass splits along
  the position axis too; the counts are summed over `data` on the mesh's
  first device (the JAX package's psum; the reference's omp-critical merge,
  phyNGSC.cpp:622-653).

A device may appear in several cells: one card (or the CPU) then runs every
shard in turn, which is how one H100 runs two shards and how the CPU tests
stand in for several devices. Each shard's work runs with its device
current, on that device's current stream: inside the pipeline's stages,
the sub-block's task stream of that device (device.use_streams makes the
task's stream of every shard device current at once), so that a copy
between two devices (PyTorch orders it on both devices' current streams)
is ordered after its producer and before its consumer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.device import on_device, resolve
from phyngsc_tpu_torch.models import quality
from phyngsc_tpu_torch.ops import histogram
from phyngsc_tpu_torch.pipeline import subblock


def make_mesh(n_data: int, n_seq: int = 1,
              devices: Optional[Sequence] = None,
              cfg: Optional[CodecConfig] = None) -> np.ndarray:
    """(n_data, n_seq) object array of torch.device: the first n_data *
    n_seq of `devices` (which may repeat one), or of the visible CUDA
    devices. Raises ValueError when there are fewer. cfg is taken for
    phyngsc_tpu's signature: the axes here are positional."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [resolve(d) for d in devices]
    need = n_data * n_seq
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return grid.reshape(n_data, n_seq)


def shard_devices(device, n_data: int) -> list:
    """The n_data shard devices of a driver's `device` argument: a sequence
    of n_data devices (which may repeat one); a CUDA device, meaning cards
    index .. index + n_data - 1, which must be visible; or another device
    (the CPU), which then holds every shard."""
    if isinstance(device, (list, tuple)):
        if len(device) != n_data:
            raise ValueError(f"{len(device)} devices given for {n_data} "
                             "data shards")
        return [resolve(d) for d in device]
    dev = resolve(device)
    if n_data == 1 or dev.type != "cuda":
        return [dev] * n_data
    first = dev.index or 0
    return list(make_mesh(first + n_data)[first:, 0])


def codec_for(device, cfg: CodecConfig) -> tuple:
    """A driver's (first device, codec): the first of the cfg.data_shards
    shard devices of `device` (shard_devices), and a ShardedSubblockCodec
    over them, or None for one shard."""
    devices = shard_devices(device, cfg.data_shards)
    if cfg.data_shards == 1:
        return devices[0], None
    return devices[0], ShardedSubblockCodec(
        make_mesh(cfg.data_shards, 1, devices, cfg), cfg)


def _split(n: int, k: int) -> list:
    """k contiguous ranges (lo, hi) covering 0 .. n - 1, sizes within one."""
    return [(i * n // k, (i + 1) * n // k) for i in range(k)]


def sharded_analyze(mesh: np.ndarray, cfg: Optional[CodecConfig] = None):
    """fn((R, L) uint8 symbols, (R, L) validity) -> (L, 256) int32 global
    per-position histogram on the mesh's first device. R splits over
    `data`, L over `seq`; each shard runs K1 on its own device, the counts
    are summed over `data` and the position slices concatenated over
    `seq`."""
    n_data, n_seq = mesh.shape
    first = mesh[0, 0]

    def fn(sym: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        R, L = sym.shape
        cols = []
        for j, (c0, c1) in enumerate(_split(L, n_seq)):
            total = None
            for i, (r0, r1) in enumerate(_split(R, n_data)):
                dev = mesh[i, j]
                with on_device(dev):
                    local = histogram.position_histogram(
                        sym[r0:r1, c0:c1].to(dev).contiguous(),
                        valid[r0:r1, c0:c1].to(dev).contiguous(), 256)
                local = local.to(first)
                total = local if total is None else total + local
            cols.append(total)
        return torch.cat(cols)

    return fn


def sharded_quality_encode(mesh: np.ndarray, records_per_substream: int,
                           n_words_cap_per_shard: int,
                           cfg: Optional[CodecConfig] = None):
    """Data-parallel quality encode: each shard packs its record range.

    Returns fn(qual (R, L), lens (R,), tab (T, A) int16, tree (L,) uint8,
    group=2, off=0) -> (words (n_data * cap,) int64 holding uint32,
    sub_n_words (S,) int64, totals (n_data,) int64) on the mesh's first
    device, tab and tree being quality.encode_tables' fused tables. R is a
    multiple of n_data * G. Substreams are shard-local, so the stream is
    the concatenation of the shards' words, each trimmed to its total."""
    n_data = mesh.shape[0]
    first = mesh[0, 0]
    G, cap = records_per_substream, n_words_cap_per_shard

    def fn(qual, lens, tab, tree, group: int = 2, off: int = 0):
        words, subs, totals = [], [], []
        for k, (r0, r1) in enumerate(_split(qual.shape[0], n_data)):
            dev = mesh[k, 0]
            with on_device(dev):
                w, s, t = quality.encode_device(
                    qual[r0:r1].to(dev), lens[r0:r1].to(dev), tab.to(dev),
                    tree.to(dev), G, cap, group, off)
            words.append(w.to(first))
            subs.append(s.to(first))
            totals.append(t.view(1).to(first))
        return torch.cat(words), torch.cat(subs), torch.cat(totals)

    return fn


class ShardedSubblockCodec:
    """Data-parallel sub-block encode and decode over the mesh's `data`
    axis (its first column).

    Each data shard owns a contiguous record range of Rp / n_data rows;
    substreams never cross shards, so the per-shard packed words
    concatenate into the exact stream one device writes with the same
    substream table. Histograms are summed over the shards so the host
    builds one table set. The decode splits the lanes (substreams) into
    n_data contiguous ranges of whole lanes, sizes within one, for any
    substream count; a shard left without lanes does nothing.
    """

    def __init__(self, mesh: np.ndarray, cfg: CodecConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.n_data = mesh.shape[0]
        self.devices = list(mesh[:, 0])

    def row_ranges(self, Rp: int) -> list:
        """(device, lo, hi) of each shard's rows of an Rp-row sub-block;
        Rp is a multiple of G * n_data (shapes.bucket_records)."""
        G = self.cfg.records_per_substream
        if Rp % (G * self.n_data):
            raise ValueError(f"{Rp} rows do not split into {self.n_data} "
                             f"shards of whole {G}-record substreams")
        return [(dev, lo, hi) for dev, (lo, hi)
                in zip(self.devices, _split(Rp, self.n_data))]

    def analyze(self, seq: list, qual: list, lens: list, small: bool):
        """Each shard's (rows, L) planes on its device -> (counts blob:
        quality then DNA counts, int32, summed over the shards on the first
        device; each shard's qual_t; each shard's keep). Each shard runs K1
        over all its rows, as the JAX package's shard_map does."""
        first = self.devices[0]
        total, qual_t, keep = None, [], []
        for dev, s, q, n in zip(self.devices, seq, qual, lens):
            with on_device(dev):
                qt, kp, q_counts, d_counts = subblock.analyze_rows(
                    s, q, n, small)
                blob = torch.cat([q_counts.reshape(-1), d_counts.reshape(-1)])
            qual_t.append(qt)
            keep.append(kp)
            blob = blob.to(first)
            total = blob if total is None else total + blob
        return total, qual_t, keep

    def encode(self, qual_t: list, keep: list, seq: list, lens: list,
               tables: list, *args) -> list:
        """Each shard packs both streams of its rows with the host `tables`
        (uploaded once to each distinct device): one subblock.encode_rows
        blob a shard, on its device. args: encode_rows' (G, q_cap, d_cap,
        mode, q_group, d_group, q_off, d_off)."""
        uploaded, blobs = {}, []
        for k, dev in enumerate(self.devices):
            with on_device(dev):
                if dev not in uploaded:
                    uploaded[dev] = subblock._upload_together(tables, dev)
                blobs.append(subblock.encode_rows(
                    qual_t[k], keep[k], seq[k], lens[k], uploaded[dev],
                    *args))
        return blobs

    def lane_ranges(self, S: int) -> list:
        """(device, s0, s1) of each shard that decodes lanes s0 .. s1 - 1."""
        return [(dev, s0, s1) for dev, (s0, s1)
                in zip(self.devices, _split(S, self.n_data)) if s1 > s0]

    def decode_walk(self, p, cfg: CodecConfig, wires: tuple) -> list:
        """The restored (2, rows, L) planes of each shard's lanes of a
        parsed sub-block (subblock.decode_lanes), on its device, in row
        order. wires: subblock.decode_wires, the code lengths that each
        shard uploads and builds its walk tables from on its own device."""
        out = []
        for dev, s0, s1 in self.lane_ranges(p.q_sub.shape[0]):
            with on_device(dev):
                out.append(subblock.decode_lanes(p, cfg, dev, s0, s1, wires))
        return out
