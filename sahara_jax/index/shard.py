"""Index sharding by text interval: references beyond a single device's
address/HBM budget (genome-scale references, SURVEY.md §5.7).

The single-index device path addresses text with int32 (< 2^31 positions).
Larger references are split into *shards*: each shard is a complete
BiFMIndex over a subset of the sequence collection; sequences longer than
the shard budget are split into overlapping windows (overlap >= the
longest expected hit span, so every hit lies wholly inside some window —
the classic context-parallel decomposition of this workload).  Queries
visit every shard; per-shard hits map back through (global seqId, window
offset) and window-duplicate hits are merged.

Scaling modes:
- single chip: shards are searched sequentially, swapping occ tables
  through HBM (engine/driver.py::search_queries_sharded);
- multi chip: one shard per device, queries replicated, results
  concatenated (parallel/interval.py) — the CP-analogue mesh axis.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from sahara_jax.index.build import build_bifmindex
from sahara_jax.index.fmindex import BiFMIndex, save_index, load_index as _load_plain

SHARD_FORMAT_VERSION = 2

# default per-shard text budget: stay well under 2^31 addressable positions
# (sentinel padding included); large enough that chr-scale sequences never
# split in practice
DEFAULT_MAX_CHARS = 2**31 - 2**27
DEFAULT_WINDOW_OVERLAP = 4096


@dataclasses.dataclass
class ShardedIndex:
    """A list of complete sub-indexes + the local->global sequence maps."""

    shards: list[BiFMIndex]
    seq_gid: list[np.ndarray]  # per shard: global sequence id per local seq
    seq_off: list[np.ndarray]  # per shard: text offset of the local window
    num_seqs: int
    windowed_gids: np.ndarray  # global ids of sequences that were split

    @property
    def sigma(self) -> int:
        return self.shards[0].sigma

    @property
    def num_shards(self) -> int:
        return len(self.shards)


def plan_shards(
    seq_lens: list[int], max_chars: int, overlap: int
) -> list[list[tuple[int, int, int]]]:
    """Greedy packing of sequences into shards.

    Returns per shard a list of (global_seq_id, window_start, window_len);
    over-long sequences are split into max_chars windows overlapping by
    ``overlap``."""
    pieces: list[tuple[int, int, int]] = []
    for gid, ln in enumerate(seq_lens):
        if ln <= max_chars:
            pieces.append((gid, 0, ln))
        else:
            start = 0
            while start < ln:
                end = min(start + max_chars, ln)
                pieces.append((gid, start, end - start))
                if end == ln:
                    break
                start = end - overlap
    shards: list[list[tuple[int, int, int]]] = [[]]
    used = 0
    for piece in pieces:
        if used and used + piece[2] > max_chars:
            shards.append([])
            used = 0
        shards[-1].append(piece)
        used += piece[2]
    return shards


def build_sharded_bifmindex(
    seqs: list[np.ndarray],
    sigma: int,
    alphabet_name: str,
    rate: int = 16,
    max_chars: int = DEFAULT_MAX_CHARS,
    overlap: int = DEFAULT_WINDOW_OVERLAP,
    threads: int = 1,
) -> BiFMIndex | ShardedIndex:
    """Build a single BiFMIndex when everything fits, else a ShardedIndex.

    ``threads`` parallelizes the build: shards build concurrently on a
    thread pool (SA-IS + the NumPy occ packing release the GIL), with each
    shard additionally overlapping its forward/reverse suffix sorts when
    the budget allows (the reference builds with ``threadNbr=10``,
    rbi-index-dna4.cpp:75 — this is its host-side analogue here)."""
    lens = [len(s) for s in seqs]
    plan = plan_shards(lens, max_chars, overlap)
    if len(plan) == 1 and all(w == 0 for _, w, _ in plan[0]):
        return build_bifmindex(seqs, sigma, alphabet_name, rate=rate, threads=threads)
    windowed = sorted({gid for shard in plan for gid, w, _ in shard if w > 0})

    def _one(shard):
        sub = [np.asarray(seqs[gid][w : w + ln], dtype=np.uint8) for gid, w, ln in shard]
        inner = 2 if threads > len(plan) else 1
        return build_bifmindex(sub, sigma, alphabet_name, rate=rate, threads=inner)

    if threads >= 2 and len(plan) > 1:
        from concurrent.futures import ThreadPoolExecutor

        outer = min(len(plan), max(1, threads if threads <= len(plan) else (threads + 1) // 2))
        with ThreadPoolExecutor(outer) as ex:
            shards = list(ex.map(_one, plan))
    else:
        shards = [_one(shard) for shard in plan]
    gids = [np.array([gid for gid, _, _ in shard], dtype=np.int64) for shard in plan]
    offs = [np.array([w for _, w, _ in shard], dtype=np.int64) for shard in plan]
    return ShardedIndex(
        shards=shards,
        seq_gid=gids,
        seq_off=offs,
        num_seqs=len(seqs),
        windowed_gids=np.array(windowed, dtype=np.int64),
    )


def save_sharded(path: str, sh: ShardedIndex) -> None:
    import io

    arrays: dict[str, np.ndarray] = {}
    for i, shard in enumerate(sh.shards):
        buf = io.BytesIO()
        save_index(buf, shard)
        arrays[f"shard{i}"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
        arrays[f"gid{i}"] = sh.seq_gid[i]
        arrays[f"off{i}"] = sh.seq_off[i]
    meta = {
        "format_version": SHARD_FORMAT_VERSION,
        "kind": "sharded",
        "sigma": sh.sigma,
        "num_shards": sh.num_shards,
        "num_seqs": sh.num_seqs,
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    arrays["windowed_gids"] = sh.windowed_gids
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_any_index(path: str):
    """Load either a plain (v1) or sharded (v2) index file (via FastNpz —
    NumPy's own npz member streaming is pathologically slow on multi-GB
    members, see fmindex.FastNpz)."""
    import io

    from sahara_jax.index.fmindex import FastNpz

    with FastNpz(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        # dispatch on `kind`: plain indexes ("bi"/"uni") carry their own
        # format_version namespace (fmindex.py), sharded containers theirs
        if meta.get("kind") == "sharded":
            if meta["format_version"] != SHARD_FORMAT_VERSION:
                raise ValueError(
                    f"unknown file format version for sharded index: {meta['format_version']}"
                )
            shards, gids, offs = [], [], []
            for i in range(meta["num_shards"]):
                shards.append(_load_plain(io.BytesIO(bytes(data[f"shard{i}"]))))
                gids.append(data[f"gid{i}"])
                offs.append(data[f"off{i}"])
            return ShardedIndex(
                shards=shards,
                seq_gid=gids,
                seq_off=offs,
                num_seqs=meta["num_seqs"],
                windowed_gids=data["windowed_gids"],
            )
    return _load_plain(path)


def peek_index_kind(path: str) -> str:
    """Cheap sniff of an index file's container kind ('sharded' or the
    plain kinds 'bi'/'uni') — reads only the JSON meta member."""
    from sahara_jax.index.fmindex import FastNpz

    with FastNpz(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
    return meta.get("kind", "plain")
