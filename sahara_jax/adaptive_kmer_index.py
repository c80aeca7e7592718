"""AdaptiveKmerIndex: FM-index over dense kmer alphabets.

Equivalent of the reference's only reusable application class
(/root/reference/src/sahara/AdaptiveKmerIndex.h:14-43, .cpp:27-106): an
FM-index whose alphabet is the dense id space of the reference's kmer
sketch, with the alphabet size bucketed ({3,4,5,6,16,32,64,128},
AdaptiveKmerIndex.cpp:31-41), exact search + locate, and a versioned
save/load of config + index (file format version 0x01,
kmer-index.cpp:152-155)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.exact import exact_search
from sahara_jax.engine.locate import locate
from sahara_jax.index.build import build_fmindex
from sahara_jax.index.fmindex import FMIndex
from sahara_jax.utils.errors import SaharaError

FILE_FORMAT_VERSION = 0x01
_SIGMA_BUCKETS = (3, 4, 5, 6, 16, 32, 64, 128)


def _bucket_sigma(largest_value: int) -> int:
    for b in _SIGMA_BUCKETS:
        if largest_value < b:
            return b
    # user-facing error (the reference throws its error_fmt for the same
    # >128 limit, AdaptiveKmerIndex.cpp) so the CLI exits with the clean
    # formatted message instead of a traceback
    raise SaharaError(f"text with values above 128 is not allowed (requested largest value: {largest_value})")


@dataclasses.dataclass
class KmerConfig:
    mode: str  # 'winnowing' | 'mod'
    kmer_len: int
    window: int  # winnowing only
    mod_exp: int  # mod only
    largest_value: int


class AdaptiveKmerIndex:
    def __init__(self, config: KmerConfig, kmer_seqs: list[np.ndarray] | None = None, host_index: FMIndex | None = None):
        self.config = config
        self.sigma = _bucket_sigma(config.largest_value)
        if host_index is None:
            if kmer_seqs is None:
                raise ValueError("need kmer sequences or a prebuilt index")
            host_index = build_fmindex(
                [np.asarray(s, dtype=np.uint8) for s in kmer_seqs],
                self.sigma,
                f"kmer{self.sigma}",
                rate=16,
            )
        self.host_index = host_index
        self._device: DeviceIndex | None = None

    @property
    def device_index(self) -> DeviceIndex:
        if self._device is None:
            self._device = DeviceIndex.from_host(self.host_index)
        return self._device

    def search(self, queries: list[np.ndarray]) -> list[list[tuple[int, int]]]:
        """Exact search + locate per query (AdaptiveKmerIndex.cpp:98-106).
        Returns [(refId, refPos), ...] per query."""
        from sahara_jax.engine.device import pad_queries

        if not queries:
            return []
        out: list[list[tuple[int, int]]] = [[] for _ in queries]
        q, lens = pad_queries([np.asarray(x, dtype=np.int32) for x in queries])
        dev = self.device_index
        lb, sz = exact_search(dev, np.asarray(q, dtype=np.int32), np.asarray(lens, dtype=np.int32))
        lb, sz = np.asarray(lb), np.asarray(sz)
        total = int(sz.sum())
        if total == 0:
            return out
        cap = 8
        while cap < total:
            cap *= 2
        src, seq_id, pos, valid, _ = locate(dev, lb.astype(np.int32), sz.astype(np.int32), cap)
        src, seq_id, pos, valid = map(np.asarray, (src, seq_id, pos, valid))
        for s, sid, p in zip(src[valid], seq_id[valid], pos[valid]):
            out[int(s)].append((int(sid), int(p)))
        return out

    def save(self, path: str, uniq: dict[int, int]) -> None:
        """Versioned container: config + index arrays + dense kmer map
        (kmer-index.cpp:149-156)."""
        from sahara_jax.index.fmindex import save_index

        meta = dataclasses.asdict(self.config)
        meta["file_format_version"] = FILE_FORMAT_VERSION
        uniq_keys = np.fromiter(uniq.keys(), dtype=np.uint64, count=len(uniq))
        uniq_vals = np.fromiter(uniq.values(), dtype=np.int64, count=len(uniq))
        import io

        buf = io.BytesIO()
        save_index(buf, self.host_index)
        with open(path, "wb") as fh:
            np.savez(
                fh,
                kmer_meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                inner_index=np.frombuffer(buf.getvalue(), dtype=np.uint8),
                uniq_keys=uniq_keys,
                uniq_vals=uniq_vals,
            )

    @staticmethod
    def load(path: str) -> tuple["AdaptiveKmerIndex", dict[int, int]]:
        import io

        from sahara_jax.index.fmindex import FastNpz, load_index

        with FastNpz(path) as data:
            meta = json.loads(bytes(data["kmer_meta"]).decode())
            version = meta.pop("file_format_version")
            if version != FILE_FORMAT_VERSION:
                raise ValueError(f"unknown file format version for index: {version}")
            inner = load_index(io.BytesIO(bytes(data["inner_index"])))
            uniq = dict(zip(data["uniq_keys"].tolist(), data["uniq_vals"].tolist()))
        return AdaptiveKmerIndex(KmerConfig(**meta), host_index=inner), uniq
