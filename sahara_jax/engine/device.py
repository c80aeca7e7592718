"""Device-resident view of an FM-index (jnp arrays in HBM).

The index arrays are replicated per device; only query batches are sharded
(SURVEY.md §2.3).  Static metadata (sigma, rate, n) rides as pytree aux data
so jitted engine code specializes on it.
"""

from __future__ import annotations

import dataclasses
import os as _os

import jax
import jax.numpy as jnp
import numpy as np

from sahara_jax.index.fmindex import BiFMIndex, FMIndex


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """Index arrays in HBM.  ``occ`` is the forward occ table with the
    reversed-text occ table stacked below it for bidirectional indexes;
    both tables are stored in the *folded* wide-row layout
    (int32[ceil(W/fold) (+ same for rev), 2*sigma*fold] — see
    engine.rank.fold_occ_rows for why).  ``rev_rows`` = the padded word
    count of the forward table (the word offset where the reversed table
    starts), 0 for unidirectional indexes.  The stacking lets the scheme
    stepper pick the extension direction per state with plain index
    arithmetic — one gather stream regardless of direction mix."""

    occ: jax.Array  # int32[Wf or 2*Wf, 2*sigma*fold]
    c_arr: jax.Array  # int32[sigma+1]
    sampled: jax.Array  # int32[ceil(W/fold_s), 2*fold_s]
    sample_seq: jax.Array  # int32[S]
    sample_pos: jax.Array  # int32[S]
    sigma: int = dataclasses.field(metadata=dict(static=True))
    rate: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    rev_rows: int = dataclasses.field(default=0, metadata=dict(static=True))
    # 1 + highest symbol rank actually present in the text (0 = unknown ->
    # assume all of sigma).  When the text has no N, the scheme stepper
    # enumerates 2 fewer transition branches per state (match/sub + del on a
    # symbol with zero occurrences can never extend), shrinking the candidate
    # scatter and flag math by ~18% with bit-identical hit sets.
    sigma_live: int = dataclasses.field(default=0, metadata=dict(static=True))
    # words per folded occ row / sampled row (1 = planar legacy layout)
    fold: int = dataclasses.field(default=1, metadata=dict(static=True))
    fold_s: int = dataclasses.field(default=1, metadata=dict(static=True))
    # packed indexed text (index/textstore.py) + per-sequence start offsets
    # in the padded layout — present iff the host index carries a text store;
    # consumed by the seed-and-verify engine (engine/seedverify.py)
    text4: jax.Array | None = None  # int32[ceil(n/8)]
    seq_starts: jax.Array | None = None  # int32[num_seqs]
    # j-mer prefix lookup (index/jmer.py): (lo | hi) interval per length-
    # lut_j DNA pattern, int32[2 * 4^lut_j]; lets the seed scan skip its
    # first lut_j steps.  0 = absent.
    lut: jax.Array | None = None
    lut_j: int = dataclasses.field(default=0, metadata=dict(static=True))
    # full suffix array (absolute padded-text positions, int32[n]) when the
    # host index carries the sa_abs sidecar: locate is ONE gather instead
    # of a rate-trip LF walk (engine/locate.py::lf_walk fast path)
    sa_full: jax.Array | None = None
    # MirroredBiFMIndex optimization (index/fmindex.py::BiFMIndex): the
    # collection is reverse-closed, so the reverse cursor is a forward-
    # index interval and right extensions rank the forward table — no rev
    # table stacked, half the occ HBM
    mirrored: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @property
    def bidirectional(self) -> bool:
        return self.rev_rows > 0 or self.mirrored

    @property
    def rev_word_off(self) -> int:
        """Word offset of the table that serves reverse-side ranks: the
        stacked rev table, or the forward table itself when mirrored."""
        return 0 if self.mirrored else self.rev_rows

    @staticmethod
    def from_host(
        index: FMIndex, device=None, sharding=None, build_lut: bool = True,
        include_rev: bool = True,
    ) -> "DeviceIndex":
        """``build_lut=False`` skips the j-mer seed table (~1s host build +
        8MB HBM) for workloads that will never run the SV engine.

        ``include_rev=False`` drops the reversed-text occ table from the
        upload (rev_rows=0: the view is NOT bidirectional and scheme
        engines will refuse it).  The seed-and-verify engine only ever
        ranks the FORWARD table (seed scan, LF-walk locate) and verifies
        against the packed text, so an SV-only view is ~35% smaller —
        at interval-shard scale that lets multiple shards stay HBM-
        resident instead of swapping multi-GB tables through the host
        link on every pass."""
        if index.n >= 2**31:
            raise ValueError(
                "single-device index limited to text < 2^31 positions; build an "
                "interval-sharded index instead (sahara_jax.index.shard."
                "build_sharded_bifmindex / `index --max_shard_mb`) and search it "
                "with search_queries_sharded or parallel.interval"
            )

        def put(x):
            if sharding is not None:
                return jax.device_put(x, sharding)
            return jax.device_put(x, device)

        from sahara_jax.engine.rank import fold_occ_rows, pick_fold

        fold = pick_fold(index.sigma)
        w = index.occ.shape[0]
        wp = -(-w // fold) * fold  # padded word count (shared fwd/rev offset)
        mirrored = bool(getattr(index, "mirrored", False))
        if isinstance(index, BiFMIndex) and index.occ_rev is not None and not mirrored and include_rev:
            occ = put(
                np.concatenate(
                    [
                        fold_occ_rows(index.occ, fold, wp),
                        fold_occ_rows(index.occ_rev, fold, wp),
                    ],
                    axis=0,
                )
            )
            rev_rows = wp
        else:
            occ = put(fold_occ_rows(index.occ, fold, wp))
            rev_rows = 0
        fold_s = 64  # sampled rows are [W, 2] -> 128-lane folded rows
        # symbol counts from the C-array: count(s) = C[s+1] - C[s]
        c_host = np.asarray(index.c_arr, dtype=np.int64)
        counts = np.diff(np.append(c_host[: index.sigma], index.n))
        present = np.nonzero(counts[1:] > 0)[0]  # symbol ranks 1.. present
        sigma_live = int(present[-1]) + 2 if len(present) else 2
        lut = None
        lut_j = 0
        if build_lut and index.text4 is not None and index.sigma <= 6:
            # seed-scan skip table for the SV engine (index/jmer.py)
            from sahara_jax.index.jmer import build_jmer_lut, pick_lut_j

            lut_j = pick_lut_j(index.n)
            lut = put(
                build_jmer_lut(np.asarray(index.occ), c_host, index.sigma, index.n, lut_j)
            )
        return DeviceIndex(
            occ=occ,
            c_arr=put(np.asarray(index.c_arr, dtype=np.int32)),
            sampled=put(fold_occ_rows(index.sampled, fold_s)),
            sample_seq=put(np.asarray(index.sample_seq)),
            sample_pos=put(np.asarray(index.sample_pos)),
            sigma=int(index.sigma),
            rate=int(index.rate),
            n=int(index.n),
            rev_rows=rev_rows,
            sigma_live=min(sigma_live, int(index.sigma)),
            fold=fold,
            fold_s=fold_s,
            text4=put(np.asarray(index.text4, dtype=np.int32)) if index.text4 is not None else None,
            seq_starts=(
                put(index.seq_starts().astype(np.int32)) if index.text4 is not None else None
            ),
            lut=lut,
            lut_j=lut_j,
            sa_full=(
                put(np.asarray(index.sa_abs, dtype=np.int32))
                if getattr(index, "sa_abs", None) is not None
                and index.text4 is not None
                and _os.environ.get("SAHARA_NO_FULL_SA", "") != "1"
                else None
            ),
            mirrored=mirrored,
        )


def pad_queries(queries: list[np.ndarray], length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Left-aligned pad to a rectangle. Returns (int32[B, L], lengths int32[B])."""
    if length is None:
        length = max((len(q) for q in queries), default=0)
    out = np.zeros((len(queries), length), dtype=np.int32)
    lens = np.zeros(len(queries), dtype=np.int32)
    for i, q in enumerate(queries):
        out[i, : len(q)] = q
        lens[i] = len(q)
    return out, lens


def queries_to_device(queries: list[np.ndarray]) -> tuple[jax.Array, jax.Array]:
    q, lens = pad_queries(queries)
    return jnp.asarray(q), jnp.asarray(lens)
