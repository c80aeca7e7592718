"""`index` / `uni-index` / `rbi-index` / `rbi-index-dna4` subcommands.

Mirrors /root/reference/src/sahara/index.cpp, uni-index.cpp, rbi-index.cpp,
rbi-index-dna4.cpp: FASTA -> rank arrays -> FM/BiFM index -> versioned index
file next to the input."""

from __future__ import annotations

import numpy as np

from sahara_jax.alphabet import D_DNA4, D_DNA5, DR_DNA4, DR_DNA5
from sahara_jax.cli.common import Timings, load_reference_ranked
from sahara_jax.index.build import build_bifmindex, build_fmindex
from sahara_jax.index.fmindex import save_index
from sahara_jax.utils.errors import SaharaError


def _build_and_save(args, alphabet, *, suffix: str, bidirectional: bool, unknown_policy: str, mirrored: bool = False):
    print(f"constructing an index for {args.input}")
    timing = Timings()
    rng = np.random.default_rng(args.seed if hasattr(args, "seed") else 0)
    seqs = load_reference_ranked(
        args.input, alphabet, ignore_unknown=args.ignore_unknown, unknown_policy=unknown_policy, rng=rng
    )
    if not seqs:
        raise SaharaError(f"reference file {args.input} was empty - abort")
    total = sum(len(s) for s in seqs)
    print("config:")
    print(f"  file: {args.input}")
    print(f"  sigma: {alphabet.sigma}")
    print(f"  references: {len(seqs)}")
    print(f"  totalSize: {total}")
    timing.mark("ld queries")

    if mirrored:
        # MirroredBiFMIndex analogue (rbi-index.cpp:76): the strand-reduced
        # alphabet makes revcomp == reverse, so appending each sequence's
        # reverse lets a single forward search find both strands; mirror
        # copies get seqIds [m, 2m).
        seqs = seqs + [s[::-1].copy() for s in seqs]
    import os as _os

    threads = getattr(args, "threads", 0) or (_os.cpu_count() or 1)
    max_shard_mb = getattr(args, "max_shard_mb", 0)
    if bidirectional and (max_shard_mb or total >= 2**31 - 2**27):
        # beyond-int32 references: interval-sharded container (configs[3])
        from sahara_jax.index.shard import DEFAULT_MAX_CHARS, ShardedIndex, build_sharded_bifmindex, save_sharded

        max_chars = int(max_shard_mb * 1_000_000) if max_shard_mb else DEFAULT_MAX_CHARS
        index = build_sharded_bifmindex(
            seqs, alphabet.sigma, alphabet.name, rate=16, max_chars=max_chars, threads=threads
        )
        timing.mark("index creation")
        out_path = str(args.input) + suffix
        if isinstance(index, ShardedIndex):
            print(f"  shards: {index.num_shards}")
            save_sharded(out_path, index)
        else:
            save_index(out_path, index)
        timing.mark("saving to disk")
        timing.print_stats()
        return out_path
    if bidirectional:
        # rbi collections are reverse-closed (mirrors appended above), so
        # the MirroredBiFMIndex optimization drops the reversed-text table
        # entirely (rbi-index.cpp:76 analogue): half the occ footprint +
        # half the suffix-sort work
        index = build_bifmindex(
            seqs, alphabet.sigma, alphabet.name, rate=16, threads=threads, mirrored=mirrored
        )
    else:
        index = build_fmindex(seqs, alphabet.sigma, alphabet.name, rate=16)
    timing.mark("index creation")

    out_path = str(args.input) + suffix
    save_index(out_path, index)
    timing.mark("saving to disk")
    timing.print_stats()
    return out_path


def cmd_index(args):
    if args.dna4:
        _build_and_save(args, D_DNA4, suffix=".dna4.idx", bidirectional=True, unknown_policy="random-acgt")
    else:
        _build_and_save(args, D_DNA5, suffix=".idx", bidirectional=True, unknown_policy="N")


def cmd_uni_index(args):
    _build_and_save(args, D_DNA5, suffix=".single.idx", bidirectional=False, unknown_policy="N")


def cmd_rbi_index(args):
    _build_and_save(args, DR_DNA5, suffix=".rbi.idx", bidirectional=True, unknown_policy="N", mirrored=True)


def cmd_rbi_index_dna4(args):
    _build_and_save(args, DR_DNA4, suffix=".rbi4.idx", bidirectional=True, unknown_policy="random-12", mirrored=True)


def register(subparsers):
    p = subparsers.add_parser("index", help="construct an index over a given input file")
    p.add_argument("input", help="path to a fasta file")
    p.add_argument("--ignore_unknown", action="store_true",
                   help="ignores unknown nuclioteds in input data and replaces them with 'N'")
    p.add_argument("--dna4", action="store_true",
                   help="use dna 4 alphabet, replace 'N' with random ACG or T")
    p.add_argument("--max_shard_mb", type=float, default=0,
                   help="split the index into text-interval shards of at most this many MB "
                        "(0 = automatic: shard only when the text exceeds the int32 device limit)")
    p.add_argument("--threads", type=int, default=0,
                   help="build threads (0 = all cores): shards build concurrently; "
                        "fwd/rev suffix sorts overlap within a shard")
    p.set_defaults(func=cmd_index)

    p = subparsers.add_parser("uni-index", help="construct an unidirectional index over a given input file")
    p.add_argument("input")
    p.add_argument("--ignore_unknown", action="store_true")
    p.set_defaults(func=cmd_uni_index)

    p = subparsers.add_parser("rbi-index", help="construct an index over a given input file")
    p.add_argument("input")
    p.add_argument("--ignore_unknown", action="store_true")
    p.set_defaults(func=cmd_rbi_index)

    p = subparsers.add_parser("rbi-index-dna4", help="construct an index over a given input file")
    p.add_argument("input")
    p.add_argument("--ignore_unknown", action="store_true")
    p.set_defaults(func=cmd_rbi_index_dna4)
