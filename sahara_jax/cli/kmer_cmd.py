"""`kmer-index` / `kmer-search` subcommands.

Mirrors /root/reference/src/sahara/kmer-index.cpp:60-168 and
kmer-search.cpp:82-250: sketch the reference into kmer space (winnowing
minimizers or mod-mers), densify hashes via the uniq map, FM-index over the
dense kmer alphabet; queries kmerized with the index's stored config,
dropped when any kmer is unseen or fewer than 6 kmers survive; exact search
in kmer space."""

from __future__ import annotations

import os

import numpy as np

from sahara_jax.adaptive_kmer_index import AdaptiveKmerIndex, KmerConfig
from sahara_jax.alphabet import D_DNA5
from sahara_jax.cli.common import Timings, load_reference_ranked, write_hits
from sahara_jax.kmer import kmerize
from sahara_jax.utils.errors import SaharaError


def cmd_kmer_index(args):
    alphabet = D_DNA5
    print(f"constructing an index for {args.input}")
    timing = Timings()

    seqs = load_reference_ranked(args.input, alphabet, ignore_unknown=args.ignore_unknown, unknown_policy="N")
    uniq: dict[int, int] = {}
    ref_kmer: list[np.ndarray] = []
    total = 0
    kmer_len_total = 0
    for ranks in seqs:
        total += len(ranks)
        values = kmerize(ranks, mode=args.kmer_mode, k=args.kmer, window=args.window, mod_exp=args.mod)
        dense = np.empty(len(values), dtype=np.int64)
        for i, v in enumerate(values.tolist()):
            d = uniq.get(v)
            if d is None:
                d = len(uniq) + 1
                uniq[v] = d
            dense[i] = d
        ref_kmer.append(dense)
        kmer_len_total += len(dense)

    print("config:")
    print(f"  file:            {args.input}")
    print(f"  references:      {len(ref_kmer):>10}")
    print(f"  totalSize:       {total:>10}")
    if args.kmer_mode == "winnowing":
        print(f"  kmerMode:        {'winnowing':>10}")
        print(f"  windowSize       {args.window:>10}")
    else:
        print(f"  kmerMode:        {'mod':>10}")
        print(f"  modFactor        {f'2^{args.mod}':>10}")
    print(f"  different kmers: {len(uniq):>10}")
    print(f"  kmer-seq-len:    {kmer_len_total:>10}")
    timing.mark("ld queries")

    config = KmerConfig(
        mode=args.kmer_mode, kmer_len=args.kmer, window=args.window, mod_exp=args.mod,
        largest_value=len(uniq),
    )
    index = AdaptiveKmerIndex(config, kmer_seqs=ref_kmer)
    timing.mark("index creation")

    index.save(str(args.input) + ".kmer.idx", uniq)
    timing.mark("saving to disk")
    timing.print_stats()


def cmd_kmer_search(args):
    alphabet = D_DNA5
    timing = Timings()

    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  generator:           {args.generator}")
    print(f"  dynamic expansion:   {args.dynamic_generator}")
    print(f"  reverse complements: {not args.no_reverse}")
    print(f"  search mode:         {args.search_mode}")
    print(f"  max hits:            {args.max_hits}")
    print(f"  output path:         {args.output}")

    if not os.path.exists(args.index):
        raise SaharaError(f"no valid index path at {args.index}")
    index, uniq = AdaptiveKmerIndex.load(args.index)
    config = index.config
    print(f"  kmer mode:           {config.mode}")
    if config.mode == "winnowing":
        print(f"  window:           {config.window}")
    else:
        print(f"  kmer mod:            {config.mod_exp}")
    timing.mark("ld index")

    # kmerize queries with the index's config; drop queries with unseen
    # kmers or < 6 kmers; add the *reversed* kmer sequence unless
    # --no-reverse (kmer-search.cpp:160-203)
    from sahara_jax.io.fasta import read_fasta

    queries: list[np.ndarray] = []
    skipped = 0
    kmer_total = 0
    smallest, longest = None, 0
    for record in read_fasta(args.query):
        ranks = alphabet.char_to_rank(record.seq)
        if (pos := alphabet.verify_rank(ranks)) is not None:
            raise SaharaError(
                f"query '{record.id}' has invalid character at position {pos}"
            )
        values = kmerize(ranks, mode=config.mode, k=config.kmer_len, window=config.window, mod_exp=config.mod_exp)
        dense = []
        ok = True
        for v in values.tolist():
            d = uniq.get(v)
            if d is None:
                ok = False
                break
            dense.append(d)
        if not ok:
            continue
        if len(dense) >= 6:
            arr = np.asarray(dense, dtype=np.int64)
            kmer_total += len(arr)
            smallest = len(arr) if smallest is None else min(smallest, len(arr))
            longest = max(longest, len(arr))
            queries.append(arr)
            if not args.no_reverse:
                queries.append(arr[::-1].copy())
        else:
            skipped += 1 + (0 if args.no_reverse else 1)

    print(f"skipped {skipped} of {skipped + len(queries)} queries")
    if queries:
        print(f"avg kmer len: {kmer_total * 1.0 / len(queries)}")
        print(f"smallest/longest kmer len: {smallest}/{longest}")
    print(f"index uniq {len(uniq)}")
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    fwd = len(queries) // (1 if args.no_reverse else 2)
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {len(queries) - fwd}")
    timing.mark("ld queries")

    per_query = index.search(queries)
    rows = []
    for qid, hits in enumerate(per_query):
        for sid, pos in hits:
            rows.append((qid, sid, pos))
    timing.mark("search")

    n = write_hits(args.output, rows)
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def register(subparsers):
    p = subparsers.add_parser("kmer-index", help="construct an index over a given input file")
    p.add_argument("input")
    p.add_argument("--kmer", type=int, default=1, help="splitting the text into kmers")
    p.add_argument("--kmer_mode", choices=["winnowing", "mod"], default="winnowing",
                   help="valid modes are: winnowing and mod")
    p.add_argument("--window", type=int, default=1,
                   help="using windows (only valid for '--kmer_mode winnowing' mode")
    p.add_argument("--mod", type=int, default=4,
                   help="take every 'mod' element (only valid for '--kmer_mode mod' mode")
    p.add_argument("--ignore_unknown", action="store_true")
    p.set_defaults(func=cmd_kmer_index)

    p = subparsers.add_parser("kmer-search", help="search for a given pattern")
    p.add_argument("--query", required=True, help="path to a query file")
    p.add_argument("--index", required=True, help="path to the index file")
    p.add_argument("--output", default="sahara-output.txt", help="output path")
    p.add_argument("--generator", default="h2-k2")
    p.add_argument("--dynamic_generator", action="store_true")
    p.add_argument("--no-reverse", action="store_true")
    p.add_argument("--search_mode", choices=["all", "besthits"], default="all")
    p.add_argument("--max_hits", type=int, default=0)
    p.set_defaults(func=cmd_kmer_search)
