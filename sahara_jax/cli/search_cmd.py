"""`search` / `uni-search` / `rbi-search` / `rbi-search-dna4` subcommands.

Mirrors /root/reference/src/sahara/search.cpp:29-291, uni-search.cpp,
rbi-search.cpp, rbi-search-dna4.cpp: flag surface, config echo, search,
locate, `queryId seqId pos` output, stats block."""

from __future__ import annotations

import os

import numpy as np

from sahara_jax.alphabet import DR_DNA4, DR_DNA5, by_sigma
from sahara_jax.cli.common import Timings, load_queries_ranked, write_hits
from sahara_jax.engine.device import DeviceIndex, pad_queries
from sahara_jax.engine.driver import _locate_hits, search_queries
from sahara_jax.engine.exact import exact_search
from sahara_jax.index.fmindex import load_index, peek_sigma
from sahara_jax.utils.errors import SaharaError


def _local_mesh(n_req: int, multihost: bool = False):
    """A data mesh over THIS PROCESS's devices, or None for single-device.

    ``n_req`` = 0 auto-selects: all local devices when the default
    platform is an accelerator (so a plain `sahara search` on a four-GPU
    host uses all four), 1 on CPU (virtual host devices give no speedup —
    pass --devices N explicitly to exercise the mesh path on CPU).

    The mesh is always built from ``jax.local_devices()`` — under
    ``jax.distributed`` (``--mh_*``), ``jax.devices()`` is the GLOBAL list
    and would hand non-zero ranks another host's chips.  In multihost runs
    the local mesh is opt-in (``--devices N``): each host then runs its
    query slice data-parallel over its own chips as an independent
    addressable-only computation."""
    import jax

    devs = jax.local_devices()
    if n_req == 0:
        if multihost:
            return None  # opt-in only (see docstring)
        n_use = len(devs) if devs and devs[0].platform != "cpu" else 1
    else:
        n_use = n_req
    if n_use <= 1:
        return None
    if len(devs) < n_use:
        raise SaharaError(f"--devices {n_use} requested but only {len(devs)} local devices")
    from sahara_jax.parallel.mesh import data_mesh

    return data_mesh(devices=devs[:n_use])


def _try_stream_search(args, alphabet) -> bool:
    """Large-file fast path: stream FASTA blocks through the engine with
    parse (reader thread) and hit formatting/writing (writer thread)
    overlapping the device search, and hits appended per block.

    Correct because blocks arrive in ascending queryId order and every
    per-query contract (canonical sort, dedup, besthits, max_hits) is
    local to a query: concatenating per-block canonical outputs IS the
    canonical global output.

    Engages only for simple uniform 2-line FASTA files over 128MB
    (SAHARA_STREAM=1/0 forces/disables), single-index, single-process.
    Returns False to fall back to the buffered path."""
    import os as _os
    import queue as queue_mod
    import threading

    if getattr(args, "mh_num_processes", 0) and args.mh_num_processes > 1:
        return False
    force = _os.environ.get("SAHARA_STREAM", "")
    if force == "0":
        return False
    try:
        fsize = _os.path.getsize(args.query)
    except OSError:
        return False
    if force != "1" and fsize < (128 << 20):
        return False
    from sahara_jax.index.shard import peek_index_kind
    from sahara_jax.io.fasta import NotSimpleFasta, iter_fasta_seq_matrix_blocks

    if not _os.path.exists(args.index):
        raise SaharaError(f"no valid index path at {args.index}")
    if peek_index_kind(args.index) == "sharded":
        return False  # the sharded driver has its own (resident) fast path
    gen = iter_fasta_seq_matrix_blocks(args.query)
    try:
        first_mat = next(gen)
    except (NotSimpleFasta, StopIteration):
        return False

    timing = Timings()
    timing.mark("ld queries")
    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  generator:           {args.generator}")
    print(f"  dynamic expansion:   {args.dynamic_generator}")
    print(f"  allowed errors:      {args.errors}")
    print(f"  reverse complements: {not args.no_reverse}")
    print(f"  search mode:         {args.search_mode}")
    print(f"  max hits:            {args.max_hits}")
    print(f"  output path:         {args.output}")
    print("  streaming:           True")

    host = load_index(args.index)
    mesh = _local_mesh(getattr(args, "devices", 0))
    if mesh is not None:
        from sahara_jax.parallel.mesh import replicate_index

        print(f"devices:             {mesh.devices.size}")
        index = replicate_index(host, mesh)
    else:
        index = DeviceIndex.from_host(host)
    timing.mark("ld index")

    from sahara_jax.alphabet import INVALID_RANK
    from sahara_jax.cli.common import format_hit_block

    add_rc = not args.no_reverse
    per_read = 2 if add_rc else 1
    limit = args.limit_queries or 0
    stop = threading.Event()
    blocks: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    lines: queue_mod.Queue = queue_mod.Queue(maxsize=4)

    def _rank_block(mat):
        ranks = alphabet.char_to_rank_table[mat]
        bad_r, bad_c = np.nonzero(ranks == INVALID_RANK)
        if len(bad_r):
            i, pos = int(bad_r[0]), int(bad_c[0])
            ch = int(mat[i, pos])
            raise SaharaError(
                f"query has invalid character at position {pos} '{chr(ch)}'({ch:x})"
            )
        if not add_rc:
            return ranks
        rc = alphabet.complement[ranks[:, ::-1]]
        out = np.empty((2 * len(ranks), ranks.shape[1]), dtype=np.uint8)
        out[0::2] = ranks
        out[1::2] = rc
        return out

    def reader():
        base = 0
        try:
            b0 = _rank_block(first_mat)
            blocks.put((base, b0))
            base += len(b0)
            for mat in gen:
                if stop.is_set() or (limit and base >= limit):
                    break
                b = _rank_block(mat)
                blocks.put((base, b))
                base += len(b)
            blocks.put(None)
        except Exception as e:  # surfaced on the main thread
            blocks.put(e)

    wr_err: list[Exception] = []

    def writer():
        try:
            with open(args.output, "w") as fh:
                while True:
                    item = lines.get()
                    if item is None:
                        return
                    fh.write(item)
        except Exception as e:
            wr_err.append(e)

    rt = threading.Thread(target=reader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    rt.start()
    wt.start()

    edit = args.distance_metric == "lev"
    kw = dict(
        k=args.errors, generator_name=args.generator, edit=edit,
        mode=args.search_mode, max_hits=args.max_hits,
        dynamic=args.dynamic_generator, engine=getattr(args, "engine", "auto"),
    )
    if mesh is not None:
        kw["mesh"] = mesh
    n_queries = 0
    n_hits = 0
    try:
        while True:
            item = blocks.get()
            if item is None:
                break
            if isinstance(item, NotSimpleFasta):
                # mid-file shape violation: abort and re-run buffered
                stop.set()
                lines.put(None)
                wt.join()
                return False
            if isinstance(item, Exception):
                raise item
            base, block = item
            if limit and base + len(block) > limit:
                block = block[: limit - base]
                stop.set()
            if len(block) == 0:
                continue
            res = search_queries(
                index, block,
                query_ids=np.arange(base, base + len(block), dtype=np.int64), **kw,
            )
            n_queries += len(block)
            n_hits += len(res.query_id)
            lines.put(format_hit_block(res.query_id, res.seq_id, res.pos))
            if limit and base + len(block) >= limit:
                stop.set()
                break
    finally:
        stop.set()
        lines.put(None)
        wt.join()
    if wr_err:
        raise wr_err[0]
    fwd = n_queries // per_read
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {n_queries - fwd}")
    timing.mark("search")
    timing.mark("locate")
    timing.mark("result")
    timing.print_stats(n_queries=n_queries, n_hits=n_hits)
    return True


def cmd_search(args):
    sigma = peek_sigma(args.index)
    alphabet = by_sigma(sigma)  # search.cpp:284-287 dispatch
    if _try_stream_search(args, alphabet):
        return
    timing = Timings()

    # multi-host bring-up (an extension; the reference is single-process).
    # Each host searches a contiguous slice of the global query list and
    # emits GLOBAL queryIds.
    multihost = getattr(args, "mh_num_processes", 0) and args.mh_num_processes > 1
    if multihost:
        from sahara_jax.parallel.multihost import initialize

        local_ids = getattr(args, "mh_local_device_ids", None)
        initialize(
            args.mh_coordinator, args.mh_num_processes, args.mh_process_id,
            [int(x) for x in local_ids.split(",")] if local_ids else None,
        )

    queries = load_queries_ranked(args.query, alphabet, add_revcomp=not args.no_reverse)
    if args.limit_queries:
        queries = queries[: args.limit_queries]
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    query_ids = None
    output_path = args.output
    if multihost:
        from sahara_jax.parallel.multihost import host_output_path, host_query_slice

        start, end = host_query_slice(len(queries))
        queries = queries[start:end]
        query_ids = np.arange(start, end, dtype=np.int64)
        output_path = host_output_path(args.output)
    timing.mark("ld queries")

    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  generator:           {args.generator}")
    print(f"  dynamic expansion:   {args.dynamic_generator}")
    print(f"  allowed errors:      {args.errors}")
    print(f"  reverse complements: {not args.no_reverse}")
    print(f"  search mode:         {args.search_mode}")
    print(f"  max hits:            {args.max_hits}")
    print(f"  output path:         {args.output}")
    fwd = len(queries) // (1 if args.no_reverse else 2)
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {len(queries) - fwd}")

    if not os.path.exists(args.index):
        raise SaharaError(f"no valid index path at {args.index}")
    from sahara_jax.index.shard import ShardedIndex, load_any_index

    host = load_any_index(args.index)
    timing.mark("ld index")

    edit = args.distance_metric == "lev"
    kw = dict(
        k=args.errors,
        generator_name=args.generator,
        edit=edit,
        mode=args.search_mode,
        max_hits=args.max_hits,
        dynamic=args.dynamic_generator,
        engine=getattr(args, "engine", "auto"),
        query_ids=query_ids,
        verbose_cb=print,
    )
    if isinstance(host, ShardedIndex):
        from sahara_jax.engine.driver import search_queries_sharded

        result = search_queries_sharded(host, queries, **kw)
    else:
        mesh = _local_mesh(getattr(args, "devices", 0), multihost=bool(multihost))
        if mesh is not None:
            from sahara_jax.parallel.mesh import replicate_index

            print(f"devices:             {mesh.devices.size}")
            index = replicate_index(host, mesh)
            kw["mesh"] = mesh
        else:
            index = DeviceIndex.from_host(host)
        result = search_queries(index, queries, **kw)
    timing.mark("search")
    timing.mark("locate")

    n = write_hits(output_path, (result.query_id, result.seq_id, result.pos))
    if multihost:
        from sahara_jax.parallel.multihost import merge_on_rank_zero

        merge_on_rank_zero(args.output)
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def cmd_uni_search(args):
    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.engine.locate import locate

    alphabet = D_DNA5
    timing = Timings()
    queries = load_queries_ranked(args.query, alphabet, add_revcomp=not args.no_reverse)
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    timing.mark("ld queries")

    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  reverse complements: {not args.no_reverse}")
    print(f"  output path:         {args.output}")
    fwd = len(queries) // (1 if args.no_reverse else 2)
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {len(queries) - fwd}")

    if not os.path.exists(args.index):
        raise SaharaError(f"no valid index path at {args.index}")
    host = load_index(args.index)
    index = DeviceIndex.from_host(host)
    timing.mark("ld index")

    q, lens = pad_queries([np.asarray(x, dtype=np.int32) for x in queries])
    lb, sz = exact_search(index, np.asarray(q, dtype=np.int32), np.asarray(lens, dtype=np.int32))
    lb, sz = np.asarray(lb), np.asarray(sz)
    timing.mark("search")

    total = int(sz.sum())
    rows = []
    if total:
        cap = 8
        while cap < total:
            cap *= 2
        src, seq_id, pos, valid, _ = locate(index, lb.astype(np.int32), sz.astype(np.int32), cap)
        src, seq_id, pos, valid = map(np.asarray, (src, seq_id, pos, valid))
        order = np.argsort(src[valid], kind="stable")
        for s, sid, p in zip(src[valid][order], seq_id[valid][order], pos[valid][order]):
            rows.append((int(s), int(sid), int(p)))
    timing.mark("locate")

    n = write_hits(args.output, rows)
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def _rbi_search(args, alphabet, unknown_random_ranks: bool):
    timing = Timings()
    # rbi queries are NOT revcomp-expanded (rbi-search.cpp:128-132): the dr
    # alphabet is strand-symmetric and the index carries the mirror text.
    if unknown_random_ranks:
        # rbi-search-dna4.cpp:111-116: unknown chars -> random rank 1/2
        from sahara_jax.alphabet import INVALID_RANK
        from sahara_jax.io.fasta import read_fasta

        rng = np.random.default_rng(0)
        queries = []
        for record in read_fasta(args.query):
            ranks = alphabet.char_to_rank(record.seq)
            bad = ranks == INVALID_RANK
            if bad.any():
                ranks = ranks.copy()
                ranks[bad] = rng.integers(1, 3, size=int(bad.sum()))
            queries.append(ranks)
    else:
        queries = load_queries_ranked(args.query, alphabet, add_revcomp=False)
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    timing.mark("ld queries")

    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  generator:           {args.generator}")
    print(f"  dynamic expansion:   {args.dynamic_generator}")
    print(f"  allowed errors:      {args.errors}")
    print(f"  search mode:         {args.search_mode}")
    print(f"  max hits:            {args.max_hits}")
    print(f"  output path:         {args.output}")
    print(f"fwd queries: {len(queries)}")

    if not os.path.exists(args.index):
        raise SaharaError(f"no valid index path at {args.index}")
    host = load_index(args.index)
    mesh = _local_mesh(getattr(args, "devices", 0))
    if mesh is not None:
        from sahara_jax.parallel.mesh import replicate_index

        print(f"devices:             {mesh.devices.size}")
        index = replicate_index(host, mesh)
    else:
        index = DeviceIndex.from_host(host)
    timing.mark("ld index")

    # rbi search is always edit distance (search_ng21, rbi-search.cpp:177-187)
    result = search_queries(
        index,
        queries,
        k=args.errors,
        generator_name=args.generator,
        edit=True,
        mode=args.search_mode,
        max_hits=args.max_hits,
        dynamic=args.dynamic_generator,
        engine=getattr(args, "engine", "auto"),
        mesh=mesh,
        verbose_cb=print,
    )
    timing.mark("search")
    timing.mark("locate")
    if getattr(args, "orig_coords", False):
        # mirror-hit remap (CONFORMANCE.md deviation 4): mirror copies have
        # seqIds [m, 2m) and reversed-sequence coordinates.  The reported
        # coordinate for BOTH orientations becomes the original-strand base
        # aligned to the query's first character: forward hits already start
        # there; a mirror hit at reversed position p touches original
        # position L - 1 - p (the alignment's full span is not recoverable
        # from a located hit, so the start of the reversed alignment — a
        # single well-defined base — is the coordinate contract).
        n_orig = host.num_seqs // 2
        sid = result.seq_id.copy()
        pos = result.pos.copy()
        mirror = sid >= n_orig
        lens = np.asarray(host.seq_lens, dtype=np.int64)
        pos[mirror] = lens[sid[mirror]] - 1 - pos[mirror]
        sid[mirror] -= n_orig
        from sahara_jax.engine.driver import SearchResult, _merge_results

        result = _merge_results(
            [SearchResult(result.query_id, sid, pos, result.errors)]
        )
    n = write_hits(args.output, (result.query_id, result.seq_id, result.pos))
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def cmd_rbi_search(args):
    _rbi_search(args, DR_DNA5, unknown_random_ranks=False)


def cmd_rbi_search_dna4(args):
    _rbi_search(args, DR_DNA4, unknown_random_ranks=True)


def _add_search_flags(p, *, metric: bool, reverse: bool, limit: bool):
    p.add_argument("-q", "--query", required=True, help="path to a query file")
    p.add_argument("-i", "--index", required=True, help="path to the index file")
    p.add_argument("-o", "--output", default="sahara-output.txt", help="output path")
    p.add_argument("-g", "--generator", default="h2-k2", help="picking optimum search scheme generator")
    p.add_argument("--dynamic_generator", action="store_true",
                   help="should generator run expand search scheme with dynamic extension")
    p.add_argument("-e", "--errors", type=int, default=0,
                   help="number of allowed errors (number of allowed differences insert/substitute and deletions)")
    if reverse:
        p.add_argument("--no-reverse", action="store_true", help="do not search for reversed complements")
    p.add_argument("-m", "--search_mode", choices=["all", "besthits"], default="all",
                   help="search mode, all (default) or besthits")
    if metric:
        p.add_argument("-d", "--distance-metric", dest="distance_metric", choices=["ham", "lev"],
                       default="lev",
                       help="which distance metric to use. ham: hamming or lev: levenshtein(edit) distance")
    p.add_argument("--max_hits", type=int, default=0, help="maximum number of hits per query")
    if limit:
        p.add_argument("--limit_queries", type=int, default=0, help="only run the given number of queries")
    # extensions with no reference counterpart
    p.add_argument("--engine", choices=["auto", "sv", "workq", "approx"], default="auto",
                   help="search engine: auto (seed-verify when eligible, else workq), "
                        "sv (seed-and-verify), workq (work-queue scheme engine), "
                        "approx (per-lane frontier scheme engine)")
    p.add_argument("--devices", type=int, default=0,
                   help="local devices for data-parallel search: 0 = all local "
                        "accelerator chips (1 on CPU), N = first N devices")
    # multi-host extension flags (no reference counterpart): bring up
    # jax.distributed and shard the query list by process rank
    p.add_argument("--mh_coordinator", default=None, help="jax.distributed coordinator address (host:port)")
    p.add_argument("--mh_num_processes", type=int, default=0, help="number of distributed processes")
    p.add_argument("--mh_process_id", type=int, default=0, help="this process's rank")
    p.add_argument("--mh_local_device_ids", default=None,
                   help="comma-separated local device ids of this process, for "
                        "several processes on one host (default: all local devices)")


def register(subparsers):
    p = subparsers.add_parser("search", help="search for a given pattern")
    _add_search_flags(p, metric=True, reverse=True, limit=True)
    p.set_defaults(func=cmd_search)

    p = subparsers.add_parser("uni-search", help="search for a given pattern")
    p.add_argument("-q", "--query", required=True)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output", default="sahara-output.txt")
    p.add_argument("--no-reverse", action="store_true")
    p.set_defaults(func=cmd_uni_search)

    p = subparsers.add_parser("rbi-search", help="search for a given pattern")
    _add_search_flags(p, metric=False, reverse=False, limit=False)
    _add_orig_coords_flag(p)
    p.set_defaults(func=cmd_rbi_search)

    p = subparsers.add_parser("rbi-search-dna4", help="search for a given pattern")
    _add_search_flags(p, metric=False, reverse=False, limit=False)
    _add_orig_coords_flag(p)
    p.set_defaults(func=cmd_rbi_search_dna4)


def _add_orig_coords_flag(p):
    p.add_argument(
        "--orig_coords", action="store_true",
        help="map mirror hits (seqId in [m, 2m)) back to original-sequence "
             "coordinates: seqId -= m, pos = seqLen - 1 - pos (the "
             "original-strand base aligned to the query's first character; "
             "forward hits already report that base as their start). "
             "CONFORMANCE.md deviation 4.")
