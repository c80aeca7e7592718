"""CLI entry point: subcommand dispatch (the ``main.cpp``/clice analogue,
/root/reference/src/sahara/main.cpp:7-16 — parses argv, dispatches to the
registered subcommand, catches user-facing errors)."""

from __future__ import annotations

import argparse
import sys

from sahara_jax.utils.errors import SaharaError


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sahara",
        description="approximate pattern matching on an accelerator (FM-index + optimum search schemes)",
    )
    subparsers = parser.add_subparsers(dest="command", required=True)

    from sahara_jax.cli import columba_cmd, index_cmd, kmer_cmd, scheme_cmd, search_cmd, sim_cmd

    index_cmd.register(subparsers)
    search_cmd.register(subparsers)
    kmer_cmd.register(subparsers)
    scheme_cmd.register(subparsers)
    sim_cmd.register(subparsers)
    columba_cmd.register(subparsers)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        args.func(args)
    except SaharaError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
