"""Storage operations CLI (the JAX package's ``storage/__main__.py``).

Subcommands verify / find-corruption / list-versions / inspect / gc-preview /
gc-run (--yes) / tensorboard-log, exit codes 0 (ok) / 1 (problem found) /
2 (usage or backend error). ``tensorboard-log --logdir DIR`` writes the
chain's history with ``utils/tensorboard_writer.py`` (exit 2 without the
tensorboard package).

Backend selection: ``--root DIR`` uses the filesystem store;
``--s3-endpoint URL`` (or env AWS_ENDPOINT_URL with ``--s3``) uses S3 when
aioboto3 is available.

Usage::

    python -m spectralmc_tpu_torch.storage --root models --bucket prod verify
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from spectralmc_tpu_torch.core.result import Failure
from spectralmc_tpu_torch.storage.gc import ExecuteGC, PreviewGC, RetentionPolicy, run_gc
from spectralmc_tpu_torch.storage.object_store import (
    FileSystemObjectStore,
    make_s3_object_store,
)
from spectralmc_tpu_torch.storage.store import AsyncBlockchainModelStore
from spectralmc_tpu_torch.storage.verification import (
    ChainCorrupted,
    find_corruption,
    verify_chain_detailed,
    verify_version_completeness,
)

EXIT_OK = 0
EXIT_PROBLEM = 1
EXIT_ERROR = 2


def _build_store(args: argparse.Namespace) -> AsyncBlockchainModelStore:
    if args.s3 or args.s3_endpoint:
        backend = make_s3_object_store(args.bucket, endpoint_url=args.s3_endpoint)
    else:
        backend = FileSystemObjectStore(args.root, args.bucket)
    return AsyncBlockchainModelStore(backend)


async def _cmd_verify(store: AsyncBlockchainModelStore, args: argparse.Namespace) -> int:
    verdict = await verify_chain_detailed(store)
    if isinstance(verdict, Failure):
        print(f"error: {verdict.error!r}", file=sys.stderr)
        return EXIT_ERROR
    if isinstance(verdict.value, ChainCorrupted):
        c = verdict.value
        print(f"CORRUPTED [{c.corruption_type}] at v{c.version_counter}: {c.details}")
        return EXIT_PROBLEM
    print(f"OK: chain valid ({verdict.value.versions} versions)")
    return EXIT_OK


async def _cmd_find_corruption(
    store: AsyncBlockchainModelStore, args: argparse.Namespace
) -> int:
    result = await find_corruption(store)
    if isinstance(result, Failure):
        print(f"error: {result.error!r}", file=sys.stderr)
        return EXIT_ERROR
    if result.value is None:
        print("OK: no corruption found")
        return EXIT_OK
    c = result.value
    print(f"CORRUPTED [{c.corruption_type}] at v{c.version_counter}: {c.details}")
    return EXIT_PROBLEM


async def _cmd_list_versions(
    store: AsyncBlockchainModelStore, args: argparse.Namespace
) -> int:
    versions = await store.list_versions()
    if isinstance(versions, Failure):
        print(f"error: {versions.error!r}", file=sys.stderr)
        return EXIT_ERROR
    for v in versions.value:
        print(f"{v.version_id}  {v.semantic_version:<10} {v.content_hash[:12]}  {v.message}")
    head = await store.get_head()
    if isinstance(head, Failure):
        print(f"error reading HEAD: {head.error!r}", file=sys.stderr)
        return EXIT_ERROR
    print(f"HEAD: {head.value.version_id if head.value else '(empty chain)'}")
    return EXIT_OK


async def _cmd_inspect(store: AsyncBlockchainModelStore, args: argparse.Namespace) -> int:
    version = await store.get_version(args.counter)
    if isinstance(version, Failure):
        print(f"error: {version.error!r}", file=sys.stderr)
        return EXIT_ERROR
    v = version.value
    missing = await verify_version_completeness(store, v)
    record = v.model_dump()
    record["record_hash"] = v.compute_hash()
    record["directory"] = v.directory_name
    record["missing_artifacts"] = (
        list(missing.value) if not isinstance(missing, Failure) else "?"
    )
    print(json.dumps(record, indent=2, sort_keys=True))
    return EXIT_OK if record["missing_artifacts"] == [] else EXIT_PROBLEM


async def _cmd_gc(
    store: AsyncBlockchainModelStore, args: argparse.Namespace, *, execute: bool
) -> int:
    if execute and not args.yes:
        print("refusing to delete without --yes", file=sys.stderr)
        return EXIT_ERROR
    policy = RetentionPolicy(
        keep_versions=args.keep,
        keep_min_versions=args.keep_min,
        protect_counters=tuple(args.protect or ()),
    )
    mode = ExecuteGC() if execute else PreviewGC()
    report = await run_gc(store, policy, mode)
    if isinstance(report, Failure):
        print(f"error: {report.error!r}", file=sys.stderr)
        return EXIT_ERROR
    r = report.value
    action = "would delete" if r.dry_run else "deleted"
    print(f"{action}: {list(r.deleted)}  protected: {list(r.protected)}  "
          f"bytes: {r.bytes_freed}")
    for line in r.details:
        print(f"  {line}")
    return EXIT_OK


async def _cmd_tensorboard_log(
    store: AsyncBlockchainModelStore, args: argparse.Namespace
) -> int:
    from spectralmc_tpu_torch.utils.tensorboard_writer import log_chain_to_tensorboard

    try:
        result = await log_chain_to_tensorboard(store, args.logdir)
    except ImportError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return EXIT_ERROR
    if isinstance(result, Failure):
        print(f"error: {result.error!r}", file=sys.stderr)
        return EXIT_ERROR
    print(f"logged {result.value} versions to {args.logdir}")
    return EXIT_OK


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m spectralmc_tpu_torch.storage")
    parser.add_argument("--root", default=".spectralmc_store", help="filesystem store root")
    parser.add_argument("--bucket", default="models", help="bucket / store name")
    parser.add_argument("--s3", action="store_true", help="use the S3 backend")
    parser.add_argument("--s3-endpoint", default=None, help="S3 endpoint URL (implies --s3)")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("verify")
    sub.add_parser("find-corruption")
    sub.add_parser("list-versions")
    inspect = sub.add_parser("inspect")
    inspect.add_argument("counter", type=int)
    for name in ("gc-preview", "gc-run"):
        gc = sub.add_parser(name)
        gc.add_argument("--keep", type=int, default=10)
        gc.add_argument("--keep-min", type=int, default=3)
        gc.add_argument("--protect", type=int, nargs="*", default=[])
        if name == "gc-run":
            gc.add_argument("--yes", action="store_true")
    tb = sub.add_parser("tensorboard-log")
    tb.add_argument("--logdir", required=True)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        store = _build_store(args)
    except ImportError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return EXIT_ERROR
    commands = {
        "verify": lambda: _cmd_verify(store, args),
        "find-corruption": lambda: _cmd_find_corruption(store, args),
        "list-versions": lambda: _cmd_list_versions(store, args),
        "inspect": lambda: _cmd_inspect(store, args),
        "gc-preview": lambda: _cmd_gc(store, args, execute=False),
        "gc-run": lambda: _cmd_gc(store, args, execute=True),
        "tensorboard-log": lambda: _cmd_tensorboard_log(store, args),
    }
    return asyncio.run(commands[args.command]())


if __name__ == "__main__":
    raise SystemExit(main())
