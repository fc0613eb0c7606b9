"""What the examples of the PyTorch port share: the device an example runs
on, the kernel launches its run made, and the ranks of the sharded ones.

An example runs on the card (``cuda``) unless ``--device cpu`` is passed. On
a machine without a card it exits non-zero and names the missing device; it
never falls back to the CPU. On the CPU each kernel wrapper runs its plain
version, so the numbers are the same stream's, at CPU speed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from spectralmc_tpu_torch.ops import gbm_cuda


def device_from_argv(description: str, argv: list[str] | None = None) -> torch.device:
    """The ``--device`` an example was asked to run on (default ``cuda``);
    ``SystemExit`` naming the device where it asks for a card that is not
    there."""
    parser = argparse.ArgumentParser(description=description.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: an NVIDIA GPU) or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"this example runs on device {args.device!r}, and no NVIDIA GPU is "
                         "available; pass --device cpu to run it on the CPU")
    return device


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The kernel branches launched since ``before`` (a copy of
    ``gbm_cuda.LAUNCHES_BY_BRANCH``), with their counts."""
    return {branch: n - before.get(branch, 0)
            for branch, n in gbm_cuda.LAUNCHES_BY_BRANCH.items() if n != before.get(branch, 0)}


def rank_layout(device: torch.device | str, world: int) -> tuple[list[str], str]:
    """(each rank's device, the backend) for ``world`` ranks asked to run on
    ``device``: on the CPU gloo; with as many cards as ranks one card a rank
    over nccl; with fewer, every rank on the first card over gloo (nccl
    takes no two ranks on one card)."""
    device = torch.device(device)
    if device.type == "cpu":
        return ["cpu"] * world, "gloo"
    if torch.cuda.device_count() >= world:
        return [f"cuda:{rank}" for rank in range(world)], "nccl"
    return ["cuda:0"] * world, "gloo"


def run_ranks(script: str, world: int, job: dict[str, object],
              timeout_s: float) -> list[dict[str, object]]:
    """Start ``world`` copies of ``script`` as ranks (``--rank R --world W
    --root DIR --job JSON``), wait for them, and return what each wrote to
    ``DIR/rank{R}.json``. A rank that fails, or a world that outlives
    ``timeout_s``, raises; every rank is stopped before this returns."""
    with tempfile.TemporaryDirectory() as root:
        procs = [subprocess.Popen([sys.executable, script, "--rank", str(rank), "--world",
                                   str(world), "--root", root, "--job", json.dumps(job)])
                 for rank in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for proc in procs:
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    break
                if proc.returncode != 0:
                    break
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        codes = [proc.returncode for proc in procs]
        if any(codes):
            raise RuntimeError(f"{Path(script).name}: rank exit codes {codes}")
        return [json.loads(Path(root, f"rank{rank}.json").read_text()) for rank in range(world)]


def rank_args(argv: list[str] | None = None) -> tuple[int, int, str, dict[str, object]] | None:
    """``(rank, world, root, job)`` where this process was started as a rank
    by ``run_ranks``, else None."""
    argv = sys.argv[1:] if argv is None else argv
    if "--rank" not in argv:
        return None
    parser = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        parser.add_argument(flag, type=int, required=True)
    parser.add_argument("--root", required=True)
    parser.add_argument("--job", type=json.loads, required=True)
    args = parser.parse_args(argv)
    return args.rank, args.world, args.root, args.job


def join_world(rank: int, world: int, root: str, job: dict[str, object]) -> torch.device:
    """Join the ranks' world through a rendezvous file in ``root`` on the
    job's device and backend (``rank_layout``); this rank's device."""
    from spectralmc_tpu_torch.parallel.distributed import initialize_distributed

    device = torch.device(job["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(
        coordinator_address=f"file://{root}/rendezvous", num_processes=world, process_id=rank,
        device_type=device.type, backend=job["backend"], timeout_s=float(job["timeout_s"]),
    ).expect("join the world")
    return device


def state_digest(module: torch.nn.Module) -> str:
    """sha256 of a module's state dict, tensor by tensor: equal digests are
    bit-equal replicas."""
    digest = hashlib.sha256()
    for name, tensor in module.state_dict().items():
        digest.update(name.encode())
        digest.update(tensor.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()
