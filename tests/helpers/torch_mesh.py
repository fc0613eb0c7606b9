"""Sharded-training cases for the port, and the ``gloo`` ranks that run them.

Importable by the tests (it imports only the port, lazily) and runnable as a
worker script, one process a rank::

    python tests/helpers/torch_mesh.py SUITE RANK WORLD RENDEZVOUS_FILE OUT_DIR

A rank joins a ``gloo`` world through a ``file://`` rendezvous (no port is
shared between test workers), runs every case of ``SUITE`` on one torch
thread and writes ``OUT_DIR/rank{RANK}.json``: per case the losses, gradient
norms, counters, recorded backward and a hash of its replica's state (and,
on rank 0, the weights). ``start_ranks`` starts the ranks, waits for them with
a time limit, stops them all if any fails, and returns the ranks' JSON.

The worker imports neither JAX nor the tests package: it runs as a script,
from a fresh interpreter.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CONTRACT_BOUNDS = {
    "spot": (50.0, 150.0),
    "strike": (50.0, 150.0),
    "maturity": (0.2, 2.0),
    "rate": (0.0, 0.10),
    "div_yield": (0.0, 0.05),
    "vol": (0.10, 0.50),
}
_MARKET = {k: CONTRACT_BOUNDS[k] for k in ("spot", "strike", "maturity", "rate", "div_yield")}
FAMILY_BOUNDS = {
    "gbm": CONTRACT_BOUNDS,
    "heston": {**_MARKET, "v0": (0.03, 0.08), "kappa": (1.0, 2.5), "theta": (0.03, 0.08),
               "xi": (0.2, 0.5), "rho": (-0.8, -0.3)},
    "merton": {**_MARKET, "vol": (0.15, 0.25), "lam": (0.1, 0.8), "jump_mean": (-0.15, 0.0),
               "jump_std": (0.1, 0.25)},
}
BASKET = {"weights": (0.6, 0.4), "correlation": ((1.0, 0.3), (0.3, 1.0))}
NONE = {"normalization": "none"}

# name -> simulation knobs (JSON values both packages take), bounds family,
# network, batches, batch size. The sizes are tests/test_parallel.py's:
# timesteps 2, network 16, 8 rows, width 24, batch 8.
CASES: dict[str, dict] = {
    "f32": {"sim": {}, "batches": 6},
    "f64": {"sim": {"precision": "float64"}, "batches": 4},
    "basket": {"sim": {"model": "basket_gbm", "basket": BASKET}},
    "barrier": {"sim": {"payoff": "barrier_up_out", "barrier_rel": 1.3, **NONE}},
    "antithetic": {"sim": {"antithetic": True}},
    "qmc": {"sim": {"sampling": "sobol_bb"}},
    "american": {"sim": {"payoff": "american_put", **NONE}},
    "american_xfit": {"sim": {"payoff": "american_put", "lsmc_cross_fit": True, **NONE}},
    "american_f64": {"sim": {"payoff": "american_put", "precision": "float64", **NONE}},
    "cliquet": {"sim": {"payoff": "cliquet", "cliquet_reset_every": 1, "cliquet_floor": -0.05,
                        "cliquet_cap": 0.05, **NONE}},
    "lookback": {"sim": {"payoff": "lookback_fixed_put", **NONE}},
    "variance_swap": {"sim": {"payoff": "variance_swap", **NONE}},
    "forward_start": {"sim": {"payoff": "forward_start", "forward_start_step": 1}},
    "curved_term": {"sim": {"term": {"vol_shape": (1.2, 0.8), "rate_shape": (1.3, 0.7),
                                     "div_shape": (0.5, 1.5)}}},
    "heston": {"sim": {"model": "heston"}, "bounds": "heston"},
    "merton": {"sim": {"model": "merton_jump"}, "bounds": "merton"},
    # the curve finding: a mean rate factor of 1.5 (the flat discount misses it)
    "curve": {"sim": {"term": {"rate_shape": (1.5, 1.5)}}},
    # per-shard batch statistics, running statistics averaged over the batch axis
    "bn": {"sim": {}, "network": "bn", "batch": 16},
}


def case(name: str) -> dict:
    c = CASES[name]
    return {"sim": c["sim"], "bounds": FAMILY_BOUNDS[c.get("bounds", "gbm")],
            "network": c.get("network", "plain"), "batches": c.get("batches", 4),
            "batch": c.get("batch", 8)}


def sim_kwargs(name: str, build_basket_spec: object) -> dict:
    """``build_simulation_params`` keywords of a case for either package
    (each builds the basket spec with its own ``build_basket_spec``)."""
    kw = dict(timesteps=2, network_size=16, batches_per_mc_run=8, mc_seed=7, **case(name)["sim"])
    if "basket" in kw:
        kw["basket"] = build_basket_spec(**kw["basket"]).expect("basket")  # type: ignore[operator]
    return kw


def cvnn_layers(mod: object, network: str, precision: object) -> object:
    """The case's CVNN config in the package ``mod`` (``models.factory``), at
    the sim's ``Precision``."""
    if network == "bn":
        # no bias before the covariance batch norm: its gradient is rounding
        # noise, which Adam turns into lr-sized steps of either sign in either
        # package (tests/test_torch_slice.py::_cvnn)
        layers = [mod.LinearCfg(width=16, bias=False, activation=mod.Activation.MODRELU),
                  mod.CovBNCfg()]
    else:
        layers = [mod.LinearCfg(width=24, activation=mod.Activation.MODRELU)]
    return mod.build_cvnn_config(layers=layers, seed=5, precision=precision).expect("cvnn")


def port_config(name: str) -> object:
    from spectralmc_tpu_torch.models import factory
    from spectralmc_tpu_torch.ops.basket import build_basket_spec
    from spectralmc_tpu_torch.ops.gbm import build_simulation_params
    from spectralmc_tpu_torch.ops.sobol import BoundSpec
    from spectralmc_tpu_torch.training.trainer import GbmCVNNPricerConfig

    c = case(name)
    sim = build_simulation_params(**sim_kwargs(name, build_basket_spec)).expect("sim")
    return GbmCVNNPricerConfig(
        sim=sim,
        bounds={k: BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in c["bounds"].items()},
        cvnn=cvnn_layers(factory, c["network"], sim.precision),
    )


def port_train(pricer: object, name: str, *, batches: int | None = None, **train_kw: object):
    from spectralmc_tpu_torch.training.trainer import build_training_config

    c = case(name)
    cfg = build_training_config(num_batches=batches or c["batches"], batch_size=c["batch"],
                                learning_rate=2e-3).expect("training config")
    return pricer.train(cfg, **train_kw).expect("train")


def state_hash(snap: object) -> str:
    """sha256 over a snapshot's weights, buffers, Adam moments and counters."""
    h = hashlib.sha256()
    opt = snap.optimizer_state
    for named in (snap.model_state, opt.mu, opt.nu):
        for key in sorted(named):
            h.update(key.encode())
            h.update(named[key].tobytes())
    h.update(f"{opt.count} {snap.global_step} {snap.sobol_skip} {snap.sim.skip}".encode())
    return h.hexdigest()


def record(result: object, snap: object, *, weights: bool) -> dict:
    out = {
        "losses": [float(x) for x in result.losses],
        "grad_norms": [float(x) for x in result.grad_norms],
        "sobol_skip": snap.sobol_skip,
        "mc_skip": snap.sim.skip,
        "global_step": snap.global_step,
        "lsmc_backward_version": snap.lsmc_backward_version,
        "state": state_hash(snap),
    }
    if weights:
        out["model_state"] = {k: v.tolist() for k, v in snap.model_state.items()}
    return out


# --------------------------------------------------------------------------
# The worker
# --------------------------------------------------------------------------


def _mesh_suite(shape: tuple[int, int], names: list[str], rank: int) -> dict:
    """Each case on the flat ``shape`` mesh."""
    from spectralmc_tpu_torch.parallel.mesh import build_mesh_spec
    from spectralmc_tpu_torch.training.trainer import GbmCVNNPricer

    spec = build_mesh_spec(batch_shards=shape[0], paths_shards=shape[1]).expect("mesh")
    out = {}
    for name in names:
        pricer = GbmCVNNPricer.create(port_config(name), device="cpu",
                                      mesh_spec=spec).expect(name)
        out[name] = record(port_train(pricer, name), pricer.snapshot(), weights=rank == 0)
    return out


def _checkpoint_suite(rank: int, out_dir: Path) -> dict:
    """On a world of 4: the global (slice 2, batch 1, paths 2) mesh against
    the flat (2, 2) mesh; ``make_sharded_segment`` against them; the
    per-shard chunk and batch checks; a CUDA pricer refused on this CPU
    world; a same-mesh resume against the uninterrupted run,
    whose snapshot rank 0 writes for single-device resumes; commits gated to
    rank 0 under ``FinalAndIntervalCommit(2)`` into a filesystem chain; a
    mid-stream ``"cuda"`` American checkpoint (backward 3) refused on a
    mesh; and ``initialize_distributed`` called again, alike and not."""
    from spectralmc_tpu_torch.core.errors.trainer import EngineMismatch
    from spectralmc_tpu_torch.ops.gbm import SimImplementation
    from spectralmc_tpu_torch.parallel.distributed import (
        build_global_mesh_spec,
        coordinator_only,
        initialize_distributed,
        joined_device_type,
    )
    from spectralmc_tpu_torch.parallel.mesh import build_mesh_spec
    from spectralmc_tpu_torch.parallel.trainer import make_sharded_segment
    from spectralmc_tpu_torch.serialization import serialize_checkpoint
    from spectralmc_tpu_torch.storage import (
        AsyncBlockchainModelStore,
        FileSystemObjectStore,
        make_commit_fn,
    )
    from spectralmc_tpu_torch.training.trainer import (
        FinalAndIntervalCommit,
        GbmCVNNPricer,
        build_training_config,
    )

    flat = build_mesh_spec(batch_shards=2, paths_shards=2).expect("flat mesh")
    glob = build_global_mesh_spec(batch_shards_per_slice=1, paths_shards=2).expect("global")
    out: dict = {"coords": {"flat": [flat.batch_index, flat.paths_index],
                            "global": [glob.batch_index, glob.paths_index]}}
    for label, spec in (("flat", flat), ("global", glob)):
        pricer = GbmCVNNPricer.create(port_config("f32"), device="cpu", mesh_spec=spec).expect("p")
        out[label] = record(port_train(pricer, "f32", batches=4), pricer.snapshot(),
                            weights=False)

    fresh = GbmCVNNPricer.create(port_config("f32"), device="cpu", mesh_spec=flat).expect("s")
    segment = make_sharded_segment(fresh.model, fresh._sim, fresh._table, batch_size=8,
                                   learning_rate=2e-3, spec=flat, length=4)
    out["segment"] = [float(x) for x in segment(fresh._step_state())[0]]
    chunked = build_training_config(num_batches=1, batch_size=24, learning_rate=2e-3,
                                    contract_chunk=8).expect("chunked")
    out["chunk_refused"] = fresh.train(chunked).error.reason
    odd = build_training_config(num_batches=1, batch_size=5, learning_rate=2e-3).expect("odd")
    out["indivisible_batch"] = fresh.train(odd).error.reason
    out["joined_for"] = joined_device_type()
    out["card_pricer_refused"] = GbmCVNNPricer.create(
        port_config("f32"), device="cuda", mesh_spec=flat).error.reason

    whole = GbmCVNNPricer.create(port_config("f32"), device="cpu", mesh_spec=flat).expect("w")
    store = AsyncBlockchainModelStore(FileSystemObjectStore(str(out_dir / "store"), "models"))
    commits: list[str] = []
    commit = make_commit_fn(store)

    def commit_fn(snap: object, message: str) -> None:
        commits.append(message)
        commit(snap, message)

    result = port_train(whole, "f32", batches=4, commit_plan=FinalAndIntervalCommit(interval=2),
                        commit_fn=coordinator_only(commit_fn, name="commit"))
    out["whole"] = record(result, whole.snapshot(), weights=False)
    out["commits"] = commits
    if rank == 0:
        (out_dir / "sharded.ckpt").write_bytes(serialize_checkpoint(whole.snapshot())[0])

    first = GbmCVNNPricer.create(port_config("f32"), device="cpu", mesh_spec=flat).expect("1")
    head = port_train(first, "f32", batches=2)
    resumed = GbmCVNNPricer.create(first.snapshot(), device="cpu", mesh_spec=flat).expect("r")
    tail = port_train(resumed, "f32", batches=2)
    out["resumed"] = {"losses": [float(x) for x in (*head.losses, *tail.losses)],
                      "state": state_hash(resumed.snapshot())}

    american = port_config("american")
    cuda = american.sim.model_copy(update={"implementation": SimImplementation.CUDA})
    single = GbmCVNNPricer.create(dataclasses.replace(american, sim=cuda),
                                  device="cpu").expect("cuda-engine american")
    port_train(single, "american", batches=1)
    snap = single.snapshot()
    refused = GbmCVNNPricer.create(snap, device="cpu", mesh_spec=flat)
    out["mid_stream_backward"] = snap.lsmc_backward_version
    out["refused_on_mesh"] = (refused.is_failure()
                              and isinstance(refused.error, EngineMismatch))

    rdv = os.environ["TORCH_MESH_RENDEZVOUS"]
    same = initialize_distributed(coordinator_address=f"file://{rdv}", num_processes=4,
                                  process_id=rank, device_type="cpu")
    other = initialize_distributed(coordinator_address=f"file://{rdv}", num_processes=4,
                                   process_id=(rank + 1) % 4, device_type="cpu")
    out["init_again"] = {"same_ok": same.is_success(),
                         "same_rank": same.value.process_index if same.is_success() else None,
                         "other_refused": other.is_failure(),
                         "other_reason": other.error.reason if other.is_failure() else ""}
    return out


FAMILIES = ["basket", "barrier", "antithetic", "qmc", "american", "american_xfit", "cliquet",
            "lookback", "variance_swap", "forward_start", "curved_term", "heston", "merton"]
SUITES = {
    "mesh_1x2": lambda rank, out_dir: _mesh_suite((1, 2), ["f32", "f64", "american"], rank),
    "mesh_2x1": lambda rank, out_dir: _mesh_suite((2, 1), ["f32", "f64"], rank),
    "mesh_2x2": lambda rank, out_dir: _mesh_suite(
        (2, 2), ["f32", "f64", *FAMILIES, "american_f64", "curve", "bn"], rank),
    "checkpoint": _checkpoint_suite,
}
WORLDS = {"mesh_1x2": 2, "mesh_2x1": 2, "mesh_2x2": 4, "checkpoint": 4}


def main(argv: list[str]) -> None:
    suite, rank, world, rdv, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4])
    import torch

    torch.set_num_threads(1)
    from spectralmc_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown_distributed,
    )

    os.environ["TORCH_MESH_RENDEZVOUS"] = rdv
    rt = initialize_distributed(coordinator_address=f"file://{rdv}", num_processes=world,
                                process_id=rank, device_type="cpu",
                                timeout_s=120.0).expect("init")
    if (rt.process_index, rt.process_count) != (rank, world):
        raise RuntimeError(f"joined as {rt}, want rank {rank} of {world}")
    out = SUITES[suite](rank, out_dir)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    shutdown_distributed()


class Ranks:
    """A suite's ranks, running: ``wait`` returns every rank's JSON, by
    rank (once; later calls return the same), and raises if a rank failed
    or the ranks outlived their time limit, after stopping them all."""

    def __init__(self, suite: str, tmp: Path, timeout_s: float) -> None:
        self.suite, self.tmp = suite, tmp
        self.deadline = time.monotonic() + timeout_s
        world = WORLDS[suite]
        tmp.mkdir(parents=True, exist_ok=True)
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1"}
        self.logs = [tmp / f"rank{rank}.log" for rank in range(world)]
        self.procs: list[subprocess.Popen] = []
        for rank, log in enumerate(self.logs):
            with log.open("w") as sink:  # the child keeps its own descriptor
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, suite, str(rank), str(world),
                     str(tmp / "rendezvous"), str(tmp)],
                    cwd=REPO, env=env, stdout=sink, stderr=subprocess.STDOUT,
                ))
        self._result: list[dict] | None = None

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    def wait(self) -> list[dict]:
        if self._result is not None:
            return self._result
        try:
            for proc in self.procs:
                proc.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{self.suite}: the ranks outlived their time limit") from None
        finally:
            self.stop()
        failed = [(rank, proc.returncode, log.read_text()[-3000:])
                  for rank, (proc, log) in enumerate(zip(self.procs, self.logs))
                  if proc.returncode]
        if failed:
            raise RuntimeError(f"{self.suite}: ranks failed: {failed}")
        self._result = [json.loads((self.tmp / f"rank{rank}.json").read_text())
                        for rank in range(len(self.procs))]
        return self._result


def start_ranks(suite: str, tmp: Path, *, timeout_s: float = 300.0) -> Ranks:
    """Start ``suite`` on its world of ``gloo`` ranks (``Ranks.wait`` for
    their JSON)."""
    return Ranks(suite, tmp, timeout_s)


if __name__ == "__main__":
    main(sys.argv[1:])
