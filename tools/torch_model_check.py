#!/usr/bin/env python
"""Exhaustive model check of the PyTorch port: snapshot/restore ≡ continuous training.

The port's counterpart of ``tools/model_check.py``, on the port alone (it
imports torch and ``spectralmc_tpu_torch``, never JAX or the JAX package).

Property. For a training run of N batches, every composition of N into
ordered positive segments — with a full snapshot → ``serialization``
serialize → deserialize (the sha256 checked) → ``GbmCVNNPricer.create``
cycle between segments — must produce a final state bit-identical to the
single continuous N-batch run: the weights and buffers, Adam's count, mu and
nu, ``global_step``, ``sobol_skip`` and ``sim.skip``, and the recorded
engine (``implementation``), CUDA stream version and LSMC backward version.
There are 2^(N-1) compositions; N=4 checks 7 split schedules beside the
continuous one.

On the ``"cuda"`` engine this holds the kernels' draw counters and each
American pricer's recorded backward to every way of cutting a run.

    python tools/torch_model_check.py [--batches 6] [--device cuda|cpu]
        [--pricer terminal|terminal_f64|qmc_asian|american|heston_american]
        [--verbose]

The command line checks the small configuration of ``tools/model_check.py``
and exits 1 where a schedule violated the property; ``config_for(pricer,
full=True)`` gives the production shape (512 contracts in chunks of 256,
2048 x 512 paths, 16 steps, the 256-wide head) that ``chip_smoke.py`` checks
on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import time
from pathlib import Path
from typing import Callable, Iterator

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from spectralmc_tpu_torch.core.precision import Precision  # noqa: E402
from spectralmc_tpu_torch.models.factory import (  # noqa: E402
    Activation,
    CovBNCfg,
    LinearCfg,
    ResidualCfg,
    SequentialCfg,
    build_cvnn_config,
)
from spectralmc_tpu_torch.ops.gbm import build_simulation_params  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.serialization.converters import (  # noqa: E402
    deserialize_checkpoint,
    serialize_checkpoint,
)
from spectralmc_tpu_torch.training.trainer import (  # noqa: E402
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

PRICERS = ("terminal", "terminal_f64", "qmc_asian", "american", "heston_american")
# the small configuration: tools/model_check.py's
SMALL_BOUNDS = {
    "spot": BoundSpec(lower=90.0, upper=110.0),
    "strike": BoundSpec(lower=90.0, upper=110.0),
    "maturity": BoundSpec(lower=0.5, upper=1.5),
    "rate": BoundSpec(lower=0.0, upper=0.05),
    "div_yield": BoundSpec(lower=0.0, upper=0.02),
    "vol": BoundSpec(lower=0.1, upper=0.4),
}
# the production shape: the JAX bench's bounds and head (bench.py:161-196)
FULL_BOUNDS = {
    "spot": BoundSpec(lower=80.0, upper=120.0),
    "strike": BoundSpec(lower=80.0, upper=120.0),
    "maturity": BoundSpec(lower=0.25, upper=2.0),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}
HESTON_BOUNDS = {
    "v0": BoundSpec(lower=0.03, upper=0.08),
    "kappa": BoundSpec(lower=1.0, upper=2.5),
    "theta": BoundSpec(lower=0.03, upper=0.08),
    "xi": BoundSpec(lower=0.2, upper=0.5),
    "rho": BoundSpec(lower=-0.8, upper=-0.3),
}
PRICER_SIM = {
    "terminal": dict(implementation="cuda"),
    "terminal_f64": dict(implementation="xla", precision="float64"),
    "qmc_asian": dict(implementation="xla", payoff="asian_geometric", sampling="sobol_bb",
                      normalization="mean"),
    "american": dict(implementation="cuda", payoff="american_put", normalization="none"),
    "heston_american": dict(implementation="cuda", model="heston", payoff="american_put",
                            normalization="none"),
}


@dataclasses.dataclass(frozen=True)
class Training:
    """The batch each segment trains on."""

    batch_size: int
    learning_rate: float = 1e-3
    contract_chunk: int | None = None

    def config(self, num_batches: int) -> object:
        return build_training_config(
            num_batches=num_batches, batch_size=self.batch_size,
            learning_rate=self.learning_rate, contract_chunk=self.contract_chunk,
        ).expect("training config")


@dataclasses.dataclass(frozen=True)
class ModelCheckReport:
    schedules: int  # the split schedules, beside the continuous run
    violations: int  # the schedules whose final state differs from the continuous run's
    seconds: float
    implementation: str  # what the continuous run recorded
    cuda_stream_version: int
    lsmc_backward_version: int


def compositions(n: int) -> Iterator[tuple[int, ...]]:
    """All ordered compositions of n into positive parts (2^(n-1) of them)."""
    for cuts in itertools.product((False, True), repeat=n - 1):
        parts: list[int] = []
        size = 1
        for cut in cuts:
            if cut:
                parts.append(size)
                size = 1
            else:
                size += 1
        parts.append(size)
        yield tuple(parts)


def production_cvnn(precision: Precision = Precision.float32) -> object:
    """The 256-wide production head (``chip_smoke.py``'s, the JAX bench's)."""
    return build_cvnn_config(
        layers=[
            LinearCfg(width=256, activation=Activation.MODRELU),
            CovBNCfg(),
            ResidualCfg(
                body=SequentialCfg(layers=(
                    LinearCfg(width=256, activation=Activation.ZRELU),
                    LinearCfg(width=256, activation=Activation.NONE),
                )),
                activation=Activation.MODRELU,
            ),
        ],
        seed=11, precision=precision,
    ).expect("cvnn")


def config_for(pricer: str, *, full: bool = False,
               rows: int | None = None) -> tuple[GbmCVNNPricerConfig, Training]:
    """The pricer's configuration and its segments' training: the small one
    of ``tools/model_check.py`` or (``full``) the production shape, at
    ``rows`` MC rows a contract where given."""
    knobs = dict(PRICER_SIM[pricer])
    precision = Precision(knobs.get("precision", "float32"))
    bounds = dict(FULL_BOUNDS if full else SMALL_BOUNDS)
    if knobs.get("model") == "heston":
        bounds = {k: bounds[k] for k in ("spot", "strike", "maturity", "rate", "div_yield")}
        bounds.update(HESTON_BOUNDS)
    if full:
        sim = build_simulation_params(
            mc_seed=31 if pricer == "qmc_asian" else 7, timesteps=16, network_size=512,
            batches_per_mc_run=rows or 2048, **knobs,
        ).expect("sim")
        return (GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=production_cvnn(precision),
                                    normalize_inputs=True),
                Training(batch_size=512, contract_chunk=256))
    sim = build_simulation_params(
        mc_seed=17, timesteps=2, network_size=8, batches_per_mc_run=rows or 8, **knobs,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=8, activation=Activation.MODRELU)], seed=23, precision=precision,
    ).expect("cvnn")
    return GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn), Training(batch_size=4)


def final_state(snapshot: GbmCVNNPricerConfig) -> dict[str, object]:
    """What the property compares: the counters, the recorded engine and
    backward, the weights and buffers, and Adam's state."""
    opt = snapshot.optimizer_state
    moments: dict[str, np.ndarray] = {}
    if opt is not None:
        moments["count"] = np.asarray(opt.count)
        moments.update({f"mu/{k}": np.asarray(v) for k, v in opt.mu.items()})
        moments.update({f"nu/{k}": np.asarray(v) for k, v in opt.nu.items()})
    return {
        "global_step": snapshot.global_step,
        "sobol_skip": snapshot.sobol_skip,
        "mc_skip": snapshot.sim.skip,
        "implementation": snapshot.sim.implementation.value,
        "cuda_stream_version": snapshot.cuda_stream_version,
        "lsmc_backward_version": snapshot.lsmc_backward_version,
        "model": {k: np.asarray(v) for k, v in (snapshot.model_state or {}).items()},
        "opt": moments,
    }


SCALARS = ("global_step", "sobol_skip", "mc_skip", "implementation", "cuda_stream_version",
           "lsmc_backward_version")


def diff(a: dict[str, object], b: dict[str, object]) -> list[str]:
    """Each way the final states ``a`` and ``b`` differ (none: bit-equal)."""
    out = [f"{field}: {a[field]} != {b[field]}" for field in SCALARS if a[field] != b[field]]
    for group in ("model", "opt"):
        keys_a, keys_b = set(a[group]), set(b[group])
        out += [f"{group}[{k}]: present in one side only" for k in sorted(keys_a ^ keys_b)]
        for k in sorted(keys_a & keys_b):
            x, y = a[group][k], b[group][k]
            if x.shape != y.shape or x.dtype != y.dtype or x.tobytes() != y.tobytes():
                delta = (float(np.max(np.abs(x - y))) if x.shape == y.shape
                         else float("nan"))
                out.append(f"{group}[{k}]: max|Δ|={delta:g}")
    return out


Restore = Callable[[GbmCVNNPricerConfig], GbmCVNNPricerConfig]


def train_schedule(base: GbmCVNNPricerConfig, parts: tuple[int, ...], *,
                   device: torch.device | str, training: Training,
                   restore: Restore | None = None) -> dict[str, object]:
    """Train ``base`` in segments of ``parts`` batches, each from the bytes
    the segment before it wrote (``restore`` rewrites the restored config
    before the next segment), and return the last bytes' final state."""
    config = base
    for i, part in enumerate(parts):
        if i and restore is not None:
            config = restore(config)
        pricer = GbmCVNNPricer.create(config, device=device).expect("create")
        pricer.train(training.config(part)).expect("train")
        blob, digest = serialize_checkpoint(pricer.snapshot())
        config = deserialize_checkpoint(blob, expected_hash=digest).expect("deserialize")
        del pricer
    return final_state(config)


def run_model_check(base: GbmCVNNPricerConfig, total_batches: int, *,
                    device: torch.device | str, training: Training,
                    restore: Restore | None = None, verbose: bool = False,
                    label: str = "model-check") -> ModelCheckReport:
    """Every split schedule of ``total_batches`` against the continuous run."""
    start = time.perf_counter()
    kw = dict(device=device, training=training)
    reference = train_schedule(base, (total_batches,), **kw)
    schedules = [p for p in compositions(total_batches) if p != (total_batches,)]
    failures = 0
    for parts in schedules:
        diffs = diff(reference, train_schedule(base, parts, restore=restore, **kw))
        failures += bool(diffs)
        if verbose or diffs:
            print(f"schedule {parts}: {'FAIL' if diffs else 'ok'}")
            for d in diffs:
                print(f"    {d}")
    seconds = time.perf_counter() - start
    print(f"{label}: {len(schedules)} schedules x {total_batches} batches, "
          f"{failures} violation(s) — snapshot/restore "
          f"{'≢' if failures else '≡'} continuous training ({reference['implementation']} "
          f"engine, stream v{reference['cuda_stream_version']}, LSMC backward "
          f"v{reference['lsmc_backward_version']}; {seconds:.1f} s)")
    return ModelCheckReport(
        schedules=len(schedules), violations=failures, seconds=seconds,
        implementation=reference["implementation"],
        cuda_stream_version=reference["cuda_stream_version"],
        lsmc_backward_version=reference["lsmc_backward_version"])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=6)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--pricer", choices=PRICERS, default="terminal")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {args.device!r} needs an NVIDIA GPU and none is available; "
                         "pass --device cpu to check on the CPU")
    base, training = config_for(args.pricer)
    report = run_model_check(base, args.batches, device=args.device, training=training,
                             verbose=args.verbose, label=f"model-check {args.pricer}")
    return 1 if report.violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
