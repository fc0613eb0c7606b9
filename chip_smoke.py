"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases, in order; each prints one line of findings and any failure raises
(the exit code is then non-zero and no result line is printed):

0. device   — require CUDA; print the card's name and power limit; apply the
              deterministic numerics policy (runtime/torch_runtime.py).
1. build    — build csrc/gbm_terminal.cu with nvcc into build/kernels/.
2. kernel   — the GBM kernel against its plain twin on the same Philox words:
              both schemes, antithetic on and off, an odd step count, at
              C=4 x 2048 x 512 x 16, and at the shape the training step
              launches (256 contracts x 2048 x 512 x 16), which is also timed.
3. oracle   — the "cuda" engine's discounted put mean over 1,048,576 paths
              within 4 standard errors of Black–Scholes, for three contracts.
4. train    — GbmCVNNPricer on the "cuda" engine at the production model
              (256-wide head), 2048 x 512 paths x 16 steps per contract,
              3 steps of 512 contracts in chunks of 256.
5. resume   — snapshot -> create -> 2 more steps on both: losses bit-equal.
6. serve    — predict_price on 1, 7 and 64 held-out Sobol contracts.
7. profile  — only with ``--profile``: 10 warm train steps timed on the host
              clock to a synchronised end, then torch.profiler over 3 train
              steps and over 20 predict_price calls at N=64 (device kernel
              time, busy share, launches, the heaviest kernels).

The kernel launch count is reset just before phase 4 and read after phase 6:
that is the main path's count. The last lines are the kernel record as JSON,
the nvidia-smi line, and the result JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from spectralmc_tpu_torch.models.factory import (
    Activation,
    CovBNCfg,
    LinearCfg,
    ResidualCfg,
    SequentialCfg,
    build_cvnn_config,
)
from spectralmc_tpu_torch.ops import gbm_cuda, rng
from spectralmc_tpu_torch.ops._build import load_library
from spectralmc_tpu_torch.ops.analytic import black_scholes_price
from spectralmc_tpu_torch.ops.dispatch import make_underlier_simulator
from spectralmc_tpu_torch.ops.gbm import (
    BlackScholesContract,
    PathScheme,
    build_simulation_params,
    terminal_to_prices,
)
from spectralmc_tpu_torch.ops.sobol import BoundSpec, SobolConfig, SobolSampler
from spectralmc_tpu_torch.runtime.torch_runtime import get_torch_handle
from spectralmc_tpu_torch.training.trainer import (
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

ROWS, COLS, STEPS = 2048, 512, 16
BATCH, CHUNK = 512, 256
KERNEL_RTOL = 2e-5  # libm/sinpif ulps between torch ops and device intrinsics
BOUNDS = {
    "spot": BoundSpec(lower=80.0, upper=120.0),
    "strike": BoundSpec(lower=80.0, upper=120.0),
    "maturity": BoundSpec(lower=0.25, upper=2.0),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}


def phase(label: str, **findings: object) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in findings.items()), flush=True)


def cuda_ms(fn, *, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    runtime = get_torch_handle()
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=repr(smi), torch=torch.__version__, cuda=runtime.cuda_version)
    return torch.device("cuda", 0), smi


def phase_build() -> None:
    built = load_library("gbm_terminal", ("gbm_terminal.cu",))
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    phase("build", source="spectralmc_tpu_torch/csrc/gbm_terminal.cu", library=built.path.name,
          build_seconds=f"{built.build_seconds:.2f}", ptxas=repr(" | ".join(ptxas)))


def kernel_inputs(device: torch.device, contracts: int, seed: int) -> tuple[torch.Tensor, ...]:
    gen = np.random.default_rng(seed)
    lo = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
    hi = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
    params = (lo + (hi - lo) * gen.random((contracts, 6))).astype(np.float32)
    keys = rng.fold_in(rng.prng_key(7), torch.arange(contracts, dtype=torch.int64))
    return torch.from_numpy(params).to(device), keys.to(device)


def compare(device: torch.device, contracts: int, **kw: object) -> tuple[float, float]:
    params, keys = kernel_inputs(device, contracts, seed=contracts + int(kw["timesteps"]))
    got = gbm_cuda.simulate_terminal_rows_cuda(params, keys, **kw)
    want = gbm_cuda.simulate_terminal_rows_cuda_plain(params, keys, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"kernel produced non-finite values at {kw}")
    abs_err = (got - want).abs()
    rel = float((abs_err / want.abs()).max())
    if rel > KERNEL_RTOL:
        raise AssertionError(f"kernel vs plain rel diff {rel:.3g} > {KERNEL_RTOL} at {kw}")
    return float(abs_err.max()), rel


def phase_kernel(device: torch.device) -> dict[str, object]:
    worst_abs, worst_rel, cases = 0.0, 0.0, []
    for scheme in (PathScheme.LOG_EULER, PathScheme.EULER):
        for half in (None, ROWS // 2):
            for steps in ((STEPS, 15) if scheme == PathScheme.LOG_EULER and half is None
                          else (STEPS,)):
                a, r = compare(device, 4, timesteps=steps, rows=ROWS, cols=COLS, scheme=scheme,
                               antithetic_half=half)
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
                cases.append(f"{scheme.value}/T{steps}/anti={half is not None}:{r:.2e}")
    shape = dict(timesteps=STEPS, rows=ROWS, cols=COLS, scheme=PathScheme.LOG_EULER)
    a, r = compare(device, CHUNK, **shape)
    worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    params, keys = kernel_inputs(device, CHUNK, seed=1)
    kernel_ms = cuda_ms(lambda: gbm_cuda.simulate_terminal_rows_cuda(params, keys, **shape))
    plain_ms = cuda_ms(
        lambda: gbm_cuda.simulate_terminal_rows_cuda_plain(params, keys, **shape),
        iters=10, warmup=1,
    )
    path_steps = CHUNK * ROWS * COLS * STEPS
    phase("kernel", cases=repr(", ".join(cases)), max_rel_diff=f"{worst_rel:.3e}",
          max_abs_err=f"{worst_abs:.3e}", rtol=KERNEL_RTOL,
          shape=f"{CHUNK}x{ROWS}x{COLS}x{STEPS}", kernel_ms=f"{kernel_ms:.3f}",
          plain_ms=f"{plain_ms:.3f}",
          kernel_path_steps_per_s=f"{path_steps / kernel_ms * 1e3:.4e}",
          plain_path_steps_per_s=f"{path_steps / plain_ms * 1e3:.4e}")
    return {"max_abs_err": worst_abs, "ms": kernel_ms, "plain_ms": plain_ms}


def phase_oracle(device: torch.device) -> None:
    sim = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=3,
        implementation="cuda", normalization="none",
    ).expect("oracle sim")
    simulate = make_underlier_simulator(sim, rows=ROWS)
    contracts = torch.tensor(
        [[100.0, 100.0, 1.0, 0.03, 0.01, 0.25],   # ATM
         [100.0, 120.0, 1.0, 0.03, 0.01, 0.25],   # ITM put
         [100.0, 80.0, 1.0, 0.03, 0.01, 0.25]],   # OTM put
        dtype=torch.float32, device=device,
    )
    keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), torch.arange(3, device=device))
    rows = simulate(keys, contracts)
    prices = terminal_to_prices(rows.reshape(3, -1), contracts, normalize=False,
                                dtype=torch.float32)
    put = prices.put_payoffs.double()
    mean = put.mean(dim=1).cpu().numpy()
    se = (put.std(dim=1) / math.sqrt(put.shape[1])).cpu().numpy()
    c = contracts.double().cpu()
    oracle = black_scholes_price(*(c[:, i] for i in range(6))).put.numpy()
    z = np.abs(mean - oracle) / se
    if not np.all(z < 4.0):
        raise AssertionError(f"MC put {mean} vs Black–Scholes {oracle}: z={z}")
    phase("oracle", paths=put.shape[1], mc_put=np.round(mean, 5).tolist(),
          black_scholes=np.round(oracle, 5).tolist(), z=np.round(z, 3).tolist())


def pricer_config() -> GbmCVNNPricerConfig:
    sim = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=7,
        implementation="cuda",
    ).expect("sim")
    cvnn = build_cvnn_config(
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
        seed=11,
    ).expect("cvnn")
    return GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn, normalize_inputs=True)


def train_steps(pricer: GbmCVNNPricer, n: int) -> tuple[np.ndarray, list[float]]:
    """``n`` single-batch train calls, each timed to a synchronised end."""
    cfg = build_training_config(
        num_batches=1, batch_size=BATCH, learning_rate=1e-3, contract_chunk=CHUNK
    ).expect("training config")
    losses, seconds = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = pricer.train(cfg).expect("train")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        losses.append(result.final_loss)
    return np.asarray(losses), seconds


def phase_train(device: torch.device) -> GbmCVNNPricer:
    pricer = GbmCVNNPricer.create(pricer_config(), device=device).expect("create")
    before = gbm_cuda.LAUNCHES
    losses, seconds = train_steps(pricer, 3)
    launched = gbm_cuda.LAUNCHES - before
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    if launched != 3 * BATCH // CHUNK:
        raise AssertionError(f"kernel launched {launched} times in 3 steps, want {3 * BATCH // CHUNK}")
    phase("train", engine=pricer.snapshot().sim.implementation.value, losses=losses.tolist(),
          launches=launched, step_seconds=[round(s, 4) for s in seconds],
          median_step_s=f"{statistics.median(seconds):.4f}",
          paths_per_contract=ROWS * COLS, batch=BATCH, chunk=CHUNK)
    return pricer


def phase_resume(device: torch.device, pricer: GbmCVNNPricer) -> None:
    resumed = GbmCVNNPricer.create(pricer.snapshot(), device=device).expect("resume")
    a, _ = train_steps(pricer, 2)
    b, _ = train_steps(resumed, 2)
    if not np.array_equal(a, b):
        raise AssertionError(f"resume is not bit-exact: {a} vs {b}")
    phase("resume", continued=a.tolist(), resumed=b.tolist(), bit_equal=True)


def phase_serve(pricer: GbmCVNNPricer) -> None:
    sampler = SobolSampler.create(BlackScholesContract, BOUNDS, SobolConfig(seed=7)).expect("s")
    held_out = sampler.sample_array(64, device="cpu", start=1 << 20).numpy()
    p50 = {}
    for n in (1, 7, 64):
        batch = held_out[:n]
        pred = pricer.predict_price(batch)
        padded = pricer.predict_price(batch, pad_to_bucket=True)
        if not np.all(np.isfinite(pred.put)):
            raise AssertionError(f"non-finite puts at N={n}: {pred.put}")
        if not (np.array_equal(pred.put, padded.put) and np.array_equal(pred.call, padded.call)):
            raise AssertionError(f"pad_to_bucket changed the prices at N={n}")
        b = batch.astype(np.float64)
        forward = b[:, 0] * np.exp((b[:, 3] - b[:, 4]) * b[:, 2])
        parity = np.exp(-b[:, 3] * b[:, 2]) * (forward - b[:, 1])
        # 1e-5 relative, measured against the strike where df·(F − K) is near 0
        gap = np.abs((pred.call - pred.put) - parity)
        if not np.all(gap <= 1e-5 * np.maximum(np.abs(parity), b[:, 1])):
            raise AssertionError(f"call − put misses df·(F − K) at N={n}: {gap.max():.3g}")
        times = []
        for _ in range(20):
            start = time.perf_counter()
            pricer.predict_price(batch)
            times.append((time.perf_counter() - start) * 1e3)
        p50[n] = statistics.median(times)
    phase("serve", held_out_skip=1 << 20, puts_n64=np.round(pred.put[:4], 4).tolist(),
          p50_ms={k: round(v, 4) for k, v in p50.items()}, pad_bit_equal=True, parity_ok=True)


def profiled(fn) -> tuple[float, float, int, list[tuple[str, int, float]]]:
    """Wall ms, device kernel ms, kernel launches and the heaviest kernels of ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    return wall, busy, sum(e.count for e in rows), [
        (e.key[:72], e.count, round(e.self_device_time_total / 1e3, 3)) for e in top
    ]


def phase_profile(pricer: GbmCVNNPricer) -> None:
    _, seconds = train_steps(pricer, 10)
    cfg = build_training_config(
        num_batches=1, batch_size=BATCH, learning_rate=1e-3, contract_chunk=CHUNK
    ).expect("training config")
    wall, busy, launches, top = profiled(lambda: [pricer.train(cfg) for _ in range(3)])
    phase("profile-train", warm_steps=len(seconds),
          median_step_s=f"{statistics.median(seconds):.4f}",
          min_step_s=f"{min(seconds):.4f}", max_step_s=f"{max(seconds):.4f}",
          profiled_steps=3, wall_ms=f"{wall:.3f}", kernel_ms=f"{busy:.3f}",
          busy=f"{busy / wall:.4f}", idle=f"{1 - busy / wall:.4f}", kernel_launches=launches,
          top=repr(top))
    sampler = SobolSampler.create(BlackScholesContract, BOUNDS, SobolConfig(seed=7)).expect("s")
    held_out = sampler.sample_array(64, device="cpu", start=1 << 20).numpy()
    for _ in range(5):
        pricer.predict_price(held_out)
    wall, busy, launches, top = profiled(
        lambda: [pricer.predict_price(held_out) for _ in range(20)])
    phase("profile-serve", n=64, calls=20, wall_ms=f"{wall:.3f}", kernel_ms=f"{busy:.3f}",
          busy=f"{busy / wall:.4f}", kernel_launches_per_call=launches / 20, top=repr(top))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the checks, time warm train steps and profile train and serve")
    args = parser.parse_args()
    device, smi = phase_device()
    phase_build()
    kernel = phase_kernel(device)
    phase_oracle(device)
    gbm_cuda.LAUNCHES = 0  # the main path's count starts here
    pricer = phase_train(device)
    phase_resume(device, pricer)
    phase_serve(pricer)
    launches = gbm_cuda.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path never launched the GBM kernel")
    if args.profile:
        phase_profile(pricer)
    print(json.dumps({"kernels": [{
        "name": "gbm_terminal",
        "route": "cuda",
        "source": "spectralmc_tpu_torch/csrc/gbm_terminal.cu",
        "replaces": "spectralmc_tpu/ops/gbm_pallas.py:512",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
