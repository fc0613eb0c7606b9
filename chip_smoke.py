"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--profile]

Phases, in order; each prints one line of findings (the kernel and oracle
phases one per case group) and any failure raises (the exit code is then
non-zero and no result line is printed):

0. device       — require CUDA; print the card's name and power limit; apply
                  the deterministic numerics policy (runtime/torch_runtime.py).
1. build        — build csrc/gbm_paths.cu with nvcc into build/kernels/;
                  count the SASS instructions of each branch's log-Euler
                  loop (cuobjdump) for the instruction cap of phase 2.
2. kernel       — every kernel branch against its plain twin on the same
                  Philox words at C=4 x 2048 x 512 x 16: TERMINAL (and its
                  digital and forward-start routes), barrier up/down, the four
                  lookbacks, variance swap, arithmetic and geometric Asian
                  under both schemes, and the cliquet under log-Euler; with
                  antithetic on and off, and an odd step or period count for
                  the pair-step branches. Continuous outputs agree to rtol
                  2e-5 (the lookback encodings against the strike, the
                  cliquet against its cap, where they cross zero); the
                  barrier knock and the digital sign may flip on at most 1e-5
                  of the paths, counted and printed. Each branch group, and
                  its twin, is timed at the training chunk 256 x 2048 x 512 x
                  16 (log-Euler) with CUDA events, beside its bound_ms and
                  its share of the SASS instruction cap.
3. oracle       — the "cuda" engine over 1,048,576 paths per contract, three
                  contracts, normalization "none": each payoff's discounted
                  MC price within 4 standard errors of the port's oracle
                  (Black–Scholes, geometric Asian, discrete barrier,
                  lookback, variance cap and floor, digital, forward start,
                  cliquet; a lattice oracle's own error, estimated by
                  halving its lattice, joins the standard error in
                  quadrature); the arithmetic Asian's sample mean within 4 SE
                  of ``expected_underlier_mean``.
4. train        — TERMINAL: GbmCVNNPricer on the "cuda" engine at the
                  production model (256-wide head), 2048 x 512 paths x 16
                  steps per contract, 3 steps of 512 contracts in chunks of
                  256: 6 launches of the TERMINAL branch.
5. resume       — snapshot -> create -> 2 more steps on both: losses bit-equal.
6. serve        — predict_price on 1, 7 and 64 held-out Sobol contracts.
7. train-asian  — phases 4-6 for the arithmetic Asian with MEAN normalization
                  to its own mean: 6 launches of the Asian branch in 3 steps,
                  bit-equal resume, and serving with pad_to_bucket bit-equal
                  and call − put = df·(E[u] − K).
8. payoffs      — every other payoff kind through the trainer at batch 64 (one
                  chunk, one step): the engine and stream version recorded,
                  its kernel branch launched, a finite loss, finite puts, and
                  calls NaN exactly where E[u] has no closed form (barrier,
                  lookback), parity where it has.
9. profile      — only with ``--profile``: for the TERMINAL and the Asian
                  pricer, 10 warm train steps timed on the host clock to a
                  synchronised end, then torch.profiler over 3 train steps
                  and over 20 predict_price calls at N=64 (device kernel
                  time, busy share, launches, the heaviest kernels).

Launch counts are set to 0 just before each main path (phases 4, 7 and 8)
and read just after it: the TERMINAL branch's count comes from phases 4-6,
the Asian branch's from phase 7 and every other branch's from phase 8. The
last lines are the kernel record as JSON, the nvidia-smi line, and the
result JSON.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import statistics
import subprocess
import time

from pathlib import Path

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
from spectralmc_tpu_torch.ops import analytic, gbm_cuda, rng
from spectralmc_tpu_torch.ops._build import find_nvcc, load_library
from spectralmc_tpu_torch.ops.dispatch import make_mean_target, make_underlier_simulator
from spectralmc_tpu_torch.ops.gbm import (
    BARRIER_PAYOFFS,
    LOOKBACK_PAYOFFS,
    BlackScholesContract,
    ModelKind,
    PathScheme,
    PayoffKind,
    build_simulation_params,
    expected_underlier_mean,
    has_closed_form_mean,
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
PAYOFF_BATCH = 64
KERNEL_RTOL = 2e-5  # libm/sinpif ulps between torch ops and device intrinsics
FLIP_SHARE = 1e-5  # barrier knocks and digital signs flipped by those ulps
SOURCE = "spectralmc_tpu_torch/csrc/gbm_paths.cu"
REPLACES = {"cliquet": "spectralmc_tpu/ops/gbm_pallas.py:793"}  # the rest: :512
CLIQUET = dict(reset_every=4, floor=-0.05, cap=0.08)
BOUNDS = {
    "spot": BoundSpec(lower=80.0, upper=120.0),
    "strike": BoundSpec(lower=80.0, upper=120.0),
    "maturity": BoundSpec(lower=0.25, upper=2.0),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}
# strike bounds in each payoff's own units (vol² for the variance swap,
# return units for the cliquet)
STRIKE_BOUNDS = {
    PayoffKind.VARIANCE_SWAP: BoundSpec(lower=0.02, upper=0.10),
    PayoffKind.CLIQUET: BoundSpec(lower=0.01, upper=0.08),
}
KNOBS = {
    PayoffKind.BARRIER_UP_OUT: dict(barrier_rel=1.25),
    PayoffKind.BARRIER_DOWN_OUT: dict(barrier_rel=0.8),
    PayoffKind.FORWARD_START: dict(forward_start_step=6),
    PayoffKind.CLIQUET: dict(cliquet_reset_every=CLIQUET["reset_every"],
                             cliquet_floor=CLIQUET["floor"], cliquet_cap=CLIQUET["cap"]),
}

# The least time the card could take (bound_ms): the larger of the bytes the
# function must move (24 + 8 bytes of contract and key per contract, 4 bytes
# written per path) over 3.35 TB/s, and its operations over 67 TFLOP/s (the
# H100's float32 rate outside the tensor cores; integer and transcendental
# operations counted one each at that rate). Per draw: half a Philox call
# (10 rounds of 2 mul-hi, 2 mul-lo, 4 xor, 2 key adds = 100 operations per
# call), the two uniforms (shift, convert, fma each), log, mul, sqrt and the
# sine or cosine with its argument: 60. Per unit of the branch's loop (a
# path-step, or a period for the cliquet): the state update and the
# branch's own work.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The instruction cap (share_of_instruction_cap): one warp instruction per scheduler per
# clock, 132 SMs x 4 schedulers x 32 lanes, at the card's maximum SM clock,
# over the SASS instructions one path-step of the log-Euler loop executes.
LANES_PER_CLOCK = 132 * 4 * 32
DRAW_OPS = 60
UNIT_OPS = {"terminal": 3, "barrier": 4, "lookback": 4, "variance": 4, "asian": 5, "cliquet": 8}


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


def bound_ms(branch: str, contracts: int, steps: int) -> tuple[float, str]:
    """``(bound_ms, bound_by)`` of one launch at ``contracts x ROWS x COLS``
    over ``steps`` log-Euler steps (the op model in the module header)."""
    paths = contracts * ROWS * COLS
    units = steps // CLIQUET["reset_every"] if branch == "cliquet" else steps
    paired = branch in ("terminal", "variance", "cliquet")
    draws = -(-units // 2) if paired else units
    ops = paths * (draws * DRAW_OPS + units * UNIT_OPS[branch])
    byte_count = contracts * 32 + paths * 4
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, byte_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------------------
# 0-1. device and build
# --------------------------------------------------------------------------


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> tuple[torch.device, str, float]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    smi = nvidia_smi("name,power.limit")
    max_sm_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    runtime = get_torch_handle()
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=repr(smi), clocks_max_sm_mhz=max_sm_hz / 1e6, torch=torch.__version__,
          cuda=runtime.cuda_version)
    return torch.device("cuda", 0), smi, max_sm_hz


def phase_build() -> dict[str, float]:
    built = load_library("gbm_paths", ("gbm_paths.cu",))
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    phase("build", source=SOURCE, library=built.path.name,
          build_seconds=f"{built.build_seconds:.2f}", ptxas=repr(" | ".join(ptxas)))
    return sass_instruction_counts(built.path)


def sass_instruction_counts(library: object) -> dict[str, float]:
    """SASS instructions one log-Euler path-step executes, per branch, counted
    from ``cuobjdump -sass`` of the built library.

    In each instantiation the log-Euler loop is the loop whose body takes no
    absolute value (the Euler loop's reflection). Of its N instructions, the
    Philox block (a skipped region with >= 16 IMAD.WIDE.U32) runs every other
    draw, a slow path holding a CALL (sqrtf's fix-up) never on these inputs,
    and any other skipped region is the branch's once-per-path single step
    (TERMINAL, variance, cliquet: subtracted) or the arithmetic Asian's
    ``expf`` (kept). Per draw: N − calls − single − Philox/2; per path-step:
    that over the steps a draw covers (2 for the pair-steps, 1 per step,
    2·reset_every for the cliquet's period pairs).
    """
    cuobjdump = str(Path(find_nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, found = parse_instruction_counts(text)
    phase("sass", log_euler_loop=repr(found),
          instructions_per_path_step={b: round(c, 3) for b, c in counts.items()})
    return counts


def parse_instruction_counts(text: str) -> tuple[dict[str, float], dict[str, str]]:
    """``sass_instruction_counts`` on the text of ``cuobjdump -sass``."""
    family = {f"gbm_paths_kernelILi{code}E": b for b, code in gbm_cuda._FAMILY_CODE.items()}
    family["gbm_cliquet_kernel"] = "cliquet"
    counts, found = {}, {}
    for block in text.split("Function : ")[1:]:
        name = block.split()[0]
        branch = next((b for key, b in family.items() if key in name), None)
        if branch is None:
            continue
        ins = [(int(a, 16), op.strip())
               for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", block)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (addr, op) in enumerate(ins):
            m = re.search(r"\bBRA (?:!?P\d, )?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr and int(m.group(1), 16) in at:
                body = ins[at[int(m.group(1), 16)]:i + 1]
                if not any(re.search(r"\|R\d+\|", o) and not o.startswith("FSETP")
                           for _, o in body):
                    loops.append(body)
        body = loops[-1]
        philox = calls = single = 0
        for j, (addr, op) in enumerate(body):
            m = re.search(r"\bBRA (?:!?P\d, )?0x([0-9a-f]+)", op)
            if not (m and op.startswith("@") and addr < int(m.group(1), 16) <= body[-1][0]):
                continue
            region = [o for a, o in body if addr < a < int(m.group(1), 16)]
            if sum("IMAD.WIDE.U32" in o for o in region) >= 16:
                philox += len(region)
            elif any("CALL" in o for o in region):
                calls += len(region)
            elif branch != "asian":
                single += len(region)
        per_draw = len(body) - calls - single - philox / 2
        steps_per_draw = {"terminal": 2, "variance": 2,
                          "cliquet": 2 * CLIQUET["reset_every"]}.get(branch, 1)
        counts[branch] = per_draw / steps_per_draw
        found[branch] = f"{len(body)}-{calls}-{single}-{philox}/2={per_draw:g}/{steps_per_draw}"
    return counts, found


# --------------------------------------------------------------------------
# 2. kernel vs twin
# --------------------------------------------------------------------------


def kernel_inputs(device: torch.device, contracts: int, seed: int) -> tuple[torch.Tensor, ...]:
    gen = np.random.default_rng(seed)
    lo = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
    hi = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
    params = (lo + (hi - lo) * gen.random((contracts, 6))).astype(np.float32)
    keys = rng.fold_in(rng.prng_key(7), torch.arange(contracts, dtype=torch.int64))
    return torch.from_numpy(params).to(device), keys.to(device)


def run_pair(params, keys, payoff: PayoffKind, **kw: object) -> tuple[torch.Tensor, ...]:
    """(kernel, twin) outputs for one case."""
    if payoff == PayoffKind.CLIQUET:
        return (gbm_cuda.simulate_cliquet_rows_cuda(params, keys, **kw),
                gbm_cuda.simulate_cliquet_rows_cuda_plain(params, keys, **kw))
    return (gbm_cuda.simulate_underlier_rows_cuda(params, keys, payoff=payoff, **kw),
            gbm_cuda.simulate_underlier_rows_cuda_plain(params, keys, payoff=payoff, **kw))


def compare(
    device: torch.device, payoff: PayoffKind, contracts: int = 4, **kw: object
) -> tuple[float, float, int]:
    """``(max abs err, max scaled err, flips)`` of the kernel against its twin
    over ``contracts`` contracts; raises past the tolerances."""
    params, keys = kernel_inputs(device, contracts, seed=contracts + int(kw["timesteps"]))
    got, want = run_pair(params, keys, payoff, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{payoff.value}: kernel produced non-finite values at {kw}")
    scale = want.abs()
    if payoff in LOOKBACK_PAYOFFS:
        scale = torch.maximum(scale, params[:, 1, None, None])
    if payoff == PayoffKind.CLIQUET:
        scale = torch.clamp(scale, min=float(kw["cap"]))
    err = (got - want).abs()
    ok = err <= KERNEL_RTOL * scale
    flips = int((~ok).sum())
    jumps = payoff in BARRIER_PAYOFFS or payoff == PayoffKind.DIGITAL
    allowed = int(FLIP_SHARE * got.numel()) if jumps else 0
    if flips > allowed:
        raise AssertionError(f"{payoff.value}: {flips} paths past rtol {KERNEL_RTOL} "
                             f"(allowed {allowed}) at {kw}")
    agree = torch.where(ok, err, torch.zeros_like(err))
    return float(agree.max()), float((agree / scale).max()), flips


def kernel_cases() -> list[tuple[str, PayoffKind, dict[str, object]]]:
    """(branch, payoff, kwargs) for every case of phase 2."""
    base = dict(rows=ROWS, cols=COLS)
    cases = []
    for scheme in (PathScheme.LOG_EULER, PathScheme.EULER):
        for half in (None, ROWS // 2):
            anti = dict(base, scheme=scheme, antithetic_half=half)
            odd = (STEPS, 15) if scheme == PathScheme.LOG_EULER and half is None else (STEPS,)
            for steps in odd:
                cases.append(("terminal", PayoffKind.TERMINAL, dict(anti, timesteps=steps)))
                cases.append(("variance", PayoffKind.VARIANCE_SWAP, dict(anti, timesteps=steps)))
            cases.append(("terminal", PayoffKind.DIGITAL, dict(anti, timesteps=STEPS)))
            cases.append(("terminal", PayoffKind.FORWARD_START,
                          dict(anti, timesteps=STEPS, forward_start_step=6)))
            for payoff in (PayoffKind.BARRIER_UP_OUT, PayoffKind.BARRIER_DOWN_OUT):
                cases.append(("barrier", payoff,
                              dict(anti, timesteps=STEPS, barrier_rel=KNOBS[payoff]["barrier_rel"])))
            for payoff in sorted(LOOKBACK_PAYOFFS, key=lambda p: p.value):
                cases.append(("lookback", payoff, dict(anti, timesteps=STEPS)))
            for payoff in (PayoffKind.ASIAN_ARITHMETIC, PayoffKind.ASIAN_GEOMETRIC):
                cases.append(("asian", payoff, dict(anti, timesteps=STEPS)))
    for half in (None, ROWS // 2):
        for steps in (STEPS, 12):  # 4 periods, 3 periods (odd)
            cases.append(("cliquet", PayoffKind.CLIQUET,
                          dict(base, timesteps=steps, antithetic_half=half, **CLIQUET)))
    return cases


# the payoff each branch group is timed with at the training chunk
TIMED = {
    "terminal": (PayoffKind.TERMINAL, {}),
    "barrier": (PayoffKind.BARRIER_UP_OUT, dict(barrier_rel=1.25)),
    "lookback": (PayoffKind.LOOKBACK_FIXED_CALL, {}),
    "variance": (PayoffKind.VARIANCE_SWAP, {}),
    "asian": (PayoffKind.ASIAN_ARITHMETIC, {}),
    "cliquet": (PayoffKind.CLIQUET, CLIQUET),
}


def phase_kernel(
    device: torch.device, per_step: dict[str, float], max_sm_hz: float
) -> dict[str, dict[str, object]]:
    record = {b: {"max_abs_err": 0.0, "max_rel": 0.0, "flips": 0, "cases": 0} for b in TIMED}
    for branch, payoff, kw in kernel_cases():
        abs_err, rel, flips = compare(device, payoff, **kw)
        r = record[branch]
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["max_rel"] = max(r["max_rel"], rel)
        r["flips"] += flips
        r["cases"] += 1
    params, keys = kernel_inputs(device, CHUNK, seed=1)
    for branch, (payoff, extra) in TIMED.items():
        kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, **extra)
        if payoff != PayoffKind.CLIQUET:
            kw["scheme"] = PathScheme.LOG_EULER
        abs_err, rel, flips = compare(device, payoff, CHUNK, **kw)  # the timed shape, checked
        r = record[branch]
        r.update(max_abs_err=max(r["max_abs_err"], abs_err), max_rel=max(r["max_rel"], rel),
                 flips=r["flips"] + flips, cases=r["cases"] + 1)
        if payoff == PayoffKind.CLIQUET:
            kernel = lambda: gbm_cuda.simulate_cliquet_rows_cuda(params, keys, **kw)  # noqa: E731
            plain = lambda: gbm_cuda.simulate_cliquet_rows_cuda_plain(params, keys, **kw)  # noqa: E731
        else:
            kernel = lambda: gbm_cuda.simulate_underlier_rows_cuda(  # noqa: E731
                params, keys, payoff=payoff, **kw)
            plain = lambda: gbm_cuda.simulate_underlier_rows_cuda_plain(  # noqa: E731
                params, keys, payoff=payoff, **kw)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        bound, bound_by = bound_ms(branch, CHUNK, STEPS)
        path_steps = CHUNK * ROWS * COLS * STEPS
        cap = LANES_PER_CLOCK * max_sm_hz / per_step[branch]
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        phase("kernel", branch=branch, cases=r["cases"], max_rel_diff=f"{r['max_rel']:.3e}",
              max_abs_err=f"{r['max_abs_err']:.3e}", flips=r["flips"], rtol=KERNEL_RTOL,
              shape=f"{CHUNK}x{ROWS}x{COLS}x{STEPS}", timed=payoff.value,
              kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.3f}",
              bound_by=bound_by, share_of_bound=f"{bound / ms:.4f}",
              kernel_path_steps_per_s=f"{path_steps / ms * 1e3:.4e}",
              plain_path_steps_per_s=f"{path_steps / plain_ms * 1e3:.4e}",
              instruction_cap_path_steps_per_s=f"{cap:.4e}",
              share_of_instruction_cap=f"{path_steps / ms * 1e3 / cap:.4f}")
    return record


# --------------------------------------------------------------------------
# 3. oracles
# --------------------------------------------------------------------------

ORACLE_CONTRACTS = [
    [100.0, 100.0, 1.0, 0.03, 0.01, 0.25],  # ATM
    [100.0, 110.0, 1.0, 0.03, 0.01, 0.25],  # ITM put
    [100.0, 90.0, 1.0, 0.03, 0.01, 0.25],   # OTM put
]
STRIKES = {
    PayoffKind.VARIANCE_SWAP: (0.0625, 0.05, 0.08),  # vol² units; fair ≈ 0.0626
    PayoffKind.CLIQUET: (0.03, 0.0, 0.06),  # return units
}


# The lattice oracles (barrier, lookback, cliquet) carry a discretization
# error of their own. It is estimated as the change when the lattice is
# coarsened by half and added to the MC standard error in quadrature. The
# barrier's knock mask on a log grid converges at first order in the spacing
# (the up-and-out call at 2,049 points sits 4.7 SE of 1,048,576 paths above
# its limit), so the gate runs it at 8,193 points.
BARRIER_GRID = 8193


@functools.lru_cache(maxsize=None)
def lookback_prices(c: tuple[float, ...], coarse: bool = False) -> analytic.LookbackPrices:
    """All four lookbacks of a contract from one survival integration."""
    grid = dict(grid_points=769, levels=513) if coarse else {}
    return analytic.lookback_price(*c, timesteps=STEPS, **grid)


@functools.lru_cache(maxsize=None)
def oracle_prices(payoff: PayoffKind, c: tuple[float, ...]) -> tuple[tuple[float, float], ...]:
    """``((put, put_err), (call, call_err))`` of the port's oracle, each
    price NaN where the channel has none; the error is 0 for closed forms."""
    s, k, t, r, q, v = c
    nan = (math.nan, 0.0)
    if payoff == PayoffKind.TERMINAL:
        p = analytic.black_scholes_price(*c)
        return (float(p.put), 0.0), (float(p.call), 0.0)
    if payoff == PayoffKind.ASIAN_GEOMETRIC:
        p = analytic.geometric_asian_price(*c, timesteps=STEPS)
        return (float(p.put), 0.0), (float(p.call), 0.0)
    if payoff == PayoffKind.DIGITAL:
        put, call = analytic.digital_price(*c)
        return (float(put), 0.0), (float(call), 0.0)
    if payoff == PayoffKind.FORWARD_START:
        p = analytic.forward_start_price(*c, timesteps=STEPS, start_step=6)
        return (float(p.put), 0.0), (float(p.call), 0.0)
    if payoff == PayoffKind.VARIANCE_SWAP:
        p = analytic.variance_option_price(k, t, r, q, v, timesteps=STEPS)
        return (p.put, 0.0), (p.call, 0.0)
    if payoff in LOOKBACK_PAYOFFS:
        field = payoff.value.removeprefix("lookback_")
        fine = getattr(lookback_prices(c), field)
        return (fine, abs(fine - getattr(lookback_prices(c, coarse=True), field))), nan
    if payoff in BARRIER_PAYOFFS:
        fine, coarse = (
            analytic.discrete_barrier_price(*c, timesteps=STEPS, grid_points=g,
                                            up=payoff == PayoffKind.BARRIER_UP_OUT,
                                            **KNOBS[payoff])
            for g in (BARRIER_GRID, BARRIER_GRID // 2 + 1)
        )
    else:
        assert payoff == PayoffKind.CLIQUET
        fine, coarse = (
            analytic.cliquet_price(*c, timesteps=STEPS, local_floor=CLIQUET["floor"],
                                   local_cap=CLIQUET["cap"], reset_every=CLIQUET["reset_every"],
                                   grid=g)
            for g in (1 << 16, 1 << 15)
        )
    return ((fine.put, abs(fine.put - coarse.put)), (fine.call, abs(fine.call - coarse.call)))


def z_score(mean: float, se: float, want: float, err: float) -> float:
    """|MC − oracle| over the MC standard error and the oracle's own error."""
    scale = math.hypot(se, err)
    if scale == 0.0:
        return 0.0 if abs(mean - want) < 1e-6 else math.inf
    return abs(mean - want) / scale


def phase_oracle(device: torch.device) -> None:
    kinds = [PayoffKind.TERMINAL, PayoffKind.ASIAN_GEOMETRIC, *sorted(BARRIER_PAYOFFS, key=str),
             *sorted(LOOKBACK_PAYOFFS, key=lambda p: p.value), PayoffKind.VARIANCE_SWAP,
             PayoffKind.DIGITAL, PayoffKind.FORWARD_START, PayoffKind.CLIQUET,
             PayoffKind.ASIAN_ARITHMETIC]
    for payoff in kinds:
        sim = build_simulation_params(
            timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=3,
            implementation="cuda", normalization="none", payoff=payoff.value,
            **KNOBS.get(payoff, {}),
        ).expect("oracle sim")
        rows_of = make_underlier_simulator(sim, rows=ROWS)
        base = [list(c) for c in ORACLE_CONTRACTS]
        for i, strike in enumerate(STRIKES.get(payoff, ())):
            base[i][1] = strike
        contracts = torch.tensor(base, dtype=torch.float32, device=device)
        keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), torch.arange(3, device=device))
        u = rows_of(keys, contracts).reshape(3, -1)
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"{payoff.value}: non-finite underliers")
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            mean = u.double().mean(dim=1).cpu().numpy()
            se = (u.double().std(dim=1) / math.sqrt(u.shape[1])).cpu().numpy()
            want = expected_underlier_mean(contracts.double().cpu(), timesteps=STEPS,
                                           payoff=payoff, dtype=torch.float64).numpy()
            z = np.abs(mean - want) / se
            if not np.all(z < 4.0):
                raise AssertionError(f"asian_arithmetic mean {mean} vs {want}: z={z}")
            phase("oracle", payoff=payoff.value, paths=u.shape[1], mc_mean=np.round(mean, 5).tolist(),
                  expected=np.round(want, 5).tolist(), z=np.round(z, 3).tolist())
            continue
        prices = terminal_to_prices(u, contracts, normalize=False, dtype=torch.float32)
        found = {}
        for side, pay in (("put", prices.put_payoffs), ("call", prices.call_payoffs)):
            pay = pay.double()
            mean = pay.mean(dim=1).cpu().numpy()
            se = (pay.std(dim=1) / math.sqrt(pay.shape[1])).cpu().numpy()
            for i, c in enumerate(base):
                want, err = oracle_prices(payoff, tuple(c))[0 if side == "put" else 1]
                if math.isnan(want):
                    continue
                z = z_score(float(mean[i]), float(se[i]), want, err)
                if not z < 4.0:
                    raise AssertionError(f"{payoff.value} {side} contract {i}: MC {mean[i]:.6f} "
                                         f"± {se[i]:.2e} vs oracle {want:.6f} ± {err:.1e} "
                                         f"(z={z:.2f})")
                found.setdefault(side, []).append(
                    (round(float(mean[i]), 5), round(float(se[i]), 5), round(want, 5),
                     float(f"{err:.2g}"), round(z, 3)))
        phase("oracle", payoff=payoff.value, paths=u.shape[1],
              **{f"{side}_mc_se_oracle_err_z": repr(v) for side, v in found.items()})


# --------------------------------------------------------------------------
# 4-8. the trainer: train, resume, serve
# --------------------------------------------------------------------------


def production_cvnn():
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
        seed=11,
    ).expect("cvnn")


def bounds_for(payoff: PayoffKind) -> dict[str, BoundSpec]:
    return {**BOUNDS, "strike": STRIKE_BOUNDS.get(payoff, BOUNDS["strike"])}


def pricer_config(payoff: PayoffKind = PayoffKind.TERMINAL) -> GbmCVNNPricerConfig:
    closed = has_closed_form_mean(ModelKind.GBM, payoff)
    mean_ok = closed and payoff not in (PayoffKind.DIGITAL, PayoffKind.CLIQUET)
    sim = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=7,
        implementation="cuda", payoff=payoff.value,
        normalization="mean" if mean_ok else "none", **KNOBS.get(payoff, {}),
    ).expect("sim")
    return GbmCVNNPricerConfig(sim=sim, bounds=bounds_for(payoff), cvnn=production_cvnn(),
                               normalize_inputs=True)


def train_steps(
    pricer: GbmCVNNPricer, n: int, *, batch: int = BATCH, chunk: int = CHUNK
) -> tuple[np.ndarray, list[float]]:
    """``n`` single-batch train calls, each timed to a synchronised end."""
    cfg = build_training_config(
        num_batches=1, batch_size=batch, learning_rate=1e-3, contract_chunk=chunk
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


def phase_train(device: torch.device, payoff: PayoffKind, label: str) -> GbmCVNNPricer:
    pricer = GbmCVNNPricer.create(pricer_config(payoff), device=device).expect("create")
    branch = gbm_cuda.branch_of(payoff)
    before = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
    losses, seconds = train_steps(pricer, 3)
    launched = gbm_cuda.LAUNCHES_BY_BRANCH[branch] - before
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    if launched != 3 * BATCH // CHUNK:
        raise AssertionError(f"{branch} kernel launched {launched} times in 3 steps, "
                             f"want {3 * BATCH // CHUNK}")
    snap = pricer.snapshot()
    phase(label, payoff=payoff.value, engine=snap.sim.implementation.value,
          normalization=snap.sim.normalization.value, stream_version=snap.cuda_stream_version,
          losses=losses.tolist(), launches=launched, step_seconds=[round(s, 4) for s in seconds],
          median_step_s=f"{statistics.median(seconds):.4f}",
          paths_per_contract=ROWS * COLS, batch=BATCH, chunk=CHUNK)
    return pricer


def phase_resume(device: torch.device, pricer: GbmCVNNPricer, label: str) -> None:
    resumed = GbmCVNNPricer.create(pricer.snapshot(), device=device).expect("resume")
    a, _ = train_steps(pricer, 2)
    b, _ = train_steps(resumed, 2)
    if not np.array_equal(a, b):
        raise AssertionError(f"resume is not bit-exact: {a} vs {b}")
    phase(label, continued=a.tolist(), resumed=b.tolist(), bit_equal=True)


def held_out(payoff: PayoffKind, n: int) -> np.ndarray:
    sampler = SobolSampler.create(BlackScholesContract, bounds_for(payoff),
                                  SobolConfig(seed=7)).expect("sampler")
    return sampler.sample_array(n, device="cpu", start=1 << 20).numpy()


def check_prices(pricer: GbmCVNNPricer, batch: np.ndarray, device: torch.device) -> object:
    """Finite puts; NaN calls exactly where E[u] has no closed form; else
    call − put = df·(E[u] − K) to 1e-5, relative to the largest of the terms
    (the parity term, the strike and the put, whose float32 rounding the
    difference carries), with E[u] the payoff's own mean as the pricer
    evaluates it on the card."""
    sim = pricer.snapshot().sim
    pred = pricer.predict_price(batch)
    if not np.all(np.isfinite(pred.put)):
        raise AssertionError(f"{sim.payoff.value}: non-finite puts {pred.put}")
    if not has_closed_form_mean(sim.model, sim.payoff):
        if not np.all(np.isnan(pred.call)):
            raise AssertionError(f"{sim.payoff.value}: calls should be NaN, got {pred.call}")
        return pred
    mean = make_mean_target(sim)(torch.from_numpy(batch).to(device)).double().cpu().numpy()
    b = batch.astype(np.float64)
    parity = np.exp(-b[:, 3] * b[:, 2]) * (mean - b[:, 1])
    gap = np.abs((pred.call - pred.put) - parity)
    scale = np.maximum(np.maximum(np.abs(parity), b[:, 1]), np.abs(pred.put))
    if not np.all(gap <= 1e-5 * scale):
        raise AssertionError(f"{sim.payoff.value}: call − put misses df·(E[u] − K) by "
                             f"{gap.max():.3g}")
    return pred


def phase_serve(pricer: GbmCVNNPricer, device: torch.device, label: str) -> dict[int, float]:
    payoff = pricer.snapshot().sim.payoff
    rows = held_out(payoff, 64)
    p50 = {}
    for n in (1, 7, 64):
        batch = rows[:n]
        pred = check_prices(pricer, batch, device)
        padded = pricer.predict_price(batch, pad_to_bucket=True)
        if not (np.array_equal(pred.put, padded.put)
                and np.array_equal(pred.call, padded.call, equal_nan=True)):
            raise AssertionError(f"pad_to_bucket changed the prices at N={n}")
        times = []
        for _ in range(20):
            start = time.perf_counter()
            pricer.predict_price(batch)
            times.append((time.perf_counter() - start) * 1e3)
        p50[n] = statistics.median(times)
    extra = {}
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        # the float32 series g(g^N − 1)/(g − 1) the pricer evaluates, against
        # float64: its cancellation costs ~1.2e-7/|g − 1| relative
        b = torch.from_numpy(rows)
        f32 = expected_underlier_mean(b.to(device), timesteps=STEPS, payoff=payoff,
                                      dtype=torch.float32).double().cpu()
        f64 = expected_underlier_mean(b.double(), timesteps=STEPS, payoff=payoff,
                                      dtype=torch.float64)
        extra["mean_f32_vs_f64_max_rel"] = f"{float(((f32 - f64) / f64).abs().max()):.3e}"
    phase(label, payoff=payoff.value, held_out_skip=1 << 20,
          puts_n64=np.round(pred.put[:4], 4).tolist(),
          p50_ms={k: round(v, 4) for k, v in p50.items()}, pad_bit_equal=True, parity_ok=True,
          **extra)
    return p50


def phase_payoffs(device: torch.device) -> None:
    kinds = [p for p in PayoffKind
             if not p.value.startswith("american")
             and p not in (PayoffKind.TERMINAL, PayoffKind.ASIAN_ARITHMETIC)]
    batch = held_out(PayoffKind.TERMINAL, 8)
    for payoff in kinds:
        pricer = GbmCVNNPricer.create(pricer_config(payoff), device=device).expect(payoff.value)
        branch = gbm_cuda.branch_of(payoff)
        before = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
        losses, seconds = train_steps(pricer, 1, batch=PAYOFF_BATCH, chunk=PAYOFF_BATCH)
        launched = gbm_cuda.LAUNCHES_BY_BRANCH[branch] - before
        snap = pricer.snapshot()
        key = "gbm_cliquet" if payoff == PayoffKind.CLIQUET else "gbm"
        if snap.sim.implementation.value != "cuda":
            raise AssertionError(f"{payoff.value}: engine {snap.sim.implementation.value}")
        if snap.cuda_stream_version != gbm_cuda.CUDA_STREAM_VERSIONS[key] or launched != 1:
            raise AssertionError(f"{payoff.value}: stream v{snap.cuda_stream_version}, "
                                 f"{branch} launches {launched}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{payoff.value}: non-finite loss {losses}")
        own = batch.copy()
        if payoff in STRIKE_BOUNDS:
            own = held_out(payoff, 8)
        pred = check_prices(pricer, own, device)
        phase("payoffs", payoff=payoff.value, engine="cuda", stream=f"{key}_v1", branch=branch,
              launches=launched, loss=float(losses[0]), step_s=round(seconds[0], 4),
              puts=np.round(pred.put[:3], 5).tolist(),
              calls="NaN" if np.all(np.isnan(pred.call)) else "parity")


# --------------------------------------------------------------------------
# 9. profile
# --------------------------------------------------------------------------


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


def phase_profile(pricer: GbmCVNNPricer, label: str) -> None:
    _, seconds = train_steps(pricer, 10)
    cfg = build_training_config(
        num_batches=1, batch_size=BATCH, learning_rate=1e-3, contract_chunk=CHUNK
    ).expect("training config")
    wall, busy, launches, top = profiled(lambda: [pricer.train(cfg) for _ in range(3)])
    phase(f"profile-train{label}", warm_steps=len(seconds),
          median_step_s=f"{statistics.median(seconds):.4f}",
          min_step_s=f"{min(seconds):.4f}", max_step_s=f"{max(seconds):.4f}",
          profiled_steps=3, wall_ms=f"{wall:.3f}", kernel_ms=f"{busy:.3f}",
          busy=f"{busy / wall:.4f}", idle=f"{1 - busy / wall:.4f}", kernel_launches=launches,
          top=repr(top))
    rows = held_out(pricer.snapshot().sim.payoff, 64)
    for _ in range(5):
        pricer.predict_price(rows)
    wall, busy, launches, top = profiled(lambda: [pricer.predict_price(rows) for _ in range(20)])
    phase(f"profile-serve{label}", n=64, calls=20, wall_ms=f"{wall:.3f}", kernel_ms=f"{busy:.3f}",
          busy=f"{busy / wall:.4f}", kernel_launches_per_call=launches / 20, top=repr(top))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the checks, time warm train steps and profile train and serve")
    args = parser.parse_args()
    device, smi, max_sm_hz = phase_device()
    per_step = phase_build()
    kernel = phase_kernel(device, per_step, max_sm_hz)
    phase_oracle(device)
    launches: dict[str, int] = {}
    gbm_cuda.reset_launches()  # the TERMINAL path's count starts here
    pricer = phase_train(device, PayoffKind.TERMINAL, "train")
    phase_resume(device, pricer, "resume")
    phase_serve(pricer, device, "serve")
    launches["terminal"] = gbm_cuda.LAUNCHES_BY_BRANCH["terminal"]
    gbm_cuda.reset_launches()  # the Asian path's count starts here
    asian = phase_train(device, PayoffKind.ASIAN_ARITHMETIC, "train-asian")
    phase_resume(device, asian, "resume-asian")
    phase_serve(asian, device, "serve-asian")
    launches["asian"] = gbm_cuda.LAUNCHES_BY_BRANCH["asian"]
    gbm_cuda.reset_launches()  # the other payoffs' path starts here
    phase_payoffs(device)
    for branch in ("barrier", "lookback", "variance", "cliquet"):
        launches[branch] = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
    missing = [b for b, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main paths never launched the {missing} kernel branches")
    if args.profile:
        phase_profile(pricer, "")
        phase_profile(asian, "-asian")
    print(json.dumps({"kernels": [{
        "name": f"gbm_{branch}",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES.get(branch, "spectralmc_tpu/ops/gbm_pallas.py:512"),
        "launches": launches[branch],
        "max_abs_err": kernel[branch]["max_abs_err"],
        "ms": kernel[branch]["ms"],
        "plain_ms": kernel[branch]["plain_ms"],
        "bound_ms": kernel[branch]["bound_ms"],
        "bound_by": kernel[branch]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes these functions
    } for branch in TIMED]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
