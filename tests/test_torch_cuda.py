"""The CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
elsewhere. The file imports neither JAX nor the JAX package, so it runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest``: the suite's conftest sets up JAX.) Tier 3, rtol 2e-5
(libm and ``sinpif``/``cospif`` ulps between torch ops and the device
intrinsics).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from spectralmc_tpu_torch.ops import (
    american_cuda,
    basket_cuda,
    dynamics_cuda,
    gbm_cuda,
    qmc,
    qmc_cuda,
    rng,
)
from spectralmc_tpu_torch.ops import basket as tbasket
from spectralmc_tpu_torch.ops import gbm as tgbm


def _contracts(n: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    lo = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
    hi = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
    return (lo + (hi - lo) * gen.random((n, 6))).astype(np.float32)


def _require_card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card (README: the port's chip tests)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", [tgbm.PathScheme.LOG_EULER, tgbm.PathScheme.EULER])
def test_kernel_matches_twin_on_card(scheme) -> None:
    """Tier 3 on the card, rtol 2e-5 (libm vs device intrinsics)."""
    device = _require_card()
    c = torch.from_numpy(_contracts(3, seed=6)).to(device)
    keys = rng.fold_in(rng.prng_key(6), torch.arange(3)).to(device)
    kw = dict(timesteps=9, rows=64, cols=96, scheme=scheme, antithetic_half=32)
    before = gbm_cuda.LAUNCHES
    got = gbm_cuda.simulate_underlier_rows_cuda(c, keys, payoff=tgbm.PayoffKind.TERMINAL, **kw)
    assert gbm_cuda.LAUNCHES == before + 1
    want = gbm_cuda.simulate_terminal_rows_cuda_plain(c, keys, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)


BRANCH_PAYOFFS = [
    ("barrier_up_out", 1.25), ("barrier_down_out", 0.8), ("lookback_fixed_call", None),
    ("lookback_fixed_put", None), ("lookback_float_call", None), ("lookback_float_put", None),
    ("variance_swap", None), ("asian_arithmetic", None), ("asian_geometric", None),
    ("digital", None), ("forward_start", None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", [tgbm.PathScheme.LOG_EULER, tgbm.PathScheme.EULER])
@pytest.mark.parametrize("payoff,barrier_rel", BRANCH_PAYOFFS,
                         ids=[p for p, _ in BRANCH_PAYOFFS])
def test_branch_kernel_matches_twin_on_card(payoff, barrier_rel, scheme) -> None:
    """Tier 3 on the card: rtol 2e-5 on continuous outputs, measured against
    the strike for the lookback encodings (differences of prices such as
    2K − M cross zero); the barrier knock and the digital sign may flip on at
    most 1e-5 of the paths (a few ulps either side of the level), where the
    values jump."""
    device = _require_card()
    payoff = tgbm.PayoffKind(payoff)
    c = torch.from_numpy(_contracts(3, seed=7)).to(device)
    keys = rng.fold_in(rng.prng_key(7), torch.arange(3)).to(device)
    kw = dict(timesteps=9, rows=64, cols=96, scheme=scheme, payoff=payoff,
              barrier_rel=barrier_rel, antithetic_half=32,
              forward_start_step=4 if payoff == tgbm.PayoffKind.FORWARD_START else None)
    before = gbm_cuda.LAUNCHES
    got = gbm_cuda.simulate_underlier_rows_cuda(c, keys, **kw)
    assert gbm_cuda.LAUNCHES == before + 1
    want = gbm_cuda.simulate_underlier_rows_cuda_plain(c, keys, **kw)
    scale = want.abs()
    if payoff in tgbm.LOOKBACK_PAYOFFS:
        scale = torch.maximum(scale, c[:, 1, None, None])
    close = (got - want).abs() <= 2e-5 * scale
    jumps = payoff in tgbm.BARRIER_PAYOFFS or payoff == tgbm.PayoffKind.DIGITAL
    assert int((~close).sum()) <= (int(1e-5 * got.numel()) if jumps else 0)


WALK_PAYOFFS = [("terminal", None), *BRANCH_PAYOFFS]
WALK_CASES = [(payoff, barrier_rel, steps) for payoff, barrier_rel in WALK_PAYOFFS
              for steps in (1, 15, 16) if not (payoff == "forward_start" and steps == 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("half", [None, 512], ids=["plain", "anti"])
@pytest.mark.parametrize("scheme", [tgbm.PathScheme.LOG_EULER, tgbm.PathScheme.EULER])
@pytest.mark.parametrize("payoff,barrier_rel,steps", WALK_CASES,
                         ids=[f"{p}-{t}" for p, _, t in WALK_CASES])
def test_walk_kernel_matches_twin_at_step_counts_on_card(payoff, barrier_rel, steps, scheme,
                                                         half) -> None:
    """Tier 3 on the card at 1, 15 and 16 steps: the walks over whole Philox
    calls at one draw, at a pair count that ends on half a call with the
    odd step in the call's other half, and at the main path's count. The
    gates of ``test_branch_kernel_matches_twin_on_card`` (rtol 2e-5; knocks
    and signs flipped on at most 1e-5 of the paths, here 1,048,576 paths so
    that the share allows whole paths), and at one step, where a value is
    one difference of two terms (the reflection-Euler price |S·(1 + (r−q)dt
    + vol√dt·z)|, the one squared increment of a variance swap), the error
    is measured against the terms' size: the spot, or vol²."""
    device = _require_card()
    payoff = tgbm.PayoffKind(payoff)
    c = torch.from_numpy(_contracts(2, seed=10)).to(device)
    keys = rng.fold_in(rng.prng_key(10), torch.arange(2)).to(device)
    kw = dict(timesteps=steps, rows=1024, cols=512, scheme=scheme, payoff=payoff,
              barrier_rel=barrier_rel, antithetic_half=half,
              forward_start_step=(steps // 2 if payoff == tgbm.PayoffKind.FORWARD_START
                                  else None))
    branch = gbm_cuda.branch_of(payoff)
    before = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
    got = gbm_cuda.simulate_underlier_rows_cuda(c, keys, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH[branch] == before + 1
    want = gbm_cuda.simulate_underlier_rows_cuda_plain(c, keys, **kw)
    assert bool(torch.isfinite(got).all())
    scale = want.abs()
    if payoff in tgbm.LOOKBACK_PAYOFFS:
        scale = torch.maximum(scale, c[:, 1, None, None])
    if steps == 1 and payoff == tgbm.PayoffKind.VARIANCE_SWAP:
        scale = torch.maximum(scale, (c[:, 5] * c[:, 5])[:, None, None])
    elif steps == 1 and scheme == tgbm.PathScheme.EULER:
        scale = torch.maximum(scale, c[:, 0, None, None])
    close = (got - want).abs() <= 2e-5 * scale
    jumps = payoff in tgbm.BARRIER_PAYOFFS or payoff == tgbm.PayoffKind.DIGITAL
    assert int((~close).sum()) <= (int(1e-5 * got.numel()) if jumps else 0)


@pytest.mark.cuda
def test_cliquet_kernel_matches_twin_on_card() -> None:
    """Exact on the card: the ``gbm_cliquet`` v2 kernel and its twin take the
    same roundings (``box_muller_pinned``, the period's FMA), so the sums are
    equal on every path."""
    device = _require_card()
    c = torch.from_numpy(_contracts(3, seed=8)).to(device)
    keys = rng.fold_in(rng.prng_key(8), torch.arange(3)).to(device)
    kw = dict(timesteps=12, rows=64, cols=96, reset_every=2, floor=-0.05, cap=0.08,
              antithetic_half=32)
    before = gbm_cuda.LAUNCHES_BY_BRANCH["cliquet"]
    got = gbm_cuda.simulate_cliquet_rows_cuda(c, keys, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["cliquet"] == before + 1
    want = gbm_cuda.simulate_cliquet_rows_cuda_plain(c, keys, **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [None, 32], ids=["plain", "anti"])
@pytest.mark.parametrize("periods", [2, 3, 4, 5, 6, 7, 9])
def test_cliquet_walk_equals_twin_at_period_counts_on_card(periods, half) -> None:
    """Exact: the walk's half call (2 periods), its single tail in the same
    call (3), one whole call (4), a tail in a second call (5), a half call
    after a whole one (6) with its single tail (7), and a tail in a third
    call (9); a second launch is bit-equal to the first."""
    device = _require_card()
    c = torch.from_numpy(_contracts(3, seed=periods)).to(device)
    keys = rng.fold_in(rng.prng_key(periods), torch.arange(3)).to(device)
    kw = dict(timesteps=4 * periods, rows=64, cols=96, reset_every=4, floor=-0.05, cap=0.08,
              antithetic_half=half)
    got = gbm_cuda.simulate_cliquet_rows_cuda(c, keys, **kw)
    assert torch.equal(gbm_cuda.simulate_cliquet_rows_cuda(c, keys, **kw), got)
    assert torch.equal(got, gbm_cuda.simulate_cliquet_rows_cuda_plain(c, keys, **kw))


# --------------------------------------------------------------------------
# The curved-term, Heston and Merton kernels (csrc/dynamics_paths.cu)
# --------------------------------------------------------------------------

STEPS = 9
TERM = tgbm.TermStructure(
    vol_shape=tuple(1.5 - i / STEPS for i in range(STEPS)),
    rate_shape=tuple(0.5 + i / STEPS for i in range(STEPS)),
)
FAMILY_LO = {
    "term": [80.0, 80.0, 0.25, 0.0, 0.0, 0.15],
    "heston": [80.0, 80.0, 0.25, 0.0, 0.0, 0.03, 1.0, 0.03, 0.2, -0.8],
    "merton": [80.0, 80.0, 0.25, 0.0, 0.0, 0.15, 0.5, -0.15, 0.1],
}
FAMILY_HI = {
    "term": [120.0, 120.0, 2.0, 0.08, 0.04, 0.45],
    "heston": [120.0, 120.0, 2.0, 0.08, 0.04, 0.08, 2.5, 0.08, 0.5, -0.3],
    "merton": [120.0, 120.0, 2.0, 0.08, 0.04, 0.25, 4.0, 0.0, 0.25],
}
FAMILY_FNS = {
    "term": (dynamics_cuda.simulate_term_rows_cuda, dynamics_cuda.simulate_term_rows_cuda_plain),
    "heston": (dynamics_cuda.simulate_heston_rows_cuda,
               dynamics_cuda.simulate_heston_rows_cuda_plain),
    "merton": (dynamics_cuda.simulate_merton_rows_cuda,
               dynamics_cuda.simulate_merton_rows_cuda_plain),
}
# Heston paths past rtol 2e-5 allowed beside the flipped knocks and signs:
# sqrt(max(v, 0)) is not Lipschitz at zero, so an ulp of a low variance grows
# from step to step. None may miss by more than HESTON_CAP_RTOL.
HESTON_SHARE = 5e-6
HESTON_CAP_RTOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["term", "heston", "merton"])
@pytest.mark.parametrize("payoff,barrier_rel", [("terminal", None), *BRANCH_PAYOFFS],
                         ids=["terminal", *(p for p, _ in BRANCH_PAYOFFS)])
def test_dynamics_kernel_matches_twin_on_card(payoff, barrier_rel, family) -> None:
    """Tier 3 on the card: rtol 2e-5 as for the flat kernel's branches, with
    the lookback encodings measured against the strike and counted flips for
    the barrier knock and the digital sign; for Heston also ``HESTON_SHARE``
    of the paths, held to ``HESTON_CAP_RTOL``. One launch per call, counted under the family's branch."""
    device = _require_card()
    payoff = tgbm.PayoffKind(payoff)
    gen = np.random.default_rng(9)
    lo, hi = np.array(FAMILY_LO[family]), np.array(FAMILY_HI[family])
    c = torch.from_numpy((lo + (hi - lo) * gen.random((3, len(lo)))).astype(np.float32)).to(device)
    keys = rng.fold_in(rng.prng_key(9), torch.arange(3)).to(device)
    kw = dict(timesteps=STEPS, rows=64, cols=96, payoff=payoff, barrier_rel=barrier_rel,
              antithetic_half=32,
              forward_start_step=4 if payoff == tgbm.PayoffKind.FORWARD_START else None)
    if family == "term":
        kw["term"] = TERM
    kernel, twin = FAMILY_FNS[family]
    before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    got = kernel(c, keys, **kw)
    launched = {b: n - before[b] for b, n in gbm_cuda.LAUNCHES_BY_BRANCH.items() if n != before[b]}
    assert list(launched.values()) == [1] and next(iter(launched)).startswith(family)
    want = twin(c, keys, **kw)
    scale = want.abs()
    if payoff in tgbm.LOOKBACK_PAYOFFS:
        scale = torch.maximum(scale, c[:, 1, None, None])
    err = (got - want).abs()
    far = int((err > 2e-5 * scale).sum())
    jumps = payoff in tgbm.BARRIER_PAYOFFS or payoff == tgbm.PayoffKind.DIGITAL
    share = (1e-5 if jumps else 0.0) + (HESTON_SHARE if family == "heston" else 0.0)
    assert far <= int(share * got.numel())
    if not jumps:
        assert bool((err <= HESTON_CAP_RTOL * scale).all())


TERM_EXACT_CASES = [(payoff, barrier_rel, steps) for payoff, barrier_rel in
                    [("terminal", None), *BRANCH_PAYOFFS] for steps in (16, 15)] + [
                    ("terminal", None, steps) for steps in (1, 2, 3, 4, 5, 7, 8)] + [
                    ("variance_swap", None, steps) for steps in (1, 2, 3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("half", [None, 32], ids=["plain", "anti"])
@pytest.mark.parametrize("payoff,barrier_rel,steps", TERM_EXACT_CASES,
                         ids=[f"{p}_T{s}" for p, _, s in TERM_EXACT_CASES])
def test_term_kernel_equals_twin_on_card(payoff, barrier_rel, steps, half) -> None:
    """Exact: the term kernel walks the ``gbm_term`` v2 words (the pair
    branches four steps a whole Philox call, the others two; every tail)
    through ``box_muller_pinned`` and steps whose every rounding the twin
    repeats, so every branch's value is the twin's on every path, under
    curves whose neighbouring steps differ; a second launch is bit-equal to
    the first and counts under the branch."""
    device = _require_card()
    payoff = tgbm.PayoffKind(payoff)
    c = torch.from_numpy(_contracts(3, seed=11 + steps)).to(device)
    keys = rng.fold_in(rng.prng_key(11), torch.arange(3)).to(device)
    term = tgbm.TermStructure(vol_shape=tuple(1.5 - i / steps for i in range(steps)),
                              rate_shape=tuple(0.5 + i / steps for i in range(steps)),
                              div_shape=tuple(1.2 - 0.3 * i / steps for i in range(steps)))
    kw = dict(timesteps=steps, rows=64, cols=96, payoff=payoff, barrier_rel=barrier_rel,
              antithetic_half=half, term=term,
              forward_start_step=(steps // 2 if payoff == tgbm.PayoffKind.FORWARD_START
                                  else None))
    kernel, twin = FAMILY_FNS["term"]
    branch = f"term_{gbm_cuda.branch_of(payoff)}"
    before = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
    got = kernel(c, keys, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH[branch] == before + 1
    assert torch.equal(kernel(c, keys, **kw), got)
    assert torch.equal(got, twin(c, keys, **kw))


@pytest.mark.cuda
def test_merton_kernel_counts_equal_the_twins_on_card() -> None:
    """Exact: with the Gaussians switched off (vol = jump_std = 0) and unit
    jumps, ln S_T − T·drift is the path's total count; the kernel's equals
    the twin's on every path, and jumps do occur."""
    device = _require_card()
    c = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 2.5, 1.0, 0.0],
                      [1.0, 1.0, 2.0, 0.0, 0.0, 0.0, 6.0, 1.0, 0.0]], device=device)
    keys = rng.fold_in(rng.prng_key(4), torch.arange(2)).to(device)
    kw = dict(timesteps=8, rows=128, cols=128, payoff=tgbm.PayoffKind.TERMINAL, antithetic_half=64)
    drift = -c[:, 6] * (math.e - 1.0) * c[:, 2]  # the compensator over the whole path
    counts = [torch.round(torch.log(fn(c, keys, **kw)) - drift[:, None, None])
              for fn in FAMILY_FNS["merton"]]
    assert torch.equal(counts[0], counts[1])
    assert float(counts[0].mean()) > 1.0 and torch.equal(counts[0][:, :64], counts[0][:, 64:])


MERTON_LOG_CASES = [(payoff, barrier_rel, 9) for payoff, barrier_rel in
                    [("terminal", None), *BRANCH_PAYOFFS]] + [
                    ("terminal", None, steps) for steps in (1, 2, 3, 4, 5, 7, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("payoff,barrier_rel,steps", MERTON_LOG_CASES,
                         ids=[f"{p}_T{s}" for p, _, s in MERTON_LOG_CASES])
def test_merton_kernel_log_price_equals_the_twins_on_card(payoff, barrier_rel, steps) -> None:
    """Exact: the Merton kernel walks the ``merton_jump`` v2 words (four
    steps on three Philox calls, a tail of ``T % 4`` steps) through the step
    of ``csrc/merton_step.cuh``, whose every rounding the twin repeats, so
    each path's final log-price is the twin's bit for bit, in every branch
    and at every tail length, with contracts whose ``lam·dt`` reaches past
    the count's first levels; a second launch is bit-equal to the first."""
    device = _require_card()
    payoff = tgbm.PayoffKind(payoff)
    gen = np.random.default_rng(17)
    lo, hi = np.array(FAMILY_LO["merton"]), np.array(FAMILY_HI["merton"])
    params = (lo + (hi - lo) * gen.random((3, len(lo)))).astype(np.float32)
    params[2, 6] = 12.0  # lam: counts past the first levels on many steps
    c = torch.from_numpy(params).to(device)
    keys = rng.fold_in(rng.prng_key(17), torch.arange(3)).to(device)
    kw = dict(timesteps=steps, rows=64, cols=96, payoff=payoff, barrier_rel=barrier_rel,
              antithetic_half=32,
              forward_start_step=4 if payoff == tgbm.PayoffKind.FORWARD_START else None)
    kernel, twin = FAMILY_FNS["merton"]
    got_trace: dict[str, torch.Tensor] = {}
    want_trace: dict[str, torch.Tensor] = {}
    before = gbm_cuda.LAUNCHES
    got = kernel(c, keys, trace=got_trace, **kw)
    assert gbm_cuda.LAUNCHES == before + 1
    assert torch.equal(kernel(c, keys, **kw), got)
    want = twin(c, keys, trace=want_trace, **kw)
    assert torch.equal(got_trace["log_price"], want_trace["log_price"])
    scale = want.abs()
    if payoff in tgbm.LOOKBACK_PAYOFFS:
        scale = torch.maximum(scale, c[:, 1, None, None])
    assert bool(((got - want).abs() <= 2e-5 * scale).all())


MERTON_WALK_STEPS = [16, 15, 14, 13, 12]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", MERTON_WALK_STEPS)
def test_american_merton_walk_equals_rolled_rows_and_terminal_on_card(steps) -> None:
    """Exact: the Merton monitor kernel at ``every = 1`` (its walk over whole
    Philox calls, four dates on three) equals its own rolled rows at every
    coarser grid that divides ``T`` on the dates they share, its last row the
    European kernel's TERMINAL value for every ``every``; tier 3 against its
    twin (rtol 2e-5: torch's ``exp`` against ``expf``), antithetic."""
    device = _require_card()
    gen = np.random.default_rng(19)
    lo, hi = np.array(FAMILY_LO["merton"]), np.array(FAMILY_HI["merton"])
    c = torch.from_numpy((lo + (hi - lo) * gen.random((3, len(lo)))).astype(np.float32)).to(device)
    keys = rng.fold_in(rng.prng_key(19), torch.arange(3)).to(device)
    kw = dict(timesteps=steps, rows=64, cols=96, antithetic_half=32)
    rows = american_cuda.simulate_merton_american_rows_cuda(c, keys, exercise_every=1, **kw)
    terminal = dynamics_cuda.simulate_merton_rows_cuda(c, keys, payoff=tgbm.PayoffKind.TERMINAL,
                                                       **kw)
    assert torch.equal(rows[:, -1], terminal)
    for every in range(2, steps // 2 + 1):
        if steps % every == 0:
            rolled = american_cuda.simulate_merton_american_rows_cuda(c, keys,
                                                                      exercise_every=every, **kw)
            assert torch.equal(rows[:, every - 1::every], rolled)
    want = american_cuda.simulate_merton_american_rows_cuda_plain(c, keys, exercise_every=1, **kw)
    torch.testing.assert_close(rows, want, rtol=2e-5, atol=0.0)


def _heston_variance_f64(c: torch.Tensor, keys: torch.Tensor, *, steps: int, rows: int,
                         cols: int, half: int | None, mask: torch.Tensor) -> torch.Tensor:
    """The Heston variance swap's value in float64 on the paths of ``mask``
    ``[C, rows, cols]``: the same Philox words, uniforms and float32
    coefficients as kernel and twin, the Box–Muller and the step in float64
    (the value both should round toward)."""
    sign, call = gbm_cuda._stream(c, keys, rows=rows, cols=cols, calls=-(-steps // 2),
                                  antithetic_half=half, row_offset=0, words=None)
    at = mask.nonzero(as_tuple=True)
    s = sign.expand(rows, cols)[at[1], at[2]].double()
    maturity, rate, div, kappa, theta, xi, rho = (c[:, i] for i in (2, 3, 4, 6, 7, 8, 9))
    dt = maturity / float(steps)
    dt, rho, rho_bar, rq_dt, kdt, ktheta_dt, xi = (
        x[at[0]].double() for x in (dt, rho, torch.sqrt(1.0 - rho * rho), (rate - div) * dt,
                                    kappa * dt, kappa * theta * dt, xi))
    v = c[at[0], 5].double()
    acc = torch.zeros_like(v)
    for j in range(steps):
        w = call(j // 2)
        a, b = (w[0], w[1]) if j % 2 == 0 else (w[2], w[3])
        u1 = gbm_cuda.uniform_open(a[at]).double()
        u2 = gbm_cuda.uniform_closed(b[at]).double()
        rad = torch.sqrt(-2.0 * torch.log(u1))
        z_v = s * rad * torch.cos(2.0 * math.pi * u2)
        z_s = rho * z_v + rho_bar * s * rad * torch.sin(2.0 * math.pi * u2)
        v_plus = torch.clamp(v, min=0.0)
        sv = torch.sqrt(v_plus * dt)
        inc = (rq_dt - 0.5 * v_plus * dt) + sv * z_s
        acc = acc + inc * inc
        v = (v + ktheta_dt - kdt * v_plus) + xi * sv * z_v
    return acc / c[at[0], 2].double()


@pytest.mark.cuda
@pytest.mark.parametrize("payoff,steps", [("terminal", 1), ("terminal", 2), ("terminal", 3),
                                          ("terminal", 15), ("forward_start", 15),
                                          ("asian_arithmetic", 15), ("variance_swap", 1),
                                          ("variance_swap", 15)])
def test_heston_pair_walk_odd_steps_and_relaunch_on_card(payoff, steps) -> None:
    """The Heston kernel walks its draws in pairs, one Philox call for two
    steps, and an odd step count ends in one tail step on the first half of
    its call: at 1, 2, 3 and 15 steps it meets the Heston gates against the
    twin, and a second launch is bit-equal to the first. The variance swap
    runs at phase 2's 4 x 2048 x 512 paths, where ``HESTON_SHARE`` allows 20
    misses. Its one-step value is the square of one increment, which may
    cancel to near 0, where an ulp of the normal is no longer small against
    it; there it takes the variance rows' gate (atol 1e-6 + rtol 2e-5, none
    past ``HESTON_CAP_RTOL`` of max(value, θ)). The paths past rtol 2e-5
    alone are printed."""
    device = _require_card()
    payoff = tgbm.PayoffKind(payoff)
    variance = payoff == tgbm.PayoffKind.VARIANCE_SWAP
    contracts, rows, cols, half = (4, 2048, 512, 1024) if variance else (3, 64, 96, 32)
    gen = np.random.default_rng(13)
    lo, hi = np.array(FAMILY_LO["heston"]), np.array(FAMILY_HI["heston"])
    c = torch.from_numpy(
        (lo + (hi - lo) * gen.random((contracts, len(lo)))).astype(np.float32)).to(device)
    keys = rng.fold_in(rng.prng_key(13), torch.arange(contracts)).to(device)
    kw = dict(timesteps=steps, rows=rows, cols=cols, payoff=payoff, antithetic_half=half,
              forward_start_step=(steps // 2 if payoff == tgbm.PayoffKind.FORWARD_START
                                  else None))
    kernel, twin = FAMILY_FNS["heston"]
    got = kernel(c, keys, **kw)
    assert torch.equal(kernel(c, keys, **kw), got)
    want = twin(c, keys, **kw)
    err = (got - want).abs()
    past_rtol = int((err > 2e-5 * want.abs()).sum())
    if variance:
        missed = err > 2e-5 * want.abs()
        exact = _heston_variance_f64(c, keys, steps=steps, rows=rows, cols=cols, half=half,
                                     mask=missed)
        kernel_off = ((got[missed].double() - exact).abs() / exact).tolist()
        twin_off = ((want[missed].double() - exact).abs() / exact).tolist()
        print(f"variance_swap steps={steps} paths={got.numel()} past_rtol_2e-5={past_rtol} "
              f"past_atol_1e-6_rtol_2e-5={int((err > 1e-6 + 2e-5 * want.abs()).sum())} "
              f"max_rel={float((err / want.abs()).max()):.3e} "
              f"bit_equal={int((got == want).sum())} "
              f"missed_rel_to_float64_kernel={[f'{x:.2e}' for x in kernel_off[:12]]} "
              f"twin={[f'{x:.2e}' for x in twin_off[:12]]} "
              f"kernel_closer={sum(k < t for k, t in zip(kernel_off, twin_off))}")
    if variance and steps == 1:
        theta = c[:, 7, None, None]
        assert int((err > 1e-6 + 2e-5 * want.abs()).sum()) <= int(HESTON_SHARE * got.numel())
        assert bool((err <= HESTON_CAP_RTOL * torch.maximum(want.abs(), theta)).all())
    else:
        assert past_rtol <= int(HESTON_SHARE * got.numel())
        assert bool((err <= HESTON_CAP_RTOL * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("half", [None, 1024], ids=["plain", "anti"])
def test_heston_variance_rows_equal_the_twins_on_card(half) -> None:
    """Exact: the Heston draw and step run on fixed roundings that the twin
    repeats, so at phase 2's 4 x 2048 x 512 paths and 16 dates the monitor
    kernel's variance rows are the twin's bit for bit, and so is the
    European kernel's variance swap (the same step, its increment summed
    first); the price rows, exp of the same log-price, within rtol 2e-5."""
    device = _require_card()
    gen = np.random.default_rng(17)
    lo, hi = np.array(FAMILY_LO["heston"]), np.array(FAMILY_HI["heston"])
    c = torch.from_numpy((lo + (hi - lo) * gen.random((4, len(lo)))).astype(np.float32)).to(device)
    keys = rng.fold_in(rng.prng_key(17), torch.arange(4)).to(device)
    kw = dict(timesteps=16, rows=2048, cols=512, exercise_every=1, antithetic_half=half)
    price, var = american_cuda.simulate_heston_american_rows_cuda(c, keys, **kw)
    price_w, var_w = american_cuda.simulate_heston_american_rows_cuda_plain(c, keys, **kw)
    print(f"heston rows half={half} var_not_bit_equal={int((var != var_w).sum())} "
          f"price_not_bit_equal={int((price != price_w).sum())} of {var.numel()}")
    assert torch.equal(var, var_w)
    torch.testing.assert_close(price, price_w, rtol=2e-5, atol=0.0)
    vkw = dict(timesteps=16, rows=2048, cols=512, payoff=tgbm.PayoffKind.VARIANCE_SWAP,
               antithetic_half=half)
    kernel, twin = FAMILY_FNS["heston"]
    assert torch.equal(kernel(c, keys, **vkw), twin(c, keys, **vkw))


# --------------------------------------------------------------------------
# The basket kernel (csrc/basket_paths.cu)
# --------------------------------------------------------------------------


def _box_muller_words() -> torch.Tensor:
    """A grid of (u1, u2) words: the 24-bit u1 codes at both ends (u1 from
    2^-25 up, and down to 1 − 2^-25, which the FMA rounds to 1) and spread
    between, against 256 u2 codes over [0, 1) with both ends."""
    top = 2**24
    u1 = np.unique(np.concatenate([np.arange(4096), top - 1 - np.arange(4096),
                                   np.linspace(0, top - 1, 8192).astype(np.int64)]))
    u2 = np.unique(np.concatenate([np.linspace(0, top - 1, 252).astype(np.int64),
                                   [1, top // 2 - 1, top // 2, top // 2 + 1]]))
    a, b = np.meshgrid(u1 << 8, u2 << 8, indexing="ij")
    return torch.from_numpy(np.stack([a.ravel(), b.ravel()], axis=1))


@pytest.mark.cuda
def test_basket_box_muller_matches_twin_on_card() -> None:
    """The basket kernels' SFU Box–Muller against the twins' torch math on
    a grid of (u1, u2) with u1 → 1 and u1 → 2^-25: |z − z_twin| within
    1.2e-6·max(r, 1), r = √(−2 ln u1) ≤ 5.9. MUFU.SIN and MUFU.COS hold
    2^-21.4 of absolute error on [−π, π), the angle 2π·(u2 − ½) at most
    3·2^-24 of it relative more (its rounding and the SFU's argument
    scaling), and the radius is relative-accurate to a few ulps (the log's
    polynomial near 1, MUFU.LG2 below ½, MUFU.RSQ); u1 = 1 gives 0."""
    device = _require_card()
    words = _box_muller_words()
    got = basket_cuda.box_muller_normals(words.to(device)).cpu()
    want = basket_cuda.box_muller_normals(words)
    rad = want.norm(dim=1, keepdim=True)
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= 1.2e-6 * torch.clamp(rad, min=1.0)).all()), float(err.max())
    ones = (words[:, 0] >> 8) == 2**24 - 1
    assert bool((got[ones] == 0).all())
    print(f"box_muller max_abs_err={float(err.max()):.3e} max_rel_to_radius="
          f"{float((err / torch.clamp(rad, min=1.0)).max()):.3e} draws={words.shape[0]}")


def _basket_spec(assets: int, combine: str) -> tbasket.BasketSpec:
    corr = tuple(tuple(1.0 if i == j else 0.3 / (1 + abs(i - j)) for j in range(assets))
                 for i in range(assets))
    weights = tuple(w / sum(range(1, assets + 1)) for w in range(assets, 0, -1))
    return tbasket.build_basket_spec(
        weights=weights, correlation=corr, combine=combine,
        spot_multipliers=tuple(1.0 + 0.05 * a for a in range(assets)),
        vol_multipliers=tuple(1.2 - 0.1 * a for a in range(assets)),
    ).expect("spec")


@pytest.mark.cuda
@pytest.mark.parametrize("assets", [1, 3, 8])
@pytest.mark.parametrize("combine", ["arithmetic", "geometric"])
@pytest.mark.parametrize("payoff,barrier_rel", [("terminal", None), *BRANCH_PAYOFFS],
                         ids=["terminal", *(p for p, _ in BRANCH_PAYOFFS)])
def test_basket_kernel_matches_twin_on_card(payoff, barrier_rel, combine, assets) -> None:
    """Tier 3 on the card: rtol 2e-5 (the lookbacks against the strike, the
    variance swap against its scale 0.01), the barrier knock and the digital
    sign flipped on at most 1e-5 of the paths; one launch under the basket
    branch per call."""
    device = _require_card()
    payoff = tgbm.PayoffKind(payoff)
    c = torch.from_numpy(_contracts(3, seed=10)).to(device)
    keys = rng.fold_in(rng.prng_key(10), torch.arange(3)).to(device)
    kw = dict(spec=_basket_spec(assets, combine), timesteps=STEPS, rows=64, cols=96,
              payoff=payoff, barrier_rel=barrier_rel, antithetic_half=32,
              forward_start_step=4 if payoff == tgbm.PayoffKind.FORWARD_START else None)
    before = gbm_cuda.LAUNCHES
    got = basket_cuda.simulate_basket_rows_cuda(c, keys, **kw)
    assert gbm_cuda.LAUNCHES == before + 1
    want = basket_cuda.simulate_basket_rows_cuda_plain(c, keys, **kw)
    scale = want.abs()
    if payoff in tgbm.LOOKBACK_PAYOFFS:
        scale = torch.maximum(scale, c[:, 1, None, None])
    if payoff == tgbm.PayoffKind.VARIANCE_SWAP:
        scale = torch.clamp(scale, min=0.01)
    far = int(((got - want).abs() > 2e-5 * scale).sum())
    jumps = payoff in tgbm.BARRIER_PAYOFFS or payoff == tgbm.PayoffKind.DIGITAL
    assert far <= (int(1e-5 * got.numel()) if jumps else 0)


# --------------------------------------------------------------------------
# The QMC generator's kernels (csrc/qmc_paths.cu)
# --------------------------------------------------------------------------


def _qmc_inputs(device: torch.device, steps: int, factors: int, contracts: int = 2):
    keys = rng.fold_in(rng.prng_key(12), torch.arange(contracts)).to(device)
    sdims, dirs, shift, pad_keys = qmc._draw_tables(keys, steps, factors, 5)
    bridge = torch.as_tensor(qmc.brownian_bridge_matrix(steps), dtype=torch.float32,
                             device=device)
    return sdims, dirs, shift, pad_keys, bridge


@pytest.mark.cuda
@pytest.mark.parametrize("steps,factors,start", [(16, 1, 0), (12, 2, 37), (5, 3, 4096),
                                                  (32, 3, 1000), (70, 1, 3)],
                         ids=["F1", "F2", "F3", "F3_padded", "T70_padded"])
def test_qmc_bridge_kernel_matches_twin_on_card(steps, factors, start) -> None:
    """Words equal; identity-bridge normals within 2 float32 ulps of the
    twin's (the two sides' log1p); bridged normals within atol 1e-5."""
    device = _require_card()
    count = 3000
    sdims, dirs, shift, pad_keys, bridge = _qmc_inputs(device, steps, factors)
    pad = None
    if sdims < steps * factors:
        pad = qmc.qmc_pad_normals(pad_keys, range(sdims, steps * factors), rows=3, cols=1000,
                                  row_offset=0)
    words = torch.empty((2, sdims, count), dtype=torch.int32, device=device)
    kw = dict(timesteps=steps, factors=factors, count=count, pad=pad)
    before = gbm_cuda.LAUNCHES_BY_BRANCH["qmc_bridge"]
    got = qmc_cuda.bridge_normals(dirs, shift, bridge, start, words_out=words, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["qmc_bridge"] == before + 1
    want_words = qmc_cuda.sobol_words(dirs, shift, start, count)
    assert torch.equal(words.to(torch.int64) & 0xFFFFFFFF, want_words)
    eye = torch.eye(steps, dtype=torch.float32, device=device)
    z_kernel = qmc_cuda.bridge_normals(dirs, shift, eye, start, **kw)
    z_twin = qmc_cuda.bridge_normals_plain(dirs, shift, eye, start, **kw)
    ulp = torch.abs(torch.nextafter(z_twin, torch.full_like(z_twin, math.inf)) - z_twin)
    assert bool(((z_kernel - z_twin).abs() <= 2 * ulp).all())
    want = qmc_cuda.bridge_normals_plain(dirs, shift, bridge, start, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


SPARSE_BRIDGE_CASES = [(8, 1, 0), (16, 1, 0), (16, 2, 37), (16, 3, 1021), (32, 3, 1000),
                       (64, 1, 3), (64, 2, 99)]


@pytest.mark.cuda
@pytest.mark.parametrize("steps,factors,start", SPARSE_BRIDGE_CASES,
                         ids=[f"T{t}_F{f}_{s}" for t, f, s in SPARSE_BRIDGE_CASES])
def test_qmc_sparse_bridge_equals_twin_and_dense_on_card(steps, factors, start) -> None:
    """Exact: the sparse instantiation of #13 (the matrix's zeros are the
    compiled pattern) equals the dense instantiation on the same inputs and
    the plain twin, bit for bit, across a thread's pair, a 512-point block
    and the range's edges, with its bridge handed over on the CPU (the main
    path's way) or on the card; padded at T = 32, F = 3 and T = 64, F = 2;
    its words equal the Sobol words."""
    device = _require_card()
    count = 3001
    sdims, dirs, shift, pad_keys, bridge = _qmc_inputs(device, steps, factors)
    assert qmc_cuda.sparse_walk(bridge, steps)
    pad = None
    if sdims < steps * factors:
        pad = qmc.qmc_pad_normals(pad_keys, range(sdims, steps * factors), rows=1, cols=count,
                                  row_offset=0)
    kw = dict(timesteps=steps, factors=factors, count=count, pad=pad)
    words = torch.empty((2, sdims, count), dtype=torch.int32, device=device)
    before = gbm_cuda.LAUNCHES_BY_BRANCH["qmc_bridge"]
    got = qmc_cuda.bridge_normals(dirs, shift, bridge.cpu(), start, words_out=words, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["qmc_bridge"] == before + 1
    assert torch.equal(words.to(torch.int64) & 0xFFFFFFFF,
                       qmc_cuda.sobol_words(dirs, shift, start, count))
    again = qmc_cuda.bridge_normals(dirs, shift, bridge, start, **kw)
    dense = qmc_cuda.bridge_normals(dirs, shift, bridge, start, dense=True, **kw)
    twin = qmc_cuda.bridge_normals_plain(dirs, shift, bridge, start, **kw)
    assert torch.equal(got, again) and torch.equal(got, dense) and torch.equal(got, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,start", [(16, 0), (7, 99), (64, 2048)])
def test_qmc_walk_kernel_equals_bridge_kernel_plus_scan(steps, start) -> None:
    """Exact: the fused walk's sums equal the bridge kernel's normals walked
    by the torch scan, bit for bit."""
    device = _require_card()
    count = 5000
    _, dirs, shift, _, bridge = _qmc_inputs(device, steps, 1)
    log_spot = torch.log(torch.tensor([100.0, 90.0], device=device))
    drift = torch.tensor([0.0011, -0.0004], device=device)
    vol_sdt = torch.tensor([0.06, 0.09], device=device)
    before = gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"]
    got = qmc_cuda.walk_acc(dirs, shift, bridge, start, log_spot, drift, vol_sdt,
                            timesteps=steps, count=count)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"] == before + 1
    eff = qmc_cuda.bridge_normals(dirs, shift, bridge, start, timesteps=steps, factors=1,
                                  count=count)[:, :, 0]
    logx = torch.zeros((2, count), device=device) + log_spot[:, None]
    acc = torch.zeros_like(logx)
    for t in range(steps):
        logx = logx + drift[:, None] + vol_sdt[:, None] * eff[:, t]
        acc = acc + logx
    assert torch.equal(got, acc)


WALK_EDGES = [(start, count) for start in (0, 1, 3, 99, 1021, 2048) for count in (5000, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("start,count", WALK_EDGES, ids=[f"{s}-{n}" for s, n in WALK_EDGES])
def test_qmc_sparse_walk_equals_bridge_plus_scan_and_twin(start, count) -> None:
    """Exact, at T = 16 (the sparse, Gray-stepped instantiation) across a
    quad's, a 1,024-point block's and the range's edges: the fused walk's
    sums equal the bridge kernel's normals walked by the torch scan and the
    plain twin's, bit for bit; the bridge handed over on the CPU (the main
    path's way) or on the card gives the same sums."""
    device = _require_card()
    _, dirs, shift, _, bridge = _qmc_inputs(device, 16, 1)
    assert qmc_cuda.sparse_walk(bridge, 16)
    scalars = (torch.log(torch.tensor([100.0, 90.0], device=device)),
               torch.tensor([0.0011, -0.0004], device=device),
               torch.tensor([0.06, 0.09], device=device))
    before = gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"]
    got = qmc_cuda.walk_acc(dirs, shift, bridge.cpu(), start, *scalars, timesteps=16, count=count)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"] == before + 1
    again = qmc_cuda.walk_acc(dirs, shift, bridge, start, *scalars, timesteps=16, count=count)
    eff = qmc_cuda.bridge_normals(dirs, shift, bridge, start, timesteps=16, factors=1,
                                  count=count)[:, :, 0]
    logx = torch.zeros((2, count), device=device) + scalars[0][:, None]
    acc = torch.zeros_like(logx)
    for t in range(16):
        logx = logx + scalars[1][:, None] + scalars[2][:, None] * eff[:, t]
        acc = acc + logx
    twin = qmc_cuda.walk_acc_plain(dirs, shift, bridge, start, *scalars, timesteps=16,
                                   count=count)
    assert torch.equal(got, again) and torch.equal(got, acc) and torch.equal(got, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [8, 32, 64, 12])
def test_qmc_walk_instantiations_equal_the_twin_on_card(steps) -> None:
    """Exact: the sparse instantiations at T = 8, 32 and 64 and the dense
    walk at T = 12 equal the plain twin and the bridge kernel plus the scan,
    from a start off the quad and block grid."""
    device = _require_card()
    count, start = 3001, 1021
    _, dirs, shift, _, bridge = _qmc_inputs(device, steps, 1)
    assert qmc_cuda.sparse_walk(bridge, steps) == (steps != 12)
    scalars = (torch.log(torch.tensor([100.0, 90.0], device=device)),
               torch.tensor([0.0011, -0.0004], device=device),
               torch.tensor([0.06, 0.09], device=device))
    got = qmc_cuda.walk_acc(dirs, shift, bridge, start, *scalars, timesteps=steps, count=count)
    eff = qmc_cuda.bridge_normals(dirs, shift, bridge, start, timesteps=steps, factors=1,
                                  count=count)[:, :, 0]
    logx = torch.zeros((2, count), device=device) + scalars[0][:, None]
    acc = torch.zeros_like(logx)
    for t in range(steps):
        logx = logx + scalars[1][:, None] + scalars[2][:, None] * eff[:, t]
        acc = acc + logx
    twin = qmc_cuda.walk_acc_plain(dirs, shift, bridge, start, *scalars, timesteps=steps,
                                   count=count)
    assert torch.equal(got, acc) and torch.equal(got, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,every,half", [(16, 1, None), (15, 1, 32), (16, 2, 32),
                                              (16, 4, None), (12, 3, 32), (15, 5, None),
                                              (16, 8, None), (12, 6, 32)])
def test_american_rows_kernel_matches_twin_on_card(steps, every, half) -> None:
    """Tier 3 on the card, rtol 2e-5 on the monitor-date prices (the
    Box–Muller on the SFU against the twin's torch math; at ``every = 1``
    the walk over whole Philox calls, an odd date count ending on half a
    call); with ``every`` even the last row is the TERMINAL kernel's value
    bit for bit (``csrc/gbm_step.cuh``'s pair step on the same words, also
    where a date's pair count is odd and its draws cross a call)."""
    device = _require_card()
    c = torch.from_numpy(_contracts(3, seed=9)).to(device)
    keys = rng.fold_in(rng.prng_key(9), torch.arange(3)).to(device)
    kw = dict(timesteps=steps, rows=64, cols=96, exercise_every=every, antithetic_half=half)
    before = gbm_cuda.LAUNCHES_BY_BRANCH["american_gbm"]
    got = american_cuda.simulate_american_rows_cuda(c, keys, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["american_gbm"] == before + 1
    want = american_cuda.simulate_american_rows_cuda_plain(c, keys, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)
    if every % 2 == 0:
        terminal = gbm_cuda.simulate_underlier_rows_cuda(
            c, keys, timesteps=steps, rows=64, cols=96, scheme=tgbm.PathScheme.LOG_EULER,
            payoff=tgbm.PayoffKind.TERMINAL, antithetic_half=half)
        assert torch.equal(got[:, -1], terminal)


def _backward_inputs(state: str, contracts: int, steps: int, rows: int, cols: int,
                     seed: int) -> tuple[torch.Tensor, torch.Tensor | None, dict]:
    """``(price_rows, extra_rows, strike/disc/df)`` on the card: the GBM
    monitor kernel's rows (``state="single"``) or the Heston or arithmetic
    basket kernel's two row sets, at ``every = 1``."""
    device = _require_card()
    bounds = "heston" if state == "heston" else "term"
    gen = np.random.default_rng(seed)
    lo, hi = np.array(FAMILY_LO[bounds]), np.array(FAMILY_HI[bounds])
    c = torch.from_numpy((lo + (hi - lo) * gen.random((contracts, len(lo)))).astype(np.float32))
    c = c.to(device)
    keys = rng.fold_in(rng.prng_key(seed), torch.arange(contracts)).to(device)
    kw = dict(timesteps=steps, rows=rows, cols=cols, exercise_every=1)
    extra = None
    if state == "single":
        price_rows = american_cuda.simulate_american_rows_cuda(c, keys, **kw)
    elif state == "heston":
        price_rows, extra = american_cuda.simulate_heston_american_rows_cuda(c, keys, **kw)
    else:
        price_rows, extra = american_cuda.simulate_basket_american_rows_cuda(
            c, keys, spec=_basket_spec(3, "arithmetic"), **kw)
    disc, df = american_cuda.monitor_discounts(c, timesteps=steps, exercise_every=1)
    return price_rows, extra, dict(strike=c[:, 1].contiguous(), disc=disc, df=df)


def _launches_of(fn) -> tuple[torch.Tensor, dict[str, int]]:
    before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    out = fn()
    return out, {b: n - before[b] for b, n in gbm_cuda.LAUNCHES_BY_BRANCH.items() if n != before[b]}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["resident", "streamed"])
@pytest.mark.parametrize("steps", [2, 16])
@pytest.mark.parametrize("state", ["single", "heston", "basket_arithmetic"])
@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
@pytest.mark.parametrize("degree", range(1, 9))
def test_lsmc_backward_kernel_matches_twin_on_card(degree, put, state, steps, route) -> None:
    """Exact on the same rows, on both routes and in both modes: no atomics
    in a sum and no FMA contraction, so β, every exercise decision and u are
    the twin's bit for bit (23,100 paths a contract: a ragged last tile); a
    second run is bit-equal; one launch, counted under its route and mode."""
    price_rows, extra, kw = _backward_inputs(state, 3, steps, 33, 700, seed=10 + degree)
    kw = dict(kw, put=put, basis_degree=degree, extra_rows=extra)
    resident = route == "resident"
    got, launched = _launches_of(lambda: american_cuda._lsmc_launch(price_rows, resident=resident,
                                                                    **kw))
    name = "lsmc_backward" if extra is None else "lsmc_two_state"
    assert launched == {name + ("" if route == "resident" else "_streamed"): 1}
    want = american_cuda.lsmc_backward_cuda_plain(price_rows, **kw)
    assert torch.equal(got, want)
    assert torch.equal(got, american_cuda._lsmc_launch(price_rows, resident=resident, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["single", "heston"])
def test_lsmc_backward_waves_and_split_on_card(state) -> None:
    """1,048,576 paths a contract and one contract more than a resident wave
    holds: ``lsmc_route`` picks the resident kernel, which runs two waves,
    and both routes equal the twin bit for bit, run after run; at 4,194,304
    paths a contract past the resident grid's capacity it picks the
    streamed one."""
    _require_card()
    two = state != "single"
    grid, slots = american_cuda.lsmc_plan(5, two, True, 0)
    wave = grid // -(-256 // slots)  # a contract group holds its 256 tiles
    assert american_cuda.lsmc_route(1 << 20, grid * slots) == "resident" and wave >= 1
    price_rows, extra, kw = _backward_inputs(state, wave + 1, 16, 2048, 512, seed=31)
    kw = dict(kw, put=True, basis_degree=5, extra_rows=extra)
    name = "lsmc_backward" if not two else "lsmc_two_state"
    got, launched = _launches_of(lambda: american_cuda.lsmc_backward_cuda(price_rows, **kw))
    assert launched == {name: 1}
    want = american_cuda.lsmc_backward_cuda_plain(price_rows, **kw)
    assert torch.equal(got, want)
    for _ in range(3):  # deterministic however the CTAs interleave
        assert torch.equal(american_cuda.lsmc_backward_cuda(price_rows, **kw), want)
    assert torch.equal(american_cuda._lsmc_launch(price_rows, resident=False, **kw), want)
    del price_rows, extra, got, want
    torch.cuda.empty_cache()
    assert american_cuda.lsmc_route(1 << 22, grid * slots) == "streamed"
    price_rows, extra, kw = _backward_inputs(state, 2, 4, 16384, 256, seed=32)
    kw = dict(kw, put=False, basis_degree=3, extra_rows=extra)
    got, launched = _launches_of(lambda: american_cuda.lsmc_backward_cuda(price_rows, **kw))
    assert launched == {name + "_streamed": 1}
    assert torch.equal(got, american_cuda.lsmc_backward_cuda_plain(price_rows, **kw))


# --------------------------------------------------------------------------
# The Heston, Merton and basket monitor-row kernels (csrc/american_dynamics.cu)
# --------------------------------------------------------------------------

AMERICAN_DYNAMICS = {  # case -> (family bounds, basket spec or None)
    "heston": ("heston", None),
    "merton": ("merton", None),
    "basket3_arithmetic": ("term", (3, "arithmetic")),
    "basket3_geometric": ("term", (3, "geometric")),
    "basket1_arithmetic": ("term", (1, "arithmetic")),
    "basket8_geometric": ("term", (8, "geometric")),
}


def _american_dynamics_rows(case: str, c: torch.Tensor, keys: torch.Tensor, plain: bool,
                            **kw: object) -> tuple[torch.Tensor, torch.Tensor | None]:
    _, basket = AMERICAN_DYNAMICS[case]
    if basket is not None:
        fn = (american_cuda.simulate_basket_american_rows_cuda_plain if plain
              else american_cuda.simulate_basket_american_rows_cuda)
        return fn(c, keys, spec=_basket_spec(*basket), **kw)
    if case == "heston":
        fn = (american_cuda.simulate_heston_american_rows_cuda_plain if plain
              else american_cuda.simulate_heston_american_rows_cuda)
        return fn(c, keys, **kw)
    fn = (american_cuda.simulate_merton_american_rows_cuda_plain if plain
          else american_cuda.simulate_merton_american_rows_cuda)
    return fn(c, keys, **kw), None


@pytest.mark.cuda
@pytest.mark.parametrize("steps,every,half", [(16, 1, None), (16, 4, 32), (15, 5, 32)])
@pytest.mark.parametrize("case", list(AMERICAN_DYNAMICS))
def test_american_dynamics_kernel_matches_twin_on_card(case, steps, every, half) -> None:
    """Tier 3 on the card: the price rows within rtol 2e-5 and the variance
    rows within atol 1e-6 + rtol 2e-5, but for Heston paths that miss (at
    most ``HESTON_SHARE`` of them, rounded up: one in this case's 18,432),
    which stay within ``HESTON_CAP_RTOL`` of the price and of the variance
    measured against its long-run level θ; the log dispersion within rtol
    2e-5 of the log basket value it cancels from; the last row is the
    European kernel's TERMINAL value (rtol 2e-5); one launch."""
    device = _require_card()
    bounds, basket = AMERICAN_DYNAMICS[case]
    gen = np.random.default_rng(11)
    lo, hi = np.array(FAMILY_LO[bounds]), np.array(FAMILY_HI[bounds])
    c = torch.from_numpy((lo + (hi - lo) * gen.random((3, len(lo)))).astype(np.float32)).to(device)
    keys = rng.fold_in(rng.prng_key(11), torch.arange(3)).to(device)
    kw = dict(timesteps=steps, rows=64, cols=96, exercise_every=every, antithetic_half=half)
    branch = "american_" + case.split("_")[0].rstrip("0123456789")
    before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    got, got_extra = _american_dynamics_rows(case, c, keys, False, **kw)
    launched = {b: n - before[b] for b, n in gbm_cuda.LAUNCHES_BY_BRANCH.items() if n != before[b]}
    assert launched == {branch: 1}
    want, want_extra = _american_dynamics_rows(case, c, keys, True, **kw)
    assert got.shape == (3, steps // every, 64, 96) and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    missed = (err > 2e-5 * want.abs()).any(dim=1)  # per path, over its dates
    allowed = math.ceil(HESTON_SHARE * missed.numel()) if case == "heston" else 0
    assert bool((err <= HESTON_CAP_RTOL * want.abs()).all())
    if case == "heston":
        var_err = (got_extra - want_extra).abs()
        missed |= (var_err > 1e-6 + 2e-5 * want_extra.abs()).any(dim=1)
        theta = c[:, 7, None, None, None]
        assert bool((var_err <= HESTON_CAP_RTOL * torch.maximum(want_extra, theta)).all())
    assert int(missed.sum()) <= allowed
    if want_extra is None:
        assert got_extra is None
    elif case != "heston":  # the dispersion, against the log level it cancels from
        scale = torch.log(want).abs()
        assert bool(((got_extra - want_extra).abs() <= 2e-5 * scale).all())
    terminal_kw = dict(timesteps=steps, rows=64, cols=96, payoff=tgbm.PayoffKind.TERMINAL,
                       antithetic_half=half)
    if basket is not None:
        terminal = basket_cuda.simulate_basket_rows_cuda(c, keys, spec=_basket_spec(*basket),
                                                         **terminal_kw)
    else:
        terminal = FAMILY_FNS[case][0](c, keys, **terminal_kw)
    off = ((got[:, -1] - terminal).abs() > 2e-5 * terminal.abs()).sum()
    assert int(off) <= allowed


BASKET_WALK_CASES = [(assets, combine, steps, rolled)
                     for assets in range(1, 9) for combine in ("arithmetic", "geometric")
                     for steps, rolled in ((16, (2, 4)), (15, (3, 5)))]


@pytest.mark.cuda
@pytest.mark.parametrize("assets,combine,steps,rolled", BASKET_WALK_CASES,
                         ids=[f"A{a}_{c[:5]}_T{t}" for a, c, t, _ in BASKET_WALK_CASES])
def test_american_basket_walk_equals_rolled_rows_on_card(assets, combine, steps, rolled) -> None:
    """Exact: the basket monitor kernel at ``every = 1`` (its walk over whole
    Philox calls) equals, bit for bit, its own rolled rows at the coarser
    grids ``rolled`` on the dates they share (price and, arithmetic, the log
    dispersion), and its last row the European basket kernel's TERMINAL
    value; tier 3 against its twin (price rows rtol 2e-5), antithetic, an
    odd step count included."""
    device = _require_card()
    gen = np.random.default_rng(23)
    lo, hi = np.array(FAMILY_LO["term"]), np.array(FAMILY_HI["term"])
    c = torch.from_numpy((lo + (hi - lo) * gen.random((3, len(lo)))).astype(np.float32)).to(device)
    keys = rng.fold_in(rng.prng_key(23), torch.arange(3)).to(device)
    spec = _basket_spec(assets, combine)
    kw = dict(timesteps=steps, rows=64, cols=96, antithetic_half=32, spec=spec)
    before = gbm_cuda.LAUNCHES_BY_BRANCH["american_basket"]
    price, disp = american_cuda.simulate_basket_american_rows_cuda(c, keys, exercise_every=1, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["american_basket"] == before + 1
    assert (disp is None) == (combine == "geometric")
    for every in rolled:
        p_rolled, d_rolled = american_cuda.simulate_basket_american_rows_cuda(
            c, keys, exercise_every=every, **kw)
        assert torch.equal(price[:, every - 1::every], p_rolled)
        if disp is not None:
            assert torch.equal(disp[:, every - 1::every], d_rolled)
    want, _ = american_cuda.simulate_basket_american_rows_cuda_plain(c, keys, exercise_every=1,
                                                                      **kw)
    torch.testing.assert_close(price, want, rtol=2e-5, atol=0.0)
    terminal = basket_cuda.simulate_basket_rows_cuda(
        c, keys, spec=spec, timesteps=steps, rows=64, cols=96, payoff=tgbm.PayoffKind.TERMINAL,
        antithetic_half=32)
    assert torch.equal(price[:, -1], terminal)


def _cuda_pricer(device: torch.device, payoff: str = "terminal"):
    """A small ``"cuda"`` pricer, two steps in."""
    from spectralmc_tpu_torch.models import factory as tf
    from spectralmc_tpu_torch.ops.sobol import BoundSpec
    from spectralmc_tpu_torch.training import trainer as ttr

    sim = tgbm.build_simulation_params(
        timesteps=8, network_size=64, batches_per_mc_run=64, mc_seed=7, implementation="cuda",
        payoff=payoff, normalization="none" if payoff == "american_put" else "mean",
    ).expect("sim")
    cvnn = tf.build_cvnn_config(layers=[
        tf.LinearCfg(width=32, activation=tf.Activation.MODRELU), tf.CovBNCfg(),
        tf.LinearCfg(width=32, activation=tf.Activation.ZRELU)], seed=11).expect("cvnn")
    names = ("spot", "strike", "maturity", "rate", "div_yield", "vol")
    lo, hi = (80.0, 80.0, 0.25, 0.0, 0.0, 0.15), (120.0, 120.0, 2.0, 0.08, 0.04, 0.45)
    bounds = {n: BoundSpec(lower=a, upper=b) for n, a, b in zip(names, lo, hi)}
    config = ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn, normalize_inputs=True)
    pricer = ttr.GbmCVNNPricer.create(config, device=device).expect("create")
    pricer.train(_card_training(2)).expect("train")
    return pricer


def _card_training(n: int):
    from spectralmc_tpu_torch.training import trainer as ttr

    return ttr.build_training_config(num_batches=n, batch_size=16, learning_rate=1e-3,
                                     contract_chunk=8).expect("training config")


@pytest.mark.cuda
@pytest.mark.parametrize("payoff", ["terminal", "american_put"])
def test_cuda_checkpoint_bytes_resume_bit_exactly_on_card(payoff) -> None:
    """Resuming from the serialized bytes equals resuming from the snapshot,
    bit for bit, with the stream and backward versions kept; a stream
    version one lower is refused mid-stream."""
    import dataclasses

    from spectralmc_tpu_torch.serialization import deserialize_checkpoint, serialize_checkpoint
    from spectralmc_tpu_torch.training import trainer as ttr

    device = _require_card()
    snap = _cuda_pricer(device, payoff).snapshot()
    data, digest = serialize_checkpoint(snap)
    decoded = deserialize_checkpoint(data, expected_hash=digest).expect("decode")
    assert decoded.cuda_stream_version == snap.cuda_stream_version > 0
    assert decoded.lsmc_backward_version == snap.lsmc_backward_version
    assert decoded.provenance.torch_env.device_kind == torch.cuda.get_device_name(device)
    from_bytes = ttr.GbmCVNNPricer.create(decoded, device=device).expect("from bytes")
    from_snapshot = ttr.GbmCVNNPricer.create(snap, device=device).expect("from snapshot")
    a = from_bytes.train(_card_training(2)).expect("a").losses
    b = from_snapshot.train(_card_training(2)).expect("b").losses
    np.testing.assert_array_equal(a, b)
    older, _ = serialize_checkpoint(
        dataclasses.replace(decoded, cuda_stream_version=decoded.cuda_stream_version - 1))
    refused = ttr.GbmCVNNPricer.create(deserialize_checkpoint(older).expect("older"),
                                       device=device)
    assert type(refused.error).__name__ == "EngineMismatch"


@pytest.mark.cuda
def test_cuda_checkpoint_commits_and_serves_bit_exactly_on_card(tmp_path) -> None:
    """A ``FileSystemObjectStore`` commit through ``FinalCommit``, then
    ``InferenceClient`` loads (pinned and tracking) serve the in-memory
    pricer's prices bit for bit."""
    import asyncio

    from spectralmc_tpu_torch.storage import (
        AsyncBlockchainModelStore,
        FileSystemObjectStore,
        InferenceClient,
        PinnedMode,
        TrackingMode,
        make_commit_fn,
        verify_chain_detailed,
    )
    from spectralmc_tpu_torch.training import trainer as ttr

    device = _require_card()
    pricer = _cuda_pricer(device)
    store = AsyncBlockchainModelStore(FileSystemObjectStore(tmp_path, "card"))
    commit_fn = make_commit_fn(store)
    commit_fn(pricer.snapshot(), "genesis")
    contracts = _contracts(64, seed=4)
    sizes = (1, 7, 64)  # each against the same N: the forward pads to a power of two
    genesis = {n: pricer.predict_price(contracts[:n]) for n in sizes}
    pricer.train(_card_training(2), commit_plan=ttr.FinalCommit(),
                 commit_fn=commit_fn).expect("train")
    head = {n: pricer.predict_price(contracts[:n]) for n in sizes}

    async def load(mode):
        async with InferenceClient(store, mode, poll_interval=0.05) as client:
            return client.get_model()

    assert asyncio.run(verify_chain_detailed(store)).expect("verify").versions == 2
    for mode, want in ((PinnedMode(counter=0), genesis), (TrackingMode(), head)):
        loaded = asyncio.run(load(mode))
        served = ttr.GbmCVNNPricer.create(loaded.config, device=device).expect("serve")
        for n in sizes:
            got = served.predict_price(contracts[:n])
            np.testing.assert_array_equal(got.put, want[n].put)
            np.testing.assert_array_equal(got.call, want[n].call)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["IntervalCommit", "FinalAndIntervalCommit"])
def test_cuda_interval_plans_and_effects_equal_nocommit_on_card(plan, tmp_path) -> None:
    """On the ``"cuda"`` engine: 5 steps under an interval plan (commits to a
    filesystem chain through ``make_commit_fn``) and through
    ``train_via_effects`` (plainly and from inside a running event loop)
    give ``NoCommit``'s losses bit for bit, the kernel launched once a chunk,
    and the effect path commits the same messages and bytes as ``train``."""
    import asyncio

    from spectralmc_tpu_torch.storage import (
        AsyncBlockchainModelStore,
        FileSystemObjectStore,
        make_commit_fn,
    )
    from spectralmc_tpu_torch.training import trainer as ttr

    device = _require_card()
    snap = _cuda_pricer(device).snapshot()
    fresh = lambda: ttr.GbmCVNNPricer.create(snap, device=device).expect("create")  # noqa: E731
    want = fresh().train(_card_training(5)).expect("NoCommit").losses
    commit_plan = getattr(ttr, plan)(interval=2)
    payloads = []
    for name, inside in (("train", False), ("train_via_effects", False),
                         ("train_via_effects", True)):
        store = AsyncBlockchainModelStore(FileSystemObjectStore(tmp_path, f"{name}{inside}"))
        pricer = fresh()
        call = lambda: getattr(pricer, name)(  # noqa: E731
            _card_training(5), commit_plan=commit_plan, commit_fn=make_commit_fn(store))

        async def in_loop():
            return call()

        before = gbm_cuda.LAUNCHES_BY_BRANCH["terminal"]
        result = (asyncio.run(in_loop()) if inside else call()).expect(name)
        assert gbm_cuda.LAUNCHES_BY_BRANCH["terminal"] - before == 5 * 2  # 16 contracts, chunk 8
        np.testing.assert_array_equal(result.losses, want)

        async def read():
            versions = (await store.list_versions()).expect("versions")
            return [(v.message, (await store.load_checkpoint(v)).expect("payload"))
                    for v in versions]

        payloads.append(asyncio.run(read()))
    assert len(payloads[0]) == (3 if plan == "FinalAndIntervalCommit" else 2)
    assert payloads[1] == payloads[0] and payloads[2] == payloads[0]


@pytest.mark.cuda
def test_cuda_diverged_segment_restores_its_start_on_card() -> None:
    """A NaN planted in a weight: ``NonFiniteLoss`` at the segment's end and
    the pricer's state back at the segment's start, bit for bit."""
    import dataclasses

    from spectralmc_tpu_torch.training import trainer as ttr

    device = _require_card()
    snap = _cuda_pricer(device).snapshot()
    model = {k: v.copy() for k, v in snap.model_state.items()}
    key = sorted(k for k in model if k.endswith("w_re"))[0]
    model[key].flat[0] = np.nan
    pricer = ttr.GbmCVNNPricer.create(dataclasses.replace(snap, model_state=model),
                                      device=device).expect("create")
    before = pricer.snapshot()
    result = pricer.train(_card_training(3), commit_plan=ttr.IntervalCommit(interval=2),
                          commit_fn=lambda s, m: None)
    assert type(result.error).__name__ == "NonFiniteLoss" and result.error.step == snap.global_step + 2
    after = pricer.snapshot()
    assert (after.global_step, after.sobol_skip, after.sim.skip) == (
        before.global_step, before.sobol_skip, before.sim.skip)
    for k in before.model_state:
        np.testing.assert_array_equal(after.model_state[k], before.model_state[k])
    for k in before.optimizer_state.mu:
        np.testing.assert_array_equal(after.optimizer_state.nu[k], before.optimizer_state.nu[k])


@pytest.mark.cuda
def test_cuda_profile_dir_records_kernels_on_card(tmp_path) -> None:
    """``profile_dir`` on the card: one ``train_segment`` range a segment and
    the path kernel's events in the trace (a CPU-only trace fails)."""
    import json

    from spectralmc_tpu_torch.training import trainer as ttr

    device = _require_card()
    pricer = _cuda_pricer(device)
    pricer.train(_card_training(2), commit_plan=ttr.IntervalCommit(interval=1),
                 commit_fn=lambda s, m: None, profile_dir=str(tmp_path)).expect("train")
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e.get("name") == "train_segment" and e.get("cat") != "gpu_user_annotation"
               for e in events) == 2
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert sum("gbm_paths" in e.get("name", "") for e in kernels) == 2 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("curved", [False, True], ids=["flat", "term"])
def test_pathwise_function_backward_on_card_matches_twin(curved) -> None:
    """Tier 3 on the card: ``simulate_terminal_rows_cuda_diff`` launches kernel
    #1 (#2 under a curve) once forward and nothing backward, and its
    gradient — the pathwise rule over the kernel's samples — equals the same
    rule over the twin's samples on the same Philox words at rtol 2e-5 (the
    kernel gate; #2 and its twin are bit-equal, so exactly there)."""
    device = _require_card()
    c = torch.from_numpy(_contracts(3, seed=16)).to(device)
    keys = rng.fold_in(rng.prng_key(16), torch.arange(3)).to(device)
    term = tgbm.TermStructure(vol_shape=(1.3, 0.7) * 4, rate_shape=(1.6, 0.4) * 4) if curved \
        else None
    shape = dict(timesteps=8, rows=64, cols=256, antithetic_half=32)
    branch = "term_terminal" if curved else "terminal"
    before = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
    x = c.clone().requires_grad_(True)
    out = gbm_cuda.simulate_terminal_rows_cuda_diff(x, keys, term=term, **shape)
    w = torch.rand(out.shape, device=device, generator=torch.Generator(device).manual_seed(3))
    (got,) = torch.autograd.grad(torch.sum(w * out), x)
    assert gbm_cuda.LAUNCHES_BY_BRANCH[branch] == before + 1
    if curved:
        twin = dynamics_cuda.simulate_term_rows_cuda_plain(
            c, keys, term=term, payoff=tgbm.PayoffKind.TERMINAL, **shape)
        factors = gbm_cuda.term_pathwise_factors(term, 8)
    else:
        twin = gbm_cuda.simulate_terminal_rows_cuda_plain(
            c, keys, scheme=tgbm.PathScheme.LOG_EULER, **shape)
        factors = None
    want = gbm_cuda.terminal_pathwise_vjp(w, twin, c, factors)
    if curved:
        assert torch.equal(got, want)
    else:  # the strike column is 0 on both sides: the floor is the gate on the largest column
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_walk_function_backward_on_card_matches_autograd_through_scan() -> None:
    """Tier 2 on the card: ``walk_acc``'s gradient (its backward a second
    launch of kernel #14 at (0, 0, 1)) equals autograd through the torch
    scan over the bridge kernel's normals at rtol 1e-4."""
    device = _require_card()
    steps, count = 16, 8192
    _, dirs, shift, _, bridge = _qmc_inputs(device, steps, 1)
    scalars = (torch.log(torch.tensor([100.0, 90.0], device=device)),
               torch.tensor([0.0011, -0.0004], device=device),
               torch.tensor([0.06, 0.09], device=device))
    strike = torch.tensor([[100.0], [85.0]], device=device)

    def loss(acc):
        return torch.sum(torch.mean(torch.clamp(torch.exp(acc / steps) - strike, min=0.0), dim=1))

    xs = [s.clone().requires_grad_(True) for s in scalars]
    before = gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"]
    got = torch.autograd.grad(loss(qmc_cuda.walk_acc(dirs, shift, bridge, 0, *xs,
                                                     timesteps=steps, count=count)), xs)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"] == before + 2
    eff = qmc_cuda.bridge_normals(dirs, shift, bridge, 0, timesteps=steps, factors=1,
                                  count=count)[:, :, 0]
    ys = [s.clone().requires_grad_(True) for s in scalars]
    logx = torch.zeros((2, count), device=device) + ys[0][:, None]
    acc = torch.zeros_like(logx)
    for t in range(steps):
        logx = logx + ys[1][:, None] + ys[2][:, None] * eff[:, t]
        acc = acc + logx
    want = torch.autograd.grad(loss(acc), ys)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)
