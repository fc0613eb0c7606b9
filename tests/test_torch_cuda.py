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

from spectralmc_tpu_torch.ops import dynamics_cuda, gbm_cuda, rng
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


@pytest.mark.cuda
def test_cliquet_kernel_matches_twin_on_card() -> None:
    """Tier 3 on the card, rtol 2e-5 measured against the cap where the sum
    of clipped returns crosses zero."""
    device = _require_card()
    c = torch.from_numpy(_contracts(3, seed=8)).to(device)
    keys = rng.fold_in(rng.prng_key(8), torch.arange(3)).to(device)
    kw = dict(timesteps=12, rows=64, cols=96, reset_every=2, floor=-0.05, cap=0.08,
              antithetic_half=32)
    before = gbm_cuda.LAUNCHES_BY_BRANCH["cliquet"]
    got = gbm_cuda.simulate_cliquet_rows_cuda(c, keys, **kw)
    assert gbm_cuda.LAUNCHES_BY_BRANCH["cliquet"] == before + 1
    want = gbm_cuda.simulate_cliquet_rows_cuda_plain(c, keys, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * kw["cap"])


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
