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

import numpy as np
import pytest
import torch

from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda, rng


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
