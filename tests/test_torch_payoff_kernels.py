"""The CUDA kernels' plain twins against the JAX kernels, every payoff branch.

Tier 3, rtol 2e-5: each twin fed all-zero Philox words against the JAX
Pallas kernel in interpret mode, whose stubbed PRNG returns zero bits, so
every draw is u1 = 2^-25, u2 = 0 in both (z = ±5.887, and the cliquet's
second period z = 0). The tolerance is the TPU polynomial sine's (< 4e-6 of
z) plus libm ulps; the cliquet's sums of clipped returns take it against
the cap where they cross zero. Reflection-Euler with antithetic mirroring
runs at a vol of 0.10 (``test_torch_gbm.py``'s ``LOW_VOL`` note). Both
pairing conventions mirror rows 4..7 onto 0..3 at 8 rows, so values are
compared in place. Every flat-kernel branch, both schemes, antithetic on and
off, odd step counts for the pair-step branches; the cliquet under log-Euler
with an even and an odd period count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda

CONTRACT = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.25], dtype=np.float32)
LOW_VOL = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.10], dtype=np.float32)
ROWS, COLS = 8, 128

# payoff, knobs, step count (odd for the pair-step variance branch)
FLAT_CASES = [
    ("barrier_up_out", dict(barrier_rel=1.25), 6),
    ("barrier_down_out", dict(barrier_rel=0.8), 6),
    ("lookback_fixed_call", {}, 5),
    ("lookback_fixed_put", {}, 5),
    ("lookback_float_call", {}, 4),
    ("lookback_float_put", {}, 4),
    ("variance_swap", {}, 7),
    ("variance_swap", {}, 6),
    ("asian_arithmetic", {}, 5),
    ("asian_geometric", {}, 6),
    ("digital", {}, 5),
    ("forward_start", dict(forward_start_step=2), 7),
]


def _pallas(contract: np.ndarray, **kw: object) -> np.ndarray:
    with pltpu.force_tpu_interpret_mode():
        out = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), jnp.asarray(contract), rows=ROWS, cols=COLS,
            dtype=jnp.float32, interpret=True, **kw,
        )
    return np.asarray(out)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("scheme", ["log_euler", "euler"])
@pytest.mark.parametrize("payoff,knobs,steps", FLAT_CASES,
                         ids=[f"{p}_T{t}" for p, _, t in FLAT_CASES])
def test_flat_twin_zero_words_matches_pallas_interpret(
    payoff: str, knobs: dict, steps: int, scheme: str, antithetic: bool
) -> None:
    contract = LOW_VOL if scheme == "euler" and antithetic else CONTRACT
    half = ROWS // 2 if antithetic else None
    want = _pallas(contract, timesteps=steps, scheme=jgbm.PathScheme(scheme),
                   payoff=jgbm.PayoffKind(payoff), antithetic_half=half, **knobs)
    got = gbm_cuda.simulate_underlier_rows_cuda_plain(
        torch.from_numpy(contract[None]), torch.zeros((1, 2), dtype=torch.int64),
        timesteps=steps, rows=ROWS, cols=COLS, scheme=tgbm.PathScheme(scheme),
        payoff=tgbm.PayoffKind(payoff), antithetic_half=half,
        words=torch.zeros((), dtype=torch.int64), **knobs,
    )[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("steps,every,floor,cap", [(12, 3, -0.02, 0.05), (9, 3, 0.0, 0.08)],
                         ids=["even_periods", "odd_periods"])
def test_cliquet_twin_zero_words_matches_pallas_interpret(
    steps: int, every: int, floor: float, cap: float, antithetic: bool
) -> None:
    half = ROWS // 2 if antithetic else None
    knobs = dict(cliquet_reset_every=every, cliquet_floor=floor, cliquet_cap=cap)
    contract = CONTRACT.copy()
    contract[5] = 0.3
    want = _pallas(contract, timesteps=steps, scheme=jgbm.PathScheme.LOG_EULER,
                   payoff=jgbm.PayoffKind.CLIQUET, antithetic_half=half, **knobs)
    got = gbm_cuda.simulate_cliquet_rows_cuda_plain(
        torch.from_numpy(contract[None]), torch.zeros((1, 2), dtype=torch.int64),
        timesteps=steps, rows=ROWS, cols=COLS, reset_every=every, floor=floor, cap=cap,
        antithetic_half=half, words=torch.zeros((), dtype=torch.int64),
    )[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * cap)


def test_twins_draw_the_stream_of_their_branch() -> None:
    """Tier 1, exact: digital is ``K + sign(S_T − K)`` of the TERMINAL twin's
    own values, forward start is the TERMINAL twin at the tail length with
    the maturity scaled by ``(N − m)/N``, and the barrier and lookback
    branches walk the same one-draw-per-step path."""
    from spectralmc_tpu_torch.ops import rng

    c = torch.tensor([[100.0, 101.0, 1.0, 0.03, 0.01, 0.25], [90.0, 85.0, 0.5, 0.0, 0.02, 0.4]])
    keys = rng.fold_in(rng.prng_key(3), torch.arange(2))
    kw = dict(rows=6, cols=8, scheme=tgbm.PathScheme.LOG_EULER, antithetic_half=3)
    terminal = gbm_cuda.simulate_terminal_rows_cuda_plain(c, keys, timesteps=7, **kw)
    digital = gbm_cuda.simulate_underlier_rows_cuda_plain(
        c, keys, timesteps=7, payoff=tgbm.PayoffKind.DIGITAL, **kw)
    strike = c[:, 1, None, None]
    assert torch.equal(digital, strike + torch.sign(terminal - strike))
    tail = c.clone()
    tail[:, 2] = tail[:, 2] * torch.tensor(4 / 7, dtype=torch.float32)
    forward = gbm_cuda.simulate_underlier_rows_cuda_plain(
        c, keys, timesteps=7, payoff=tgbm.PayoffKind.FORWARD_START, forward_start_step=3, **kw)
    assert torch.equal(forward, gbm_cuda.simulate_terminal_rows_cuda_plain(
        tail, keys, timesteps=4, **kw))
    far = gbm_cuda.simulate_underlier_rows_cuda_plain(
        c, keys, timesteps=7, payoff=tgbm.PayoffKind.BARRIER_UP_OUT, barrier_rel=1e6, **kw)
    float_put = gbm_cuda.simulate_underlier_rows_cuda_plain(
        c, keys, timesteps=7, payoff=tgbm.PayoffKind.LOOKBACK_FLOAT_PUT, **kw)
    fixed_call = gbm_cuda.simulate_underlier_rows_cuda_plain(
        c, keys, timesteps=7, payoff=tgbm.PayoffKind.LOOKBACK_FIXED_CALL, **kw)
    # the per-step branches walk one path: S_T = (K − (M − S_T)) + K − (2K − M)
    torch.testing.assert_close(far, float_put + strike - fixed_call, rtol=1e-5, atol=0.0)
    assert torch.all(float_put <= strike)  # M >= S_T
    euler_kw = {**kw, "scheme": tgbm.PathScheme.EULER}
    geo = gbm_cuda.simulate_underlier_rows_cuda_plain(
        c, keys, timesteps=7, payoff=tgbm.PayoffKind.ASIAN_GEOMETRIC, **euler_kw)
    arith = gbm_cuda.simulate_underlier_rows_cuda_plain(
        c, keys, timesteps=7, payoff=tgbm.PayoffKind.ASIAN_ARITHMETIC, **euler_kw)
    assert torch.all(geo <= arith * (1 + 1e-6))  # AM-GM on the same path


def test_cliquet_route_and_refusals() -> None:
    """The flat twin refuses cliquets (their kernel is another program) and
    a barrier without its level; the cliquet twin refuses a bad grid."""
    c = torch.tensor([[100.0, 0.02, 1.0, 0.03, 0.01, 0.25]])
    keys = torch.zeros((1, 2), dtype=torch.int64)
    kw = dict(timesteps=4, rows=2, cols=2, scheme=tgbm.PathScheme.LOG_EULER)
    with pytest.raises(ValueError, match="cliquet"):
        gbm_cuda.simulate_underlier_rows_cuda_plain(c, keys, payoff=tgbm.PayoffKind.CLIQUET, **kw)
    with pytest.raises(ValueError, match="barrier_rel"):
        gbm_cuda.simulate_underlier_rows_cuda(c, keys, payoff=tgbm.PayoffKind.BARRIER_UP_OUT,
                                              **kw)
    with pytest.raises(ValueError, match="periods"):
        gbm_cuda.simulate_cliquet_rows_cuda(c, keys, timesteps=4, rows=2, cols=2, reset_every=3,
                                            floor=0.0, cap=0.1)
    with pytest.raises(ValueError, match="floor"):
        gbm_cuda.simulate_cliquet_rows_cuda_plain(c, keys, timesteps=4, rows=2, cols=2,
                                                  reset_every=2, floor=0.1, cap=0.0)
