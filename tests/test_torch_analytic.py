"""The port's oracles against the JAX package's, on a grid of contracts.

Tier 2, float64, rtol 1e-6 (absolute floor 1e-9 of the price scale where a
price is near zero): the closed forms evaluate the same formulas in torch
instead of jnp; the lattice oracles (barrier, lookback, cliquet) run the
same numpy/scipy arithmetic, with their grids cut down so the whole file
takes seconds. Curve arguments are taken as the JAX package takes them
(``test_torch_term.py`` holds them on a grid).
"""

from __future__ import annotations

import numpy as np
import pytest

from spectralmc_tpu.ops import analytic as ja
from spectralmc_tpu_torch.ops import analytic as ta

RTOL = 1e-6

# spot, strike, maturity, rate, div_yield, vol: ATM, ITM put, OTM put, r = q
GRID = [
    (100.0, 100.0, 1.0, 0.03, 0.01, 0.25),
    (100.0, 120.0, 0.5, 0.05, 0.0, 0.35),
    (90.0, 80.0, 2.0, 0.01, 0.03, 0.15),
    (110.0, 105.0, 1.5, 0.02, 0.02, 0.45),
]


def _close(got: object, want: object, scale: float) -> None:
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=RTOL, atol=1e-9 * scale)


def _fields(p: object) -> tuple:
    return (p.put, p.call, p.put_intrinsic, p.call_intrinsic, p.put_convexity, p.call_convexity)


@pytest.mark.parametrize("c", GRID)
def test_black_scholes_digital_and_geometric_asian_match_jax(c) -> None:
    for got, want in zip(_fields(ta.black_scholes_price(*c)), _fields(ja.black_scholes_price(*c))):
        _close(got, want, c[0])
    for got, want in zip(ta.digital_price(*c), ja.digital_price(*c)):
        _close(got, want, 1.0)
    for t in (1, 7, 16):
        for got, want in zip(_fields(ta.geometric_asian_price(*c, timesteps=t)),
                             _fields(ja.geometric_asian_price(*c, timesteps=t))):
            _close(got, want, c[0])


def test_closed_forms_broadcast_over_tensors() -> None:
    cols = [np.array(col) for col in zip(*GRID)]
    got = ta.geometric_asian_price(*cols, timesteps=8)
    want = ja.geometric_asian_price(*cols, timesteps=8)
    _close(got.put, want.put, 100.0)
    _close(ta.digital_price(*cols)[1], ja.digital_price(*cols)[1], 1.0)


@pytest.mark.parametrize("c", GRID)
@pytest.mark.parametrize("steps,start", [(8, 1), (8, 5), (5, 4)])
def test_forward_start_price_matches_jax(c, steps: int, start: int) -> None:
    got = ta.forward_start_price(*c, timesteps=steps, start_step=start)
    want = ja.forward_start_price(*c, timesteps=steps, start_step=start)
    for g, w in zip(_fields(got), _fields(want)):
        _close(g, w, c[0])


@pytest.mark.parametrize("c", GRID)
@pytest.mark.parametrize("up,rel", [(True, 1.2), (False, 0.85)])
def test_discrete_barrier_price_matches_jax(c, up: bool, rel: float) -> None:
    kw = dict(timesteps=6, barrier_rel=rel, up=up, grid_points=257)
    for g, w in zip(_fields(ta.discrete_barrier_price(*c, **kw)),
                    _fields(ja.discrete_barrier_price(*c, **kw))):
        _close(g, w, c[0])


@pytest.mark.parametrize("c", GRID)
def test_lookback_price_matches_jax(c) -> None:
    kw = dict(timesteps=5, grid_points=193, levels=129)
    got, want = ta.lookback_price(*c, **kw), ja.lookback_price(*c, **kw)
    for field in ("fixed_call", "fixed_put", "float_call", "float_put", "e_max", "e_min",
                  "forward", "discount_factor"):
        _close(getattr(got, field), getattr(want, field), c[0])


@pytest.mark.parametrize("c", GRID)
@pytest.mark.parametrize("strike", [0.02, 0.0625, 0.10])
def test_variance_option_price_and_fair_strike_match_jax(c, strike: float) -> None:
    _, _, t, r, q, v = c
    for steps in (4, 16):
        got = ta.variance_option_price(strike, t, r, q, v, timesteps=steps)
        want = ja.variance_option_price(strike, t, r, q, v, timesteps=steps)
        for g, w in zip(_fields(got), _fields(want)):
            _close(g, w, 0.1)
        _close(ta.variance_fair_strike(t, r, q, v, timesteps=steps),
               ja.variance_fair_strike(t, r, q, v, timesteps=steps), 0.1)


@pytest.mark.parametrize("c", GRID)
@pytest.mark.parametrize("every,floor,cap", [(2, -0.05, 0.08), (4, 0.0, 0.05), (3, -0.2, 0.3)])
def test_cliquet_price_matches_jax(c, every: int, floor: float, cap: float) -> None:
    spot, _, t, r, q, v = c
    kw = dict(timesteps=12, reset_every=every, local_floor=floor, local_cap=cap, grid=1 << 12)
    for strike in (0.0, 0.03):
        got = ta.cliquet_price(spot, strike, t, r, q, v, **kw)
        want = ja.cliquet_price(spot, strike, t, r, q, v, **kw)
        for g, w in zip(_fields(got), _fields(want)):
            _close(g, w, 0.1)


def test_curve_arguments_are_refused() -> None:
    """No curve argument is refused any more: each oracle that took
    ``NotImplementedError`` for one now prices under it as the JAX package
    does, and an empty shape still means flat."""
    c = GRID[0]
    for got, want in zip(ta.digital_price(*c, vol_shape=(1.0, 1.2)),
                         ja.digital_price(*c, vol_shape=(1.0, 1.2))):
        _close(got, want, 1.0)
    kw = dict(timesteps=2, barrier_rel=1.2, up=True, grid_points=257)
    for g, w in zip(_fields(ta.discrete_barrier_price(*c, rate_shape=(1.0, 1.0), **kw)),
                    _fields(ta.discrete_barrier_price(*c, **kw))):
        _close(g, w, c[0])
    cq = dict(timesteps=4, reset_every=2, local_floor=0.0, local_cap=0.1, grid=1 << 12)
    for g, w in zip(_fields(ta.cliquet_price(*c, div_shape=(1.5, 1.0, 1.0, 0.5), **cq)),
                    _fields(ja.cliquet_price(*c, div_shape=(1.5, 1.0, 1.0, 0.5), **cq))):
        _close(g, w, 0.1)
    assert not hasattr(ta, "_flat_only")
