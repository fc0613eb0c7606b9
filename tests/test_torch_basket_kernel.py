"""The basket kernel's plain twin against the JAX package's basket kernel.

Tier 3, rtol 2e-5 (the TPU polynomial sine's < 4e-6 of z plus libm ulps):
the twin fed all-zero Philox words against
``_simulate_basket_rows_pallas_f32`` in interpret mode, whose stubbed PRNG
returns zero bits, so every draw is u1 = 2^-25, u2 = 0 in both (r = 5.887,
cos θ = 1, sin θ = 0): assets 2p take r, assets 2p + 1 take 0, and each
asset's mixed normal is r times the sum of its even-column Cholesky entries.
Both pairing conventions mirror rows 4..7 onto 0..3 at 8 rows, so values
are compared in place. Every branch (the digital and the geometric forward
start through the wrappers' TERMINAL routes), both combines and antithetic
on and off at 3 assets, and once more at 1 asset. The closed form of
``tests/test_gbm_pallas.py``'s basket replay holds the twin's TERMINAL value
too (rtol 1e-5).

The draw order on real Philox words, which zero words cannot see, is held
against a numpy re-statement of one step from the same uniforms.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spectralmc_tpu.ops import basket as jb
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import gbm_pallas as jpallas
from spectralmc_tpu_torch.ops import basket as tb
from spectralmc_tpu_torch.ops import basket_cuda, gbm_cuda, rng
from spectralmc_tpu_torch.ops import gbm as tgbm

ROWS, COLS = 8, 128
CONTRACT = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.25], dtype=np.float32)
ZERO_KEYS = torch.zeros((1, 2), dtype=torch.int64)
ZERO_WORDS = torch.zeros((), dtype=torch.int64)
CORR = ((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0))

CASES = [
    ("terminal", {}, 6),
    ("digital", {}, 5),
    ("forward_start", dict(forward_start_step=2), 6),
    ("barrier_up_out", dict(barrier_rel=1.1), 6),
    ("barrier_down_out", dict(barrier_rel=0.9), 6),
    ("lookback_fixed_call", {}, 5),
    ("lookback_fixed_put", {}, 5),
    ("lookback_float_call", {}, 4),
    ("lookback_float_put", {}, 4),
    ("variance_swap", {}, 6),
    ("asian_arithmetic", {}, 5),
    ("asian_geometric", {}, 6),
]


def _specs(combine: str, assets: int):
    kw = (dict(weights=(0.5, 0.3, 0.2), correlation=CORR, spot_multipliers=(1.0, 1.1, 0.9),
               vol_multipliers=(1.0, 0.8, 1.2)) if assets == 3
          else dict(weights=(1.0,), correlation=((1.0,),), spot_multipliers=(1.05,),
                    vol_multipliers=(0.9,)))
    return (jb.build_basket_spec(**kw, combine=combine).expect("j"),
            tb.build_basket_spec(**kw, combine=combine).expect("t"))


def _interpret(js, payoff: str, steps: int, half: int | None, **knobs: object) -> np.ndarray:
    with pltpu.force_tpu_interpret_mode():
        out = jpallas.simulate_basket_underlier_rows_pallas(
            jax.random.PRNGKey(1), jnp.asarray(CONTRACT), spec=js, timesteps=steps, rows=ROWS,
            cols=COLS, dtype=jnp.float32, payoff=jgbm.PayoffKind(payoff), antithetic_half=half,
            interpret=True, **knobs)
    return np.asarray(out)


def _twin(ts, payoff: str, steps: int, half: int | None, **knobs: object) -> np.ndarray:
    return basket_cuda.simulate_basket_rows_cuda_plain(
        torch.from_numpy(CONTRACT[None]), ZERO_KEYS, spec=ts, timesteps=steps, rows=ROWS,
        cols=COLS, payoff=tgbm.PayoffKind(payoff), antithetic_half=half, words=ZERO_WORDS,
        **knobs)[0].numpy()


# 3 assets under both combines, antithetic on and off; 1 asset (an odd count
# whose last draw is half used) once per branch
VARIANTS = [(combine, anti, 3) for combine in ("arithmetic", "geometric")
            for anti in (False, True)] + [("arithmetic", False, 1)]


@pytest.mark.parametrize("combine,antithetic,assets", VARIANTS,
                         ids=[f"{c}_{'anti' if a else 'plain'}_a{n}" for c, a, n in VARIANTS])
@pytest.mark.parametrize("payoff,knobs,steps", CASES, ids=[c[0] for c in CASES])
def test_basket_twin_zero_words_matches_pallas_interpret(
    payoff: str, knobs: dict, steps: int, combine: str, antithetic: bool, assets: int
) -> None:
    js, ts = _specs(combine, assets)
    half = ROWS // 2 if antithetic else None
    want = _interpret(js, payoff, steps, half, **knobs)
    got = _twin(ts, payoff, steps, half, **knobs)
    scale = np.abs(want)
    if payoff.startswith("lookback"):
        scale = np.maximum(scale, CONTRACT[1])
    if payoff == "variance_swap":
        scale = np.maximum(scale, 1e-3)
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got - want) <= 2e-5 * scale), np.max(np.abs(got - want) / scale)


def test_basket_twin_terminal_matches_the_zero_bit_closed_form() -> None:
    """``tests/test_gbm_pallas.py``'s closed form: every draw (r, 0), asset a
    mixed r·Σ_{even b <= a} chol[a][b], the arithmetic basket value after T
    steps of drift."""
    _, ts = _specs("arithmetic", 3)
    got = _twin(ts, "terminal", 6, None)
    r = math.sqrt(-2.0 * math.log(2.0**-25))
    chol = tb.basket_cholesky(ts)
    s, _, t, rate, q, vol = CONTRACT.astype(np.float64)
    dt = t / 6
    value = 0.0
    for a in range(3):
        sig = vol * ts.vol_multipliers[a]
        z = r * sum(chol[a][b] for b in range(0, a + 1, 2))
        log_s = math.log(s * ts.spot_multipliers[a]) + 6 * ((rate - q - 0.5 * sig * sig) * dt
                                                             + sig * math.sqrt(dt) * z)
        value += ts.weights[a] * math.exp(log_s)
    np.testing.assert_allclose(got, value, rtol=1e-5)


def test_basket_twin_draw_order_on_philox_words() -> None:
    """One step of 3 assets on real words: assets 0 and 1 take r·cos θ and
    r·sin θ of words 0, 1 of call 0, asset 2 r·cos θ of words 2, 3 (rtol 1e-5
    of the log-price, against a float64 re-statement)."""
    _, ts = _specs("geometric", 3)
    params = torch.from_numpy(CONTRACT[None])
    keys = rng.fold_in(rng.prng_key(2), torch.arange(1))
    got = basket_cuda.simulate_basket_rows_cuda_plain(
        params, keys, spec=ts, timesteps=1, rows=2, cols=4, payoff=tgbm.PayoffKind.TERMINAL)[0]
    path = torch.arange(8, dtype=torch.int64).reshape(2, 4)
    kw = keys.to(torch.int64)
    zero = torch.zeros_like(path)
    words = rng.philox4x32((path, zero, zero, zero), (kw[0, 0], kw[0, 1]))
    u = lambda w: ((w >> 8).double() * 2.0**-24)  # noqa: E731
    z = []
    for p in range(2):
        rad = torch.sqrt(-2.0 * torch.log(u(words[2 * p]) + 2.0**-25))
        theta = 2.0 * math.pi * u(words[2 * p + 1])
        z += [rad * torch.cos(theta), rad * torch.sin(theta)]
    chol = torch.from_numpy(tb.basket_cholesky(ts))
    s, _, t, rate, q, vol = (float(x) for x in CONTRACT)
    log_b = torch.zeros(2, 4, dtype=torch.float64)
    for a in range(3):
        sig = vol * ts.vol_multipliers[a]
        zm = sum(chol[a, b] * z[b] for b in range(a + 1))
        log_b += ts.weights[a] * (math.log(s * ts.spot_multipliers[a])
                                  + (rate - q - 0.5 * sig * sig) * t + sig * math.sqrt(t) * zm)
    np.testing.assert_allclose(torch.log(got).double().numpy(), log_b.numpy(), rtol=1e-5)


def test_basket_barrier_factor_is_the_tpu_kernels_host_double() -> None:
    _, ts = _specs("arithmetic", 3)
    assert basket_cuda.barrier_factor(ts, 1.2) == float(np.float32((0.5 + 0.33 + 0.18) * 1.2))
    _, tg = _specs("geometric", 3)
    g0 = sum(w * math.log(m) for w, m in zip(tg.weights, tg.spot_multipliers))
    assert basket_cuda.barrier_factor(tg, 0.8) == float(np.float32(math.exp(g0) * 0.8))


def test_basket_wrapper_runs_the_twin_on_cpu_and_counts_nothing() -> None:
    _, ts = _specs("arithmetic", 3)
    params = torch.from_numpy(np.stack([CONTRACT, CONTRACT * 1.1]))
    keys = rng.fold_in(rng.prng_key(2), torch.arange(2))
    before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    kw = dict(spec=ts, timesteps=4, rows=4, cols=8, payoff=tgbm.PayoffKind.ASIAN_ARITHMETIC)
    got = basket_cuda.simulate_basket_rows_cuda(params, keys, **kw)
    want = basket_cuda.simulate_basket_rows_cuda_plain(params, keys, **kw)
    assert torch.equal(got, want)
    assert gbm_cuda.LAUNCHES_BY_BRANCH == before
    too_many = tb.build_basket_spec(weights=(1 / 9,) * 9, correlation=tuple(
        tuple(float(i == j) for j in range(9)) for i in range(9))).expect("nine")
    with pytest.raises(ValueError, match="1..8 assets"):
        basket_cuda.simulate_basket_rows_cuda(params, keys, **{**kw, "spec": too_many})
