"""The ``gbm_term`` and ``gbm_cliquet`` v2 twins against a numpy restatement.

Tier 1, exact, on real Philox words: the curved-term kernel's pair step,
single step and variance pair (``csrc/dynamics_paths.cu``) and the cliquet
kernel's period pairs and tail (``csrc/gbm_paths.cu``) are restated here op
by op in numpy float32 — the words laid out as the v2 streams walk them
(draw ``j`` is words ``2(j%2), 2(j%2)+1`` of Philox call ``j // 2``), the
fixed-rounding Box–Muller of ``csrc/heston_step.cuh`` from the header's
constants, every FMA rounded once (round-to-odd in float64, then one
rounding to float32) and every other operation rounded alone — and the
twins must equal the restatement on every path. Only the epilogue's and
the cliquet's ``exp`` are torch's on both sides (on the card the kernel's
``expf`` and torch's agree, ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spectralmc_tpu_torch.ops import dynamics_cuda, gbm_cuda, rng
from spectralmc_tpu_torch.ops import gbm as tgbm

F32 = np.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread, as the twins' neighbouring tests run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once: the float32 product is exact in
    float64, the float64 sum is rounded to odd (Knuth's two-sum gives its
    error), and the cast to float32 then rounds as one rounding would."""
    a, b, c = (np.asarray(x, dtype=F32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(F32)


def _horner(x: np.ndarray, coefficients: tuple[float, ...]) -> np.ndarray:
    acc = np.full_like(x, F32(coefficients[0]))
    for c in coefficients[1:]:
        acc = _fma(acc, x, F32(c))
    return acc


def _box_muller(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, ...]:
    """``box_muller_pinned`` of words ``(a, b)``: ``(r, cos 2πu2, sin 2πu2)``."""
    u1 = ((a >> 8).astype(F32) * F32(2.0**-24) + F32(2.0**-25)).astype(F32)
    ix = u1.view(np.int32).astype(np.int64)
    k = (ix - 0x3F3504F3) >> 23
    f = ((ix - (k << 23)).astype(np.int32).view(F32) - F32(1.0)).astype(F32)
    kf = k.astype(F32)
    y = _fma((f * f).astype(F32), _horner(f, rng.LN_Q), f)
    ln = _fma(kf, F32(rng.LN2_HI), _fma(kf, F32(rng.LN2_LO), y))
    rad = np.sqrt((F32(-2.0) * ln).astype(F32)).astype(F32)
    m = (b >> 8).astype(np.int64)
    q = (m + (1 << 21)) >> 22
    r = ((m - (q << 22)).astype(F32) * F32(2.0**-22)).astype(F32)
    s = (r * r).astype(F32)
    sin_r = _fma(r, F32(rng.HALF_PI_HI), (r * _fma(s, _horner(s, rng.SIN_S),
                                                    F32(rng.HALF_PI_LO))).astype(F32))
    cos_r = _fma(s, _horner(s, rng.COS_C), F32(1.0))
    odd = (q & 1) == 1
    c, si = np.where(odd, sin_r, cos_r), np.where(odd, cos_r, sin_r)
    return rad, np.where(((q + 1) & 2) != 0, -c, c), np.where((q & 2) != 0, -si, si)


def _draws(keys: torch.Tensor, rows: int, cols: int, count: int,
           half: int | None) -> list[tuple[np.ndarray, np.ndarray]]:
    """Draw ``j``'s two words ``[C, rows, cols]``: words ``2(j%2), 2(j%2)+1``
    of Philox call ``j // 2``, the row folded onto its antithetic partner."""
    row = torch.arange(rows)[:, None]
    if half is not None:
        row = torch.where(row >= half, row - half, row)
    path = row * cols + torch.arange(cols)[None, :]
    k0, k1 = keys[:, 0, None, None], keys[:, 1, None, None]
    zero = torch.zeros_like(path)[None]
    calls = [[w.numpy() for w in rng.philox4x32(
        (path[None], zero, torch.full_like(path, q)[None], zero), (k0, k1))]
        for q in range(-(-count // 2))]
    return [(calls[j // 2][2 * (j % 2)], calls[j // 2][2 * (j % 2) + 1]) for j in range(count)]


def _sign(rows: int, half: int | None) -> np.ndarray:
    if half is None:
        return np.ones((rows, 1), dtype=F32)
    return np.where(np.arange(rows)[:, None] >= half, F32(-1.0), F32(1.0)).astype(F32)


CONTRACTS = np.array([[100.0, 101.0, 1.0, 0.03, 0.01, 0.25],
                      [90.0, 85.0, 0.5, 0.0, 0.02, 0.45]], dtype=F32)
ROWS, COLS = 6, 32


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("payoff", ["terminal", "variance_swap", "asian_geometric"])
@pytest.mark.parametrize("steps", [1, 2, 15, 16])
def test_term_twin_is_the_v2_step_restated_on_real_words(
    steps: int, payoff: str, antithetic: bool
) -> None:
    """Tier 1, exact: TERMINAL's pair step ``logx + (a.x + b.x) +
    sign·r·(a.y·cos θ + b.y·sin θ)`` and its odd single step, the variance
    pair's ``a.x + a.y·(sign·r·cos θ)`` and ``b.x + b.y·(sign·r·sin θ)``
    summed by two FMAs, and the one-draw branches' single step (the
    geometric Asian's running sum), under curves whose neighbouring steps
    differ."""
    half = ROWS // 2 if antithetic else None
    term = tgbm.TermStructure(vol_shape=tuple(1.5 - 0.9 * i / steps for i in range(steps)),
                              rate_shape=tuple(0.5 + 1.0 * i / steps for i in range(steps)),
                              div_shape=tuple(1.2 - 0.3 * i / steps for i in range(steps)))
    c = torch.from_numpy(CONTRACTS)
    keys = rng.fold_in(rng.prng_key(21), torch.arange(2))
    got = dynamics_cuda.simulate_term_rows_cuda_plain(
        c, keys, term=term, timesteps=steps, rows=ROWS, cols=COLS,
        payoff=tgbm.PayoffKind(payoff), antithetic_half=half)
    table = dynamics_cuda.term_coeff_tables(c, term.shapes(steps), steps).numpy()
    ax = lambda t: table[:, t, 0, None, None]  # noqa: E731
    ay = lambda t: table[:, t, 1, None, None]  # noqa: E731
    sign = _sign(ROWS, half)
    pairs = steps // 2
    paired = payoff != "asian_geometric"
    draws = _draws(keys, ROWS, COLS, pairs + steps % 2 if paired else steps, half)
    logx = np.broadcast_to(torch.log(c[:, 0, None, None]).numpy(), (2, ROWS, COLS)).astype(F32)
    acc = np.zeros((2, ROWS, COLS), dtype=F32)

    def draw(j: int) -> tuple[np.ndarray, ...]:
        rad, cs, sn = _box_muller(*draws[j])
        return (sign * rad).astype(F32), cs, sn

    def single(j: int, t: int, logx: np.ndarray) -> np.ndarray:
        srad, cs, _ = draw(j)
        return _fma(ay(t), (srad * cs).astype(F32), (logx + ax(t)).astype(F32))

    if payoff == "terminal":
        for j in range(pairs):
            srad, cs, sn = draw(j)
            mix = _fma(ay(2 * j), cs, (ay(2 * j + 1) * sn).astype(F32))
            logx = _fma(srad, mix, (logx + (ax(2 * j) + ax(2 * j + 1)).astype(F32)).astype(F32))
        if steps % 2:
            logx = single(pairs, steps - 1, logx)
        want = torch.exp(torch.from_numpy(logx))
    elif payoff == "variance_swap":
        for j in range(pairs):
            srad, cs, sn = draw(j)
            inc_a = _fma(ay(2 * j), (srad * cs).astype(F32), ax(2 * j))
            inc_b = _fma(ay(2 * j + 1), (srad * sn).astype(F32), ax(2 * j + 1))
            acc = _fma(inc_b, inc_b, _fma(inc_a, inc_a, acc))
        if steps % 2:
            srad, cs, _ = draw(pairs)
            inc = _fma(ay(steps - 1), (srad * cs).astype(F32), ax(steps - 1))
            acc = _fma(inc, inc, acc)
        want = torch.from_numpy((acc / CONTRACTS[:, 2, None, None]).astype(F32))
    else:
        for j in range(steps):
            logx = single(j, j, logx)
            acc = (acc + logx).astype(F32)
        want = torch.exp(torch.from_numpy((acc * F32(1.0 / steps)).astype(F32)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("periods", [2, 3, 4, 5])
def test_cliquet_twin_is_the_v2_period_restated_on_real_words(
    periods: int, antithetic: bool
) -> None:
    """Tier 1, exact: two periods a draw (``sign·r·cos θ`` and ``sign·r·sin
    θ``), the odd last period on ``r·cos θ``, each ``min(max(exp(fma(vol_k,
    z, drift_k)) − 1, floor), cap)`` added in order, with ``dt`` the IEEE
    quotient and the period's drift and vol rounded op by op."""
    half = ROWS // 2 if antithetic else None
    reset, floor, cap = 3, -0.05, 0.08
    steps = periods * reset
    c = torch.from_numpy(CONTRACTS)
    keys = rng.fold_in(rng.prng_key(22), torch.arange(2))
    got = gbm_cuda.simulate_cliquet_rows_cuda_plain(
        c, keys, timesteps=steps, rows=ROWS, cols=COLS, reset_every=reset, floor=floor,
        cap=cap, antithetic_half=half)
    maturity, rate, div, vol = (CONTRACTS[:, i, None, None] for i in (2, 3, 4, 5))
    dt = (maturity / F32(steps)).astype(F32)
    k = F32(reset)
    drift = ((((rate - div).astype(F32) - ((F32(0.5) * vol) * vol).astype(F32)).astype(F32)
              * dt).astype(F32) * k).astype(F32)
    vol_k = (vol * np.sqrt((dt * k).astype(F32))).astype(F32)

    def clipped(z: np.ndarray) -> np.ndarray:
        e = torch.exp(torch.from_numpy(_fma(vol_k, z, drift))).numpy()
        return np.minimum(np.maximum((e - F32(1.0)).astype(F32), F32(floor)), F32(cap))

    sign = _sign(ROWS, half)
    pairs = periods // 2
    acc = np.zeros((2, ROWS, COLS), dtype=F32)
    for j, (a, b) in enumerate(_draws(keys, ROWS, COLS, pairs + periods % 2, half)):
        rad, cs, sn = _box_muller(a, b)
        srad = (sign * rad).astype(F32)
        acc = (acc + clipped((srad * cs).astype(F32))).astype(F32)
        if j < pairs:
            acc = (acc + clipped((srad * sn).astype(F32))).astype(F32)
    assert torch.equal(got, torch.from_numpy(acc))
