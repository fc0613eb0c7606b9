"""The curved-term, Heston and Merton kernels' plain twins against the JAX kernels.

Tier 3, rtol 2e-5: each twin fed all-zero Philox words against the JAX
Pallas kernel in interpret mode, whose stubbed PRNG returns zero bits, so
every draw is u1 = 2^-25, u2 = 0 in both (r = 5.887, cos θ = 1, sin θ = 0)
and every Merton count uniform is 0 (count 0: the diffusion leg only). The
tolerance is the TPU polynomial sine's (< 4e-6 of z) plus libm ulps. Both
pairing conventions mirror rows 4..7 onto 0..3 at 8 rows, so values are
compared in place. Every branch, antithetic on and off, odd and even step
counts for the pair-step branches, an unequal vol curve.

The Merton jump leg, which zero words cannot reach, is held on real Philox
words laid out as the ``merton_jump`` v2 stream lays them (three words a
step, four steps on three calls) against a numpy re-statement of the step
from the same uniforms (tier 2, rtol 1e-5 of the log-price) and against an
op-for-op restatement of the kernel's step (tier 1, exact), and the count
function against the JAX kernel's ``_poisson_counts`` bit for bit. The
kernel's count (``merton_count``: the first levels, the rest behind a rare
branch) equals the 16-level count on every 24-bit uniform (tier 1, exact),
and the header's constants are the twin's.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import gbm_pallas as jpallas
from spectralmc_tpu_torch.ops import dynamics_cuda, gbm_cuda, rng
from spectralmc_tpu_torch.ops import gbm as tgbm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the twins are thousands of small ops,
    which torch's thread pool slows tenfold and more while the suite's other
    workers hold the cores (past the suite's 120 s limit a test fails)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROWS, COLS = 8, 128
GBM = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.25], dtype=np.float32)
HESTON = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.04, 1.5, 0.05, 0.4, -0.6], dtype=np.float32)
MERTON = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.2, 0.8, -0.1, 0.2], dtype=np.float32)
ZERO_KEYS = torch.zeros((1, 2), dtype=torch.int64)
ZERO_WORDS = torch.zeros((), dtype=torch.int64)

# payoff, knobs, step count (odd and even for the pair-step branches)
CASES = [
    ("terminal", {}, 7),
    ("terminal", {}, 6),
    ("digital", {}, 5),
    ("forward_start", dict(forward_start_step=2), 7),
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
]
CASE_IDS = [f"{p}_T{t}" for p, _, t in CASES]


def _curves(steps: int) -> dict[str, tuple[float, ...]]:
    """Unequal neighbours in every curve, so that a pair's two steps differ."""
    return dict(
        vol_shape=tuple(1.5 - 0.9 * i / steps for i in range(steps)),
        rate_shape=tuple(0.5 + 1.0 * i / steps for i in range(steps)),
        div_shape=tuple(1.2 - 0.3 * i / steps for i in range(steps)),
    )


def _interpret(fn, contract: np.ndarray, **kw: object) -> np.ndarray:
    with pltpu.force_tpu_interpret_mode():
        out = fn(jax.random.PRNGKey(1), jnp.asarray(contract), rows=ROWS, cols=COLS,
                 dtype=jnp.float32, interpret=True, **kw)
    return np.asarray(out)


def _scale(want: np.ndarray, payoff: str, strike: float) -> np.ndarray:
    """Lookback encodings cross zero: their error is measured against the strike."""
    return np.maximum(np.abs(want), strike) if payoff.startswith("lookback") else np.abs(want)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("payoff,knobs,steps", CASES, ids=CASE_IDS)
def test_term_twin_zero_words_matches_pallas_interpret(
    payoff: str, knobs: dict, steps: int, antithetic: bool
) -> None:
    half = ROWS // 2 if antithetic else None
    curves = _curves(steps)
    want = _interpret(
        jpallas.simulate_underlier_rows_pallas, GBM, timesteps=steps,
        scheme=jgbm.PathScheme.LOG_EULER, payoff=jgbm.PayoffKind(payoff), antithetic_half=half,
        term=jgbm.TermStructure(**curves), **knobs,
    )
    got = dynamics_cuda.simulate_term_rows_cuda_plain(
        torch.from_numpy(GBM[None]), ZERO_KEYS, term=tgbm.TermStructure(**curves),
        timesteps=steps, rows=ROWS, cols=COLS, payoff=tgbm.PayoffKind(payoff),
        antithetic_half=half, words=ZERO_WORDS, **knobs,
    )[0].numpy()
    assert np.all(np.abs(got - want) <= 2e-5 * _scale(want, payoff, GBM[1]))


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("payoff,knobs,steps", CASES, ids=CASE_IDS)
def test_heston_twin_zero_words_matches_pallas_interpret(
    payoff: str, knobs: dict, steps: int, antithetic: bool
) -> None:
    half = ROWS // 2 if antithetic else None
    want = _interpret(
        jpallas.simulate_heston_underlier_rows_pallas, HESTON, timesteps=steps,
        payoff=jgbm.PayoffKind(payoff), antithetic_half=half, **knobs,
    )
    got = dynamics_cuda.simulate_heston_rows_cuda_plain(
        torch.from_numpy(HESTON[None]), ZERO_KEYS, timesteps=steps, rows=ROWS, cols=COLS,
        payoff=tgbm.PayoffKind(payoff), antithetic_half=half, words=ZERO_WORDS, **knobs,
    )[0].numpy()
    assert np.all(np.abs(got - want) <= 2e-5 * _scale(want, payoff, HESTON[1]))


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("payoff,knobs,steps", CASES, ids=CASE_IDS)
def test_merton_twin_zero_words_matches_pallas_interpret(
    payoff: str, knobs: dict, steps: int, antithetic: bool
) -> None:
    half = ROWS // 2 if antithetic else None
    want = _interpret(
        jpallas.simulate_merton_underlier_rows_pallas, MERTON, timesteps=steps,
        payoff=jgbm.PayoffKind(payoff), antithetic_half=half, **knobs,
    )
    got = dynamics_cuda.simulate_merton_rows_cuda_plain(
        torch.from_numpy(MERTON[None]), ZERO_KEYS, timesteps=steps, rows=ROWS, cols=COLS,
        payoff=tgbm.PayoffKind(payoff), antithetic_half=half, words=ZERO_WORDS, **knobs,
    )[0].numpy()
    assert np.all(np.abs(got - want) <= 2e-5 * _scale(want, payoff, MERTON[1]))


@pytest.mark.parametrize("steps", [1, 5, 8])
def test_term_coeff_tables_match_jax(steps: int) -> None:
    """Tier 2, rtol 1e-6 (sqrt ulps): the step table."""
    curves = _curves(steps)
    shapes = jgbm.TermStructure(**curves).shapes(steps)
    contracts = np.stack([GBM, GBM * np.float32(1.1)])
    got_step = dynamics_cuda.term_coeff_tables(
        torch.from_numpy(contracts), tgbm.TermStructure(**curves).shapes(steps), steps)
    assert got_step.shape == (2, steps, 2)
    for i, c in enumerate(contracts):
        want_step, _ = jpallas._term_coeff_tables(jnp.asarray(c), shapes, steps)
        np.testing.assert_allclose(got_step[i].numpy(), np.asarray(want_step), rtol=1e-6)


@pytest.mark.parametrize("payoff,knobs,steps", CASES, ids=CASE_IDS)
def test_term_twin_on_all_ones_curves_agrees_with_the_flat_twin(
    payoff: str, knobs: dict, steps: int
) -> None:
    """Tier 2, rtol 1e-5 (counted flips for the digital and barrier jumps):
    fed all-ones shapes below the ``is_flat`` normalisation, the term twin
    walks the flat twin's stream with the table's equal coefficients in
    place of the flat kernel's constants."""
    c = torch.tensor([[100.0, 101.0, 1.0, 0.03, 0.01, 0.25], [90.0, 85.0, 0.5, 0.0, 0.02, 0.4]])
    keys = rng.fold_in(rng.prng_key(3), torch.arange(2))
    ones = tgbm.TermStructure(vol_shape=(1.0,) * steps)
    kw = dict(timesteps=steps, rows=6, cols=32, payoff=tgbm.PayoffKind(payoff),
              antithetic_half=3, **knobs)
    got = dynamics_cuda.simulate_term_rows_cuda_plain(c, keys, term=ones, **kw)
    want = gbm_cuda.simulate_underlier_rows_cuda_plain(c, keys, scheme=tgbm.PathScheme.LOG_EULER,
                                                       **kw)
    scale = want.abs()
    if payoff.startswith("lookback"):
        scale = torch.maximum(scale, c[:, 1, None, None])
    far = int(((got - want).abs() > 1e-5 * scale).sum())
    assert far <= (1 if payoff == "digital" or payoff.startswith("barrier") else 0)


# --------------------------------------------------------------------------
# The Merton jump leg
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mu", [0.0, 0.01, 0.05, 0.4, 1.0, 3.0])
def test_poisson_counts_match_the_jax_kernels_bit_for_bit(mu: float) -> None:
    """Tier 1, exact: seeded 24-bit uniforms through the port's level table
    and compare loop against ``gbm_pallas._poisson_counts``, and against the
    float64 inverse cdf apart from the uniforms within an ulp of a level."""
    from scipy.stats import poisson

    gen = np.random.default_rng(int(mu * 100) + 1)
    u = (gen.integers(0, 1 << 24, size=20000).astype(np.float32) * np.float32(2.0**-24))
    u[:3] = [0.0, 1.0 - 2.0**-24, 0.5]
    want = np.asarray(jpallas._poisson_counts(jnp.asarray(u), jnp.float32(mu)))
    levels = dynamics_cuda.poisson_levels(torch.tensor(mu))
    got = dynamics_cuda.poisson_counts(torch.from_numpy(u), levels).numpy()
    np.testing.assert_array_equal(got, want)
    exact = poisson.ppf(u.astype(np.float64), mu) if mu > 0 else np.zeros_like(u)
    exact = np.where(np.isin(u.astype(np.float64), poisson.cdf(np.arange(17), mu)), got, exact)
    assert np.mean(got != exact) < 1e-3
    assert got.max() <= dynamics_cuda.POISSON_TERMS


def _merton_words(keys: torch.Tensor, rows: int, cols: int, steps: int,
                  half: int | None) -> list[tuple[torch.Tensor, ...]]:
    """Each step's three words ``[C, rows, cols]`` as the ``merton_jump`` v2
    stream lays them out: step ``t`` reads words ``3t, 3t+1, 3t+2``, word
    ``i`` being word ``i % 4`` of Philox call ``i // 4``."""
    row = torch.arange(rows)[:, None]
    if half is not None:
        row = torch.where(row >= half, row - half, row)
    path = row * cols + torch.arange(cols)[None, :]
    k0, k1 = keys[:, 0, None, None], keys[:, 1, None, None]
    zero = torch.zeros_like(path)[None]
    calls = [rng.philox4x32((path[None], zero, torch.full_like(path, q)[None], zero), (k0, k1))
             for q in range(-(-3 * steps // 4))]
    return [tuple(calls[i // 4][i % 4] for i in range(3 * t, 3 * t + 3)) for t in range(steps)]


def _merton_uniforms(keys: torch.Tensor, rows: int, cols: int, steps: int, half: int | None):
    """(u1, u2, u_c) ``[steps, C, rows, cols]`` float64 from ``_merton_words``."""
    words = _merton_words(keys, rows, cols, steps, half)
    out = [[(w[0] >> 8).double() * 2.0**-24 + 2.0**-25, (w[1] >> 8).double() * 2.0**-24,
            (w[2] >> 8).double() * 2.0**-24] for w in words]
    return [torch.stack([o[i] for o in out]).numpy() for i in range(3)]


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_merton_twin_jump_leg_matches_a_numpy_restatement(antithetic: bool) -> None:
    """Real Philox words, lam·dt = 0.4 so that most steps jump: the TERMINAL
    log-price against float64 numpy from the same uniforms (rtol 1e-5), with
    the counts taken from the float32 level table the kernel reads."""
    rows, cols, steps = 6, 64, 5
    half = rows // 2 if antithetic else None
    c = np.array([[100.0, 100.0, 1.0, 0.03, 0.01, 0.2, 2.0, -0.1, 0.2],
                  [90.0, 95.0, 0.5, 0.01, 0.0, 0.3, 4.0, 0.05, 0.1]], dtype=np.float32)
    keys = rng.fold_in(rng.prng_key(9), torch.arange(2))
    got = dynamics_cuda.simulate_merton_rows_cuda_plain(
        torch.from_numpy(c), keys, timesteps=steps, rows=rows, cols=cols,
        payoff=tgbm.PayoffKind.TERMINAL, antithetic_half=half,
    ).double().numpy()
    u1, u2, uc = _merton_uniforms(keys, rows, cols, steps, half)
    cd = c.astype(np.float64)
    spot, _, mat, r, q, vol, lam, jm, js = (cd[:, i, None, None] for i in range(9))
    dt = mat / steps
    sign = np.where(np.arange(rows) >= (half if half is not None else rows), -1.0, 1.0)[:, None]
    levels = dynamics_cuda.merton_table(torch.from_numpy(c), steps)[:, 4:].double().numpy()
    logx = np.log(spot) + np.zeros((2, rows, cols))
    jumps = 0
    for t in range(steps):
        rad = np.sqrt(-2.0 * np.log(u1[t]))
        z_d = sign * rad * np.cos(2 * np.pi * u2[t])
        z_j = sign * rad * np.sin(2 * np.pi * u2[t])
        cnt = (uc[t][..., None] >= levels[:, None, None, :]).sum(-1)
        jumps += cnt.sum()
        m = np.exp(jm + 0.5 * js * js) - 1.0
        logx = logx + (r - q - lam * m - 0.5 * vol * vol) * dt + vol * np.sqrt(dt) * z_d \
            + cnt * jm + js * np.sqrt(cnt) * z_j
    assert jumps > 0.25 * logx.size * steps  # the jump leg really ran
    np.testing.assert_allclose(np.log(got), logx, rtol=1e-5)
    if antithetic:
        # the pair shares its counts: with the Gaussians switched off, the
        # mirrored rows coincide
        quiet = c.copy()
        quiet[:, 5], quiet[:, 8] = 0.0, 0.0
        out = dynamics_cuda.simulate_merton_rows_cuda_plain(
            torch.from_numpy(quiet), keys, timesteps=steps, rows=rows, cols=cols,
            payoff=tgbm.PayoffKind.TERMINAL, antithetic_half=half)
        assert torch.equal(out[:, :half], out[:, half:])
        assert len(torch.unique(out[0])) > 2  # several distinct jump totals


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("payoff", ["terminal", "variance_swap"])
@pytest.mark.parametrize("steps", [4, 5, 6, 7, 9])
def test_merton_twin_log_price_is_the_step_restated_on_the_v2_words(
    steps: int, payoff: str, antithetic: bool
) -> None:
    """Tier 1, exact: on real Philox words (every tail of ``T % 4`` steps),
    the twin's final log-price and value equal a restatement of
    ``csrc/merton_step.cuh``'s step, op by op, on the words laid out by
    ``_merton_words``: the pinned Box–Muller pair, the 16-level count and
    its IEEE root, the jump and update FMAs rounded once. lam·dt runs up to
    1.6, so counts past the first levels (the kernel's rare branch) occur."""
    rows, cols = 6, 32
    half = rows // 2 if antithetic else None
    c = torch.tensor([[100.0, 100.0, 1.0, 0.03, 0.01, 0.2, 2.0, -0.1, 0.2],
                      [90.0, 95.0, 0.5, 0.01, 0.0, 0.3, 16.0, 0.05, 0.1]])
    keys = rng.fold_in(rng.prng_key(12), torch.arange(2))
    trace: dict[str, torch.Tensor] = {}
    got = dynamics_cuda.simulate_merton_rows_cuda_plain(
        c, keys, timesteps=steps, rows=rows, cols=cols, payoff=tgbm.PayoffKind(payoff),
        antithetic_half=half, trace=trace)
    table = dynamics_cuda.merton_table(c, steps)[:, None, None, :]
    drift, vol_sdt, jm, js = (table[..., i] for i in range(4))
    sign = torch.ones(rows, 1) if half is None else torch.where(
        torch.arange(rows)[:, None] >= half, -1.0, 1.0)
    logx = torch.log(c[:, 0, None, None]).expand(2, rows, cols)
    acc = torch.zeros(2, rows, cols)
    counts = []
    for a, b, w in _merton_words(keys, rows, cols, steps, half):
        rad, cs, sn = dynamics_cuda.box_muller_pinned(gbm_cuda.uniform_open(a),
                                                      gbm_cuda.uniform_closed(b))
        n = dynamics_cuda.poisson_counts(gbm_cuda.uniform_closed(w), table[..., 4:])
        counts.append(n)
        jump = rng.fma32_exact(js * torch.sqrt(n), sign * (rad * sn), n * jm)
        if payoff == "variance_swap":
            inc = rng.fma32_exact(vol_sdt, sign * (rad * cs), drift) + jump
            logx = logx + inc
            acc = rng.fma32_exact(inc, inc, acc)
        else:
            logx = rng.fma32_exact(vol_sdt, sign * (rad * cs), logx + drift) + jump
    assert torch.equal(trace["log_price"], logx)
    want = acc / c[:, 2, None, None] if payoff == "variance_swap" else torch.exp(logx)
    assert torch.equal(got, want)
    assert float(torch.stack(counts).max()) >= dynamics_cuda.MERTON_COUNT_FIRST


@pytest.mark.parametrize("mu", [0.0, 0.03125, 0.075, 1.0, 9.9])
def test_merton_count_equals_the_sixteen_level_count_on_every_uniform(mu: float) -> None:
    """Tier 1, exact, over all 2^24 uniforms the stream draws: the kernel's
    count (the first levels, the rest only at or past level
    ``MERTON_COUNT_FIRST − 1``) is ``poisson_counts``' 16-level count, the
    top uniform 1 − 2^-24 included (where saturated levels all count), and
    its root the IEEE root of the count."""
    u = torch.arange(1 << 24, dtype=torch.float32) * 2.0**-24
    levels = dynamics_cuda.poisson_levels(torch.tensor(mu))
    n, root = dynamics_cuda.merton_count(u, levels)
    assert torch.equal(n, dynamics_cuda.poisson_counts(u, levels))
    assert torch.equal(root, torch.sqrt(n))
    if mu >= 1.0:
        assert float(n[-1]) >= dynamics_cuda.MERTON_COUNT_FIRST


def test_poisson_levels_never_decrease() -> None:
    """Tier 1, exact: on a grid of 20,001 rates from 0 to 10 each level is
    at least the one before (the count's shortcut rests on it); the first is
    positive (a uniform of 0 counts nothing)."""
    levels = dynamics_cuda.poisson_levels(torch.linspace(0.0, 10.0, 20001))
    assert bool((levels[:, 1:] >= levels[:, :-1]).all())
    assert bool((levels[:, 0] > 0.0).all())


def test_merton_step_header_constants_are_the_twins() -> None:
    """Tier 1, exact: ``csrc/merton_step.cuh``'s root constants are the
    float32 IEEE roots the twin takes, and its level and count sizes are the
    module's."""
    header = (Path(dynamics_cuda.__file__).resolve().parent.parent / "csrc"
              / "merton_step.cuh").read_text()
    body = header.split("kRoots[kPoissonTerms + 1] = {")[1].split("}")[0]
    roots = torch.tensor([float(x.rstrip("f")) for x in re.findall(r"[0-9.]+f", body)])
    assert torch.equal(roots, torch.sqrt(torch.arange(17, dtype=torch.float32)))
    assert int(re.search(r"kPoissonTerms = (\d+);", header).group(1)) == \
        dynamics_cuda.POISSON_TERMS
    assert int(re.search(r"kCountFirst = (\d+);", header).group(1)) == \
        dynamics_cuda.MERTON_COUNT_FIRST


def test_twins_route_digital_and_forward_start_and_refuse_what_has_no_kernel() -> None:
    """Tier 1, exact: digital is ``K + sign(S_T − K)`` of the same twin's
    TERMINAL values; Merton's forward start is its TERMINAL at the tail
    length with the maturity scaled; the term twin's runs on the curves
    sliced to the tail. Cliquets and a barrier without a level raise."""
    keys = rng.fold_in(rng.prng_key(2), torch.arange(1))
    kw = dict(timesteps=6, rows=4, cols=16)
    h, m, g = (torch.from_numpy(x[None]) for x in (HESTON, MERTON, GBM))
    term = tgbm.TermStructure(**_curves(6))
    for twin, c, extra in ((dynamics_cuda.simulate_heston_rows_cuda_plain, h, {}),
                           (dynamics_cuda.simulate_merton_rows_cuda_plain, m, {}),
                           (dynamics_cuda.simulate_term_rows_cuda_plain, g, dict(term=term))):
        terminal = twin(c, keys, payoff=tgbm.PayoffKind.TERMINAL, **kw, **extra)
        digital = twin(c, keys, payoff=tgbm.PayoffKind.DIGITAL, **kw, **extra)
        assert torch.equal(digital, c[:, 1, None, None] + torch.sign(terminal - c[:, 1, None, None]))
        with pytest.raises(ValueError, match="cliquet"):
            twin(c, keys, payoff=tgbm.PayoffKind.CLIQUET, **kw, **extra)
        with pytest.raises(ValueError, match="barrier_rel"):
            twin(c, keys, payoff=tgbm.PayoffKind.BARRIER_UP_OUT, **kw, **extra)
    tail = m.clone()
    tail[:, 2] = tail[:, 2] * torch.tensor(4 / 6, dtype=torch.float32)
    forward = dynamics_cuda.simulate_merton_rows_cuda_plain(
        m, keys, payoff=tgbm.PayoffKind.FORWARD_START, forward_start_step=2, **kw)
    assert torch.equal(forward, dynamics_cuda.simulate_merton_rows_cuda_plain(
        tail, keys, payoff=tgbm.PayoffKind.TERMINAL, timesteps=4, rows=4, cols=16))
    tail_g = g.clone()
    tail_g[:, 2] = tail_g[:, 2] * torch.tensor(4 / 6, dtype=torch.float32)
    sliced = tgbm.TermStructure(**{k: v[2:] for k, v in _curves(6).items()})
    forward = dynamics_cuda.simulate_term_rows_cuda_plain(
        g, keys, term=term, payoff=tgbm.PayoffKind.FORWARD_START, forward_start_step=2, **kw)
    assert torch.equal(forward, dynamics_cuda.simulate_term_rows_cuda_plain(
        tail_g, keys, term=sliced, payoff=tgbm.PayoffKind.TERMINAL, timesteps=4, rows=4, cols=16))
    with pytest.raises(ValueError, match="forward_start_step"):
        dynamics_cuda.simulate_heston_rows_cuda_plain(
            h, keys, payoff=tgbm.PayoffKind.FORWARD_START, forward_start_step=6, **kw)
    with pytest.raises(ValueError, match=r"\[C, 10\]"):
        dynamics_cuda.simulate_heston_rows_cuda(m, keys, payoff=tgbm.PayoffKind.TERMINAL, **kw)
    trace: dict[str, torch.Tensor] = {}
    traced = dynamics_cuda.simulate_heston_rows_cuda_plain(
        h, keys, payoff=tgbm.PayoffKind.TERMINAL, trace=trace, **kw)
    assert torch.equal(traced, dynamics_cuda.simulate_heston_rows_cuda_plain(
        h, keys, payoff=tgbm.PayoffKind.TERMINAL, **kw))
    least = trace["min_variance"]  # each path's least raw variance, the start included
    assert least.shape == traced.shape and bool((least <= h[0, 5]).all())
    assert bool((least < h[0, 5]).any())
    before = gbm_cuda.LAUNCHES
    dynamics_cuda.simulate_heston_rows_cuda(h, keys, payoff=tgbm.PayoffKind.TERMINAL, **kw)
    assert gbm_cuda.LAUNCHES == before  # a CPU tensor runs the twin, never a kernel
