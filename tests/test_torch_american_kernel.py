"""The American kernels' plain twins against the JAX package's Pallas kernels.

* The monitor-row forward (``csrc/american_paths.cu``'s ``american_gbm``,
  the counterpart of ``_gbm_monitor_block_kernel``): its twin fed all-zero
  Philox words against the Pallas kernel in interpret mode, whose stubbed
  PRNG returns zero bits, so every draw is u1 = 2^-25, u2 = 0 in both. Tier
  3, rtol 2e-5 on the price rows (the TPU polynomial sine's error and libm
  ulps). Zero bits make every path identical, so the Bermudan value through
  the torch estimator is the host Bellman DP's (to 1e-4, the JAX package's
  own gate for this collapse); a β is never compared there, because the
  rank-revealing drop is a coin flip on an exactly singular Gram.
* The LSMC backward (the counterpart of ``_fused_backward_kernel`` and
  ``_streamed_backward_kernel``): its twin against both Pallas kernels in
  interpret mode on the same random rows, with the JAX package's gate
  between its backwards (mean cashflow within 2e-3 relative, at most 2% of
  paths flipped: the reduction orders differ, so β differs in its last ulps);
  on identical paths, the Bellman DP.
* ``resolve_lsmc_backward`` against the support predicate, and the twins'
  determinism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spectralmc_tpu.ops import gbm_pallas
from spectralmc_tpu.ops.lsmc_pallas import lsmc_fused_backward, lsmc_streamed_backward
from spectralmc_tpu_torch.ops import american as tam
from spectralmc_tpu_torch.ops import american_cuda, gbm_cuda, rng
from spectralmc_tpu_torch.ops import gbm as tgbm

CONTRACT = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.2], dtype=np.float32)
ROWS, COLS = 8, 128
ZERO = torch.zeros((), dtype=torch.int64)


def _pallas_rows(monkeypatch, steps: int, every: int, antithetic: bool) -> np.ndarray:
    """The Pallas monitor kernel's ``[n_monitor, ROWS, COLS]`` rows in
    interpret mode: its wrapper's backward is replaced by the identity."""
    monkeypatch.setattr(gbm_pallas, "_encode_american_rows", lambda rows, contract, **kw: rows)
    with pltpu.force_tpu_interpret_mode():
        rows = gbm_pallas._simulate_american_rows_pallas_f32.__wrapped__(
            jax.random.PRNGKey(1), jnp.asarray(CONTRACT), timesteps=steps, rows=ROWS,
            cols=COLS, put=True, basis_degree=5, exercise_every=every,
            antithetic=antithetic, interpret=True,
        )
    return np.asarray(rows)


def _twin_rows(steps: int, every: int, half: int | None) -> torch.Tensor:
    return american_cuda.simulate_american_rows_cuda_plain(
        torch.from_numpy(CONTRACT[None]), torch.zeros((1, 2), dtype=torch.int64),
        timesteps=steps, rows=ROWS, cols=COLS, exercise_every=every, antithetic_half=half,
        words=ZERO,
    )


def _bellman(path: np.ndarray, *, put: bool, strike: float, disc: float, df: float) -> float:
    """``u = K − disc·v/df`` of the exercise DP along one deterministic path."""
    def payoff(x: float) -> float:
        return max(strike - x, 0.0) if put else max(x - strike, 0.0)

    v = payoff(float(path[-1]))
    for d in range(len(path) - 2, -1, -1):
        ex = payoff(float(path[d]))
        v = ex if (ex > 0.0 and ex > disc * v) else disc * v
    return strike - disc * v / df


MONITOR_CASES = [(8, 1), (8, 2), (8, 4), (6, 3)]


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("steps,every", MONITOR_CASES,
                         ids=[f"T{t}_every{e}" for t, e in MONITOR_CASES])
def test_monitor_twin_zero_words_matches_pallas_interpret(
    monkeypatch, steps: int, every: int, antithetic: bool
) -> None:
    want = _pallas_rows(monkeypatch, steps, every, antithetic)
    rows = _twin_rows(steps, every, ROWS // 2 if antithetic else None)
    assert rows.shape == (1, steps // every, ROWS, COLS)
    np.testing.assert_allclose(rows[0].numpy(), want, rtol=2e-5)
    if antithetic:
        return
    # identical paths: the torch estimator's Bermudan value is the DP's
    c = torch.from_numpy(CONTRACT[None])
    disc, df = american_cuda.monitor_discounts(c, timesteps=steps, exercise_every=every)
    for option in tam.OptionSide:
        u = tam.encode_monitor_prices(
            rows, strike=c[:, 1], maturity=c[:, 2], rate=c[:, 3], disc_monitor=disc,
            dtype=torch.float32, put=option == tam.OptionSide.PUT, basis_degree=5,
        )[0].numpy()
        assert np.all(u == u[0, 0])
        expected = _bellman(rows[0, :, 0, 0].double().numpy(), put=option == tam.OptionSide.PUT,
                            strike=float(CONTRACT[1]), disc=float(disc[0]), df=float(df[0]))
        assert u[0, 0] == pytest.approx(expected, rel=1e-4)


@pytest.mark.parametrize("steps", [8, 6])
def test_monitor_twin_even_segments_end_on_the_terminal_value(steps: int) -> None:
    """Tier 1, exact: with ``every`` even a segment is pair steps only, so
    the draws are the TERMINAL branch's and the last monitor row is its
    value."""
    c = torch.tensor([[100.0, 95.0, 1.5, 0.04, 0.01, 0.3], [80.0, 90.0, 0.5, 0.0, 0.02, 0.45]])
    keys = rng.fold_in(rng.prng_key(5), torch.arange(2))
    kw = dict(rows=6, cols=16, antithetic_half=3, row_offset=2)
    rows = american_cuda.simulate_american_rows_cuda_plain(c, keys, timesteps=steps,
                                                           exercise_every=2, **kw)
    terminal = gbm_cuda.simulate_terminal_rows_cuda_plain(
        c, keys, timesteps=steps, scheme=tgbm.PathScheme.LOG_EULER, **kw)
    assert torch.equal(rows[:, -1], terminal)


def test_monitor_twin_rows_are_shard_stable() -> None:
    """Tier 1, exact: a row block drawn at its ``row_offset`` equals the same
    rows of the whole batch (the stream keys the GLOBAL row)."""
    c = torch.from_numpy(CONTRACT[None])
    keys = rng.fold_in(rng.prng_key(2), torch.arange(1))
    kw = dict(timesteps=6, cols=32, exercise_every=3, antithetic_half=4)
    whole = american_cuda.simulate_american_rows_cuda_plain(c, keys, rows=8, **kw)
    part = american_cuda.simulate_american_rows_cuda_plain(c, keys, rows=3, row_offset=5, **kw)
    assert torch.equal(part, whole[:, :, 5:])


def _synthetic_rows(n_monitor: int, rows: int, cols: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    z = gen.standard_normal((n_monitor, rows, cols)).astype(np.float32)
    steps = np.float32(0.2 * np.sqrt(1.0 / n_monitor)) * z + np.float32(0.01 / n_monitor)
    return (100.0 * np.exp(np.cumsum(steps, axis=0))).astype(np.float32)


STRIKE = np.float32(100.0)
DISC = np.float32(np.exp(-0.03 / 8))
DF = np.float32(np.exp(-0.03))


def _twin_u(rows: np.ndarray, put: bool, degree: int = 5) -> np.ndarray:
    return american_cuda.lsmc_backward_cuda_plain(
        torch.from_numpy(rows)[None], strike=torch.tensor([STRIKE]), disc=torch.tensor([DISC]),
        df=torch.tensor([DF]), put=put, basis_degree=degree,
    )[0].numpy()


def _statistically_equal(got: np.ndarray, want: np.ndarray) -> None:
    cf_got = (STRIKE - got) * DF
    cf_want = (STRIKE - want) * DF
    assert abs(cf_got.mean() - cf_want.mean()) <= max(2e-3 * abs(cf_want.mean()), 2e-3)
    assert np.mean(got != want) <= 0.02


@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
def test_backward_twin_matches_fused_kernel_interpret(put: bool) -> None:
    rows = _synthetic_rows(8, 16, 128, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = lsmc_fused_backward(jnp.asarray(rows), strike=STRIKE, disc_monitor=DISC,
                                   df_total=DF, put=put, basis_degree=5, interpret=True)
    _statistically_equal(_twin_u(rows, put), np.asarray(want))


@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
def test_backward_twin_matches_streamed_kernel_interpret(put: bool) -> None:
    """Plain ``interpret=True``: the streamed kernel's DMA schedule is far
    too slow under ``force_tpu_interpret_mode``."""
    rows = _synthetic_rows(8, 16, 128, seed=2)
    want = lsmc_streamed_backward(jnp.asarray(rows), strike=STRIKE, disc_monitor=DISC,
                                  df_total=DF, put=put, basis_degree=5, interpret=True)
    _statistically_equal(_twin_u(rows, put), np.asarray(want))


@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
def test_backward_twin_matches_torch_estimator(put: bool) -> None:
    """The same estimator at another reduction order, on a ragged path count
    (the last block part-filled) and a 3-contract batch."""
    rows = np.stack([_synthetic_rows(5, 9, 700, seed=s) for s in (3, 4, 5)])
    strike = torch.tensor([100.0, 95.0, 105.0])
    disc = torch.full((3,), float(DISC))
    df = torch.full((3,), float(DF))
    got = american_cuda.lsmc_backward_cuda_plain(torch.from_numpy(rows), strike=strike,
                                                 disc=disc, df=df, put=put, basis_degree=4)
    cf = tam.lsmc_backward(torch.from_numpy(rows), strike=strike, disc=disc,
                           dtype=torch.float32, put=put, basis_degree=4)
    want = strike[:, None, None] - cf / df[:, None, None]
    for c in range(3):
        cf_got = ((strike[c] - got[c]) * df[c]).numpy()
        assert abs(cf_got.mean() - cf[c].numpy().mean()) <= 2e-3 * abs(cf[c].numpy().mean())
        assert float(torch.mean((got[c] != want[c]).float())) <= 0.02


@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
def test_backward_twin_on_identical_paths_is_the_bellman_dp(put: bool) -> None:
    n_monitor = 8
    path = (100.0 * np.exp(np.linspace(0.08, -0.12, n_monitor))).astype(np.float32)
    rows = np.ascontiguousarray(np.broadcast_to(path[:, None, None], (n_monitor, 8, 128)))
    u = _twin_u(rows, put)
    assert np.all(u == u[0, 0])
    expected = _bellman(path.astype(np.float64), put=put, strike=float(STRIKE),
                        disc=float(DISC), df=float(DF))
    assert u[0, 0] == pytest.approx(expected, rel=1e-4)


def test_backward_twin_is_deterministic() -> None:
    rows = _synthetic_rows(6, 20, 300, seed=6)
    a = _twin_u(rows, True, degree=3)
    b = _twin_u(rows.copy(), True, degree=3)
    assert np.array_equal(a, b)


def _sim(**kw: object) -> tgbm.SimulationParams:
    base = dict(timesteps=8, network_size=16, batches_per_mc_run=8, mc_seed=1,
                payoff="american_put", normalization="none", implementation="cuda",
                lsmc_fused_backward=True)
    return tgbm.build_simulation_params(**{**base, **kw}).expect("sim")


RESOLVE_CASES = [
    ("fused", {}, 3),
    ("call_degree_8", dict(payoff="american_call", lsmc_basis_degree=8), 3),
    ("every_4", dict(lsmc_exercise_every=4), 3),
    ("antithetic", dict(antithetic=True), 3),
    ("flag_off", dict(lsmc_fused_backward=False), 3),
    ("xla_engine", dict(implementation="xla"), 0),
    ("cross_fit", dict(lsmc_fused_backward=False, lsmc_cross_fit=True), 0),
    ("past_128_dates", dict(timesteps=256), 0),
    ("european", dict(payoff="terminal", lsmc_fused_backward=False), 0),
]


@pytest.mark.parametrize("kw,want", [(kw, w) for _, kw, w in RESOLVE_CASES],
                         ids=[name for name, _, _ in RESOLVE_CASES])
def test_resolve_lsmc_backward_follows_the_support_predicate(kw: dict, want: int) -> None:
    """The ``"cuda"`` engine runs the CUDA backward wherever it computes the
    estimator asked for, whatever ``lsmc_fused_backward`` says."""
    sim = _sim(**kw)
    got = american_cuda.resolve_lsmc_backward(sim, rows=sim.batches_per_mc_run)
    engine_runs = (sim.payoff in tgbm.AMERICAN_PAYOFFS
                   and tgbm.resolve_implementation(sim) == tgbm.SimImplementation.CUDA)
    supported = american_cuda.cuda_backward_version(
        dtype=torch.float32, n_monitor=sim.timesteps // sim.lsmc_exercise_every,
        cross_fit=sim.lsmc_cross_fit)
    assert got == want
    assert got == (supported if engine_runs else 0)
    assert american_cuda.LSMC_BACKWARD_VERSIONS["cuda"] not in (1, 2)  # the JAX kernels'


def test_kernel_buffers_skip_the_deterministic_fill_only_for_themselves() -> None:
    """The wrappers' output buffers, which their kernels write in every
    element, are allocated without deterministic mode's NaN fill; the
    runtime's setting is restored for every other tensor."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        buf = american_cuda._written_in_full(3, 5, device=torch.device("cpu"))
        assert buf.shape == (3, 5) and buf.dtype == torch.float32
        assert torch.utils.deterministic.fill_uninitialized_memory
        assert bool(torch.isnan(torch.empty(4)).all())  # every other tensor still filled
    finally:
        torch.use_deterministic_algorithms(before)
