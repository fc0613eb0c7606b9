"""The Heston, Merton and basket monitor-row kernels' twins against the JAX package's Pallas kernels.

* The forwards (``csrc/american_dynamics.cu``: the counterparts of
  ``_heston_monitor_block_kernel``, ``_merton_monitor_block_kernel`` and
  ``_basket_monitor_block_kernel``): each twin fed all-zero Philox words
  against the Pallas kernel in interpret mode, whose stubbed PRNG returns
  zero bits, so every draw is u1 = 2^-25, u2 = 0 (and a Merton count's
  uniform 0: no jumps) in both. The Pallas wrappers' backward is replaced by
  the identity, so both row sets come out. Tier 3: the price rows within
  rtol 2e-5 (the TPU polynomial sine and libm ulps); Heston's ``max(v, 0)``
  rows within atol 1e-7 + rtol 2e-5 (the variance can reach 0, where a
  relative gate means nothing); the arithmetic basket's log dispersion, a
  difference of two values near ``ln S``, within 2e-5 of ``|ln B|``.
* Identical paths: zero words make every path the same, so the twin's rows
  through the backward the ``"cuda"`` engine picks for the family (the
  torch estimator with the second state for Heston and the arithmetic
  basket, the CUDA backward's twin for Merton and the geometric basket)
  give the host Bellman DP on that path (rel 1e-4, the GBM twin's gate).
* The engine's decisions: ``resolve_lsmc_backward``, ``cuda_supported`` and
  ``cuda_stream_version`` for every family (every stream at v2); the twins'
  last row against the European twins' TERMINAL value (exact: the same
  operations in the same order; for Merton also at ``every`` 1, 2, 4, 5 and
  at T = 13 and 15, antithetic on and off) and their shard stability.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spectralmc_tpu.ops import basket as jbasket
from spectralmc_tpu.ops import gbm_pallas
from spectralmc_tpu_torch.ops import american as tam
from spectralmc_tpu_torch.ops import american_cuda, basket_cuda, dynamics_cuda, gbm_cuda, rng
from spectralmc_tpu_torch.ops import basket as tbasket
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
ZERO = torch.zeros((), dtype=torch.int64)
HESTON = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.04, 1.5, 0.05, 0.4, -0.6], dtype=np.float32)
MERTON = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.2, 0.5, -0.1, 0.15], dtype=np.float32)
BASKET = np.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.25], dtype=np.float32)
BASKET_KW = dict(weights=(0.5, 0.3, 0.2),
                 correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)))
FAMILIES = ["heston", "merton", "basket_arithmetic", "basket_geometric"]
CONTRACT = {"heston": HESTON, "merton": MERTON, "basket_arithmetic": BASKET,
            "basket_geometric": BASKET}


def _spec(family: str, mod=tbasket):
    return mod.build_basket_spec(**BASKET_KW, combine=family.split("_")[1]).expect("spec")


def _pallas_rows(monkeypatch, family: str, steps: int, every: int,
                 antithetic: bool) -> tuple[np.ndarray, np.ndarray | None]:
    """The Pallas monitor kernel's ``[n_monitor, ROWS, COLS]`` rows in
    interpret mode, and its second state (None where it has none): its
    wrapper's backward is replaced by the identity."""
    monkeypatch.setattr(gbm_pallas, "_encode_american_rows",
                        lambda rows, contract, **kw: (rows, kw.get("extra_rows")))
    fn = {"heston": gbm_pallas._simulate_heston_american_rows_pallas_f32,
          "merton": gbm_pallas._simulate_merton_american_rows_pallas_f32}.get(
        family, gbm_pallas._simulate_basket_american_rows_pallas_f32)
    kw = dict(timesteps=steps, rows=ROWS, cols=COLS, put=True, basis_degree=5,
              exercise_every=every, antithetic=antithetic, interpret=True)
    if family.startswith("basket"):
        kw["spec"] = _spec(family, jbasket)
    with pltpu.force_tpu_interpret_mode():
        rows, extra = fn.__wrapped__(jax.random.PRNGKey(1), jnp.asarray(CONTRACT[family]), **kw)
    return np.asarray(rows), None if extra is None else np.asarray(extra)


def _twin_rows(family: str, steps: int, every: int, half: int | None,
               params: np.ndarray | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    c = torch.from_numpy((CONTRACT[family] if params is None else params)[None])
    kw = dict(timesteps=steps, rows=ROWS, cols=COLS, exercise_every=every, antithetic_half=half,
              words=ZERO)
    keys = torch.zeros((1, 2), dtype=torch.int64)
    if family == "heston":
        return american_cuda.simulate_heston_american_rows_cuda_plain(c, keys, **kw)
    if family == "merton":
        return american_cuda.simulate_merton_american_rows_cuda_plain(c, keys, **kw), None
    return american_cuda.simulate_basket_american_rows_cuda_plain(c, keys, spec=_spec(family),
                                                                  **kw)


CASES = [(8, 1), (8, 2)]


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("steps,every", CASES, ids=[f"T{t}_every{e}" for t, e in CASES])
@pytest.mark.parametrize("family", FAMILIES)
def test_monitor_twin_zero_words_matches_pallas_interpret(
    monkeypatch, family: str, steps: int, every: int, antithetic: bool
) -> None:
    want, want_extra = _pallas_rows(monkeypatch, family, steps, every, antithetic)
    rows, extra = _twin_rows(family, steps, every, ROWS // 2 if antithetic else None)
    assert rows.shape == (1, steps // every, ROWS, COLS)
    np.testing.assert_allclose(rows[0].numpy(), want, rtol=2e-5)
    if family == "heston":
        np.testing.assert_allclose(extra[0].numpy(), want_extra, rtol=2e-5, atol=1e-7)
    elif family == "basket_arithmetic":
        tol = 2e-5 * np.abs(np.log(want))
        assert np.all(np.abs(extra[0].numpy() - want_extra) <= tol)
        assert np.all(want_extra >= 0.0)  # Jensen: B_arith >= B_geom
    else:  # single-state: the JAX wrapper hands its backward no second state
        assert extra is None and want_extra is None


def _bellman(path: np.ndarray, *, put: bool, strike: float, disc: float, df: float) -> float:
    """``u = K − disc·v/df`` of the exercise DP along one deterministic path."""
    def payoff(x: float) -> float:
        return max(strike - x, 0.0) if put else max(x - strike, 0.0)

    v = payoff(float(path[-1]))
    for d in range(len(path) - 2, -1, -1):
        ex = payoff(float(path[d]))
        v = ex if (ex > 0.0 and ex > disc * v) else disc * v
    return strike - disc * v / df


# contracts whose deterministic zero-word path crosses the strike, so both
# sides exercise somewhere
DP_CONTRACTS = {
    "heston": np.array([100.0, 101.0, 1.0, 0.08, 0.01, 0.04, 1.5, 0.05, 0.4, -0.6], np.float32),
    "merton": np.array([100.0, 102.0, 1.0, 0.06, 0.0, 0.2, 0.5, -0.1, 0.15], np.float32),
    "basket_arithmetic": np.array([100.0, 104.0, 1.0, 0.06, 0.0, 0.25], np.float32),
    "basket_geometric": np.array([100.0, 104.0, 1.0, 0.06, 0.0, 0.25], np.float32),
}


@pytest.mark.parametrize("option", list(tam.OptionSide), ids=lambda o: o.value)
@pytest.mark.parametrize("family", FAMILIES)
def test_identical_paths_give_the_bellman_dp(family: str, option: tam.OptionSide) -> None:
    """Zero words: every path is the same, so the engine's backward for the
    family (the two-state twin for Heston and the arithmetic basket, the
    single-state one for the others) prices the host Bellman DP on the
    twin's own path."""
    params = DP_CONTRACTS[family]
    rows, extra = _twin_rows(family, 8, 2, None, params)
    c = torch.from_numpy(params[None])
    backward = american_cuda.cuda_backward_version(dtype=torch.float32, n_monitor=4,
                                                   two_state=extra is not None)
    assert backward == (4 if family in ("heston", "basket_arithmetic") else 3)
    u = american_cuda.monitor_underliers(rows, c, timesteps=8, exercise_every=2, option=option,
                                         basis_degree=5, extra_rows=extra,
                                         backward=backward)[0].numpy()
    assert np.all(u == u[0, 0])
    disc, df = american_cuda.monitor_discounts(c, timesteps=8, exercise_every=2)
    want = _bellman(rows[0, :, 0, 0].double().numpy(), put=option == tam.OptionSide.PUT,
                    strike=float(params[1]), disc=float(disc[0]), df=float(df[0]))
    assert u[0, 0] == pytest.approx(want, rel=1e-4)


KEYS = rng.fold_in(rng.prng_key(5), torch.arange(2))
RANDOM = {
    "heston": torch.tensor([[100.0, 95.0, 1.5, 0.04, 0.01, 0.05, 1.5, 0.04, 0.5, -0.7],
                            [80.0, 90.0, 0.5, 0.0, 0.02, 0.03, 2.5, 0.08, 0.3, -0.3]]),
    "merton": torch.tensor([[100.0, 95.0, 1.5, 0.04, 0.01, 0.2, 0.8, -0.1, 0.2],
                            [80.0, 90.0, 0.5, 0.0, 0.02, 0.25, 2.0, 0.0, 0.1]]),
    "basket_arithmetic": torch.tensor([[100.0, 95.0, 1.5, 0.04, 0.01, 0.3],
                                       [80.0, 90.0, 0.5, 0.0, 0.02, 0.2]]),
}
RANDOM["basket_geometric"] = RANDOM["basket_arithmetic"]


def _random_rows(family: str, **kw: object) -> tuple[torch.Tensor, torch.Tensor | None]:
    params = RANDOM[family]
    if family == "heston":
        return american_cuda.simulate_heston_american_rows_cuda_plain(params, KEYS, **kw)
    if family == "merton":
        return american_cuda.simulate_merton_american_rows_cuda_plain(params, KEYS, **kw), None
    return american_cuda.simulate_basket_american_rows_cuda_plain(params, KEYS,
                                                                  spec=_spec(family), **kw)


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_monitor_twin_last_row_is_the_terminal_twin(family: str, every: int) -> None:
    """Tier 1, exact: none of the three has a pair-step shortcut, so the last
    monitor row is the European twin's TERMINAL value for any ``every``."""
    kw = dict(rows=6, cols=16, antithetic_half=3, row_offset=2)
    rows, _ = _random_rows(family, timesteps=9, exercise_every=every, **kw)
    tkw = dict(timesteps=9, payoff=tgbm.PayoffKind.TERMINAL, **kw)
    params = RANDOM[family]
    if family == "heston":
        terminal = dynamics_cuda.simulate_heston_rows_cuda_plain(params, KEYS, **tkw)
    elif family == "merton":
        terminal = dynamics_cuda.simulate_merton_rows_cuda_plain(params, KEYS, **tkw)
    else:
        terminal = basket_cuda.simulate_basket_rows_cuda_plain(params, KEYS, spec=_spec(family),
                                                               **tkw)
    assert torch.equal(rows[:, -1], terminal)


MERTON_LAST_ROW_CASES = [(16, 1), (16, 2), (16, 4), (15, 5), (13, 1)]


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("steps,every", MERTON_LAST_ROW_CASES,
                         ids=[f"T{t}_every{e}" for t, e in MERTON_LAST_ROW_CASES])
def test_merton_monitor_twin_last_row_is_the_terminal_twin(steps: int, every: int,
                                                           antithetic: bool) -> None:
    """Tier 1, exact: the Merton monitor twin's last row is the European
    twin's TERMINAL value bit for bit, and its rows at a coarser grid are its
    ``every = 1`` rows on the dates they share (both walk the ``merton_jump``
    v2 words, three a step, through ``dynamics_cuda.merton_step_plain``)."""
    kw = dict(rows=6, cols=16, antithetic_half=3 if antithetic else None)
    params = RANDOM["merton"]
    rows = american_cuda.simulate_merton_american_rows_cuda_plain(
        params, KEYS, timesteps=steps, exercise_every=every, **kw)
    terminal = dynamics_cuda.simulate_merton_rows_cuda_plain(
        params, KEYS, timesteps=steps, payoff=tgbm.PayoffKind.TERMINAL, **kw)
    assert rows.shape == (2, steps // every, 6, 16)
    assert torch.equal(rows[:, -1], terminal)
    if every > 1:
        fine = american_cuda.simulate_merton_american_rows_cuda_plain(
            params, KEYS, timesteps=steps, exercise_every=1, **kw)
        assert torch.equal(fine[:, every - 1::every], rows)


@pytest.mark.parametrize("family", FAMILIES)
def test_monitor_twin_rows_are_shard_stable(family: str) -> None:
    """Tier 1, exact: a row block drawn at its ``row_offset`` equals the same
    rows of the whole batch (the stream keys the GLOBAL row)."""
    kw = dict(timesteps=6, cols=32, exercise_every=2, antithetic_half=4)
    whole, whole_extra = _random_rows(family, rows=8, **kw)
    part, part_extra = _random_rows(family, rows=3, row_offset=5, **kw)
    assert torch.equal(part, whole[:, :, 5:])
    if whole_extra is not None:
        assert torch.equal(part_extra, whole_extra[:, :, 5:])


def _sim(model: str, **kw: object) -> tgbm.SimulationParams:
    basket = {"basket": tbasket.build_basket_spec(
        **BASKET_KW, combine=kw.pop("combine", "arithmetic")).expect("spec")} \
        if model == "basket_gbm" else {}
    base = dict(timesteps=8, network_size=16, batches_per_mc_run=8, mc_seed=1,
                payoff="american_put", normalization="none", implementation="cuda", model=model)
    return tgbm.build_simulation_params(**{**base, **basket, **kw}).expect("sim")


# (model, knobs, engine, backward, stream key)
RESOLVE_CASES = [
    ("heston", "heston", {}, "cuda", 4, "american_heston"),
    ("heston_call_every4", "heston", dict(payoff="american_call", lsmc_exercise_every=4),
     "cuda", 4, "american_heston"),
    ("heston_cross_fit", "heston", dict(lsmc_cross_fit=True), "cuda", 0, "american_heston"),
    ("merton", "merton_jump", {}, "cuda", 3, "american_merton_jump"),
    ("merton_antithetic", "merton_jump", dict(antithetic=True), "cuda", 3,
     "american_merton_jump"),
    ("merton_cross_fit", "merton_jump", dict(lsmc_cross_fit=True), "cuda", 0,
     "american_merton_jump"),
    ("basket_arithmetic", "basket_gbm", {}, "cuda", 4, "american_basket_gbm"),
    ("basket_arithmetic_cross_fit", "basket_gbm", dict(lsmc_cross_fit=True), "cuda", 0,
     "american_basket_gbm"),
    ("basket_geometric", "basket_gbm", dict(combine="geometric"), "cuda", 3,
     "american_basket_gbm"),
    ("basket_geometric_degree3", "basket_gbm", dict(combine="geometric", lsmc_basis_degree=3),
     "cuda", 3, "american_basket_gbm"),
    ("heston_xla", "heston", dict(implementation="xla"), "xla", 0, None),
    ("merton_xla", "merton_jump", dict(implementation="xla"), "xla", 0, None),
    ("merton_past_128_dates", "merton_jump", dict(timesteps=256), "xla", 0, None),
    ("basket_float64", "basket_gbm", dict(combine="geometric", precision="float64"), "xla", 0,
     None),
]


@pytest.mark.parametrize("model,kw,engine,backward,stream",
                         [c[1:] for c in RESOLVE_CASES], ids=[c[0] for c in RESOLVE_CASES])
def test_engine_backward_and_stream_per_family(model: str, kw: dict, engine: str,
                                               backward: int, stream: str | None) -> None:
    """The ``"cuda"`` engine runs every family's monitor kernel on flat
    float32 pseudo-random configs with 2–128 dates; the CUDA backward where
    it computes the estimator asked for (single-state, 3: Merton, the
    geometric basket; two-state, 4: Heston, the arithmetic basket), the
    torch estimator for cross-fit; the stream key is JAX's
    ``american_{model}``."""
    sim = _sim(model, **dict(kw))
    assert tgbm.resolve_implementation(sim).value == engine
    assert american_cuda.resolve_lsmc_backward(sim, rows=sim.batches_per_mc_run) == backward
    assert american_cuda.two_state(sim) == (model == "heston" or (
        model == "basket_gbm" and sim.basket.combine == tbasket.BasketCombine.ARITHMETIC))
    if stream is not None:
        assert gbm_cuda.cuda_stream_version(sim.model, sim.payoff) == \
            gbm_cuda.CUDA_STREAM_VERSIONS[stream] == 2
    assert set(gbm_cuda.CUDA_STREAM_VERSIONS) >= {
        "american_heston", "american_merton_jump", "american_basket_gbm"}


def test_cuda_supported_admits_baskets_of_one_to_eight_assets() -> None:
    kw = dict(dtype=torch.float32, model=tgbm.ModelKind.BASKET_GBM,
              payoff=tgbm.PayoffKind.AMERICAN_PUT, sampling=tgbm.SamplingKind.PSEUDO,
              timesteps=16)
    assert all(gbm_cuda.cuda_supported(n_assets=a, **kw) for a in range(1, 9))
    assert not gbm_cuda.cuda_supported(n_assets=9, **kw)
    assert not gbm_cuda.cuda_supported(n_assets=3, **{**kw, "timesteps": 1})
    curve = tgbm.TermStructure(rate_shape=(0.5, 1.5) * 8)
    assert not gbm_cuda.cuda_supported(n_assets=3, term=curve, **kw)


def test_the_cuda_backward_refuses_a_second_state() -> None:
    """The single-state CUDA backward (3), handed a second state row set,
    raises rather than drop it; the two-state one (4) raises without one."""
    rows, extra = _random_rows("heston", timesteps=4, rows=4, cols=8, exercise_every=1)
    with pytest.raises(ValueError, match="single-state"):
        american_cuda.monitor_underliers(rows, RANDOM["heston"], timesteps=4, exercise_every=1,
                                         option=tam.OptionSide.PUT, basis_degree=3,
                                         extra_rows=extra, backward=3)
    with pytest.raises(ValueError, match="two-state"):
        american_cuda.monitor_underliers(rows, RANDOM["heston"], timesteps=4, exercise_every=1,
                                         option=tam.OptionSide.PUT, basis_degree=3,
                                         backward=4)
