"""The two-state LSMC backward (version 4): its plain twin against the JAX package.

The CUDA backward's second mode regresses on ``[x^a, v, v·x, v²]`` with
``v = 20·extra`` (Heston's ``max(v, 0)``, the arithmetic basket's log
dispersion): the estimator of the JAX package's ``ops/american.py::
_lsmc_backward`` with ``extra_rows``, which runs there on XLA (its Pallas
backward refuses a second state). The kernel itself runs on the card only
(``tests/test_torch_cuda.py`` holds it to this twin bit for bit); here:

* the twin's moments are exactly JAX's Gram products, once each;
* the twin against JAX's ``_lsmc_backward`` and against the port's torch
  estimator on the same rows: the reduction orders differ, so β differs in
  its last ulps and near-boundary paths flip — mean cashflow within 2e-3
  relative, at most 2% of paths flipped (the JAX package's gate between its
  backwards); on identical paths, the host Bellman DP; deterministic;
* the routing: Heston and the arithmetic basket record backward 4 on the
  ``"cuda"`` engine, and a version-0 snapshot of such a config cannot
  continue mid-stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.ops import american as jam
from spectralmc_tpu_torch.core.errors.trainer import EngineMismatch
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import american as tam
from spectralmc_tpu_torch.ops import american_cuda, rng
from spectralmc_tpu_torch.ops import basket as tbasket
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import step as tstep
from spectralmc_tpu_torch.training import trainer as ttr
from test_torch_american_dynamics import BASKET_KW, HESTON_BOUNDS, HESTON_SIM
from test_torch_slice import _cvnn, _train


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the twins are thousands of small ops,
    which torch's thread pool slows tenfold and more while the suite's other
    workers hold the cores (past the suite's 120 s limit a test fails)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HESTON = torch.tensor([[100.0, 104.0, 1.0, 0.04, 0.01, 0.05, 1.5, 0.05, 0.3, -0.6],
                       [97.0, 96.0, 0.7, 0.02, 0.015, 0.07, 2.0, 0.04, 0.4, -0.4],
                       [90.0, 95.0, 1.5, 0.06, 0.0, 0.04, 1.0, 0.06, 0.5, -0.7]])
BASKET = torch.tensor([[100.0, 104.0, 1.0, 0.04, 0.01, 0.25],
                       [97.0, 96.0, 0.7, 0.02, 0.015, 0.3],
                       [90.0, 95.0, 1.5, 0.06, 0.0, 0.2]])
KEYS = rng.fold_in(rng.prng_key(9), torch.arange(3))


def _rows(state: str, rows: int, cols: int, steps: int = 8) -> tuple[torch.Tensor, ...]:
    """``(price_rows, extra_rows, strike, disc, df)``: the monitor kernel's
    twin rows of three contracts at ``every = 1``."""
    kw = dict(timesteps=steps, rows=rows, cols=cols, exercise_every=1)
    if state == "heston":
        params = HESTON
        price, extra = american_cuda.simulate_heston_american_rows_cuda_plain(params, KEYS, **kw)
    else:
        params = BASKET
        spec = tbasket.build_basket_spec(**BASKET_KW, combine="arithmetic").expect("spec")
        price, extra = american_cuda.simulate_basket_american_rows_cuda_plain(
            params, KEYS, spec=spec, **kw)
    disc, df = american_cuda.monitor_discounts(params, timesteps=steps, exercise_every=1)
    return price, extra, params[:, 1].contiguous(), disc, df


def _gate(u: torch.Tensor, cf_want: torch.Tensor, strike: torch.Tensor, df: torch.Tensor) -> None:
    """Mean cashflow within 2e-3 relative and at most 2% of paths flipped,
    per contract, against a cashflow discounted to t = 0."""
    for c in range(u.shape[0]):
        cf_got = (strike[c] - u[c]).double() * float(df[c])
        want = cf_want[c].double()
        assert abs(float(cf_got.mean() - want.mean())) <= 2e-3 * abs(float(want.mean()))
        u_want = strike[c] - cf_want[c] / df[c]
        assert float((u[c] != u_want).float().mean()) <= 0.02


@pytest.mark.parametrize("degree", range(1, 9))
def test_moments_are_the_gram_products_once_each(degree: int) -> None:
    """The kernel's moment layout is JAX's ``prod_exp`` (27 at degree 5)."""
    cols = american_cuda.basis_columns(degree, True)
    assert cols[:degree + 1] == [(j, 0) for j in range(degree + 1)]
    want = {(a1 + a2, b1 + b2) for i, (a1, b1) in enumerate(cols) for (a2, b2) in cols[i:]}
    layout = american_cuda.moment_layout(degree, True)
    assert len(layout) == len(set(layout)) and set(layout) == want
    assert american_cuda.moment_layout(degree, False) == [(a, 0) for a in range(2 * degree + 1)]
    if degree == 5:
        assert len(layout) == 27 and len(cols) == 9


@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
@pytest.mark.parametrize("state", ["heston", "basket_arithmetic"])
def test_two_state_twin_matches_jax_lsmc_backward(state: str, put: bool) -> None:
    """16,384 paths a contract, as the port's two-state estimator is held to
    JAX's (below ~4,096 the 9-column basis is loose enough that one flip at
    the last date cascades through the earlier ones); JAX's backward jitted
    and mapped over the three contracts."""
    price, extra, strike, disc, df = _rows(state, 32, 512)
    u = american_cuda.lsmc_backward_cuda_plain(price, strike=strike, disc=disc, df=df, put=put,
                                               basis_degree=5, extra_rows=extra)
    jax_backward = jax.jit(jax.vmap(lambda p, e, k, d: jam._lsmc_backward(
        p, strike=k, disc=d, dtype=jnp.float32, put=put, basis_degree=5, extra_rows=e)))
    cf_jax = torch.from_numpy(np.array(jax_backward(*(jnp.asarray(t.numpy()) for t in (
        price, extra, strike, disc)))))
    _gate(u, cf_jax, strike, df)


@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
@pytest.mark.parametrize("state", ["heston", "basket_arithmetic"])
def test_two_state_twin_matches_torch_estimator(state: str, put: bool) -> None:
    """A ragged path count (9 × 700: the last tile part-filled), degree 4."""
    price, extra, strike, disc, df = _rows(state, 9, 700, steps=6)
    u = american_cuda.lsmc_backward_cuda_plain(price, strike=strike, disc=disc, df=df, put=put,
                                               basis_degree=4, extra_rows=extra)
    cf = tam.lsmc_backward(price, strike=strike, disc=disc, dtype=torch.float32, put=put,
                           basis_degree=4, extra_rows=extra)
    _gate(u, cf, strike, df)


@pytest.mark.parametrize("put", [True, False], ids=["put", "call"])
def test_two_state_twin_on_identical_paths_is_the_bellman_dp(put: bool) -> None:
    """Every path the same price and variance path: the Gram is singular,
    the pivots drop, and the policy is the DP's."""
    n = 8
    path = (100.0 * np.exp(np.linspace(0.08, -0.12, n))).astype(np.float32)
    var = np.linspace(0.04, 0.06, n).astype(np.float32)
    price = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(path[:, None, None],
                                                                  (n, 8, 128))))[None]
    extra = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(var[:, None, None],
                                                                  (n, 8, 128))))[None]
    strike, disc, df = torch.tensor([100.0]), torch.tensor([0.996]), torch.tensor([0.97])
    u = american_cuda.lsmc_backward_cuda_plain(price, strike=strike, disc=disc, df=df, put=put,
                                               basis_degree=5, extra_rows=extra)[0].numpy()
    assert np.all(u == u[0, 0])
    v = max(100.0 - path[-1], 0.0) if put else max(path[-1] - 100.0, 0.0)
    for d in range(n - 2, -1, -1):
        ex = max(100.0 - path[d], 0.0) if put else max(path[d] - 100.0, 0.0)
        v = ex if (ex > 0.0 and ex > 0.996 * v) else 0.996 * v
    assert u[0, 0] == pytest.approx(100.0 - 0.996 * v / 0.97, rel=1e-4)


def test_two_state_twin_is_deterministic() -> None:
    price, extra, strike, disc, df = _rows("heston", 5, 300, steps=5)
    kw = dict(strike=strike, disc=disc, df=df, put=True, basis_degree=3)
    a = american_cuda.lsmc_backward_cuda_plain(price, extra_rows=extra, **kw)
    b = american_cuda.lsmc_backward_cuda_plain(price.clone(), extra_rows=extra.clone(), **kw)
    assert torch.equal(a, b)
    single = american_cuda.lsmc_backward_cuda_plain(price, **kw)
    assert not torch.equal(a, single)  # the second state moves the policy


def test_route_splits_on_the_resident_capacity() -> None:
    """Resident while one contract's 4096-path tiles fit the grid's slots."""
    assert american_cuda.lsmc_route(1 << 20, 256) == "resident"
    assert american_cuda.lsmc_route((1 << 20) + 1, 256) == "streamed"
    assert american_cuda.lsmc_route(1, 1) == "resident"
    assert american_cuda.lsmc_route(1 << 22, 792) == "streamed"


def _heston_pricer(**overrides: object) -> ttr.GbmCVNNPricer:
    sim = tgbm.build_simulation_params(**{**HESTON_SIM, "implementation": "cuda",
                                          "batches_per_mc_run": 64, **overrides}).expect("sim")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in HESTON_BOUNDS.items()}
    cfg = ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=_cvnn(tf), normalize_inputs=True)
    return ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("pricer")


@pytest.mark.parametrize("cross_fit", [False, True], ids=["classic", "cross_fit"])
def test_a_version_zero_heston_snapshot_cannot_continue(cross_fit: bool) -> None:
    """A Heston American put on the ``"cuda"`` engine records backward 4
    (cross-fit: 0, the torch estimator); its snapshot relabelled with the
    other version is refused mid-stream with ``EngineMismatch``."""
    pricer = _heston_pricer(lsmc_cross_fit=cross_fit)
    _train(pricer, ttr, tstep, 1)
    snap = pricer.snapshot()
    assert snap.lsmc_backward_version == (0 if cross_fit else 4)
    stale = ttr.GbmCVNNPricerConfig(**{**snap.__dict__,
                                       "lsmc_backward_version": 4 if cross_fit else 0})
    res = ttr.GbmCVNNPricer.create(stale, device="cpu")
    assert res.is_failure() and isinstance(res.error, EngineMismatch)
    assert ttr.GbmCVNNPricer.create(snap, device="cpu").is_success()
