"""Sharded training in the port against its single-device run and the JAX package's sharded run.

The port's ranks are ``gloo`` worker processes (``tests/helpers/torch_mesh.py``):
one world per mesh shape — (1, 2), (2, 1) and (2, 2) — runs all of its cases
and hands back losses, counters, a hash of each replica and rank 0's
weights as JSON. The JAX side runs here, on the conftest's 8 virtual CPU
devices, at ``tests/test_parallel.py``'s sizes (timesteps 2, network 16, 8
rows, width 24, batch 8) and tolerances:

* tier 2, float32: losses within rtol 2e-4 (3e-4 for the families; 5e-3 for
  the American policy, whose exercise indicator may flip at reduction-order
  noise), weights within rtol 2e-3 and atol 1e-5; float64: rtol 1e-9;
* tier 1: counters, the recorded LSMC backward, and the replicas' bytes on
  every rank (a hash of weights, buffers and Adam moments).

The curve finding: under ``rate_shape=(1.5, 1.5)`` the port's sharded step
discounts at the curve's effective rate, as both single-device steps do,
while the JAX package's sharded step (its flat ``exp(-rate·T)``) misses by
more than 1%.

Each kernel's twin runs at row offsets too: the rows of a 2- or 4-way
shard equal the same rows of the full launch bit for bit (tier 1), through
the engine's own simulators and wrappers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import basket as jbasket
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.parallel.mesh import build_mesh_spec as jax_mesh_spec
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.ops import american_cuda
from spectralmc_tpu_torch.ops.basket import build_basket_spec
from spectralmc_tpu_torch.ops.dispatch import make_underlier_simulator
from spectralmc_tpu_torch.ops.gbm import ModelKind, build_simulation_params
from spectralmc_tpu_torch.parallel.mesh import build_mesh_spec
from spectralmc_tpu_torch.training.trainer import GbmCVNNPricer
from tests.helpers import torch_mesh as tm

MESHES = {"mesh_1x2": (1, 2), "mesh_2x1": (2, 1), "mesh_2x2": (2, 2)}
# tests/test_parallel.py's gates: the families at 3e-4, the American policy
# at the flip scale
FAMILY_RTOL = {"american": 5e-3, "american_xfit": 5e-3}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The three worlds, started together; ``ranks[suite]`` waits for its
    ranks' JSON."""
    started = {s: tm.start_ranks(s, tmp_path_factory.mktemp(s)) for s in MESHES}
    yield started
    for run in started.values():
        run.stop()


def _jax_pricer(name: str, shape: tuple[int, int] | None) -> jtr.GbmCVNNPricer:
    c = tm.case(name)
    sim = jgbm.build_simulation_params(**tm.sim_kwargs(name, jbasket.build_basket_spec)).expect(
        "jax sim")
    cfg = jtr.GbmCVNNPricerConfig(
        sim=sim,
        bounds={k: jsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in c["bounds"].items()},
        cvnn=tm.cvnn_layers(jf, c["network"], sim.precision),
    )
    spec = None if shape is None else jax_mesh_spec(
        batch_shards=shape[0], paths_shards=shape[1]).expect("jax mesh")
    return jtr.GbmCVNNPricer.create(cfg, mesh_spec=spec).expect("jax pricer")


def _jax_run(name: str, shape: tuple[int, int] | None) -> tuple[np.ndarray, dict]:
    pricer = _jax_pricer(name, shape)
    c = tm.case(name)
    cfg = jtr.build_training_config(num_batches=c["batches"], batch_size=c["batch"],
                                    learning_rate=2e-3).expect("jax training config")
    losses = np.asarray(pricer.train(cfg).expect("jax train").losses)
    return losses, {k: np.asarray(v) for k, v in pricer.snapshot().model_state.items()}


def _port_single(name: str) -> tuple[np.ndarray, object]:
    pricer = GbmCVNNPricer.create(tm.port_config(name), device="cpu").expect("port pricer")
    result = tm.port_train(pricer, name)
    return np.asarray(result.losses), pricer.snapshot()


def _assert_replicas(runs: list[dict], name: str) -> None:
    """Every rank's replica has the same bytes, losses and counters."""
    assert len({r[name]["state"] for r in runs}) == 1, name
    for r in runs[1:]:
        assert r[name]["losses"] == runs[0][name]["losses"], name


def _assert_weights(got: dict, want: dict, name: str) -> None:
    assert set(got) == set(want), name
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), value, rtol=2e-3, atol=1e-5,
                                   err_msg=f"{name} {key}")


def test_mesh_spec_validation() -> None:
    """JAX's refusals, and the port's own: no world, no mesh."""
    assert "needs 256 devices, have 1" in build_mesh_spec(
        batch_shards=16, paths_shards=16).error.reason
    assert "must be > 0" in build_mesh_spec(batch_shards=0, paths_shards=1).error.reason
    assert "not initialized" in build_mesh_spec(batch_shards=1, paths_shards=1).error.reason


@pytest.mark.parametrize("suite", list(MESHES))
def test_sharded_float32_matches_single_device_and_jax(ranks, suite: str) -> None:
    runs = ranks[suite].wait()
    got = runs[0]["f32"]
    single, snap = _port_single("f32")
    np.testing.assert_allclose(got["losses"], single, rtol=2e-4)
    _assert_weights(got["model_state"], snap.model_state, "f32")
    assert (got["sobol_skip"], got["mc_skip"], got["global_step"]) == (
        snap.sobol_skip, snap.sim.skip, snap.global_step)
    jax_losses, jax_weights = _jax_run("f32", MESHES[suite])
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=2e-4)
    _assert_weights(got["model_state"], jax_weights, "f32 vs jax")
    _assert_replicas(runs, "f32")


@pytest.mark.parametrize("suite", list(MESHES))
def test_sharded_float64_matches_tightly(ranks, suite: str) -> None:
    runs = ranks[suite].wait()
    got = runs[0]["f64"]
    single, _ = _port_single("f64")
    np.testing.assert_allclose(got["losses"], single, rtol=1e-9)
    jax_losses, _ = _jax_run("f64", MESHES[suite])
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-9)
    _assert_replicas(runs, "f64")


@pytest.mark.parametrize("name", tm.FAMILIES)
def test_sharded_families_match(ranks, name: str) -> None:
    """The JAX package's sharded families on the (2, 2) mesh: each against
    the port's single-device run and JAX's sharded run."""
    runs = ranks["mesh_2x2"].wait()
    got = runs[0][name]
    rtol = FAMILY_RTOL.get(name, 3e-4)
    single, snap = _port_single(name)
    np.testing.assert_allclose(got["losses"], single, rtol=rtol, err_msg=name)
    assert (got["sobol_skip"], got["mc_skip"]) == (snap.sobol_skip, snap.sim.skip)
    jax_losses, _ = _jax_run(name, MESHES["mesh_2x2"])
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=rtol, err_msg=f"{name} vs jax")
    _assert_replicas(runs, name)


def test_american_float64_matches_jax_sharded(ranks) -> None:
    """The American put in float64 on the threefry engine: the psum'd
    regression solves the same system in both packages, so the losses agree
    to rtol 1e-9 (no exercise decision flips at float64 noise here)."""
    got = ranks["mesh_2x2"].wait()[0]["american_f64"]
    jax_losses, _ = _jax_run("american_f64", MESHES["mesh_2x2"])
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-9)
    assert got["lsmc_backward_version"] == 0


def test_sharded_american_records_the_torch_estimator(ranks) -> None:
    """On a (1, 2) mesh the American put regresses over both shards' paths
    (backward version 0) and stays within the flip-scale gate of one device."""
    runs = ranks["mesh_1x2"].wait()
    got = runs[0]["american"]
    assert got["lsmc_backward_version"] == 0
    single, _ = _port_single("american")
    np.testing.assert_allclose(got["losses"], single, rtol=5e-3)
    _assert_replicas(runs, "american")


def test_batchnorm_matches_jax_sharded(ranks) -> None:
    """Per-shard batch statistics with running statistics averaged over the
    batch axis, as the JAX package's sharded step keeps them: the losses and
    the running statistics against JAX's. (The output bias's imaginary part
    at DFT bins 0 and N/2, where a real payoff's spectrum is 0, follows a
    gradient of rounding noise that Adam turns into steps of either sign, so
    the parameters are held to each other only through the losses.)"""
    runs = ranks["mesh_2x2"].wait()
    got = runs[0]["bn"]
    jax_losses, jax_weights = _jax_run("bn", MESHES["mesh_2x2"])
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=2e-4)
    running = {k: v for k, v in jax_weights.items() if k.startswith("state/")}
    assert any("c_rr" in key for key in running)
    _assert_weights({k: got["model_state"][k] for k in running}, running, "bn vs jax")
    _assert_replicas(runs, "bn")


def test_curved_rate_discounts_as_single_device(ranks) -> None:
    """The port's sharded step equals both single-device steps under a
    curved rate; the JAX package's sharded step (flat discount) does not."""
    got = np.asarray(ranks["mesh_2x2"].wait()[0]["curve"]["losses"])
    single, _ = _port_single("curve")
    jax_single, _ = _jax_run("curve", None)
    jax_sharded, _ = _jax_run("curve", MESHES["mesh_2x2"])
    np.testing.assert_allclose(got, single, rtol=2e-4)
    np.testing.assert_allclose(got, jax_single, rtol=2e-4)
    assert np.max(np.abs(jax_sharded / jax_single - 1.0)) > 0.01


# --------------------------------------------------------------------------
# The kernels' twins at row offsets
# --------------------------------------------------------------------------

ROWS, COLS, STEPS, CONTRACTS = 8, 16, 4, 3
TERM = {"vol_shape": (1.2, 0.8, 1.0, 1.1), "rate_shape": (1.3, 0.7, 1.0, 1.0),
        "div_shape": (0.5, 1.5, 1.0, 1.0)}
# (label, simulation knobs, model contract bounds): one sim a kernel branch
ENGINE_CASES = [
    ("gbm_terminal", {}),
    ("gbm_terminal_antithetic", {"antithetic": True}),
    ("gbm_asian", {"payoff": "asian_arithmetic"}),
    ("gbm_barrier_antithetic", {"payoff": "barrier_up_out", "barrier_rel": 1.2,
                                "normalization": "none", "antithetic": True}),
    ("gbm_lookback", {"payoff": "lookback_fixed_put", "normalization": "none"}),
    ("gbm_term", {"term": TERM}),
    ("gbm_cliquet", {"payoff": "cliquet", "cliquet_reset_every": 2, "cliquet_floor": -0.05,
                     "cliquet_cap": 0.08, "normalization": "none"}),
    ("heston", {"model": "heston", "antithetic": True}),
    ("merton", {"model": "merton_jump"}),
    ("basket", {"model": "basket_gbm"}),
    ("qmc_bridge", {"sampling": "sobol_bb", "model": "heston"}),
    ("qmc_walk", {"sampling": "sobol_bb", "payoff": "asian_geometric"}),
]
MONITOR_CASES = [ModelKind.GBM, ModelKind.HESTON, ModelKind.MERTON_JUMP, ModelKind.BASKET_GBM]
PARAMS = {
    ModelKind.GBM: [100.0, 95.0, 1.0, 0.03, 0.01, 0.25],
    ModelKind.BASKET_GBM: [100.0, 95.0, 1.0, 0.03, 0.01, 0.25],
    ModelKind.HESTON: [100.0, 95.0, 1.0, 0.03, 0.01, 0.05, 1.5, 0.05, 0.4, -0.6],
    ModelKind.MERTON_JUMP: [100.0, 95.0, 1.0, 0.03, 0.01, 0.2, 0.5, -0.1, 0.15],
}
BASKET_SPEC = build_basket_spec(weights=(0.5, 0.3, 0.2), correlation=(
    (1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0))).expect("basket")


def _contracts(model: ModelKind) -> tuple[torch.Tensor, torch.Tensor]:
    base = torch.tensor(PARAMS[model], dtype=torch.float32)
    params = base.repeat(CONTRACTS, 1) * (1.0 + 0.05 * torch.arange(CONTRACTS)[:, None])
    keys = torch.tensor([[7, 11], [13, 17], [19, 23]], dtype=torch.int64)
    return params, keys


def _shards_equal_full(run, rows_dim: int) -> None:
    full = run(0, ROWS)
    for ways in (2, 4):
        local = ROWS // ways
        parts = [run(j * local, local) for j in range(ways)]
        assert torch.equal(torch.cat(parts, dim=rows_dim), full), ways


@pytest.mark.parametrize("label,knobs", ENGINE_CASES, ids=[c[0] for c in ENGINE_CASES])
def test_engine_rows_at_offsets_equal_the_full_launch(label: str, knobs: dict) -> None:
    """The ``"cuda"`` engine's simulator (each kernel's twin on the CPU,
    through the wrapper the main path calls) at a row offset gives the full
    launch's rows bit for bit, antithetic pairs by the global half too."""
    sim = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=7,
        implementation="cuda", **knobs,
        **({"basket": BASKET_SPEC} if knobs.get("model") == "basket_gbm" else {})).expect(label)
    params, keys = _contracts(ModelKind(sim.model))

    def run(offset: int, rows: int) -> torch.Tensor:
        return make_underlier_simulator(sim, rows=rows)(keys, params, row_offset=offset)

    _shards_equal_full(run, rows_dim=1)


@pytest.mark.parametrize("model", MONITOR_CASES, ids=[m.value for m in MONITOR_CASES])
def test_monitor_rows_at_offsets_equal_the_full_launch(model: ModelKind) -> None:
    """The American monitor kernels' twins (#4, #6, #8, #10): price rows,
    and Heston's variance and the basket's dispersion rows, at row offsets."""
    params, keys = _contracts(model)

    def run(offset: int, rows: int) -> torch.Tensor:
        price, extra = american_cuda.american_rows_cuda(
            params, keys, model=model, spec=BASKET_SPEC if model == ModelKind.BASKET_GBM else None,
            timesteps=STEPS, rows=rows, cols=COLS, exercise_every=1,
            antithetic_half=ROWS // 2, row_offset=offset)
        return price if extra is None else torch.stack([price, extra])

    _shards_equal_full(run, rows_dim=-2)
