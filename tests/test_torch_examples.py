"""The port's examples (``examples/torch/``) against the JAX package's own
calls at the same sizes and seeds, on the CPU.

Each example's ``run(device="cpu", ...)`` runs at a small size (a few
batches, narrow widths) on the threefry engine (``implementation="xla"``),
and the test makes the JAX example's calls at those sizes. Tiers:

* tier 1, exact: chain content hashes, parents, versions and messages (03);
  checkpoint bytes, which the JAX package decodes and re-encodes to the same
  bytes (04, 05), and the bytes a client loads against the bytes committed
  (05); the float64 oracles and the bootstrapped curve (07, 12, 13); the
  port's key for seed 7 against ``jax.random.PRNGKey(7)`` (10, 11).
* tier 2, float tolerance: threefry-engine prices and spectra, trained
  losses and predictions rtol 1e-4 (``tests/test_torch_slice.py``'s
  cross-package tolerance); pathwise Greeks rtol 1e-4 with atol 1e-6,
  gamma rtol 1e-3 (``tests/test_torch_greeks.py``'s float32 gates).
* statistical, where the LSMC regression's exercise decisions may flip on
  float32 noise (11, 13's American put): prices within 2 SE of JAX's on the
  same paths (``tests/test_torch_american.py`` holds 2e-3 at 32k paths).
* the sharded examples (06, 08) as gloo ranks at world 2: the ranks' losses
  against JAX's single-device run at tier 2, the replicas bit-equal.

An example run without a card and without ``--device cpu`` exits non-zero
and names the device.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spectralmc_tpu.models import factory as jf
from spectralmc_tpu.ops import american as jam
from spectralmc_tpu.ops import analytic as jan
from spectralmc_tpu.ops import basket as jbasket
from spectralmc_tpu.ops import gbm as jgbm
from spectralmc_tpu.ops import greeks as jgreeks
from spectralmc_tpu.ops import heston as jheston
from spectralmc_tpu.ops import merton as jmerton
from spectralmc_tpu.ops import sobol as jsobol
from spectralmc_tpu.serialization import deserialize_checkpoint as jax_deserialize
from spectralmc_tpu.serialization import serialize_checkpoint as jax_serialize
from spectralmc_tpu.training import step as jstep
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.core.provenance import Provenance
from spectralmc_tpu_torch.ops import rng
from spectralmc_tpu_torch.serialization import deserialize_checkpoint, serialize_checkpoint

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
REL = 1e-4  # tier 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these small runs gain nothing from more, and the
    suite runs under xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def example(name: str):
    """The example module ``examples/torch/<name>*.py``."""
    (path,) = EXAMPLES.glob(f"{name}_*.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{path.stem}", path)
    module = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_bounds(bounds: dict) -> dict:
    return {k: jsobol.BoundSpec(lower=b.lower, upper=b.upper) for k, b in bounds.items()}


def jax_pricer(sim: dict, bounds: dict, layers: list[tuple[int, str]], seed: int,
               **config: object) -> jtr.GbmCVNNPricer:
    """The JAX example's pricer: ``layers`` as (width, activation)."""
    cvnn = jf.build_cvnn_config(
        layers=[jf.LinearCfg(width=w, activation=jf.Activation(a)) for w, a in layers],
        seed=seed,
    ).expect("cvnn")
    params = jgbm.build_simulation_params(**sim).expect("sim")
    return jtr.GbmCVNNPricer.create(jtr.GbmCVNNPricerConfig(
        sim=params, bounds=jax_bounds(bounds), cvnn=cvnn, **config)).expect("pricer")


def jax_train(pricer: jtr.GbmCVNNPricer, **cfg: object) -> np.ndarray:
    return np.asarray(pricer.train(jtr.build_training_config(**cfg).expect("cfg"))
                      .expect("train").losses)


def assert_greeks(got, want) -> None:
    assert got.price == pytest.approx(want.price, rel=1e-5)
    for field, value in want.by_field.items():
        assert got.by_field[field] == pytest.approx(value, rel=1e-4, abs=1e-6), field
    assert got.gamma == pytest.approx(want.gamma, rel=1e-3, abs=1e-6)


def assert_wire_format(blob: bytes) -> None:
    """The port's checkpoint bytes are the JAX package's wire format: the
    port re-encodes them whole, and the JAX package decodes them and encodes
    the bytes the port encodes for the same config under the JAX package's
    environment record (which it writes in place of the ``torch_env``)."""
    port = deserialize_checkpoint(blob).expect("the port decodes its checkpoint")
    assert serialize_checkpoint(port)[0] == blob
    jax_bytes = jax_serialize(
        jax_deserialize(blob).expect("the JAX package decodes the port's checkpoint"))[0]
    jax_env = deserialize_checkpoint(jax_bytes).expect("decode").provenance.jax_env
    assert jax_env is not None
    as_jax = dataclasses.replace(port, provenance=Provenance(jax_env=jax_env))
    assert serialize_checkpoint(as_jax)[0] == jax_bytes


def case_01() -> None:
    size = dict(timesteps=4, network_size=16, batches_per_mc_run=16)
    out = example("01").run("cpu", implementation="xla", **size)
    mod = example("01")
    c = jgbm.BlackScholesContract(**mod.CONTRACT.model_dump())
    params = jgbm.build_simulation_params(mc_seed=42, **size).expect("sim")
    prices, engine = jgbm.BlackScholes(params).price_to_host(c)
    assert out["put"] == pytest.approx(prices.put, rel=REL)
    assert out["call"] == pytest.approx(prices.call, rel=REL)
    assert out["put_convexity"] == pytest.approx(prices.put_convexity, rel=1e-4, abs=1e-4)
    assert out["skip"] == engine.params.skip == 1
    black = jan.black_scholes_price(*mod.CONTRACT.model_dump().values())
    assert out["analytic_put"] == pytest.approx(float(black.put), rel=1e-12)


def case_02() -> None:
    mod = example("02")
    size = dict(timesteps=2, network_size=8, batches_per_mc_run=8)
    out = mod.run("cpu", implementation="xla", width=8, num_batches=3, batch_size=4, **size)
    jp = jax_pricer(dict(mc_seed=5, **size), mod.BOUNDS,
                    [(8, "modrelu"), (8, "modrelu")], seed=3)
    losses = jax_train(jp, num_batches=3, batch_size=4, learning_rate=2e-3)
    np.testing.assert_allclose(out["losses"], losses, rtol=REL)
    contracts = [jgbm.BlackScholesContract(spot=100, strike=k, maturity=1.0, rate=0.03,
                                           div_yield=0.01, vol=0.25) for k in mod.STRIKES]
    np.testing.assert_allclose(out["put"], jp.predict_price(contracts).put, rtol=REL)


def case_03() -> None:
    from spectralmc_tpu.serialization import compute_sha256
    from spectralmc_tpu.storage import AsyncBlockchainModelStore
    from spectralmc_tpu.storage.object_store import InMemoryObjectStore

    out = example("03").run("cpu")

    async def chain() -> list:
        store = AsyncBlockchainModelStore(InMemoryObjectStore("demo"))
        for i in range(3):
            payload = f"model-checkpoint-{i}".encode()
            (await store.commit(payload, compute_sha256(payload), f"release {i}")).expect("c")
        return list((await store.list_versions()).expect("list"))

    fields = ("counter", "semantic_version", "parent_hash", "content_hash", "message")
    for got, want in zip(out["versions"], asyncio.run(chain()), strict=True):
        assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
        assert got.directory_name == want.directory_name
    assert out["verdict"].versions == 3 and out["tampered"] == "Failure"
    assert type(out["tampered_error"]).__name__ == "ChecksumError"


def case_04() -> None:
    mod = example("04")
    out = mod.run("cpu", implementation="xla")
    jp = jax_pricer(dict(timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=42),
                    mod.BOUNDS, [(32, "modrelu")], seed=1)
    losses = jax_train(jp, num_batches=8, batch_size=8, learning_rate=2e-3)
    np.testing.assert_allclose(out["losses"], losses, rtol=REL)
    assert [m.split(" ")[0] for _, m in out["versions"]] == ["step=3", "step=6", "step=8"]
    assert out["resume_equal"] and np.array_equal(out["continued"], out["resumed"])
    assert jax_deserialize(out["head_bytes"]).expect("decode").global_step == 8
    assert_wire_format(out["head_bytes"])


def case_05() -> None:
    mod = example("05")
    out = mod.run("cpu", implementation="xla")
    assert out["pinned"] == "v0000000000" and out["pinned_step"] == 2
    assert out["tracking_swapped"] == "v0000000001"
    assert out["pinned_bytes"] == out["v0_bytes"] and out["tracked_bytes"] == out["v1_bytes"]
    for blob in (out["v0_bytes"], out["v1_bytes"]):
        assert_wire_format(blob)
    assert out["served_put"] == out["columnar_put"] == out["trainer_put"]
    jp = jax_pricer(dict(timesteps=2, network_size=16, batches_per_mc_run=4, mc_seed=42),
                    mod.BOUNDS, [(16, "modrelu")], seed=1)
    for _ in range(2):
        jax_train(jp, num_batches=2, batch_size=4, learning_rate=1e-3)
    want = jp.predict_price([jgbm.BlackScholesContract(**mod.CONTRACT.model_dump())]).put[0]
    assert out["served_put"] == pytest.approx(float(want), rel=REL)


def case_06() -> None:
    mod = example("06")
    out = mod.run("cpu", batch_shards=2, paths_shards=1, num_batches=3, implementation="xla",
                  timeout_s=100.0)
    assert (out["backend"], out["devices"]) == ("gloo", ["cpu", "cpu"])
    assert out["replicas_equal"] and out["max_rel_diff"] < 1e-5
    jp = jax_pricer(dict(timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=42),
                    mod.BOUNDS, [(32, "modrelu")], seed=1)
    losses = jax_train(jp, num_batches=3, batch_size=16, learning_rate=2e-3)
    np.testing.assert_allclose(out["single"], losses, rtol=REL)
    np.testing.assert_allclose(out["sharded"], losses, rtol=REL)


def case_07() -> None:
    mod = example("07")
    size = dict(timesteps=2, network_size=8, batches_per_mc_run=8)
    out = mod.run("cpu", implementation="xla", width=8, num_batches=2, batch_size=4, **size)
    jp = jax_pricer(dict(mc_seed=3, model="heston", **size), mod.BOUNDS,
                    [(8, "modrelu"), (8, "zrelu")], seed=5)
    np.testing.assert_allclose(out["losses"], jax_train(jp, num_batches=2, batch_size=4,
                                                        learning_rate=2e-3), rtol=REL)
    pred = jp.predict_price([jheston.HestonContract(**mod.PROBE)])
    assert out["put"] == pytest.approx(float(pred.put[0]), rel=REL)
    assert out["exact_put"] == pytest.approx(jheston.heston_call_price(**mod.PROBE)[1],
                                             rel=1e-10)


def case_08() -> None:
    mod = example("08")
    out = mod.run("cpu", processes=2, implementation="xla", timeout_s=100.0)
    assert (out["backend"], out["devices"]) == ("gloo", ["cpu", "cpu"])
    assert out["replicas_equal"] and len(out["versions"]) == 1
    assert out["versions"][0][1].startswith("step=8")
    assert [r["is_coordinator"] for r in out["ranks"]] == [True, False]
    jp = jax_pricer(dict(timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=7),
                    mod.make_config("xla").bounds, [(32, "modrelu")], seed=3,
                    normalize_inputs=True)
    losses = jax_train(jp, num_batches=8, batch_size=8, learning_rate=2e-3)
    for r in out["ranks"]:
        np.testing.assert_allclose(r["losses"], losses, rtol=REL)


def case_09() -> None:
    mod = example("09")
    size = dict(timesteps=4, network_size=16, batches_per_mc_run=16)
    out = mod.run("cpu", implementation="xla", num_batches=2, **size)
    c = jgbm.BlackScholesContract(**mod.CONTRACT.model_dump())
    sim = jgbm.build_simulation_params(mc_seed=7, **size).expect("sim")
    assert_greeks(out["mc"], jgreeks.mc_greeks(sim, c, option=jgreeks.OptionSide.CALL))
    oracle = jgreeks.analytic_greeks(c, option=jgreeks.OptionSide.CALL)
    assert out["oracle"].price == pytest.approx(oracle.price, rel=1e-10)
    jp = jax_pricer(dict(timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=7),
                    mod.BOUNDS, [(48, "modrelu")], seed=3)
    jax_train(jp, num_batches=2, batch_size=16, learning_rate=3e-3)
    g = jp.predict_greeks([c])
    jac = dict(zip(g.fields, g.call_jacobian[0]))
    assert out["learned_call"] == pytest.approx(float(g.call[0]), rel=REL)
    assert out["learned_delta"] == pytest.approx(float(jac["spot"]), rel=1e-4, abs=1e-6)
    assert out["learned_vega"] == pytest.approx(float(jac["vol"]), rel=1e-4, abs=1e-6)


def case_10() -> None:
    mod = example("10")
    size = dict(rows=4, cols=32, timesteps=3)
    out = mod.run("cpu", implementation="xla", greeks_network_size=16, greeks_batches=8, **size)
    np.testing.assert_array_equal(rng.prng_key(7).numpy(),
                                  np.asarray(jax.random.key_data(jax.random.PRNGKey(7))))
    c = jgbm.BlackScholesContract(**mod.CONTRACT.model_dump())
    geo = jbasket.build_basket_spec(
        weights=(0.5, 0.3, 0.2), correlation=mod.CORRELATION,
        spot_multipliers=(1.0, 0.9, 1.1), vol_multipliers=(1.0, 1.3, 0.7),
        combine=jbasket.BasketCombine.GEOMETRIC).expect("spec")

    def mc_call(spec) -> float:
        arr = c.as_array(np.float32)
        vals = jbasket.simulate_basket_underlier_rows(
            jax.random.PRNGKey(7), arr, spec=spec, timesteps=size["timesteps"],
            rows=size["rows"], cols=size["cols"], dtype=np.float32,
            payoff=jgbm.PayoffKind.TERMINAL)
        prices = jgbm.terminal_to_prices(
            vals.reshape(-1), arr, normalize=True, dtype=np.float32,
            mean_target=jbasket.expected_basket_underlier_mean(
                arr, spec, timesteps=size["timesteps"], payoff=jgbm.PayoffKind.TERMINAL,
                dtype=np.float32))
        return float(np.mean(prices.call_payoffs))

    assert out["geo_call"] == pytest.approx(mc_call(geo), rel=REL)
    for rho, got in zip(mod.RHOS, out["arithmetic_call"], strict=True):
        spec = jbasket.build_basket_spec(
            weights=(1 / 3, 1 / 3, 1 / 3),
            correlation=tuple(tuple(1.0 if i == j else rho for j in range(3))
                              for i in range(3))).expect("spec")
        assert got == pytest.approx(mc_call(spec), rel=REL)
    assert out["geo_closed_form"] == pytest.approx(float(jan.geometric_basket_price(
        100.0, 100.0, 1.0, 0.03, 0.01, 0.25, spec=geo).call), rel=1e-10)
    sim = jgbm.build_simulation_params(
        timesteps=size["timesteps"], network_size=16, batches_per_mc_run=8, mc_seed=7,
        model=jgbm.ModelKind.BASKET_GBM, basket=geo).expect("sim")
    assert_greeks(out["greeks"], jgreeks.mc_greeks(sim, c, option=jgreeks.OptionSide.CALL))


def case_11() -> None:
    mod = example("11")
    size = dict(timesteps=2, network_size=8, batches_per_mc_run=8)
    out = mod.run("cpu", implementation="xla", dates=4, paths=1 << 12, width=8, num_batches=2,
                  batch_size=4, **size)
    c = jgbm.BlackScholesContract(**mod.CONTRACT.model_dump())
    for name, split in (("lsmc", False), ("bracket", True)):
        want = jam.lsmc_price(jax.random.PRNGKey(7), c, timesteps=4, paths=1 << 12,
                              split_sample=split)
        got = out[name]
        assert abs(got.price - want.price) <= 2 * want.std_error, name
        assert got.european == pytest.approx(want.european, rel=1e-4)
        if split:
            assert abs(got.in_sample_price - want.in_sample_price) <= 2 * want.std_error
    assert out["tree"] == pytest.approx(jam.bermudan_tree_price(
        spot=100.0, strike=110.0, maturity=1.0, rate=0.05, div_yield=0.0, vol=0.25,
        exercise_dates=4, option="put"), rel=1e-12)
    jp = jax_pricer(dict(mc_seed=7, payoff="american_put", normalization="none", **size),
                    mod.BOUNDS, [(8, "modrelu"), (8, "zrelu")], seed=5, normalize_inputs=True)
    jax_train(jp, num_batches=2, batch_size=4, learning_rate=2e-3,
              lr_schedule=jstep.LRScheduleConfig(peak=1.2e-2, warmup_steps=0, decay_steps=2,
                                                 end_value=1e-5))
    atm = jgbm.BlackScholesContract(**mod.ATM.model_dump())
    want = float(jp.predict_price([atm]).put[0])
    assert out["atm_put"] == pytest.approx(want, rel=1e-3)  # 64 paths a contract: flips
    assert np.isnan(out["atm_call"])
    assert (out["engine"], out["lsmc_backward_version"]) == ("xla", 0)


def case_12() -> None:
    mod = example("12")
    size = dict(timesteps=2, network_size=8, batches_per_mc_run=8)
    out = mod.run("cpu", implementation="xla", width=8, num_batches=2, batch_size=4, **size)
    sim = dict(mc_seed=3, model="merton_jump", **size)
    jp = jax_pricer(sim, mod.BOUNDS, [(8, "modrelu"), (8, "zrelu")], seed=5)
    np.testing.assert_allclose(out["losses"], jax_train(jp, num_batches=2, batch_size=4,
                                                        learning_rate=2e-3), rtol=REL)
    probe = jmerton.MertonContract(**mod.PROBE)
    assert out["put"] == pytest.approx(float(jp.predict_price([probe]).put[0]), rel=REL)
    assert out["exact_put"] == pytest.approx(jmerton.merton_call_price(**mod.PROBE)[1],
                                             rel=1e-10)
    params = jgbm.build_simulation_params(**sim).expect("sim")
    ipa = jgreeks.mc_greeks(params, probe, option=jgreeks.OptionSide.CALL)
    bump = jgreeks.bump_greeks(params, probe, option=jgreeks.OptionSide.CALL)
    assert out["ipa_delta"] == pytest.approx(ipa.delta, rel=1e-4, abs=1e-6)
    assert out["ipa_lam"] == pytest.approx(ipa.by_field["lam"], rel=1e-4, abs=1e-6)
    # a bumped Greek is the difference of two float32 prices over 2h (h = 1%
    # of the field): allow 8 float32 ulps of the price over 2h
    for key, field in (("bump_delta", "spot"), ("bump_lam", "lam")):
        slack = 8 * np.finfo(np.float32).eps * bump.price / (2 * 1e-2 * mod.PROBE[field])
        assert out[key] == pytest.approx(bump.by_field[field], rel=1e-4, abs=slack), key


def case_13() -> None:
    mod = example("13")
    out = mod.run("cpu", implementation="xla", network_size=16, batches_per_mc_run=16)
    shape = jgbm.bootstrap_vol_shape(mod.QUOTES, timesteps=mod.TIMESTEPS,
                                     reference_vol=mod.REF_VOL).expect("shape")
    assert tuple(out["vol_shape"]) == tuple(shape)
    term = jgbm.TermStructure(vol_shape=shape, rate_shape=tuple(
        0.5 + 1.0 * i / mod.TIMESTEPS for i in range(mod.TIMESTEPS)))
    size = dict(timesteps=mod.TIMESTEPS, network_size=16, batches_per_mc_run=16, mc_seed=11,
                term=term)
    c = jgbm.BlackScholesContract(**mod.CONTRACT.model_dump())
    sim = jgbm.build_simulation_params(**size).expect("sim")
    prices, _ = jgbm.BlackScholes(sim).price_to_host(c)
    assert out["put"] == pytest.approx(prices.put, rel=REL)
    oracle = jan.term_effective_black(100.0, 102.0, 1.0, 0.03, 0.01, 0.25,
                                      vol_shape=term.vol_shape, rate_shape=term.rate_shape,
                                      div_shape=())
    assert out["effective_black_put"] == pytest.approx(float(oracle.put), rel=1e-12)
    assert_greeks(out["greeks"], jgreeks.mc_greeks(sim, c, option=jgreeks.OptionSide.PUT))
    asim = jgbm.build_simulation_params(**size, payoff="american_put",
                                        normalization="none").expect("asim")
    payoffs, _ = jgbm.BlackScholes(asim).price(c)
    am = np.asarray(payoffs.put_payoffs)
    assert abs(out["american_put"] - am.mean()) <= 2 * am.std() / np.sqrt(am.size)
    assert out["lattice_put"] == pytest.approx(jam.bermudan_grid_price(
        spot=100.0, strike=102.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25,
        timesteps=mod.TIMESTEPS, vol_shape=term.vol_shape, rate_shape=term.rate_shape),
        rel=1e-12)


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


RANKED = ("06", "08")  # gloo ranks in subprocesses, each world bounded by run's timeout_s


@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.timeout_s(150))
                                  if n in RANKED else n for n in sorted(CASES)])
def test_example_matches_jax(name: str, monkeypatch: pytest.MonkeyPatch) -> None:
    """Each of examples/torch/01–13 against the JAX package's calls at its
    small size (the tiers in the module docstring)."""
    assert sorted(p.name[:2] for p in EXAMPLES.glob("[0-9]*.py")) == sorted(CASES)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    CASES[name]()


def test_example_without_a_card_exits_loudly() -> None:
    """No card and no ``--device cpu``: the example exits non-zero naming
    the device it was asked for; it never falls back to the CPU."""
    assert not torch.cuda.is_available()
    proc = subprocess.run([sys.executable, str(EXAMPLES / "01_price_option.py")],
                          capture_output=True, text=True, timeout=100, cwd=REPO)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "'cuda'" in proc.stderr and "--device cpu" in proc.stderr
