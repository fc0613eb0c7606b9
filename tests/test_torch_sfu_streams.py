"""The basket streams' SFU Box–Muller and the stream versions, on the CPU.

* ``minus_two_log``'s polynomial (``csrc/path_stream.cuh``), read from the
  header and evaluated in float32 with every FMA rounded once, against
  float64 over every u1 >= ½ the stream can draw: relative-accurate to
  2 ulp, and the subtraction u1 − 1 it rests on exact.
* The streams whose arithmetic changed are at version 2 or 3: the basket
  streams (this transform), ``gbm`` (every branch of the flat kernel walks
  whole Philox calls; its transform takes ln u1 and the sine and cosine on
  fixed roundings and the root on the SFU, ``csrc/gbm_step.cuh``),
  ``american_gbm`` (v2: its odd single step's draw on the SFU; v3: its
  pair steps are ``gbm``'s) and the Heston streams (draw and step on fixed
  roundings, ``csrc/heston_step.cuh``) and the Merton streams (three words a
  step, four steps on three Philox calls, the draw and the step on fixed
  roundings, ``csrc/merton_step.cuh``) and the curved-term and cliquet
  streams (whole-call walks, the draw and the steps on fixed roundings)
  (``gbm_cuda.cuda_stream_version``);
  a checkpoint that recorded any version before is refused mid-stream with
  ``EngineMismatch`` (the
  pattern of
  ``test_torch_slice.py::test_midstream_cuda_checkpoint_needs_its_stream_version``),
  and the checkpoint at the current version resumes.

The kernels themselves are held to their plain twins on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from spectralmc_tpu_torch.core.errors.trainer import EngineMismatch
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import basket as tbasket
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import gbm_cuda
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.training import trainer as ttr

HEADER = Path(tgbm.__file__).resolve().parent.parent / "csrc" / "path_stream.cuh"


def _minus_two_log_coefficients() -> list[float]:
    """Q's coefficients, highest first, as the header's Horner chain lists them."""
    body = HEADER.read_text().split("float minus_two_log(float u1) {")[1].split("}")[0]
    first = re.search(r"float q = (-?[0-9.]+)f;", body).group(1)
    return [float(first), *map(float, re.findall(r"q = fmaf\(q, d, (-?[0-9.]+)f\);", body))]


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a·b + c rounded once (the float32 product is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def test_minus_two_log_polynomial_is_relative_accurate() -> None:
    """Every u1 = uniform_open(w) >= ½: the float32 Horner chain of Q and
    the last FMA −2d + d²·Q stay within 2 ulp of −2·ln u1 (the kernel's
    root then keeps the radius relative-accurate as u1 nears 1)."""
    coefficients = _minus_two_log_coefficients()
    assert len(coefficients) == 8
    m = np.arange(2**23, 2**24, dtype=np.float64)  # the 24-bit words with u1 >= ½
    u1 = ((2.0 * m + 1.0) * 2.0**-25).astype(np.float32)  # the FMA's one rounding
    d = (u1.astype(np.float64) - 1.0).astype(np.float32)
    np.testing.assert_array_equal(d.astype(np.float64), u1.astype(np.float64) - 1.0)
    q = np.full_like(d, np.float32(coefficients[0]))
    for c in coefficients[1:]:
        q = _fma32(q, d, np.full_like(d, np.float32(c)))
    x = _fma32((d * d).astype(np.float32), q, (np.float32(-2.0) * d).astype(np.float32))
    want = -2.0 * np.log(u1.astype(np.float64))
    assert float(u1.max()) == 1.0 and float(x[u1 == 1.0].max()) == 0.0  # 1 − 2^-25 rounds up
    inside = want > 0
    rel = np.abs(x.astype(np.float64)[inside] - want[inside]) / want[inside]
    assert float(rel.max()) <= 2.0 * 2.0**-24
    assert bool((x[inside] > 0).all())


def _cvnn():
    return tf.build_cvnn_config(
        layers=[tf.LinearCfg(width=8, bias=False, activation=tf.Activation.MODRELU),
                tf.CovBNCfg(), tf.LinearCfg(width=8)], seed=3).expect("cvnn")


MARKET = {"spot": (95.0, 105.0), "strike": (95.0, 105.0), "maturity": (0.5, 1.5),
          "rate": (0.01, 0.05), "div_yield": (0.0, 0.02)}
HESTON = {**MARKET, "v0": (0.03, 0.08), "kappa": (1.0, 2.5), "theta": (0.03, 0.08),
          "xi": (0.2, 0.5), "rho": (-0.8, -0.3)}
BASKET = {**MARKET, "vol": (0.2, 0.3)}
MERTON = {**MARKET, "vol": (0.15, 0.25), "lam": (0.1, 0.8), "jump_mean": (-0.15, 0.0),
          "jump_std": (0.1, 0.25)}
GBM = BASKET
BASKET_SPEC = tbasket.build_basket_spec(
    weights=(0.5, 0.3, 0.2),
    correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0))).expect("spec")
CLIQUET = {**GBM, "strike": (0.01, 0.08)}  # the cliquet's strike in return units
# stream key -> (model, payoff, bounds, version, more of the config): the
# basket streams and american_gbm's single step, whose Box–Muller moved to
# the SFU, the flat GBM stream, whose draws moved to whole-call walks and a
# new transform (and american_gbm's pair steps with it), the Heston streams,
# whose draw and step moved to fixed roundings, the Merton streams, whose
# words moved to three a step and whose draw and step moved to fixed
# roundings, and the curved-term and cliquet streams, whose draws moved to
# whole-call walks and whose draw and steps moved to fixed roundings
STREAMS = {
    "basket_gbm": ("basket_gbm", "terminal", BASKET, 2, {"basket": BASKET_SPEC}),
    "american_basket_gbm": ("basket_gbm", "american_put", BASKET, 2, {"basket": BASKET_SPEC}),
    "gbm": ("gbm", "terminal", GBM, 2, {}),
    "american_gbm": ("gbm", "american_put", GBM, 3, {}),
    "heston": ("heston", "terminal", HESTON, 2, {}),
    "american_heston": ("heston", "american_put", HESTON, 2, {}),
    "merton_jump": ("merton_jump", "terminal", MERTON, 2, {}),
    "american_merton_jump": ("merton_jump", "american_put", MERTON, 2, {}),
    "gbm_term": ("gbm", "terminal", GBM, 2,
                 {"term": tgbm.TermStructure(vol_shape=(1.2, 1.1, 0.9, 0.8))}),
    "gbm_cliquet": ("gbm", "cliquet", CLIQUET, 2,
                    dict(cliquet_reset_every=2, cliquet_floor=-0.05, cliquet_cap=0.08)),
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_stream_version_is_recorded_and_an_older_one_refused_mid_stream(stream: str) -> None:
    model, payoff, bounds, version, more = STREAMS[stream]
    sim = tgbm.build_simulation_params(
        timesteps=4, network_size=16, batches_per_mc_run=8, mc_seed=2, model=model,
        payoff=payoff, normalization="none", implementation="cuda", **more).expect("sim")
    assert tgbm.resolve_implementation(sim) == tgbm.SimImplementation.CUDA
    assert gbm_cuda.cuda_stream_version(sim.model, sim.payoff,
                                        term=tgbm.curved(sim.term) is not None) == \
        gbm_cuda.CUDA_STREAM_VERSIONS[stream] == version
    cfg = ttr.GbmCVNNPricerConfig(
        sim=sim, bounds={k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in bounds.items()},
        cvnn=_cvnn(), normalize_inputs=True)
    pricer = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("pricer")
    train = ttr.build_training_config(num_batches=1, batch_size=4, learning_rate=1e-3,
                                      contract_chunk=4).expect("training config")
    pricer.train(train).expect("train")
    snap = pricer.snapshot()
    assert snap.global_step == 1 and snap.cuda_stream_version == version
    for older in range(1, version):
        stale = ttr.GbmCVNNPricerConfig(**{**snap.__dict__, "cuda_stream_version": older})
        refused = ttr.GbmCVNNPricer.create(stale, device="cpu")
        assert refused.is_failure() and isinstance(refused.error, EngineMismatch)
        assert refused.error.requested == f"cuda stream v{older}"
        assert refused.error.effective == f"cuda stream v{version}"
    assert ttr.GbmCVNNPricer.create(snap, device="cpu").is_success()
