"""Example 2 — train a CVNN pricer on MC spectra (the core workflow), in the PyTorch port.

The port's counterpart of ``examples/02_train_pricer.py``: a
``GbmCVNNPricer`` trained online for 600 batches on the ``"cuda"`` engine
(kernel #1's TERMINAL branch), then its puts against Black–Scholes.
Run: python examples/torch/02_train_pricer.py [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples.torch._common import device_from_argv  # noqa: E402
from spectralmc_tpu_torch.models.factory import (  # noqa: E402
    Activation,
    LinearCfg,
    build_cvnn_config,
)
from spectralmc_tpu_torch.ops.analytic import black_scholes_price  # noqa: E402
from spectralmc_tpu_torch.ops.gbm import BlackScholesContract, build_simulation_params  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.training import (  # noqa: E402
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

BOUNDS = {
    "spot": BoundSpec(lower=95.0, upper=105.0),
    "strike": BoundSpec(lower=95.0, upper=105.0),
    "maturity": BoundSpec(lower=0.9, upper=1.1),
    "rate": BoundSpec(lower=0.02, upper=0.04),
    "div_yield": BoundSpec(lower=0.005, upper=0.015),
    "vol": BoundSpec(lower=0.2, upper=0.3),
}
STRIKES = (96.0, 100.0, 104.0)


def run(device: torch.device | str, *, timesteps: int = 2, network_size: int = 32,
        batches_per_mc_run: int = 64, width: int = 64, num_batches: int = 600,
        batch_size: int = 32, implementation: str = "cuda") -> dict[str, object]:
    """The training losses, and the model's and Black's puts at ``STRIKES``."""
    sim = build_simulation_params(
        timesteps=timesteps, network_size=network_size, batches_per_mc_run=batches_per_mc_run,
        mc_seed=5, implementation=implementation,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[
            LinearCfg(width=width, activation=Activation.MODRELU),
            LinearCfg(width=width, activation=Activation.MODRELU),
        ],
        seed=3,
    ).expect("cvnn")
    pricer = GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn), device=device
    ).expect("pricer")
    result = pricer.train(
        build_training_config(num_batches=num_batches, batch_size=batch_size,
                              learning_rate=2e-3).expect("cfg")
    ).expect("training")
    contracts = [
        BlackScholesContract(spot=100, strike=k, maturity=1.0, rate=0.03, div_yield=0.01,
                             vol=0.25)
        for k in STRIKES
    ]
    pred = pricer.predict_price(contracts)
    analytic = [float(black_scholes_price(c.spot, c.strike, c.maturity, c.rate, c.div_yield,
                                          c.vol).put) for c in contracts]
    return {"losses": np.asarray(result.losses), "strikes": STRIKES,
            "put": [float(p) for p in pred.put], "analytic_put": analytic,
            "engine": pricer.snapshot().sim.implementation.value}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    losses = out["losses"]
    print(f"loss: {np.mean(losses[:10]):.2f} -> {np.mean(losses[-10:]):.2f}")
    for k, put, a in zip(out["strikes"], out["put"], out["analytic_put"]):
        print(f"K={k}: model put={put:.3f}  analytic={a:.3f}  err={(put - a) / a:+.1%}")


if __name__ == "__main__":
    main()
