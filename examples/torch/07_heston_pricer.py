"""Example 7 — the Heston model family: train a CVNN on stochastic-vol MC spectra,
in the PyTorch port.

The port's counterpart of ``examples/07_heston_pricer.py``: the CVNN learns
the characteristic function of discounted Heston put payoffs over a
10-dimensional Sobol contract domain on the ``"cuda"`` engine (kernel #5,
``csrc/dynamics_paths.cu``); the semi-analytic Heston price grades it.
Run: python examples/torch/07_heston_pricer.py [--device cpu]
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
from spectralmc_tpu_torch.ops.gbm import ModelKind, build_simulation_params  # noqa: E402
from spectralmc_tpu_torch.ops.heston import HestonContract, heston_call_price  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.training.trainer import (  # noqa: E402
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

BOUNDS = {
    "spot": BoundSpec(lower=95.0, upper=105.0),
    "strike": BoundSpec(lower=95.0, upper=105.0),
    "maturity": BoundSpec(lower=0.8, upper=1.2),
    "rate": BoundSpec(lower=0.02, upper=0.04),
    "div_yield": BoundSpec(lower=0.0, upper=0.02),
    "v0": BoundSpec(lower=0.03, upper=0.06),
    "kappa": BoundSpec(lower=1.0, upper=2.0),
    "theta": BoundSpec(lower=0.03, upper=0.06),
    "xi": BoundSpec(lower=0.2, upper=0.5),
    "rho": BoundSpec(lower=-0.8, upper=-0.4),
}
PROBE = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
             v0=0.045, kappa=1.5, theta=0.045, xi=0.35, rho=-0.6)


def run(device: torch.device | str, *, timesteps: int = 8, network_size: int = 32,
        batches_per_mc_run: int = 64, width: int = 64, num_batches: int = 600,
        batch_size: int = 32, implementation: str = "cuda") -> dict[str, object]:
    """The training losses and the model's put at ``PROBE`` beside the
    semi-analytic one."""
    sim = build_simulation_params(
        mc_seed=3, timesteps=timesteps, network_size=network_size,
        batches_per_mc_run=batches_per_mc_run, model=ModelKind.HESTON,
        implementation=implementation,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[
            LinearCfg(width=width, activation=Activation.MODRELU),
            LinearCfg(width=width, activation=Activation.ZRELU),
        ],
        seed=5,
    ).expect("cvnn")
    pricer = GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn), device=device
    ).expect("pricer")
    cfg = build_training_config(num_batches=num_batches, batch_size=batch_size,
                                learning_rate=2e-3).expect("cfg")
    result = pricer.train(cfg).expect("train")
    pred = pricer.predict_price([HestonContract(**PROBE)])
    _, put_exact = heston_call_price(**PROBE)
    return {"losses": np.asarray(result.losses), "final_loss": result.final_loss,
            "total_batches": result.total_batches, "put": float(pred.put[0]),
            "exact_put": float(put_exact)}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    print(f"loss: {out['losses'][0]:.2f} -> {out['final_loss']:.2f} "
          f"over {out['total_batches']} batches")
    err = (out["put"] - out["exact_put"]) / out["exact_put"]
    print(f"model put={out['put']:.4f}  semi-analytic={out['exact_put']:.4f}  err={err:+.1%}")


if __name__ == "__main__":
    main()
