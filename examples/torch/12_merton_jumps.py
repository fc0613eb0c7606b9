"""Example 12 — the Merton jump-diffusion family: train a CVNN on jumpy MC spectra,
in the PyTorch port.

The port's counterpart of ``examples/12_merton_jumps.py``: the CVNN learns
the characteristic function of discounted Merton put payoffs over a
9-dimensional Sobol contract domain on the ``"cuda"`` engine (kernel #9,
``csrc/dynamics_paths.cu``); Merton's exact series price grades it. The
MC Greeks at the probe are pathwise (``mc_greeks``) and bump-and-reprice
(``bump_greeks``, which carries the full ``lam`` sensitivity).
Run: python examples/torch/12_merton_jumps.py [--device cpu]
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
from spectralmc_tpu_torch.ops.greeks import OptionSide, bump_greeks, mc_greeks  # noqa: E402
from spectralmc_tpu_torch.ops.merton import MertonContract, merton_call_price  # noqa: E402
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
    "vol": BoundSpec(lower=0.15, upper=0.25),
    "lam": BoundSpec(lower=0.1, upper=0.8),
    "jump_mean": BoundSpec(lower=-0.15, upper=0.0),
    "jump_std": BoundSpec(lower=0.1, upper=0.25),
}
PROBE = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
             vol=0.2, lam=0.4, jump_mean=-0.08, jump_std=0.18)


def run(device: torch.device | str, *, timesteps: int = 8, network_size: int = 32,
        batches_per_mc_run: int = 64, width: int = 64, num_batches: int = 600,
        batch_size: int = 32, implementation: str = "cuda") -> dict[str, object]:
    """The training losses, the model's put at ``PROBE`` beside the series
    price, and the pathwise and bumped delta and ``lam`` Greeks there."""
    sim = build_simulation_params(
        mc_seed=3, timesteps=timesteps, network_size=network_size,
        batches_per_mc_run=batches_per_mc_run, model=ModelKind.MERTON_JUMP,
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
    pred = pricer.predict_price([MertonContract(**PROBE)])
    _, put_exact = merton_call_price(**PROBE)

    # MC Greeks: pathwise is exact on the diffusion fields; the lam field
    # needs bump-and-reprice for the discrete count channel
    ipa = mc_greeks(sim, MertonContract(**PROBE), option=OptionSide.CALL, device=device)
    fd = bump_greeks(sim, MertonContract(**PROBE), option=OptionSide.CALL, device=device)
    return {"losses": np.asarray(result.losses), "final_loss": result.final_loss,
            "total_batches": result.total_batches, "put": float(pred.put[0]),
            "exact_put": float(put_exact), "ipa_delta": ipa.delta, "bump_delta": fd.delta,
            "ipa_lam": ipa.by_field["lam"], "bump_lam": fd.by_field["lam"]}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    print(f"loss: {out['losses'][0]:.2f} -> {out['final_loss']:.2f} "
          f"over {out['total_batches']} batches")
    err = (out["put"] - out["exact_put"]) / out["exact_put"]
    print(f"model put={out['put']:.4f}  series-exact={out['exact_put']:.4f}  err={err:+.1%}")
    print(f"delta: ipa={out['ipa_delta']:+.4f} bump={out['bump_delta']:+.4f}   "
          f"lam-greek: envelope={out['ipa_lam']:+.4f} full={out['bump_lam']:+.4f}")


if __name__ == "__main__":
    main()
