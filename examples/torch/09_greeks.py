"""Example 9 — Greeks by autograd: pathwise MC sensitivities + learned-pricer Jacobians,
in the PyTorch port.

The port's counterpart of ``examples/09_greeks.py``. Every first-order
Greek of the MC price (all six contract fields at once) is one reverse pass:
on the ``"cuda"`` engine the forward is kernel #1 and its backward the
pathwise rule over the kernel's samples (``gbm_cuda.TerminalPathwise``).
The learned pricer's Jacobians and gamma come from ``predict_greeks``.
Run: python examples/torch/09_greeks.py [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from examples.torch._common import device_from_argv  # noqa: E402
from spectralmc_tpu_torch.models.factory import (  # noqa: E402
    Activation,
    LinearCfg,
    build_cvnn_config,
)
from spectralmc_tpu_torch.ops.gbm import BlackScholesContract, build_simulation_params  # noqa: E402
from spectralmc_tpu_torch.ops.greeks import OptionSide, analytic_greeks, mc_greeks  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.training.trainer import (  # noqa: E402
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

GREEKS = ("delta", "gamma", "vega", "theta", "rho", "dual_delta")
CONTRACT = BlackScholesContract(
    spot=100.0, strike=105.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25
)
BOUNDS = {
    "spot": BoundSpec(lower=80.0, upper=120.0),
    "strike": BoundSpec(lower=80.0, upper=120.0),
    "maturity": BoundSpec(lower=0.25, upper=2.0),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}


def run(device: torch.device | str, *, timesteps: int = 16, network_size: int = 256,
        batches_per_mc_run: int = 256, num_batches: int = 60,
        implementation: str = "cuda") -> dict[str, object]:
    """The pathwise MC call Greeks beside Black–Scholes' (``mc``, ``oracle``:
    the ``MCGreeks``), and the learned pricer's call, delta, vega and gamma
    after ``num_batches`` online batches."""
    sim = build_simulation_params(
        timesteps=timesteps, network_size=network_size, batches_per_mc_run=batches_per_mc_run,
        mc_seed=7, implementation=implementation,
    ).expect("sim params")
    mc = mc_greeks(sim, CONTRACT, option=OptionSide.CALL, device=device)
    oracle = analytic_greeks(CONTRACT, option=OptionSide.CALL, device=device)

    # Greeks of the LEARNED pricer: smooth Jacobian over all fields + gamma.
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=48, activation=Activation.MODRELU)], seed=3
    ).expect("cvnn config")
    tiny_sim = build_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=7,
        implementation=implementation,
    ).expect("sim params")
    pricer = GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=tiny_sim, bounds=BOUNDS, cvnn=cvnn), device=device
    ).expect("pricer")
    pricer.train(
        build_training_config(num_batches=num_batches, batch_size=16,
                              learning_rate=3e-3).expect("cfg")
    ).expect("train")
    g = pricer.predict_greeks([CONTRACT])
    jac = dict(zip(g.fields, g.call_jacobian[0]))
    return {"mc": mc, "oracle": oracle, "engine": mc.engine.value,
            "learned_call": float(g.call[0]), "learned_delta": float(jac["spot"]),
            "learned_vega": float(jac["vol"]), "learned_gamma": float(g.call_gamma[0]),
            "num_batches": num_batches}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    mc, oracle = out["mc"], out["oracle"]
    print(f"{'greek':<12}{'pathwise MC':>14}{'Black-Scholes':>16}")
    for name in GREEKS:
        print(f"{name:<12}{getattr(mc, name):>14.5f}{getattr(oracle, name):>16.5f}")
    print(f"{'price':<12}{mc.price:>14.5f}{oracle.price:>16.5f}")
    print(f"\nlearned pricer (after {out['num_batches']} online batches):")
    print(f"  call={out['learned_call']:.4f}  delta={out['learned_delta']:.4f}  "
          f"vega={out['learned_vega']:.4f}  gamma={out['learned_gamma']:.5f}")
    print("  (tighter after longer training — see docs/performance.md quality section)")


if __name__ == "__main__":
    main()
