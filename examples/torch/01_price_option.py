"""Example 1 — Monte-Carlo option pricing with the GBM engine, in the PyTorch port.

The port's counterpart of ``examples/01_price_option.py``: one contract
priced by ``BlackScholes.price_to_host`` on the ``"cuda"`` engine (kernel
#1's TERMINAL branch, ``csrc/gbm_paths.cu``) against Black–Scholes.
Run: python examples/torch/01_price_option.py [--device cpu]
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from examples.torch._common import device_from_argv  # noqa: E402
from spectralmc_tpu_torch.ops.analytic import black_scholes_price  # noqa: E402
from spectralmc_tpu_torch.ops.gbm import (  # noqa: E402
    BlackScholes,
    BlackScholesContract,
    build_simulation_params,
)

CONTRACT = BlackScholesContract(
    spot=100.0, strike=105.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25
)


def run(device: torch.device | str, *, timesteps: int = 16, network_size: int = 256,
        batches_per_mc_run: int = 256, mc_seed: int = 42,
        implementation: str = "cuda") -> dict[str, object]:
    """The MC put and call of ``CONTRACT`` with their standard errors, the
    time value, the engine's advanced skip and the Black prices."""
    params = build_simulation_params(
        timesteps=timesteps, network_size=network_size, batches_per_mc_run=batches_per_mc_run,
        mc_seed=mc_seed, implementation=implementation,
    ).expect("valid simulation params")
    engine = BlackScholes(params, device=device)
    prices, advanced = engine.price_to_host(CONTRACT)
    payoffs, _ = engine.price(CONTRACT)  # the same draw: the payoffs' spread
    n = payoffs.put_payoffs.numel()
    analytic = black_scholes_price(
        CONTRACT.spot, CONTRACT.strike, CONTRACT.maturity,
        CONTRACT.rate, CONTRACT.div_yield, CONTRACT.vol,
    )
    return {
        "put": prices.put, "call": prices.call,
        "put_se": float(payoffs.put_payoffs.double().std()) / math.sqrt(n),
        "call_se": float(payoffs.call_payoffs.double().std()) / math.sqrt(n),
        "analytic_put": float(analytic.put), "analytic_call": float(analytic.call),
        "put_convexity": prices.put_convexity, "skip": advanced.params.skip,
    }


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    print(f"MC put  = {out['put']:.4f}   analytic = {out['analytic_put']:.4f}")
    print(f"MC call = {out['call']:.4f}   analytic = {out['analytic_call']:.4f}")
    print(f"convexity (time value) = {out['put_convexity']:.4f}")
    print(f"engine resume counter (skip) = {out['skip']}")


if __name__ == "__main__":
    main()
