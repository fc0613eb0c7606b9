"""Example 10 — multi-asset basket options: correlated GBMs, in the PyTorch port.

The port's counterpart of ``examples/10_basket_options.py``: three
correlated assets, options on the weighted basket, simulated on the
``"cuda"`` engine (kernel #7, ``csrc/basket_paths.cu``) from the contract
key of seed 7. The geometric basket is exactly lognormal under log-Euler,
so its closed form grades the MC; the correlation ablation shows the
Cholesky mixing at work (basket calls get pricier as assets co-move). The
pathwise Greeks run the threefry engine (``greeks_engine``: the kernel
engine's Greeks are GBM TERMINAL's).
Run: python examples/torch/10_basket_options.py [--device cpu]
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from examples.torch._common import device_from_argv  # noqa: E402
from spectralmc_tpu_torch.ops import rng  # noqa: E402
from spectralmc_tpu_torch.ops.analytic import geometric_basket_price  # noqa: E402
from spectralmc_tpu_torch.ops.basket import (  # noqa: E402
    BasketCombine,
    build_basket_spec,
    expected_basket_underlier_mean,
)
from spectralmc_tpu_torch.ops.dispatch import make_underlier_simulator  # noqa: E402
from spectralmc_tpu_torch.ops.gbm import (  # noqa: E402
    BlackScholesContract,
    ModelKind,
    PayoffKind,
    build_simulation_params,
    terminal_to_prices,
)
from spectralmc_tpu_torch.ops.greeks import OptionSide, mc_greeks  # noqa: E402

CONTRACT = BlackScholesContract(
    spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25
)
CORRELATION = ((1.0, 0.5, 0.2), (0.5, 1.0, 0.3), (0.2, 0.3, 1.0))
RHOS = (0.0, 0.4, 0.8)


def mc_call(spec, contract, device, *, rows=128, cols=2048, timesteps=6,
            implementation="cuda") -> tuple[float, float]:
    """The basket call's MC price and standard error on the paths of the
    contract key of seed 7."""
    sim = build_simulation_params(
        timesteps=timesteps, network_size=cols, batches_per_mc_run=rows, mc_seed=7,
        model=ModelKind.BASKET_GBM, basket=spec, implementation=implementation,
    ).expect("sim")
    arr = contract.as_array(torch.float32, device)[None]
    vals = make_underlier_simulator(sim, rows=rows)(rng.prng_key(7, device)[None], arr)
    prices = terminal_to_prices(
        vals.reshape(1, -1), arr, normalize=True, dtype=torch.float32,
        mean_target=expected_basket_underlier_mean(
            arr, spec, timesteps=timesteps, payoff=PayoffKind.TERMINAL, dtype=torch.float32
        ),
    )
    pay = prices.call_payoffs[0].double()
    return float(pay.mean()), float(pay.std()) / math.sqrt(pay.numel())


def run(device: torch.device | str, *, rows: int = 128, cols: int = 2048, timesteps: int = 6,
        greeks_network_size: int = 256, greeks_batches: int = 256,
        implementation: str = "cuda") -> dict[str, object]:
    """The geometric basket call (MC and standard error beside the closed
    form), the arithmetic basket call at each correlation of ``RHOS``, and
    the pathwise Greeks of the geometric basket call."""
    size = dict(rows=rows, cols=cols, timesteps=timesteps, implementation=implementation)
    geo = build_basket_spec(
        weights=(0.5, 0.3, 0.2), correlation=CORRELATION,
        spot_multipliers=(1.0, 0.9, 1.1), vol_multipliers=(1.0, 1.3, 0.7),
        combine=BasketCombine.GEOMETRIC,
    ).expect("spec")
    analytic = geometric_basket_price(
        CONTRACT.spot, CONTRACT.strike, CONTRACT.maturity, CONTRACT.rate,
        CONTRACT.div_yield, CONTRACT.vol, spec=geo,
    )
    geo_call, geo_se = mc_call(geo, CONTRACT, device, **size)

    arithmetic = []
    for rho in RHOS:
        spec = build_basket_spec(
            weights=(1 / 3, 1 / 3, 1 / 3),
            correlation=tuple(tuple(1.0 if i == j else rho for j in range(3))
                              for i in range(3)),
        ).expect("spec")
        arithmetic.append(mc_call(spec, CONTRACT, device, **size)[0])

    sim = build_simulation_params(
        timesteps=timesteps, network_size=greeks_network_size,
        batches_per_mc_run=greeks_batches, mc_seed=7, model=ModelKind.BASKET_GBM, basket=geo,
        implementation=implementation,
    ).expect("sim")
    g = mc_greeks(sim, CONTRACT, option=OptionSide.CALL, device=device)
    return {"geo_call": geo_call, "geo_se": geo_se, "geo_closed_form": float(analytic.call),
            "rhos": RHOS, "arithmetic_call": arithmetic, "greeks": g}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    print(f"geometric basket call: MC {out['geo_call']:.4f}  "
          f"closed form {out['geo_closed_form']:.4f}")
    print("\narithmetic basket call vs correlation (co-movement => variance => value):")
    for rho, call in zip(out["rhos"], out["arithmetic_call"]):
        print(f"  rho={rho:.1f}: {call:.4f}")
    g = out["greeks"]
    print(f"\npathwise basket greeks: delta={g.delta:.4f} vega={g.vega:.4f} "
          f"rho={g.rho:.4f} theta={g.theta:.4f}")


if __name__ == "__main__":
    main()
