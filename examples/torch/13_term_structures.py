"""Example 13 — term structures: price against a curved market, in the PyTorch port.

The port's counterpart of ``examples/13_term_structures.py``. Bootstrap a
piecewise-constant ``vol_shape`` from an implied-vol expiry strip (exactly
reproducing every quote, refusing calendar arbitrage), attach it with
rising rates to ``SimulationParams.term``, and the unchanged MC pipeline
prices the curved market on the ``"cuda"`` engine (kernel #2, the term
kernel of ``csrc/dynamics_paths.cu``) — gated by the still-exact
effective-Black oracle. The pathwise Greeks differentiate through the
curves (kernel #2's forward, the pathwise rule backward). The American put
under the same curves runs the threefry engine (the monitor kernel takes
flat markets), against the lattice oracle.
Run: python examples/torch/13_term_structures.py [--device cpu]
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from examples.torch._common import device_from_argv  # noqa: E402
from spectralmc_tpu_torch.ops.american import bermudan_grid_price  # noqa: E402
from spectralmc_tpu_torch.ops.analytic import (  # noqa: E402
    black_scholes_price,
    term_effective_black,
)
from spectralmc_tpu_torch.ops.gbm import (  # noqa: E402
    BlackScholes,
    BlackScholesContract,
    TermStructure,
    bootstrap_vol_shape,
    build_simulation_params,
)
from spectralmc_tpu_torch.ops.greeks import OptionSide, mc_greeks  # noqa: E402

TIMESTEPS = 8
QUOTES = ((2, 0.32), (5, 0.27), (8, 0.24))  # near vols rich, far vols cheap
REF_VOL = 0.25
CONTRACT = BlackScholesContract(
    spot=100.0, strike=102.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=REF_VOL
)


def run(device: torch.device | str, *, network_size: int = 256, batches_per_mc_run: int = 256,
        implementation: str = "cuda") -> dict[str, object]:
    """The bootstrapped vol shape; the curved MC put (and its standard
    error) beside effective-Black and flat Black; the curved put's pathwise
    Greeks; the curved American put beside the lattice."""
    # 1. Bootstrap the forward-variance shape from the strip.
    vol_shape = bootstrap_vol_shape(
        QUOTES, timesteps=TIMESTEPS, reference_vol=REF_VOL
    ).expect("no calendar arbitrage in the strip")
    # a rising money-market curve: short rates at half the long rate
    term = TermStructure(
        vol_shape=vol_shape,
        rate_shape=tuple(0.5 + 1.0 * i / TIMESTEPS for i in range(TIMESTEPS)),
    )

    # 2. Monte-Carlo price under the curves vs the exact effective-Black
    #    oracle (the terminal law stays lognormal under piecewise curves).
    size = dict(timesteps=TIMESTEPS, network_size=network_size,
                batches_per_mc_run=batches_per_mc_run, mc_seed=11, term=term,
                implementation=implementation)
    sim = build_simulation_params(**size).expect("sim")
    engine = BlackScholes(sim, device=device)
    prices, _ = engine.price_to_host(CONTRACT)
    payoffs, _ = engine.price(CONTRACT)  # the same draw: the payoffs' spread
    oracle = term_effective_black(
        CONTRACT.spot, CONTRACT.strike, CONTRACT.maturity,
        CONTRACT.rate, CONTRACT.div_yield, CONTRACT.vol,
        vol_shape=term.vol_shape, rate_shape=term.rate_shape, div_shape=(),
    )
    flat = black_scholes_price(
        CONTRACT.spot, CONTRACT.strike, CONTRACT.maturity,
        CONTRACT.rate, CONTRACT.div_yield, CONTRACT.vol,
    )

    # 3. Pathwise Greeks differentiate through the curves: vega picks up
    #    every step's vol * shape_t term.
    greeks = mc_greeks(sim, CONTRACT, option=OptionSide.PUT, device=device)

    # 4. Early exercise under the same curves: LSMC discounts each monitor
    #    segment at its own curve rate; the lattice oracle handles
    #    time-varying coefficients where a CRR tree cannot recombine.
    asim = build_simulation_params(
        **size, payoff="american_put", normalization="none"
    ).expect("asim")
    am_prices, _ = BlackScholes(asim, device=device).price_to_host(CONTRACT)
    am_oracle = bermudan_grid_price(
        spot=CONTRACT.spot, strike=CONTRACT.strike, maturity=CONTRACT.maturity,
        rate=CONTRACT.rate, div_yield=CONTRACT.div_yield, vol=CONTRACT.vol,
        timesteps=TIMESTEPS, vol_shape=term.vol_shape, rate_shape=term.rate_shape,
    )
    pay = payoffs.put_payoffs.double()
    return {"vol_shape": vol_shape, "put": prices.put,
            "put_se": float(pay.std()) / math.sqrt(pay.numel()),
            "effective_black_put": float(oracle.put), "flat_black_put": float(flat.put),
            "greeks": greeks, "american_put": am_prices.put, "lattice_put": am_oracle}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    print("bootstrapped vol_shape:", [round(v, 4) for v in out["vol_shape"]])
    print(f"curved MC put      {out['put']:.4f}")
    print(f"effective-Black    {out['effective_black_put']:.4f}  (exact oracle)")
    print(f"flat Black         {out['flat_black_put']:.4f}  (what ignoring the curve quotes)")
    g = out["greeks"]
    print(f"curved greeks: delta {g.delta:.4f} vega {g.vega:.4f} "
          f"rho {g.by_field['rate']:.4f} (engine={g.engine.value})")
    print(f"curved American put: LSMC {out['american_put']:.4f}  "
          f"lattice {out['lattice_put']:.4f}  (European: {out['effective_black_put']:.4f})")


if __name__ == "__main__":
    main()
