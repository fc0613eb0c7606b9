"""Example 11 — American options: Longstaff–Schwartz, in the PyTorch port.

The port's counterpart of ``examples/11_american_options.py``. On the
``"cuda"`` engine the monitor rows come from kernel #4
(``csrc/american_paths.cu``) and the backward induction is one cooperative
launch of the CUDA LSMC backward (kernel #11, ``csrc/lsmc_backward.cuh``);
the oracle is a Bermudan-aware binomial tree restricted to the same
exercise dates. Then the American put as a family: the same train →
predict → Greeks pipeline every other family uses (backward version 3
recorded). Run: python examples/torch/11_american_options.py [--device cpu]
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
from spectralmc_tpu_torch.ops import rng  # noqa: E402
from spectralmc_tpu_torch.ops.american import bermudan_tree_price, lsmc_price  # noqa: E402
from spectralmc_tpu_torch.ops.analytic import black_scholes_price  # noqa: E402
from spectralmc_tpu_torch.ops.gbm import (  # noqa: E402
    BlackScholesContract,
    SimImplementation,
    build_simulation_params,
)
from spectralmc_tpu_torch.ops.greeks import OptionSide  # noqa: E402
from spectralmc_tpu_torch.ops.sobol import BoundSpec  # noqa: E402
from spectralmc_tpu_torch.training.step import LRScheduleConfig  # noqa: E402
from spectralmc_tpu_torch.training.trainer import (  # noqa: E402
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

CONTRACT = BlackScholesContract(
    spot=100.0, strike=110.0, maturity=1.0, rate=0.05, div_yield=0.0, vol=0.25
)
ATM = BlackScholesContract(
    spot=100.0, strike=100.0, maturity=1.0, rate=0.04, div_yield=0.01, vol=0.25
)
BOUNDS = {
    "spot": BoundSpec(lower=95.0, upper=105.0),
    "strike": BoundSpec(lower=95.0, upper=105.0),
    "maturity": BoundSpec(lower=0.5, upper=1.5),
    "rate": BoundSpec(lower=0.01, upper=0.05),
    "div_yield": BoundSpec(lower=0.0, upper=0.02),
    "vol": BoundSpec(lower=0.2, upper=0.3),
}


def run(device: torch.device | str, *, dates: int = 16, paths: int = 1 << 17,
        timesteps: int = 8, network_size: int = 32, batches_per_mc_run: int = 64,
        width: int = 64, num_batches: int = 800, batch_size: int = 32,
        implementation: str = "cuda") -> dict[str, object]:
    """The LSMC put (``AmericanPrice``, classic and split-sample) beside the
    Bermudan tree and Black's European put; the trained American-put
    pricer's ATM put, learned delta, final loss and recorded backward
    version beside its tree price."""
    engine = SimImplementation(implementation)
    key = rng.prng_key(7)
    result = lsmc_price(key, CONTRACT, timesteps=dates, paths=paths, option=OptionSide.PUT,
                        implementation=engine, device=device)
    tree = bermudan_tree_price(
        spot=CONTRACT.spot, strike=CONTRACT.strike, maturity=CONTRACT.maturity,
        rate=CONTRACT.rate, div_yield=CONTRACT.div_yield, vol=CONTRACT.vol,
        exercise_dates=dates, option="put",
    )
    euro = float(
        black_scholes_price(
            CONTRACT.spot, CONTRACT.strike, CONTRACT.maturity,
            CONTRACT.rate, CONTRACT.div_yield, CONTRACT.vol,
        ).put
    )
    # split-sample estimator: fit the exercise policy on half the paths,
    # price on the other half — the out-of-sample price is a statistical
    # lower bound (no look-ahead) and in_sample_price the classic high-biased
    # estimate, so the pair brackets the true Bermudan price.
    bracket = lsmc_price(key, CONTRACT, timesteps=dates, paths=paths, option=OptionSide.PUT,
                         split_sample=True, implementation=engine, device=device)

    # American as a family: LSMC cashflows feed the learned spectrum
    sim = build_simulation_params(
        timesteps=timesteps, network_size=network_size, batches_per_mc_run=batches_per_mc_run,
        mc_seed=7, payoff="american_put", normalization="none", implementation=implementation,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[
            LinearCfg(width=width, activation=Activation.MODRELU),
            LinearCfg(width=width, activation=Activation.ZRELU),
        ],
        seed=5,
    ).expect("cvnn")
    pricer = GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn, normalize_inputs=True),
        device=device,
    ).expect("pricer")
    tc = build_training_config(
        num_batches=num_batches, batch_size=batch_size, learning_rate=2e-3,
        lr_schedule=LRScheduleConfig(
            peak=1.2e-2, warmup_steps=num_batches // 10, decay_steps=num_batches,
            end_value=1e-5,
        ),
    ).expect("tc")
    res = pricer.train(tc).expect("train")
    pred = pricer.predict_price([ATM])
    greeks = pricer.predict_greeks([ATM])
    tree_atm = bermudan_tree_price(
        spot=ATM.spot, strike=ATM.strike, maturity=ATM.maturity, rate=ATM.rate,
        div_yield=ATM.div_yield, vol=ATM.vol, exercise_dates=timesteps, option="put",
    )
    snap = pricer.snapshot()
    return {"lsmc": result, "tree": tree, "european": euro, "bracket": bracket,
            "dates": dates, "num_batches": num_batches, "final_loss": res.final_loss,
            "atm_put": float(pred.put[0]), "atm_call": float(pred.call[0]),
            "atm_tree": tree_atm, "atm_delta": float(greeks.put_jacobian[0, 0]),
            "engine": snap.sim.implementation.value,
            "lsmc_backward_version": snap.lsmc_backward_version}


def main(argv: list[str] | None = None) -> None:
    out = run(device_from_argv(__doc__, argv))
    result, bracket = out["lsmc"], out["bracket"]
    print(f"American put (K=110, r=5%): LSMC {result.price:.4f} ± {result.std_error:.4f}")
    print(f"  Bermudan tree (same {out['dates']} dates): {out['tree']:.4f}")
    print(f"  European (Black):                  {out['european']:.4f}")
    print(f"  early-exercise premium:            {result.price - result.european:.4f}")
    print(f"  split-sample bracket: [{bracket.price:.4f} (out-of-sample), "
          f"{bracket.in_sample_price:.4f} (in-sample)] ± {bracket.std_error:.4f}")
    print(f"\nLearned American-put family ({out['num_batches']} online batches, "
          f"loss {out['final_loss']:.3g}):")
    print(f"  predict_price ATM put: {out['atm_put']:.4f} (tree {out['atm_tree']:.4f})")
    print(f"  delta of the learned surface: {out['atm_delta']:.4f}")
    print("  call channel is NaN: early exercise has no put-call parity")


if __name__ == "__main__":
    main()
