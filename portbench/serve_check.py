"""The serving cells' comparison with the plain reference.

For a sample of the window's calls, drawn from the seed, every row the call
served: the reference normalizes the book's contracts by the bounds, runs
the network in evaluation mode (running batch-norm statistics), inverts
the spectrum (``mean(Re ifft(f))``) for the put and adds the parity term
``e^{−rT}·(S·e^{(r−q)T} − K)`` for the call. Compared, over all sampled
rows: ``put_gap`` and ``call_gap``, each the largest absolute gap over the
root mean square of the reference's values.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from portbench import inputs
from portbench.train_check import normalized

NUMBERS = ("put_gap", "call_gap")


def reference_prices(config: dict[str, Any], weights_flat: dict[str, torch.Tensor],
                     book: np.ndarray, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> tuple[np.ndarray, np.ndarray]:
    weights, state = inputs.split(weights_flat)
    w = {k: v.to(dtype) for k, v in weights.items()}
    s = {k: v.to(dtype) for k, v in state.items()}
    contracts = torch.from_numpy(book)
    x = normalized(config, contracts).to(device).to(dtype)
    with torch.no_grad():
        out_re, out_im = inputs.network(config)(w, s, x, torch.zeros_like(x), train=False)
        spectrum = torch.complex(out_re.float(), out_im.float())
        put = torch.mean(torch.fft.ifft(spectrum, dim=1).real, dim=1).double().cpu().numpy()
    c = book.astype(np.float64)
    spot, strike, maturity, rate, div = (c[:, i] for i in range(5))
    call = put + np.exp(-rate * maturity) * (spot * np.exp((rate - div) * maturity) - strike)
    return put, call


def compare(got: list[tuple[np.ndarray, np.ndarray]],
            want: list[tuple[np.ndarray, np.ndarray]]) -> dict[str, float]:
    out = {}
    for i, name in enumerate(NUMBERS):
        g = [np.asarray(pair[i], np.float64) for pair in got]
        w = [np.asarray(pair[i], np.float64) for pair in want]
        if not w or [x.shape for x in g] != [x.shape for x in w]:
            out[name] = math.inf
            continue
        g_all, w_all = np.concatenate(g), np.concatenate(w)
        gap = float(np.max(np.abs(g_all - w_all)) / np.sqrt(np.mean(w_all * w_all)))
        out[name] = gap if math.isfinite(gap) else math.inf
    return out
