"""Characteristic-function (DFT) estimator of the MC payoff distribution.

The port of the JAX package's ``ops/spectrum.py`` on ``torch.fft`` (cuFFT on
the card, as the JAX package left the FFT to XLA). The DFT is linear, so the
batch-mean spectrum is one ``network_size``-point FFT of the row mean.
``mean_spectrum_psum`` is the sharded variant: each rank FFTs the sum of its
own rows and the batch mean is one all-reduce over the mesh's paths group.
"""

from __future__ import annotations

import torch

from spectralmc_tpu_torch.ops.collectives import ProcessGroup, psum


def payoff_spectrum(payoffs: torch.Tensor, *, batches: int, network_size: int) -> torch.Tensor:
    """Batch-averaged DFT ``[..., network_size]`` complex of ``[..., batches*network]``.

    ``mean_r FFT(row_r) == FFT(mean_r row_r)``: one FFT of the row mean
    replaces ``batches`` row FFTs. Leading dims are contracts.
    """
    rows = payoffs.reshape(*payoffs.shape[:-1], batches, network_size)
    return torch.fft.fft(torch.mean(rows, dim=-2), dim=-1)


def local_spectrum_sum(payoffs: torch.Tensor, *, batches: int, network_size: int) -> torch.Tensor:
    """Per-shard un-normalized spectrum sum ``[..., network_size]`` (combine
    with ``psum`` and a divide)."""
    rows = payoffs.reshape(*payoffs.shape[:-1], batches, network_size)
    return torch.fft.fft(torch.sum(rows, dim=-2), dim=-1)


def mean_spectrum_psum(
    payoffs: torch.Tensor,
    *,
    batches: int,
    network_size: int,
    group: ProcessGroup,
    total_batches: int,
) -> torch.Tensor:
    """Sharded batch-mean spectrum: the local FFT of the row sum, one
    all-reduce over ``group`` (the paths group), then the divide by the
    global row count ``total_batches``."""
    local = local_spectrum_sum(payoffs, batches=batches, network_size=network_size)
    return psum(local, group) / total_batches


def spectrum_to_price(spectrum: torch.Tensor) -> torch.Tensor:
    """Invert a spectrum ``[..., network]`` back to E[discounted payoff].

    The mean of the recovered sequence is ``spectrum[0] / network_size``
    algebraically; the full IFFT is kept so the imaginary residue stays
    available as a model-quality diagnostic.
    """
    return torch.mean(torch.fft.ifft(spectrum, dim=-1), dim=-1)
