"""Kernel #14's sparse, Gray-stepped walk (``csrc/qmc_paths.cu``'s
``qmc_walk_sparse_kernel``) replayed in torch on the CPU, tier 1, exact.

* The pattern the kernel compiles (its ``bridge_col``, read from the source
  and evaluated here, and ``qmc_cuda.bridge_pattern``, the host's mirror)
  is exactly the non-zeros of ``brownian_bridge_matrix(T)`` in float32 at
  T = 8, 16, 32 and 64, and ``sparse_walk`` refuses any other matrix or T.
* A torch replica of the kernel's order — a thread's consecutive points
  (``kQuad``, read from the source), the first one's word from its block's
  gray bits (the block holds 256 threads' points, aligned) and its own low
  bits, the next ones by one direction each, the row sums over the
  non-zeros only in ascending column, each multiply-add rounded once — is
  ``torch.equal`` to the plain twin ``walk_acc_plain`` (which takes every
  column, zeros included) at starts 0, 1, 3, 99 and 1021: the edges of a
  thread's points, of a block and of the range.

* Kernel #13's sparse instantiation (``qmc_bridge_sparse_kernel``) replayed
  the same way: a thread's points' Gray-stepped words for the flat
  dimensions the Sobol table covers, the padded ones from ``pad``, and for
  each factor in turn each row's sum over its non-zeros in ascending column,
  one rounding per multiply-add — ``torch.equal`` to the plain twin
  ``bridge_normals_plain`` at T = 8, 16, 32 and 64 with F = 1, 2 and 3 (T =
  32 with F = 3, and T = 64 with F = 2 or 3, padded) from the same starts;
  ``sparse_walk``, which the host reads before either kernel, sends every
  other T and any other matrix to the dense kernels.

The kernels themselves are held to the twins and to #13 plus the scan on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralmc_tpu_torch.ops import qmc, qmc_cuda, rng

SOURCE = Path(qmc_cuda.__file__).resolve().parent.parent / "csrc" / "qmc_paths.cu"
STEPS = (8, 16, 32, 64)
COUNT = 1500  # crosses a block boundary (512 or 1,024 points) from every start below
POINTS = int(re.search(r"constexpr int kQuad = (\d+);", SOURCE.read_text()).group(1))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: its many small tensor ops slow tenfold
    on torch's thread pool while the suite's other workers hold the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kernel_bridge_col():
    """``bridge_col(log_t, t, d)`` as the kernel source writes it."""
    body = SOURCE.read_text().split("constexpr int bridge_col(int log_t, int t, int d) {")[1]
    cond, zero, other = re.match(r"\s*return (.+?) \? (.+?) : (.+?);", body).groups()
    return lambda log_t, t, d: eval(  # noqa: S307 - the repository's own source
        zero if eval(cond, {}, dict(t=t, d=d, log_t=log_t)) else other, {},
        dict(t=t, d=d, log_t=log_t))


@pytest.mark.parametrize("steps", STEPS)
def test_compiled_pattern_is_the_bridge_matrix_zeros(steps: int) -> None:
    nonzero = torch.from_numpy(qmc.brownian_bridge_matrix(steps).astype(np.float32)) != 0
    col = _kernel_bridge_col()
    log = steps.bit_length() - 1
    compiled = torch.zeros_like(nonzero)
    for t in range(steps):
        cols = [col(log, t, d) for d in range(log + 1)]
        assert cols == sorted(set(cols))  # one column a level, ascending
        compiled[t, cols] = True
    assert torch.equal(compiled, nonzero)
    assert torch.equal(qmc_cuda.bridge_pattern(steps), nonzero)
    bridge = torch.from_numpy(qmc.brownian_bridge_matrix(steps).astype(np.float32))
    assert qmc_cuda.sparse_walk(bridge, steps)
    assert not qmc_cuda.sparse_walk(torch.eye(steps), steps)
    assert not qmc_cuda.sparse_walk(bridge + 1.0, steps)


def test_other_step_counts_take_the_dense_walk() -> None:
    for steps in (4, 7, 12, 15):
        bridge = torch.from_numpy(qmc.brownian_bridge_matrix(steps).astype(np.float32))
        assert not qmc_cuda.sparse_walk(bridge, steps)
    with pytest.raises(ValueError, match="2\\^m"):
        qmc_cuda.bridge_pattern(12)


def _quad_words(directions: torch.Tensor, shift: torch.Tensor, start: int,
                count: int) -> torch.Tensor:
    """``[C, d, count]`` words as the kernel makes them: a block of 256
    threads' points XORs its gray bits from log2(256·POINTS) up into c_hi, a
    thread its first point's lower bits, then one direction a point (bit
    ctz(n) of gray(n) ^ gray(n − 1))."""
    low = (256 * POINTS).bit_length() - 1
    n = (start + torch.arange(count, dtype=torch.int64)) & rng.MASK32
    n0 = n & ~(POINTS - 1)
    base = n0 & ~((1 << low) - 1)
    gray_hi = (base ^ (base >> 1)) & ~((1 << low) - 1)
    g = n0 ^ (n0 >> 1)
    v = directions.to(torch.int64)  # [d, 32]
    words = shift[:, :, None].expand(-1, -1, count).clone()
    for b in range(32):
        bits = ((gray_hi >> b) & 1) if b >= low else ((g >> b) & 1)
        words ^= v[None, :, b, None] * bits[None, None, :]
    step = n & (POINTS - 1)
    for i in range(1, POINTS):
        ctz = (i & -i).bit_length() - 1
        words ^= v[None, :, ctz, None] * (step >= i)[None, None, :]
    return words


def _sparse_walk_replica(directions, shift, bridge, start, log_spot, drift, vol_sdt, *,
                         timesteps: int, count: int) -> torch.Tensor:
    z = qmc._inv_cdf(_quad_words(directions, shift, start, count))  # [C, T, count]
    pattern = qmc_cuda.bridge_pattern(timesteps)
    logx = torch.zeros_like(z[:, 0]) + log_spot[:, None]
    acc = torch.zeros_like(logx)
    for t in range(timesteps):
        e = torch.zeros_like(logx)
        for col in torch.nonzero(pattern[t]).flatten().tolist():  # ascending
            e = rng.fma32_exact(bridge[t, col].double(), z[:, col].double(), e)
        logx = (logx + drift[:, None]) + vol_sdt[:, None] * e
        acc = acc + logx
    return acc


@pytest.mark.parametrize("start", [0, 1, 3, 99, 1021])
@pytest.mark.parametrize("steps", STEPS)
def test_sparse_quad_walk_equals_the_twin(steps: int, start: int) -> None:
    keys = rng.fold_in(rng.prng_key(12), torch.arange(2))
    _, directions, shift, _ = qmc._draw_tables(keys, steps, 1, 5)
    assert torch.equal(_quad_words(directions, shift, start, COUNT),
                       qmc_cuda.sobol_words(directions, shift, start, COUNT))
    bridge = torch.as_tensor(qmc.brownian_bridge_matrix(steps), dtype=torch.float32)
    scalars = (torch.log(torch.tensor([100.0, 90.0])), torch.tensor([0.0011, -0.0004]),
               torch.tensor([0.06, 0.09]))
    got = _sparse_walk_replica(directions, shift, bridge, start, *scalars, timesteps=steps,
                               count=COUNT)
    want = qmc_cuda.walk_acc_plain(directions, shift, bridge, start, *scalars,
                                   timesteps=steps, count=COUNT)
    assert torch.equal(got, want)


@pytest.mark.parametrize("steps", STEPS)
def test_bridge_instantiation_follows_the_matrix(steps: int) -> None:
    """#13 and #14 take their sparse instantiations exactly where the
    matrix's zeros are the compiled pattern: the bridge of T steps, not a
    matrix with one more or one fewer non-zero, nor another T's bridge cut
    to size."""
    bridge = torch.from_numpy(qmc.brownian_bridge_matrix(steps).astype(np.float32))
    assert qmc_cuda.sparse_walk(bridge, steps)
    filled = bridge.clone()
    filled[0, steps - 1] = 1e-30  # a zero of the pattern made non-zero
    emptied = bridge.clone()
    emptied[steps - 1, 1] = 0.0  # a non-zero of the pattern made zero
    wider = torch.from_numpy(qmc.brownian_bridge_matrix(2 * steps).astype(np.float32))
    for other in (filled, emptied, wider[:steps, :steps], torch.eye(steps)):
        assert not qmc_cuda.sparse_walk(other, steps)


def _sparse_bridge_replica(directions, shift, bridge, start, *, timesteps: int, factors: int,
                           count: int, pad: torch.Tensor | None) -> torch.Tensor:
    """``[C, T, F, count]`` as ``qmc_bridge_sparse_kernel`` computes it."""
    sdims = directions.shape[0]
    z_sobol = qmc._inv_cdf(_quad_words(directions, shift, start, count))  # [C, sdims, count]
    pattern = qmc_cuda.bridge_pattern(timesteps)
    last_row = {col: max(t for t in range(timesteps) if pattern[t, col])
                for col in range(timesteps)}
    out = torch.empty((shift.shape[0], timesteps, factors, count), dtype=torch.float32)
    for f in range(factors):
        live: dict[int, torch.Tensor] = {}  # a column's normals, from entry to last row
        for t in range(timesteps):
            cols = torch.nonzero(pattern[t]).flatten().tolist()  # ascending
            for col in cols:
                k = col * factors + f
                if col not in live:
                    live[col] = z_sobol[:, k] if k < sdims else pad[:, k - sdims]
            e = torch.zeros((shift.shape[0], count), dtype=torch.float32)
            for col in cols:
                e = rng.fma32_exact(bridge[t, col].double(), live[col].double(), e)
            out[:, t, f] = e
            for col in cols:
                if last_row[col] == t:
                    del live[col]
        assert not live
    return out


@pytest.mark.parametrize("start", [0, 1, 3, 99, 1021])
@pytest.mark.parametrize("factors", [1, 2, 3])
@pytest.mark.parametrize("steps", STEPS)
def test_sparse_bridge_equals_the_twin(steps: int, factors: int, start: int) -> None:
    keys = rng.fold_in(rng.prng_key(14), torch.arange(2))
    sdims, directions, shift, _ = qmc._draw_tables(keys, steps, factors, 5)
    flat = steps * factors
    pad = None
    if sdims < flat:
        pad = torch.from_numpy(np.random.default_rng(steps * factors + start).standard_normal(
            (2, flat - sdims, COUNT)).astype(np.float32))
    bridge = torch.as_tensor(qmc.brownian_bridge_matrix(steps), dtype=torch.float32)
    assert qmc_cuda.sparse_walk(bridge, steps)
    kw = dict(timesteps=steps, factors=factors, count=COUNT, pad=pad)
    got = _sparse_bridge_replica(directions, shift, bridge, start, **kw)
    want = qmc_cuda.bridge_normals_plain(directions, shift, bridge, start, **kw)
    assert torch.equal(got, want)
