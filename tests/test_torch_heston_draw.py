"""The Heston streams' fixed roundings, on the CPU.

The Heston kernels (``csrc/heston_step.cuh``) and their plain twins
(``ops/dynamics_cuda.py``) take every rounding of the draw and the step in
the same place, so that both carry the same variance bit for bit. These
tests hold what that rests on:

* ``rng.fma32_exact`` rounds ``a·b + c`` once, as ``__fmaf_rn`` does, also
  where the float64 sum lands on a float32 tie (there ``rng.fma32`` rounds
  twice and misses by an ulp) and below float32's normal range, against
  exact rational arithmetic;
* the twin's ``ln_pinned`` and ``sincos_2pi_pinned`` stay within 1.2 ulp of
  float64 over every value the stream can draw (all 2^24 of u1 and of u2),
  give exact zeros where the function is zero, and use the header's
  constants.

The kernels are held to the twins bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralmc_tpu_torch.ops import dynamics_cuda, rng

HEADER = Path(dynamics_cuda.__file__).resolve().parent.parent / "csrc" / "heston_step.cuh"
ULP_CAP = 1.2


def _round_f32(x: Fraction) -> float:
    """The float32 nearest ``x``, ties to even, by exact comparison."""
    near = np.float32(float(x))
    candidates = [np.nextafter(near, np.float32(-np.inf)), near,
                  np.nextafter(near, np.float32(np.inf))]
    return float(min(candidates, key=lambda c: (abs(Fraction(float(c)) - x),
                                                int(np.array(c).view(np.int32)) & 1)))


def _near_tie_cases() -> tuple[np.ndarray, ...]:
    """``a·b + c`` just below a float32 midpoint whose even neighbour is
    above: ``a·b = 2^-24·(1 − k²·2^-46)`` with ``c`` odd in ``[1, 2)``, so the
    float64 sum rounds onto the midpoint itself and a second rounding goes
    up, one ulp past the once-rounded result; both signs."""
    k = np.arange(1, 257, dtype=np.float64)
    a = (2.0**-12 * (1.0 + k * 2.0**-23)).astype(np.float32)
    b = (2.0**-12 * (1.0 - k * 2.0**-23)).astype(np.float32)
    c = (1.0 + (2.0 * k + 1.0) * 2.0**-23).astype(np.float32)
    return (np.concatenate([a, -a]), np.concatenate([b, b]), np.concatenate([c, -c]))


def test_fma32_exact_rounds_once_where_fma32_rounds_twice() -> None:
    a, b, c = _near_tie_cases()
    got = rng.fma32_exact(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert got.dtype == torch.float32 and got.tolist() == want
    assert got.tolist() == (torch.from_numpy(c)).tolist()  # below the midpoint: c itself
    twice = rng.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert bool((twice != got).all())  # the double rounding fma32 admits


def test_fma32_exact_matches_exact_arithmetic_on_random_operands() -> None:
    gen = np.random.default_rng(5)
    n = 4000
    a = (gen.standard_normal(n) * 2.0 ** gen.integers(-30, 30, n)).astype(np.float32)
    b = (gen.standard_normal(n) * 2.0 ** gen.integers(-30, 30, n)).astype(np.float32)
    c = (gen.standard_normal(n) * 2.0 ** gen.integers(-60, 60, n)).astype(np.float32)
    c[::4] = -(a[::4].astype(np.float64) * b[::4]).astype(np.float32)  # near-cancellation
    a[1::4] *= np.float32(2.0**-50)  # results below float32's normal range
    b[1::4] *= np.float32(2.0**-50)
    c[1::4] = (gen.standard_normal(n // 4) * 2.0**-140).astype(np.float32)
    got = rng.fma32_exact(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert got.tolist() == want


def test_fma32_exact_keeps_the_sign_of_an_exact_zero() -> None:
    """An exact zero sum is the FMA's zero: −0 only where both terms are
    −0 (a Merton step without a jump: 0·μ_J with μ_J < 0, plus (σ_J·0)·z)."""
    a = torch.tensor([0.0, 0.0, -0.0, 2.0, 0.0])
    b = torch.tensor([-1.5, 1.5, 1.5, 3.0, -2.0])
    c = torch.tensor([-0.0, -0.0, 0.0, -6.0, 0.0])
    got = rng.fma32_exact(a, b, c)
    assert got.tolist() == [0.0] * 5
    assert torch.signbit(got).tolist() == [True, False, False, False, False]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: beside the suite's other workers the
    exhaustive checks would otherwise take every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ulps(got: torch.Tensor, want: np.ndarray) -> float:
    """The largest error in float32 ulps of ``want``; exact zeros must be 0."""
    got64 = got.double().numpy()
    zero = want == 0
    assert bool((got64[zero] == 0).all())
    mag = np.abs(want[~zero]).astype(np.float32)
    ulp = (np.nextafter(mag, np.float32(np.inf)) - mag).astype(np.float64)
    return float((np.abs(got64[~zero] - want[~zero]) / ulp).max())


@pytest.mark.parametrize("part", range(4))
def test_ln_pinned_is_within_ulp_cap_over_every_u1(part: int) -> None:
    """Every u1 = uniform_open(w): ``b·2^-24 + 2^-25`` for the 24-bit ``b``,
    rounded once (1 − 2^-25 rounds up to 1, whose log is 0)."""
    m = torch.arange(part * 2**22, (part + 1) * 2**22, dtype=torch.int64)
    u1 = m.to(torch.float32) * 2.0**-24 + 2.0**-25
    assert _ulps(dynamics_cuda.ln_pinned(u1), np.log(u1.double().numpy())) <= ULP_CAP


@pytest.mark.parametrize("part", range(4))
def test_sincos_2pi_pinned_is_within_ulp_cap_over_every_u2(part: int) -> None:
    """Every u2 = m·2^-24, against float64 on the exact quarter-turn
    reduction (so cos 2πu2 is exactly 0 at u2 = ¼ and ¾ on both sides)."""
    m = torch.arange(part * 2**22, (part + 1) * 2**22, dtype=torch.int64)
    cs, sn = dynamics_cuda.sincos_2pi_pinned(m.to(torch.float32) * 2.0**-24)
    mm = m.numpy()
    q = (mm + (1 << 21)) >> 22
    r = (mm - (q << 22)) * 2.0**-22
    c, s = np.cos(math.pi / 2 * r), np.sin(math.pi / 2 * r)
    turn = q & 3
    want_c = np.select([turn == 0, turn == 1, turn == 2, turn == 3], [c, -s, -c, s])
    want_s = np.select([turn == 0, turn == 1, turn == 2, turn == 3], [s, c, -s, -c])
    assert _ulps(cs, want_c) <= ULP_CAP
    assert _ulps(sn, want_s) <= ULP_CAP


def test_twin_constants_are_the_headers() -> None:
    text = HEADER.read_text()

    def chain(function: str, first: str) -> list[float]:
        body = text.split(function)[1].split("}")[0]
        head = re.search(rf"float {first} = (-?[0-9.e-]+)f;", body).group(1)
        rest = re.findall(rf"{first} = __fmaf_rn\({first}, \w+, (-?[0-9.e-]+)f\);", body)
        return [float(head), *map(float, rest)]

    assert chain("float ln_pinned(float u1) {", "q") == list(dynamics_cuda.LN_Q)
    sincos = "void sincos_2pi_pinned(uint32_t b, float& cs, float& sn) {"
    assert chain(sincos, "ps") == list(dynamics_cuda.SIN_S)
    assert chain(sincos, "pc") == list(dynamics_cuda.COS_C)
    named = dict(re.findall(r"constexpr float (k\w+) = (-?[0-9.e-]+)f;", text))
    assert [float(named[k]) for k in ("kLn2Hi", "kLn2Lo", "kHalfPiHi", "kHalfPiLo")] == [
        dynamics_cuda.LN2_HI, dynamics_cuda.LN2_LO, dynamics_cuda.HALF_PI_HI,
        dynamics_cuda.HALF_PI_LO]


def test_box_muller_pinned_at_the_zero_words() -> None:
    """The JAX interpreter's zero bits (u1 = 2^-25, u2 = 0): r within an ulp
    of √(50·ln 2), cos exactly 1 and sin exactly 0."""
    u1 = torch.tensor([2.0**-25], dtype=torch.float32)
    rad, cs, sn = dynamics_cuda.box_muller_pinned(u1, torch.zeros(1))
    assert float(cs) == 1.0 and float(sn) == 0.0
    want = math.sqrt(50.0 * math.log(2.0))
    assert abs(float(rad) - want) <= float(np.spacing(np.float32(want)))
