"""Design variants of the port's kernels, measured on one NVIDIA GPU.

    python3 chip_variants.py [--only gbm|walk|bridge|merton|term|cliquet ...] [--parent DIR]

Each variant is this checkout's CUDA source with one change, built with nvcc
beside the package's own build (``build/variants/``) and launched through the
same C entry point as the kernel it varies:

* the flat GBM kernel's Box–Muller transform (``csrc/gbm_step.cuh``'s
  ``box_muller_gbm``): ``libm`` (logf, sqrtf, sincospif: the transform of
  the kernel before the gbm v2 stream), ``sfu`` (MUFU.LG2 below ½ and a
  polynomial above, MUFU.RSQ, MUFU.SIN and MUFU.COS: ``path_stream.cuh``'s
  ``box_muller_sfu``), ``sfu_log`` (that ln u1, the fixed-rounding angle),
  ``sfu_angle`` (the fixed-rounding ln u1, the SFU's angle) and ``gbm`` (the
  kernel's own: the fixed-rounding ln u1 and angle, the root on the SFU).
  Each is held to the plain twin: the existing card test's cases
  (``tests/test_torch_cuda.py::test_branch_kernel_matches_twin_on_card``, 3
  contracts x 64 x 96, 9 steps) under that test's gates, and the paths past
  rtol 2e-5 of the digital and up-and-out barrier at 32 contracts x 2048 x
  512 (33,554,432 paths, antithetic) at 9 and 16 steps under both schemes;
  then each branch group's time at the training chunk 256 x 2048 x 512 x 16
  (CUDA events, the variants in turn and then in reverse) and its SASS a
  path-step (``chip_smoke.py``'s rule).
* the sparse QMC walk's points a thread and register cap
  (``csrc/qmc_paths.cu``'s ``kQuad`` and ``kQuadMinBlocks``): each is the
  kernel's output bit for bit, then timed at 256 x 2048 x 512 points (T = 16)
  and its SASS a point counted and split (``chip_smoke.py``'s rule).
* the sparse QMC bridge's register cap (``kQuadMinBlocks``, which it shares
  with the sparse walk, at T = 16, the main path's, and at T = 64: 8, 6, 5
  or 4 and 2 resident blocks an SM, 32 to 128 registers a thread) beside
  the dense bridge the host would launch instead: each is the package's output bit
  for bit, then timed at 64 x 2048 x 512 points of 16 steps (the shape the
  main path launches it at, F = 1) or at 4 x 2048 x 512 points of 64 steps,
  with its registers and spills. Each launches into one output allocated
  beforehand; the package's wrapper is timed beside them (its own output
  allocated, which the deterministic policy fills with NaN).

* the Merton kernels' design (``csrc/merton_step.cuh``, built into
  ``csrc/dynamics_paths.cu`` for #9 and ``csrc/american_dynamics.cu`` for
  #10), one choice varied at a time: ``v2`` (the kernels' own: the walk of
  four steps on three whole Philox calls, each made just before the first
  step that reads it, the IEEE root of the Box–Muller radius, the first
  kCountFirst = 3 levels compared and the rest behind a branch),
  ``one_call`` (one Philox call a step, words 0–2), ``sfu_root`` (the
  radius's root on the SFU, ``path_stream.cuh::box_muller_root``), ``k2``,
  ``k4`` and ``k16`` (kCountFirst) and ``eager`` (the walk's three calls
  made before its four steps). With ``--parent DIR`` (a
  checkout of the parent commit, e.g. ``git archive`` unpacked under
  ``build/``) its two Merton kernels join as ``parent``, launched through
  their own C entry points (the ``[C, 16]`` level table). Each is held to
  the plain twin: #9 TERMINAL at 8 x 2048 x 512 x 16 and #10 at every = 1
  at 4 x 2048 x 512 x 16, antithetic, the paths past rtol 2e-5 counted
  (``one_call`` against the twin fed the words it reads), and the
  up-and-out barrier's and the digital's flips over 32 x 2048 x 512
  antithetic paths; then #9 TERMINAL and #10 at every = 1 timed at 64 and
  256 contracts x 2048 x 512 x 16 (launches only, into outputs and tables
  made beforehand; CUDA events, the variants in turn and then in reverse),
  beside their SASS a path-step (``chip_smoke.py``'s rule; the parent's
  by the rule its own smoke applied) and their share of the instruction
  cap.

* the curved-term kernel (#2, ``gbm_term_kernel`` in ``csrc/dynamics_paths.cu``,
  ``--only term``) and the cliquet kernel (#3, ``gbm_cliquet_kernel`` in
  ``csrc/gbm_paths.cu``, ``--only cliquet``), one choice varied at a time:
  ``v2`` (the kernels' own: whole-call walks, ``box_muller_pinned`` with
  its IEEE root, ``expf``), ``sfu_root`` (the radius's root on the SFU,
  ``path_stream.cuh::box_muller_root``), ``exp_sfu`` (the cliquet's period
  return and the term arithmetic Asian's price on ``ex2.approx``,
  ``gbm_step.cuh::exp_sfu``) and, for the cliquet, ``index64``
  (``path_setup`` without its 32-bit route: the row, column and counter in
  64-bit arithmetic at every shape, as before). With ``--parent DIR`` the parent's two kernels join as
  ``parent``, the term kernel fed its ``(R, φ)`` table. Each variant is held
  to the plain twin (the paths not bit-equal and those past rtol 2e-5):
  term TERMINAL and arithmetic Asian at 8 x 2048 x 512 x 16, the up-and-out
  barrier and the digital at 32, the cliquet at 32, antithetic; then every
  term branch and the cliquet timed at 64 and 256 contracts x 2048 x 512 x
  16 (launches only, into outputs and tables made beforehand; CUDA events,
  in turn and then in reverse) with the package's wrapper beside them,
  their SASS a path-step (``chip_smoke.py``'s rule) and cap share, and the
  cliquet's SASS a path by part (``chip_smoke.py``'s ``cliquet_sass_split``).

Prints one line per measurement and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from spectralmc_tpu_torch.ops import american_cuda, dynamics_cuda, gbm_cuda, qmc_cuda, rng
from spectralmc_tpu_torch.ops._build import CSRC, NVCC_FLAGS, find_nvcc
from spectralmc_tpu_torch.ops.gbm import BARRIER_PAYOFFS, LOOKBACK_PAYOFFS, PathScheme, PayoffKind

OUT = Path(__file__).resolve().parent / "build" / "variants"
TRANSFORM = {  # the body of box_muller_gbm(d, rad, cs, sn), returning x = −2·ln u1
    "libm": """  const float x = -2.0f * logf(uniform_open(d.x));
  rad = sqrtf(x);
  sincospif(2.0f * uniform_closed(d.y), &sn, &cs);
  return x;""",
    "sfu": """  const float x = minus_two_log(uniform_open(d.x));
  rad = box_muller_root(x);
  const float theta = box_muller_angle(d.y);
  cs = -cos_sfu(theta);
  sn = -sin_sfu(theta);
  return x;""",
    "sfu_log": """  const float x = minus_two_log(uniform_open(d.x));
  rad = box_muller_root(x);
  sincos_2pi_pinned(d.y, cs, sn);
  return x;""",
    "sfu_angle": """  const float x = __fmul_rn(-2.0f, ln_pinned(uniform_open(d.x)));
  rad = box_muller_root(x);
  const float theta = box_muller_angle(d.y);
  cs = -cos_sfu(theta);
  sn = -sin_sfu(theta);
  return x;""",
    "gbm": None,  # the kernel's own
}
WALK = {"q2_b8": (2, 8), "q4_b4": (4, 4), "q2_b4": (2, 4), "q4_b6": (4, 6)}  # kQuad, min blocks
BRIDGE = [(16, 8), (16, 6), (16, 5), (16, 4), (64, 8), (64, 6), (64, 4), (64, 2)]  # T, min blocks
BRIDGE_CONTRACTS = {16: 64, 64: 4}  # contracts a timed launch
SMALL_PAYOFFS = [("terminal", None), ("barrier_up_out", 1.25), ("barrier_down_out", 0.8),
                 ("lookback_fixed_call", None), ("lookback_fixed_put", None),
                 ("lookback_float_call", None), ("lookback_float_put", None),
                 ("variance_swap", None), ("asian_arithmetic", None), ("asian_geometric", None),
                 ("digital", None), ("forward_start", None)]


def build(name: str, source: str, edited: str, edit, csrc: Path = CSRC) -> tuple[Path, str]:
    """nvcc one variant: ``source`` from a copy of ``csrc`` (this checkout's
    csrc/ by default) whose file ``edited`` has ``edit(text)`` applied,
    built with the package's flags; ``(library, nvcc's log)``."""
    d = OUT / name / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    (d / edited).write_text(edit((d / edited).read_text()))
    lib = d.parent / f"lib{name}.so"
    done = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(d / source)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{(done.stdout + done.stderr)[-4000:]}")
    return lib, done.stdout + done.stderr


def build_all(only: set[str], parent: Path | None) -> dict[str, tuple[Path, str]]:
    """Every variant of the groups in ``only``, one nvcc each, all started
    together."""
    jobs = {}
    if "gbm" in only:
        jobs.update({f"gbm_{name}": ("gbm_paths.cu", "gbm_step.cuh", transform_edit(body))
                     for name, body in TRANSFORM.items()})
    if "walk" in only:
        jobs.update({f"walk_{name}": ("qmc_paths.cu", "qmc_paths.cu", walk_edit(*knobs))
                     for name, knobs in WALK.items()})
    if "bridge" in only:
        jobs.update({f"bridge_t{steps}_b{blocks}": ("qmc_paths.cu", "qmc_paths.cu",
                                                      walk_edit(2, blocks))
                     for steps, blocks in BRIDGE})
    if "merton" in only:
        for name, (edited, edit) in MERTON.items():
            for kernel, source in MERTON_SOURCES.items():
                jobs[f"merton_{name}_{kernel}"] = (source, edited, edit)
        if parent is not None:
            for kernel, source in MERTON_SOURCES.items():
                jobs[f"merton_parent_{kernel}"] = (source, source, lambda text: text,
                                                   parent / "spectralmc_tpu_torch" / "csrc")
    for kernel in ("term", "cliquet"):
        if kernel in only:
            source = TC_SOURCES[kernel]
            for name, (edited, edit) in TERM_CLIQUET[kernel].items():
                jobs[f"{kernel}_{name}"] = (source, edited, edit)
            if parent is not None:
                jobs[f"{kernel}_parent"] = (source, source, lambda text: text,
                                            parent / "spectralmc_tpu_torch" / "csrc")
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(build, name, *job) for name, job in jobs.items()}
        return {name: future.result() for name, future in futures.items()}


def transform_edit(body: str | None):
    def edit(text: str) -> str:
        if body is None:
            return text
        head = "float box_muller_gbm(uint2 d, float& rad, float& cs, float& sn) {\n"
        start = text.index(head) + len(head)
        return text[:start] + body + text[text.index("\n}", start):]
    return edit


def walk_edit(points: int, blocks: int):
    def edit(text: str) -> str:
        text = re.sub(r"constexpr int kQuad = \d+;", f"constexpr int kQuad = {points};", text)
        return re.sub(r"constexpr int kQuadMinBlocks = \d+;",
                      f"constexpr int kQuadMinBlocks = {blocks};", text)
    return edit


def body_edit(head: str, body: str):
    """Replace the body of the function whose first line is ``head``."""
    def edit(text: str) -> str:
        start = text.index(head) + len(head)
        return text[:start] + body + text[text.index("\n}", start):]
    return edit


MERTON_SOURCES = {"paths": "dynamics_paths.cu", "american": "american_dynamics.cu"}
MERTON_WALK = "void walk_triples(const PathStream& s, int steps, Step&& step) {\n"
MERTON = {  # variant -> (the csrc/ file it edits, its edit)
    "v2": ("merton_step.cuh", lambda text: text),
    "one_call": ("path_stream.cuh", body_edit(MERTON_WALK, """  for (int t = 0; t < steps; ++t) {
    const uint4 w = s.call(t);
    step(t, make_uint2(w.x, w.y), w.z);
  }""")),
    "sfu_root": ("merton_step.cuh", lambda text: text.replace(
        "  box_muller_pinned(d, rad, cs, sn);\n",
        "  rad = box_muller_root(__fmul_rn(-2.0f, ln_pinned(uniform_open(d.x))));\n"
        "  sincos_2pi_pinned(d.y, cs, sn);\n")),
    **{f"k{k}": ("merton_step.cuh", (lambda k: lambda text: re.sub(
        r"constexpr int kCountFirst = \d+;", f"constexpr int kCountFirst = {k};", text))(k))
       for k in (2, 4, 16)},
    # the walk's three calls made first, then its four steps (the packed
    # layout; steps of a whole pass only, so T must be a multiple of 4)
    "eager": ("path_stream.cuh", body_edit(MERTON_WALK, """  for (int t = 0; t < steps; t += 4) {
    const int first = t / 4 * 3;
    const uint4 a = s.call(first), b = s.call(first + 1), c = s.call(first + 2);
    step(t, make_uint2(a.x, a.y), a.z);
    step(t + 1, make_uint2(a.w, b.x), b.y);
    step(t + 2, make_uint2(b.z, b.w), c.x);
    step(t + 3, make_uint2(c.y, c.z), c.w);
  }""")),
}
MERTON_CONTRACTS = (64, 256)  # the batch-64 steps that launch them, the training chunk


TC_SOURCES = {"term": "dynamics_paths.cu", "cliquet": "gbm_paths.cu"}
SFU_ROOT = ("heston_step.cuh", lambda text: text.replace(
    "  rad = __fsqrt_rn(__fmul_rn(-2.0f, ln_pinned(uniform_open(d.x))));\n",
    "  rad = box_muller_root(__fmul_rn(-2.0f, ln_pinned(uniform_open(d.x))));\n"))
INDEX64 = ("path_stream.cuh", lambda text: text.replace(
    "  const bool narrow = (row_offset + rows) * cols < (int64_t{1} << 31)"
    " && half < (int64_t{1} << 31);\n",
    "  const bool narrow = false;  // the 64-bit route only\n"))
TERM_CLIQUET = {  # kernel -> variant -> (the csrc/ file it edits, its edit)
    "term": {
        "v2": ("dynamics_paths.cu", lambda text: text),
        "sfu_root": SFU_ROOT,
        "exp_sfu": ("dynamics_paths.cu", lambda text: text.replace(
            "return acc + (variant ? logx : expf(logx));",
            "return acc + (variant ? logx : exp_sfu(logx));")),
    },
    "cliquet": {
        "v2": ("gbm_paths.cu", lambda text: text),
        "sfu_root": SFU_ROOT,
        "exp_sfu": ("gbm_paths.cu", lambda text: text.replace(
            "__fsub_rn(expf(__fmaf_rn(period_vol, z, period_drift)), 1.0f)",
            "__fsub_rn(exp_sfu(__fmaf_rn(period_vol, z, period_drift)), 1.0f)")),
        "index64": INDEX64,
    },
}
TC_CONTRACTS = (64, 256)  # the batch-64 steps that launch them, the training chunk


def check_edits() -> None:
    """Each variant's edit changes its file (a stale pattern would time the
    kernel itself under a variant's name)."""
    for kernel, variants in TERM_CLIQUET.items():
        for name, (edited, edit) in variants.items():
            text = (CSRC / edited).read_text()
            if name != "v2" and edit(text) == text:
                raise AssertionError(f"variant {kernel}/{name} does not apply to {edited}")


def load_term(path: Path, parent: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.gbm_term_launch.argtypes = [vp, vp, vp, *([vp] if parent else []), vp, i, ll, ll, i, i,
                                    i, f, ll, ll, vp]
    lib.gbm_term_launch.restype = ctypes.c_int
    return lib


def load_cliquet(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.gbm_cliquet_launch.argtypes = [vp, vp, vp, i, ll, ll, i, i, f, f, ll, ll, vp]
    lib.gbm_cliquet_launch.restype = ctypes.c_int
    return lib


def parent_pair_table(step: torch.Tensor) -> torch.Tensor:
    """The parent term kernel's second table, ``(R, φ)`` of each pair of
    steps (``R = √(v_a² + v_b²)``, ``φ = atan2(v_a, v_b)/2π``), from the
    step table as the parent's wrapper computed it."""
    pairs = step.shape[1] // 2
    va, vb = step[:, 0:2 * pairs:2, 1], step[:, 1:2 * pairs:2, 1]
    phi = torch.atan2(va, vb) * torch.tensor(1.0 / (2.0 * math.pi), dtype=torch.float32)
    return torch.stack([torch.sqrt(va * va + vb * vb), phi], dim=2).contiguous()


class TermCliquetLaunch:
    """One launch of a variant's #2 (a payoff's branch) or #3 (the cliquet),
    its inputs made beforehand: ``()`` launches into the same output."""

    def __init__(self, lib: ctypes.CDLL, parent: bool, params: torch.Tensor,
                 keys: torch.Tensor, payoff: PayoffKind, half: int | None = None,
                 out: torch.Tensor | None = None, steps: int = cs.STEPS, **knobs: object):
        self.lib, self.parent, self.payoff = lib, parent, payoff
        self.half, self.steps = half, steps
        self.knobs = knobs
        self.p, self.words, fresh = gbm_cuda._device_args(params, keys, steps, cs.ROWS, cs.COLS)
        self.out = fresh if out is None else out
        if payoff != PayoffKind.CLIQUET:
            self.step = dynamics_cuda.term_coeff_tables(self.p, cs.term_of(steps).shapes(steps),
                                                        steps)
            self.pair = parent_pair_table(self.step) if parent else None

    def __call__(self) -> torch.Tensor:
        c, stream = self.p.shape[0], torch.cuda.current_stream().cuda_stream
        if self.payoff == PayoffKind.CLIQUET:
            status = self.lib.gbm_cliquet_launch(
                self.p.data_ptr(), self.words.data_ptr(), self.out.data_ptr(), c, cs.ROWS,
                cs.COLS, self.steps, cs.CLIQUET["reset_every"], cs.CLIQUET["floor"],
                cs.CLIQUET["cap"], self.half or 0, 0, stream)
        else:
            branch = gbm_cuda.branch_of(self.payoff)
            barrier_rel = self.knobs.get("barrier_rel")
            status = self.lib.gbm_term_launch(
                self.p.data_ptr(), self.words.data_ptr(), self.step.data_ptr(),
                *([self.pair.data_ptr()] if self.parent else []), self.out.data_ptr(), c,
                cs.ROWS, cs.COLS, self.steps, gbm_cuda._FAMILY_CODE[branch],
                dynamics_cuda._variant(branch, self.payoff),
                1.0 if barrier_rel is None else barrier_rel, self.half or 0, 0, stream)
        if status:
            raise RuntimeError(f"term/cliquet variant launch failed: cudaError {status}")
        return gbm_cuda._route_out(self.payoff, self.out, self.p)


def tc_twin(params: torch.Tensor, keys: torch.Tensor, payoff: PayoffKind, half: int | None,
            **knobs: object) -> torch.Tensor:
    """The package's plain twin of #2 or #3 on the card."""
    kw = dict(timesteps=cs.STEPS, rows=cs.ROWS, cols=cs.COLS, antithetic_half=half)
    if payoff == PayoffKind.CLIQUET:
        return gbm_cuda.simulate_cliquet_rows_cuda_plain(params, keys, **kw, **cs.CLIQUET)
    return dynamics_cuda.simulate_term_rows_cuda_plain(
        params, keys, term=cs.term_of(cs.STEPS), payoff=payoff, **kw, **knobs)


def tc_wrapper(params: torch.Tensor, keys: torch.Tensor, payoff: PayoffKind,
               **knobs: object) -> torch.Tensor:
    """The package's wrapper of #2 or #3: the main path's call."""
    kw = dict(timesteps=cs.STEPS, rows=cs.ROWS, cols=cs.COLS)
    if payoff == PayoffKind.CLIQUET:
        return gbm_cuda.simulate_cliquet_rows_cuda(params, keys, **kw, **cs.CLIQUET)
    return dynamics_cuda.simulate_term_rows_cuda(params, keys, term=cs.term_of(cs.STEPS),
                                                 payoff=payoff, **kw, **knobs)


def tc_sass(kernel: str, library: Path) -> dict[str, float]:
    """A variant's SASS a path-step by ``chip_smoke.py``'s rule, per group."""
    text = cs.cuobjdump_sass(library)
    counts, _ = (cs.term_sass_count(text) if kernel == "term" else cs.cliquet_sass_count(text))
    return counts


TC_TIMED = {  # kernel -> (group, payoff, knobs) timed
    "term": [(f"term_{g}", *cs.TIMED_PAYOFF[g]) for g in gbm_cuda.FLAT_BRANCHES],
    "cliquet": [("cliquet", PayoffKind.CLIQUET, {})],
}
TC_CHECKS = {  # kernel -> (case, contracts, payoff, knobs) held to the twin
    "term": [("terminal", 8, PayoffKind.TERMINAL, {}),
             ("asian_arithmetic", 8, PayoffKind.ASIAN_ARITHMETIC, {}),
             ("barrier_up_out", 32, PayoffKind.BARRIER_UP_OUT, dict(barrier_rel=1.25)),
             ("digital", 32, PayoffKind.DIGITAL, {})],
    "cliquet": [("cliquet", 32, PayoffKind.CLIQUET, {})],
}


def term_cliquet_variants(kernel: str, device: torch.device, max_sm_hz: float,
                          built: dict[str, tuple[Path, str]]) -> None:
    names = [n for n in [*TERM_CLIQUET[kernel], "parent"] if f"{kernel}_{n}" in built]
    libs = {n: (load_cliquet(built[f"{kernel}_{n}"][0]) if kernel == "cliquet"
                else load_term(built[f"{kernel}_{n}"][0], n == "parent")) for n in names}
    piece = "gbm_term_kernel<0>" if kernel == "term" else "gbm_cliquet_kernel"
    for name in names:
        cs.phase(f"variant-{kernel}-build", variant=name,
                 registers=cs.ptxas_summary(built[f"{kernel}_{name}"][1]).get(piece, "?"))
    half = cs.ROWS // 2
    for case, contracts, payoff, knobs in TC_CHECKS[kernel]:
        unequal, past = {}, {}
        every_params, every_keys = cs.kernel_inputs(device, contracts, 300 + contracts)
        for chunk in range(0, contracts, 8):  # the twin eight contracts at a time
            params, keys = every_params[chunk:chunk + 8], every_keys[chunk:chunk + 8]
            want = tc_twin(params, keys, payoff, half, **knobs)
            for name in [n for n in names if n != "parent"]:
                got = TermCliquetLaunch(libs[name], False, params, keys, payoff, half,
                                        **knobs)()
                scale = torch.clamp(want.abs(), min=cs.CLIQUET["cap"]) \
                    if payoff == PayoffKind.CLIQUET else want.abs()
                unequal[name] = unequal.get(name, 0) + int((got != want).sum())
                past[name] = past.get(name, 0) + int(((got - want).abs() > 2e-5 * scale).sum())
                del got
            del want
            torch.cuda.empty_cache()
        cs.phase(f"variant-{kernel}-twin", case=case, steps=cs.STEPS, antithetic=True,
                 paths=contracts * cs.ROWS * cs.COLS, not_bit_equal=unequal, past_rtol=past,
                 rtol=2e-5)
    sass = {n: tc_sass(kernel, built[f"{kernel}_{n}"][0]) for n in names}
    if kernel == "cliquet":
        for name in names:
            library = built[f"{kernel}_{name}"][0]
            try:
                split = cs.cliquet_sass_split(cs.cuobjdump_sass(library),
                                              cs.nvdisasm_text(library))
            except (AssertionError, OSError, StopIteration, ValueError,
                    subprocess.CalledProcessError) as err:
                split = {"error": repr(err)[:300]}
            cs.phase("variant-cliquet-sass-split", variant=name, parts="per path",
                     timesteps=cs.STEPS, **split)
    path_steps_per_contract = cs.ROWS * cs.COLS * cs.STEPS
    for group, payoff, knobs in TC_TIMED[kernel]:
        for contracts in TC_CONTRACTS:
            params, keys = cs.kernel_inputs(device, contracts, 1)
            first = TermCliquetLaunch(libs[names[0]], names[0] == "parent", params, keys,
                                      payoff, **knobs)
            launches = {n: TermCliquetLaunch(libs[n], n == "parent", params, keys, payoff,
                                             out=first.out, **knobs) for n in names}
            times = {n: [] for n in names}
            for name in names + names[::-1]:
                times[name].append(cs.cuda_ms(launches[name]))
            wrapper = cs.cuda_ms(lambda: tc_wrapper(params, keys, payoff, **knobs))
            # the wrapper's parts beside the launch: its checked arguments and
            # output (gbm_cuda._device_args) and, for #2, the step table
            args = cs.cuda_ms(lambda: gbm_cuda._device_args(params, keys, cs.STEPS, cs.ROWS,
                                                            cs.COLS))
            split = dict(args_ms=f"{args:.3f}")
            if payoff != PayoffKind.CLIQUET:
                shapes = cs.term_of(cs.STEPS).shapes(cs.STEPS)
                table = cs.cuda_ms(lambda: dynamics_cuda.term_coeff_tables(params, shapes,
                                                                           cs.STEPS))
                split["table_ms"] = f"{table:.3f}"
            del launches, first
            torch.cuda.empty_cache()
            bound, bound_by = cs.bound_ms(group, contracts, cs.STEPS)
            rate = {n: contracts * path_steps_per_contract / (min(times[n]) / 1e3)
                    for n in names}
            cs.phase(f"variant-{kernel}-time", group=group,
                     shape=f"{contracts}x{cs.ROWS}x{cs.COLS}x{cs.STEPS}",
                     bound_ms=f"{bound:.3f}", bound_by=bound_by, wrapper_ms=f"{wrapper:.3f}",
                     **split,
                     **{f"{n}_ms": "/".join(f"{x:.3f}" for x in times[n]) for n in names},
                     **{f"{n}_sass": round(sass[n].get(group, float("nan")), 2) for n in names},
                     **{f"{n}_cap_share":
                        f"{rate[n] / (cs.LANES_PER_CLOCK * max_sm_hz / sass[n][group]):.4f}"
                        for n in names if group in sass[n]})


def load_gbm(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.gbm_paths_launch.argtypes = [vp, vp, vp, i, ll, ll, i, i, i, i, f, ll, ll, vp]
    lib.gbm_paths_launch.restype = ctypes.c_int
    return lib


def run_gbm(lib: ctypes.CDLL, params: torch.Tensor, keys: torch.Tensor, *, timesteps: int,
            rows: int, cols: int, scheme: PathScheme, payoff: PayoffKind, barrier_rel=None,
            forward_start_step=None, antithetic_half=None) -> torch.Tensor:
    """``gbm_cuda.simulate_underlier_rows_cuda`` through another library."""
    p, steps = gbm_cuda._route_in(payoff, params, timesteps, forward_start_step)
    p, words, out = gbm_cuda._device_args(p, keys, steps, rows, cols)
    branch = gbm_cuda.branch_of(payoff)
    variant = (int(payoff == PayoffKind.BARRIER_UP_OUT) if branch == "barrier"
               else gbm_cuda._LOOKBACK_VARIANT[payoff] if branch == "lookback"
               else int(payoff == PayoffKind.ASIAN_GEOMETRIC))
    status = lib.gbm_paths_launch(
        p.data_ptr(), words.data_ptr(), out.data_ptr(), p.shape[0], rows, cols, steps,
        gbm_cuda._SCHEME_CODE[scheme], gbm_cuda._FAMILY_CODE[branch], variant,
        1.0 if barrier_rel is None else barrier_rel, antithetic_half or 0, 0,
        torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"gbm_paths_launch failed: cudaError {status}")
    return gbm_cuda._route_out(payoff, out, p)


def card_test_misses(lib: ctypes.CDLL, device: torch.device) -> int:
    """The cases of test_branch_kernel_matches_twin_on_card (and TERMINAL)
    that would fail under that test's gates."""
    gen = np.random.default_rng(7)
    lo = np.array([80.0, 80.0, 0.25, 0.0, 0.0, 0.15])
    hi = np.array([120.0, 120.0, 2.0, 0.08, 0.04, 0.45])
    c = torch.from_numpy((lo + (hi - lo) * gen.random((3, 6))).astype(np.float32)).to(device)
    keys = rng.fold_in(rng.prng_key(7), torch.arange(3)).to(device)
    failed = 0
    for scheme in (PathScheme.LOG_EULER, PathScheme.EULER):
        for name, barrier_rel in SMALL_PAYOFFS:
            payoff = PayoffKind(name)
            kw = dict(timesteps=9, rows=64, cols=96, scheme=scheme, payoff=payoff,
                      barrier_rel=barrier_rel, antithetic_half=32,
                      forward_start_step=4 if payoff == PayoffKind.FORWARD_START else None)
            got = run_gbm(lib, c, keys, **kw)
            want = gbm_cuda.simulate_underlier_rows_cuda_plain(c, keys, **kw)
            scale = want.abs()
            if payoff in LOOKBACK_PAYOFFS:
                scale = torch.maximum(scale, c[:, 1, None, None])
            far = int(((got - want).abs() > 2e-5 * scale).sum())
            jumps = payoff in BARRIER_PAYOFFS or payoff == PayoffKind.DIGITAL
            failed += far > (int(1e-5 * got.numel()) if jumps else 0)
    return failed


def gbm_variants(device: torch.device, max_sm_hz: float,
                 built: dict[str, tuple[Path, str]]) -> None:
    libs = {name: load_gbm(built[f"gbm_{name}"][0]) for name in TRANSFORM}
    for name, lib in libs.items():
        cs.phase("variant-gbm-card-test", transform=name,
                 failing_cases=card_test_misses(lib, device), cases=2 * len(SMALL_PAYOFFS))
    for steps in (9, 16):
        for scheme in (PathScheme.LOG_EULER, PathScheme.EULER):
            for name, barrier_rel in (("digital", None), ("barrier_up_out", 1.25)):
                params, keys = cs.kernel_inputs(device, 32, 100 + steps)
                kw = dict(timesteps=steps, rows=cs.ROWS, cols=cs.COLS, scheme=scheme,
                          payoff=PayoffKind(name), barrier_rel=barrier_rel,
                          antithetic_half=cs.ROWS // 2)
                want = gbm_cuda.simulate_underlier_rows_cuda_plain(params, keys, **kw)
                past = {}
                for transform, lib in libs.items():
                    got = run_gbm(lib, params, keys, **kw)
                    past[transform] = int(((got - want).abs() > 2e-5 * want.abs()).sum())
                    del got
                cs.phase("variant-gbm-flips", payoff=name, scheme=scheme.value, steps=steps,
                         paths=want.numel(), **past)
                del want
                torch.cuda.empty_cache()
    params, keys = cs.kernel_inputs(device, cs.CHUNK, 1)
    for group, piece in cs.FLAT_WALKS.items():
        payoff, extra = cs.TIMED_PAYOFF[group]
        kw = dict(timesteps=cs.STEPS, rows=cs.ROWS, cols=cs.COLS, scheme=PathScheme.LOG_EULER,
                  payoff=payoff, **extra)
        order = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cs.cuda_ms(lambda: run_gbm(libs[name], params, keys, **kw)))
        sass = {}
        for name in libs:
            counts, _ = cs.parse_instruction_counts(
                cs.cuobjdump_sass(built[f"gbm_{name}"][0]), {piece: group}, {},
                pick_loop=cs.walk_or_longest, single_step=lambda g: False,
                draws_per_step=cs.FLAT_DRAWS_PER_STEP)
            sass[name] = counts[group]
        path_steps = cs.CHUNK * cs.ROWS * cs.COLS * cs.STEPS
        cap = {n: cs.LANES_PER_CLOCK * max_sm_hz / sass[n] for n in libs}
        cs.phase("variant-gbm-time", branch=group,
                 shape=f"{cs.CHUNK}x{cs.ROWS}x{cs.COLS}x{cs.STEPS}",
                 **{f"{n}_ms": "/".join(f"{t:.3f}" for t in times[n]) for n in libs},
                 **{f"{n}_sass": round(sass[n], 2) for n in libs},
                 **{f"{n}_cap_share": f"{path_steps / (min(times[n]) / 1e3) / cap[n]:.4f}"
                    for n in libs})


def walk_variants(device: torch.device, max_sm_hz: float,
                  built: dict[str, tuple[Path, str]]) -> None:
    ll, i, vp, u = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint
    libs = {}
    for name in WALK:
        lib = ctypes.CDLL(str(built[f"walk_{name}"][0]))
        lib.qmc_walk_launch.argtypes = [vp, vp, vp, vp, vp, i, i, ll, u, i, vp]
        lib.qmc_walk_launch.restype = ctypes.c_int
        libs[name] = lib
    kw = cs.qmc_inputs(device, cs.QMC_CONTRACTS, cs.STEPS, 1, 0)
    rep = cs.CHUNK // cs.QMC_CONTRACTS
    table = qmc_cuda._words32(kw["directions"])
    shift = qmc_cuda._words32(kw["shift"].repeat(rep, 1))
    scalars = torch.stack([x.repeat(rep) for x in cs.walk_scalars(device, cs.QMC_CONTRACTS)],
                          1).contiguous()
    bridge = kw["bridge"].contiguous()
    count = cs.ROWS * cs.COLS
    out = torch.empty((shift.shape[0], count), device=device)

    def launch(name: str) -> None:
        status = libs[name].qmc_walk_launch(
            table.data_ptr(), shift.data_ptr(), bridge.data_ptr(), scalars.data_ptr(),
            out.data_ptr(), shift.shape[0], cs.STEPS, count, 0, 1,
            torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"qmc_walk_launch failed: cudaError {status}")

    want = qmc_cuda.walk_acc(kw["directions"], kw["shift"].repeat(rep, 1), bridge.cpu(), 0,
                             *scalars.unbind(1), timesteps=cs.STEPS, count=count)
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        launch(name)
        if not torch.equal(out, want):
            raise AssertionError(f"walk variant {name} is not the kernel's output")
        times[name].append(cs.cuda_ms(lambda: launch(name), iters=5))
    for name, (points, blocks) in WALK.items():
        library, log = built[f"walk_{name}"]
        regs = cs.ptxas_summary(log).get("qmc_walk_sparse_kernel<16>", "?")
        split = cs.qmc_walk_sass(library, source=OUT / f"walk_{name}" / "csrc" / "qmc_paths.cu")
        cap = cs.LANES_PER_CLOCK * max_sm_hz / split["total"]
        cs.phase("variant-walk", variant=name, points_per_thread=points, min_blocks=blocks,
                 registers=repr(regs), bit_equal=True,
                 ms="/".join(f"{t:.3f}" for t in times[name]), sass_per_point=split["total"],
                 split={k: split[k] for k in cs.QMC_PARTS}, bridge_ffma=split["bridge_ffma"],
                 share_of_instruction_cap=f"{count * cs.CHUNK / min(times[name]) * 1e3 / cap:.4f}")


def bridge_variants(device: torch.device, built: dict[str, tuple[Path, str]]) -> None:
    ll, i, vp, u = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint
    count = cs.ROWS * cs.COLS
    for steps, contracts in BRIDGE_CONTRACTS.items():
        libs = {}
        for t, blocks in BRIDGE:
            if t == steps:
                lib = ctypes.CDLL(str(built[f"bridge_t{t}_b{blocks}"][0]))
                lib.qmc_bridge_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, ll, u, i, vp]
                lib.qmc_bridge_launch.restype = ctypes.c_int
                libs[f"b{blocks}"] = lib
        kw = cs.qmc_inputs(device, contracts, steps, 1, 0)
        table, shift = qmc_cuda._words32(kw["directions"]), qmc_cuda._words32(kw["shift"])
        bridge = kw["bridge"].contiguous()
        out = torch.empty((contracts, steps, 1, count), device=device)

        def launch(name: str) -> None:  # "dense": the dense kernel, from the first library
            lib = libs[next(iter(libs))] if name == "dense" else libs[name]
            status = lib.qmc_bridge_launch(
                table.data_ptr(), shift.data_ptr(), bridge.data_ptr(), 0, out.data_ptr(), 0,
                contracts, steps, 1, steps, count, 0, int(name != "dense"),
                torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"qmc_bridge_launch failed: cudaError {status}")

        want = qmc_cuda.bridge_normals(**kw, dense=True)
        if not torch.equal(qmc_cuda.bridge_normals(**cs.main_bridge_args(kw)), want):
            raise AssertionError(f"the package's sparse bridge is not its dense one at T={steps}")
        times = {name: [] for name in [*libs, "dense", "wrapper"]}
        for name in ["dense", *libs, *list(libs)[::-1], "dense"]:
            launch(name)
            if not torch.equal(out, want):
                raise AssertionError(f"bridge variant T={steps} {name} is not the kernel's output")
            times[name].append(cs.cuda_ms(lambda: launch(name), iters=5))
        times["wrapper"].append(cs.cuda_ms(  # the main path's call: its output allocated too
            lambda: qmc_cuda.bridge_normals(**cs.main_bridge_args(kw)), iters=5))
        bound, bound_by = cs.qmc_bound_ms(contracts, steps, 1, count)
        for name in times:
            regs = (f"(qmc_bridge_kernel<{steps}>)" if name == "dense" else
                    "(the package's bridge_normals)" if name == "wrapper" else
                    cs.ptxas_summary(built[f"bridge_t{steps}_{name}"][1]).get(
                        f"qmc_bridge_sparse_kernel<{steps}>", "?"))
            cs.phase("variant-bridge", timesteps=steps, variant=name, registers=repr(regs),
                     bit_equal=True, shape=f"{contracts}x{cs.ROWS}x{cs.COLS}x{steps}",
                     ms="/".join(f"{t:.3f}" for t in times[name]), bound_ms=f"{bound:.4f}",
                     bound_by=bound_by)
        del out, want
        torch.cuda.empty_cache()


def load_merton(paths: Path, american: Path) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """The two Merton entry points of a variant's (or the parent's) two
    libraries, with this tree's signatures (the table and, for #9, the
    log-price pointer) or, for ``parent``, the level table's."""
    ll, i, vp, f = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lp, la = ctypes.CDLL(str(paths)), ctypes.CDLL(str(american))
    parent = "merton_parent" in str(paths)
    lp.merton_paths_launch.argtypes = (
        [vp, vp, vp, vp, *([] if parent else [vp]), i, ll, ll, i, i, i, f, ll, ll, vp])
    la.american_merton_launch.argtypes = [vp, vp, vp, vp, i, ll, ll, i, i, ll, ll, vp]
    lp.merton_paths_launch.restype = la.american_merton_launch.restype = ctypes.c_int
    return lp, la


class MertonLaunch:
    """One launch of a variant's #9 (a payoff's branch) or #10 (``every``),
    its inputs made beforehand: ``()`` launches into the same output."""

    def __init__(self, libs: tuple[ctypes.CDLL, ctypes.CDLL], parent: bool,
                 params: torch.Tensor, keys: torch.Tensor, *, payoff: PayoffKind | None = None,
                 barrier_rel: float | None = None, every: int = 0, half: int | None = None,
                 out: torch.Tensor | None = None):
        steps = cs.STEPS
        self.libs, self.parent, self.payoff = libs, parent, payoff
        self.every, self.half = every, half
        self.barrier_rel = 1.0 if barrier_rel is None else barrier_rel
        self.p, self.words, _ = gbm_cuda._device_args(params, keys, steps, 1, 1)
        self.table = (dynamics_cuda.poisson_levels(self.p[:, 6] * (self.p[:, 2] / float(steps)))
                      if parent else dynamics_cuda.merton_table(self.p, steps))
        shape = (self.p.shape[0], *((steps // every,) if every else ()), cs.ROWS, cs.COLS)
        self.out = torch.empty(shape, device=params.device) if out is None else out

    def __call__(self) -> torch.Tensor:
        c, stream = self.p.shape[0], torch.cuda.current_stream().cuda_stream
        args = (self.p.data_ptr(), self.words.data_ptr(), self.table.data_ptr(),
                self.out.data_ptr())
        if self.every:
            status = self.libs[1].american_merton_launch(
                *args, c, cs.ROWS, cs.COLS, cs.STEPS, self.every, self.half or 0, 0, stream)
        else:
            branch = gbm_cuda.branch_of(self.payoff)
            status = self.libs[0].merton_paths_launch(
                *args, *([] if self.parent else [None]), c, cs.ROWS, cs.COLS, cs.STEPS,
                gbm_cuda._FAMILY_CODE[branch], dynamics_cuda._variant(branch, self.payoff),
                self.barrier_rel, self.half or 0, 0, stream)
        if status:
            raise RuntimeError(f"Merton variant launch failed: cudaError {status}")
        return self.out if self.every else gbm_cuda._route_out(self.payoff, self.out, self.p)


def one_call_words(params: torch.Tensor, keys: torch.Tensor, half: int | None) -> torch.Tensor:
    """The words ``one_call`` reads (call t's words 0–2 for step t), laid
    out where the v2 twin reads step t's: ``[C, ROWS, COLS, calls, 4]``."""
    _, call = gbm_cuda._stream(params, keys, rows=cs.ROWS, cols=cs.COLS, calls=cs.STEPS,
                               antithetic_half=half, row_offset=0, words=None)
    flat = torch.stack([w for t in range(cs.STEPS) for w in call(t)[:3]], dim=-1)
    calls = dynamics_cuda.merton_calls(cs.STEPS)
    flat = torch.cat([flat, flat[..., :4 * calls - 3 * cs.STEPS]], dim=-1)
    return flat.view(*flat.shape[:-1], calls, 4)


def merton_sass(name: str, built: dict[str, tuple[Path, str]]) -> tuple[float, float]:
    """``(#9 TERMINAL, #10 at every = 1)`` SASS a path-step of a variant:
    chip_smoke.py's rule, or, for the parent (one call a step, rolled
    monitor loops), the rule its own smoke applied."""
    paths = cs.cuobjdump_sass(built[f"merton_{name}_paths"][0])
    piece = {"merton_paths_kernelILi0E": "merton_terminal"}
    american = cs.cuobjdump_sass(built[f"merton_{name}_american"][0])
    if name == "parent":
        counts, _ = cs.parse_instruction_counts(
            paths, piece, {}, pick_loop=lambda loops: max(loops, key=len),
            single_step=lambda g: False)
        monitor, _ = cs.american_sass_count(american, "american_merton_kernel",
                                            skip_inner=False, halve_philox=False)
    else:
        counts, _ = cs.parse_instruction_counts(
            paths, piece, {}, pick_loop=cs.walk_or_longest, single_step=lambda g: True,
            draws_per_step={"merton_terminal": cs.MERTON_DRAWS_PER_STEP})
        monitor, _ = cs.monitor_sass_count(
            american, "american_merton_kernel", draws_per_step=cs.MERTON_DRAWS_PER_STEP,
            rare=True, skip_inner=False, halve_philox=False)
    return counts["merton_terminal"], monitor


def merton_variants(device: torch.device, max_sm_hz: float,
                    built: dict[str, tuple[Path, str]]) -> None:
    names = [n for n in [*MERTON, "parent"] if f"merton_{n}_paths" in built]
    libs = {n: load_merton(built[f"merton_{n}_paths"][0], built[f"merton_{n}_american"][0])
            for n in names}
    for name, lib in libs.items():
        regs = {**cs.ptxas_summary(built[f"merton_{name}_paths"][1]),
                **cs.ptxas_summary(built[f"merton_{name}_american"][1])}
        cs.phase("variant-merton-build", variant=name,
                 terminal=regs.get("merton_paths_kernel<0>", "?"),
                 american=regs.get("american_merton_kernel", "?"))
    half = cs.ROWS // 2
    checks = (("terminal", 8, dict(payoff=PayoffKind.TERMINAL)),
              ("american_every1", 4, dict(every=1)),
              ("barrier_up_out", 32, dict(payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.25)),
              ("digital", 32, dict(payoff=PayoffKind.DIGITAL)))
    for case, contracts, kw in checks:
        past = {}
        every_params, every_keys = cs.kernel_inputs(device, contracts, 200 + contracts, "merton")
        for chunk in range(0, contracts, 8):  # the twin eight contracts at a time
            params, keys = every_params[chunk:chunk + 8], every_keys[chunk:chunk + 8]
            wants = {}  # the twin on the words each layout reads
            for name in [n for n in names if n != "parent"]:
                layout = "one_call" if name == "one_call" else "v2"
                if layout not in wants:
                    twin_kw = dict(timesteps=cs.STEPS, rows=cs.ROWS, cols=cs.COLS,
                                   antithetic_half=half, words=(one_call_words(params, keys, half)
                                                                if layout == "one_call" else None))
                    if "every" in kw:
                        wants[layout] = american_cuda.simulate_merton_american_rows_cuda_plain(
                            params, keys, exercise_every=1, **twin_kw)
                    else:
                        wants[layout] = dynamics_cuda.simulate_merton_rows_cuda_plain(
                            params, keys, payoff=kw["payoff"], barrier_rel=kw.get("barrier_rel"),
                            **twin_kw)
                    del twin_kw
                want = wants[layout]
                got = MertonLaunch(libs[name], False, params, keys, half=half, **kw)()
                off = (got - want).abs() > 2e-5 * want.abs()
                if "every" in kw:
                    off = off.any(dim=1)  # a path past on any date
                past[name] = past.get(name, 0) + int(off.sum())
                del want, got, off
            del wants
            torch.cuda.empty_cache()
        cs.phase("variant-merton-twin", case=case, steps=cs.STEPS, antithetic=True,
                 paths=contracts * cs.ROWS * cs.COLS, past_rtol=past, rtol=2e-5)
    sass = {name: merton_sass(name, built) for name in names}
    path_steps_per_contract = cs.ROWS * cs.COLS * cs.STEPS
    for kernel, kw in (("terminal", dict(payoff=PayoffKind.TERMINAL)),
                       ("american_every1", dict(every=1))):
        for contracts in MERTON_CONTRACTS:
            params, keys = cs.kernel_inputs(device, contracts, 1, "merton")
            first = MertonLaunch(libs[names[0]], names[0] == "parent", params, keys, **kw)
            launches = {n: MertonLaunch(libs[n], n == "parent", params, keys, out=first.out, **kw)
                        for n in names}  # one output for all
            times = {n: [] for n in names}
            for name in names + names[::-1]:
                times[name].append(cs.cuda_ms(launches[name]))
            del launches, first
            torch.cuda.empty_cache()
            index = 0 if kernel == "terminal" else 1
            bound = (cs.bound_ms("merton_terminal", contracts, cs.STEPS)[0] if index == 0
                     else cs.dynamics_bound_ms("merton", contracts, cs.STEPS)[0])
            rate = {n: contracts * path_steps_per_contract / (min(times[n]) / 1e3)
                    for n in names}
            cs.phase("variant-merton-time", kernel=kernel,
                     shape=f"{contracts}x{cs.ROWS}x{cs.COLS}x{cs.STEPS}", bound_ms=f"{bound:.3f}",
                     **{f"{n}_ms": "/".join(f"{x:.3f}" for x in times[n]) for n in names},
                     **{f"{n}_sass": round(sass[n][index], 2) for n in names},
                     **{f"{n}_cap_share":
                        f"{rate[n] / (cs.LANES_PER_CLOCK * max_sm_hz / sass[n][index]):.4f}"
                        for n in names})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    groups = ("gbm", "walk", "bridge", "merton", "term", "cliquet")
    parser.add_argument("--only", action="append", choices=groups,
                        help="measure only these groups (repeatable; default all)")
    parser.add_argument("--parent", type=Path,
                        help="a checkout of the parent commit: its Merton, term and cliquet "
                             "kernels join those groups' variants")
    args = parser.parse_args()
    only = set(args.only or groups)
    check_edits()
    device, smi, max_sm_hz = cs.phase_device()
    built = build_all(only, args.parent)
    if "gbm" in only:
        gbm_variants(device, max_sm_hz, built)
    if "walk" in only:
        walk_variants(device, max_sm_hz, built)
    if "bridge" in only:
        bridge_variants(device, built)
    if "merton" in only:
        merton_variants(device, max_sm_hz, built)
    for kernel in ("term", "cliquet"):
        if kernel in only:
            term_cliquet_variants(kernel, device, max_sm_hz, built)
    print(smi)


if __name__ == "__main__":
    main()
