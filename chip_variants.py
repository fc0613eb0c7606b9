"""Design variants of two of the port's kernels, measured on one NVIDIA GPU.

    python3 chip_variants.py

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

Prints one line per measurement and, last, the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from spectralmc_tpu_torch.ops import gbm_cuda, qmc_cuda, rng
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


def build(name: str, source: str, edited: str, edit) -> tuple[Path, str]:
    """nvcc one variant: ``source`` from a copy of csrc/ whose file
    ``edited`` has ``edit(text)`` applied, built with the package's flags;
    ``(library, nvcc's log)``."""
    d = OUT / name / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d)
    (d / edited).write_text(edit((d / edited).read_text()))
    lib = d.parent / f"lib{name}.so"
    done = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(d / source)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{(done.stdout + done.stderr)[-4000:]}")
    return lib, done.stdout + done.stderr


def build_all() -> dict[str, tuple[Path, str]]:
    """Every variant, one nvcc each, all started together."""
    jobs = {f"gbm_{name}": ("gbm_paths.cu", "gbm_step.cuh", transform_edit(body))
            for name, body in TRANSFORM.items()}
    jobs.update({f"walk_{name}": ("qmc_paths.cu", "qmc_paths.cu", walk_edit(*knobs))
                 for name, knobs in WALK.items()})
    jobs.update({f"bridge_t{steps}_b{blocks}": ("qmc_paths.cu", "qmc_paths.cu",
                                                  walk_edit(2, blocks))
                 for steps, blocks in BRIDGE})
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


def main() -> None:
    device, smi, max_sm_hz = cs.phase_device()
    built = build_all()
    gbm_variants(device, max_sm_hz, built)
    walk_variants(device, max_sm_hz, built)
    bridge_variants(device, built)
    print(smi)


if __name__ == "__main__":
    main()
