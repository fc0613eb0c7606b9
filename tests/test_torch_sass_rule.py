"""``chip_smoke.py``'s SASS rule and per-part split, on synthetic disassembly.

The card runs the rule on ``cuobjdump -sass`` and ``nvdisasm -gi`` of the
built libraries; here the same functions read small texts in those formats,
and the attribution reads the repository's own csrc/ files: a loop's Philox
block skipped every other iteration (the rolled draw) counts half, a loop
that calls Philox unskipped covers the steps its calls' draws feed, and each
instruction goes to the part its source lines name.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

import chip_smoke as cs

CSRC = Path(cs.__file__).resolve().parent / "spectralmc_tpu_torch" / "csrc"


def _sass(ops: list[str]) -> str:
    """One function's ``cuobjdump -sass`` text, an instruction every 16 bytes."""
    return "Function : _Zkernel\n" + "\n".join(
        f"        /*{16 * i:04x}*/                   {op} ;" for i, op in enumerate(ops))


def _line(name: str, text: str) -> int:
    """The 1-based line of ``text`` in csrc/``name``."""
    return next(i for i, line in enumerate((CSRC / name).read_text().splitlines(), 1)
                if text in line)


def test_skipped_philox_block_counts_half() -> None:
    # MOV, a skip over 20 IMAD.WIDE.U32 and 2 LOP3 (the block), 3 more, the back branch
    ops = ["MOV R1, R2", f"@P0 BRA 0x{16 * 24:x}", *["IMAD.WIDE.U32 R2, R3, R4, RZ"] * 20,
           "LOP3.LUT R5", "LOP3.LUT R6", "FADD R1, R2, R3", "FFMA R1, R2, R3, R4", "@P1 BRA 0x0"]
    weights, steps, found = cs.loop_weights(
        _sass(ops).split("Function : ")[1], "g", pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: False, draws_per_step=1)
    assert steps == 1 and found == "27-0-0-22/2=16/1"
    assert sum(w for *_, w in weights) == 16


@pytest.mark.parametrize("calls,draws_per_step,steps", [(1, 1, 2), (2, 1, 4), (1, 2, 1),
                                                        (2, 2, 2), (1, 0.5, 4), (2, 0.5, 8)])
def test_unskipped_philox_calls_set_the_steps(calls: int, draws_per_step: int,
                                              steps: int) -> None:
    """20 IMAD.WIDE.U32 a call (19 where the first round's product is
    hoisted); a call feeds two draws, and a pair-step draw two steps."""
    ops = ["MOV R1, R2", *["IMAD.WIDE.U32 R2, R3, R4, RZ"] * (20 * calls - 1),
           *["FFMA R1, R2, R3, R4"] * 10, "@P1 BRA 0x0"]
    weights, got, _ = cs.loop_weights(
        _sass(ops).split("Function : ")[1], "g", pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: False, draws_per_step=draws_per_step)
    assert got == steps and sum(w for *_, w in weights) == len(ops)


def test_split_high_products_count_as_philox_multiplies() -> None:
    """ptxas may split a round's IMAD.WIDE.U32 into IMAD.HI.U32 and IMAD:
    13 wide and 5 high products still make one call, two Heston steps."""
    ops = ["MOV R1, R2", *["IMAD.WIDE.U32 R2, R3, R4, RZ"] * 13,
           *["IMAD.HI.U32 R5, R3, R4, RZ", "IMAD R6, R3, R4, RZ"] * 5,
           *["FFMA R1, R2, R3, R4"] * 10, "@P1 BRA 0x0"]
    _, steps, _ = cs.loop_weights(
        _sass(ops).split("Function : ")[1], "g", pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: False, draws_per_step=1)
    assert steps == 2


def test_an_if_else_arm_is_not_a_once_per_path_region() -> None:
    """In a loop that walks whole calls, a region that ends by jumping over
    its else arm (the Box–Muller's u1 < ½, divergent) issues every
    iteration; a plain skipped region (the forward start's capture) is the
    once-per-path one."""
    ops = ["MOV R1, R2", *["IMAD.WIDE.U32 R2, R3, R4, RZ"] * 20,
           f"@!P0 BRA 0x{16 * 25:x}", "FADD R1, R2, R3", "FFMA R1, R2, R3, R4",
           f"BRA 0x{16 * 27:x}", "MUFU.LG2 R1, R2", "FMUL R1, R1, R2",
           f"@P2 BRA 0x{16 * 30:x}", "MUFU.EX2 R3, R3", "FFMA R4, R3, R5, R4",
           "@P1 BRA 0x0"]
    weights, steps, found = cs.loop_weights(
        _sass(ops).split("Function : ")[1], "g", pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: True, draws_per_step=2)
    assert steps == 1 and found == "31-0-2-0/2=29/1"
    assert sum(w for *_, w in weights) == 29


def test_merton_walk_covers_four_steps_and_drops_the_rare_count() -> None:
    """The Merton walk: three calls unskipped (60 products, one hoisted) feed
    four steps of three words (``MERTON_DRAWS_PER_STEP`` draws); the count's
    rare branch (a skipped region of compares and loads, no else arm) never
    runs on the bench's inputs and weighs 0, like sqrtf's fix-up."""
    ops = ["MOV R1, R2", *["IMAD.WIDE.U32 R2, R3, R4, RZ"] * 59,
           *["FFMA R1, R2, R3, R4"] * 8, f"@!P2 BRA 0x{16 * 74:x}",
           "LDG.E.128.CONSTANT R8, desc[UR12][R26.64+0x20]", "FSETP.GE.AND P0, PT, R23, R8, PT",
           "FSEL R8, R8, 5, P0", "MUFU.RSQ R9, R8", "FMUL.FTZ R11, R8, R9",
           "FADD R1, R2, R3", "@P1 BRA 0x0"]
    weights, steps, found = cs.loop_weights(
        _sass(ops).split("Function : ")[1], "merton_terminal", pick_loop=cs.walk_or_longest,
        single_step=lambda group: True, draws_per_step=cs.MERTON_DRAWS_PER_STEP)
    assert steps == 4 and found == "76-0-5-0/2=71/4"
    assert sum(w for *_, w in weights) == 71


def test_nvdisasm_frames_join_an_inlined_line_and_its_call_site() -> None:
    text = (
        '\t.section\t.text._Zk,"ax",@progbits\n'
        '\t//## File "/x/csrc/path_stream.cuh", line 37 inlined at "/x/csrc/k.cu", line 5\n'
        '\t//## File "/x/csrc/k.cu", line 5\n'
        "        /*0000*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;\n"
        "        /*0010*/                   LOP3.LUT R5, R6, R7, R8, 0x96, !PT ;\n"
        '\t//## File "/x/csrc/k.cu", line 9\n'
        "        /*0020*/                   FADD R1, R2, R3 ;\n")
    frames = cs.parse_nvdisasm_lines(text)["_Zk"]
    assert frames[0] == frames[16] == [("/x/csrc/path_stream.cuh", 37), ("/x/csrc/k.cu", 5),
                                       ("/x/csrc/k.cu", 5)]
    assert frames[32] == [("/x/csrc/k.cu", 9)]


def test_parts_follow_the_stream_helpers_and_the_step_text() -> None:
    read = lambda f: Path(f).read_text().splitlines()  # noqa: E731
    stream, heston = str(CSRC / "path_stream.cuh"), str(CSRC / "heston_step.cuh")
    kernel = str(CSRC / "dynamics_paths.cu")
    call_site = (kernel, _line("dynamics_paths.cu", "heston_step<kFamily == kVariance>"))
    philox = (stream, _line("path_stream.cuh", "c = make_uint4(hi1 ^ c.y ^ k0"))
    assert cs.part_of([philox, call_site], read) == "philox"
    radius = (stream, _line("path_stream.cuh", "return x * rsqrt_sfu"))
    assert cs.part_of([radius, call_site], read) == "box_muller"
    assert cs.part_of([(heston, _line("heston_step.cuh", "const float z_s =")), call_site],
                      read) == "update"
    assert cs.part_of([(heston, _line("heston_step.cuh", "const float z_v =")), call_site],
                      read) == "box_muller"
    assert cs.part_of([(stream, _line("path_stream.cuh", "for (; t + kL <= steps; t += kL)")),
                       call_site], read) == "branch"
    assert cs.part_of([("/usr/local/cuda/include/crt/math.h", 9), call_site], read) == "branch"


def test_merton_parts_follow_the_step_helpers() -> None:
    """The Merton split: the count (its uniform included) and the jump by
    their helpers, the draw's transform as Box–Muller, the three-word
    accessor as Philox, the log-price update by its text and a monitor
    kernel's exp-and-store line as the stores."""
    read = lambda f: Path(f).read_text().splitlines()  # noqa: E731
    step, stream = str(CSRC / "merton_step.cuh"), str(CSRC / "path_stream.cuh")
    american = str(CSRC / "american_dynamics.cu")
    kernel = str(CSRC / "dynamics_paths.cu")
    call_site = (kernel, _line("dynamics_paths.cu", "merton_step<kFamily == kVariance>"))
    uniform = (stream, _line("path_stream.cuh", "return static_cast<float>(w >> 8) * 0x1p-24f;"))
    count = (step, _line("merton_step.cuh", "const float u = uniform_closed(w);"))
    assert cs.part_of([uniform, count, call_site], read) == "count"
    assert cs.part_of([(step, _line("merton_step.cuh", "n = hit ?")), call_site], read) == "count"
    jump = (step, _line("merton_step.cuh", "return __fmaf_rn(__fmul_rn(k.jump_std, root)"))
    assert cs.part_of([jump, call_site], read) == "jump"
    draw = (step, _line("merton_step.cuh", "box_muller_pinned(d, rad, cs, sn);"))
    assert cs.part_of([draw, call_site], read) == "box_muller"
    assert cs.part_of([(step, _line("merton_step.cuh", "logx = __fadd_rn(__fmaf_rn(k.vol_sdt")),
                       call_site], read) == "update"
    assert cs.part_of([(stream, _line("path_stream.cuh", "w = call(first + 1);")), call_site],
                      read) == "philox"
    store = (american, _line("american_dynamics.cu", "*o = expf(logx); o += n;"))
    assert cs.part_of([store], read) == "stores"


def test_split_sums_to_the_count_and_sorts_units(tmp_path: Path) -> None:
    src = tmp_path / "csrc" / "k.cu"
    src.parent.mkdir()
    src.write_text("__global__ void k() {\n  logx = logx + inc;\n  loop();\n}\n")
    ops = ["FADD R1, R2, R3", "MUFU.LG2 R4, R5", "LOP3.LUT R5, R6, R7, R8, 0x96, !PT",
           "@P1 BRA 0x0"]
    disasm = '\t.section\t.text._Zkernel,"ax",@progbits\n' + "".join(
        f'\t//## File "{src}", line {2 if i < 2 else 3}\n'
        f"        /*{16 * i:04x}*/                   {op} ;\n" for i, op in enumerate(ops))
    split = cs.sass_split(_sass(ops), disasm, "_Zkernel", draws_per_step=1)
    assert (split["update"], split["branch"], split["total"]) == (2.0, 2.0, 4.0)
    assert split["mix"] == {"xu": 1.0, "fp32": 1.0, "int": 1.0, "other": 1.0}


def test_qmc_parts_follow_the_walk_functions() -> None:
    """The fused walk's split: the inverse CDF before the word (its lines
    inline into the word's), the word's XORs, the bridge rows, the rest the
    walk; erf⁻¹'s tail arm is marked."""
    read = lambda f: Path(f).read_text().splitlines()  # noqa: E731
    qmc = str(CSRC / "qmc_paths.cu")
    call_site = (qmc, _line("qmc_paths.cu", "z[l][i] = word_normal(w[i])"))
    normal = (qmc, _line("qmc_paths.cu", "const float u = __fmul_rn(__fadd_rn("))
    assert cs.qmc_part([normal, call_site], read) == ("normal", False)
    tail = (qmc, _line("qmc_paths.cu", "const float wl = sqrtf(w) - 3.0f;"))
    assert cs.qmc_part([tail, call_site], read) == ("normal", True)
    word = (qmc, _line("qmc_paths.cu", "x ^= mask[bit] & dir[bit];"))
    assert cs.qmc_part([word, call_site], read) == ("words", False)
    bridge = (qmc, _line("qmc_paths.cu", "e[i] = __fmaf_rn(b[d], z[l][i], e[i]);"))
    assert cs.qmc_part([bridge], read) == ("bridge", False)
    walk = (qmc, _line("qmc_paths.cu", "acc[i] = __fadd_rn(acc[i], logx[i]);"))
    assert cs.qmc_part([walk], read) == ("walk", False)


def test_qmc_split_weighs_the_edge_stores_but_not_the_early_return(monkeypatch) -> None:
    """The fused walk's split counts what follows the tables' barrier over
    a thread's points (kQuad, read from the source): a branch past more
    than half of it (the early return) skips nothing, a skipped region that
    stores without computing (the points on an edge of the range) counts
    0, the parking branch after EXIT is no instruction."""
    qmc = CSRC / "qmc_paths.cu"
    points = int(re.search(r"constexpr int kQuad = (\d+);", qmc.read_text()).group(1))
    ops = ["S2R R0, SR_TID.X", "BAR.SYNC.DEFER_BLOCKING 0x0", "@P0 BRA 0xc0",
           "FFMA R1, R2, R3, R4", "FFMA R1, R2, R3, R4", "@P1 BRA 0x80", "STG.E [R2.64], R1",
           "STG.E [R2.64+0x4], R1", "STG.E.64 [R2.64], R4", "MUFU.LG2 R5, R6", "FADD R7, R7, R8",
           "FADD R7, R7, R8", "EXIT", "BRA 0xd0"]
    sass = "Function : _Zqmc_walk_sparse_kernelILi16E\n" + "\n".join(
        f"        /*{16 * i:04x}*/                   {op} ;" for i, op in enumerate(ops))
    bridge = "e[i] = __fmaf_rn(b[d], z[l][i], e[i]);"
    lines = {3: bridge, 4: bridge, 9: "const float u = __fmul_rn(__fadd_rn("}
    walk = "acc[i] = __fadd_rn(acc[i], logx[i]);"  # every other instruction's line
    disasm = '\t.section\t.text._Zqmc_walk_sparse_kernelILi16E,"ax",@progbits\n' + "".join(
        f'\t//## File "{qmc}", line {_line("qmc_paths.cu", lines.get(i, walk))}\n'
        f"        /*{16 * i:04x}*/                   {op} ;\n" for i, op in enumerate(ops))
    monkeypatch.setattr(cs, "cuobjdump_sass", lambda library: sass)
    monkeypatch.setattr(cs, "nvdisasm_text", lambda library: disasm)
    split = cs.qmc_walk_sass("library", source=qmc)
    assert split["points_per_thread"] == points
    assert split["bridge"] == split["bridge_ffma"] == round(2 / points, 3)
    assert split["normal"] == round(1 / points, 3)
    # 12 after the barrier, less the 2 edge stores and the parking branch
    assert split["total"] == round(9 / points, 3)


def test_qmc_bridge_parts_follow_the_bridge_functions() -> None:
    """#13's split: the normal, the word's XORs, the bridge rows and the
    vector store by their functions; the one-float edge stores, the checks'
    word copy and the padded reads are work the main path never runs, in
    the sparse kernel and the dense one alike."""
    read = lambda f: Path(f).read_text().splitlines()  # noqa: E731
    qmc = str(CSRC / "qmc_paths.cu")

    def at(text: str) -> tuple[str, int]:
        return qmc, _line("qmc_paths.cu", text)

    call_site = at("z[l][i] = word_normal(w[i])")
    assert cs.qmc_bridge_part([at("const float u = __fmul_rn(__fadd_rn("), call_site],
                              read) == ("normal", False)
    assert cs.qmc_bridge_part([at("const float wl = sqrtf(w) - 3.0f;"), call_site],
                              read) == ("normal", True)
    assert cs.qmc_bridge_part([at("x ^= mask[bit] & dir[bit];")], read) == ("words", False)
    assert cs.qmc_bridge_part([at("e[i] = __fmaf_rn(b[d], z[l][i], e[i]);")],
                              read) == ("bridge", False)
    assert cs.qmc_bridge_part([at("*reinterpret_cast<float2*>(o) = make_float2(e[0], e[1]);")],
                              read) == ("stores", False)
    assert cs.qmc_bridge_part([at("if (in[i]) o[i] = e[i];")], read) == ("idle", False)
    assert cs.qmc_bridge_part([at("if (in[i]) words_c[")], read) == ("idle", False)
    assert cs.qmc_bridge_part([at("z[i] = in[i] ? col[i] : 0.0f;")], read) == ("pad", False)
    assert cs.qmc_bridge_part([at("return pad[static_cast<int64_t>(k - sdims) * count];")],
                              read) == ("pad", False)
    assert cs.qmc_bridge_part([at("words_out[(static_cast<int64_t>(c) * sdims + k)")],
                              read) == ("idle", False)
    assert cs.qmc_bridge_part([at("if (t < timesteps) out_c[")], read) == ("stores", False)
    assert cs.qmc_bridge_part([at("const bool vec = p0 >= 0")], read) == ("other", False)


def test_qmc_bridge_split_drops_the_padded_copy(monkeypatch) -> None:
    """The sparse bridge's split: the shortest forward-branch region that
    holds every padded read (its copy of a factor's rows for padded
    dimensions) counts 0, the rest over a thread's points."""
    qmc = CSRC / "qmc_paths.cu"
    points = int(re.search(r"constexpr int kQuad = (\d+);", qmc.read_text()).group(1))
    ops = ["S2R R0, SR_TID.X", "BAR.SYNC.DEFER_BLOCKING 0x0", "@P0 BRA 0x70",
           "FFMA R1, R2, R3, R4", "LDG.E R1, [R2.64]", "FFMA R1, R2, R3, R4", "BRA 0x90",
           "FFMA R1, R2, R3, R4", "STG.E.64 [R2.64], R4", "EXIT", "BRA 0xa0"]
    name = "_Zqmc_bridge_sparse_kernelILi16E"
    sass = f"Function : {name}\n" + "\n".join(
        f"        /*{16 * i:04x}*/                   {op} ;" for i, op in enumerate(ops))
    bridge = "e[i] = __fmaf_rn(b[d], z[l][i], e[i]);"
    lines = {3: bridge, 4: "z[i] = in[i] ? col[i] : 0.0f;", 5: bridge, 7: bridge,
             8: "*reinterpret_cast<float2*>(o) = make_float2(e[0], e[1]);"}
    other = "const bool vec = p0 >= 0"
    disasm = f'\t.section\t.text.{name},"ax",@progbits\n' + "".join(
        f'\t//## File "{qmc}", line {_line("qmc_paths.cu", lines.get(i, other))}\n'
        f"        /*{16 * i:04x}*/                   {op} ;\n" for i, op in enumerate(ops))
    monkeypatch.setattr(cs, "cuobjdump_sass", lambda library: sass)
    monkeypatch.setattr(cs, "nvdisasm_text", lambda library: disasm)
    split = cs.qmc_bridge_sass("library", source=qmc)
    assert split["points_per_thread"] == points
    assert split["bridge"] == split["bridge_ffma"] == round(1 / points, 3)
    assert split["stores"] == round(1 / points, 3)
    # the branch, the kept FFMA, the store and EXIT; the padded copy and the parking branch not
    assert split["total"] == round(4 / points, 3)


def _functions(blocks: dict[str, list[str]]) -> str:
    """Several functions' ``cuobjdump -sass`` text."""
    return "".join(_sass(ops).replace("_Zkernel", name) + "\n" for name, ops in blocks.items())


CLIQUET_NAME = "_Z18gbm_cliquet_kernelPKfPKjPflliiffll"
# a rolled loop (v1): a skipped Philox block of 22 and 5 more instructions
ROLLED = ["MOV R1, R2", f"@P0 BRA 0x{16 * 24:x}", *["IMAD.WIDE.U32 R2, R3, R4, RZ"] * 20,
          "LOP3.LUT R5", "LOP3.LUT R6", "FADD R1, R2, R3", "FFMA R1, R2, R3, R4", "@P1 BRA 0x0"]


def _walk_body(calls: int, extra: int) -> list[str]:
    """A loop that makes ``calls`` whole Philox calls unskipped (20 wide
    products each) and ``extra`` more instructions."""
    return ["MOV R1, R2", *["IMAD.WIDE.U32 R2, R3, R4, RZ"] * (20 * calls),
            *["FFMA R1, R2, R3, R4"] * extra, "@P1 BRA 0x0"]


def test_term_walks_count_four_steps_a_call_for_pairs_and_two_for_single_draws() -> None:
    """The term kernel's v2 walks: TERMINAL and the variance swap take a
    whole call for two pair draws, four steps; the one-draw branches two
    steps a call."""
    body = _walk_body(1, 37)  # 59 instructions an iteration
    text = _functions({f"_Z15gbm_term_kernelILi{code}EEvPKfPKjPK6float2Pfllifll": body
                       for code in range(5)})
    counts, found = cs.term_sass_count(text)
    assert counts["term_terminal"] == counts["term_variance"] == len(body) / 4
    for group in ("term_barrier", "term_lookback", "term_asian"):
        assert counts[group] == len(body) / 2
    assert found["term_terminal"].endswith("/4") and found["term_asian"].endswith("/2")


def test_term_rolled_draws_count_by_the_rolled_rule() -> None:
    """A v1 term build (a parent's) draws one by one: its Philox block is
    skipped every other draw and a pair draw covers two steps."""
    text = _functions({"_Z15gbm_term_kernelILi0EEvPKfPKjPK6float2S4_Pfllifll": ROLLED})
    counts, found = cs.term_sass_count(text)
    assert found["term_terminal"] == "27-0-0-22/2=16/2" and counts["term_terminal"] == 8


def test_cliquet_walk_counts_four_periods_a_call() -> None:
    """The cliquet's count a path-step over a whole path: the v2 walk's loop
    (one whole call, two pair draws, four periods an iteration) runs
    ``periods / 4`` times, the v1 rolled loop (a draw, two periods, its
    Philox block every other draw) ``periods / 2`` times."""
    body = _walk_body(1, 43)
    periods = cs.STEPS // cs.CLIQUET["reset_every"]
    counts, found = cs.cliquet_sass_count(_functions({CLIQUET_NAME: body}))
    assert counts["cliquet"] == len(body) * (periods // 4) / cs.STEPS
    assert found["cliquet"] == f"{len(body)}-0-0-0/2={len(body)}/1 x {periods // 4} + 0"
    counts, found = cs.cliquet_sass_count(_functions({CLIQUET_NAME: ROLLED}))
    assert counts["cliquet"] == 16 * (periods // 2) / cs.STEPS
    assert found["cliquet"] == f"27-0-0-22/2=16/1 x {periods // 2} + 0"


def test_cliquet_split_counts_a_path_by_part(tmp_path: Path) -> None:
    """The cliquet's split a path: the index (path_setup) and the
    coefficients once, the walk's loop once per whole call (four periods),
    the store once; the slow path behind a skip holding a CALL, the walk's
    tails (Philox, transform and exp-and-clip outside the loop) and what
    follows the parking branch never."""
    stream, gbm = str(CSRC / "path_stream.cuh"), str(CSRC / "gbm_paths.cu")
    at = {
        "index": (stream, _line("path_stream.cuh", "const int64_t lrow = local / cols;")),
        "coefficients": (gbm, _line("gbm_paths.cu", "const float period_vol = __fmul_rn(vol")),
        "philox": (stream, _line("path_stream.cuh", "c = make_uint4(hi1 ^ c.y ^ k0")),
        "transform": (str(CSRC / "heston_step.cuh"),
                      _line("heston_step.cuh", "rad = __fsqrt_rn(__fmul_rn(-2.0f, ln_pinned(")),
        "exp_clip": (gbm, _line("gbm_paths.cu", "return fminf(fmaxf(ret, floor), cap);")),
        "store": (gbm, _line("gbm_paths.cu", "out[static_cast<int64_t>(c) * n + local] = acc")),
    }
    listing = [  # (op, part of its source line)
        ("S2R R0, SR_CTAID.X", "index"), ("IMAD R0, R0, R1, R2", "index"),
        ("FFMA R3, R4, R5, R6", "coefficients"), ("@P0 BRA 0x{skip}", "coefficients"),
        ("CALL.REL.NOINC 0x{sub}", "coefficients"), ("MOV R7, R8", "coefficients"),
        *[("IMAD.WIDE.U32 R2, R3, R4, RZ", "philox")] * 20, ("MUFU.RSQ R9, R9", "transform"),
        ("FFMA R9, R9, R9, R9", "transform"), ("MUFU.EX2 R9, R9", "exp_clip"),
        ("FMNMX R9, R9, R8, PT", "exp_clip"), ("@P1 BRA 0x{loop}", "exp_clip"),
        ("@!P2 BRA 0x{store}", "index"),
        *[("IMAD.WIDE.U32 R2, R3, R4, RZ", "philox")] * 20, ("MUFU.RSQ R9, R9", "transform"),
        ("MUFU.EX2 R9, R9", "exp_clip"), ("STG.E [R2.64], R9", "store"), ("EXIT", "store"),
        ("BRA 0x{park}", "store"), ("FFMA R1, R2, R3, R4", "coefficients"),
        ("RET.REL", "index")]
    loop = 6
    skip = 6  # past the CALL region (the CALL and the MOV)
    addr = lambda i: f"{16 * i:x}"  # noqa: E731
    store = next(i for i, (op, _) in enumerate(listing) if op.startswith("STG"))
    park = next(i for i, (op, _) in enumerate(listing) if op.startswith("BRA 0x{park}"))
    ops = [op.format(skip=addr(skip), sub=addr(park + 1), loop=addr(loop), store=addr(store),
                     park=addr(park)) for op, _ in listing]
    name = CLIQUET_NAME
    sass = _sass(ops).replace("_Zkernel", name)
    disasm = f'\t.section\t.text.{name},"ax",@progbits\n' + "".join(
        f'\t//## File "{at[part][0]}", line {at[part][1]}\n'
        f"        /*{16 * i:04x}*/                   {op} ;\n"
        for i, (op, (_, part)) in enumerate(zip(ops, listing)))
    split = cs.cliquet_sass_split(sass, disasm, steps=4 * 4 * cs.CLIQUET["reset_every"])
    assert split["iterations"] == 4.0  # 16 periods, four a call
    assert (split["philox"], split["transform"], split["exp_clip"]) == (80.0, 8.0, 12.0)
    # index: S2R, IMAD and the tail's guard; coefficients: the FFMA and the skip
    assert (split["index"], split["coefficients"], split["store"]) == (3.0, 2.0, 2.0)
    assert split["total"] == 107.0 and split["outside_loop"] == 7


HESTON_SASS = Path(__file__).resolve().parent / "fixtures" / "sass" / \
    "heston_paths_lookback_barrier.sass"


def test_heston_lookback_counts_one_arm_of_its_variant_switch() -> None:
    """The Heston kernel's lookback loop (the card's ``cuobjdump -sass`` of
    ``heston_paths_kernel<2>``, saved) switches three ways on the
    ``variant`` argument, each arm two steps of the walk; the barrier's
    two ways on it. Each path runs one arm, so the rule counts the longest
    and the rest is idle: about the barrier's count a step, not the 195.5
    (two arms) that put the lookback's cap share above 1."""
    text = HESTON_SASS.read_text()
    kernels = {"heston_paths_kernelILi2E": "heston_lookback",
               "heston_paths_kernelILi1E": "heston_barrier"}
    counts, found = cs.parse_instruction_counts(
        text, kernels, {}, pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: False, draws_per_step=dict.fromkeys(kernels.values(), 1))
    assert found == {"heston_lookback": "601-13-0-0/2-367=221/2",
                     "heston_barrier": "324-13-0-0/2-92=219/2"}
    assert counts == {"heston_lookback": 110.5, "heston_barrier": 109.5}


@pytest.mark.parametrize("source,switch", [("LDC R9, c[0x0][0x23c]", True),
                                           ("ULDC UR9, c[0x0][0x23c]", True),
                                           ("FADD R9, R1, R2", False)])
def test_only_a_switch_on_a_kernel_argument_idles_an_arm(source: str, switch: bool) -> None:
    """An if/else whose predicate compares a register the loop loaded from
    the parameter bank (or a uniform register it does not write) runs one
    arm a launch; one on data is a divergent branch, both arms issue."""
    reg = source.split()[1].rstrip(",")
    # the compare, a branch over a 6-op then arm ending in a jump over a
    # 4-op else arm, and the back branch
    ops = [source, f"ISETP.NE.AND P1, PT, {reg}, 0x1, PT", f"@!P1 BRA 0x{16 * 10:x}",
           *["FADD R1, R2, R3"] * 6, f"BRA 0x{16 * 14:x}", *["FMUL R1, R2, R3"] * 4,
           "@P0 BRA 0x0"]
    weights, steps, found = cs.loop_weights(
        _sass(ops).split("Function : ")[1], "g", pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: False)
    idle = sum(w == 0.0 for *_, w in weights)
    assert idle == (4 if switch else 0)
    assert sum(w for *_, w in weights) == len(ops) - idle


def test_a_share_past_the_cap_is_printed_as_unread() -> None:
    assert cs.cap_share(0.5, 1.0) == {"share_of_instruction_cap": "0.5000"}
    unread = cs.cap_share(1.2, 1.0)
    assert unread["share_of_instruction_cap"] is None
    assert "instructions the loop does not issue" in unread["share_of_instruction_cap_unread"]
