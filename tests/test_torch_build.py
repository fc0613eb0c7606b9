"""The kernel libraries' build hash covers every header their sources reach.

``ops/_build.py::load_library`` names a built library by a hash of its
sources and of their include closure (``include_closure``: the quoted
``#include`` lines, followed through the headers), so that an edited header
never leaves a stale library in ``build/kernels/`` that loads as current.
Tier 1, on a copy of ``csrc/``, nothing built: for each of the port's eight
libraries the closure holds every ``csrc/`` file that any file of it
includes, editing a header of the closure changes the library's path and
editing any other header leaves it as it was. ``gbm_step.cuh`` includes
``heston_step.cuh``, so an edit there rebuilds ``gbm_paths`` and
``american_paths``.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import pytest

from spectralmc_tpu_torch.ops import (
    _build,
    american_cuda,
    basket_cuda,
    dynamics_cuda,
    gbm_cuda,
    qmc_cuda,
)

LIBRARIES = {lib[0]: lib for lib in (
    gbm_cuda.LIBRARY, dynamics_cuda.LIBRARY, basket_cuda.LIBRARY, qmc_cuda.LIBRARY,
    american_cuda.LIBRARY, american_cuda.DYNAMICS_LIBRARY, american_cuda.BACKWARD_LIBRARY,
    american_cuda.TWO_STATE_LIBRARY)}


def test_every_library_is_listed() -> None:
    """The port's eight libraries, each ``(name, sources)``: no hand-kept
    header list is left to go stale."""
    assert len(LIBRARIES) == 8
    assert all(len(lib) == 2 for lib in LIBRARIES.values())


@pytest.mark.parametrize("name", list(LIBRARIES))
def test_build_hash_covers_the_include_closure(name: str, tmp_path: Path) -> None:
    _, sources = LIBRARIES[name]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    closure = _build.include_closure(sources, csrc)
    files = (*sources, *closure)
    included = {inc for f in files
                for inc in re.findall(r'#include "([^"]+)"', (csrc / f).read_text())}
    assert included <= set(files) and set(closure) <= included
    before = _build.library_path(name, sources, csrc)
    assert before.parent == _build.BUILD_DIR and before.name.startswith(f"{name}-")
    for header in sorted(p.name for p in csrc.glob("*.cuh")):
        text = (csrc / header).read_text()
        (csrc / header).write_text(text + "// an edit\n")
        after = _build.library_path(name, sources, csrc)
        assert (after != before) == (header in closure), header
        (csrc / header).write_text(text)
    assert _build.library_path(name, sources, csrc) == before
    if name in ("gbm_paths", "american_paths"):
        assert "heston_step.cuh" in closure
