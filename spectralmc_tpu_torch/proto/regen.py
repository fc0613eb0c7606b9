"""Regenerate the port's ``*_pb2.py`` modules from its ``.proto`` schemas.

    python -m spectralmc_tpu_torch.proto.regen

Runs ``protoc`` with the repository root as the include path, so the
schemas register in protobuf's descriptor pool as
``spectralmc_tpu_torch/proto/<name>.proto`` in the proto package
``spectralmc_tpu_torch``: a process that also imports the JAX package's
generated modules (``tensors.proto`` in package ``spectralmc_tpu``) sees no
duplicate file or symbol. Neither name reaches the wire. The generated
modules are committed, so the package imports without a build step.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

PROTO_DIR = pathlib.Path(__file__).resolve().parent
ROOT = PROTO_DIR.parent.parent


def main() -> int:
    protos = sorted(PROTO_DIR.glob("*.proto"))
    if not protos:
        print("no .proto files found", file=sys.stderr)
        return 1
    subprocess.run(
        ["protoc", f"-I{ROOT}", f"--python_out={ROOT}",
         *(str(p.relative_to(ROOT)) for p in protos)],
        check=True,
        cwd=ROOT,
    )
    print(f"regenerated {len(protos)} schemas into {PROTO_DIR}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
