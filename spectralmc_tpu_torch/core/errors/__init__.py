"""Frozen error ADTs, one module per subsystem (the JAX package's
``core/errors``): failures are data carried in ``Result``, not exceptions.
"""


def not_ported(what: str, queue_item: str) -> NotImplementedError:
    """The loud refusal for a JAX-package feature the port has not reached.

    ``queue_item`` names the ROADMAP.md queue entry that will port it.
    """
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {queue_item})")
