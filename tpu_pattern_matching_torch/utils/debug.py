"""Debug logging — the reference's DPRINTF family as a runtime subsystem.

The reference gates fprintf tracing behind ``-D_DEBUG`` at compile time
(``DPRINTF``/``DPRINTF2``, common.h:22-43). Here the switch is the
``TPM_DEBUG`` environment variable, read per call so tests and embedders
can toggle it without reimporting:

- ``TPM_DEBUG=1`` — framework events: engine/config choice, feeder file
  lifecycle, batch dispatch/decode summaries (the DPRINTF tier).
- ``TPM_DEBUG=2`` — adds per-round detail (the DPRINTF2 tier).

Copy of the reference's ``utils/debug.py``; its device-side
``kernel_debug`` (``jax.debug.print``) is not ported (ROADMAP queue 1
item 12).

All output goes to stderr through the ``tpu_pattern_matching_torch`` logger so
embedders can redirect it with standard ``logging`` configuration.
"""

from __future__ import annotations

import logging
import os
import sys

logger = logging.getLogger("tpu_pattern_matching_torch")
_configured = False


def level() -> int:
    try:
        return int(os.environ.get("TPM_DEBUG", "0") or 0)
    except ValueError:
        return 0


def _ensure_handler() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[tpm] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.DEBUG)


def dprint(lvl: int, msg: str, *args) -> None:
    """DPRINTF analogue: emit when TPM_DEBUG >= lvl."""
    if level() >= lvl:
        _ensure_handler()
        logger.debug(msg, *args)

