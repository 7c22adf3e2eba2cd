"""Debug logging — the reference's DPRINTF family as a runtime subsystem.

The reference gates fprintf tracing behind ``-D_DEBUG`` at compile time
(``DPRINTF``/``DPRINTF2``, common.h:22-43). Here the switch is the
``TPM_DEBUG`` environment variable, read per call so tests and embedders
can toggle it without reimporting:

- ``TPM_DEBUG=1`` — framework events: engine/config choice, feeder file
  lifecycle, batch dispatch/decode summaries (the DPRINTF tier).
- ``TPM_DEBUG=2`` — adds device-side values via :func:`kernel_debug`
  and per-round detail (the DPRINTF2 tier).

Copy of the reference's ``utils/debug.py``; its ``kernel_debug``
(``jax.debug.print`` inside jitted code) becomes a host-side read of the
tensors, as eager PyTorch has no traced code to print from.

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


def kernel_debug(fmt: str, *vals) -> None:
    """Device-side debug hook: at TPM_DEBUG >= 2, reads ``vals`` to the
    host (a tensor's read waits for the device: a sync, only then) and
    logs ``fmt.format(*vals)`` (``{}`` fields, as ``jax.debug.print``)
    through the package logger; a one-element tensor prints as its value.
    Below 2 it returns without touching any value, so call sites cost
    nothing in production runs. Unlike the reference's, the gate is read
    at every call (no trace bakes it in)."""
    if level() < 2:
        return
    _ensure_handler()
    logger.debug(fmt.format(*(_host_value(v) for v in vals)))


def _host_value(v):
    tolist = getattr(v, "tolist", None)  # tensors and arrays
    if tolist is None:
        return v
    x = tolist()
    return x[0] if isinstance(x, list) and len(x) == 1 else x

