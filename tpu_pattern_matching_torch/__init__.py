"""PyTorch + CUDA port of ``tpu_pattern_matching`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package runs its
default single-device pipeline — the q-gram bloom probe (hand-written CUDA
kernels under ``csrc/``), on-device exact-gram refinement (torch ops) and
the native host window verifier — and is held to the reference bit for bit
by ``tests/test_torch_*.py``.

Layout mirrors the reference so each module's counterpart is easy to find:

- ``ops``     — the bloom filter (host build + device probe), the exact
                gram table, candidate compaction, the CUDA kernel loader.
- ``runtime`` — ``MatchSession`` (``engine="bloom"``, ``verify="host"``).
- ``utils``   — the explicit device resolver.

Host modules with no JAX in them are imported from the reference package,
not copied: ``core.*`` (DFA compiler, pattern parsing, native oracle),
``runtime.buffers``, ``runtime.verify``, ``runtime.stager_native`` and
``utils.common``/``utils.debug``. This package never imports ``jax``.
"""

__version__ = "0.1.0"

from tpu_pattern_matching.core.dfa import (  # noqa: F401
    AhoCorasick,
    DfaTable,
    compile_patterns,
)
