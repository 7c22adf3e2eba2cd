"""PyTorch + CUDA port of ``tpu_pattern_matching`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package runs its
pipelines — the q-gram bloom probe with on-device exact-gram refinement
and host or device verify, and the dense DFA engine, over byte lanes or
uint16 packet-metadata lanes, on one device or on a data-parallel mesh of
``torch.distributed`` ranks — with every kernel hand-written in CUDA under
``csrc/``, and is held to the reference bit for bit by
``tests/test_torch_*.py``.

Layout mirrors the reference so each module's counterpart is easy to find:

- ``ops``     — the bloom filter (host build + device probe), the exact
                gram table, device verify, the dense table, walk and
                compaction, the CUDA kernel loader.
- ``runtime`` — ``MatchSession`` (``engine="bloom"`` with
                ``verify="host"`` or ``"device"``, ``engine="dense"``,
                ``pat_shards``, ``mesh``) and the ``--profile`` trace.
- ``parallel`` — pattern shards on one device (``pshard``) and the
                data-parallel mesh on ``torch.distributed`` (``mesh``).
- ``engine``  — the benchmark scan-total hook.
- ``entry``   — the entry point of the forward probe step and the
                multi-rank dry run (``dryrun_multichip``).
- ``tools``   — the fuzz campaign.
- ``ushort``  — the packet-metadata grep (``run_ushort_grep``).
- ``cli``     — ``torch_aho_grep``, the reference CLI's surface.
- ``apps``    — the sentiment app on the port's session and CLI.
- ``core``    — the DFA compiler, pattern-file parsing and the oracles
                (Python and native C++).
- ``utils``   — the explicit device resolver, small helpers, debug log
                (``kernel_debug``), the card's peaks and timers.

This package imports nothing of the reference package and never imports
``jax``. The reference's host modules that it needs are copied here under
the same names (``core.*``, ``runtime.buffers``, ``runtime.verify``,
``runtime.feeder``, ``runtime.files``, ``runtime.stats``,
``runtime.stager_native``, ``utils.common``, ``utils.debug``,
``runtime.tracing.PhaseTimer``, the sentiment app's counters), with the
native oracle and stager sources in ``csrc/``; ``tests/test_torch_copies.py``
holds them equal to the reference.
"""

__version__ = "0.1.0"

from tpu_pattern_matching_torch.core.dfa import (  # noqa: F401
    AhoCorasick,
    DfaTable,
    compile_patterns,
)
