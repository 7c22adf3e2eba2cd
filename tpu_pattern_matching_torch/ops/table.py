"""Device-resident DFA table (torch port of the reference's
``ops/table.py``).

The compiled automaton on one torch device: the flat signed transition
table, kept in the dtype the compiler chose (int16 below 2^15 states,
int32 above), plus the small per-state match side tables that resolve a
matched state to its match group and representative pattern.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_pattern_matching_torch.core.dfa import DfaTable


@dataclasses.dataclass
class DeviceTable:
    """DFA arrays on a torch device + static metadata.

    ``table_flat[s * A + c]`` = next state, negated iff final (match).
    ``state_gid`` / ``group_rep`` resolve matched states to match groups
    and representative pattern indices after compaction."""

    table_flat: torch.Tensor  # [S * A] int16 or int32
    state_gid: torch.Tensor  # [S] int32
    group_rep: torch.Tensor  # [G] int32
    alphabet_size: int
    max_pat_len: int
    num_states: int
    num_groups: int
    num_patterns: int

    @staticmethod
    def put(table: DfaTable, device) -> "DeviceTable":
        """Upload a compiled table to ``device``."""

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return DeviceTable(
            table_flat=up(table.goto_signed.reshape(-1)),
            state_gid=up(table.state_gid.astype(np.int32)),
            group_rep=up(table.group_rep.astype(np.int32)),
            alphabet_size=table.alphabet_size,
            max_pat_len=table.max_pat_len,
            num_states=table.num_states,
            num_groups=table.num_groups,
            num_patterns=table.num_patterns,
        )

    @property
    def nbytes(self) -> int:
        return self.table_flat.numel() * self.table_flat.element_size()
