"""Run statistics (the reference's stats block, ocl_aho_grep.c:601-631)."""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class RunStats:
    matches_total: int = 0
    matches_reported: int = 0
    bytes: int = 0
    lines: int = 0
    files: int = 0
    rounds: int = 0  # "kernel launches": one device scan per batch
    automaton_states: int = 0
    automaton_bytes: int = 0
    wall_us: int = 0

    @property
    def throughput_mbps(self) -> float:
        """Mbps = bytes*8 / 2**20 / secs (exact formula of ocl_aho_grep.c:628-630)."""
        if not self.wall_us:
            return 0.0
        return (self.bytes * 8 / 1048576) / (self.wall_us / 1e6)

    def render(self) -> str:
        """The reference's stats block, line-compatible labels."""
        out = [
            "-------------- STATS --------------",
            f"Matches:             {self.matches_total}",
            f"Matches reported:    {self.matches_reported}",
            f"Time (secs):         {self.wall_us / 1e6:.5f}",
            f"Automaton states:    {self.automaton_states}",
            f"Automaton size (MB): {self.automaton_bytes / 1048576:.3f}",
            f"Processed bytes:     {self.bytes}",
        ]
        if self.lines:
            out.append(f"Processed lines:     {self.lines}")
        out += [
            f"Processed files:     {self.files}",
            f"Kernel launches:     {self.rounds}",
            f"Throughput (Mbps):   {self.throughput_mbps:.3f}",
            "-----------------------------------",
            "",
        ]
        return "\n".join(out)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["throughput_mbps"] = self.throughput_mbps
        return json.dumps(d)
