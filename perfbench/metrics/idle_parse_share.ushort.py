"""Of the device's idle time over the profiled batches, the share in
which the feeder threads were parsing, in % (the program's spans placed
on the trace's axis by its ``scan`` marks)."""

from perfbench.program_trace import idle_parse_share


def read(run):
    return idle_parse_share(run)
