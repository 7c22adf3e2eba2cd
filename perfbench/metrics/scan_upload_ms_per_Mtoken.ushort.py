"""Host ms of the window's ``scan.upload`` spans (the batch's copies to
the device inside ``MatchSession.scan``) per million tokens they
carried."""

from perfbench.program_trace import ms_per_mtoken, window_spans


def read(run):
    spans = window_spans(run, "scan.upload")
    if spans is None:
        return None
    return ms_per_mtoken(sum(r.t1 - r.t0 for r in spans),
                         sum(r.work for r in spans))
