"""Host ms of the window's ``scan.upload`` spans (the batch's copies to
the device inside ``MatchSession.scan``) per GiB they carried, over the
part of the window whose records the program's ring still holds."""

from perfbench.program_trace import kept_window_spans, ms_per_gib


def read(run):
    spans = kept_window_spans(run, "scan.upload", "bytes")
    if not spans:
        return None
    return ms_per_gib(sum(r.t1 - r.t0 for r in spans),
                      sum(r.work for r in spans))
