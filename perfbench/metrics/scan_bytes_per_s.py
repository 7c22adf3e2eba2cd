"""Bytes scanned over the window per second (whole batches, from the
first batch's feed wait to the last decode)."""


def read(run):
    if run["unit"] != "bytes" or run["window_s"] <= 0:
        return None
    return run["symbols"] / run["window_s"]
