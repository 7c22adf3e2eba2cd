"""Flow tokens scanned over the window per second (whole batches, from
the first scan call to the last decode)."""


def read(run):
    if run["unit"] != "tokens" or run["window_s"] <= 0:
        return None
    return run["symbols"] / run["window_s"]
