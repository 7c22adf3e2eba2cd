"""Set-up seconds: process start to the first timed batch (imports,
inputs, table and filter build, kernel load, warm-up)."""


def read(run):
    return run["setup_s"]
