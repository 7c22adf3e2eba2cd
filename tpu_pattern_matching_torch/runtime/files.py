"""Input path handling (reference file_traverse.c).

``expand_paths`` reproduces the CLI's input rules (ocl_aho_grep.c:509-555):
the ``-f`` argument may be a directory (expanded to all regular files, like
get_all_regular_files, file_traverse.c:107-166), a single file, or multiple
comma-separated files; FIFOs are accepted for follow mode.
"""

from __future__ import annotations

import os
import stat


def is_regular_file(path: str) -> bool:
    try:
        return stat.S_ISREG(os.stat(path).st_mode)
    except OSError:
        return False


def is_fifo(path: str) -> bool:
    try:
        return stat.S_ISFIFO(os.stat(path).st_mode)
    except OSError:
        return False


def is_directory(path: str) -> bool:
    return os.path.isdir(path)


def get_all_regular_files(directory: str) -> list[str]:
    """All regular files directly inside ``directory`` (non-recursive, like
    the reference's readdir loop, file_traverse.c:107-166)."""
    out = []
    with os.scandir(directory) as it:
        for entry in sorted(it, key=lambda e: e.name):
            if entry.is_file(follow_symlinks=True):
                out.append(entry.path)
    return out


def expand_paths(data_path: str) -> list[str]:
    """Expand the ``-f`` argument to an ordered list of openable inputs."""
    if is_directory(data_path):
        return get_all_regular_files(data_path)
    files = [p for p in data_path.split(",") if p]
    return [p for p in files if is_regular_file(p) or is_fifo(p)]
