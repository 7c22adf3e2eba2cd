"""Pattern file parsing.

Reproduces the reference's pattern ingestion behavior:

- ``load_pattern_file``: the byte-alphabet formats handled by
  ocl_worker_ctx_init (ocl_worker.c:73-145): one pattern per line;
  auto-detected "categorical" ``ID PATTERN`` format when the first line starts
  with an integer token (ocl_worker.c:79-102); surrounding double quotes
  stripped (ocl_worker.c:125-129); optional printable-hex decoding (``-x``,
  ocl_worker.c:131-136); optional pattern-size truncation (``-m``,
  ocl_worker.c:132-139).
- ``load_signature_file``: the ushort-alphabet metadata-signature format of
  AC_ushorts (README:14-24, iacsmx.c:418-451):
  ``"40,32,287,...; 22; attack name"`` — comma-separated ushort sequence,
  sequence length, free-text label.
- ``parse_flow_line``: comma-separated ushort input lines (AC_ushorts
  databuf.c:154-190).
"""

from __future__ import annotations

import dataclasses
import re

from tpu_pattern_matching_torch.utils.common import hex_to_bytes

_LEAD_DIGITS = re.compile(r"\d+")

MAX_PAT_SIZE = 4096  # reference utils.h:14


@dataclasses.dataclass
class ParsedPattern:
    data: bytes | tuple[int, ...]
    iid: int
    label: str


def _detect_categorical(first_line: str) -> bool:
    """True if the first line looks like ``ID PATTERN`` (ocl_worker.c:79-102).

    The reference checks that everything before the first whitespace is
    digits, allowing a leading ``+``/``-`` sign.
    """
    token = first_line.split(None, 1)[0] if first_line.split() else first_line
    if not token:
        return False
    body = token[1:] if token[0] in "+-" else token
    return bool(body) and body.isdigit()


def load_pattern_file(
    path: str,
    hex_pat: bool = False,
    pat_size_limit: int = -1,
) -> list[ParsedPattern]:
    """Parse a byte-alphabet pattern file, one pattern per line."""
    out: list[ParsedPattern] = []
    categ = False
    with open(path, "r", errors="surrogateescape") as fp:
        for i, raw in enumerate(fp):
            line = raw.rstrip("\n")
            if i == 0:
                categ = _detect_categorical(line)
            if not line:
                continue
            if categ:
                parts = line.split(None, 1)
                try:
                    iid = int(parts[0])
                except ValueError:
                    continue
                pattern = parts[1] if len(parts) > 1 else ""
            else:
                iid = i
                pattern = line
            if len(pattern) >= 2 and pattern[0] == '"' and pattern[-1] == '"':
                pattern = pattern[1:-1]
            if not pattern:
                continue
            if hex_pat:
                if pat_size_limit != -1:
                    pattern = pattern[: pat_size_limit * 2]
                data = hex_to_bytes(pattern)
            else:
                if pat_size_limit != -1:
                    pattern = pattern[:pat_size_limit]
                data = pattern.encode("utf-8", errors="surrogateescape")
            if not data:
                continue
            out.append(ParsedPattern(data=data, iid=iid, label=pattern))
    return out


def load_signature_file(path: str, max_tokens: int = 16) -> list[ParsedPattern]:
    """Parse the ushort metadata-signature format (AC_ushorts/README:14-24).

    Each line: ``seq ; length ; label`` where ``seq`` is comma-separated
    unsigned shorts. ``max_tokens`` mirrors MAX_PATT_LEN (iacsmx.c:11): the
    sequence is truncated to the first ``max_tokens`` values.
    """
    out: list[ParsedPattern] = []
    with open(path, "r") as fp:
        for i, raw in enumerate(fp):
            line = raw.strip()
            if not line:
                continue
            parts = line.split(";")
            seq_txt = parts[0]
            label = parts[2].strip() if len(parts) > 2 else ""
            # leading-digits parse, like the reference's atoi
            # (iacsm_add_fullpattern, AC_ushorts/iacsmx.c:418-451): its
            # own shipped traces carry tshark noise such as
            # "1460[Reassembly..." which atoi reads as 1460. Delta: a
            # token with NO leading digits is skipped rather than
            # silently inserted as 0 (what atoi would do).
            seq = tuple(
                int(m.group())
                for tok in seq_txt.split(",")
                if (m := _LEAD_DIGITS.match(tok.strip()))
            )[:max_tokens]
            if not seq:
                continue
            out.append(ParsedPattern(data=seq, iid=i, label=label or seq_txt))
    return out


def parse_flow_line(line: str) -> list[int]:
    """Parse one comma/semicolon-separated ushort input line
    (AC_ushorts/databuf.c:154-190)."""
    vals: list[int] = []
    for tok in line.replace(";", ",").split(","):
        tok = tok.strip()
        if tok:
            try:
                vals.append(int(tok) & 0xFFFF)
            except ValueError:
                continue
    return vals
