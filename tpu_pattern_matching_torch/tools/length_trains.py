"""Packet-length-train extractor (AC_ushorts/scripts/get_length_trains.c).

Parses per-flow ASCII traces produced by tshark (one packet per line, fields
separated by spaces, source IP at field 3, destination at field 5, payload
length as a ``Len=N`` token), where each file is named
``srcip-dstip-srcport-dstport``. Emits three signature-train files:

- ``tx.signatures``   — lengths of client->server packets
- ``rx.signatures``   — lengths of server->client packets
- ``txrx.signatures`` — both directions, server packets negated

one comma-separated line per flow, suitable as ``--ushort`` input or (after
adding ``; len; name``) as signatures.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_trace_line(line: str) -> tuple[str | None, str | None, int | None]:
    """(src_ip, dst_ip, payload_len) from one tshark text line."""
    toks = line.split()
    src = toks[2] if len(toks) > 2 else None
    dst = toks[4] if len(toks) > 4 else None
    length = None
    for tok in toks:
        if "Len=" in tok:
            try:
                length = int(tok.split("=", 1)[1])
            except ValueError:
                pass
            break
    return src, dst, length


def extract(trace_dir: str, out_dir: str = ".") -> tuple[str, str, str]:
    tx_path = os.path.join(out_dir, "tx.signatures")
    rx_path = os.path.join(out_dir, "rx.signatures")
    txrx_path = os.path.join(out_dir, "txrx.signatures")
    with open(tx_path, "a") as txf, open(rx_path, "a") as rxf, open(
        txrx_path, "a"
    ) as txrxf:
        for name in sorted(os.listdir(trace_dir)):
            path = os.path.join(trace_dir, name)
            if not os.path.isfile(path):
                continue
            parts = name.split("-")
            if len(parts) < 2:
                continue
            flow_src = parts[0]
            tx, rx, txrx = [], [], []
            with open(path, errors="replace") as f:
                for line in f:
                    src, _dst, length = parse_trace_line(line)
                    if length is None or src is None:
                        continue
                    if src == flow_src:
                        tx.append(str(length))
                        txrx.append(str(length))
                    else:
                        rx.append(str(length))
                        txrx.append(f"-{length}")
            txf.write(", ".join(tx) + "\n")
            rxf.write(", ".join(rx) + "\n")
            txrxf.write(", ".join(txrx) + "\n")
    return tx_path, rx_path, txrx_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    paths = extract(args.trace_dir, args.out_dir)
    print("\n".join(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
