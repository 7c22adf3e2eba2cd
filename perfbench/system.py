"""The system under test, built from a configuration as the grep CLI of
the port builds it: the CLI's argument parser and checks, then, for a
``--ushort`` configuration, what ``ushort.run_ushort_grep`` builds (its
signature compiler ``ushort.compile_signatures``, its session and its
feeder of ``UshortBuffer`` lanes), and for any other, what ``cli.run``
builds (``cli.compile_table``, its session and its feeder of byte
lanes). The feeder is ``cli.rank_feeder`` in both."""

from __future__ import annotations

import numpy as np


def cli_args(config: dict, corpus_dir: str, sig_path: str, device: str):
    from tpu_pattern_matching_torch import cli

    argv = ["-f", corpus_dir, "-p", sig_path, "--device", device,
            *config["cli"]]
    args = cli.build_argparser().parse_args(argv)
    cli.raise_nofile_limit()
    cli.check_args(args)
    cli.align_parameters(args)
    return args


def build(config: dict, args, device):
    """``(session, make_feeder, iid_of)`` as the CLI builds them for
    ``args``: ``make_feeder(filenames)`` gives the CLI's ``Feeder``;
    ``iid_of[pattern index]`` is the id the CLI prints for a pattern."""
    from tpu_pattern_matching_torch import cli
    from tpu_pattern_matching_torch.runtime.buffers import UshortBuffer
    from tpu_pattern_matching_torch.runtime.session import MatchSession
    from tpu_pattern_matching_torch.ushort import compile_signatures

    if not args.ushort:
        return build_bytes(args, device)
    engine = args.engine
    if engine == "auto":
        engine = "bloom" if device.type == "cuda" else "dense"
    if args.pat_shards > 1:
        engine = "bloom"
    table = compile_signatures(args.pat_path, max_tokens=16)
    chunk = max(16, args.chunk_size // 2)  # tokens per lane
    sess = MatchSession(
        table, max_chunks=args.global_ws, chunk_len=chunk,
        max_results=args.max_results, sort=args.sort, engine=engine,
        verify=args.verify, device=device, pat_shards=args.pat_shards,
        mesh=cli.mesh_spec(args))

    def make_feeder(filenames):
        return cli.rank_feeder(sess, filenames, n_workers=args.thread_no,
                               max_chunks=sess.local_chunks, chunk_len=chunk,
                               halo=sess.halo, follow=False,
                               buffer_factory=UshortBuffer)

    iid_of = np.array([p.iid for p in table.patterns], np.int64)
    return sess, make_feeder, iid_of


def build_bytes(args, device):
    """:func:`build` for a byte configuration, as ``cli.run`` builds it."""
    from tpu_pattern_matching_torch import cli
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    table = cli.compile_table(args)
    bloom_table = cli.load_bloom(args.load_bloom) if args.load_bloom else None
    sess = MatchSession(
        table, max_chunks=args.global_ws, chunk_len=args.chunk_size,
        max_results=args.max_results, sort=args.sort or args.sort_global,
        engine=args.engine, verify=args.verify, device=device,
        bloom_table=bloom_table, pat_shards=args.pat_shards,
        mesh=cli.mesh_spec(args))

    def make_feeder(filenames):
        return cli.rank_feeder(sess, filenames, n_workers=args.thread_no,
                               max_chunks=sess.local_chunks,
                               chunk_len=args.chunk_size, halo=sess.halo,
                               text_mode=args.text_mode, follow=False)

    iid_of = np.array([p.iid for p in table.patterns], np.int64)
    return sess, make_feeder, iid_of
