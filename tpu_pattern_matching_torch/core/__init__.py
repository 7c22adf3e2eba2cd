from tpu_pattern_matching_torch.core.dfa import AhoCorasick, DfaTable, Pattern  # noqa: F401
