"""The capacity and scale axes of the matcher (port of the reference's
``parallel/``): ``pshard`` partitions the pattern set into S shard
filters probed on one device; ``mesh`` is the data-parallel mesh on
``torch.distributed``, one lane shard per rank. pshard's ("pat", "data")
grid is not ported yet (ROADMAP queue 1, item 11b)."""
