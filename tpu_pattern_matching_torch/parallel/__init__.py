"""The capacity and scale axes of the matcher (port of the reference's
``parallel/``): ``pshard`` partitions the pattern set into S shard
filters, probed on one device or spread over the ranks of the ("pat",
"data") grid; ``mesh`` is the data-parallel mesh on
``torch.distributed``, one lane shard per rank."""
