"""The capacity and scale axes of the matcher (port of the reference's
``parallel/``): ``pshard`` partitions the pattern set into S shard
filters probed on one device. The reference's meshes (``parallel/mesh.py``
and pshard's ("pat", "data") grid) are not ported yet (ROADMAP queue 1,
item 11)."""
