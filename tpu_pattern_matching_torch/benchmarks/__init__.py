"""Experiments of the port: counterparts of the reference's ``benchmarks/``
scripts that hold a kernel (``exp_bloom``, the prototype bloom probe)."""
