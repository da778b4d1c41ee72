"""Mamba-2 SSD intra-chunk family (plain version ``ref``, CUDA wrapper
``ssd``, dispatching op ``ops.ssd_intra``)."""
