"""Rotary position embedding family: the paper's rotation on head-dim
pairs (plain version ``ref`` with ``rope_tables``, CUDA wrapper ``rope``,
dispatching op ``ops.rope``; ``repro_torch.kernels.rope`` at the package
level is the op)."""
