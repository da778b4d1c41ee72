"""Flash attention family: causal, sliding-window GQA attention with an
online softmax (plain versions ``ref``, CUDA wrapper ``flash_attention``,
dispatching op ``ops.attention``, which ``repro_torch.kernels.attention``
is)."""
