"""RMSNorm family: y = x * rsqrt(mean(x^2) + eps) * gain over the trailing
dim (plain version ``ref``, CUDA wrapper ``rmsnorm``, dispatching op
``ops.rmsnorm``; ``repro_torch.kernels.rmsnorm`` at the package level is
the op)."""
