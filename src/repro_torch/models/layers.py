"""Shared layers, the port of the JAX package's ``models/layers.py``.

Every residual add routes through the paper's vector-vector primitive
(``kernels.vecadd``, the ``vecadd_2d`` kernel) and every norm through the
derived-scalar scaling kernel (``kernels.rmsnorm``, ``rmsnorm_2d``): the
model stack is built out of the paper's linear-algebra classes.  The
embedding, the logits head and the SwiGLU MLP are plain torch products,
as the JAX package leaves them to XLA outside any Pallas kernel; so is
the add of ``sinusoidal_positions`` (whisper's positions), a plain
``+`` in the callers as in the reference.  ``cross_entropy`` is the
training loss, plain torch as the reference's is plain jnp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as k_rmsnorm
from repro_torch.kernels import vecadd as k_vecadd


def residual_add(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Paper section 5.1 vector-vector op as the residual connection."""
    return k_vecadd(x, delta)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the trailing dim through the ``rmsnorm_2d`` kernel."""
    return k_rmsnorm(x, gain, eps=eps)


# -- dense / embedding --------------------------------------------------------

def normal(generator: torch.Generator, shape: tuple, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """A float32 standard normal draw on the generator's device, times
    ``scale``, rounded to ``dtype`` (the JAX package's init recipe)."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)
    return (out * scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """A (d_in, d_out) weight, normal with std d_in**-0.5 by default."""
    scale = scale if scale is not None else d_in ** -0.5
    return normal(generator, (d_in, d_out), scale, dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    """A (vocab, d) standard normal embedding table."""
    return normal(generator, (vocab, d), 1.0, dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for integer ``tokens`` (any shape)."""
    return table[tokens]


def logits_head(x: torch.Tensor, table: torch.Tensor,
                softcap: float = 0.0) -> torch.Tensor:
    """x (..., d) @ table.T (V, d) -> (..., V) float32: the operands
    widened exactly to float32, so the products and their sum are float32
    as with the JAX package's ``preferred_element_type``."""
    out = torch.matmul(x.float(), table.float().t())
    if softcap:
        out = torch.tanh(out / softcap) * softcap
    return out


# -- SwiGLU MLP ---------------------------------------------------------------

def mlp_init(generator: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    """SwiGLU weights: gate and up (d, d_ff), down (d_ff, d)."""
    return {
        "w_gate": dense_init(generator, d, d_ff, dtype),
        "w_up": dense_init(generator, d, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d, dtype, scale=d_ff ** -0.5),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x @ W_gate) * (x @ W_up) @ W_down in x's dtype."""
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# -- positions ---------------------------------------------------------------

def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Classic transformer sinusoids (whisper's position encoding):
    positions (S,) -> (S, d) float32, sin then cos over d // 2
    frequencies 10000**(-i / max(d // 2 - 1, 1))."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / max(half - 1, 1))
    ang = positions.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- losses --------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean cross entropy in float32 with a z-loss (``z_loss *
    logsumexp**2`` a token); labels below 0 are masked out and the
    denominator is floored at 1."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll * mask).sum() / denom
