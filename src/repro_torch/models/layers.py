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

On a mesh whose ``model`` axis splits a weight (``sharding.
split_on_model``: the SwiGLU hidden dim, the vocabulary) the layer runs
on each rank's shard in ``sharding.tp_map``, as GSPMD splits the
reference's products: ``mlp`` on its local columns of ``w_gate``/
``w_up`` and rows of ``w_down``, then one all-reduce (and with the
fsdp axes splitting the contraction, ``sharding.contraction_split``,
each rank's slice of d); ``embed`` a
masked lookup of the local vocabulary rows, then one all-reduce;
``logits_head`` the local vocabulary's logits (..., V/tp); and
``cross_entropy`` and ``greedy`` reduce their max, sum, gold logit or
index over ``model`` without gathering the logits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
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
    """Rows of ``table`` for integer ``tokens`` (any shape).  On a mesh
    the lookup runs on each rank's tokens (``sharding.tp_map``: DTensor's
    own ``index_put`` backward fails to propagate in some torch
    releases); a table split over ``model`` by vocabulary rows gives each
    rank's rows for the tokens it holds, zeros elsewhere, summed over
    ``model`` (exact: one rank holds each row)."""
    if not sharding.any_dtensor(table, tokens):
        return table[tokens]
    from torch.distributed.tensor import Partial
    mesh = (table if sharding.is_dtensor(table) else tokens).device_mesh
    rows = sharding.rows_of(tokens, mesh)
    if not sharding.split_on_model(table):
        return sharding.tp_map(lambda tab, tok: tab[tok], (table, tokens),
                               (None, None), rows)
    lo = sharding.model_offset(table, 0)

    def local(tab, tok):
        idx = tok - lo
        hit = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(hit[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
    out = sharding.tp_map(local, (table, tokens), (None, None),
                          sharding.with_model(rows, mesh, Partial()))
    return sharding.whole_on_model(out)


def logits_head(x: torch.Tensor, table: torch.Tensor,
                softcap: float = 0.0) -> torch.Tensor:
    """x (..., d) @ table.T (V, d) -> (..., V) float32: the operands
    widened exactly to float32, so the products and their sum are float32
    as with the JAX package's ``preferred_element_type``.  A table split
    over ``model`` gives each rank its vocabulary's logits, (..., V/tp),
    split over ``model`` on the last dim; a whole one (a vocabulary
    ``model`` does not divide) splits the tokens instead
    (``_token_split_head``)."""
    if sharding.split_on_model(table) or sharding.split_on_fsdp(table):
        from torch.distributed.tensor import Replicate, Shard
        split = Shard(x.dim() - 1) if sharding.split_on_model(table) \
            else Replicate()
        return sharding.tp_block(
            lambda p, a: logits_head(a, p["table"], softcap),
            {"table": table}, x, split_out=split)
    if sharding.is_dtensor(x) and sharding.model_width(x.device_mesh) > 1:
        out = _token_split_head(x, table, softcap)
        if out is not None:
            return out
    out = sharding.col_product(x.float(), table.float().t())
    if softcap:
        out = torch.tanh(out / softcap) * softcap
    return out


def _token_split_head(x: torch.Tensor, table: torch.Tensor, softcap: float):
    """The head of a DTensor x against a table whole on ``model``, each
    ``model`` rank on its part of the tokens (``sharding.tp_map``): of
    the sequence of a (B, S, d) x whose S ``model`` divides -- the logits
    come back split there (the training loss reduces them so) -- else
    of its local batch rows, the logits gathered back whole over
    ``model`` (the serving steps' (B, 1, d)); None where neither
    divides."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    width = sharding.model_width(mesh)
    rows = sharding.rows_of(x, mesh)
    local_b = x.shape[0] // sharding.axis_size(mesh, tuple(
        n for i, n in enumerate(mesh.mesh_dim_names)
        if rows[i].is_shard()))
    if x.dim() == 3 and x.shape[1] > 1 and x.shape[1] % width == 0:
        where = sharding.with_model(rows, mesh, Shard(1))
        return sharding.tp_map(lambda a, t: logits_head(a, t, softcap),
                               (x, table), (where, None), where)
    if local_b % width:
        return None
    return sharding.tp_map(
        lambda a, t: sharding.gather_on_model(logits_head(a, t, softcap), 0,
                                              mesh),
        (x, table), (sharding.with_model(rows, mesh, Shard(0)), None), rows)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the last dim, ties to the lowest index as
    ``torch.argmax``; on logits split over ``model`` by vocabulary, each
    rank's best is reduced to the global best (an all-reduce max), then
    the lowest index holding it (an all-reduce min) -- bit for bit the
    argmax of the gathered logits."""
    if not sharding.vocab_split(logits):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import Partial
    mesh = logits.device_mesh
    lo = sharding.model_offset(logits, logits.dim() - 1)
    vocab = logits.shape[-1]
    rows = sharding.rows_of(logits, mesh)
    best = sharding.whole_on_model(sharding.tp_map(
        lambda lg: lg.amax(dim=-1), (logits,), (None,),
        sharding.with_model(rows, mesh, Partial("max"))))

    def first(lg, b):
        at = torch.argmax(lg, dim=-1) + lo
        return torch.where(lg.amax(dim=-1) == b, at,
                           torch.full_like(at, vocab))
    return sharding.whole_on_model(sharding.tp_map(
        first, (logits, best), (None, None),
        sharding.with_model(rows, mesh, Partial("min"))))


# -- SwiGLU MLP ---------------------------------------------------------------

def mlp_init(generator: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    """SwiGLU weights: gate and up (d, d_ff), down (d_ff, d)."""
    return {
        "w_gate": dense_init(generator, d, d_ff, dtype),
        "w_up": dense_init(generator, d, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d, dtype, scale=d_ff ** -0.5),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x @ W_gate) * (x @ W_up) @ W_down in x's dtype; with the hidden
    dim split over ``model``, each rank's columns and rows, then one
    all-reduce of the partial sums."""
    w = params["w_gate"]
    if sharding.split_on_model(w) or sharding.split_on_fsdp(w):
        return sharding.tp_block(_mlp, params, x)
    return _mlp(params, x)


def _mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(sharding.col_product(x, params["w_gate"])) \
        * sharding.col_product(x, params["w_up"])
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
    if sharding.vocab_split(logits):
        nll = _nll(*_vocab_split_lse_gold(logits.float(), labels), z_loss)
    elif sharding.split_on_model(logits):    # tokens split over model
        where = tuple(logits.placements)
        nll = sharding.tp_map(
            lambda lg, y: _nll(*_lse_gold(lg.float(), y), z_loss),
            (logits, labels), (None, where), where)
    else:
        nll = _nll(*_lse_gold(logits.float(), labels), z_loss)
    mask = (labels >= 0).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll * mask).sum() / denom


def _nll(lse: torch.Tensor, gold: torch.Tensor, z_loss: float):
    """A token's loss: logsumexp less the gold logit, plus the z-loss."""
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return nll


def _lse_gold(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, the gold logit) of float32 logits a token."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    return lse, gold


def _vocab_split_lse_gold(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, the gold logit) over logits split over ``model`` by
    vocabulary: the max (detached: the logsumexp's gradient does not
    depend on it), the sum of exponentials and the gold logit (each rank
    the labels in its vocabulary, zero elsewhere) reduced over
    ``model``, as Megatron's vocabulary-parallel cross entropy."""
    from torch.distributed.tensor import Partial
    mesh = logits.device_mesh
    lo = sharding.model_offset(logits, logits.dim() - 1)
    rows = sharding.rows_of(logits, mesh)

    def part(op):
        return sharding.with_model(rows, mesh, Partial(op))
    m = sharding.whole_on_model(sharding.tp_map(
        lambda lg: lg.amax(dim=-1), (logits.detach(),), (None,), part("max")))
    sumexp = sharding.whole_on_model(sharding.tp_map(
        lambda lg, mx: torch.exp(lg - mx[..., None]).sum(dim=-1),
        (logits, m), (None, None), part("sum")))

    def gold_local(lg, y):
        idx = y.long() - lo
        hit = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(hit, g[..., 0], torch.zeros((), device=lg.device))
    gold = sharding.whole_on_model(sharding.tp_map(
        gold_local, (logits, labels.clamp_min(0)), (None, None), part("sum")))
    return m + torch.log(sumexp), gold
