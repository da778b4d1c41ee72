"""Sharding rules: parameter, optimizer, batch and cache specs over a
``DeviceMesh``, the port of the JAX package's ``distributed/sharding.py``.

Layout: mesh axes ``("pod", "data", "model")`` or ``("data", "model")``.

  * ``fsdp`` = ("pod", "data") -- ZeRO-3 weight shard + batch shard,
  * ``tp``   = "model"         -- Megatron-style tensor parallel.

A spec is a tuple with one entry a tensor dim: None (whole), a mesh
axis name, or a tuple of names (the dim split over their product, the
first major), as a JAX ``PartitionSpec``.  ``placements`` turns it into
DTensor placements, one a mesh dim.

The port's parameters are a list of per-layer dicts, where the JAX
package stacks the layers on a leading axis; its expert weights are (E,
d, ff).  The rules therefore match a leaf's *name* (``wq``, ``w_gate``,
``router``...) and act on its last two dims, so every port leaf's local
shard is the reference's shard with the layer axis dropped.

KV caches: heads shard over ``model`` when divisible; otherwise the
cache *length* dim does (sequence-sharded decode).  ``attn_layout`` says
how attention's full-sequence work splits over ``model`` for a config
(by heads, by query heads with their kv group, or by the sequence); the
local bodies gather activations over ``model`` (``stack_on_model``,
``cols_on_model``) and end in a row product's partial sum
(``rows_on_model``), never gathering a weight.

``constrain`` is the activation constraint: a no-op for a plain tensor
and off a mesh; on a DTensor it redistributes to the named placements.
``gathered`` is the ZeRO-3 use of a parameter: its DTensor redistributed
to whole on every rank, whose backward reduces the gradient back to the
parameter's shards; ``gathered(keep_model=True)`` is the Megatron use:
the leaf gathered over the fsdp axes only, a col or row leaf keeping
its ``model`` shard.  ``tp_block`` runs a block's body on every rank's
local shards -- its heads, its hidden columns -- in plain tensors (the
split products GSPMD makes of the reference's specs) and then the one
all-reduce over ``model`` of its row product's partial sums.  Where the
batch does not split over the fsdp axes (a batch-1 decode) and no
gradient is recorded, the fsdp axes split the block's contractions
instead, as XLA splits the reference's products there
(``contraction_split``, ``col_product``).
"""
from __future__ import annotations

import contextlib
import re
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:  # the models import this module (constrain)
    from repro_torch.models.config import ModelConfig

#: the ambient meshes, innermost last (``mesh_context``)
_MESHES: list = []
#: redistributions inserted by ``constrain`` and the kernel ops
_REDISTRIBUTIONS = {"constrain": 0, "kernel": 0}


def ambient_mesh():
    """The mesh of the innermost ``mesh_context``, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh inside (nests; resets on exit)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def redistribution_counts() -> dict[str, int]:
    """Redistributions since the last reset, by the site that asked."""
    return dict(_REDISTRIBUTIONS)


def reset_redistribution_counts() -> None:
    for k in _REDISTRIBUTIONS:
        _REDISTRIBUTIONS[k] = 0


def is_dtensor(x) -> bool:
    if type(x) in _PLAIN:          # the hot path imports nothing
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def axis_names(mesh) -> tuple[tuple[str, ...], str]:
    """(the fsdp axes in mesh order, the tp axis name)."""
    tp = "model"
    return tuple(n for n in mesh.mesh_dim_names if n != tp), tp


def axis_size(mesh, axes) -> int:
    """The product of the named axes' sizes (1 for none)."""
    names = mesh.mesh_dim_names
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= mesh.shape[names.index(a)]
    return n


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists;
    the path joins the keys and indices with ``/`` (``layers/3/attn/wq``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(
            fn, v, *(r[i] for r in rest),
            path=f"{path}/{i}" if path else str(i))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _map_specs(fn, spec_tree, *rest):
    """``fn`` over the specs (tuples) of a spec tree and matching leaves."""
    if _is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(spec_tree)]
    raise TypeError(f"not a spec tree: {spec_tree!r}")


# ---------------------------------------------------------------------------
# parameters, optimizer state, batches, caches
# ---------------------------------------------------------------------------

_COL = "col"   # (.., d_in, d_out_tp):  (fsdp, tp)
_ROW = "row"   # (.., d_in_tp, d_out):  (tp, fsdp)
_PARAM_RULES: list[tuple[str, str]] = [
    (r"(^|/)(embed|unembed)$", "embed"),           # (V, d): (tp, fsdp)
    (r"(^|/)(wq|wk|wv)$", _COL),
    (r"(^|/)(w_gate|w_up)$", _COL),
    (r"(^|/)in_proj$", _COL),
    (r"(^|/)router$", "router"),                   # (d, E): (fsdp, None)
    (r"(^|/)(wo|w_down|out_proj)$", _ROW),
    # conv_w stays replicated: its channel layout is (heads x headdim)
    # interleaved, which a model-axis shard cannot re-express after the
    # (B,S,di)->(B,S,h,p) reshape
    (r"(^|/)conv_w$", "replicate"),
]


def param_spec(path_str: str, ndim: int, fsdp, tp) -> tuple:
    """The spec of the parameter at ``path_str`` of ``ndim`` dims: its
    rule's entries on the last two dims, the leading ones whole."""
    if ndim <= 1:
        return (None,) * ndim
    lead = (None,) * (ndim - 2)
    for pattern, kind in _PARAM_RULES:
        if re.search(pattern, path_str):
            if kind in ("embed", _ROW):
                return (*lead, tp, fsdp)
            if kind == _COL:
                return (*lead, fsdp, tp)
            if kind == "router":
                return (*lead, fsdp, None)
            return (*lead, None, None)
    return (*lead, None, None)                     # unknown 2D+: whole


def params_specs(params_shape, mesh):
    """The spec tree of a parameter (or shape) tree."""
    fsdp, tp = axis_names(mesh)
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, len(leaf.shape), fsdp, tp),
        params_shape)


def opt_specs(opt_shape, pspecs):
    """The optimizer state mirrors the parameters' specs (float32)."""
    return {"step": (), "master": pspecs, "m": pspecs, "v": pspecs}


def batch_specs(batch_shape, mesh, *, accum_dim: bool):
    """A training batch (accum, micro, ...) or a serving batch (B, ...):
    the batch dim shards over all the fsdp axes."""
    fsdp, _ = axis_names(mesh)

    def spec(_, leaf):
        n = len(leaf.shape)
        if accum_dim:
            return (None, fsdp, *(None,) * (n - 2))
        return (fsdp, *(None,) * (n - 1))

    return tree_map_with_path(spec, batch_shape)


def cache_specs(cache_shape, cfg: "ModelConfig", mesh):
    """Specs of the serving cache (a list of per-layer caches: attention,
    SSM, hybrid, enc-dec), each leaf's the reference's without the
    layer axis."""
    fsdp, tp = axis_names(mesh)
    heads = bool(cfg.n_kv_heads) and cfg.n_kv_heads % axis_size(mesh, tp) == 0

    def spec(path, leaf):
        n = len(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        if name == "kpos":
            return (None,) * n
        if name == "state":                        # (B, h, p, n)
            return (fsdp, None, tp, None)
        if name == "conv":                         # (B, w-1, ch)
            return (fsdp, None, tp)
        # attention k/v (self or cross) and int8 scales: (B, Hkv, T, D)
        return (fsdp, tp, None, None) if heads else (fsdp, None, tp, None)

    return tree_map_with_path(spec, cache_shape)


def sanitize_specs(shape_tree, spec_tree, mesh):
    """Drop spec axes whose mesh size does not divide the tensor dim: odd
    vocabularies (32001, 49155, 50280, 51865) and batch-1 cells fall back
    to whole on that dim, as the reference's arguments do."""
    def fix(spec, leaf):
        dims = tuple(getattr(leaf, "shape", ()))
        return tuple(
            None if a is None or i >= len(dims)
            or dims[i] % axis_size(mesh, a) else a
            for i, a in enumerate(spec))

    return _map_specs(fix, spec_tree, shape_tree)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim that
    shards tensor dim d, ``Replicate()`` on the rest -- and on a mesh dim
    of size 1, which splits nothing (the same local shard; DTensor cannot
    propagate every shard of a size-1 dim through a view)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            j = names.index(a)
            if mesh.size(j) > 1:
                out[j] = Shard(d)
    return tuple(out)


def to_shardings(spec_tree, mesh, shape_tree=None):
    """A tree of ``(mesh, placements)``, the specs first sanitized against
    ``shape_tree`` when it is given."""
    if shape_tree is not None:
        spec_tree = sanitize_specs(shape_tree, spec_tree, mesh)
    return _map_specs(lambda s: (mesh, placements(s, mesh)), spec_tree)


def shard_map(f, *, mesh, in_specs, out_specs, in_grad_specs=None):
    """``f`` on every rank's local shards: a thin ``local_map``, the
    counterpart of ``jax.shard_map``, with specs in place of
    placements."""
    from torch.distributed.tensor.experimental import local_map

    def pl(specs):
        return None if specs is None else tuple(
            None if s is None else placements(s, mesh) for s in specs)
    # one output's placements go as a list (a tuple holds one per output)
    outs = list(placements(out_specs, mesh)) if _is_spec(out_specs) \
        else pl(out_specs)
    return local_map(f, out_placements=outs, in_placements=pl(in_specs),
                     in_grad_placements=pl(in_grad_specs), device_mesh=mesh,
                     redistribute_inputs=True)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def constrain(x, *axes):
    """Best-effort activation constraint under the ambient mesh.

    ``axes`` name mesh axes per dim ("batch" expands to all the fsdp
    axes); axes missing from the mesh or not dividing the dim are
    dropped, and with nothing left the call is a no-op.  A plain tensor,
    or no mesh, passes through; a DTensor is redistributed to the
    placements (every dim not named whole; a mesh dim of size 1 is
    ``Replicate()``, see ``placements``)."""
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    names = set(mesh.mesh_dim_names)
    fsdp = tuple(n for n in ("pod", "data") if n in names)
    spec = []
    for i, ax in enumerate(axes):
        group = () if ax is None else fsdp if ax == "batch" else \
            (ax,) if isinstance(ax, str) else tuple(ax)
        group = tuple(a for a in group if a in names)
        size = axis_size(mesh, group)
        spec.append(None if not group or x.shape[i] % size else group)
    if all(s is None for s in spec):
        return x
    dmesh = x.device_mesh
    # a size-1 mesh dim keeps a partial sum (it is the identity there)
    want = tuple(p if dmesh.size(j) == 1 and p.is_partial() else w
                 for j, (w, p) in enumerate(zip(
                     placements(tuple(spec), dmesh), x.placements)))
    if tuple(x.placements) == want:
        return x
    _REDISTRIBUTIONS["constrain"] += 1
    return x.redistribute(x.device_mesh, want)


def whole(x):
    """``x`` replicated on every rank: a DTensor redistributed to
    ``Replicate()`` everywhere (differentiable), anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gathered(tree, *, keep_model: bool = False, keep_fsdp: bool = False):
    """Every DTensor leaf of a parameter tree gathered for use: whole by
    default, the ZeRO-3 all-gather.  ``keep_model``: a leaf split over
    ``model`` keeps that split (a col leaf's output columns, a row leaf's
    input rows, a table's vocabulary rows), gathered over the fsdp axes
    only -- the Megatron use.  ``keep_fsdp``: a split over the fsdp axes
    is kept too, for a block whose contractions the fsdp axes split
    (``contraction_split``).  The backward reduce-scatters the gradient
    to the leaf's shards over the axes gathered.  A tree of plain tensors
    comes back as it is."""
    if isinstance(tree, dict):
        return {k: gathered(v, keep_model=keep_model, keep_fsdp=keep_fsdp)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gathered(v, keep_model=keep_model,
                                   keep_fsdp=keep_fsdp) for v in tree)
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate
    mesh = tree.device_mesh
    j = model_dim(mesh)
    want = tuple(p if p.is_shard() and (keep_model if i == j else keep_fsdp)
                 else Replicate() for i, p in enumerate(tree.placements))
    if tuple(tree.placements) == want:
        return tree
    return tree.redistribute(mesh, want)


def model_dim(mesh) -> int | None:
    """The index of the ``model`` mesh dim, or None."""
    names = mesh.mesh_dim_names
    return names.index("model") if "model" in names else None


def model_width(mesh=None) -> int:
    """The ``model`` axis size of ``mesh`` (the ambient one by default; 1
    off a mesh or without the axis)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    j = None if mesh is None else model_dim(mesh)
    return 1 if j is None else mesh.size(j)


def split_on_model(t) -> bool:
    """Whether ``t`` is a DTensor split along some dim over a ``model``
    axis wider than 1 (a col or row leaf ``gathered`` with
    ``keep_model``, a vocabulary-split logit)."""
    if not is_dtensor(t):
        return False
    j = model_dim(t.device_mesh)
    return j is not None and t.device_mesh.size(j) > 1 \
        and t.placements[j].is_shard()


def vocab_split(t) -> bool:
    """Whether ``t`` (logits) is split over ``model`` on its last dim
    (a table split by vocabulary gives them so)."""
    if not split_on_model(t):
        return False
    return t.placements[model_dim(t.device_mesh)].dim == t.dim() - 1


def with_model(where: tuple, mesh, placement) -> tuple:
    """``where`` (placements) with ``placement`` on the ``model`` dim."""
    j = model_dim(mesh)
    return tuple(placement if i == j else p for i, p in enumerate(where))


def rows_of(t, mesh) -> tuple:
    """Placements for a tensor split on its batch dim as ``t`` is (a
    DTensor: its splits over the fsdp dims; a plain tensor: whole), whole
    on ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    j = model_dim(mesh)
    if not is_dtensor(t):
        return (Replicate(),) * mesh.ndim
    return tuple(Replicate() if i == j or not p.is_shard()
                 else Shard(p.dim) for i, p in enumerate(t.placements))


def model_offset(t, dim: int) -> int:
    """This rank's first global index along ``dim`` of a DTensor split
    along ``dim`` over ``model`` alone (a vocabulary-split table or
    logit, a cache split by slots); 0 where ``model`` does not split
    ``dim``."""
    j = model_dim(t.device_mesh)
    p = t.placements[j] if j is not None else None
    if p is None or not p.is_shard() or p.dim != dim:
        return 0
    return model_rank(t.device_mesh) * t.to_local().shape[dim]


def tp_map(fn, args: tuple, where: tuple, out_where):
    """``fn(*args)`` on every rank's local shards, in plain tensors: a
    block's body at its ``model``-local shapes.

    ``args`` are tensors or dicts of tensors.  ``where[i]`` is the
    placements every DTensor leaf of ``args[i]`` is redistributed to
    first (a plain leaf is placed whole and then so), or None to take
    the leaves as they are (a plain leaf is used as it is, the same on
    every rank).  Each DTensor leaf's gradient comes back split where the
    leaf is and partial on every other mesh dim that some argument
    splits (its local use was one part of a split computation).
    ``out_where`` is the placements of the output (a tensor):
    ``Partial()`` on ``model`` for a row product's partial sum
    (``whole_on_model`` reduces it), ``Shard(d)`` for a split output."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.utils import _pytree as pytree
    flat, spec = pytree.tree_flatten(list(args))
    # the top-level argument of each flat leaf
    owner = []
    for i, a in enumerate(args):
        owner += [i] * len(pytree.tree_leaves(a))
    mesh = next(t.device_mesh for t in flat if isinstance(t, DTensor))
    placed = []
    for t, i in zip(flat, owner):
        want = where[i]
        if isinstance(t, torch.Tensor) and want is not None:
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                       run_check=False)
            if tuple(t.placements) != tuple(want):
                t = t.redistribute(mesh, tuple(want))
        placed.append(t)
    split = [any(isinstance(t, DTensor) and t.placements[j].is_shard()
                 for t in placed) for j in range(mesh.ndim)]
    local = []
    for t in placed:
        if isinstance(t, DTensor):
            grads = tuple(p if p.is_shard() else
                          Partial() if split[j] else Replicate()
                          for j, p in enumerate(t.placements))
            t = t.to_local(grad_placements=grads)
        local.append(t)
    out = fn(*pytree.tree_unflatten(local, spec))
    return _from_local(out.contiguous(), mesh, tuple(out_where))


#: the running ``tp_block`` bodies whose col products the fsdp axes
#: split: (mesh, the fsdp mesh dims), innermost last
_CONTRACTING: list = []


def fsdp_dims(mesh) -> tuple:
    """The fsdp mesh dims (every dim but ``model``) wider than 1."""
    j = model_dim(mesh)
    return tuple(i for i in range(mesh.ndim) if i != j and mesh.size(i) > 1)


def split_on_fsdp(t) -> bool:
    """Whether ``t`` is a DTensor split over an fsdp axis wider than 1."""
    return is_dtensor(t) and any(t.placements[i].is_shard()
                                 for i in fsdp_dims(t.device_mesh))


def contraction_split(x) -> bool:
    """Whether the fsdp axes split the dense contractions of a block fed
    ``x`` instead of its batch: no gradient recorded, a DTensor ``x``
    whole over fsdp axes wider than 1 (a batch they do not divide: a
    batch-1 decode).  The reference's XLA keeps its col and row leaves'
    fsdp shards there and splits their products; gathering them would
    repeat each product on every fsdp rank."""
    if torch.is_grad_enabled() or not is_dtensor(x):
        return False
    dims = fsdp_dims(x.device_mesh)
    return bool(dims) and not any(x.placements[i].is_shard() for i in dims)


def col_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; inside a ``tp_block`` body whose contractions the fsdp
    axes split, x and w hold this rank's slice of the contracted dim and
    the partial products are summed over those axes (functional
    all-reduces)."""
    y = x @ w
    if _CONTRACTING:
        from torch.distributed import _functional_collectives as funcol
        mesh, dims = _CONTRACTING[-1]
        for i in dims:
            y = _wait(funcol.all_reduce(y, "sum", (mesh, i)))
    return y


def attn_layout(cfg: "ModelConfig", width: int) -> str:
    """How a ``model`` axis of ``width`` splits attention's full-sequence
    work, the reference's col/row specs whatever the head counts:

      * ``"heads"``: it divides both head counts (or is 1) -- each rank
        its query and kv heads;
      * ``"groups"``: it divides the query heads and each rank's query
        heads share one kv head (yi-6b's 32/4 on 8) -- each rank its
        query heads and the kv head of their group, whose ``wk``/``wv``
        columns sit on the width/Hkv ranks that share it;
      * ``"sequence"``: it does not divide the query heads (hymba's 25)
        -- each rank the queries of its positions, the sequence split
        the SSM branch takes.

    Wherever it does not divide the kv heads the cache is split by slots
    (``cache_specs``) and a decode attends over each rank's slots."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if width == 1 or (hq % width == 0 and hkv % width == 0):
        return "heads"
    if hq % width == 0 and (hq // hkv) % (hq // width) == 0:
        return "groups"
    return "sequence"


def model_rank(mesh) -> int:
    """This rank's index on ``mesh``'s ``model`` axis (0 without one)."""
    j = model_dim(mesh)
    return 0 if j is None else mesh.get_coordinate()[j]


def _wait(t):
    from torch.distributed import _functional_collectives as funcol
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def stack_on_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """Inside a local body: every ``model`` rank's ``t`` stacked in rank
    order, (width, *t.shape) -- an all-gather (differentiable: its
    backward reduce-scatters)."""
    from torch.distributed import _functional_collectives as funcol
    j = model_dim(mesh)
    if j is None or mesh.size(j) == 1:
        return t[None]
    t = t.contiguous()[None]
    # the *_single names are newer torch's, the *_tensor ones older's
    if torch.is_grad_enabled() and t.requires_grad:
        gather = getattr(funcol, "all_gather_single_autograd", None) \
            or funcol.all_gather_tensor_autograd
        return _ContiguousGrad.apply(_wait(gather(t, 0, (mesh, j))))
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return _wait(gather(t, 0, (mesh, j)))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on its gradient contiguous: an
    all-gather's backward (a reduce-scatter) takes only contiguous
    gradients in some torch releases (2.11), and the gathered parts are
    read through strided slices."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def gather_on_model(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Inside a local body: the ``model`` ranks' ``t`` joined along
    ``dim`` in rank order (``stack_on_model``)."""
    s = stack_on_model(t, mesh)
    if s.shape[0] == 1:
        return t
    dim = dim % t.dim()
    return s.movedim(0, dim).reshape(
        *t.shape[:dim], s.shape[0] * t.shape[dim], *t.shape[dim + 1:])


def reduce_on_model(t: torch.Tensor, op: str, mesh) -> torch.Tensor:
    """Inside a local body without autograd: ``t`` all-reduced (``op``:
    sum, max) over ``model``."""
    from torch.distributed import _functional_collectives as funcol
    j = model_dim(mesh)
    if j is None or mesh.size(j) == 1:
        return t
    return _wait(funcol.all_reduce(t, op, (mesh, j)))


def _part(n: int, width: int, rank: int) -> tuple[int, int, int]:
    """(first, end, chunk) of rank's even ceil-sized part of ``n``."""
    c = -(-n // width)
    return min(rank * c, n), min((rank + 1) * c, n), c


def cols_on_model(x: torch.Tensor, ws: list, splits: list, mesh) -> list:
    """Inside a local body: the whole products ``x @ w`` for each (w,
    split) pair, each rank computing its part of the columns -- a leaf
    split over ``model`` its local columns, a whole one its own even
    slice of them -- and the parts gathered over ``model`` at once (one
    ``stack_on_model``).  The contractions go through ``col_product``
    (the fsdp axes' split, where a ``tp_block`` set one)."""
    j = model_dim(mesh)
    width = 1 if j is None else mesh.size(j)
    rank = model_rank(mesh)
    parts, full = [], []
    for w, split in zip(ws, splits):
        n = w.shape[-1] * (width if split else 1)
        if split or width == 1:
            y = col_product(x, w)
        else:
            lo, hi, c = _part(n, width, rank)
            y = torch.nn.functional.pad(col_product(x, w[..., lo:hi]),
                                        (0, c - (hi - lo)))
        parts.append(y)
        full.append(n)
    if width == 1:
        return parts
    sizes = [p.shape[-1] for p in parts]
    s = stack_on_model(torch.cat(parts, dim=-1), mesh)   # (w, ..., sum)
    out, at = [], 0
    for size, n in zip(sizes, full):
        piece = s[..., at:at + size].movedim(0, -2)      # (..., w, size)
        out.append(piece.reshape(*piece.shape[:-2], width * size)[..., :n])
        at += size
    return out


def rows_on_model(y: torch.Tensor, w: torch.Tensor, split: bool,
                  mesh) -> torch.Tensor:
    """Inside a local body: this rank's partial sum of ``y @ w`` for a
    whole ``y`` (..., K) -- its rows of a ``w`` split over ``model`` by
    rows (its local shard), or its own even slice of a whole ``w`` --
    summed over ``model`` by the caller (a ``Partial`` output)."""
    j = model_dim(mesh)
    width = 1 if j is None else mesh.size(j)
    rank = model_rank(mesh)
    if split:
        lo, hi = rank * w.shape[0], (rank + 1) * w.shape[0]
    elif width == 1:
        return y @ w
    else:
        lo, hi, _ = _part(w.shape[0], width, rank)
        w = w[lo:hi]
    # the rows' slice as one (tokens, K/w) product: a strided slice would
    # make matmul broadcast w over the leading dims
    out = y[..., lo:hi].reshape(-1, hi - lo) @ w
    return out.reshape(*y.shape[:-1], w.shape[-1])


def tp_block(body, params: dict, x, *, rows_like=None, extra=(),
             split_out=None, partial: bool | None = None):
    """``body(params, x, *extra tensors)`` on each rank's shard of a block
    whose col and row leaves are split over ``model`` (and over the fsdp
    axes where ``contraction_split``): x whole on ``model``, split on its
    batch as ``rows_like`` is (x itself by default; a cache when the
    block writes one), ``extra`` (tensor tree, placements) pairs placed
    so.  By default the body ends in a row product: its partial sums
    over ``model`` are all-reduced (and, with the contraction split, its
    slices of d gathered over fsdp) and the output comes back on x's
    rows; ``partial`` says whether the body's output is a partial sum
    over ``model`` (by default: whether the first leaf is split there).
    ``split_out``: the output's placement on ``model`` instead (a col
    product's heads or vocabulary), kept as it is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    w = next(v for v in params.values() if is_dtensor(v))
    mesh = w.device_mesh
    rows = rows_of(x if rows_like is None else rows_like, mesh)
    if partial is None:
        partial = split_on_model(w)
    out = with_model(rows, mesh, split_out if split_out is not None else
                     Partial() if partial else Replicate())
    x_where, dims = rows, ()
    if split_on_fsdp(w):
        dims = fsdp_dims(mesh)
        last = Shard(x.dim() - 1)
        x_where = tuple(last if i in dims else p for i, p in enumerate(rows))
        if split_out is None:    # the row product's slices of d
            out = tuple(last if i in dims else p for i, p in enumerate(out))
        _CONTRACTING.append((mesh, dims))
    try:
        y = tp_map(body, (params, x, *(t for t, _ in extra)),
                   (None, x_where, *(p for _, p in extra)), out)
    finally:
        if dims:
            _CONTRACTING.pop()
    if split_out is not None:
        return y
    return y.redistribute(mesh, rows) if tuple(y.placements) != rows else y


def whole_on_model(y):
    """``y`` whole over ``model``, its other placements kept: a partial
    result reduced -- the one all-reduce (sum, or the partial's own op) a
    row product needs, GSPMD's -- or a split gathered.  A plain tensor
    comes back as it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate
    mesh = y.device_mesh
    return y.redistribute(mesh, with_model(tuple(y.placements), mesh,
                                           Replicate()))


def replicate_as(t: torch.Tensor, like) -> torch.Tensor:
    """A plain tensor computed alike on every rank (a position table),
    as a whole DTensor on ``like``'s mesh when ``like`` is a DTensor, so
    the two can meet in one op; otherwise ``t`` itself."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def on_shards(fn, x, whole: tuple):
    """``fn(x)`` for an op that DTensor cannot run on ``x`` itself (no
    sharding strategy for it or its backward): on a DTensor it runs on
    the local shard, the dims in ``whole`` made whole first, and comes
    back a DTensor (``local_call``); a plain tensor goes to ``fn``."""
    if not is_dtensor(x):
        return fn(x)
    free = tuple(d for d in range(x.dim()) if d not in whole)
    return local_call(fn, (x,), (free,))


def local_call(fn, tensors, free_dims, *, n_out: int = 1):
    """Run a kernel op ``fn`` on the local shards of DTensor arguments.

    ``tensors`` are the op's tensor arguments; ``free_dims[i]`` the dims
    of tensor i that may stay sharded (the kernel neither reduces nor
    contracts over them).  Every DTensor is first redistributed to the
    first tensor's placements on its free dims and whole elsewhere (a
    partial sum reduced) -- the collective GSPMD would insert, counted --
    then ``fn`` runs on the local tensors and each output comes back as a
    DTensor with the first tensor's placements.  Plain tensors pass as
    they are (the same on every rank)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    first = next(t for t in tensors if isinstance(t, DTensor))
    mesh = first.device_mesh
    lead = [p if p.is_shard() and p.dim in free_dims[0] else Replicate()
            for p in first.placements]
    local = []
    for t, free in zip(tensors, free_dims):
        if not isinstance(t, DTensor):
            local.append(t)
            continue
        want = tuple(p if p.is_shard() and p.dim in free else Replicate()
                     for p in lead)
        if tuple(t.placements) != want:
            _REDISTRIBUTIONS["kernel"] += 1
            t = t.redistribute(mesh, want)
        # a whole input used by split rows gets a partial gradient there
        grads = tuple(Partial() if w.is_replicate() and p.is_shard() else w
                      for w, p in zip(want, lead))
        local.append(t.to_local(grad_placements=grads))
    out = fn(*local)
    outs = out if n_out > 1 else (out,)
    wrapped = tuple(_from_local(o.contiguous(), mesh, tuple(lead))
                    for o in outs)
    return wrapped if n_out > 1 else wrapped[0]


def _from_local(local: torch.Tensor, mesh, where: tuple):
    """A contiguous local shard as a DTensor with the contiguous strides
    of its global shape (``from_local``'s own inference scales the
    strides of size-1 dims, which makes ``matmul`` expand a weight to a
    batched product instead of folding it into one)."""
    from torch.distributed.tensor import DTensor
    shape = list(local.shape)
    for j, p in enumerate(where):
        if p.is_shard():
            shape[p.dim] *= mesh.size(j)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, where, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def local_part(full: torch.Tensor, like) -> torch.Tensor:
    """The part of ``full`` (a whole tensor, the same on every rank) that
    this rank holds of ``like``, a DTensor of ``full``'s shape: a view of
    its local shard's slice, which a static buffer's ``to_local()`` takes
    in place (no new DTensor, no collective)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, like.device_mesh, like.placements)
    for d, (n, o) in enumerate(zip(shape, offset)):
        full = full.narrow(d, o, n)
    return full


def write_at(dest, dim: int, index, value) -> None:
    """``dest[..., index, ...] = value`` along ``dim`` in place, ``index``
    a slice or a 1-D integer tensor of global positions.  A DTensor
    ``dest`` (a cache split along ``dim`` or any other dim) takes the
    write on each rank's local shard: ``value`` is first placed as
    ``dest`` on every other dim and made whole along ``dim``, then each
    rank writes the positions that fall in its shard."""
    if not is_dtensor(dest):
        idx = [slice(None)] * dest.dim()
        idx[dim] = index
        dest[tuple(idx)] = value
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh, where = dest.device_mesh, tuple(dest.placements)
    want = tuple(Replicate() if p.is_shard() and p.dim == dim else p
                 for p in where)
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
    if tuple(value.placements) != want:
        value = value.redistribute(mesh, want)
    value = value.to_local()
    local = dest.to_local()
    # this rank's first global position along dim: its shard index over
    # the mesh dims that split dim (the first major), in chunks of the
    # ceiling size, as DTensor splits
    coord, index_, parts = mesh.get_coordinate(), 0, 1
    for j, p in enumerate(where):
        if p.is_shard() and p.dim == dim:
            index_ = index_ * mesh.size(j) + coord[j]
            parts *= mesh.size(j)
    write_local(local, dim, index_ * -(-dest.shape[dim] // parts), index,
                value)


def write_local(local: torch.Tensor, dim: int, lo: int, index,
                value) -> None:
    """``write_at`` on a plain local shard whose first global position
    along ``dim`` is ``lo``: the entries of ``value`` (whole along
    ``dim``) whose positions ``index`` (a slice or a 1-D integer tensor)
    fall in the shard are written there in place."""
    n = local.shape[dim]
    if isinstance(index, slice):
        start = index.start or 0
        a, b = max(start, lo), min(index.stop, lo + n)
        if a < b:
            local.narrow(dim, a - lo, b - a).copy_(
                value.narrow(dim, a - start, b - a))
        return
    pos = index.to(local.device)
    # which new entry lands on each local slot, by shapes alone (no
    # data-dependent indexing: the dry-run traces this on fake tensors)
    hit = (pos[None, :] - lo) == torch.arange(n, device=local.device)[:, None]
    src = (hit * torch.arange(pos.numel(), device=local.device)).sum(1)
    shape = [1] * local.dim()
    shape[dim] = n
    take = hit.any(1).reshape(shape)
    local.copy_(torch.where(take, value.index_select(dim, src), local))


def any_dtensor(*tensors) -> bool:
    """Whether any argument is a DTensor (a plain tensor is told apart by
    its type alone, so the kernel ops' hot path imports nothing)."""
    return any(is_dtensor(t) for t in tensors)


_PLAIN = (torch.Tensor, torch.nn.Parameter, type(None), int, float)
