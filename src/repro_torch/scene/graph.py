"""The scene-graph IR: named nodes over ``TransformChain`` with dirty bits.

A copy of the JAX package's ``scene/graph.py`` on the port's
``transform_chain`` and ``obs.trace``.

A ``SceneGraph`` is a forest of named nodes, each owning a LOCAL
``TransformChain`` and a parent link.  A node's WORLD chain is the
concatenation of the local chains along the root -> node path, applied in
path order: the root's primitives first, the node's own last.  That is
the shared-prefix shape of real transform traffic (the companion
graphics paper's world -> camera -> projection pipelines): every
descendant of a node shares the node's whole prefix, so the fold of that
prefix is computed ONCE and extended per child -- never recomputed per
request.

Two mechanisms make that sound:

  * **Content-hash fold CSE** (``scene.cache``): each node's world prefix
    is named by a content digest, and its fold carry is cached in a
    ``FoldCache`` shared across nodes, scenes and requests under
    (digest, fold kind).  Extending a parent's cached carry re-enters the
    SAME fold loop ``fold_structure`` runs (``fold_carry_extend``), so a
    cached world fold is bit-identical to folding the node's whole world
    chain from scratch -- the equality contract ``tests/test_torch_scene.py``
    asserts and the serving integration relies on.

  * **Dirty propagation**: editing one node's local chain
    (``set_local``) invalidates exactly that node's subtree (per-node
    dirty bit = an invalidated world digest).  The next resolution
    recomputes digests down the dirty path and folds ONLY nodes whose
    content digest is new to the cache: cost O(changed subtree), not
    O(scene).  ``chip_smoke.py``'s scene phase gates "folds per frame ==
    dirtied nodes" exactly.

Serving: ``GeometryServer.submit_scene(scene, node, points)`` submits a
node's points through the cached world fold -- same buckets, same packed
kernels, bitwise-equal results to submitting ``scene.world_chain(node)``
(float32 and Qm.n lanes both).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import transform_chain as tc
from repro_torch.obs import trace as obst
from repro_torch.scene import cache as scache


@dataclasses.dataclass
class SceneNode:
    """One scene node: a named local chain + its place in the tree.

    ``world_key`` is the content digest of the node's whole root -> node
    prefix; ``None`` IS the dirty bit (an edit anywhere above invalidated
    it).  ``folded_kinds`` remembers the fold kinds this node has ever
    folded under, so a recomputation counts as a *refold* rather than
    first contact."""

    name: str
    parent: str | None
    local: tc.TransformChain
    children: list[str] = dataclasses.field(default_factory=list)
    local_key: bytes = b""
    world_key: bytes | None = None
    folded_kinds: set = dataclasses.field(default_factory=set)


class SceneGraph:
    """Named transform hierarchy with cached, incrementally-refolded
    world folds (see the module docstring for the contract)."""

    def __init__(self, dim: int = 2, *, cache: scache.FoldCache | None = None):
        """A scene of ``dim``-dimensional chains.  ``cache`` is the
        ``FoldCache`` to share; default is the process-wide
        ``scene.shared_cache()`` so independent scenes still CSE each
        other's subchains."""
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        self.dim = dim
        self.cache = cache if cache is not None else scache.shared_cache()
        self._nodes: dict[str, SceneNode] = {}
        self._roots: list[str] = []

    # -- structure -----------------------------------------------------------

    def __len__(self) -> int:
        """Number of nodes in the scene."""
        return len(self._nodes)

    def __contains__(self, name: str) -> bool:
        """True if ``name`` is a node of this scene."""
        return name in self._nodes

    def names(self) -> list[str]:
        """Every node name, in insertion order."""
        return list(self._nodes)

    def add(self, name: str, local: tc.TransformChain | None = None, *,
            parent: str | None = None) -> str:
        """Add a node under ``parent`` (None = a root) with ``local`` as
        its local chain (None = the identity chain).  Names are unique;
        the parent must already exist -- parents are fixed at add time,
        so the graph is a forest by construction (no cycles to check
        for).  Returns the name for chaining."""
        if not isinstance(name, str) or not name:
            raise ValueError(f"node name must be a non-empty str: {name!r}")
        if name in self._nodes:
            raise ValueError(f"duplicate scene node {name!r}")
        local = tc.TransformChain.identity(self.dim) if local is None \
            else self._check_local(local)
        if parent is not None and parent not in self._nodes:
            raise KeyError(f"unknown parent node {parent!r}")
        node = SceneNode(name, parent, local,
                         local_key=scache.chain_digest(
                             self.dim, local.kinds, local.params))
        self._nodes[name] = node
        if parent is None:
            self._roots.append(name)
        else:
            self._nodes[parent].children.append(name)
        return name

    def _check_local(self, local: tc.TransformChain) -> tc.TransformChain:
        if not isinstance(local, tc.TransformChain):
            raise TypeError(f"local must be a TransformChain, "
                            f"got {type(local).__name__}")
        if local.dim != self.dim:
            raise ValueError(f"local chain dim {local.dim} != scene "
                             f"dim {self.dim}")
        return local

    def _node(self, name: str) -> SceneNode:
        try:
            return self._nodes[name]
        except KeyError:
            raise KeyError(f"unknown scene node {name!r}") from None

    def parent_of(self, name: str) -> str | None:
        """The node's parent name (None for a root)."""
        return self._node(name).parent

    def children_of(self, name: str) -> list[str]:
        """The node's direct children, in add order."""
        return list(self._node(name).children)

    def local(self, name: str) -> tc.TransformChain:
        """The node's LOCAL chain (its own primitives only)."""
        return self._node(name).local

    def leaves(self) -> list[str]:
        """Every childless node, in insertion order (where point payloads
        naturally attach)."""
        return [n for n, nd in self._nodes.items() if not nd.children]

    def subtree(self, name: str) -> list[str]:
        """``name`` plus every descendant, preorder -- the set an edit of
        ``name`` dirties."""
        out, stack = [], [name]
        self._node(name)
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(reversed(self._nodes[n].children))
        return out

    def dirty(self, name: str) -> bool:
        """True if the node's world digest is invalidated (an edit at or
        above it has not been resolved yet)."""
        return self._node(name).world_key is None

    # -- editing -------------------------------------------------------------

    def set_local(self, name: str, local: tc.TransformChain) -> int:
        """Replace the node's local chain and dirty its subtree: every
        descendant's world digest is invalidated, nothing else is
        touched.  Returns the number of nodes NEWLY dirtied (already
        dirty nodes don't recount -- they still only cost one refold),
        which the ``dirtied`` counter accumulates: the next resolution of
        the whole scene performs at most that many folds, and exactly
        that many when the new parameters are fresh content (a revert to
        previously-folded content is a cache hit instead)."""
        node = self._node(name)
        node.local = self._check_local(local)
        node.local_key = scache.chain_digest(
            self.dim, local.kinds, local.params)
        dirtied = 0
        for n in self.subtree(name):
            nd = self._nodes[n]
            if nd.world_key is not None:
                nd.world_key = None
                dirtied += 1
        scache.stats["dirtied"] += dirtied
        return dirtied

    # -- world resolution ----------------------------------------------------

    def _path(self, name: str) -> list[SceneNode]:
        """root -> node chain of SceneNodes."""
        path = []
        cur: str | None = name
        while cur is not None:
            node = self._node(cur)
            path.append(node)
            cur = node.parent
        path.reverse()
        return path

    def world_structure(self, name: str) -> tuple:
        """The ``TransformChain.structure`` of the node's world chain
        (concatenated kinds along the root -> node path)."""
        kinds: tuple = ()
        for node in self._path(name):
            kinds = kinds + node.local.kinds
        return (self.dim, kinds)

    def world_kind(self, name: str) -> str:
        """Plan kind of the node's world chain (diag|matrix|projective);
        the fold-kind half of the node's cache key."""
        return tc.plan_kind_of(self.world_structure(name))

    def world_chain(self, name: str) -> tc.TransformChain:
        """The node's world chain as a plain ``TransformChain`` -- the
        independent per-request oracle: applying/folding it from scratch
        is bit-identical to the scene's cached ``world_fold`` (the
        equality the tests assert)."""
        kinds: tuple = ()
        params: tuple = ()
        for node in self._path(name):
            kinds = kinds + node.local.kinds
            params = params + node.local.params
        return tc.TransformChain(self.dim, kinds, params)

    def world_digest(self, name: str) -> str:
        """Hex content digest naming the node's world prefix -- a pure
        function of chain content, stable across processes and hash
        seeds (what the FoldCache keys on)."""
        path = self._path(name)
        self._ensure_keys(path)
        key = path[-1].world_key
        assert key is not None
        return key.hex()

    def _ensure_keys(self, path: list[SceneNode]) -> None:
        """Recompute invalidated world digests down a root -> node path
        (consuming the dirty bits on it)."""
        parent_key: bytes | None = None
        for node in path:
            if node.world_key is None:
                node.world_key = scache.path_digest(parent_key,
                                                    node.local_key)
            parent_key = node.world_key

    def _carry(self, name: str, kind: str) -> tuple:
        """Resolve the node's fold carry under ``kind``: walk up to the
        nearest cached prefix, then extend downward, caching and
        counting each fold.  Fold work == nodes on the path whose
        content digest is new to the cache under this kind."""
        path = self._path(name)
        self._ensure_keys(path)
        trc = obst.active()
        carry = None
        start = 0
        for i in range(len(path) - 1, -1, -1):
            node = path[i]
            cached = self.cache.lookup((node.world_key, kind))
            if cached is not None:
                if trc.enabled:
                    trc.instant("scene.cse_hit", node=node.name, kind=kind)
                carry, start = cached, i + 1
                break
        if carry is None:
            carry = tc.fold_carry_identity(kind, self.dim)
        for node in path[start:]:
            carry = tc.fold_carry_extend(kind, self.dim, carry,
                                         node.local.kinds,
                                         node.local.params)
            self.cache.store((node.world_key, kind), carry)
            refold = kind in node.folded_kinds
            node.folded_kinds.add(kind)
            scache.stats["folds"] += 1
            if refold:
                scache.stats["refolds"] += 1
            if trc.enabled:
                trc.instant("scene.refold" if refold else "scene.fold",
                            node=node.name, kind=kind,
                            length=len(node.local.kinds))
        return carry

    def world_fold(self, name: str) -> tuple:
        """The node's folded world parameters -- float32 (s, t) / (A, t)
        / (H, lo, hi) by world plan kind -- resolved through the shared
        ``FoldCache``.  Bit-identical to
        ``fold_structure(*world chain*)`` from scratch, because a cache
        extension re-runs the very same fold loop from the parent's
        saved state (``transform_chain.fold_carry_extend``); cost is
        O(nodes whose content is new) thanks to dirty propagation."""
        kind = self.world_kind(name)
        return tc.fold_carry_finish(kind, self._carry(name, kind))
