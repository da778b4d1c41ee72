"""The port's scene graph against the JAX package's: the carry folds, the
content digests, the cached world folds, the counters and trace instants
through one edit script, and ``submit_scene``/``submit_scene_async`` on
the ``ref`` backend (the plain versions on CPU tensors).

Held equal, bit for bit or exactly:

  * ``fold_carry_extend`` in pieces against one ``fold_structure`` pass,
    in both packages (the same numpy loop), projective chains included;
  * ``chain_digest``/``path_digest`` bytes and every node's
    ``world_digest`` (the cache keys are the contract), for parameters
    given as Python floats, numpy scalars, 0-d arrays, tuples and arrays;
  * every node's ``world_fold`` against the reference's and against
    ``fold_structure`` of its world chain, over seeded random trees and
    edit schedules;
  * ``scene.stats`` through the same edit script, on the benchmark's
    smoke scenes (6 frames, 4 x 4 leaves, 64 points, served) and at the
    card's tree shape (8 x 64 leaves, 30 frames), with ``folds ==
    dirtied`` every frame; the ``scene.fold``/``cse_hit``/``refold``
    instants event for event;
  * ``submit_scene`` results against ``submit(world_chain)`` (float
    diag, float matrix, q8.7 on both kinds, projective), against
    per-request ``apply`` (float diag, q8.7), sync against async; typed
    errors for a bad node, chain or points.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

import torch_scenes as ts  # noqa: E402
from repro import scene as jscene  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import transform_chain as jtc  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import errors, scene, serving  # noqa: E402
from repro_torch.core import transform_chain as tc  # noqa: E402
from repro_torch.obs import trace as obst  # noqa: E402

PKGS = {"port": (scene, tc), "jax": (jscene, jtc)}


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bytes_eq(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _fold_eq(fa, fb) -> bool:
    return len(fa) == len(fb) and all(_bytes_eq(x, y)
                                      for x, y in zip(fa, fb))


def _rand_ops(rng, dim, kinds="TSAR", max_len=3) -> list:
    """A random primitive list [(builder, args, kwargs)], replayable on
    either package's ``TransformChain``."""
    ops = []
    for _ in range(int(rng.integers(0, max_len + 1))):
        k = kinds[int(rng.integers(len(kinds)))]
        if k == "T":
            ops.append(("translate",
                        tuple(rng.standard_normal(dim).astype(np.float32)),
                        {}))
        elif k == "S":
            ops.append(("scale",
                        tuple(rng.uniform(0.5, 2.0, dim).astype(np.float32)),
                        {}))
        elif k == "A":
            ops.append(("affine",
                        (rng.uniform(0.5, 2.0, dim).astype(np.float32),
                         rng.standard_normal(dim).astype(np.float32)), {}))
        else:
            axis = int(rng.integers(3)) if dim == 3 else None
            ops.append(("rotate", (float(rng.uniform(-3, 3)),),
                        {"axis": axis}))
    return ops


def _chain(pkg_tc, dim, ops):
    c = pkg_tc.TransformChain.identity(dim)
    for name, args, kw in ops:
        c = getattr(c, name)(*args, **kw)
    return c


def _rand_tree_script(rng, dim, n_nodes, n_edits, **kw) -> tuple:
    """A random forest (each node under a random earlier node, or a root)
    and a schedule of edits, as replayable primitive lists."""
    nodes = []
    for i in range(n_nodes):
        parent = None
        if nodes and rng.uniform() < 0.8:
            parent = nodes[int(rng.integers(len(nodes)))][0]
        nodes.append((f"n{i}", parent, _rand_ops(rng, dim, **kw)))
    edits = [(nodes[int(rng.integers(n_nodes))][0], _rand_ops(rng, dim, **kw))
             for _ in range(n_edits)]
    return nodes, edits


def _replay(pkg, dim, nodes):
    sc, pkg_tc = PKGS[pkg]
    g = sc.SceneGraph(dim, cache=sc.FoldCache())
    for name, parent, ops in nodes:
        g.add(name, _chain(pkg_tc, dim, ops), parent=parent)
    return g


# ---------------------------------------------------------------------------
# carry folds and digests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_carry_folds_piecewise_equal_one_pass_and_reference(dim):
    rng = np.random.default_rng(301 + dim)
    checked = 0
    for _ in range(30):
        ops = _rand_ops(rng, dim, max_len=6)
        c, jc = _chain(tc, dim, ops), _chain(jtc, dim, ops)
        if not len(c):
            continue
        kind = tc.plan_kind_of(c.structure)
        one = tc.fold_structure(c.structure, c.params)
        assert _fold_eq(one, jtc.fold_structure(jc.structure, jc.params))
        cut = int(rng.integers(0, len(c) + 1))
        carry = tc.fold_carry_identity(kind, dim)
        for lo, hi in ((0, cut), (cut, len(c))):
            carry = tc.fold_carry_extend(kind, dim, carry, c.kinds[lo:hi],
                                         c.params[lo:hi])
        assert _fold_eq(tc.fold_carry_finish(kind, carry), one)
        checked += 1
    assert checked >= 20


def test_carry_folds_projective_and_restrictions_match_reference():
    def pipe(pkg_tc):
        return (pkg_tc.TransformChain.identity(3).rotate(0.3, axis=1)
                .translate(0.0, 0.0, -4.0)
                .projective(np.array([[1.2, 0, 0, 0], [0, 1.2, 0, 0],
                                      [0, 0, -1.02, -1], [0, 0, -0.2, 0]],
                                     np.float32))
                .cull(-1.0, 1.0).affine(0.5, 0.5))
    c, jc = pipe(tc), pipe(jtc)
    one = tc.fold_structure(c.structure, c.params)
    assert _fold_eq(one, jtc.fold_structure(jc.structure, jc.params))
    for cut in range(len(c) + 1):
        carry = tc.fold_carry_identity("projective", 3)
        for lo, hi in ((0, cut), (cut, len(c))):
            carry = tc.fold_carry_extend("projective", 3, carry,
                                         c.kinds[lo:hi], c.params[lo:hi])
        assert _fold_eq(tc.fold_carry_finish("projective", carry), one)
        assert carry[3] is True
    # a rotation after a resumed cull is refused, as in one pass
    rot = tc.TransformChain.identity(3).rotate(0.1, axis=0)
    with pytest.raises(ValueError, match="follow cull"):
        tc.fold_carry_extend("projective", 3, carry, rot.kinds, rot.params)
    diag = tc.fold_carry_identity("diag", 2)
    r2 = tc.TransformChain.identity(2).rotate(0.2)
    p2 = tc.TransformChain.identity(2).cull()
    for kind, carry0, sub in (("diag", diag, r2),
                              ("matrix", tc.fold_carry_identity("matrix", 2),
                               p2)):
        with pytest.raises(ValueError, match="cannot fold"):
            tc.fold_carry_extend(kind, 2, carry0, sub.kinds, sub.params)
        with pytest.raises(ValueError, match="cannot fold"):
            jtc.fold_carry_extend(kind, 2, carry0, sub.kinds, sub.params)
    for bad in (lambda m: m.fold_carry_identity("bogus", 2),
                lambda m: m.fold_carry_extend("bogus", 2, diag, (), ())):
        with pytest.raises(ValueError, match="unknown fold kind"):
            bad(tc)
        with pytest.raises(ValueError, match="unknown fold kind"):
            bad(jtc)


@pytest.mark.parametrize("params", [
    (1.5,), (np.float32(1.5),), (np.array(1.5, np.float32),),
    ((np.float32(0.5), np.float32(-2.0)),), ([0.5, -2.0],),
    (np.array([0.5, -2.0]),), (np.array([[1.0, 2.0], [3.0, 4.0]]),),
    ((np.float32(2.0), (np.float32(1.0), np.float32(3.0))),),
    (np.float64(0.1),), (7,)])
def test_chain_and_path_digests_are_the_reference_bytes(params):
    kinds = (("T", -1),) if len(params) == 1 else ()
    for dim in (2, 3):
        for ks in (kinds, (("R", 2),), (("A", -1),)):
            want = jscene.chain_digest(dim, ks, params)
            got = scene.chain_digest(dim, ks, params)
            assert got == want and len(got) == 16
    local = scene.chain_digest(2, kinds, params)
    root = scene.path_digest(None, local)
    assert root == jscene.path_digest(None, local)
    assert scene.path_digest(root, local) == jscene.path_digest(root, local)
    assert scene.path_digest(b"", local) != root


def test_builder_params_digest_and_fold_like_the_reference():
    """The port's builders record the same parameter leaves as the
    reference's (numpy scalars stay scalars, tuples stay tuples), so a
    local chain digests to the same key."""
    rng = np.random.default_rng(7)
    for dim in (2, 3):
        for _ in range(20):
            ops = _rand_ops(rng, dim, max_len=5)
            c, jc = _chain(tc, dim, ops), _chain(jtc, dim, ops)
            assert c.kinds == jc.kinds
            assert scene.chain_digest(dim, c.kinds, c.params) == \
                jscene.chain_digest(dim, jc.kinds, jc.params)


# ---------------------------------------------------------------------------
# the graph: world folds, digests, dirty propagation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim, kinds", [(2, "TSA"), (2, "TSAR"), (3, "TSAR")])
def test_world_folds_and_digests_equal_reference_bitwise(dim, kinds):
    rng = np.random.default_rng(40 + dim + len(kinds))
    for _ in range(4):
        nodes, edits = _rand_tree_script(rng, dim, 14, 10, kinds=kinds)
        g, jg = _replay("port", dim, nodes), _replay("jax", dim, nodes)
        for step, (name, ops) in enumerate([(None, None)] + edits):
            if name is not None:
                assert g.set_local(name, _chain(tc, dim, ops)) == \
                    jg.set_local(name, _chain(jtc, dim, ops))
            for n in g.names()[step % 3::2]:
                assert g.world_digest(n) == jg.world_digest(n)
                f = g.world_fold(n)
                assert _fold_eq(f, jg.world_fold(n))
                wc = g.world_chain(n)
                if len(wc):
                    assert _fold_eq(f, tc.fold_structure(wc.structure,
                                                         wc.params))
                assert g.world_kind(n) == jg.world_kind(n)
                assert g.world_structure(n) == jg.world_structure(n)


def test_structure_queries_and_dirty_propagation_match_reference():
    nodes = [("r", None, []), ("a", "r", [("scale", (2.0,), {})]),
             ("b", "r", []), ("a1", "a", [("translate", (1.0, 2.0), {})]),
             ("a2", "a", []), ("a1x", "a1", [])]
    g, jg = _replay("port", 2, nodes), _replay("jax", 2, nodes)
    for q in ("parent_of", "children_of", "subtree", "dirty"):
        for n in g.names():
            assert getattr(g, q)(n) == getattr(jg, q)(n), (q, n)
    assert g.leaves() == jg.leaves() == ["b", "a2", "a1x"]
    assert len(g) == 6 and "a1" in g and "zz" not in g
    for n in g.names():
        g.world_fold(n)
        jg.world_fold(n)
    assert not any(g.dirty(n) for n in g.names())
    t = tc.TransformChain.identity(2).translate(3.0)
    jt = jtc.TransformChain.identity(2).translate(3.0)
    assert g.set_local("a", t) == jg.set_local("a", jt) == 4
    assert g.set_local("a1", t) == jg.set_local("a1", jt) == 0
    assert [g.dirty(n) for n in g.names()] == \
        [jg.dirty(n) for n in jg.names()] == \
        [False, True, False, True, True, True]
    assert g.local("a") is t


def test_graph_errors_are_the_reference_types():
    for pkg in ("port", "jax"):
        sc, pkg_tc = PKGS[pkg]
        with pytest.raises(ValueError, match="dim"):
            sc.SceneGraph(4)
        g = sc.SceneGraph(2, cache=sc.FoldCache())
        g.add("r")
        with pytest.raises(ValueError, match="duplicate"):
            g.add("r")
        with pytest.raises(ValueError, match="non-empty"):
            g.add("")
        with pytest.raises(KeyError, match="unknown parent"):
            g.add("x", parent="nope")
        with pytest.raises(TypeError, match="TransformChain"):
            g.add("y", local="not a chain")
        with pytest.raises(ValueError, match="dim 3"):
            g.add("z", pkg_tc.TransformChain.identity(3))
        with pytest.raises(KeyError, match="unknown scene node"):
            g.world_fold("nope")
        with pytest.raises(KeyError, match="unknown scene node"):
            g.set_local("nope", pkg_tc.TransformChain.identity(2))


def test_revert_and_cse_across_scenes_sharing_a_cache():
    """A revert to folded content costs no fold; a second scene on the
    same cache serves its common prefix from the first scene's entries;
    both exactly as in the reference."""
    def script(pkg):
        sc, pkg_tc = PKGS[pkg]
        sc.reset_stats()
        cache = sc.FoldCache()
        a = sc.SceneGraph(2, cache=cache)
        b = sc.SceneGraph(2, cache=cache)
        base = pkg_tc.TransformChain.identity(2).scale(np.float32(2.0))
        for g in (a, b):
            g.add("w", base)
            g.add("c", pkg_tc.TransformChain.identity(2).rotate(0.25),
                  parent="w")
        a.add("l", pkg_tc.TransformChain.identity(2).translate(1.0, 0.0),
              parent="c")
        b.add("l", pkg_tc.TransformChain.identity(2).translate(2.0, 0.0),
              parent="c")
        out = [a.world_fold("l"), b.world_fold("l")]
        snaps = [dict(sc.stats)]
        a.set_local("w", pkg_tc.TransformChain.identity(2).scale(3.0))
        out.append(a.world_fold("l"))
        a.set_local("w", base)
        out.append(a.world_fold("l"))
        snaps.append(dict(sc.stats))
        return out, snaps, len(cache)
    got, want = script("port"), script("jax")
    assert all(_fold_eq(x, y) for x, y in zip(got[0], want[0]))
    assert got[1:] == want[1:]
    assert got[1][0]["cse_hits"] == 1 and got[1][0]["folds"] == 4
    # the revert: 3 folds for the new "w", none for the reverted one
    assert got[1][1]["folds"] == 7


# ---------------------------------------------------------------------------
# counters and trace instants through the benchmark's edit script
# ---------------------------------------------------------------------------

def _served_script(pkg: str, kind: str, *, frames, branches, leaves, points):
    """The card phase's frame loop (scene_bench's, with every lane on
    both scenes) on a ``ref`` server: the warm frame, then each frame one
    edit and every leaf served through ``submit_scene`` as q8.7 and as
    float32, and through ``submit(world_chain)`` as float32.  Returns
    (per-frame (dirtied, folds), the counters, the last frame's results
    by leaf, the graph, the points)."""
    sc, pkg_tc = PKGS[pkg]
    g, names = ts.BUILD[kind][0](sc, pkg_tc, branches, leaves)
    pts = ts.leaf_points(np.random.default_rng(ts.SCENE_SEED), len(names),
                         points, g.dim)
    srv = serving.GeometryServer(device="cpu") if pkg == "port" \
        else jserving.GeometryServer(backend="ref")

    def serve():
        out = {}
        for n, p in zip(names, pts):
            out[n] = (srv.submit_scene(g, n, p, qformat="q8.7"),
                      srv.submit_scene(g, n, p),
                      srv.submit(g.world_chain(n), p))
        res = srv.flush()
        base = min(t for ts_ in out.values() for t in ts_)
        return {n: tuple(res[t - base] for t in ts_)
                for n, ts_ in out.items()}
    serve()
    sc.reset_stats()
    per_frame = []
    for frame in range(1, frames + 1):
        before = sc.stats["folds"]
        dirtied = ts.edit(sc, pkg_tc, g, kind, frame, branches)
        last = serve()
        per_frame.append((dirtied, sc.stats["folds"] - before))
    return per_frame, dict(sc.stats), last, g, names, pts


@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_smoke_scene_counters_equal_reference_and_results_bitwise(kind):
    got = _served_script("port", kind, **ts.SMOKE)
    want = _served_script("jax", kind, **ts.SMOKE)
    assert got[0] == want[0] and all(d == f for d, f in got[0])
    assert got[1] == want[1]
    assert got[1]["folds"] == got[1]["dirtied"] == 6 * (ts.SMOKE["leaves"]
                                                        + 1)
    _, _, last, g, names, pts = got
    for n, p in zip(names, pts):
        chain = g.world_chain(n)
        q, f_scene, f_chain = last[n]
        assert _bytes_eq(f_scene, f_chain)
        assert _bytes_eq(f_scene, chain.apply(p, device="cpu"))
        assert _bytes_eq(q, chain.apply(p, dtype="q8.7", device="cpu"))


@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_card_tree_counters_equal_reference_and_pins(kind):
    got = ts.resolve_frames(scene, tc, kind, **ts.CARD)
    want = ts.resolve_frames(jscene, jtc, kind, **ts.CARD)
    assert got == want
    assert all(d == f == ts.CARD["leaves"] + 1 for d, f in got[0])
    assert got[1] == ts.CARD_COUNTERS


def test_card_tree_served_counters_equal_pins():
    """The card phase's serve script at its tree shape (few points a
    leaf: the counters do not depend on points) gives the pinned
    counters on the port's ``ref`` server, frame for frame."""
    for kind in ("diag", "matrix"):
        shape = dict(ts.CARD, points=2)
        per_frame, stats, *_ = _served_script("port", kind, **shape)
        assert all(d == f == ts.CARD["leaves"] + 1 for d, f in per_frame)
        assert stats == ts.CARD_COUNTERS


def _instants(pkg: str) -> list:
    sc, pkg_tc = PKGS[pkg]
    trace_mod = obst if pkg == "port" else jtrace
    trc = trace_mod.Tracer()
    with trace_mod.installed(trc):
        sc.reset_stats()
        g, names = ts.build_matrix_scene(sc, pkg_tc, 3, 3)
        for n in names:
            g.world_fold(n)
        for frame in (1, 2, 4):
            ts.edit(sc, pkg_tc, g, "matrix", frame, 3)
            for n in names[::2]:
                g.world_fold(n)
        g.set_local("b0", ts.pose3(pkg_tc, 0, 0))      # a revert: hits
        g.world_fold(names[0])
        stats = dict(sc.stats)
    ev = [(s.name, dict(s.attrs)) for s in trc.spans
          if s.instant and s.name.startswith("scene.")]
    return ev, stats


def test_trace_instants_equal_reference_event_for_event():
    got, want = _instants("port"), _instants("jax")
    assert got == want
    ev, stats = got
    names = [n for n, _ in ev]
    assert names.count("scene.fold") == stats["folds"] - stats["refolds"]
    assert names.count("scene.refold") == stats["refolds"] > 0
    assert names.count("scene.cse_hit") == stats["cse_hits"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _scene_and_points(kind: str, rng, n_points=33):
    g, names = ts.BUILD[kind][0](scene, tc, 3, 4)
    pts = ts.leaf_points(rng, len(names), n_points, g.dim)
    return g, names, pts


@pytest.mark.parametrize("kind, qformat", [("diag", None), ("matrix", None),
                                           ("diag", "q8.7"),
                                           ("matrix", "q8.7")])
def test_submit_scene_equals_submit_of_world_chain_bitwise(kind, qformat):
    rng = np.random.default_rng(11)
    g, names, pts = _scene_and_points(kind, rng)
    srv = serving.GeometryServer(device="cpu")
    for frame in (0, 1):
        if frame:
            ts.edit(scene, tc, g, kind, frame, 3)
        a = [srv.submit_scene(g, n, p, qformat=qformat)
             for n, p in zip(names, pts)]
        b = [srv.submit(g.world_chain(n), p, qformat=qformat)
             for n, p in zip(names, pts)]
        res = srv.flush()
        base = a[0]
        for n, p, ta, tb in zip(names, pts, a, b):
            assert _bytes_eq(res[ta - base], res[tb - base])
            if kind == "diag" or qformat is not None:
                oracle = g.world_chain(n).apply(p, dtype=qformat,
                                                device="cpu")
                assert _bytes_eq(res[ta - base], oracle)
    assert srv.reports and all(r.launches for r in srv.reports)


def test_submit_scene_projective_and_identity_nodes():
    g = scene.SceneGraph(3, cache=scene.FoldCache())
    g.add("cam", tc.TransformChain.identity(3).translate(0.0, 0.0, -4.0))
    g.add("proj", tc.TransformChain.identity(3).projective(
        np.array([[1.2, 0, 0, 0], [0, 1.2, 0, 0], [0, 0, -1.02, -1],
                  [0, 0, -0.2, 0]], np.float32)).cull(), parent="cam")
    g.add("id")
    pts = np.random.default_rng(3).uniform(-2, 2, (50, 3)).astype(np.float32)
    srv = serving.GeometryServer(device="cpu")
    t0 = srv.submit_scene(g, "proj", pts)
    srv.submit(g.world_chain("proj"), pts)
    srv.submit_scene(g, "id", pts)
    a, b, c = srv.flush()
    assert _bytes_eq(np.asarray(a), np.asarray(b)) \
        and _bytes_eq(a.mask, b.mask) and a.mask is not None
    assert _bytes_eq(c, pts) and t0 == 0


def test_submit_scene_async_equals_sync_bitwise():
    rng = np.random.default_rng(15)
    g, names, pts = _scene_and_points("matrix", rng)
    sync = serving.GeometryServer(device="cpu")
    for n, p in zip(names, pts):
        sync.submit_scene(g, n, p, qformat="q8.7")
        sync.submit_scene(g, n, p)
    want = sync.flush()
    eng = serving.AsyncGeometryServer(device="cpu",
                                      clock=serving.VirtualClock())
    tickets = []
    for n, p in zip(names, pts):
        tickets.append(eng.submit_scene_async(g, n, p, qformat="q8.7"))
        tickets.append(eng.submit_scene_async(g, n, p))
    eng.drain()
    assert len(tickets) == len(want)
    for t, w in zip(tickets, want):
        assert _bytes_eq(t.result(), w)


def test_submit_scene_raises_typed_errors():
    g, names, pts = _scene_and_points("diag", np.random.default_rng(5))
    srv = serving.GeometryServer(device="cpu")
    leaf = names[0]
    with pytest.raises(errors.ShapeError):
        srv.submit_scene(g, leaf, np.ones((4, 3), np.float32))
    with pytest.raises(errors.EmptyPointsError):
        srv.submit_scene(g, leaf, np.ones((0, 2), np.float32))
    with pytest.raises(errors.DtypeError):
        srv.submit_scene(g, leaf, np.ones((4, 2), np.float64))
    bad = np.ones((4, 2), np.float32)
    bad[1, 0] = np.nan
    with pytest.raises(errors.NonFiniteError, match="points"):
        srv.submit_scene(g, leaf, bad)
    with pytest.raises(KeyError, match="unknown scene node"):
        srv.submit_scene(g, "nope", pts[0])
    # an injected fold passes the same finiteness check as a computed one
    g.set_local("b1", tc.TransformChain.identity(2).scale(np.float32(np.inf)))
    with pytest.raises(errors.NonFiniteError, match="fold"):
        srv.submit_scene(g, names[4], pts[4])
    strict = serving.GeometryServer(
        device="cpu", fault_config=serving.FaultConfig(on_q_overflow="reject"))
    with pytest.raises(errors.QRangeError):
        strict.submit_scene(g, leaf, pts[0] * np.float32(500.0),
                            qformat="q8.7")
    assert srv.pending == 0 and strict.pending == 0
    eng = serving.AsyncGeometryServer(device="cpu",
                                      clock=serving.VirtualClock())
    with pytest.raises(errors.NonFiniteError):
        eng.submit_scene_async(g, names[4], pts[4])
    assert eng.queue_depth == 0
