"""Seeded fault injection + the chaos soak harness for GeometryServer.

The port of ``repro/serving/faults.py``.  The fault model has three
injection points, each mapped to a hook the engine already calls on the
REAL execution path -- the injector never gets a private code path to
make itself pass:

  * **launch faults** -- ``FaultInjector.before_launch`` raises
    ``InjectedFault`` exactly where a kernel launch error would surface;
    the engine's retry / backend-ladder / bisection machinery cannot
    tell the difference.
  * **staging corruption** -- ``corrupt_staging`` returns a corrupted
    COPY of the pinned packed operand buffer on its way to the device
    (the DMA-corruption failure mode); the engine detects it downstream
    through the output finiteness check and re-packs from the clean host
    copies.
  * **malformed requests** -- ``malform`` produces the intake garbage
    (wrong dim, empty set, float64, NaN) that ``submit`` must reject
    with a typed error before it can poison a packed bucket.

Every decision is a pure function of ``(seed, ticket)`` -- roles come
from ``np.random.default_rng([SALT, seed, ticket])``, the JAX package's
draw -- so a soak run is bit-reproducible, and its counters equal the
reference's for the same ladder: exact counter values, not "some faults
happened".

``run_chaos_soak`` is the harness: a seeded mixed-lane workload (all
three plan kinds, float + q dtype lanes) served under injection, every
result held bitwise to per-request ``TransformChain.apply``/``project``
on the server's device (the packed-vs-per-request contract of
``serving.engine``), and the full counter set returned as a
``ChaosReport``.  Its invariant: zero lost requests -- every submission
resolves to a verified result or a typed, ticket-named error.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import quantize
from repro_torch.core import transform_chain as tc
from repro_torch.obs import recorder as obsrec
from repro_torch.obs import trace as obst
from repro_torch.serving import engine, workload
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.errors import (InjectedFault, LaunchError,
                                        RequestError)

#: role-draw salt: keeps the injector's stream disjoint from every other
#: seeded stream in the repo (workloads use their own salts)
_SALT = 0xFA17

#: what a ticket can be scheduled to do, and which recovery mechanism it
#: exercises:
#:   flaky   -- launch fails while attempt < flaky_attempts (same rung):
#:              recovered by RETRY with backoff
#:   backend -- launch fails on ladder rung 0, any attempt: recovered by
#:              BACKEND DEGRADATION (cuda -> ref)
#:   corrupt -- staged words NaN out at (rung 0, attempt 0): detected by
#:              the output finiteness check, recovered by a clean
#:              re-pack RETRY
#:   poison  -- launch fails at every rung and attempt: isolated by
#:              BISECTION, resolves to a typed LaunchError; its bucket
#:              neighbours all recover
ROLES = ("flaky", "backend", "corrupt", "poison")


@dataclasses.dataclass
class FaultInjector:
    """Deterministic per-ticket fault scheduler.

    Roles are assigned per TICKET (not per bucket): a launch group fails
    when any member request's role says so at this (rung, attempt), which
    is exactly how a real poison request takes a packed bucket down.
    Explicit ``*_tickets`` overrides win over the seeded rate draw --
    tests pin scenarios with them; the soak uses rates."""
    seed: int = 0
    flaky_rate: float = 0.0
    backend_rate: float = 0.0
    corrupt_rate: float = 0.0
    poison_rate: float = 0.0
    flaky_attempts: int = 2        # flaky launches fail attempts < this
    flaky_tickets: frozenset = frozenset()
    backend_tickets: frozenset = frozenset()
    corrupt_tickets: frozenset = frozenset()
    poison_tickets: frozenset = frozenset()

    def __post_init__(self):
        self.injected_launch_faults = 0
        self.injected_corruptions = 0
        self._roles: dict[int, str | None] = {}

    def role(self, ticket: int) -> str | None:
        """This ticket's scheduled role (None = clean), memoised; the
        draw itself depends only on (seed, ticket)."""
        if ticket not in self._roles:
            for name in ROLES:
                if ticket in getattr(self, f"{name}_tickets"):
                    self._roles[ticket] = name
                    break
            else:
                u = np.random.default_rng([_SALT, self.seed, ticket]).random()
                edge = 0.0
                self._roles[ticket] = None
                for name, rate in (("poison", self.poison_rate),
                                   ("backend", self.backend_rate),
                                   ("flaky", self.flaky_rate),
                                   ("corrupt", self.corrupt_rate)):
                    edge += rate
                    if u < edge:
                        self._roles[ticket] = name
                        break
        return self._roles[ticket]

    # -- engine hooks --------------------------------------------------------

    def before_launch(self, tickets: tuple, rung_index: int,
                      attempt: int) -> None:
        """Called by the engine immediately before dispatching a launch
        (initial, retry, degraded, or bisected); raises to fail it."""
        for t in tickets:
            r = self.role(t)
            fail = (r == "poison"
                    or (r == "backend" and rung_index == 0)
                    or (r == "flaky" and rung_index == 0
                        and attempt < self.flaky_attempts))
            if fail:
                self.injected_launch_faults += 1
                raise InjectedFault(
                    f"injected {r} fault (ticket {t}, rung {rung_index}, "
                    f"attempt {attempt})")

    def corrupt_staging(self, packed: torch.Tensor, tickets: tuple,
                        rung_index: int, attempt: int) -> torch.Tensor:
        """Called by the engine while staging a float affine launch; may
        return a corrupted COPY of the (pinned, on a CUDA server) packed
        host buffer -- the launch's own buffer stays clean, and that is
        what recovery re-packs from."""
        if rung_index != 0 or attempt != 0:
            return packed
        rows = [i for i, t in enumerate(tickets)
                if self.role(t) == "corrupt"]
        if not rows:
            return packed
        out = torch.empty_like(packed, pin_memory=packed.is_pinned())
        out.copy_(packed)
        out[rows, 0, 0] = float("nan")
        self.injected_corruptions += len(rows)
        return out


#: malformed-submission modes and how ``submit`` must answer each --
#: (mode, expected error code from the ``errors`` taxonomy)
MALFORM_MODES = (("empty", "empty"), ("shape", "shape"),
                 ("float64", "dtype"), ("nan", "nonfinite"))


def malform(points: np.ndarray, mode: str) -> np.ndarray:
    """Turn a valid point set into intake garbage of the given mode."""
    if mode == "empty":
        return np.zeros((0, points.shape[-1]), np.float32)
    if mode == "shape":
        return np.asarray(points)[..., :-1] if points.shape[-1] > 1 \
            else np.repeat(np.asarray(points), 2, axis=-1)
    if mode == "float64":
        return np.asarray(points, dtype=np.float64)
    if mode == "nan":
        bad = np.array(points, copy=True)
        bad.reshape(-1)[0] = np.nan
        return bad
    raise ValueError(f"unknown malform mode {mode!r}")


@dataclasses.dataclass
class ChaosReport:
    """One soak run's full accounting.  Everything except ``elapsed_s``
    (and the rates derived from it) is deterministic for a fixed (seed,
    n_requests, rates, ladder)."""
    seed: int
    backend: str
    requests: int                  # well-formed submissions
    malformed: int                 # deliberately-garbage submissions
    rejected_at_submit: int        # typed RequestErrors raised at intake
    resolved: int                  # result slots holding verified points
    failed_requests: int           # result slots holding a LaunchError
    lost: int                      # submissions with NO resolution (must be 0)
    mismatches: int                # resolved results that failed the oracle
    faulted_buckets: int           # buckets that needed any recovery
    launches: int
    launch_failures: int
    retries: int
    backend_fallbacks: int
    bisections: int
    recovered_requests: int
    q_fallbacks: int
    injected_launch_faults: int
    injected_corruptions: int
    elapsed_s: float
    #: per-recovery-ladder flight-recorder post-mortems: one entry per
    #: recovery track, each the span/event dicts of that ladder's walk
    #: (deterministic under the soak's auto-installed virtual-clock
    #: tracer)
    postmortems: list = dataclasses.field(default_factory=list)

    @property
    def recovered_rps(self) -> float:
        """Recovered requests per second of soak wall time."""
        return self.recovered_requests / max(self.elapsed_s, 1e-9)

    def counters(self) -> dict:
        """The deterministic counter subset, name -> value (the shape the
        JAX package's ``ChaosReport.counters`` has)."""
        d = dataclasses.asdict(self)
        d.pop("elapsed_s")
        d.pop("backend")
        d.pop("postmortems")
        return d


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _verify_one(chain: tc.TransformChain, pts: np.ndarray,
                qname: str | None, res, srv: engine.GeometryServer) -> bool:
    """One request's oracle check: bitwise equal to per-request
    ``apply``/``project`` on the server's device and top backend (the
    engine's packed-vs-per-request contract), masks included, in the lane
    the server's overflow policy routes it to (``quantize.fits``, as at
    submit)."""
    x = torch.from_numpy(pts).to(srv.device)
    if chain.is_projective:
        ref, ref_mask = chain.project(x, backend=srv.backend)
        return _same_bits(res, ref.cpu().numpy()) \
            and _same_bits(res.mask, ref_mask.cpu().numpy())
    dtype = None
    if qname is not None:
        fmt = quantize.as_qformat(qname)
        fits = srv.fault_config.on_q_overflow == "wrap" or not len(chain) \
            or quantize.fits(chain.fold(), chain.plan_kind, fmt,
                             float(np.abs(pts).max()))
        dtype = qname if fits else None
    ref = chain.apply(x, backend=srv.backend, dtype=dtype)
    return _same_bits(res, ref.cpu().numpy())


def run_chaos_soak(seed: int = 0, n_requests: int = 64, *,
                   device: str | torch.device = "cuda",
                   backend: str | None = None, q_fraction: float = 0.25,
                   qformat: str = "q8.7", malformed_every: int = 9,
                   flaky_rate: float = 0.06, backend_rate: float = 0.05,
                   corrupt_rate: float = 0.05, poison_rate: float = 0.03,
                   fault_config: engine.FaultConfig | None = None,
                   verify: bool = True) -> ChaosReport:
    """Serve a seeded mixed-lane workload under seeded fault injection
    and account for every request.

    The workload mixes diagonal / matrix / projective structures and the
    float + fixed-point lanes; every ``malformed_every``-th submission is
    deliberately garbage (cycling ``MALFORM_MODES``).  The injector's
    default rates put a fault in roughly 20% of buckets.  ``backend``
    defaults to the server's own ladder top: the kernels on the card,
    whose ladder ``("cuda", "ref")`` has a live rung below them, and the
    plain version on the CPU (``("ref",)``, one rung).

    With ``verify=True`` (the default) every resolved result is held to
    its per-request oracle and every failure slot must be a
    ``LaunchError`` naming its own ticket; ``lost`` counts submissions
    with neither, and the invariant is ``lost == 0``.

    Runs traced: if no tracer is installed, the soak installs its own
    (virtual clock at 0, so recovery post-mortems are a pure function of
    the seed) for the duration and attaches per-ladder flight-recorder
    windows to ``ChaosReport.postmortems``."""
    kw = dict(device=device, backend=backend, q_fraction=q_fraction,
              qformat=qformat, malformed_every=malformed_every,
              flaky_rate=flaky_rate, backend_rate=backend_rate,
              corrupt_rate=corrupt_rate, poison_rate=poison_rate,
              fault_config=fault_config, verify=verify)
    if not obst.active().enabled:
        tracer = obst.Tracer(clock=VirtualClock(),
                             recorder=obsrec.FlightRecorder(512))
        with obst.installed(tracer):
            return _chaos_soak_traced(seed, n_requests, **kw)
    return _chaos_soak_traced(seed, n_requests, **kw)


def _recovery_postmortems(trc) -> list:
    """Group the trace's recovery-track events into one post-mortem per
    ladder (insertion order = first failure order, so deterministic)."""
    tracks: dict = {}
    for s in trc.spans:
        if s.track is not None and str(s.track).startswith("recovery"):
            tracks.setdefault(s.track, []).append(s.as_dict())
    return [{"track": t, "events": evs} for t, evs in tracks.items()]


def _chaos_soak_traced(seed, n_requests, *, device, backend, q_fraction,
                       qformat, malformed_every, flaky_rate, backend_rate,
                       corrupt_rate, poison_rate, fault_config, verify):
    cfg = fault_config or engine.FaultConfig()
    srv = engine.GeometryServer(
        device=device, backend=backend, fault_config=cfg,
        injector=FaultInjector(seed=seed, flaky_rate=flaky_rate,
                               backend_rate=backend_rate,
                               corrupt_rate=corrupt_rate,
                               poison_rate=poison_rate))
    triples = workload.mixed_lane_workload(seed, n_requests,
                                           q_fraction=q_fraction,
                                           qformat=qformat)
    base = dict(engine.stats)
    t0 = time.perf_counter()
    rejected = malformed = 0
    submitted = []                 # (ticket, chain, pts, qname)
    for i, (chain, pts, qname) in enumerate(triples):
        if malformed_every and i % malformed_every == malformed_every - 1:
            mode, _code = MALFORM_MODES[(i // malformed_every)
                                        % len(MALFORM_MODES)]
            malformed += 1
            try:
                srv.submit(chain, malform(pts, mode))
            except RequestError:
                rejected += 1      # the only acceptable outcome
        try:
            ticket = srv.submit(chain, pts, qformat=qname)
        except RequestError:
            # default rates + workload never reject a well-formed
            # request; count it rather than crash if a config does
            rejected += 1
            continue
        submitted.append((ticket, chain, pts, qname))
    if q_fraction > 0:
        # one guaranteed-overflow q request: q8.7 spans [-256, 256), so a
        # x1000 scale must trip the wrap prediction (reject or float32
        # reroute, per policy) -- exercised in every soak
        probe = tc.TransformChain(dim=2).scale(1000.0).translate([1.0, -1.0])
        probe_pts = np.linspace(-1, 1, 16, dtype=np.float32).reshape(8, 2)
        try:
            t = srv.submit(probe, probe_pts, qformat=qformat)
            submitted.append((t, probe, probe_pts, qformat))
        except RequestError:
            rejected += 1          # the "reject" overflow policy
    results = srv.flush()
    elapsed = time.perf_counter() - t0

    by_ticket = {}
    for (ticket, *_), res in zip(submitted, results):
        by_ticket[ticket] = res
    resolved = failed = lost = mismatches = 0
    for ticket, chain, pts, qname in submitted:
        res = by_ticket.get(ticket)
        if isinstance(res, LaunchError):
            failed += 1
            if res.ticket != ticket:
                mismatches += 1    # a mis-addressed error is a lost result
        elif res is None:
            lost += 1
        else:
            resolved += 1
            if verify and not _verify_one(chain, pts, qname, res, srv):
                mismatches += 1
    lost += max(0, len(submitted) - len(results))

    delta = {k: engine.stats[k] - base[k] for k in engine.stats}
    faulted = sum(1 for r in srv.last_report
                  if r.retries or r.bisections or r.backend_fallbacks
                  or r.failed_requests or r.recovered_requests)
    return ChaosReport(
        seed=seed, backend=srv.backend, requests=len(submitted),
        malformed=malformed, rejected_at_submit=rejected,
        resolved=resolved, failed_requests=failed, lost=lost,
        mismatches=mismatches, faulted_buckets=faulted,
        launches=delta["launches"],
        launch_failures=delta["launch_failures"],
        retries=delta["retries"],
        backend_fallbacks=delta["backend_fallbacks"],
        bisections=delta["bisections"],
        recovered_requests=delta["recovered_requests"],
        q_fallbacks=delta["q_fallbacks"],
        injected_launch_faults=srv.injector.injected_launch_faults,
        injected_corruptions=srv.injector.injected_corruptions,
        elapsed_s=elapsed,
        postmortems=_recovery_postmortems(obst.active()))

