"""One serving replica of the fleet: engine semantics in modeled time.

A :class:`Replica` wraps the serving stack one tier down —
:class:`~repro_torch.serve.scheduler.Scheduler` for admission/slot lifecycle,
a :class:`~repro_torch.dvfs.DvfsSession`-planned :class:`~repro_torch.dvfs.DvfsPlan`
with its own chip model and governor, and the session's
:class:`~repro_torch.dvfs.ServeGovernorExecutor` for phase replay + energy
metering — and advances it in **modeled time**: every prefill/decode
step's duration and energy come from the executed plan segments (the
same :class:`~repro_torch.runtime.energy.EnergyMeter` integration the engine's
executor performs), so a 200-request trace across N replicas simulates
in milliseconds while exercising the *real* scheduler, governor,
executor, and online re-planning code paths.  A real
:class:`~repro_torch.serve.ServeEngine` plugs into the identical executor
protocol (``on_prefill`` / ``on_decode``) when token-level fidelity is
needed — see ``attach_engine``.

Lifecycle: ``active`` → ``draining`` (no new routes; queued + in-flight
requests finish) → ``parked``.  A parked replica is modeled as the chip
holding its **deepest frequency state** (both grid minima —
``Chip.deepest_pair``), so autoscale-down is literally one more DVFS
decision: park power is ``Chip.idle_power(deepest)`` vs the idle
(auto-clock) draw, and waking is a frequency ramp charged as
``wake_latency_s``.  Idle/parked dwell is integrated alongside the
executor's busy books, so fleet energy totals cover the whole horizon,
not just the busy fraction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..cache import RadixCache
from ..dvfs.session import DvfsSession
from ..obs import NULL_TRACER
from ..serve.kv_pages import PagePool
from ..serve.scheduler import Scheduler
from .traces import TraceRequest

ACTIVE = "active"
DRAINING = "draining"
PARKED = "parked"
#: crashed (fault injection): clock frozen, 0 W, never routable again
DEAD = "dead"

#: phase roles (mirrors dvfs.plan_ir.PHASE_ROLES): a unified replica
#: serves both phases; a prefill replica migrates every multi-token
#: request out after its first token; a decode replica admits migrated
#: requests without re-running (or re-billing) their prefill.
UNIFIED = "unified"
PREFILL = "prefill"
DECODE = "decode"


#: synthetic token-id bases for the modeled tier: a trace request has no
#: real prompt tokens, so the radix key is built from collision-free
#: ids — template position i of template t maps to one id fleet-wide
#: (identical across replicas and requests, so shared prefixes match),
#: while user-suffix position j of request uid is unique to the request.
_TEMPLATE_BASE = 1 << 50
_USER_BASE = 2 << 50
_KEY_STRIDE = 100_000


def request_token_key(req: TraceRequest) -> List[int]:
    """Synthetic prompt token ids for the radix cache (modeled tier)."""
    pl = min(req.prefix_len, req.prompt_len) if req.template_id >= 0 else 0
    key = [_TEMPLATE_BASE + req.template_id * _KEY_STRIDE + i
           for i in range(pl)]
    key += [_USER_BASE + req.uid * _KEY_STRIDE + j
            for j in range(req.prompt_len - pl)]
    return key


@dataclass
class RequestState:
    """Mutable runtime record of one trace request inside the fleet."""

    req: TraceRequest
    routed_to: Optional[str] = None
    admitted_s: Optional[float] = None     # entered a batch slot
    first_token_s: Optional[float] = None  # prefill done, token 0 sampled
    finish_s: Optional[float] = None
    n_generated: int = 0
    remaining: int = 0
    prefilled_on: Optional[str] = None     # disagg: replica that prefilled
    migrate_ready_s: Optional[float] = None  # disagg: transfer landed
    #: recovery: the KV pages are gone (crash or exhausted link retries)
    #: — the next admitting replica must re-run the prefill, but the
    #: token budget resumes (n_generated/remaining carry over, so the
    #: request is billed exactly once)
    needs_reprefill: bool = False
    link_attempts: int = 0                 # failed transfer attempts
    #: prefix-cache: prompt tokens whose KV was spliced from the radix
    #: tree at admission — the prefill only computes the remainder
    cached_tokens: int = 0

    @property
    def done(self) -> bool:
        return self.finish_s is not None

    @property
    def migrated(self) -> bool:
        """True once the request's prefill ran on a *different* replica
        (its KV pages arrive by transfer; admission must not re-prefill)."""
        return self.first_token_s is not None and self.finish_s is None

    @property
    def page_tokens(self) -> int:
        """Token positions the request reserves in a page pool — the same
        whole-request reservation the real engine makes at admission
        (prompt + every generated token except the last, which is never
        cached)."""
        return self.req.prompt_len + self.req.max_new_tokens - 1

    @property
    def ttft_s(self) -> Optional[float]:
        """Arrival -> first token (queue wait + admission + prefill)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.req.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.finish_s is None or self.n_generated < 2:
            return None
        return (self.finish_s - self.first_token_s) \
            / (self.n_generated - 1)


class Replica:
    """A serving replica driven in modeled time by the fleet loop.

    The session must already hold an adopted serve plan (via
    ``plan_serve`` or ``adopt``); the replica builds its governor
    executor from it.  ``run_until`` is the only clock mutator: the
    fleet advances every replica to each arrival/control event, one
    admission-or-decode step at a time.
    """

    def __init__(self, name: str, session: DvfsSession, *,
                 n_slots: Optional[int] = None,
                 wake_latency_s: float = 0.0,
                 prefill_table=None,
                 page_size: int = 16,
                 pool_max_seq: int = 512,
                 n_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 cache_seed: int = 0,
                 tracer: Optional[object] = None):
        plan = session.governor.plan
        if plan is None or plan.kind != "serve":
            raise ValueError(f"replica {name!r} needs a session holding "
                             f"an adopted serve plan")
        if n_slots is None:
            n_slots = int(plan.meta.get("n_slots", 0)) \
                or max(plan.decode_buckets)
        self.name = name
        self.session = session
        self.chip = session.chip
        self.executor = session.serve_executor()
        # tracing: one track per replica, spans on the replica's modeled
        # clock.  The executor emits the phase spans/replan instants; the
        # replica emits lifecycle/fault/cache instants through _event.
        self.tracer = tracer if tracer is not None \
            else getattr(self.executor, "tracer", NULL_TRACER)
        self.executor.tracer = self.tracer
        self.executor.trace_track = name
        self.executor.clock_fn = lambda: self.clock
        self.executor.note_segments()
        self.scheduler = Scheduler(n_slots)
        self.n_slots = n_slots
        #: phase role, stamped into the plan by derive_role_plan
        self.role = str(plan.meta.get("role", UNIFIED))
        #: host-side page accounting twin of the engine's PagePool —
        #: admission reserves the same whole-request page count the real
        #: engine would, so slot *and* page backpressure (and the
        #: conservation invariants the disagg tests assert) are modeled.
        #: Default geometry matches PagedBatchState: every slot can hold
        #: pool_max_seq tokens, so a same-sized unified fleet never
        #: back-pressures and legacy behavior is unchanged.
        max_blocks = max(-(-pool_max_seq // page_size), 1)
        if n_pages is None:
            n_pages = n_slots * max_blocks + 1
        self.pool = PagePool(n_pages, page_size, n_slots, max_blocks)
        #: radix prefix cache over the pool (modeled: pages carry no
        #: device KV, but refcounts / CoW / eviction run the same code
        #: the engine's device-backed cache does, and prefill charges
        #: shrink to the uncached suffix fraction)
        self.prefix_cache: Optional[RadixCache] = \
            RadixCache(page_size, seed=cache_seed) if prefix_cache else None
        self.wake_latency_s = wake_latency_s
        self.state = ACTIVE
        self.clock = 0.0
        self.busy_s = 0.0
        self.idle_s = 0.0
        self.parked_s = 0.0
        self.n_wakes = 0
        self.last_work_s = 0.0         # clock when work was last present
        self.dead_since: Optional[float] = None
        self.dead_s = 0.0              # post-crash dwell (0 W)
        #: thermal clamp currently applied (max_core_frac), or None
        self.thermal_cap: Optional[float] = None
        self._thermal_saved = None
        self.n_recovery_prefills = 0
        self.recovery_prefill_j = 0.0
        self.completed: List[RequestState] = []
        #: disagg: multi-token prefills finished here, awaiting migration
        #: (the fleet loop drains this into PageBlockTransfer deliveries)
        self.outbox: List[RequestState] = []
        self.n_migrated_out = 0
        self.n_migrated_in = 0
        self.engine = None             # optional real ServeEngine twin
        #: prefill measurement table (fleet governor's second cap lever)
        self.prefill_table = prefill_table
        self.events: List[Dict] = []
        #: at-crash cache/pool books, snapshotted by fail() before the
        #: flush destroys them; the fleet folds these into its recovery
        #: books so crash stats are not silently lost
        self.crash_stats: Optional[Dict] = None

    # -- plan access ------------------------------------------------------
    @property
    def plan(self):
        return self.session.governor.plan

    @property
    def governor(self):
        return self.session.governor

    def decode_step_time(self, n_active: int) -> float:
        if not self.plan.decode_buckets:
            # prefill-only plan: slots turn over at prefill cadence
            return self.prefill_time_s
        return self.plan.decode_segment(max(n_active, 1)).time_s

    def decode_energy_per_token(self, n_active: int) -> float:
        """Planned decode energy per generated token at an occupancy:
        the marginal-energy signal the energy-aware router scores."""
        if not self.plan.decode_buckets:
            return 0.0   # prefill-only replica never decodes
        seg = self.plan.decode_segment(max(n_active, 1))
        return seg.energy_j / max(seg.bucket, 1)

    @property
    def prefill_time_s(self) -> float:
        return self.plan.prefill_segment().time_s

    @property
    def prefill_energy_j(self) -> float:
        return self.plan.prefill_segment().energy_j

    # -- load signals (router inputs) -------------------------------------
    @property
    def n_active(self) -> int:
        return self.scheduler.n_active

    @property
    def n_queued(self) -> int:
        return self.scheduler.pending

    @property
    def routable(self) -> bool:
        return self.state == ACTIVE

    def backlog_tokens(self) -> int:
        """Generation tokens still owed: in-flight remainders + queued
        budgets (the service-demand estimate behind wait prediction)."""
        live = sum(rs.remaining for rs in self.scheduler.slots
                   if rs is not None)
        queued = sum(rs.req.max_new_tokens for rs in self.scheduler.queue)
        return live + queued

    def est_wait_s(self) -> float:
        """Predicted delay before the *next* routed request starts its
        own prefill.  Two components the router must see:

        * prefill serialization — every queued request ahead prefills
          back-to-back before this one (the engine admits the whole
          queue head-first at the next round boundary);
        * slot availability — beyond the free slots, each queued
          request ahead consumes one slot-release; release times are
          predicted from the in-flight generation remainders.
        """
        q = self.scheduler.pending
        free = self.n_slots - self.scheduler.n_active
        # migrated-in requests (decode pool) skip prefill; only the
        # queued ones still owing a prefill serialize ahead
        q_pre = sum(1 for rs in self.scheduler.queue
                    if rs.first_token_s is None)
        wait = q_pre * self.prefill_time_s
        if q >= free:
            rem = sorted(rs.remaining for rs in self.scheduler.slots
                         if rs is not None)
            k = min(q - free, len(rem) - 1) if rem else 0
            if rem:
                per_step = self.decode_step_time(self.scheduler.n_active)
                wait += rem[k] * per_step
        return wait

    def _event(self, rec: Dict, cat: str = "lifecycle") -> None:
        """Append a legacy event record and mirror it onto the trace as
        an instant on this replica's track (same ``t``/payload)."""
        self.events.append(rec)
        if self.tracer.enabled:
            args = {k: v for k, v in rec.items()
                    if k not in ("t", "event")}
            self.tracer.instant(self.name, str(rec.get("event")),
                                float(rec.get("t", self.clock)), cat=cat,
                                args=args or None)

    # -- lifecycle --------------------------------------------------------
    def drain(self) -> None:
        """Stop accepting routes; queued + in-flight work still finishes,
        then the replica parks itself."""
        if self.state == ACTIVE:
            self.state = DRAINING
            self._event({"t": self.clock, "event": "drain"})

    def preempt_drain(self) -> None:
        """Priority preemption: an ``interactive``-class request may pull
        a draining replica back into service rather than wait for a wake
        ramp elsewhere — draining means the chip is still at serving
        clocks, so resuming costs nothing."""
        if self.state == DRAINING:
            self.state = ACTIVE
            self._event({"t": self.clock, "event": "preempt_drain"})

    def park(self) -> None:
        """Enter the deepest frequency state.  Only an empty replica can
        park; drain first to flush in-flight work."""
        if self.has_work():
            raise RuntimeError(f"replica {self.name!r} has in-flight or "
                               f"queued work; drain before parking")
        if self.state != PARKED:
            self.state = PARKED
            self._event({"t": self.clock, "event": "park"})

    def unpark(self) -> None:
        """Ramp back to serving clocks; the wake latency is charged as
        parked dwell (the request that woke us waits through it)."""
        if self.state == PARKED:
            self.parked_s += self.wake_latency_s
            self.clock += self.wake_latency_s
            self.n_wakes += 1
            self.state = ACTIVE
            self._event({"t": self.clock, "event": "unpark"})

    def fail(self, now: float) -> Dict[str, List[RequestState]]:
        """Crash at ``now``: orphan every queued / in-flight / outbound
        request, free all pages, freeze the clock.  Returns the orphans
        (each request in exactly one bucket — exactly-once recovery
        starts from this partition); the fleet re-dispatches them once
        the heartbeat timeout detects the death."""
        # snapshot the cache/pool books FIRST: _vacate empties the pool
        # and the radix flush zeroes the tree, so the at-crash stats the
        # recovery books fold in must be taken before either
        self.crash_stats = {"pool": self.pool.stats()}
        if self.prefix_cache is not None:
            self.crash_stats["prefix_cache"] = self.prefix_cache.stats()
        orphans: Dict[str, List[RequestState]] = {
            "queued": [], "slots": [], "outbox": list(self.outbox)}
        self.outbox.clear()
        while self.scheduler.queue:
            orphans["queued"].append(self.scheduler.queue.popleft())
        for slot, rs in enumerate(list(self.scheduler.slots)):
            if rs is None:
                continue
            self._vacate(slot)
            # release() bills a completion; a crash eviction is not one
            self.scheduler.n_completed -= 1
            orphans["slots"].append(rs)
        if self.prefix_cache is not None:
            # cached KV died with the chip; drop every tree reference so
            # the pool's conservation invariants hold post-crash
            self.prefix_cache.flush(self.pool)
        self.state = DEAD
        self.dead_since = now
        stranded = sum(len(v) for v in orphans.values())
        self._event({"t": now, "event": "crash",
                     "orphaned": stranded}, cat="fault")
        return orphans

    # -- work -------------------------------------------------------------
    def enqueue(self, rs: RequestState) -> None:
        """Accept a routed request into the admission queue."""
        if self.state == DEAD:
            raise RuntimeError(f"replica {self.name!r} is dead; the "
                               f"router must not send it work")
        interactive = rs.req.slo_class == "interactive"
        if self.state == PARKED:
            self.unpark()                # routed-to-parked wakes the chip
        elif self.state == DRAINING:
            if interactive:
                self.preempt_drain()     # priority class un-drains
            else:
                raise RuntimeError(f"replica {self.name!r} is draining; "
                                   f"router must not send it new work")
        rs.routed_to = self.name
        self.last_work_s = self.clock
        self.scheduler.submit([rs], front=interactive)

    def has_work(self) -> bool:
        return bool(self.scheduler.pending or self.scheduler.n_active)

    def attach_engine(self, engine) -> None:
        """Optional token-level twin: a real ServeEngine built with this
        replica's ``executor`` (same phase hooks, same metering)."""
        self.engine = engine

    # -- prefix cache ------------------------------------------------------
    def cached_prefix_tokens(self, req: TraceRequest) -> int:
        """Router probe: prompt tokens this replica's radix tree would
        splice for ``req``.  Pure read — no LRU or hit-counter motion,
        so scoring N candidates does not perturb their caches."""
        if self.prefix_cache is None:
            return 0
        _, matched, tail = self.prefix_cache.match(
            request_token_key(req), tail=True, touch=False)
        return matched + (tail[1] if tail is not None else 0)

    def _admit_pages(self, slot: int, rs: RequestState) -> bool:
        """Reserve the whole-request page count, splicing cached prefix
        pages read-only (CoW for a mid-page tail hit).  Mirrors
        ``ServeEngine._allocate_paged``; sets ``rs.cached_tokens`` to the
        prompt tokens whose prefill the splice absorbs."""
        pool = self.pool
        cache = self.prefix_cache
        rs.cached_tokens = 0
        if cache is None:
            return pool.allocate(slot, rs.page_tokens)
        need_pages = max(-(-rs.page_tokens // pool.page_size), 1)
        shared: List[int] = []
        matched = 0
        tail = None
        # migrated-in KV arrives by transfer and recovery re-prefills
        # rebuild dead pages — only a fresh local prefill can splice
        if rs.first_token_s is None and not rs.needs_reprefill:
            pages, matched, tailhit = cache.match(
                request_token_key(rs.req), tail=True)
            shared = [int(p) for p in pages[:need_pages]]
            matched = min(matched, len(shared) * pool.page_size)
            if tailhit is not None and len(shared) + 1 <= need_pages:
                tail = tailhit
        splice = shared + ([tail[0]] if tail is not None else [])
        fresh = need_pages - len(splice)
        extra = 0 if tail is None else 1   # the CoW copy target page
        if pool.n_free < fresh + extra:
            cache.evict(pool, fresh + extra - pool.n_free)
        if tail is not None and pool.n_free < fresh + 1:
            tail, splice = None, list(shared)   # recompute tail instead
        if not pool.allocate(slot, rs.page_tokens, shared=splice):
            return False
        if tail is not None:
            pool.cow(slot, len(shared))
        rs.cached_tokens = matched + (tail[1] if tail is not None else 0)
        if rs.cached_tokens and self.tracer.enabled:
            self.tracer.instant(
                self.name, "cache-hit", self.clock, cat="cache",
                args={"uid": rs.req.uid,
                      "cached_tokens": rs.cached_tokens,
                      "prompt_len": rs.req.prompt_len,
                      "cow": tail is not None})
        return True

    def _insert_prompt(self, slot: int, rs: RequestState) -> None:
        """Adopt the request's fully-prefilled prompt pages into the
        radix tree — including a mixed template-tail + user-suffix chunk,
        which is exactly what later mid-page tail matches CoW from."""
        key = request_token_key(rs.req)
        n_full = len(key) // self.pool.page_size
        if n_full:
            self.prefix_cache.insert(
                key, [int(p) for p in self.pool.tables[slot, :n_full]],
                self.pool)

    def _finish(self, slot: int, rs: RequestState) -> None:
        rs.finish_s = self.clock
        self._vacate(slot)
        self.completed.append(rs)

    def _vacate(self, slot: int) -> None:
        """Release a slot and return its page reservation to the pool."""
        self.scheduler.release(slot)
        if self.pool.n_blocks[slot]:
            self.pool.free(slot)

    def _migrate_out(self, slot: int, rs: RequestState) -> None:
        """Disaggregation: the prefill is done and token 0 sampled; hand
        the request to the fleet loop for a page-block transfer to the
        decode pool.  The slot and its pages free immediately — the
        transfer is a *copy* (exactly as ``extract_page_block`` copies
        pages by value), so the source pool can reuse them while the
        migrated KV is in flight."""
        self._vacate(slot)
        self.outbox.append(rs)
        self.n_migrated_out += 1

    def _step(self) -> None:
        """One engine round in modeled time: admit + prefill every
        admissible queued request, then one decode step over the pool.

        Mirrors the paged engine's admission: a request first reserves
        its whole-request page count; when the pool cannot cover it the
        admission is undone (``requeue``) and the round proceeds with
        what fit — page backpressure, distinct from slot backpressure.
        Migrated-in requests (``first_token_s`` already set) skip the
        prefill charge: their KV arrived by transfer.  On a prefill-role
        replica every multi-token request migrates out after its first
        token instead of decoding locally.
        """
        admitted: List[Tuple[int, RequestState]] = []
        while True:
            nxt = self.scheduler.admit_next()
            if nxt is None:
                break
            slot, rs = nxt
            if not self._admit_pages(slot, rs):
                self.scheduler.requeue(slot)
                if not int(self.pool.n_blocks.sum()):
                    # pool fully idle and the head still does not fit —
                    # deferring would deadlock (same guard as the engine)
                    raise RuntimeError(
                        f"replica {self.name!r}: request "
                        f"{rs.req.uid!r} needs {rs.page_tokens} tokens; "
                        f"pool holds {self.pool.n_free} free pages of "
                        f"{self.pool.page_size} even when idle")
                break
            admitted.append(nxt)
        for slot, rs in admitted:
            if rs.needs_reprefill:
                # recovery: the KV pages died with their replica (or the
                # migration link gave up) — re-run the prefill here, but
                # resume the generation budget: tokens already streamed
                # to the user are never re-billed, and first_token_s
                # keeps the time the user actually saw token 0
                rec = self.executor.on_prefill()
                self.busy_s += rec.time_s
                self.clock += rec.time_s
                self.n_recovery_prefills += 1
                self.recovery_prefill_j += rec.energy_j
                rs.needs_reprefill = False
                if rs.first_token_s is None:
                    rs.first_token_s = self.clock
                    rs.n_generated = 1
                    rs.remaining = rs.req.max_new_tokens - 1
                rs.prefilled_on = self.name
                if rs.remaining <= 0:
                    self._finish(slot, rs)
                continue
            if rs.first_token_s is not None:        # migrated-in
                self.n_migrated_in += 1
                if rs.remaining <= 0:
                    self._finish(slot, rs)
                continue
            rs.admitted_s = self.clock
            # prefix hit: only the uncached suffix fraction of the
            # prompt runs (and is billed) — at least one position always
            # recomputes, matching the engine's spliced prefill
            P = max(rs.req.prompt_len, 1)
            frac = max(P - rs.cached_tokens, 1) / P
            rec = self.executor.on_prefill(frac)
            self.busy_s += rec.time_s
            self.clock += rec.time_s
            if self.prefix_cache is not None:
                self._insert_prompt(slot, rs)
            rs.first_token_s = self.clock
            rs.prefilled_on = self.name
            rs.n_generated = 1
            rs.remaining = rs.req.max_new_tokens - 1
            if rs.remaining <= 0:
                self._finish(slot, rs)
            elif self.role == PREFILL:
                self._migrate_out(slot, rs)
        n = self.scheduler.n_active
        if n:
            rec = self.executor.on_decode(n)
            self.busy_s += rec.time_s
            self.clock += rec.time_s
            for slot, rs in enumerate(list(self.scheduler.slots)):
                if rs is None or rs.first_token_s is None:
                    continue
                rs.n_generated += 1
                rs.remaining -= 1
                if rs.remaining <= 0:
                    self._finish(slot, rs)
        self.last_work_s = self.clock
        if self.state == DRAINING and not self.has_work():
            self.park()

    def run_until(self, t: float) -> None:
        """Advance the modeled clock to (at least) ``t``: execute rounds
        while work exists — the step in flight at ``t`` completes, as on
        real hardware — then dwell idle/parked up to ``t``."""
        if self.state == DEAD:
            # a dead chip draws no power; only the clock moves
            if t > self.clock:
                self.dead_s += t - self.clock
                self.clock = t
            return
        while self.clock < t and self.state != PARKED and self.has_work():
            self._step()
        if self.clock < t:
            dt = t - self.clock
            if self.state == PARKED:
                self.parked_s += dt
            elif self.state == DRAINING and not self.has_work():
                self.park()
                self.parked_s += dt
            else:
                self.idle_s += dt
            self.clock = t

    # -- accounting -------------------------------------------------------
    @property
    def idle_power_w(self) -> float:
        return self.chip.idle_power()

    @property
    def parked_power_w(self) -> float:
        return self.chip.idle_power(self.chip.deepest_pair())

    def energy_book(self) -> Dict:
        """Whole-horizon accounting: executed (busy) books from the
        governor executor plus integrated idle/parked dwell."""
        ex = self.executor.summary()
        busy = ex["totals"]
        idle_j = self.idle_s * self.idle_power_w
        parked_j = self.parked_s * self.parked_power_w
        # a request's tokens are counted once fleet-wide: on the replica
        # that *finished* it (migrated requests carry their token 0 from
        # the prefill replica into the decode replica's book; the prefill
        # replica's completed list holds only its single-token finishes)
        tokens = sum(rs.n_generated for rs in self.completed)
        book = {"name": self.name, "chip": self.chip.name,
                "role": self.role,
                "n_migrated_out": self.n_migrated_out,
                "n_migrated_in": self.n_migrated_in,
                "pool": self.pool.stats(),
                "state": self.state, "clock_s": self.clock,
                "busy_s": self.busy_s, "idle_s": self.idle_s,
                "parked_s": self.parked_s, "dead_s": self.dead_s,
                "n_wakes": self.n_wakes,
                "n_recovery_prefills": self.n_recovery_prefills,
                "recovery_prefill_j": self.recovery_prefill_j,
                "busy_energy_j": busy["energy_j"],
                "base_busy_energy_j": busy["base_energy_j"],
                "idle_energy_j": idle_j, "parked_energy_j": parked_j,
                "energy_j": busy["energy_j"] + idle_j + parked_j,
                "tokens": tokens,
                "n_completed": len(self.completed),
                "governor_revision": self.governor.revision,
                "executed": ex}
        if self.prefix_cache is not None:
            book["prefix_cache"] = self.prefix_cache.stats()
            book["cached_prompt_tokens"] = sum(
                rs.cached_tokens for rs in self.completed)
        return book
