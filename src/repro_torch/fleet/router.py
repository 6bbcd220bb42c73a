"""Pluggable request routing across replicas, registered by name.

Mirrors the ``dvfs.governors`` registry pattern::

    r = router("round-robin")
    r = router("least-queue")
    r = router("energy-slo", slo_ttft_s=0.5, slo_weight=4.0)

* ``round-robin`` — cycle over routable replicas, blind to load and
  chip: the spread-everything baseline every serving stack starts with.
* ``least-queue`` — join-the-shortest-queue on backlog tokens: the
  latency-first baseline (tail-optimal, energy-oblivious).
* ``energy-slo`` — score every routable replica by its **predicted
  marginal energy** for this request read off the replica's active
  :class:`~repro_torch.dvfs.DvfsPlan` (prefill segment energy + decode
  energy/token at the occupancy the request would see, times its
  generation budget), inflated by a predicted-SLO penalty built from the
  replica's backlog.  Minimizing this packs work onto the most
  energy-efficient replicas (higher decode occupancy amortizes static
  power; on a heterogeneous fleet it prefers the efficient chip) while
  the SLO term spills to colder replicas before queues threaten the
  TTFT target — the Wilkins-style energy/SLO routing the fleet
  benchmark measures against the blind baselines.
* ``cache-affinity`` — energy-slo scoring with prefix-cache locality:
  each candidate's prefill term (energy *and* its TTFT contribution)
  shrinks by the prompt fraction that replica's radix tree already
  holds, so requests sharing a template gravitate to the replica that
  cached it — without abandoning the SLO spill valve when that replica
  backlogs.

Routers only read replica *predictions* (plan segments + backlog +
cache probes); they never mutate replica state.  ``route`` returns the
chosen replica; the fleet loop performs the actual enqueue.  An
``interactive``-SLO request may additionally be routed to a *draining*
replica (priority preemption pulls it back into service — see
``Replica.preempt_drain``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from .replica import Replica
from .traces import TraceRequest

ROUTERS: Dict[str, type] = {}


def register_router(name: str):
    """Class decorator: make a routing policy constructible by name."""
    def deco(cls):
        ROUTERS[name] = cls
        cls.name = name
        return cls
    return deco


def router(name: str, **kwargs) -> "BaseRouter":
    """Instantiate a registered routing policy by name."""
    if name not in ROUTERS:
        raise ValueError(f"unknown router {name!r}; registered: "
                         f"{sorted(ROUTERS)}")
    return ROUTERS[name](**kwargs)


class BaseRouter:
    """Shared routing contract: pick one replica for each arrival."""

    name = "?"

    def route(self, req: TraceRequest,
              replicas: Sequence[Replica]) -> Replica:
        cands = [r for r in replicas if r.routable]
        if not cands and req.slo_class == "interactive":
            # priority preemption: an interactive request may un-drain a
            # replica still at serving clocks instead of paying a wake
            cands = [r for r in replicas if r.state == "draining"]
        if not cands:
            # a fully drained/parked fleet still owes the request an
            # answer: wake the cheapest parked replica
            parked = [r for r in replicas if r.state == "parked"]
            if not parked:
                dead = [r.name for r in replicas if r.state == "dead"]
                if dead:
                    raise RuntimeError(
                        f"no routable replica (dead: {', '.join(dead)})")
                raise RuntimeError("no routable replica (all draining)")
            return min(parked, key=lambda r: r.parked_power_w)
        return self.pick(req, cands)

    def pick(self, req: TraceRequest,
             candidates: List[Replica]) -> Replica:
        raise NotImplementedError


@register_router("round-robin")
class RoundRobinRouter(BaseRouter):
    """Cycle over routable replicas regardless of load or chip."""

    def __init__(self):
        self._i = 0

    def pick(self, req, candidates):
        r = candidates[self._i % len(candidates)]
        self._i += 1
        return r


@register_router("least-queue")
class LeastQueueRouter(BaseRouter):
    """Join-the-shortest-queue on requests in system (ties: backlog
    tokens, so two three-deep queues compare by service demand)."""

    def pick(self, req, candidates):
        return min(candidates,
                   key=lambda r: (r.n_active + r.n_queued,
                                  r.backlog_tokens()))


@register_router("energy-slo")
class EnergySloRouter(BaseRouter):
    """Minimize predicted marginal energy, penalized by predicted SLO
    risk.

    Marginal energy of placing ``req`` on replica ``r``::

        E(r) = prefill_energy(r)
             + max_new_tokens * decode_energy_per_token(r, occupancy')

    with ``occupancy'`` the decode-bucket occupancy the request would
    see (current active + queued + itself, clamped to the pool).  The
    per-token term is read from the replica's *active* plan segment for
    that bucket, so online re-plans (mix drift, fleet power caps) shift
    routing automatically.  The SLO penalty converts predicted wait into
    an energy-equivalent inflation::

        score = E(r) * (1 + slo_weight * max(0, wait_hat/slo_ttft - slack))

    so a backlogged-but-efficient replica loses to a colder one exactly
    when its predicted TTFT approaches the target.
    """

    def __init__(self, slo_ttft_s: float = 0.5, slo_weight: float = 8.0,
                 slack: float = 0.25):
        if slo_ttft_s <= 0:
            raise ValueError(f"slo_ttft_s must be > 0, got {slo_ttft_s}")
        self.slo_ttft_s = slo_ttft_s
        self.slo_weight = slo_weight
        self.slack = slack

    def score(self, req: TraceRequest, r: Replica) -> float:
        occ = min(r.n_active + r.n_queued + 1, r.n_slots)
        energy = r.prefill_energy_j \
            + req.max_new_tokens * r.decode_energy_per_token(occ)
        ttft_hat = r.est_wait_s() + r.prefill_time_s
        if r.state == "parked":
            # waking is a frequency ramp: the request waits through it,
            # and the chip re-joins the fleet's idle-power bill
            ttft_hat += r.wake_latency_s
            energy += r.idle_power_w * r.wake_latency_s
        # quadratic risk: waits inside the slack band are free (packing
        # is allowed to cost a little latency), approaching the target
        # dominates any energy difference
        risk = max(ttft_hat / self.slo_ttft_s - self.slack, 0.0) ** 2
        return energy * (1.0 + self.slo_weight * risk)

    def route(self, req, replicas):
        # parked replicas stay candidates (scored with their wake cost):
        # spilling a burst onto a parked chip is this policy's autoscale-up
        cands = [r for r in replicas
                 if r.routable or r.state == "parked"]
        if not cands:
            return super().route(req, replicas)
        return self.pick(req, cands)

    def pick(self, req, candidates):
        return min(candidates, key=lambda r: self.score(req, r))


@register_router("cache-affinity")
class CacheAffinityRouter(EnergySloRouter):
    """Energy-SLO routing with prefix-cache locality.

    Identical to :class:`EnergySloRouter` except the prefill term is
    scaled by the **predicted uncached suffix fraction**: probing each
    candidate's radix tree (:meth:`Replica.cached_prefix_tokens`, a pure
    read) tells how much of the prompt it would splice instead of
    recompute, shrinking both the prefill energy and its TTFT
    contribution::

        suffix(r) = max(prompt_len - cached(r), 1) / prompt_len
        E(r) = prefill_energy(r) * suffix(r)
             + max_new_tokens * decode_energy_per_token(r, occupancy')
        ttft_hat = wait_hat(r) + prefill_time(r) * suffix(r)

    Requests sharing a template therefore gravitate to the replica that
    already cached it (which *keeps* it warm — affinity is
    self-reinforcing), while the unchanged SLO risk term still spills to
    colder replicas once the hot replica's queue threatens the target.
    On replicas without a prefix cache the probe returns 0 and the score
    degrades to exactly the energy-slo score.
    """

    def score(self, req: TraceRequest, r: Replica) -> float:
        occ = min(r.n_active + r.n_queued + 1, r.n_slots)
        P = max(req.prompt_len, 1)
        suffix = max(P - r.cached_prefix_tokens(req), 1) / P
        energy = r.prefill_energy_j * suffix \
            + req.max_new_tokens * r.decode_energy_per_token(occ)
        ttft_hat = r.est_wait_s() + r.prefill_time_s * suffix
        if r.state == "parked":
            ttft_hat += r.wake_latency_s
            energy += r.idle_power_w * r.wake_latency_s
        risk = max(ttft_hat / self.slo_ttft_s - self.slack, 0.0) ** 2
        return energy * (1.0 + self.slo_weight * risk)
