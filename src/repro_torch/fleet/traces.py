"""Seeded open-loop request traces for fleet-level serving benchmarks.

A :class:`Trace` is the workload contract of the fleet tier: a list of
:class:`TraceRequest` (arrival time, prompt length, generation budget)
that every router/governor/replica-mix comparison replays *identically*.
Arrival processes are registered by name, mirroring ``dvfs.governors``::

    trace = generate_trace("poisson", n_requests=200, rate_rps=40.0)
    trace = generate_trace("diurnal", n_requests=200, rate_rps=40.0,
                           period_s=20.0, amplitude=0.8)
    trace = generate_trace("bursty", n_requests=200, rate_rps=40.0,
                           burst_size=6)

* ``poisson`` — homogeneous Poisson arrivals (exponential gaps), the
  steady-traffic baseline.
* ``diurnal`` — inhomogeneous Poisson with a sinusoidal rate (thinning):
  peaks ``(1+amplitude)·rate`` and troughs ``(1-amplitude)·rate``, the
  day/night cycle autoscaling (replica parking) feeds on.
* ``bursty`` — compound Poisson: burst *events* arrive with exponential
  gaps and carry a geometric number of back-to-back requests — the tail
  stressor for routing policies (round-robin lands whole bursts on
  backlogged replicas; queue-aware policies spread them).

Prompt/output lengths are drawn over the same power-of-two buckets the
serving engine compiles for (``serve.engine._bucket`` prompts, skewed
generation lengths like the continuous-batching benchmark), so a trace
exercises exactly the decode buckets the DVFS plans cover.  Traces
round-trip through JSON (``save``/``load``) so a benchmark run can be
replayed bit-for-bit later.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

#: default prompt-length buckets (the engine's power-of-two prefill
#: buckets) and their traffic shares
PROMPT_LENS = (8, 16, 32, 64)
PROMPT_WEIGHTS = (0.35, 0.35, 0.2, 0.1)

ARRIVALS: Dict[str, Callable] = {}


def register_arrivals(name: str):
    """Decorator: make an arrival process constructible by name."""
    def deco(fn):
        ARRIVALS[name] = fn
        return fn
    return deco


@dataclass(frozen=True)
class TraceRequest:
    """One open-loop arrival: when it lands and how big it is.

    Tenant-tagged workloads additionally carry who sent it (``tenant``),
    its latency class (``slo_class``: ``interactive`` requests jump
    admission queues and may preempt a draining replica, ``batch`` never
    does), and the shared-prefix recipe: the first ``prefix_len`` prompt
    tokens are the tenant's template ``template_id``, identical across
    every request carrying it — what the radix prefix cache feeds on.
    The defaults reproduce the legacy untagged request exactly, and
    :meth:`to_dict` emits only non-default fields so legacy trace JSON
    stays bit-identical.
    """

    uid: int
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    tenant: str = ""
    slo_class: str = "standard"
    template_id: int = -1
    prefix_len: int = 0

    def to_dict(self) -> Dict:
        d = {"uid": self.uid, "arrival_s": self.arrival_s,
             "prompt_len": self.prompt_len,
             "max_new_tokens": self.max_new_tokens}
        if self.tenant:
            d["tenant"] = self.tenant
        if self.slo_class != "standard":
            d["slo_class"] = self.slo_class
        if self.template_id != -1:
            d["template_id"] = self.template_id
        if self.prefix_len:
            d["prefix_len"] = self.prefix_len
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "TraceRequest":
        return cls(uid=int(d["uid"]), arrival_s=float(d["arrival_s"]),
                   prompt_len=int(d["prompt_len"]),
                   max_new_tokens=int(d["max_new_tokens"]),
                   tenant=str(d.get("tenant", "")),
                   slo_class=str(d.get("slo_class", "standard")),
                   template_id=int(d.get("template_id", -1)),
                   prefix_len=int(d.get("prefix_len", 0)))


@dataclass
class Trace:
    """A replayable arrival sequence plus the recipe that generated it."""

    requests: List[TraceRequest]
    meta: Dict = field(default_factory=dict)

    def __post_init__(self):
        arr = [r.arrival_s for r in self.requests]
        if any(b < a for a, b in zip(arr, arr[1:])):
            raise ValueError("trace arrivals must be sorted by time")

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    @property
    def total_new_tokens(self) -> int:
        return sum(r.max_new_tokens for r in self.requests)

    @property
    def total_prompt_tokens(self) -> int:
        return sum(r.prompt_len for r in self.requests)

    def summary(self) -> Dict:
        gaps = np.diff([r.arrival_s for r in self.requests]) \
            if len(self.requests) > 1 else np.array([0.0])
        news = np.array([r.max_new_tokens for r in self.requests])
        prompts = self.total_prompt_tokens
        return {"n_requests": len(self.requests),
                "duration_s": self.duration_s,
                "total_new_tokens": int(news.sum()),
                "total_prompt_tokens": int(prompts),
                # prefill:decode token demand — the first-order signal
                # for sizing a disaggregated fleet's phase pools
                "prompt_to_new_ratio": (float(prompts / news.sum())
                                        if news.sum() else 0.0),
                "mean_rate_rps": (len(self.requests) / self.duration_s
                                  if self.duration_s > 0 else 0.0),
                "gap_cv": (float(gaps.std() / gaps.mean())
                           if gaps.size and gaps.mean() > 0 else 0.0),
                "max_new_p50": float(np.percentile(news, 50)),
                "max_new_p95": float(np.percentile(news, 95)),
                "meta": dict(self.meta)}

    # -- JSON round-trip (replayable benchmarks) -------------------------
    def to_dict(self) -> Dict:
        return {"meta": self.meta,
                "requests": [r.to_dict() for r in self.requests]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_dict(cls, d: Dict) -> "Trace":
        return cls(requests=[TraceRequest.from_dict(r)
                             for r in d["requests"]],
                   meta=d.get("meta", {}))

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

@register_arrivals("poisson")
def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate_rps: float) -> np.ndarray:
    """Homogeneous Poisson: iid exponential inter-arrival gaps."""
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


@register_arrivals("diurnal")
def diurnal_arrivals(rng: np.random.Generator, n: int, rate_rps: float,
                     period_s: float = 20.0,
                     amplitude: float = 0.8) -> np.ndarray:
    """Inhomogeneous Poisson via thinning: rate(t) = r·(1+a·sin(2πt/T)).

    ``amplitude`` in [0, 1): troughs at ``(1-a)·rate`` are where an
    energy-aware fleet drains and parks replicas.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    peak = rate_rps * (1.0 + amplitude)
    out, t = [], 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / peak)
        lam = rate_rps * (1.0 + amplitude
                          * np.sin(2.0 * np.pi * t / period_s))
        if rng.uniform() < lam / peak:
            out.append(t)
    return np.asarray(out)


@register_arrivals("bursty")
def bursty_arrivals(rng: np.random.Generator, n: int, rate_rps: float,
                    burst_size: int = 6,
                    intra_gap_s: float = 1e-3) -> np.ndarray:
    """Compound Poisson: burst events carry Geometric(1/burst_size)
    requests ``intra_gap_s`` apart; event rate is scaled so the *mean*
    request rate stays ``rate_rps`` (same load, fatter tail)."""
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    event_rate = rate_rps / burst_size
    out, t = [], 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / event_rate)
        k = int(rng.geometric(1.0 / burst_size))
        for j in range(min(k, n - len(out))):
            out.append(t + j * intra_gap_s)
    # a long burst's tail can overlap the next event: re-sort
    return np.sort(np.asarray(out))


def generate_trace(process: str = "poisson", *, n_requests: int = 200,
                   rate_rps: float = 40.0, seed: int = 0,
                   prompt_lens: Sequence[int] = PROMPT_LENS,
                   prompt_weights: Optional[Sequence[float]] = None,
                   mean_new_tokens: int = 8, straggler_every: int = 4,
                   straggler_tokens: int = 48, **process_kwargs) -> Trace:
    """Build a seeded trace: registered arrival process x the serving
    engine's length buckets.

    Generation lengths reproduce the continuous-batching benchmark's
    skewed mix — short requests with a ``straggler_tokens`` straggler
    every ``straggler_every``-th arrival — so the decode-bucket mix (and
    its tail) matches what the DVFS phase plans were optimized for.
    """
    if process not in ARRIVALS:
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"registered: {sorted(ARRIVALS)}")
    rng = np.random.default_rng(seed)
    arrivals = ARRIVALS[process](rng, n_requests, rate_rps,
                                 **process_kwargs)
    if prompt_weights is None:
        prompt_weights = PROMPT_WEIGHTS[:len(prompt_lens)]
    w = np.asarray(prompt_weights, dtype=float)
    w = w / w.sum()
    plens = rng.choice(np.asarray(prompt_lens), size=n_requests, p=w)
    reqs = []
    for i in range(n_requests):
        # straggler phase 1 % every keeps every=1 meaning "all
        # stragglers" while preserving the i%every==1 pattern for >1
        straggler = straggler_every \
            and i % straggler_every == 1 % straggler_every
        new = straggler_tokens if straggler \
            else int(rng.integers(max(mean_new_tokens // 2, 1),
                                  mean_new_tokens + 2))
        reqs.append(TraceRequest(uid=i, arrival_s=float(arrivals[i]),
                                 prompt_len=int(plens[i]),
                                 max_new_tokens=new))
    meta = {"process": process, "n_requests": n_requests,
            "rate_rps": rate_rps, "seed": seed,
            "prompt_lens": list(prompt_lens),
            "mean_new_tokens": mean_new_tokens,
            "straggler_every": straggler_every,
            "straggler_tokens": straggler_tokens, **process_kwargs}
    return Trace(requests=reqs, meta=meta)


#: per-SLO-class TTFT targets (s): interactive chat, standard API,
#: throughput batch.  Routers and replicas read these off the request's
#: ``slo_class`` tag.
SLO_TTFT_S: Dict[str, float] = {"interactive": 0.05, "standard": 0.1,
                                "batch": 0.5}


def generate_tenant_trace(process: str = "poisson", *,
                          n_requests: int = 200, rate_rps: float = 40.0,
                          seed: int = 0, n_tenants: int = 4,
                          templates_per_tenant: int = 2,
                          zipf_alpha: float = 1.1,
                          template_lens: Sequence[int] = (24, 40, 56),
                          suffix_lens: Sequence[int] = (8, 16, 32),
                          suffix_weights: Optional[Sequence[float]] = None,
                          slo_classes: Sequence[str] = ("interactive",
                                                        "standard",
                                                        "batch"),
                          mean_new_tokens: int = 8,
                          straggler_every: int = 4,
                          straggler_tokens: int = 48,
                          **process_kwargs) -> Trace:
    """Multi-tenant trace with Zipf-shared prefix templates.

    Every tenant owns ``templates_per_tenant`` prompt templates (fixed
    lengths cycled from ``template_lens`` — deliberately not all
    page-aligned, so partial-page tails exercise the cache's
    copy-on-write path).  Template *popularity* is Zipf(``zipf_alpha``)
    over all templates — the empirical shape of shared system prompts —
    so a small set of hot templates dominates and a prefix cache's hit
    rate rises with ``zipf_alpha``.  Each request draws a template
    (fixing ``tenant``, ``template_id``, ``prefix_len`` and the tenant's
    SLO class, cycled from ``slo_classes``) plus a private suffix from
    ``suffix_lens``; generation lengths keep :func:`generate_trace`'s
    skewed straggler mix so the decode-bucket spectrum matches the DVFS
    plans.
    """
    if process not in ARRIVALS:
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"registered: {sorted(ARRIVALS)}")
    if n_tenants < 1 or templates_per_tenant < 1:
        raise ValueError("need >= 1 tenant and >= 1 template per tenant")
    rng = np.random.default_rng(seed)
    arrivals = ARRIVALS[process](rng, n_requests, rate_rps,
                                 **process_kwargs)
    n_templates = n_tenants * templates_per_tenant
    pop = 1.0 / np.arange(1, n_templates + 1) ** float(zipf_alpha)
    pop = pop / pop.sum()
    tlens = [int(template_lens[t % len(template_lens)])
             for t in range(n_templates)]
    if suffix_weights is None:
        w = np.full(len(suffix_lens), 1.0 / len(suffix_lens))
    else:
        w = np.asarray(suffix_weights, dtype=float)
        w = w / w.sum()
    picks = rng.choice(n_templates, size=n_requests, p=pop)
    suffixes = rng.choice(np.asarray(suffix_lens), size=n_requests, p=w)
    reqs = []
    for i in range(n_requests):
        t = int(picks[i])
        tenant_idx = t % n_tenants
        straggler = straggler_every \
            and i % straggler_every == 1 % straggler_every
        new = straggler_tokens if straggler \
            else int(rng.integers(max(mean_new_tokens // 2, 1),
                                  mean_new_tokens + 2))
        reqs.append(TraceRequest(
            uid=i, arrival_s=float(arrivals[i]),
            prompt_len=tlens[t] + int(suffixes[i]),
            max_new_tokens=new,
            tenant=f"tenant{tenant_idx}",
            slo_class=slo_classes[tenant_idx % len(slo_classes)],
            template_id=t, prefix_len=tlens[t]))
    meta = {"process": process, "n_requests": n_requests,
            "rate_rps": rate_rps, "seed": seed,
            "n_tenants": n_tenants, "n_templates": n_templates,
            "zipf_alpha": zipf_alpha,
            "template_lens": list(template_lens),
            "suffix_lens": list(suffix_lens),
            "slo_classes": list(slo_classes),
            "mean_new_tokens": mean_new_tokens,
            "straggler_every": straggler_every,
            "straggler_tokens": straggler_tokens, **process_kwargs}
    return Trace(requests=reqs, meta=meta)
