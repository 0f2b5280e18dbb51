"""Synthetic request traces for the engine simulator: seeded Poisson
and diurnal arrivals with mixed classes, tenants and shared prefixes.

A copy of ``analytics_zoo_tpu/serving/sim/trace.py``, held to it by
``tests/test_torch_serving_pins.py``.  One ``random.Random(seed)``
drives every draw, so a seed gives the same trace on any platform and
process.  Standard library only.
"""

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Request", "poisson_trace", "diurnal_trace", "requests_from_dicts"]

#: Default priority-class mix (must be a subset of policy.PRIORITIES).
DEFAULT_CLASS_MIX: Tuple[Tuple[str, float], ...] = (
    ("interactive", 0.5), ("standard", 0.3), ("batch", 0.2))


@dataclass(frozen=True)
class Request:
    """One simulated request.

    ``gen_len`` is the number of tokens the request will emit before
    finishing — the simulator does not model EOS sampling, so the
    completion length is part of the trace.  When re-simulating a
    recorded bundle, ``gen_len`` is the realized token count from the
    bundle's trace, which is exactly the "completion-length oracle"
    trick the engine-vs-sim equivalence tests use.

    ``prefix_id``/``prefix_len`` tag a request that opens with a
    shared system prompt: the first ``prefix_len`` tokens of
    ``prompt_len`` are identical across every request carrying the
    same ``prefix_id`` (the tiered-KV model keys residency on it).
    ``""``/0 — the defaults, and everything a prefix-free generator
    emits — mean no shared prefix.
    """

    uri: str
    arrival_t: float
    prompt_len: int
    gen_len: int
    priority: Optional[str] = "standard"
    tenant: str = ""
    prefix_id: str = ""
    prefix_len: int = 0
    #: Optional end-to-end deadline (seconds after arrival).  Read by
    #: the fleet's crash-recovery redispatch (``plan_redispatch``):
    #: a lost request older than its deadline error-terminates instead
    #: of retrying.  0 = no per-request deadline (the fleet-level
    #: ``request_deadline_s`` still applies, if set).
    deadline_s: float = 0.0

    def to_dict(self) -> Dict[str, object]:
        out = {
            "uri": self.uri,
            "arrival_t": round(float(self.arrival_t), 9),
            "prompt_len": int(self.prompt_len),
            "gen_len": int(self.gen_len),
            "priority": self.priority,
            "tenant": self.tenant,
        }
        if self.prefix_id:
            # only tagged requests carry the fields, so prefix-free
            # traces serialize byte-identically to previous releases
            out["prefix_id"] = self.prefix_id
            out["prefix_len"] = int(self.prefix_len)
        if self.deadline_s:
            out["deadline_s"] = float(self.deadline_s)
        return out


def requests_from_dicts(rows: Sequence[Dict[str, object]]) -> List[Request]:
    """Parse an explicit request list (scenario files, golden fixtures)."""
    out = []
    for i, row in enumerate(rows):
        out.append(Request(
            uri=str(row.get("uri", "req-%06d" % i)),
            arrival_t=float(row.get("arrival_t", 0.0)),
            prompt_len=int(row["prompt_len"]),
            gen_len=int(row.get("gen_len", row.get("max_new", 1))),
            priority=row.get("priority", "standard"),  # type: ignore[arg-type]
            tenant=str(row.get("tenant", "")),
            prefix_id=str(row.get("prefix_id", "")),
            prefix_len=int(row.get("prefix_len", 0)),
            deadline_s=float(row.get("deadline_s", 0.0)),
        ))
    out.sort(key=lambda r: (r.arrival_t, r.uri))
    return out


def _normalize_mix(class_mix) -> List[Tuple[str, float]]:
    if class_mix is None:
        items = list(DEFAULT_CLASS_MIX)
    elif isinstance(class_mix, dict):
        # dicts preserve insertion order; scenario files are parsed in
        # file order, so this is deterministic for a given file.
        items = [(str(k), float(v)) for k, v in class_mix.items()]
    else:
        items = [(str(k), float(v)) for k, v in class_mix]
    total = sum(w for _, w in items)
    if total <= 0:
        raise ValueError("class mix weights must sum to a positive value")
    return [(k, w / total) for k, w in items]


def _normalize_prefixes(prefixes) -> List[Tuple[str, int]]:
    """``prefixes`` as an explicit (id, length) list.  Accepts a dict
    (``{"sysA": 128}``, insertion-ordered like the class mix) or a
    sequence of (id, length) pairs."""
    if isinstance(prefixes, dict):
        items = [(str(k), int(v)) for k, v in prefixes.items()]
    else:
        items = [(str(k), int(v)) for k, v in prefixes]
    if not items:
        raise ValueError("prefixes must name at least one shared prefix")
    for k, n in items:
        if n < 1:
            raise ValueError(f"prefix {k!r} needs a positive length, "
                             f"got {n}")
    return items


def _pick(rng: random.Random, items: List[Tuple[str, float]]) -> str:
    x = rng.random()
    acc = 0.0
    for key, w in items:
        acc += w
        if x < acc:
            return key
    return items[-1][0]


def _body(rng: random.Random, i: int, t: float, prompt_len, gen_len,
          mix, tenants: Sequence[str],
          prefixes: Optional[List[Tuple[str, int]]] = None,
          prefix_frac: float = 0.0) -> Request:
    plo, phi = int(prompt_len[0]), int(prompt_len[-1])
    glo, ghi = int(gen_len[0]), int(gen_len[-1])
    plen = rng.randint(plo, phi)
    glen = rng.randint(glo, ghi)
    priority = _pick(rng, mix)
    tenant = rng.choice(list(tenants)) if tenants else ""
    prefix_id, prefix_len = "", 0
    if prefixes is not None and prefix_frac > 0.0:
        # the prefix draws run ONLY on this branch: prefix-free calls
        # consume the exact RNG stream previous releases did, keeping
        # every existing seeded trace byte-identical
        if rng.random() < prefix_frac:
            prefix_id, prefix_len = rng.choice(prefixes)
            if plen <= prefix_len:
                # the shared prefix is a LEADING slice; leave at least
                # one private token so admission always has work
                plen = prefix_len + 1
    return Request(
        uri="req-%06d" % i,
        arrival_t=t,
        prompt_len=plen,
        gen_len=glen,
        priority=priority,
        tenant=tenant,
        prefix_id=prefix_id,
        prefix_len=prefix_len,
    )


def poisson_trace(*, n_requests: int, rate_rps: float, seed: int,
                  prompt_len: Sequence[int] = (16, 256),
                  gen_len: Sequence[int] = (8, 64),
                  class_mix=None,
                  tenants: Sequence[str] = ("",),
                  prefixes=None,
                  prefix_frac: float = 0.0) -> List[Request]:
    """Homogeneous Poisson arrivals: exponential gaps at ``rate_rps``."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = random.Random(seed)
    mix = _normalize_mix(class_mix)
    pfx = _normalize_prefixes(prefixes) if prefixes is not None else None
    t = 0.0
    out = []
    for i in range(int(n_requests)):
        t += rng.expovariate(rate_rps)
        out.append(_body(rng, i, t, prompt_len, gen_len, mix, tenants,
                         pfx, prefix_frac))
    return out


def diurnal_trace(*, n_requests: int, base_rps: float, peak_rps: float,
                  period_s: float, seed: int,
                  prompt_len: Sequence[int] = (16, 256),
                  gen_len: Sequence[int] = (8, 64),
                  class_mix=None,
                  tenants: Sequence[str] = ("",),
                  prefixes=None,
                  prefix_frac: float = 0.0) -> List[Request]:
    """Sinusoidal-rate Poisson arrivals sampled by thinning.

    Instantaneous rate at time ``t``::

        rate(t) = base + (peak - base) * (1 - cos(2*pi*t/period)) / 2

    which starts at ``base_rps``, peaks at ``peak_rps`` mid-period, and
    returns to base — one "day" per ``period_s``.
    """
    if not (0 < base_rps <= peak_rps):
        raise ValueError("need 0 < base_rps <= peak_rps")
    if period_s <= 0:
        raise ValueError("period_s must be positive")
    rng = random.Random(seed)
    mix = _normalize_mix(class_mix)
    pfx = _normalize_prefixes(prefixes) if prefixes is not None else None
    t = 0.0
    out = []
    i = 0
    while i < int(n_requests):
        t += rng.expovariate(peak_rps)
        rate = base_rps + (peak_rps - base_rps) * (
            1.0 - math.cos(2.0 * math.pi * t / period_s)) / 2.0
        if rng.random() * peak_rps < rate:
            out.append(_body(rng, i, t, prompt_len, gen_len, mix,
                             tenants, pfx, prefix_frac))
            i += 1
    return out
