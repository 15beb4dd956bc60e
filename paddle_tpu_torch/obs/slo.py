"""SLO engine: declared objectives, burn-rate evaluation, health
states, after paddle_tpu/obs/slo.py (the same spec syntax, burn math,
state machine and readouts).

A declared SLO per served model, a background monitor thread that
samples the live ``ServingMetrics`` counters at a fixed interval into a
bounded time-series ring, and a multi-window burn-rate evaluation
driving a per-model health state machine (``ok`` -> ``degraded`` ->
``breach``, with hysteresis on both edges).  Transitions emit
``slo_degraded`` / ``slo_breach`` / ``slo_recovered`` events and the
monitor exports burn-rate / compliance / state gauges; the server's
``health`` verb renders its state, and a breach fires the flight
recorder (obs/flightrec.py), whose bundle carries the monitor's
timeline.

Burn-rate model:

* every objective reduces each sampling interval to a **bad fraction**
  in [0, 1]:
    - ``error_rate`` / ``shed_rate``: the measured rate over the
      interval's counter deltas (bad requests / requests);
    - ``p95_ms`` / ``ttft_p95_ms``: an indicator — 1.0 when the
      interval's windowed p95 exceeded the target, else 0.0;
    - ``spec_accept``: 1.0 when the interval's draft accept rate fell
      below the floor (only when drafts were offered);
* ``burn(window) = mean(bad fraction over the window) / budget`` where
  the budget is the declared rate itself for rate objectives and
  ``SLO.budget`` (the allowed fraction of violating intervals) for
  threshold objectives.  burn == 1.0 means the error budget is being
  spent exactly at the sustainable rate; burn >> 1 means it will be
  exhausted early;
* two windows: a FAST window (default 6 samples) evaluated against
  ``fast_burn`` (default 10.0) catches hard outages within a couple of
  intervals; a SLOW window (default 30 samples, only evaluated once
  full) against ``slow_burn`` (default 2.0) catches low-grade burns a
  fast window can never see.  Either rule "trips" the evaluation; the
  slow rule is additionally gated on the fast window ALSO burning at
  >= ``slow_burn`` (Google's paired-window condition — stale bad
  intervals inside the slow window must not re-trip a lane that
  already recovered).  Note threshold objectives cap their burn at
  ``1/budget`` (an all-bad window), so ``fast_burn`` must sit at or
  under that to be reachable.

State machine with hysteresis: ``breach_evals`` consecutive tripped
evaluations escalate (first trip = ``degraded``, sustained =
``breach``); ``recover_evals`` consecutive clean evaluations are
required to return to ``ok`` (one ``slo_recovered`` event per
recovery, never a flap storm).

Nothing here touches the hot path: the monitor thread reads counters
the traffic already maintains, and a declared-SLO-free model is still
sampled (its timeline feeds the flight recorder) but never evaluated.
"""

import collections
import threading
import time

__all__ = ["SLO", "SLOMonitor", "parse_slo_spec",
           "STATE_OK", "STATE_DEGRADED", "STATE_BREACH"]

STATE_OK = "ok"
STATE_DEGRADED = "degraded"
STATE_BREACH = "breach"
_STATE_CODE = {STATE_OK: 0, STATE_DEGRADED: 1, STATE_BREACH: 2}

# objective keys a spec / declare() may set (targets)
_RATE_OBJECTIVES = ("error_rate", "shed_rate")
_THRESHOLD_OBJECTIVES = ("p95_ms", "ttft_p95_ms", "spec_accept")
OBJECTIVES = _RATE_OBJECTIVES + _THRESHOLD_OBJECTIVES
# tunables riding the same spec syntax
_TUNABLES = ("budget", "fast_window", "slow_window", "fast_burn",
             "slow_burn", "breach_evals", "recover_evals")


class SLO(object):
    """One model's declared objectives + burn/hysteresis tuning.
    Unset objectives (None) are not evaluated."""

    __slots__ = ("error_rate", "shed_rate", "p95_ms", "ttft_p95_ms",
                 "spec_accept", "budget", "fast_window", "slow_window",
                 "fast_burn", "slow_burn", "breach_evals",
                 "recover_evals")

    def __init__(self, error_rate=None, shed_rate=None, p95_ms=None,
                 ttft_p95_ms=None, spec_accept=None, budget=0.1,
                 fast_window=6, slow_window=30, fast_burn=10.0,
                 slow_burn=2.0, breach_evals=2, recover_evals=3):
        self.error_rate = None if error_rate is None else float(error_rate)
        self.shed_rate = None if shed_rate is None else float(shed_rate)
        self.p95_ms = None if p95_ms is None else float(p95_ms)
        self.ttft_p95_ms = None if ttft_p95_ms is None \
            else float(ttft_p95_ms)
        self.spec_accept = None if spec_accept is None \
            else float(spec_accept)
        # the fraction of intervals a threshold objective may violate
        # before its budget burns at rate 1.0
        self.budget = max(float(budget), 1e-6)
        self.fast_window = max(int(fast_window), 2)
        self.slow_window = max(int(slow_window), self.fast_window + 1)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.breach_evals = max(int(breach_evals), 1)
        self.recover_evals = max(int(recover_evals), 1)

    def objectives(self):
        """The declared (objective, target) pairs."""
        return [(k, getattr(self, k)) for k in OBJECTIVES
                if getattr(self, k) is not None]

    def to_dict(self):
        d = {k: getattr(self, k) for k, _ in
             [(o, None) for o in OBJECTIVES]
             if getattr(self, k) is not None}
        d.update({k: getattr(self, k) for k in _TUNABLES})
        return d

    def __repr__(self):
        return "SLO(%s)" % ", ".join(
            "%s=%s" % (k, v) for k, v in sorted(self.to_dict().items()))


def parse_slo_spec(spec):
    """Parse ``FLAGS.serving_slo`` into {model_or_*: SLO}.

    Syntax: semicolon-separated declarations, each
    ``[model:]key=value,key=value,...``; a declaration with no model
    prefix (or the ``*`` prefix) is the default applied to every model
    without its own.  Keys: the objectives (p95_ms, ttft_p95_ms,
    error_rate, shed_rate, spec_accept) plus the tunables (budget,
    fast_window, slow_window, fast_burn, slow_burn, breach_evals,
    recover_evals).  Example::

        "p95_ms=250,error_rate=0.01;llm:ttft_p95_ms=400,spec_accept=0.5"
    """
    out = {}
    if not spec:
        return out
    for decl in str(spec).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        model = "*"
        body = decl
        head, sep, rest = decl.partition(":")
        if sep and "=" not in head:
            model, body = (head.strip() or "*"), rest
        kwargs = {}
        for part in body.split(","):
            part = part.strip()
            if not part:
                continue
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq or key not in OBJECTIVES + _TUNABLES:
                raise ValueError(
                    "bad SLO spec entry %r (model %r) — keys are %s"
                    % (part, model, ", ".join(OBJECTIVES + _TUNABLES)))
            kwargs[key] = float(val)
        out[model] = SLO(**kwargs)
    return out


class _Sample(object):
    """One sampling instant of one model lane: cumulative counters plus
    the interval-windowed percentile reads.  ``ts`` is the wall-clock
    record stamp (timeline/bundle field); ``mono`` carries the
    interval math."""

    __slots__ = ("ts", "mono", "requests", "responses", "errors",
                 "shed", "deadline_expired", "p95_ms", "ttft_p95_ms",
                 "draft_tokens", "accepted_tokens", "bad")

    def to_dict(self):
        d = {"ts": self.ts, "requests": self.requests,
             "responses": self.responses, "errors": self.errors,
             "shed": self.shed,
             "deadline_expired": self.deadline_expired,
             "draft_tokens": self.draft_tokens,
             "accepted_tokens": self.accepted_tokens}
        if self.p95_ms is not None:
            d["p95_ms"] = round(self.p95_ms, 3)
        if self.ttft_p95_ms is not None:
            d["ttft_p95_ms"] = round(self.ttft_p95_ms, 3)
        if self.bad:
            d["bad"] = {k: round(v, 4) for k, v in self.bad.items()}
        return d

class SLOMonitor(object):
    """Samples one ``ServingMetrics`` registry on a fixed interval,
    keeps a bounded per-lane time-series ring, and evaluates declared
    SLOs into the ok/degraded/breach state machine.

    ``tick()`` is the whole evaluation pass and is public so tests (and
    synthetic-timeline drivers) can step the monitor without the
    background thread; ``start()`` runs it on a daemon thread every
    ``interval_s``."""

    def __init__(self, metrics, slos=None, interval_s=None,
                 timeline_samples=256, name="server"):
        from ..flags import FLAGS
        self.metrics = metrics
        self.name = str(name)
        self.interval_s = (float(FLAGS.slo_eval_interval_ms) / 1000.0
                           if interval_s is None else float(interval_s))
        self.interval_s = max(self.interval_s, 0.01)
        self._slos = dict(slos or {})      # model name (or '*') -> SLO
        self._timeline_cap = max(int(timeline_samples), 8)
        self._lock = threading.Lock()
        self._rings = {}     # lane key -> deque[_Sample]
        self._states = {}    # lane key -> state dict
        self._stop = threading.Event()
        self._thread = None
        self._ticks = 0

    @classmethod
    def from_flags(cls, metrics, name="server"):
        from ..flags import FLAGS
        return cls(metrics, slos=parse_slo_spec(FLAGS.serving_slo),
                   name=name)

    # -- sampling ------------------------------------------------------

    def _read_lane(self, mm, interval_s):
        s = _Sample()
        s.ts = time.time()
        s.mono = time.monotonic()
        s.requests = mm.requests.value
        s.responses = mm.responses.value
        s.errors = mm.errors.value
        s.shed = mm.shed.value
        s.deadline_expired = mm.deadline_expired.value
        s.draft_tokens = mm.draft_tokens.value
        s.accepted_tokens = mm.accepted_tokens.value
        # windowed percentiles over roughly the sampling interval — the
        # lifetime reservoir would blur a fresh regression under hours
        # of healthy history
        window = max(interval_s * 1.5, 0.05)
        s.p95_ms = mm.recent_latency_p95(window)
        s.ttft_p95_ms = mm.recent_ttft_p95(window)
        s.bad = {}
        return s

    @staticmethod
    def _bad_fractions(prev, cur, slo):
        """Reduce one interval (prev -> cur) to per-objective bad
        fractions; objectives without traffic contribute 0.0 (no data
        is not a burn)."""
        bad = {}
        done_d = max((cur.responses - prev.responses)
                     + (cur.errors - prev.errors), 0)
        req_d = max(cur.requests - prev.requests, 0)
        shed_d = max(cur.shed - prev.shed, 0)
        if slo.error_rate is not None:
            bad["error_rate"] = ((cur.errors - prev.errors) / done_d) \
                if done_d else 0.0
        if slo.shed_rate is not None:
            offered = req_d + shed_d
            bad["shed_rate"] = (shed_d / offered) if offered else 0.0
        if slo.p95_ms is not None:
            bad["p95_ms"] = 1.0 if (cur.p95_ms is not None
                                    and cur.p95_ms > slo.p95_ms) else 0.0
        if slo.ttft_p95_ms is not None:
            bad["ttft_p95_ms"] = 1.0 if (
                cur.ttft_p95_ms is not None
                and cur.ttft_p95_ms > slo.ttft_p95_ms) else 0.0
        if slo.spec_accept is not None:
            drafts_d = max(cur.draft_tokens - prev.draft_tokens, 0)
            if drafts_d:
                rate = (cur.accepted_tokens
                        - prev.accepted_tokens) / drafts_d
                bad["spec_accept"] = 1.0 if rate < slo.spec_accept \
                    else 0.0
            else:
                bad["spec_accept"] = 0.0
        return bad

    @staticmethod
    def _budget(slo, objective):
        if objective == "error_rate":
            return max(slo.error_rate, 1e-6)
        if objective == "shed_rate":
            return max(slo.shed_rate, 1e-6)
        return slo.budget

    def _burns(self, ring, slo):
        """{objective: {"fast": burn, "slow": burn|None}} over the two
        windows.  The fast window evaluates as soon as 2 intervals
        exist (hard outages trip early); the slow window only once it
        is FULL — a low-grade burn must prove itself over the whole
        window before it trips (trips late, by design)."""
        samples = list(ring)
        intervals = [s.bad for s in samples[1:] if s.bad is not None]
        out = {}
        for objective, _target in slo.objectives():
            series = [b.get(objective, 0.0) for b in intervals]
            budget = self._budget(slo, objective)
            fast_n = min(slo.fast_window, len(series))
            fast = (sum(series[-fast_n:]) / fast_n / budget) \
                if fast_n >= 2 else None
            slow = (sum(series[-slo.slow_window:]) / slo.slow_window
                    / budget) if len(series) >= slo.slow_window else None
            out[objective] = {"fast": fast, "slow": slow}
        return out

    # -- evaluation ----------------------------------------------------

    def _evaluate_locked(self, key, slo, burns):
        st = self._states.setdefault(
            key, {"state": STATE_OK, "bad_streak": 0, "good_streak": 0,
                  "breaches": 0, "recoveries": 0, "burns": {},
                  "tripped_by": None})
        st["burns"] = burns
        tripped = None
        worst = 0.0
        for objective, b in burns.items():
            if b["fast"] is not None and b["fast"] >= slo.fast_burn \
                    and b["fast"] / slo.fast_burn >= worst:
                tripped, worst = (objective, "fast"), \
                    b["fast"] / slo.fast_burn
            # the slow rule is gated on the SHORT window also burning
            # (Google's paired-window condition): without it, stale bad
            # intervals still inside the slow window would re-trip a
            # lane that has already recovered
            if b["slow"] is not None and b["slow"] >= slo.slow_burn \
                    and b["fast"] is not None \
                    and b["fast"] >= slo.slow_burn \
                    and b["slow"] / slo.slow_burn >= worst:
                tripped, worst = (objective, "slow"), \
                    b["slow"] / slo.slow_burn
        events = []
        if tripped is not None:
            st["bad_streak"] += 1
            st["good_streak"] = 0
            st["tripped_by"] = tripped[0]
            if st["bad_streak"] >= slo.breach_evals:
                if st["state"] != STATE_BREACH:
                    st["state"] = STATE_BREACH
                    st["breaches"] += 1
                    b = burns[tripped[0]]
                    events.append(("slo_breach", {
                        "model": key, "objective": tripped[0],
                        "window": tripped[1],
                        "burn_fast": round(b["fast"], 3)
                        if b["fast"] is not None else None,
                        "burn_slow": round(b["slow"], 3)
                        if b["slow"] is not None else None}))
            elif st["state"] == STATE_OK:
                st["state"] = STATE_DEGRADED
                events.append(("slo_degraded", {
                    "model": key, "objective": tripped[0],
                    "window": tripped[1]}))
        else:
            st["good_streak"] += 1
            st["bad_streak"] = 0
            if st["state"] != STATE_OK \
                    and st["good_streak"] >= slo.recover_evals:
                st["state"] = STATE_OK
                st["recoveries"] += 1
                st["tripped_by"] = None
                events.append(("slo_recovered", {"model": key}))
        return events

    def tick(self):
        """One sample + evaluate pass over every live metrics lane.
        Returns the emitted (kind, fields) transition events."""
        from . import events as obs_events
        interval = self.interval_s
        with self.metrics._lock:
            lanes = dict(self.metrics._models)
        emitted = []
        with self._lock:
            self._ticks += 1
            # an unloaded model's lane leaves the metrics registry:
            # drop its ring/state so health() reflects what is served
            for gone in [k for k in self._rings if k not in lanes]:
                self._rings.pop(gone, None)
                self._states.pop(gone, None)
            for key, mm in lanes.items():
                ring = self._rings.get(key)
                if ring is None:
                    ring = self._rings[key] = collections.deque(
                        maxlen=self._timeline_cap)
                sample = self._read_lane(mm, interval)
                slo = (self._slos.get(key)
                       or self._slos.get(key.split("@", 1)[0])
                       or self._slos.get("*"))
                if ring and slo is not None:
                    sample.bad = self._bad_fractions(ring[-1], sample,
                                                     slo)
                ring.append(sample)
                if slo is None:
                    continue
                burns = self._burns(ring, slo)
                emitted.extend(self._evaluate_locked(key, slo, burns))
        # emit OUTSIDE the lock
        # emit (and fire the flight recorder) outside the lock: the
        # recorder's providers may read this monitor back
        for kind, fields in emitted:
            obs_events.emit(kind, monitor=self.name, **fields)
            if kind == "slo_breach":
                from . import flightrec
                flightrec.trigger("slo_breach", **fields)
        return emitted

    # -- thread lifecycle ----------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="paddle-tpu-torch-slo-monitor-%s" % self.name)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # judgment must never take down the serving process;
                # a broken tick retries next interval
                pass

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    @property
    def running(self):
        t = self._thread
        return bool(t is not None and t.is_alive())

    # -- readouts ------------------------------------------------------

    def state(self):
        """Wire-encodable per-lane SLO readout (the `health` RPC's
        ``slo`` section)."""
        with self._lock:
            out = {}
            for key, ring in self._rings.items():
                slo = (self._slos.get(key)
                       or self._slos.get(key.split("@", 1)[0])
                       or self._slos.get("*"))
                st = self._states.get(key)
                info = {"samples": len(ring),
                        "monitored": slo is not None}
                if ring:
                    info["last_sample_age_s"] = round(
                        max(time.monotonic() - ring[-1].mono, 0.0), 3)
                if slo is not None:
                    info["slo"] = slo.to_dict()
                if st is None:
                    info["state"] = STATE_OK if slo is not None else None
                else:
                    info["state"] = st["state"]
                    info["breaches"] = st["breaches"]
                    info["recoveries"] = st["recoveries"]
                    if st["tripped_by"]:
                        info["tripped_by"] = st["tripped_by"]
                    burns = {}
                    for objective, b in (st["burns"] or {}).items():
                        burns[objective] = {
                            w: (round(v, 3) if v is not None else None)
                            for w, v in b.items()}
                    if burns:
                        info["burn"] = burns
                out[key] = info
            return out

    def timeline(self, model=None, n=None):
        """The bounded time-series ring (the flight-recorder bundle's
        timeline): {lane key: [sample dicts, oldest first]}."""
        with self._lock:
            out = {}
            for key, ring in self._rings.items():
                if model is not None and key != model:
                    continue
                samples = list(ring)
                if n is not None:
                    samples = samples[-int(n):]
                out[key] = [s.to_dict() for s in samples]
            return out

    def export(self):
        """Prometheus samples for the registry render:
        [(metric, labels, value, type)].  State codes: 0 ok,
        1 degraded, 2 breach."""
        with self._lock:
            rows = []
            for key in sorted(self._rings):
                model, _, prec = key.partition("@")
                labels = {"model": model}
                if prec:
                    labels["precision"] = prec
                st = self._states.get(key)
                slo = (self._slos.get(key) or self._slos.get(model)
                       or self._slos.get("*"))
                if slo is None:
                    continue
                state = st["state"] if st else STATE_OK
                rows.append(("slo_state", dict(labels),
                             _STATE_CODE[state], "gauge"))
                for objective, b in ((st or {}).get("burns")
                                     or {}).items():
                    for window in ("fast", "slow"):
                        if b.get(window) is not None:
                            rows.append((
                                "slo_burn_rate",
                                dict(labels, objective=objective,
                                     window=window),
                                round(b[window], 4), "gauge"))
                # compliance: the fraction of recent intervals that met
                # the objective (1.0 = clean slow window)
                ring = self._rings.get(key)
                intervals = [s.bad for s in list(ring)[1:]
                             if s.bad is not None] if ring else []
                for objective, _t in slo.objectives():
                    series = [b.get(objective, 0.0) for b in
                              intervals[-slo.slow_window:]]
                    if series:
                        rows.append((
                            "slo_compliance",
                            dict(labels, objective=objective),
                            round(1.0 - sum(series) / len(series), 4),
                            "gauge"))
            return rows
