"""Named, versioned model registry with device-placed replicas and
atomic hot swap, after paddle_tpu/serving/model_registry.py.

Each model name maps to versioned entries, each holding N replica
predictors fronted by one batcher (a DynamicBatcher for a
`save_inference_model` artifact, a DecodeBatcher for a decode artifact);
requests route through a `latest` pointer per precision lane.

Placement (`resolve_placement`): `FLAGS.serving_replicas` or a per-load
override — an int N (N replicas round-robin over the visible cards),
'auto' (one replica per card) or an explicit device list ('cuda:0,cuda:1',
local card indices '0,1', or 'cpu').  Entry points run on the card: the
default is `cuda:0`, and a host without CUDA raises unless the caller
names `cpu`.  The artifact is loaded once; each further replica is a
`clone_to(device)` holding its own parameter copy on its card.

A hot swap builds ALL new replicas completely (load, clone, batcher,
warm every bucket on every replica), then flips `latest` under the
routing lock, and only afterwards drains and retires the displaced
replica set: no request is dropped or answered twice.  Precision lanes
(an fp32 artifact and its int8 PTQ twin under one name) are an A/B axis,
not a hot swap: loading one never touches the other, and default
traffic splits by `ab_weight` or stays on fp32.

Not ported yet (ROADMAP.md queue 1): the admission fit check (needs
`analysis/`, item 15), AOT artifacts and the compile cache (item 11),
mesh replicas (item 12), and paging, fault-in and resize (with the
fleet controller).
"""

import os
import threading

import numpy as np
import torch

from .. import resolve_device
from ..flags import FLAGS
from ..obs import events as obs_events
from .batcher import DecodeBatcher, DynamicBatcher
from .metrics import ServingMetrics

__all__ = ["ModelRegistry", "ModelEntry", "open_predictor",
           "resolve_placement"]


def _one_device(tok):
    """One placement element as a torch.device: a torch.device, a card
    index (int or digit string), or a device string ('cuda:1', 'cpu')."""
    if isinstance(tok, torch.device):
        dev = tok
    elif isinstance(tok, int) or str(tok).strip().isdigit():
        dev = torch.device("cuda", int(tok))
    else:
        dev = torch.device(str(tok).strip())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        idx = 0 if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise ValueError("no card cuda:%d (this host has %d)"
                             % (idx, torch.cuda.device_count()))
        dev = torch.device("cuda", idx)
    elif dev.type == "cpu":
        dev = torch.device("cpu")
    return dev


def resolve_placement(spec=None):
    """Turn a replica placement spec into a list of torch.devices, one
    per replica.

    spec: None -> FLAGS.serving_replicas; int or digit-string N -> N
    replicas round-robin over the visible cards (N == 1 -> [cuda:0]);
    'auto' -> one replica per visible card; a comma list or sequence of
    card indices ('0,1'), device strings ('cuda:1', 'cpu') or
    torch.devices -> exactly those (a device may repeat).  The mesh
    forms ('mesh:N', 'a+b' groups) raise: mesh replicas wait (ROADMAP.md
    queue 1, item 12)."""
    if spec is None:
        spec = FLAGS.serving_replicas
    if isinstance(spec, str) and ("+" in spec or spec.strip()
                                  .startswith("mesh:")):
        raise NotImplementedError(
            "mesh placement %r: mesh replicas are not ported to "
            "paddle_tpu_torch yet (ROADMAP.md queue 1, item 12)" % spec)
    if isinstance(spec, (list, tuple)):
        devs = [_one_device(t) for t in spec
                if not (isinstance(t, str) and not t.strip())]
        if not devs:
            raise ValueError("empty replica device list")
        return devs
    if isinstance(spec, str):
        s = spec.strip()
        if s == "auto":
            n = torch.cuda.device_count()
            if n < 1:
                raise RuntimeError(
                    "placement 'auto' needs CUDA, and this host has no "
                    "card; name 'cpu' explicitly for the plain path")
            return [torch.device("cuda", i) for i in range(n)]
        if "," in s or ":" in s or not s.isdigit():
            return resolve_placement([p for p in s.split(",")
                                      if p.strip()])
        spec = int(s)
    n = int(spec)
    if n < 1:
        raise ValueError("replica count must be >= 1, got %d" % n)
    first = resolve_device(torch.device("cuda", 0))
    cards = max(torch.cuda.device_count(), 1)
    return [first] + [torch.device("cuda", i % cards) for i in range(1, n)]


def open_predictor(path, buckets=None, device=None, kv_cache_dtype=None):
    """Open a serving artifact directory on `device` as the right
    predictor: a `decode_meta.bin` dir as a GenerativePredictor, any other
    directory as a `save_inference_model` Predictor under AnalysisConfig
    (bucketed; `buckets` overrides).  `kv_cache_dtype` (decode artifacts
    only) overrides the artifact's cache-numerics pin.  An AOT artifact
    (`aot_meta.bin`) raises: AOT serving waits (ROADMAP.md queue 1,
    item 11)."""
    from ..inference import AnalysisConfig, Predictor
    from ..inference.decode import DECODE_META, GenerativePredictor
    if os.path.exists(os.path.join(path, DECODE_META)):
        return GenerativePredictor(path, device=device,
                                   kv_cache_dtype=kv_cache_dtype)
    if os.path.exists(os.path.join(path, "aot_meta.bin")):
        raise NotImplementedError(
            "%r is a save_aot artifact: AOT serving and the compile cache "
            "are not ported to paddle_tpu_torch yet (ROADMAP.md queue 1, "
            "item 11); serve the save_inference_model directory" % path)
    if not os.path.isdir(path):
        raise FileNotFoundError("no model artifact directory at %r" % path)
    config = AnalysisConfig(model_dir=path)
    if buckets:
        config.batch_size_buckets = tuple(sorted(int(b) for b in buckets))
    return Predictor(config, device=device)


def _build_replicas(path, buckets, devices, kv_cache_dtype=None):
    """One artifact load + (N-1) clone_to placements: each replica holds
    its own parameter copy on its device."""
    first = open_predictor(path, buckets=buckets, device=devices[0],
                           kv_cache_dtype=kv_cache_dtype)
    preds = [first]
    for dev in devices[1:]:
        preds.append(first.clone_to(dev))
    return preds


class ModelEntry:
    """One (name, version): its replica predictors, the batcher fronting
    them, and its path.  `predictor` stays the first replica — the
    introspection surface (buckets, feed specs) is the same on every
    replica."""

    def __init__(self, name, version, path, predictor, batcher,
                 replicas=None, devices=None, precision="fp32",
                 draft_path=None):
        self.name = name
        self.version = version
        self.path = path
        self.predictor = predictor
        self.batcher = batcher
        self.replicas = list(replicas) if replicas else [predictor]
        self.devices = list(devices) if devices else \
            [p.device for p in self.replicas]
        # the numerics lane this version serves: 'int8' for a PTQ
        # artifact, 'fp32' otherwise
        self.precision = str(precision or "fp32")
        # the draft artifact this entry's decode lanes draft with
        self.draft_path = draft_path

    def device_labels(self):
        from ..inference.predictor import _device_label
        return [_device_label(d) for d in self.devices]

    @property
    def is_decode(self):
        return bool(getattr(self.predictor, "is_decode", False))

    def warm(self):
        """Run one zero batch per bucket DIRECTLY on every replica (not
        through the batcher: warming must not mix with traffic), so the
        first real request on any lane runs at steady state: the
        kernels are built and the allocator holds each bucket's shapes.
        A decode model warms its lanes' own sessions before any request
        is routed to them (DecodeBatcher.warm): every prompt bucket's
        prefill and one dispatch of the lane's kind, its CUDA graph
        included on the card."""
        if self.is_decode:
            self.batcher.warm()
            return self
        specs = self.predictor.feed_specs()
        buckets = self.predictor.batch_buckets() or (1,)
        batched = self.predictor.batched_feed_names()
        for pred in self.replicas:
            for cap in buckets:
                feeds = {}
                for fname, (shape, dtype) in specs.items():
                    fill = cap if fname in batched else 1
                    feeds[fname] = np.zeros(
                        tuple(fill if d == -1 else d for d in shape),
                        dtype=np.dtype(dtype))
                pred.run(feeds)
        return self


class ModelRegistry:
    """name -> {versions, latest per precision lane} with hot swap and
    drain-on-retire."""

    def __init__(self, metrics=None, max_queue=None, deadline_ms=None,
                 workers=None, replicas=None):
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._max_queue = max_queue
        self._deadline_ms = deadline_ms
        self._workers = workers
        self._replicas = replicas  # default placement spec for loads
        self._lock = threading.Lock()
        self._models = {}  # name -> {"versions", "latest", "latest_prec",
        #                             "ab", "ab_credit"}

    # ------------------------------------------------------------------

    @staticmethod
    def _fit_check(name, path, placement):
        """The JAX registry's static admission gate analyzes the artifact
        and rejects a placement whose estimated peak memory does not fit
        a device.  It needs the resource analysis of `analysis/`, which
        is not ported yet (ROADMAP.md queue 1, item 15): until then a
        load is admitted unchecked, and says so in a `model_fit_unchecked`
        event.  A load that does not fit fails in the build with the
        card's out-of-memory error instead."""
        from ..inference.predictor import _device_label
        obs_events.emit("model_fit_unchecked", model=name, path=path,
                        devices=",".join(_device_label(d)
                                         for d in placement),
                        reason="analysis/ not ported")

    def load_model(self, name, path, version=None, warm=True,
                   buckets=None, drain_timeout=30.0, replicas=None,
                   devices=None, decode_slots=None, decode_mode=None,
                   precision=None, ab_weight=None, draft=None,
                   spec_k=None, kv_cache_dtype=None, fuse_steps=None):
        """Load (or hot-swap in) `path` as `name`; returns the entry.
        `replicas`/`devices` override the registry's default placement
        (resolve_placement).  ALL replicas are built and warmed before
        the flip; the displaced latest version OF THE SAME PRECISION
        LANE, if any, is drained and retired after it.

        `precision` overrides the artifact's own lane ('int8' for a PTQ
        artifact, else 'fp32'); `ab_weight` sets this lane's share of
        default-routed traffic (requests naming no precision).  Without
        weights default traffic stays on the fp32 lane.

        A decode artifact is fronted by a DecodeBatcher: per-replica slot
        tables of `decode_slots` (default FLAGS.serving_decode_slots),
        `decode_mode="static"` for the static-batching baseline,
        `kv_cache_dtype` ('int8' or 'float32'; default the artifact's pin,
        then FLAGS.serving_kv_cache_dtype), `fuse_steps` (default
        FLAGS.serving_decode_fuse_steps) and `draft`/`spec_k` (default
        FLAGS.serving_spec_draft / FLAGS.serving_spec_k): a draft
        artifact built on the same placement, one draft replica per
        target replica."""
        spec = devices if devices is not None else (
            replicas if replicas is not None else self._replicas)
        placement = resolve_placement(spec)
        is_decode_path = os.path.exists(
            os.path.join(path, "decode_meta.bin"))
        draft_path, spec_depth = None, 0
        if is_decode_path:
            # normalize at admission: a bad wire value is a typed error
            # before any build work
            from ..inference.decode import normalize_kv_dtype
            if kv_cache_dtype is not None:
                kv_cache_dtype = normalize_kv_dtype(kv_cache_dtype)
            spec_depth = int(FLAGS.serving_spec_k if spec_k is None
                             else spec_k)
            draft_path = draft if draft is not None \
                else (FLAGS.serving_spec_draft or None)
            if not draft_path or spec_depth < 1:
                draft_path, spec_depth = None, 0
        else:
            kv_cache_dtype = None
        self._fit_check(name, path, placement)
        preds = _build_replicas(path, buckets, placement,
                                kv_cache_dtype=kv_cache_dtype)
        precision = str(precision or getattr(preds[0], "precision",
                                             "fp32"))
        lane_metrics = self.metrics.model(name, precision)
        if getattr(preds[0], "is_decode", False):
            draft_preds = _build_replicas(draft_path, None, placement) \
                if draft_path else None
            batcher = DecodeBatcher(
                preds[0], replicas=preds, n_slots=decode_slots,
                max_queue=self._max_queue, metrics=lane_metrics,
                continuous=(decode_mode != "static"),
                draft_replicas=draft_preds, spec_k=spec_depth,
                fuse_steps=fuse_steps)
        else:
            batcher = DynamicBatcher(
                preds[0], max_queue=self._max_queue,
                deadline_ms=self._deadline_ms, workers=self._workers,
                metrics=lane_metrics, replicas=preds)
        entry = ModelEntry(name, version, path, preds[0], batcher,
                           replicas=preds, devices=placement,
                           precision=precision, draft_path=draft_path)
        if warm:
            try:
                entry.warm()
            except BaseException:
                batcher.close(drain=False, timeout=1.0)
                raise
        displaced = None
        with self._lock:
            slot = self._models.setdefault(
                name, {"versions": {}, "latest": None,
                       "latest_prec": {}, "ab": {}, "ab_credit": {}})
            if version is None:
                prev = [v for v in slot["versions"] if isinstance(v, int)]
                version = entry.version = (max(prev) + 1) if prev else 1
            # hot swap is per precision lane: the displaced set is the
            # old latest of THIS lane, never the A/B sibling
            old_lane = slot["latest_prec"].get(precision)
            if old_lane is not None and old_lane != version:
                displaced = slot["versions"].get(old_lane)
            replaced_same = slot["versions"].get(version)
            slot["versions"][version] = entry
            slot["latest"] = version  # the atomic flip
            slot["latest_prec"][precision] = version
            if ab_weight is not None:
                slot["ab"][precision] = float(ab_weight)
        obs_events.emit("hot_swap", model=name, version=version,
                        from_version=old_lane, precision=precision,
                        replicas=len(entry.replicas))
        for old in (displaced, replaced_same):
            if old is not None and old is not entry:
                old.batcher.close(drain=True, timeout=drain_timeout)
                with self._lock:
                    slot = self._models.get(name)
                    if slot and slot["versions"].get(old.version) is old:
                        del slot["versions"][old.version]
        return entry

    def set_ab_weights(self, name, weights):
        """Set the default-traffic split across precision lanes, e.g.
        ``{"fp32": 0.5, "int8": 0.5}``.  Requests naming a `precision`
        (or `version`) bypass it.  A lane absent from the dict shares
        what the named lanes leave unassigned."""
        clean = {str(k): float(v) for k, v in dict(weights).items()
                 if float(v) > 0.0}
        with self._lock:
            slot = self._models.get(name)
            if slot is None:
                raise KeyError("no model %r" % name)
            slot["ab"] = clean
            slot["ab_credit"] = {}

    def unload_model(self, name, drain_timeout=30.0):
        """Remove `name`: new requests fail immediately, queued and
        in-flight ones drain first."""
        with self._lock:
            slot = self._models.pop(name, None)
        if slot is None:
            raise KeyError("no model %r" % name)
        for entry in slot["versions"].values():
            entry.batcher.close(drain=True, timeout=drain_timeout)
        self.metrics.drop(name)
        obs_events.emit("model_unloaded", model=name,
                        lanes=len(slot["latest_prec"]))

    def describe(self):
        with self._lock:
            out = {}
            for name, slot in self._models.items():
                info = {"latest": slot["latest"],
                        "versions": sorted(slot["versions"])}
                lanes = slot["latest_prec"]
                if lanes:
                    info["precisions"] = dict(sorted(lanes.items()))
                    if slot["ab"]:
                        info["ab_weights"] = dict(
                            sorted(slot["ab"].items()))
                latest = slot["versions"].get(slot["latest"])
                if latest is not None:
                    info["buckets"] = list(
                        latest.predictor.batch_buckets())
                    info["replicas"] = len(latest.replicas)
                    info["devices"] = latest.device_labels()
                    info["precision"] = latest.precision
                    if latest.is_decode:
                        # buckets above are the PROMPT prefill buckets
                        info["decode"] = True
                        info["decode_slots"] = latest.batcher.n_slots
                        info["max_seq_len"] = \
                            latest.predictor.max_seq_len
                        info["eos_id"] = latest.predictor.eos_id
                        info["kv_cache_dtype"] = str(
                            latest.predictor.kv_cache_dtype)
                        info["fuse_steps"] = int(latest.batcher.fuse_steps)
                        if latest.batcher.spec_k:
                            info["spec_k"] = latest.batcher.spec_k
                            info["draft"] = latest.draft_path
                else:
                    info["buckets"] = []
                out[name] = info
            return out

    def health(self):
        """Per-model liveness (the `health` verb's ``models`` section):
        for each precision lane's routed version, the batcher's thread
        and lane liveness plus queue depth.  The slots are snapshotted
        under the lock and the batchers read outside it."""
        with self._lock:
            snap = []
            for name, slot in self._models.items():
                lanes = dict(slot["latest_prec"])
                if not lanes and slot["latest"] is not None:
                    lanes = {"fp32": slot["latest"]}
                snap.append((name, slot["latest"],
                             sorted(slot["versions"]),
                             [(prec, v, slot["versions"].get(v))
                              for prec, v in sorted(lanes.items())]))
        out = {}
        for name, latest, versions, lanes in snap:
            minfo = {"latest": latest, "versions": versions, "lanes": {}}
            for prec, v, entry in lanes:
                if entry is None:
                    continue
                li = {"version": v,
                      "queue_depth": entry.batcher.queue_depth(),
                      "decode": entry.is_decode}
                try:
                    li["liveness"] = entry.batcher.lane_liveness()
                except Exception as e:
                    li["liveness"] = {"error": "%s: %s"
                                      % (type(e).__name__, e)}
                if entry.is_decode:
                    ages = [l.get("last_step_age_s")
                            for l in li["liveness"].get("lanes", [])
                            if l.get("last_step_age_s") is not None]
                    li["last_decode_step_age_s"] = min(ages) \
                        if ages else None
                minfo["lanes"][prec] = li
            out[name] = minfo
        return out

    # ------------------------------------------------------------------

    def _entry_locked(self, name, version, precision=None):
        slot = self._models.get(name)
        if slot is None:
            raise KeyError("no model %r" % name)
        v = self._route_version_locked(slot, name, precision) \
            if version is None else version
        entry = slot["versions"].get(v)
        if entry is None:
            raise KeyError("model %r has no version %r" % (name, v))
        return entry

    @staticmethod
    def _route_version_locked(slot, name, precision):
        """The precision router.  An explicit `precision` resolves to
        that lane's latest (KeyError when it was never loaded).  Default
        traffic: with A/B weights a smooth weighted round-robin over the
        live lanes (deterministic, exact shares over any window);
        without them the fp32 lane when there is one, else the latest."""
        lanes = slot["latest_prec"]
        if precision is not None:
            v = lanes.get(str(precision))
            if v is None:
                raise KeyError(
                    "model %r has no %r precision lane (have %s)"
                    % (name, precision, sorted(lanes) or ["fp32"]))
            return v
        ab = {p: w for p, w in slot["ab"].items()
              if p in lanes and w > 0.0}
        if len(lanes) > 1 and ab:
            others = [p for p in lanes if p not in ab]
            rem = max(0.0, 1.0 - sum(ab.values()))
            if others and rem > 0.0:
                for p in others:
                    ab[p] = rem / len(others)
            credit = slot["ab_credit"]
            total = sum(ab.values())
            for p, w in ab.items():
                credit[p] = credit.get(p, 0.0) + w
            pick = max(sorted(ab), key=lambda p: credit.get(p, 0.0))
            credit[pick] -= total
            return lanes[pick]
        if len(lanes) > 1 and "fp32" in lanes:
            return lanes["fp32"]
        return slot["latest"]

    def submit(self, name, feeds, version=None, deadline=None,
               priority=0, trace_id=None, max_new_tokens=None,
               chunk_tokens=None, precision=None):
        """Route one request; returns the batcher's Future (a
        DecodeStream on a decode entry, whose `result()` is the whole
        greedy stream; `feeds` must then carry the prompt as "tokens").
        Resolution and submit happen under ONE lock acquisition, so a
        concurrent hot swap never retires a version between the two."""
        with self._lock:
            entry = self._entry_locked(name, version, precision=precision)
            if entry.is_decode:
                if not isinstance(feeds, dict) or "tokens" not in feeds:
                    raise ValueError(
                        "decode model %r takes feeds {'tokens': int "
                        "array}, got %s"
                        % (name, sorted(feeds) if isinstance(feeds, dict)
                           else type(feeds).__name__))
                return entry.batcher.submit(
                    feeds["tokens"], max_new_tokens=max_new_tokens,
                    deadline=deadline, priority=priority,
                    trace_id=trace_id, chunk_tokens=chunk_tokens)
            return entry.batcher.submit(feeds, deadline=deadline,
                                        priority=priority,
                                        trace_id=trace_id)

    def submit_stream(self, name, tokens, version=None,
                      max_new_tokens=None, deadline=None, priority=0,
                      trace_id=None, chunk_tokens=None):
        """Streaming generation: the DecodeStream whose token chunks the
        server's `infer_stream` verb flushes to the wire."""
        with self._lock:
            entry = self._entry_locked(name, version)
            if not entry.is_decode:
                raise ValueError(
                    "model %r is not a decode model — infer_stream "
                    "serves autoregressive artifacts only" % name)
            return entry.batcher.submit(
                tokens, max_new_tokens=max_new_tokens, deadline=deadline,
                priority=priority, trace_id=trace_id,
                chunk_tokens=chunk_tokens)

    def infer(self, name, feeds, version=None, deadline=None,
              timeout=None, priority=0, precision=None):
        """Blocking submit + wait for in-process callers."""
        return self.submit(name, feeds, version=version,
                           deadline=deadline, priority=priority,
                           precision=precision).result(timeout=timeout)

    def close_all(self, drain=True, timeout=30.0):
        with self._lock:
            slots = list(self._models.values())
            self._models.clear()
        for slot in slots:
            for entry in slot["versions"].values():
                entry.batcher.close(drain=drain, timeout=timeout)
