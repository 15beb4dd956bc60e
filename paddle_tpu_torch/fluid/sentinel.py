"""Anomaly sentinel, after paddle_tpu/fluid/sentinel.py: NaN/Inf step
screening with a skip / rollback policy.

The Trainer drives a small state machine each step:

    verdict = sentinel.observe(named_values)   # OK / SKIP / ROLLBACK

* finite values reset the consecutive-bad counter (OK);
* a non-finite value is a bad step: SKIP (revert to the pre-step state
  and move on) while fewer than `max_bad_steps` consecutive bad steps
  have been seen, then ROLLBACK (reload the last-good checkpoint) when
  the policy allows it;
* under policy "skip" the K-th consecutive bad step raises
  SentinelError: silent divergence is never an option.

The port's steps never write a state tensor in place (the optimizer
lowerings return new tensors and the Executor rebinds the scope's
names), so "revert the step" restores the pre-step dict of tensor
references: no copies, no device traffic.

Under async dispatch (FLAGS.async_dispatch_depth > 0) the Trainer
screens step t at the drain while steps t+1..t+k (k <= depth) are in
flight; `observe(..., step=)` records which step was screened
(`last_step_observed`, `max_observe_lag`).  When a bad step is reverted
those in-flight steps were computed from the poisoned state: the
Trainer discards them unobserved and redispatches their batches
(`note_inflight_discarded`, `total_discarded`); a discard neither
extends nor resets the bad streak.  A rollback and a giveup fire the
flight recorder.
"""

import numpy as np

__all__ = ["OK", "SKIP", "ROLLBACK", "SentinelError", "AnomalySentinel",
           "non_finite_names"]

OK = "ok"
SKIP = "skip"
ROLLBACK = "rollback"

POLICIES = ("skip", "rollback")


class SentinelError(FloatingPointError):
    """Training is non-finite beyond what the policy can absorb."""


def non_finite_names(named_values):
    """Names (in order) whose float values contain NaN/Inf.  Accepts an
    iterable of (name, array-like or torch tensor); None values are
    ignored.  Tensors are tested on their device and their flags read
    back together (one host read)."""
    import torch
    named = [(n, v) for n, v in named_values if v is not None]
    flags = {}
    dev = [(n, v) for n, v in named if isinstance(v, torch.Tensor)
           and v.is_floating_point()]
    if dev:
        ok = torch.stack([torch.isfinite(v).all().to(dev[0][1].device)
                          for _, v in dev]).cpu().tolist()
        flags.update((n, o) for (n, _), o in zip(dev, ok))
    bad = []
    for name, val in named:
        if isinstance(val, torch.Tensor):
            if not flags.get(name, True):
                bad.append(name)
            continue
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)  # ml_dtypes: kind 'V', no isfinite
        if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
            bad.append(name)
    return bad


class AnomalySentinel:
    def __init__(self, max_bad_steps=3, policy="skip", check_params=False,
                 pipeline_depth=0):
        if policy not in POLICIES:
            raise ValueError("sentinel policy must be one of %s, got %r"
                             % (POLICIES, policy))
        self.max_bad_steps = max(int(max_bad_steps), 1)
        self.policy = policy
        self.check_params = bool(check_params)
        # async-pipeline lag bound: checks run at the drain, <= this
        # many steps behind dispatch (0 = fully synchronous screening)
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.consecutive_bad = 0
        self.total_bad = 0
        self.total_rollbacks = 0
        self.total_discarded = 0
        self.last_bad_names = []
        self.last_step_observed = None
        self.steps_observed = 0
        self.max_observe_lag = 0

    def observe(self, named_values, step=None):
        """Screen one step's fetched values; returns OK, SKIP or
        ROLLBACK.  Raises SentinelError when the bad-step budget is
        exhausted and the policy has no rollback (or rollback already
        happened for this bad streak — a checkpoint that itself diverges
        must not loop forever).  `step` is the dispatch-order step id
        being screened (the async Trainer drains behind dispatch, so
        this lags the newest dispatched step by <= pipeline_depth)."""
        from ..obs import events as obs_events
        self.steps_observed += 1
        if step is not None:
            self.last_step_observed = step
        bad = non_finite_names(named_values)
        self.last_bad_names = bad
        if not bad:
            self.consecutive_bad = 0
            return OK
        self.consecutive_bad += 1
        self.total_bad += 1
        if self.consecutive_bad < self.max_bad_steps:
            # structured lifecycle record: skips/rollbacks stamped with
            # the step id so the event log cross-references the train
            # spans and the checkpoint commits
            obs_events.emit("sentinel_skip", step=step,
                            bad=",".join(bad),
                            consecutive=self.consecutive_bad)
            return SKIP
        if self.policy == "rollback":
            if self.total_rollbacks >= 1 and \
                    self.consecutive_bad >= 2 * self.max_bad_steps:
                obs_events.emit("sentinel_giveup", step=step,
                                bad=",".join(bad))
                from ..obs import flightrec
                flightrec.trigger("sentinel_giveup", step=step,
                                  bad=",".join(bad))
                raise SentinelError(
                    "sentinel: still non-finite (%s) after a rollback to "
                    "the last-good checkpoint — giving up"
                    % ", ".join(bad))
            self.total_rollbacks += 1
            obs_events.emit("sentinel_rollback", step=step,
                            bad=",".join(bad),
                            consecutive=self.consecutive_bad)
            # the pre-rollback evidence (which fetches went non-finite,
            # what the pipeline was doing) evaporates with the restore
            # — bundle it now (no-op while FLAGS.flight_dir unset)
            from ..obs import flightrec
            flightrec.trigger("sentinel_rollback", step=step,
                              bad=",".join(bad))
            return ROLLBACK
        obs_events.emit("sentinel_giveup", step=step, bad=",".join(bad),
                        consecutive=self.consecutive_bad)
        from ..obs import flightrec
        flightrec.trigger("sentinel_giveup", step=step,
                          bad=",".join(bad))
        raise SentinelError(
            "sentinel: %d consecutive non-finite steps (%s) under policy "
            "'skip' with no rollback target — raising instead of "
            "training on garbage" % (self.consecutive_bad,
                                     ", ".join(bad)))

    def note_rollback_done(self):
        """The caller restored the last-good checkpoint; the bad streak
        counter keeps running so a re-diverging rollback can give up."""

    def note_inflight_discarded(self, count, newest_step=None):
        """The caller reverted a bad step and dropped `count` in-flight
        steps un-observed (they were dispatched from the poisoned
        state).  Pure bookkeeping: discarded steps were never screened,
        so the consecutive-bad streak is untouched; the count feeds the
        Trainer's recovery warning and the max_observe_lag statistic."""
        count = int(count)
        self.total_discarded += count
        if count > self.max_observe_lag:
            self.max_observe_lag = count
        if count:
            from ..obs import events as obs_events
            obs_events.emit("sentinel_discard", count=count,
                            newest_step=newest_step,
                            total=self.total_discarded)
        return self.total_discarded
