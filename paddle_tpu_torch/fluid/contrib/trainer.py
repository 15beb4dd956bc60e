"""High-level Trainer with events, checkpointing and the async training
pipeline, after paddle_tpu/fluid/contrib/trainer.py (reference
python/paddle/fluid/contrib/trainer.py: Trainer, the Begin/End
Epoch/Step events, CheckpointConfig auto-save and resume).

    trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                    place=fluid.CUDAPlace(0),
                                    checkpoint_config=cfg)
    trainer.train(num_epochs, event_handler, reader=reader,
                  feed_order=["x", "y"])

`place=None` means the card.  With `FLAGS.async_dispatch_depth > 0` the
train loop keeps up to N steps in flight as FetchFutures
(Executor.run(as_future=True)) and drains the loss bookkeeping, the
sentinel's NaN/Inf screen and the EndStepEvent callbacks from the
pipeline tail: one host sync (one batched copy) per drained step.
`FLAGS.reader_prefetch_depth > 0` stages the next batches on the card
from a background thread (reader.prefetch_to_device: prepare_feeds, then
a pinned, non-blocking copy on a side stream) while the current step
computes.  The async trajectory is bit for bit the sync one on finite
runs: the feeds, the dispatch order on the compute stream and the
Executor's RNG step folds are the same; only when the host looks at the
results changes.  With `FLAGS.sentinel_nan_check` the anomaly sentinel
(fluid/sentinel.py) screens every drained step: a bad step is reverted
to its pre-dispatch state, the steps in flight behind it are discarded
and their batches redispatched, and the policy escalates to a rollback
to the last-good checkpoint of the vault (fluid/checkpoint.py) or to
SentinelError.
"""

import collections
import os

import numpy as np

from .. import core
from ..framework import Program
from ..executor import Executor, global_scope
from .. import io as fluid_io

__all__ = ["BeginEpochEvent", "EndEpochEvent", "BeginStepEvent",
           "EndStepEvent", "CheckpointConfig", "Trainer"]


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """reference contrib/trainer.py:100.  `max_num_checkpoints` drives
    the vault's keep-N rotation (fluid/checkpoint.py); `async_save`
    commits checkpoints on the background saver thread so the train loop
    doesn't stall on IO (Trainer joins pending saves at train() exit)."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10, async_save=False):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            ".", "checkpoints")
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(int(epoch_interval), 1)
        self.step_interval = max(int(step_interval), 1)
        self.async_save = bool(async_save)
        self.epoch_id = 0
        self.step_id = 0
        self.epoch_step = 0
        self.load_serial = None


class _PendingStep:
    """One dispatched-but-undrained step of the async pipeline: the
    FetchFuture plus everything the drain needs — the (epoch, step) ids
    for the deferred EndStepEvent, the feed/fetch lists so a sentinel
    recovery can re-dispatch this batch from a restored state, and the
    pre/post persistable ref snapshots (a step never writes a state
    tensor in place, so references are snapshots) that make the
    skip/rollback machinery depth-aware."""

    __slots__ = ("epoch", "step", "feed", "fetch", "future", "pre", "post")

    def __init__(self, epoch, step, feed, fetch, future, pre, post):
        self.epoch = epoch
        self.step = step
        self.feed = feed
        self.fetch = fetch
        self.future = future
        self.pre = pre
        self.post = post


class Trainer:
    """reference contrib/trainer.py:169. `train_func` builds the loss (and
    optionally extra metrics) in the current program; `optimizer_func`
    returns an optimizer."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        self.checkpoint_cfg = checkpoint_config
        self.place = place if place is not None else core.CUDAPlace(0)
        self.parallel = parallel
        self.train_program = Program()
        self.startup_program = Program()
        from ..framework import program_guard
        from .. import unique_name
        with program_guard(self.train_program, self.startup_program), \
                unique_name.guard():
            ret = train_func()
            if isinstance(ret, (list, tuple)):
                self.train_outputs = list(ret)
            else:
                self.train_outputs = [ret]
            loss = self.train_outputs[0]
            optimizer = optimizer_func()
            optimizer.minimize(loss)
        self.loss = loss
        self.exe = Executor(self.place)
        self.exe.run(self.startup_program)
        if param_path:
            fluid_io.load_persistables(self.exe, param_path,
                                       main_program=self.train_program)
        if self.checkpoint_cfg and os.path.isdir(
                self.checkpoint_cfg.checkpoint_dir):
            try:
                self._restore_checkpoint()
            except FileNotFoundError:
                pass  # empty dir: fresh run; corruption still raises
        self._stop = False

    def _restore_checkpoint(self):
        """Load the last-good checkpoint and adopt its canonical
        {"epoch", "step"} meta (+ optional "epoch_step" for exact
        mid-epoch resume).  load_checkpoint always returns that schema —
        the legacy int-step metas are normalized on the way out, so both
        sides of the round-trip speak one format."""
        meta = fluid_io.load_checkpoint(
            self.exe, self.checkpoint_cfg.checkpoint_dir,
            main_program=self.train_program)
        self.checkpoint_cfg.epoch_id = int(meta.get("epoch", 0))
        self.checkpoint_cfg.step_id = int(meta.get("step", 0))
        self.checkpoint_cfg.epoch_step = int(meta.get("epoch_step", 0))
        if "rng_step" in meta:
            # the port's own meta key: the Executor's step counter that
            # seeds the random ops, so a resumed run draws the dropout
            # masks the uninterrupted one draws (a JAX package checkpoint
            # has none, and the counter restarts as the JAX one does)
            self.exe._step_counters[id(self.train_program)] = \
                int(meta["rng_step"])
        return meta

    def stop(self):
        self._stop = True

    def _make_sentinel(self, pipeline_depth=0):
        from ...flags import FLAGS
        if not FLAGS.sentinel_nan_check:
            return None
        from .. import sentinel as sentinel_mod
        return sentinel_mod.AnomalySentinel(
            max_bad_steps=FLAGS.sentinel_max_bad_steps,
            policy=FLAGS.sentinel_policy,
            check_params=FLAGS.sentinel_check_params,
            pipeline_depth=pipeline_depth)

    def _run_step(self, feed, fetch, sentinel, step_id=None):
        """One executor step, optionally screened by the anomaly
        sentinel: on a non-finite step the pre-step persistable refs are
        restored (no step writes a state tensor in place) and
        after K consecutive bad steps the policy escalates to a reload
        of the last-good checkpoint (or SentinelError)."""
        from ...obs import tracing as obs_tracing
        if sentinel is None:
            with obs_tracing.trace("train/step", kind="train",
                                   step=step_id):
                return self.exe.run(self.train_program, feed=feed,
                                    fetch_list=fetch)
        from .. import functionalizer, sentinel as sentinel_mod
        scope = global_scope()
        names = functionalizer.persistable_names(self.train_program)
        pre = {n: scope.get(n) for n in names if scope.has(n)}
        with obs_tracing.trace("train/step", kind="train", step=step_id):
            metrics = self.exe.run(self.train_program, feed=feed,
                                   fetch_list=fetch)
        named = list(zip((getattr(f, "name", str(f)) for f in fetch),
                         metrics))
        if sentinel.check_params:
            named += [(n, scope.get(n)) for n in names if scope.has(n)]
        verdict = sentinel.observe(named, step=step_id)
        if verdict == sentinel_mod.SKIP:
            for n, v in pre.items():
                scope.set(n, v)
            self._warn_skip(sentinel, 0)
        elif verdict == sentinel_mod.ROLLBACK:
            self._rollback_last_good(sentinel)
        return metrics

    @staticmethod
    def _warn_skip(sentinel, discarded):
        import warnings
        extra = ""
        if discarded:
            extra = (" (pipeline: %d in-flight step(s) discarded "
                     "un-observed and re-dispatched from the reverted "
                     "state)" % discarded)
        warnings.warn(
            "sentinel: non-finite step (%s) reverted — %d/%d "
            "consecutive%s" % (", ".join(sentinel.last_bad_names),
                               sentinel.consecutive_bad,
                               sentinel.max_bad_steps, extra))

    def _rollback_last_good(self, sentinel):
        import warnings
        from .. import sentinel as sentinel_mod
        if not self.checkpoint_cfg:
            raise sentinel_mod.SentinelError(
                "sentinel policy 'rollback' needs a checkpoint_config "
                "with a last-good checkpoint, and this Trainer has "
                "none")
        try:
            meta = fluid_io.load_checkpoint(
                self.exe, self.checkpoint_cfg.checkpoint_dir,
                main_program=self.train_program)
        except FileNotFoundError:
            raise sentinel_mod.SentinelError(
                "sentinel: rollback requested but no checkpoint "
                "exists yet under %s"
                % self.checkpoint_cfg.checkpoint_dir)
        sentinel.note_rollback_done()
        warnings.warn(
            "sentinel: %d consecutive non-finite steps — rolled back "
            "to last-good checkpoint (epoch %s, step %s)"
            % (sentinel.consecutive_bad, meta.get("epoch"),
               meta.get("step")))
        return meta

    # ---- async pipeline: in-flight dispatch + deferred drain --------

    def _dispatch_step(self, epoch_id, step_id, feed, fetch, sentinel):
        """Dispatch one step WITHOUT host sync (Executor.run as_future)
        and record what its eventual drain needs.  The pre/post scope
        snapshots bracket this step's persistable refs: `pre` is the
        restore target if THIS step turns out non-finite, `post` is the
        state the sentinel screens under check_params (at drain time
        the live scope already holds later in-flight steps' state, so
        screening it would attribute a later step's corruption here)."""
        from ...obs import tracing as obs_tracing
        scope = global_scope()
        pre = post = None
        names = None
        if sentinel is not None:
            from .. import functionalizer
            names = functionalizer.persistable_names(self.train_program)
            pre = {n: scope.get(n) for n in names if scope.has(n)}
        with obs_tracing.trace("train/dispatch", kind="train",
                               step=step_id):
            future = self.exe.run(self.train_program, feed=feed,
                                  fetch_list=fetch, as_future=True)
        if sentinel is not None:
            post = {n: scope.get(n) for n in names if scope.has(n)}
        return _PendingStep(epoch_id, step_id, feed, fetch, future,
                            pre, post)

    def _discard_and_redispatch(self, pending, sentinel):
        """Depth-aware recovery: every in-flight step was dispatched
        from state downstream of the step just reverted/rolled back, so
        its results must never be observed.  Drop them un-resolved and
        re-dispatch the SAME batches (same feeds, original event ids)
        from the restored state — no data is lost to a bad step; only
        the RNG step folds of the replayed steps differ, exactly as the
        sync loop's post-anomaly trajectory would differ anyway."""
        dropped = list(pending)
        pending.clear()
        if dropped:
            sentinel.note_inflight_discarded(len(dropped))
        for d in dropped:
            pending.append(self._dispatch_step(
                d.epoch, d.step, d.feed, d.fetch, sentinel))
        return len(dropped)

    def _drain_step(self, pending, sentinel):
        """Resolve the OLDEST in-flight step (ONE batched copy to the host
        via FetchFuture.result — the watchdog wraps this drain, scaled by
        how many steps the resolve may be waiting behind) and run the
        sentinel screen that dispatch deferred."""
        from .. import sentinel as sentinel_mod
        ent = pending.popleft()
        metrics = ent.future.result(watchdog_scale=len(pending) + 2,
                                    step=ent.step)
        if sentinel is None:
            return ent, metrics
        scope = global_scope()
        named = list(zip((getattr(f, "name", str(f)) for f in ent.fetch),
                         metrics))
        if sentinel.check_params:
            named += sorted(ent.post.items())
        verdict = sentinel.observe(named, step=ent.step)
        if verdict == sentinel_mod.SKIP:
            for n, v in ent.pre.items():
                scope.set(n, v)
            discarded = self._discard_and_redispatch(pending, sentinel)
            self._warn_skip(sentinel, discarded)
        elif verdict == sentinel_mod.ROLLBACK:
            self._rollback_last_good(sentinel)
            self._discard_and_redispatch(pending, sentinel)
        return ent, metrics

    def train(self, num_epochs, event_handler, reader=None, feed_order=None):
        from ...flags import FLAGS
        from ..data_feeder import DataFeeder
        feeder = DataFeeder(feed_list=[
            self.train_program.global_block().var(n) for n in feed_order],
            place=self.place, program=self.train_program) \
            if feed_order else None
        cfg = self.checkpoint_cfg
        start_epoch = cfg.epoch_id if cfg else 0
        global_step = cfg.step_id if cfg else 0
        # exact mid-epoch resume: the checkpoint records how many steps
        # of its epoch were already trained; replaying the (deterministic)
        # reader and skipping them reproduces the uninterrupted trajectory
        resume_skip = cfg.epoch_step if cfg else 0
        depth = max(int(FLAGS.async_dispatch_depth), 0)
        if FLAGS.check_nan_inf or FLAGS.benchmark:
            # both modes force a per-step host sync by definition — the
            # pipeline would only defer what they exist to observe
            depth = 0
        sentinel = self._make_sentinel(pipeline_depth=depth)
        feed_fn = feeder.feed if feeder else (lambda d: d)
        prefetch = max(int(FLAGS.reader_prefetch_depth), 0)
        if prefetch > 0 and reader is not None:
            # device prefetch queue: prepare_feeds (dtype casts, LoD
            # padding) and the copy to the card for the NEXT batch run
            # on the prefetch thread while the current step computes;
            # items arrive on the card, so the per-step feed path below
            # is a pass-through
            from ...reader import prefetch_to_device
            from ..executor import prepare_feeds
            prog, make_feed = self.train_program, feed_fn
            reader = prefetch_to_device(
                reader, prefetch,
                prepare=lambda d: prepare_feeds(prog, make_feed(d)),
                device=self.exe.device)
            feed_fn = lambda d: d  # noqa: E731
        pending = collections.deque()

        def drain_one():
            nonlocal global_step
            ent, metrics = self._drain_step(pending, sentinel)
            event_handler(EndStepEvent(ent.epoch, ent.step, metrics))
            global_step += 1
            return ent

        def drain_and_maybe_checkpoint():
            ent = drain_one()
            if cfg and global_step % cfg.step_interval == 0:
                # a checkpoint is a sync boundary: flush the window so
                # the scope state matches the step ids the vault
                # records (saves coalesce when step_interval < depth)
                while pending:
                    ent = drain_one()
                self._save_checkpoint(ent.epoch, global_step,
                                      ent.step + 1)

        try:
            for epoch_id in range(start_epoch, num_epochs):
                event_handler(BeginEpochEvent(epoch_id))
                batches = reader()
                try:
                    for step_id, data in enumerate(batches):
                        if epoch_id == start_epoch and \
                                step_id < resume_skip:
                            continue
                        if self._stop:
                            # stop() lands within <= depth steps: the
                            # in-flight window still drains (its events
                            # fire; state already includes those steps)
                            while pending:
                                drain_one()
                            return
                        begin = BeginStepEvent(epoch_id, step_id)
                        event_handler(begin)
                        fetch = self.train_outputs if begin.fetch_metrics \
                            else []
                        feed = feed_fn(data)
                        if depth == 0:
                            metrics = self._run_step(feed, fetch, sentinel,
                                                     step_id=step_id)
                            event_handler(EndStepEvent(epoch_id, step_id,
                                                       metrics))
                            global_step += 1
                            if cfg and global_step % cfg.step_interval == 0:
                                self._save_checkpoint(epoch_id, global_step,
                                                      step_id + 1)
                        else:
                            pending.append(self._dispatch_step(
                                epoch_id, step_id, feed, fetch, sentinel))
                            while len(pending) > depth:
                                drain_and_maybe_checkpoint()
                finally:
                    # explicit close, not GC: the prefetch worker (and
                    # any generator-held resource) must die with the
                    # epoch even when the loop exits early
                    close = getattr(batches, "close", None)
                    if close is not None:
                        close()
                while pending:
                    drain_and_maybe_checkpoint()
                event_handler(EndEpochEvent(epoch_id))
                if cfg and (epoch_id + 1) % cfg.epoch_interval == 0:
                    self._save_checkpoint(epoch_id + 1, global_step, 0)
        finally:
            if cfg and cfg.async_save:
                from .. import checkpoint as _ckpt
                _ckpt.wait_for_async_saves()

    def test(self, reader, feed_order):
        test_program = self.train_program.clone(for_test=True)
        from ...flags import FLAGS
        from ..data_feeder import DataFeeder
        feeder = DataFeeder(feed_list=[
            test_program.global_block().var(n) for n in feed_order],
            place=self.place, program=test_program)
        # deferred-drain eval: dispatch up to async_dispatch_depth
        # batches before resolving; each drain copies the step's
        # fetches to the host in ONE batch (FetchFuture.result)
        depth = max(int(FLAGS.async_dispatch_depth), 0)
        pending = collections.deque()
        accum, count = None, 0

        def drain():
            nonlocal accum, count
            fut = pending.popleft()
            res = fut.result(watchdog_scale=len(pending) + 2)
            vals = [np.asarray(r).astype(np.float64) for r in res]
            accum = vals if accum is None else [
                a + v for a, v in zip(accum, vals)]
            count += 1

        for data in reader():
            pending.append(self.exe.run(
                test_program, feed=feeder.feed(data),
                fetch_list=self.train_outputs, as_future=True))
            while len(pending) > depth:
                drain()
        while pending:
            drain()
        return [a / max(count, 1) for a in accum] if accum else []

    def save_params(self, param_path):
        fluid_io.save_persistables(self.exe, param_path,
                                   main_program=self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        fluid_io.save_inference_model(
            param_path, feeded_var_names,
            [self.train_outputs[i] for i in target_var_indexes],
            self.exe, main_program=self.train_program)

    def _save_checkpoint(self, epoch_id, step_id, epoch_step=0):
        cfg = self.checkpoint_cfg
        from ...obs import tracing as obs_tracing
        # the ckpt ms of the per-step breakdown: what the train loop
        # actually pays at the sync boundary (async_save hides the
        # commit itself; the vault emits its own committed event)
        with obs_tracing.trace("train/ckpt", kind="train", step=step_id,
                               epoch=epoch_id):
            rng_step = self.exe._step_counters.get(
                id(self.train_program), 0)
            fluid_io.save_checkpoint(
                self.exe, cfg.checkpoint_dir,
                main_program=self.train_program,
                step={"step": step_id, "rng_step": rng_step},
                epoch=epoch_id, epoch_step=epoch_step,
                max_num_checkpoints=cfg.max_num_checkpoints,
                async_save=cfg.async_save)
