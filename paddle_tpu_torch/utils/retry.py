"""Retry policy: bounded attempts, exponential backoff, jitter — the
port's copy of paddle_tpu/utils/retry.py.

The serving client re-offers shed requests and re-dials dead
connections under one policy until its deadline
(FLAGS.rpc_retry_times / FLAGS.rpc_retry_backoff give the defaults).
Each delay is multiplied by a uniform factor in [1-jitter, 1+jitter], so
clients retrying a recovering server do not stampede it.
"""

import random
import time

__all__ = ["RetryPolicy", "default_rpc_policy"]


class RetryPolicy:
    """`max_attempts` total tries (>=1); between tries, sleep
    ``base_delay * multiplier**k`` capped at `max_delay`, jittered.
    A policy object is stateless across uses — `delays()` returns a
    fresh iterator, `call()` runs a callable under the policy."""

    def __init__(self, max_attempts=5, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.5, retry_on=(OSError,),
                 sleep=time.sleep, rng=None):
        self.max_attempts = max(int(max_attempts), 1)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.retry_on = tuple(retry_on)
        self._sleep = sleep
        self._rng = rng or random.Random()

    def delays(self):
        """Yield the sleep duration before each RETRY (so at most
        max_attempts - 1 values)."""
        for k in range(self.max_attempts - 1):
            d = min(self.base_delay * (self.multiplier ** k),
                    self.max_delay)
            if self.jitter:
                d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
            yield max(d, 0.0)

    def sleep(self, delay):
        self._sleep(delay)

    def call(self, fn, retry_on=None, on_retry=None, deadline=None):
        """Run `fn()` with retries on `retry_on` (defaults to the
        policy's own).  `on_retry(exc, attempt)` runs before each sleep
        (cleanup hook: close a dead socket, log).  A monotonic
        `deadline` stops retrying early — the last exception re-raises.
        """
        retry_on = self.retry_on if retry_on is None else tuple(retry_on)
        it = self.delays()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except retry_on as e:
                try:
                    delay = next(it)
                except StopIteration:
                    raise e
                if deadline is not None and \
                        time.monotonic() + delay > deadline:
                    raise e
                if on_retry is not None:
                    on_retry(e, attempt)
                self.sleep(delay)


def default_rpc_policy(**overrides):
    """The distributed control plane's shared policy, parameterized by
    FLAGS.rpc_retry_times / FLAGS.rpc_retry_backoff."""
    from ..flags import FLAGS
    kw = dict(max_attempts=FLAGS.rpc_retry_times,
              base_delay=FLAGS.rpc_retry_backoff,
              retry_on=(ConnectionError, OSError, EOFError))
    kw.update(overrides)
    return RetryPolicy(**kw)
