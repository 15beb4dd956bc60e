"""paddle_tpu_torch's DecodeBatcher on the CPU: continuous-batching
streams equal single-request greedy decode, slots recycle, admission
control sheds, deadlines and cancels free (and zero) slots."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.inference.decode import (GenerativePredictor,
                                               build_tiny_decode_model,
                                               greedy_decode)
from paddle_tpu_torch.serving import (BatcherClosed, DeadlineExceeded,
                                      DecodeBatcher, ServerOverloaded)


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_batcher") / "lm")
    build_tiny_decode_model(d, vocab_size=32, d_model=16, n_heads=2,
                            n_layers=2, max_seq_len=64, eos_id=-1, seed=7)
    return GenerativePredictor(d, device="cpu")


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    prompts = [[int(t) for t in rng.randint(1, 32, size=rng.randint(1, 20))]
               for _ in range(n)]
    return prompts, [int(m) for m in rng.randint(1, 12, size=n)]


def _gate_prefill(batcher):
    """Hold the lane inside its next prefill until the returned event is
    set, so submits pile up in the admission queue."""
    gate = threading.Event()
    sess = batcher.session
    real = sess.prefill

    def gated(slot, tokens):
        gate.wait(30)
        return real(slot, tokens)
    sess.prefill = gated
    return gate


@pytest.mark.parametrize("n_requests,n_slots", [(6, 4), (10, 2)])
def test_streams_equal_greedy_decode(predictor, n_requests, n_slots):
    prompts, budgets = _requests(n_requests, seed=n_requests)
    b = DecodeBatcher(predictor, n_slots=n_slots)
    try:
        streams = [b.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, budgets)]
        outs = [s.result(timeout=60)[0].tolist() for s in streams]
    finally:
        b.close()
    for p, m, out, s in zip(prompts, budgets, outs, streams):
        ref, reason = greedy_decode(predictor, p, m, n_slots=n_slots)
        assert out == ref
        assert s.finish_reason == reason
    stats = b.lane_stats()
    assert stats["tokens"] == sum(len(o) for o in outs)
    assert stats["steps"] >= max(budgets) - 1
    assert stats["inflight"] == 0 and stats["dead"] is None
    assert all(b.session.slot_is_zero(s) for s in range(n_slots))


def test_stream_events_and_chunks(predictor):
    b = DecodeBatcher(predictor, n_slots=2)
    try:
        s = b.submit([3, 4, 5], max_new_tokens=7, chunk_tokens=3)
        chunks = list(s)
    finally:
        b.close()
    assert [len(c) for c in chunks] == [3, 3, 1]
    assert sum(chunks, []) == s.tokens == greedy_decode(
        predictor, [3, 4, 5], 7, n_slots=2)[0]
    assert s.done() and s.finish_reason == "length"


def test_queue_overflow_sheds(predictor):
    b = DecodeBatcher(predictor, n_slots=1, max_queue=2)
    gate = _gate_prefill(b)
    try:
        first = b.submit([1, 2], max_new_tokens=3)
        deadline = time.monotonic() + 10
        while b.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.005)     # the lane took `first` into prefill
        low = b.submit([3], max_new_tokens=2, priority=0)
        mid = b.submit([4], max_new_tokens=2, priority=1)
        with pytest.raises(ServerOverloaded) as err:
            b.submit([5], max_new_tokens=2, priority=0)
        assert err.value.priority == 0
        # a higher-priority arrival evicts the lowest-priority queued one
        high = b.submit([6], max_new_tokens=2, priority=2)
        with pytest.raises(ServerOverloaded):
            low.result(timeout=10)
        gate.set()
        for s in (first, mid, high):
            assert len(s.result(timeout=60)[0]) in (2, 3)
    finally:
        gate.set()
        b.close()
    with pytest.raises(BatcherClosed):
        b.submit([1])


def test_cancel_and_deadline_free_zeroed_slots(predictor):
    b = DecodeBatcher(predictor, n_slots=1, max_new_tokens=60)
    try:
        s = b.submit([1, 2, 3], max_new_tokens=60)
        while len(s.tokens) < 2:
            time.sleep(0.002)
        s.cancel()
        assert s.result(timeout=30) and s.finish_reason == "cancelled"
        expired = b.submit([4, 5], deadline=time.monotonic() - 1.0)
        with pytest.raises(DeadlineExceeded):
            expired.result(timeout=30)
        # mid-decode: steps slowed to 5 ms, the deadline is 50 ms out
        sess = b.session
        real = sess.decode

        def slow():
            time.sleep(0.005)
            return real()
        sess.decode = slow
        late = b.submit([4, 5], max_new_tokens=60,
                        deadline=time.monotonic() + 0.05)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=30)
        assert 0 < len(late.tokens) < 60
        sess.decode = real
        after = b.submit([7, 8], max_new_tokens=4)
        assert after.result(timeout=30)[0].tolist() == greedy_decode(
            predictor, [7, 8], 4)[0]
        b.drain(timeout=30)
        assert b.session.slot_is_zero(0)
    finally:
        b.close()


def test_submit_validation(predictor):
    b = DecodeBatcher(predictor, n_slots=1)
    try:
        with pytest.raises(ValueError, match="empty"):
            b.submit([])
        with pytest.raises(ValueError, match="token ids"):
            b.submit([1, 32])
        with pytest.raises(ValueError, match="cache room"):
            b.submit([1] * 64)
    finally:
        b.close()
    # the flag sets the fused window of a batcher that names none
    FLAGS.serving_decode_fuse_steps = 4
    try:
        b = DecodeBatcher(predictor, n_slots=1)
    finally:
        FLAGS.serving_decode_fuse_steps = 1
    try:
        assert b.fuse_steps == 4
        out = b.submit([1, 2], max_new_tokens=6).result(timeout=30)[0]
        assert out.tolist() == greedy_decode(predictor, [1, 2], 6)[0]
    finally:
        b.close()


def test_failed_step_fails_streams_typed(predictor):
    b = DecodeBatcher(predictor, n_slots=2)
    sess = b.session

    def broken():
        raise RuntimeError("device fault")
    sess.decode = broken
    try:
        s = b.submit([1, 2], max_new_tokens=5)
        with pytest.raises(RuntimeError, match="device fault"):
            s.result(timeout=30)
        assert "device fault" in b.lane_stats()["dead"]
        with pytest.raises(BatcherClosed):
            b.submit([1, 2])
    finally:
        b.close()
