"""Speculative decoding on paddle_tpu_torch, on the CPU: the verify step
against paddle_tpu's `_verify_math`, the SpeculativeDecodeSession against
target-only greedy decode and against the JAX session round by round,
and the DecodeBatcher's speculative lanes."""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import decode as jax_decode
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.inference import decode as torch_decode
from paddle_tpu_torch.inference.decode import (SpeculativeDecodeSession,
                                               greedy_decode,
                                               set_draft_poison)
from paddle_tpu_torch.ops.pallas_kernels import KernelError
from paddle_tpu_torch.serving import DecodeBatcher

_TINY = dict(vocab_size=32, d_model=16, n_heads=2, max_seq_len=64,
             eos_id=0)


@pytest.fixture(autouse=True)
def _disarm_poison():
    yield
    set_draft_poison(None)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_spec") / "lm")
    torch_decode.build_tiny_decode_model(d, n_layers=2, seed=7, **_TINY)
    return d


@pytest.fixture(scope="module")
def other_art(tmp_path_factory):
    """Same vocab and eos, different weights: the low-accept draft."""
    d = str(tmp_path_factory.mktemp("torch_spec_alt") / "lm2")
    torch_decode.build_tiny_decode_model(d, n_layers=1, seed=101, **_TINY)
    return d


_JAX_PREDICTORS = {}


def _jax_open(d, kv=None):
    """Module-cached JAX predictors: each compiles its phases once."""
    if (d, kv) not in _JAX_PREDICTORS:
        _JAX_PREDICTORS[d, kv] = jax_decode.GenerativePredictor(
            d, kv_cache_dtype=kv)
    return _JAX_PREDICTORS[d, kv]


def _open(d, kv=None):
    return torch_decode.GenerativePredictor(d, device="cpu",
                                            kv_cache_dtype=kv)


@pytest.fixture(scope="module")
def target(art):
    return _open(art)


def _drain(sess, prompts, max_new):
    """Drive a speculative session to completion (slot i = prompt i) with
    the serving loop's per-token EOS / max-new cuts; returns the streams
    and the per-round (committed tokens, counts) of the active slots."""
    eos = sess.predictor.eos_id
    streams = {i: [sess.prefill(i, p)] for i, p in enumerate(prompts)}
    done = {i for i, s in streams.items() if s[-1] == eos
            or len(s) >= max_new}
    for i in done:
        sess.free(i)
    rounds = []
    while len(done) < len(prompts):
        assert len(rounds) < 200, "speculative session wedged"
        toks, counts = sess.step()
        rounds.append({i: (toks[i, :counts[i]].tolist(), int(counts[i]))
                       for i in streams if i not in done})
        for i in list(streams):
            if i in done:
                continue
            for j in range(int(counts[i])):
                streams[i].append(int(toks[i, j]))
                if streams[i][-1] == eos or len(streams[i]) >= max_new:
                    break
            if streams[i][-1] == eos or len(streams[i]) >= max_new:
                done.add(i)
                sess.free(i)
    return [streams[i] for i in range(len(prompts))], rounds


def _refs(pred, prompts, max_new, n_slots):
    return [greedy_decode(pred, p, max_new, n_slots=n_slots)[0]
            for p in prompts]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_verify_matches_jax_verify_math(art, kv):
    """One verify over a chunk that agrees with the target for a while:
    the same greedy tokens, accept counts and (zeroed-suffix) caches as
    the JAX package's `_verify_math` on the same state."""
    jp = _jax_open(art, kv)
    tp = _open(art, kv)
    if kv == "int8":
        torch_decode.kv_scales_from_jax(tp, jp.kv_scales())
    js, ts = jp.new_session(3), tp.new_session(3)
    for slot, p in ((0, [3, 5, 7]), (2, [9, 4, 1, 2, 8])):
        assert ts.prefill(slot, p) == js.prefill(slot, p)
    for _ in range(2):
        ts.decode()
        js.decode()
    # drafts: the target's own next tokens for slot 0, noise for slot 2
    ref = tp.new_session(3)
    ref.prefill(0, [3, 5, 7])
    for _ in range(2):
        ref.decode()
    own = [int(ref.decode()[0]) for _ in range(3)]
    chunk = np.zeros((3, 4), np.int32)
    chunk[:, 0] = ts.last_tokens
    chunk[0, 1:] = own[:2] + [(own[2] + 1) % 32]
    chunk[2, 1:] = [5, 6, 7]
    state = {n: np.asarray(v) for n, v in jp._state_host.items()}
    jg, jm, jk, jv = jp._verify_math(state, js._kc, js._vc, js.lengths,
                                     chunk, js.active)
    g, m = ts.verify(chunk)
    assert np.array_equal(g[[0, 2]], np.asarray(jg)[[0, 2]])
    assert np.array_equal(m[[0, 2]], np.asarray(jm)[[0, 2]])
    assert m[0] == 2
    jk, jv = np.asarray(jk), np.asarray(jv)
    if kv == "int8":
        for ours, theirs in ((ts._kc, jk), (ts._vc, jv)):
            diff = np.abs(ours.numpy().astype(np.int32) - theirs)
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    else:
        for ours, theirs in ((ts._kc, jk), (ts._vc, jv)):
            np.testing.assert_allclose(
                ours.numpy(), theirs, rtol=1e-5,
                atol=1e-6 * float(np.abs(theirs).max()))
    # the rejected suffix is zeroed: slot 0 keeps length + m + 1 rows
    n0 = int(ts.lengths[0])
    assert not ts._kc[:, 0, n0 + 3:].any()
    assert ts._kc[:, 0, n0 + 2].any()


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_twin_draft_accepted_whole_and_bit_exact(art, kv):
    target = _open(art, kv)
    prompts = [[3, 5, 7], [9, 4]]
    sess = SpeculativeDecodeSession(target, _open(art, kv), 2, spec_k=3)
    streams, _ = _drain(sess, prompts, 24)
    assert streams == _refs(target, prompts, 24, 2)
    assert sess.proposed > 0 and sess.accepted == sess.proposed
    assert sess.rounds > 0 and sess.plain_steps == 0
    assert not sess.degraded


def test_int8_twin_drafts_for_the_fp32_target(art, target):
    prompts = [[3, 5, 7], [9, 4], [12, 30, 1]]
    sess = SpeculativeDecodeSession(target, _open(art, "int8"), 3,
                                    spec_k=4)
    streams, _ = _drain(sess, prompts, 20)
    assert streams == _refs(target, prompts, 20, 3)
    assert sess.draft_session._kc.dtype == torch.int8
    assert sess.session._kc.dtype == torch.float32
    assert sess.rounds > 0 and sess.accepted > 0


def test_mismatched_draft_still_bit_exact(target, other_art):
    prompts = [[11, 12, 13, 14], [2]]
    sess = SpeculativeDecodeSession(target, _open(other_art), 2, spec_k=2)
    streams, _ = _drain(sess, prompts, 16)
    assert streams == _refs(target, prompts, 16, 2)
    assert sess.accepted < sess.proposed


def test_rounds_match_the_jax_session(art, other_art, target):
    """Per round, the same committed tokens and counts as the JAX
    package's SpeculativeDecodeSession, with a draft that disagrees."""
    prompts = [[11, 12, 13, 14], [2], [7, 7, 7]]
    jsess = jax_decode.SpeculativeDecodeSession(
        _jax_open(art, "float32"), _jax_open(other_art), 3, spec_k=2)
    tsess = SpeculativeDecodeSession(target, _open(other_art), 3, spec_k=2)
    jstreams, jrounds = _drain(jsess, prompts, 14)
    tstreams, trounds = _drain(tsess, prompts, 14)
    assert tstreams == jstreams
    assert trounds == jrounds
    assert (tsess.rounds, tsess.plain_steps, tsess.proposed,
            tsess.accepted) == (jsess.rounds, jsess.plain_steps,
                                jsess.proposed, jsess.accepted)


def test_near_full_slot_falls_back_to_plain_rounds(art, target):
    sess = SpeculativeDecodeSession(target, _open(art), 1, spec_k=4)
    # 57 prompt tokens on a 64-row cache: one spec round fits, then the
    # slot lacks k + 1 rows and the session runs plain rounds
    prompt = (list(range(1, 30)) * 2)[:57]
    streams, _ = _drain(sess, [prompt], 8)
    assert streams[0] == _refs(target, [prompt], 8, 1)[0]
    assert sess.plain_steps > 0


def test_draft_poison_degrades_in_the_same_round(art, target):
    prompts = [[3, 5, 7], [9, 4]]
    refs = _refs(target, prompts, 20, 2)
    sess = SpeculativeDecodeSession(target, _open(art), 2, spec_k=3)
    streams = {i: [sess.prefill(i, p)] for i, p in enumerate(prompts)}
    toks, counts = sess.step()          # one healthy speculative round
    assert sess.rounds == 1 and not sess.degraded
    for i in streams:
        streams[i] += toks[i, :counts[i]].tolist()
    set_draft_poison(1)                 # dies in the next round's drafts
    toks, counts = sess.step()
    assert sess.degraded and (sess.rounds, sess.plain_steps) == (1, 1)
    assert counts.tolist() == [1, 1]    # that same round ran plain
    assert "poison" in sess.degrade_error
    for i in streams:
        streams[i] += toks[i, :counts[i]].tolist()
    while any(len(s) < 20 for s in streams.values()):
        toks, counts = sess.step()
        for i in streams:
            streams[i] += toks[i, :counts[i]].tolist()
    for i, r in enumerate(refs):
        assert streams[i][:20] == r


def test_incompatible_draft_rejected(target, tmp_path):
    bad = str(tmp_path / "vocab16")
    torch_decode.build_tiny_decode_model(bad, vocab_size=16, d_model=16,
                                         n_heads=2, n_layers=1,
                                         max_seq_len=64, eos_id=0, seed=3)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeDecodeSession(target, _open(bad), 2, 2)
    short = str(tmp_path / "len32")
    torch_decode.build_tiny_decode_model(short, vocab_size=32, d_model=16,
                                         n_heads=2, n_layers=1,
                                         max_seq_len=32, eos_id=0, seed=3)
    with pytest.raises(ValueError, match="max_seq_len"):
        SpeculativeDecodeSession(target, _open(short), 2, 2)
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeDecodeSession(target, target, 2, 0)
    # a fused round over an empty table commits nothing
    toks, counts = SpeculativeDecodeSession(target, target, 2, 2).step(
        fused=True)
    assert counts.tolist() == [0, 0] and toks.shape == (2, 3)


def test_spec_lane_joins_and_leaves_bit_exact(art, target):
    prompts = [[3, 5, 7], [9, 4], [11, 12, 13, 14], [2], [7, 7, 7]]
    budgets = [12, 7, 16, 9, 5]
    b = DecodeBatcher(target, n_slots=2, draft=_open(art, "int8"),
                      spec_k=2)
    try:
        assert b.kv_cache_info() == ("float32", target.kv_cache_bytes(2))
        streams = [b.submit(p, max_new_tokens=n)
                   for p, n in zip(prompts, budgets)]
        outs = [s.result(timeout=120)[0].tolist() for s in streams]
    finally:
        b.close()
    for p, n, out in zip(prompts, budgets, outs):
        assert out == greedy_decode(target, p, n, n_slots=2)[0]
    stats = b.lane_stats()
    assert stats["spec_k"] == 2 and stats["rounds"] > 0
    assert stats["steps"] == stats["rounds"] + stats["plain_steps"]
    assert stats["tokens"] == sum(len(o) for o in outs)
    assert 0 < stats["accepted"] <= stats["proposed"]
    assert stats["degraded"] is False and stats["degrade_error"] is None
    assert all(b.session.slot_is_zero(s) for s in range(2))


def test_spec_lane_degrades_latched_and_streams_intact(art, target):
    set_draft_poison(5)
    b = DecodeBatcher(target, n_slots=2, draft=_open(art))
    try:
        assert b.spec_k == FLAGS.serving_spec_k == 4
        prompts = [[3, 5, 7], [9, 4], [1, 2, 3]]
        streams = [b.submit(p, max_new_tokens=18) for p in prompts]
        outs = [s.result(timeout=120)[0].tolist() for s in streams]
    finally:
        b.close()
    for p, out in zip(prompts, outs):
        assert out == greedy_decode(target, p, 18, n_slots=2)[0]
    stats = b.lane_stats()
    assert stats["degraded"] is True and stats["plain_steps"] > 0
    assert "poison" in stats["degrade_error"]


_LAUNCH_FAILED = "decode_attention: CUDA kernel launch failed (cudaError 700)"


def _break_draft(sess, method, after_calls):
    """Make the draft session's `method` raise the KernelError of a failed
    launch once it has run `after_calls` times."""
    ds = sess.draft_session
    real = getattr(ds, method)
    calls = [0]

    def broken(*a, **kw):
        if calls[0] >= after_calls:
            raise KernelError(_LAUNCH_FAILED)
        calls[0] += 1
        return real(*a, **kw)
    setattr(ds, method, broken)


@pytest.mark.parametrize("site,method,after_calls", [
    ("prefill", "prefill", 0), ("draft_step", "decode", 0),
    ("catch_up", "decode", 2)])
def test_draft_kernel_failure_raises_instead_of_degrading(
        art, target, site, method, after_calls):
    """A draft-side kernel that fails to build or launch is a fault of
    the port, not a draft failure: it propagates from prefill, from the
    draft steps and from the catch-up step after a whole accept (a twin
    draft at spec_k 2: decode calls 0-1 draft, call 2 catches up), and
    the session does not degrade."""
    sess = SpeculativeDecodeSession(target, _open(art), 1, spec_k=2)
    _break_draft(sess, method, after_calls)
    with pytest.raises(KernelError, match="launch failed"):
        sess.prefill(0, [3, 5, 7])
        sess.step()
    assert not sess.degraded and sess.degrade_error is None
    assert sess.plain_steps == 0


def test_spec_lane_kernel_failure_ends_the_lane(art, target):
    """On a speculative lane a draft kernel failure ends the lane, as a
    target one does: the stream fails with the KernelError and
    `lane_stats()` names it, instead of the lane degrading silently."""
    b = DecodeBatcher(target, n_slots=1, draft=_open(art), spec_k=2)
    try:
        _break_draft(b.session, "decode", 0)
        st = b.submit([3, 5, 7], max_new_tokens=8)
        with pytest.raises(KernelError, match="launch failed"):
            st.result(timeout=60)
    finally:
        b.close()
    stats = b.lane_stats()
    assert stats["dead"].startswith("KernelError") and not stats["degraded"]


def test_no_draft_or_spec_k_below_one_is_a_plain_lane(art, target):
    for kw in ({}, {"draft": _open(art), "spec_k": 0}):
        b = DecodeBatcher(target, n_slots=1, **kw)
        try:
            assert b.spec_k == 0 and "rounds" not in b.lane_stats()
            out = b.submit([3, 5], max_new_tokens=4).result(timeout=60)
        finally:
            b.close()
        assert out[0].tolist() == greedy_decode(target, [3, 5], 4)[0]
