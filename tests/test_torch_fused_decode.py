"""Fused N-step decode on paddle_tpu_torch, on the CPU: `decode_fused`
against paddle_tpu's `decode_fused` and against single `decode()` steps,
the fused speculative round against the host-driven one and the JAX
package's, and the DecodeBatcher's fused windows and deadline governor.
The cases marked `cuda` hold the captured CUDA graphs against the eager
plain version on the card, bit for bit, and count their launches."""

import time

import numpy as np
import pytest
import torch

from paddle_tpu.inference import decode as jax_decode
from paddle_tpu_torch.inference import decode as torch_decode
from paddle_tpu_torch.inference.decode import (SpeculativeDecodeSession,
                                               greedy_decode,
                                               set_draft_poison)
from paddle_tpu_torch.ops import pallas_kernels as tkernels
from paddle_tpu_torch.serving import DeadlineExceeded, DecodeBatcher

# the tolerances of test_torch_decode.py (fp32 caches: XLA's and
# PyTorch's CPU matmuls sum in other orders) and test_torch_int8_kv.py
# (int8 caches: at most this share of elements one count apart)
RTOL, ATOL = 1e-5, 1e-6
FLIP_SHARE = 1e-3

_CONFIGS = {
    "small": dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2,
                  max_seq_len=64, eos_id=0, seed=7),
    "d64h4": dict(vocab_size=48, d_model=64, n_heads=4, n_layers=2,
                  max_seq_len=64, eos_id=-1, seed=11),
}
N_STEPS = 6


@pytest.fixture(autouse=True)
def _disarm_poison():
    yield
    set_draft_poison(None)


def _build(tmp_path_factory, name, **kw):
    d = str(tmp_path_factory.mktemp("torch_fused") / name)
    jax_decode.build_tiny_decode_model(d, **kw)
    return d


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    return {name: _build(tmp_path_factory, name, **cfg)
            for name, cfg in _CONFIGS.items()}


@pytest.fixture(scope="module")
def other_art(tmp_path_factory):
    """The small config's vocab and eos with other weights: a draft that
    disagrees with the target on most rounds."""
    return _build(tmp_path_factory, "other",
                  **dict(_CONFIGS["small"], n_layers=1, seed=101))


def _open(d, kv=None, device="cpu"):
    return torch_decode.GenerativePredictor(d, device=device,
                                            kv_cache_dtype=kv)


def _prompt(n, vocab, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(
        1, vocab, size=n)]


def _fill(sess, V, S):
    """Slots 0, 1, 3 occupied (3 a cache of S - 3 rows, which fills
    mid-window), slot 2 free."""
    for slot, n in ((0, 3), (1, 9), (3, S - 3)):
        sess.prefill(slot, _prompt(n, V, 40 + slot))


# windows: the whole window; budgets (slot 0 stops after 2 tokens, the
# free slot's budget is clipped to 0); a max_trips clamp
_WINDOWS = [dict(), dict(budget=[2, N_STEPS, 5, N_STEPS]),
            dict(max_trips=3)]


def _assert_caches_close(ts, js):
    for ours, theirs in ((ts._kc, js._kc), (ts._vc, js._vc)):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        if ours.dtype == np.int8:
            diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
            assert diff.max() <= 1
            assert (diff != 0).sum() <= FLIP_SHARE * diff.size
        else:
            np.testing.assert_allclose(
                ours, theirs, rtol=RTOL,
                atol=ATOL * max(1.0, float(np.abs(theirs).max())))


def _pair(arts, name, kv):
    jp = jax_decode.GenerativePredictor(arts[name], kv_cache_dtype=kv)
    tp = _open(arts[name], kv)
    if kv == "int8":
        torch_decode.kv_scales_from_jax(tp, jp.kv_scales())
    return jp, tp


def _assert_windows_match(js, ts, windows, n_steps=N_STEPS):
    for w in windows:
        jt, jc, jtrips = js.decode_fused(n_steps, **w)
        tt, tc, ttrips = ts.decode_fused(n_steps, **w)
        assert ttrips == jtrips, w
        assert np.array_equal(tc, np.asarray(jc)), w
        for s in range(ts.n_slots):
            assert tt[s, :tc[s]].tolist() \
                == np.asarray(jt)[s, :tc[s]].tolist(), (w, s)
        assert np.array_equal(ts.lengths, js.lengths), w
        assert np.array_equal(ts.last_tokens, js.last_tokens), w
        assert ts.steps == js.steps
        assert tt.dtype == tc.dtype == ts.lengths.dtype == np.int32
        _assert_caches_close(ts, js)


@pytest.mark.parametrize("name,kv", [("small", "float32"),
                                     ("d64h4", "float32"),
                                     ("small", "int8")])
def test_decode_fused_matches_jax(arts, name, kv):
    """Budgets, a max_trips clamp and a slot that fills its cache: the
    same tokens, counts, trips, lengths and last tokens as the JAX
    package's decode_fused, and caches at the stated tolerances."""
    jp, tp = _pair(arts, name, kv)
    js, ts = jp.new_session(4), tp.new_session(4)
    V, S = tp.vocab_size, tp.max_seq_len
    _fill(ts, V, S)
    _fill(js, V, S)
    _assert_windows_match(js, ts, _WINDOWS)
    # slot 3 filled its cache and stopped there
    assert int(ts.lengths[3]) == S
    assert ts.slot_is_zero(2)


def test_decode_fused_eos_mid_window_matches_jax(arts, tmp_path):
    """An EOS mid-window ends the window early (trips < n_steps), the
    EOS token itself is emitted, and both packages agree."""
    cfg = _CONFIGS["d64h4"]
    probe, _ = greedy_decode(_open(arts["d64h4"]), [5, 9, 3], 16)
    j = next(i for i in range(3, len(probe)) if probe[i] not in probe[:i])
    d = str(tmp_path / "eos")
    jax_decode.build_tiny_decode_model(d, **dict(cfg, eos_id=int(probe[j])))
    jp, tp = jax_decode.GenerativePredictor(d), _open(d)
    js, ts = jp.new_session(2), tp.new_session(2)
    for sess in (js, ts):
        sess.prefill(0, [5, 9, 3])
    toks, counts, trips = ts.decode_fused(j + 4)
    assert trips == counts[0] == j < j + 4
    assert [probe[0]] + toks[0, :j].tolist() == probe[:j + 1]
    jt, jc, jtrips = js.decode_fused(j + 4)
    assert (trips, counts.tolist()) == (jtrips, np.asarray(jc).tolist())
    assert toks[0, :j].tolist() == np.asarray(jt)[0, :j].tolist()
    assert np.array_equal(ts.lengths, js.lengths)
    _assert_caches_close(ts, js)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_decode_fused_bit_exact_against_single_steps(arts, kv):
    """A fused window equals single `decode()` steps in which a slot
    stops advancing once it met its budget: tokens, lengths and caches
    under torch.equal."""
    tp = _open(arts["d64h4"], kv)
    V = tp.vocab_size
    fused, single = tp.new_session(4), tp.new_session(4)
    for sess in (fused, single):
        for slot, n in ((0, 3), (1, 17), (2, 6)):
            sess.prefill(slot, _prompt(n, V, slot))
    budget = np.array([N_STEPS, 4, 1, 0])
    toks, counts, trips = fused.decode_fused(N_STEPS, budget=budget)
    assert counts.tolist() == [N_STEPS, 4, 1, 0] and trips == N_STEPS
    want = {s: [] for s in range(3)}
    for i in range(N_STEPS):
        single.active = np.array([i < b for b in budget[:3]] + [False])
        step = single.decode()
        for s in range(3):
            if i < budget[s]:
                want[s].append(int(step[s]))
    single.active = np.array([True, True, True, False])
    for s in range(3):
        assert toks[s, :counts[s]].tolist() == want[s]
    assert np.array_equal(fused.lengths, single.lengths)
    assert np.array_equal(fused.last_tokens, single.last_tokens)
    assert torch.equal(fused._kc, single._kc)
    assert torch.equal(fused._vc, single._vc)
    # a second window carries on from the first, still bit-exact
    toks, counts, _ = fused.decode_fused(3)
    for i in range(3):
        step = single.decode()
        assert toks[:3, i].tolist() == step[:3].tolist()
    assert torch.equal(fused._kc, single._kc)
    assert fused.slot_is_zero(3)


def test_decode_fused_argument_clipping(arts):
    tp = _open(arts["d64h4"])
    sess = tp.new_session(2)
    sess.prefill(1, [4, 5])
    with pytest.raises(ValueError, match="n_steps"):
        sess.decode_fused(0)
    # negative budgets clip to 0, budgets past the window to the window,
    # max_trips to [1, n_steps]
    toks, counts, trips = sess.decode_fused(4, budget=[9, -3])
    assert counts.tolist() == [0, 0] and trips == 0
    toks, counts, trips = sess.decode_fused(4, budget=[9, 9], max_trips=0)
    assert counts.tolist() == [0, 1] and trips == 1
    toks, counts, trips = sess.decode_fused(4, max_trips=99)
    assert counts.tolist() == [0, 4] and trips == 4 and toks.shape == (2, 4)
    assert sess.steps == 5 and int(sess.lengths[1]) == 7
    assert sess.graph_stats() == {}


# ---------------------------------------------------------------------------
# the fused speculative round
# ---------------------------------------------------------------------------

def _drain(sess, prompts, max_new, fused):
    """Drive a speculative session to completion (slot i = prompt i)
    with the serving loop's per-token EOS / max-new cuts; returns the
    streams and the per-round committed tokens of the active slots."""
    eos = sess.predictor.eos_id
    streams = {i: [sess.prefill(i, p)] for i, p in enumerate(prompts)}
    done = {i for i, s in streams.items()
            if s[-1] == eos or len(s) >= max_new}
    for i in done:
        sess.free(i)
    rounds = []
    while len(done) < len(prompts):
        assert len(rounds) < 200, "speculative session wedged"
        toks, counts = sess.step(fused=fused)
        rounds.append({i: toks[i, :counts[i]].tolist()
                       for i in streams if i not in done})
        for i in [i for i in streams if i not in done]:
            for j in range(int(counts[i])):
                streams[i].append(int(toks[i, j]))
                if streams[i][-1] == eos or len(streams[i]) >= max_new:
                    break
            if streams[i][-1] == eos or len(streams[i]) >= max_new:
                done.add(i)
                sess.free(i)
    return [streams[i] for i in range(len(prompts))], rounds


def _assert_sessions_equal(a, b):
    for x, y in ((a.session, b.session),
                 (a.draft_session, b.draft_session)):
        assert torch.equal(x._kc, y._kc) and torch.equal(x._vc, y._vc)
        assert np.array_equal(x.lengths, y.lengths)
        assert np.array_equal(x.last_tokens, y.last_tokens)
        assert x.steps == y.steps
    assert (a.rounds, a.plain_steps, a.proposed, a.accepted,
            a.degraded) == (b.rounds, b.plain_steps, b.proposed,
                            b.accepted, b.degraded)


@pytest.mark.parametrize("draft", ["twin", "int8_twin", "mismatched"])
def test_fused_round_bit_exact_against_host_round(arts, other_art, draft):
    """Round by round, the fused round commits the host-driven round's
    tokens and leaves both tables bit-identical; streams equal fp32
    greedy decode; a twin draft is accepted whole."""
    d = arts["small"]
    target = _open(d)
    mk = {"twin": lambda: _open(d), "int8_twin": lambda: _open(d, "int8"),
          "mismatched": lambda: _open(other_art)}[draft]
    prompts = [[3, 5, 7], [9, 4], [12, 30, 1, 1]]
    fused = SpeculativeDecodeSession(target, mk(), 3, spec_k=3)
    host = SpeculativeDecodeSession(target, mk(), 3, spec_k=3)
    fs, frounds = _drain(fused, prompts, 22, fused=True)
    hs, hrounds = _drain(host, prompts, 22, fused=False)
    assert fs == hs and frounds == hrounds
    _assert_sessions_equal(fused, host)
    assert fs == [greedy_decode(target, p, 22, n_slots=3)[0]
                  for p in prompts]
    assert fused.rounds > 0
    if draft == "twin":
        assert fused.accepted == fused.proposed > 0
    if draft == "mismatched":
        assert fused.accepted < fused.proposed


def test_fused_round_matches_jax_fused_round(arts, other_art):
    """The same committed tokens, counts and session counters as the JAX
    package's fused round, with a draft that disagrees."""
    d = arts["small"]
    prompts = [[11, 12, 13, 14], [2], [7, 7, 7]]
    jsess = jax_decode.SpeculativeDecodeSession(
        jax_decode.GenerativePredictor(d),
        jax_decode.GenerativePredictor(other_art), 3, spec_k=2)
    tsess = SpeculativeDecodeSession(_open(d), _open(other_art), 3, spec_k=2)
    js, jrounds = _drain(jsess, prompts, 14, fused=True)
    ts, trounds = _drain(tsess, prompts, 14, fused=True)
    assert ts == js and trounds == jrounds
    assert (tsess.rounds, tsess.plain_steps, tsess.proposed,
            tsess.accepted) == (jsess.rounds, jsess.plain_steps,
                                jsess.proposed, jsess.accepted)
    assert tsess.draft_session.steps == jsess.draft_session.steps


def test_poisoned_draft_degrades_before_the_fused_round(arts):
    """A draft poisoned within the round's k checks degrades that round
    to the plain round before the dispatch, as the host-driven round
    does; the streams stay exact."""
    d = arts["small"]
    target = _open(d)
    prompts = [[3, 5, 7], [9, 4]]
    runs = {}
    for fused in (True, False):
        sess = SpeculativeDecodeSession(target, _open(d), 2, spec_k=3)
        for i, p in enumerate(prompts):
            sess.prefill(i, p)
        toks, counts = sess.step(fused=fused)
        assert sess.rounds == 1 and counts.tolist() == [4, 4]
        set_draft_poison(1)
        toks, counts = sess.step(fused=fused)
        set_draft_poison(None)
        assert sess.degraded and "poison" in sess.degrade_error
        assert (sess.rounds, sess.plain_steps) == (1, 1)
        assert counts.tolist() == [1, 1]
        runs[fused] = (toks.tolist(), sess.session._kc.clone(),
                       sess.session.lengths.copy())
        # degraded rounds run plain, fused or not
        toks, counts = sess.step(fused=fused)
        assert counts.tolist() == [1, 1] and sess.plain_steps == 2
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])
    assert np.array_equal(runs[True][2], runs[False][2])


def test_fused_round_plain_version_equals_fused(arts):
    """`step_fused_plain` (the eager form the card runs by name) is the
    CPU's fused round."""
    d = arts["small"]
    target = _open(d)
    a = SpeculativeDecodeSession(target, _open(d, "int8"), 2, spec_k=2)
    b = SpeculativeDecodeSession(target, _open(d, "int8"), 2, spec_k=2)
    for sess in (a, b):
        sess.prefill(0, [3, 5, 7])
        sess.prefill(1, [9, 4])
    for _ in range(3):
        ga, ca = a.step(fused=True)
        gb, cb = b.step_fused_plain()
        assert np.array_equal(ga, gb) and np.array_equal(ca, cb)
    _assert_sessions_equal(a, b)
    assert a.graph_stats() is None


# ---------------------------------------------------------------------------
# the batcher's fused windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True])
def test_batcher_fused_windows_equal_greedy_decode(arts, spec):
    """fuse_steps=8 with more requests than slots (joins and leaves at
    window boundaries): every stream equals single-request greedy decode,
    and a window carries several tokens per dispatch."""
    d = arts["small"]
    target = _open(d)
    rng = np.random.RandomState(1)
    prompts = [[int(x) for x in rng.randint(1, 32, size=n)]
               for n in (2, 5, 3, 7, 1, 4)]
    budgets = [6, 3, 9, 2, 12, 7]
    kw = dict(draft=_open(d, "int8"), spec_k=3) if spec else {}
    b = DecodeBatcher(target, n_slots=2, fuse_steps=8, **kw)
    try:
        streams = [b.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, budgets)]
        outs = [s.result(timeout=120)[0].tolist() for s in streams]
    finally:
        b.close()
    for p, m, out in zip(prompts, budgets, outs):
        assert out == greedy_decode(target, p, m, n_slots=2)[0]
    stats = b.lane_stats()
    decoded = sum(len(o) for o in outs) - len(outs)
    assert stats["fuse_steps"] == 8 and stats["steps"] < decoded
    assert stats["trips"] >= stats["steps"] > 0
    assert stats["step_ewma_ms"] > 0
    if spec:
        assert stats["rounds"] > 0 and stats["accepted"] > 0
    assert all(b.session.slot_is_zero(s) for s in range(2))


def test_batcher_fused_deadline_overshoot_bounded(arts):
    """Deadlines are checked between dispatches, so the governor's EWMA
    trip clamp bounds the overshoot to about one window: each trip here
    costs 30 ms (a slowed `decode_fused`), a window is 4 trips."""
    target = _open(arts["d64h4"])
    b = DecodeBatcher(target, n_slots=1, fuse_steps=4)
    sess = b.session
    real = sess.decode_fused

    def slow(n_steps, budget=None, max_trips=None):
        out = real(n_steps, budget=budget, max_trips=max_trips)
        time.sleep(0.03 * out[2])
        return out
    sess.decode_fused = slow
    try:
        # steady-state step cost first: the clamp reads the lane's EWMA
        b.submit([4, 4], max_new_tokens=8).result(timeout=60)
        deadline = time.monotonic() + 0.25
        s = b.submit([5, 9, 3], max_new_tokens=60, deadline=deadline)
        with pytest.raises(DeadlineExceeded):
            s.result(timeout=30)
        over = time.monotonic() - deadline
        assert 1 <= len(s.tokens) < 60
        # one window is 4 x 30 ms; host slack on top
        assert over <= 4 * 0.03 + 0.5, over
        b.drain(timeout=30)
        assert sess.slot_is_zero(0)
    finally:
        b.close()


def test_batcher_fused_window_drops_cancelled_streams(arts):
    """A stream cancelled while queued behind a window leaves at the
    next window boundary, its slot zeroed; the others finish exactly."""
    target = _open(arts["small"])
    b = DecodeBatcher(target, n_slots=2, fuse_steps=4)
    try:
        keep = b.submit([3, 5, 7], max_new_tokens=10)
        gone = b.submit([9, 4], max_new_tokens=40, chunk_tokens=1)
        assert next(gone.events(timeout=30))[0] == "tokens"
        gone.cancel()
        assert keep.result(timeout=60)[0].tolist() == greedy_decode(
            target, [3, 5, 7], 10, n_slots=2)[0]
        b.drain(timeout=30)
        assert gone.finish_reason == "cancelled"
        assert len(gone.tokens) < 40
        assert all(b.session.slot_is_zero(s) for s in range(2))
    finally:
        b.close()


# ---------------------------------------------------------------------------
# on the card: the CUDA graphs against the eager plain version
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the decode "
                    "kernels have no CPU mode")


def _cuda_pair(arts, kv):
    d = arts["d64h4"]
    pred = _open(d, kv, device="cuda")
    a, b = pred.new_session(4), pred.new_session(4)
    V, S = pred.vocab_size, pred.max_seq_len
    for sess in (a, b):
        _fill(sess, V, S)
    return pred, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_cuda_graph_window_matches_eager_loop(arts, kv):
    """The captured window against `decode_fused_plain` on the card: the
    same tokens, counts, trips and bookkeeping, caches equal bit for bit,
    across budgets, a clamp and a slot that fills its cache; K3 or K4
    launches count every replay (n_steps trips x layers each) and the
    warm-up before the capture (as many)."""
    _need_cuda()
    pred, graph, eager = _cuda_pair(arts, kv)
    L = int(pred.meta["n_layers"])
    name = "decode_attention_int8" if kv == "int8" else "decode_attention"
    for i, w in enumerate(_WINDOWS):
        tkernels.reset_launch_counts()
        got = graph.decode_fused(N_STEPS, **w)
        n_graph = tkernels.launch_counts[name]
        want = eager.decode_fused_plain(N_STEPS, **w)
        for x, y in zip(got, want):
            assert np.array_equal(x, y), w
        assert n_graph == (2 if i == 0 else 1) * N_STEPS * L, (w, n_graph)
        assert np.array_equal(graph.lengths, eager.lengths)
        assert np.array_equal(graph.last_tokens, eager.last_tokens)
        assert torch.equal(graph._kc, eager._kc)
        assert torch.equal(graph._vc, eager._vc)
    stats = graph.graph_stats()
    assert list(stats) == [N_STEPS]
    assert stats[N_STEPS]["replays"] == len(_WINDOWS)
    assert stats[N_STEPS]["launches"] == {name: N_STEPS * L}
    assert stats[N_STEPS]["warmup"] == {name: N_STEPS * L}


@pytest.mark.cuda
def test_cuda_graph_spec_round_matches_eager_round(arts):
    """The captured speculative round (int8 twin draft) against its
    eager plain version on the card, round by round, bit for bit; per
    replay K3 launches once per target layer, K4 (k + 1) times per draft
    layer (k drafts and the catch-up), and as many again for the warm-up
    before the capture."""
    _need_cuda()
    d = arts["d64h4"]
    target = _open(d, device="cuda")
    k = 3
    sessions = [SpeculativeDecodeSession(
        target, _open(d, "int8", device="cuda"), 3, spec_k=k)
        for _ in range(2)]
    for sess in sessions:
        for slot, p in enumerate([[3, 5, 7], [9, 4], [1, 2, 3, 4, 5]]):
            sess.prefill(slot, p)
    graph, eager = sessions
    L = int(target.meta["n_layers"])
    for i in range(4):
        tkernels.reset_launch_counts()
        g1, c1 = graph.step(fused=True)
        counts = dict(tkernels.launch_counts)
        g2, c2 = eager.step_fused_plain()
        assert np.array_equal(g1, g2) and np.array_equal(c1, c2)
        times = 2 if i == 0 else 1
        assert counts["decode_attention"] == times * L
        assert counts["decode_attention_int8"] == times * (k + 1) * L
    _assert_sessions_equal(graph, eager)
    assert graph.graph_stats()["replays"] == 4
