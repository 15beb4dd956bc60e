"""paddle_tpu_torch's decode engine against paddle_tpu's, on the CPU:
weights carried across, prefill, decode steps and session caches, greedy
streams, and the session invariants the port keeps within itself."""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import decode as jax_decode
from paddle_tpu_torch.inference import decode as torch_decode

# fp32 on both sides; XLA's and PyTorch's CPU matmuls sum in other
# orders.  An element near zero is the cancellation of terms as large as
# the array's largest ones, so the absolute floor scales with max|ref|.
RTOL, ATOL = 1e-5, 1e-6


def _assert_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(
        actual, desired, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(desired).max())))


_CONFIGS = {
    "small": dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2,
                  max_seq_len=64, eos_id=0, seed=7),
    "d64h4": dict(vocab_size=48, d_model=64, n_heads=4, n_layers=2,
                  max_seq_len=64, eos_id=-1, seed=11),
}


@pytest.fixture(scope="module", params=sorted(_CONFIGS))
def pair(request, tmp_path_factory):
    """(artifact dir, JAX predictor, port predictor on the CPU)."""
    d = str(tmp_path_factory.mktemp("torch_decode") / request.param)
    jax_decode.build_tiny_decode_model(d, **_CONFIGS[request.param])
    return (d, jax_decode.GenerativePredictor(d),
            torch_decode.GenerativePredictor(d, device="cpu"))


def _prompt(n, vocab, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(
        1, vocab, size=n)]


def test_state_from_jax_round_trips(pair, tmp_path):
    d, jp, tp = pair
    state = jp._state_host
    model = torch_decode.state_from_jax(state, jp.meta, "cpu")
    back = torch_decode.state_to_jax(model)
    assert list(back) == list(state)
    for name in state:
        assert back[name].dtype == np.float32
        assert np.array_equal(back[name], np.asarray(state[name])), name
    # the carried weights re-save as the byte-identical artifact
    out = str(tmp_path / "resaved")
    torch_decode.save_decode_model(out, back, {
        k: jp.meta[k] for k in ("vocab_size", "d_model", "n_heads",
                                "n_layers", "max_seq_len", "eos_id")})
    for name in ("decode_meta.bin", "decode_state.bin"):
        with open("%s/%s" % (d, name), "rb") as a, \
                open("%s/%s" % (out, name), "rb") as b:
            assert a.read() == b.read(), name


def test_meta_surface_matches(pair):
    _, jp, tp = pair
    assert tp.vocab_size == jp.vocab_size
    assert tp.max_seq_len == jp.max_seq_len
    assert tp.eos_id == jp.eos_id
    assert tp.prefill_buckets() == jp.prefill_buckets()
    assert tp.kv_cache_dtype == jp.kv_cache_dtype == "float32"
    for n in (1, 8, 9, 33, 64):
        assert tp.prompt_bucket(n) == jp.prompt_bucket(n)
    assert tp.kv_cache_bytes(4) == jp.kv_cache_bytes(4)
    assert tp.param_bytes() == jp.param_bytes()
    assert tp.new_session(4).cache_bytes() == tp.kv_cache_bytes(4)
    with pytest.raises(ValueError, match="max_seq_len"):
        tp.prompt_bucket(65)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 33])
def test_prefill_matches_jax_prefill_core(pair, n):
    _, jp, tp = pair
    bucket = tp.prompt_bucket(n)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = _prompt(n, tp.vocab_size, seed=n)
    state = {k: np.asarray(v) for k, v in jp._state_host.items()}
    jfirst, jk, jv = jp._prefill_core(state, padded, np.int32(n))
    tfirst, tk, tv = tp.prefill(padded, n)
    assert tfirst == int(jfirst)
    _assert_close(tk.numpy(), np.asarray(jk))
    _assert_close(tv.numpy(), np.asarray(jv))
    # pad positions hold exact zeros
    assert not tk[:, :, n:].any() and not tv[:, :, n:].any()


def test_five_steps_match_jax_session(pair):
    _, jp, tp = pair
    js, ts = jp.new_session(4), tp.new_session(4)
    prompts = {0: _prompt(3, tp.vocab_size, 1),
               2: _prompt(20, tp.vocab_size, 2),
               3: _prompt(9, tp.vocab_size, 3)}
    for slot, p in prompts.items():
        assert ts.prefill(slot, p) == js.prefill(slot, p)
    for _ in range(5):
        tt, jt = ts.decode(), js.decode()
        for slot in prompts:
            assert tt[slot] == jt[slot]
    assert np.array_equal(ts.lengths, js.lengths)
    assert ts.lengths.dtype == np.int32
    assert np.array_equal(ts.last_tokens, js.last_tokens)
    assert np.array_equal(ts.active, js.active)
    _assert_close(ts._kc.numpy(), js._kc)
    _assert_close(ts._vc.numpy(), js._vc)
    assert ts.slot_is_zero(1) and js.slot_is_zero(1)


@pytest.mark.parametrize("n,max_new", [(3, 12), (9, 20), (40, 30)])
def test_greedy_streams_identical(pair, n, max_new):
    _, jp, tp = pair
    p = _prompt(n, tp.vocab_size, seed=100 + n)
    assert torch_decode.greedy_decode(tp, p, max_new) \
        == jax_decode.greedy_decode(jp, p, max_new)


def test_free_and_rollback_zero(pair):
    _, _, tp = pair
    sess = tp.new_session(2)
    sess.prefill(0, _prompt(5, tp.vocab_size, 4))
    sess.prefill(1, _prompt(3, tp.vocab_size, 5))
    for _ in range(4):
        sess.decode()
    assert int(sess.lengths[0]) == 9
    sess.rollback(0, 3, last_token=7)
    assert int(sess.lengths[0]) == 6 and int(sess.last_tokens[0]) == 7
    assert not sess._kc[:, 0, 6:].any() and not sess._vc[:, 0, 6:].any()
    assert sess._kc[:, 0, 5].any() and sess._vc[:, 0, 5].any()
    with pytest.raises(ValueError):
        sess.rollback(0, 7)
    assert not sess.slot_is_zero(1)
    sess.free(1)
    assert sess.slot_is_zero(1)
    assert sess.free_slots() == [1] and sess.occupancy() == 1


def test_rollback_equals_never_advanced(pair):
    """A slot rolled back by n is bit-identical to one stopped n steps
    earlier, and decodes on identically."""
    _, _, tp = pair
    p = _prompt(6, tp.vocab_size, 6)
    a, b = tp.new_session(2), tp.new_session(2)
    a.prefill(0, p)
    b.prefill(0, p)
    toks = [a.decode()[0] for _ in range(5)]
    for _ in range(2):
        b.decode()
    a.rollback(0, 3, last_token=toks[1])
    assert torch.equal(a._kc, b._kc) and torch.equal(a._vc, b._vc)
    assert np.array_equal(a.lengths, b.lengths)
    assert [a.decode()[0] for _ in range(3)] \
        == [b.decode()[0] for _ in range(3)]


def test_batched_vs_single_slot_bit_exact(pair):
    """At equal n_slots, requests joining and leaving a running batch do
    not move another slot's tokens or cache by one bit."""
    _, _, tp = pair
    V = tp.vocab_size
    sess = tp.new_session(4)
    prompts = {0: _prompt(3, V, 7), 1: _prompt(7, V, 8),
               2: _prompt(2, V, 9)}
    outs = {i: [sess.prefill(i, p)] for i, p in prompts.items()}
    for _ in range(3):
        t = sess.decode()
        for i in prompts:
            outs[i].append(int(t[i]))
    sess.free(2)
    prompts[3] = _prompt(4, V, 10)
    outs[3] = [sess.prefill(2, prompts[3])]
    for _ in range(5):
        t = sess.decode()
        for i, slot in ((0, 0), (1, 1), (3, 2)):
            outs[i].append(int(t[slot]))
    for i in (0, 1, 3):
        ref, _ = torch_decode.greedy_decode(tp, prompts[i], len(outs[i]),
                                            n_slots=4)
        assert outs[i] == ref, "slot %d diverged" % i
    assert outs[2] == torch_decode.greedy_decode(tp, prompts[2], 4,
                                                 n_slots=4)[0]
    # the cache of a batched slot equals the single-request one bitwise
    single = tp.new_session(4)
    single.prefill(0, prompts[0])
    for _ in range(8):
        single.decode()
    assert torch.equal(single._kc[:, 0], sess._kc[:, 0])
    assert torch.equal(single._vc[:, 0], sess._vc[:, 0])


def test_eos_finish(pair):
    d, _, tp = pair
    toks, reason = torch_decode.greedy_decode(
        tp, _prompt(3, tp.vocab_size, 11), 6)
    assert len(toks) == 6 and reason == ("eos" if toks[-1] == tp.eos_id
                                         else "length")
    sess = tp.new_session(1)
    sess.prefill(0, _prompt(3, tp.vocab_size, 11))
    eos = int(sess.decode()[0])
    tp2 = torch_decode.GenerativePredictor(d, device="cpu")
    tp2.meta = dict(tp2.meta, eos_id=eos)
    toks2, reason2 = torch_decode.greedy_decode(
        tp2, _prompt(3, tp.vocab_size, 11), 50)
    assert reason2 == "eos" and toks2[-1] == eos and len(toks2) < 50


def test_rejects_what_is_not_ported_or_invalid(pair):
    d, _, tp = pair
    # a fused speculative round commits what the host-driven one does
    # (a twin draft: all k + 1 tokens)
    spec = torch_decode.SpeculativeDecodeSession(tp, tp, 1, 2)
    host = torch_decode.SpeculativeDecodeSession(tp, tp, 1, 2)
    for sess in (spec, host):
        sess.prefill(0, [1, 2, 3])
    (g, counts), (gh, ch) = spec.step(fused=True), host.step()
    assert counts.tolist() == ch.tolist() == [3]
    assert g.tolist() == gh.tolist()
    with pytest.raises(ValueError):
        torch_decode.normalize_kv_dtype("fp16")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        torch_decode.GenerativePredictor(d, device="cpu",
                                         kv_cache_dtype="int4")
    sess = tp.new_session(1)
    with pytest.raises(ValueError, match="token ids"):
        sess.prefill(0, [1, tp.vocab_size])
    with pytest.raises(ValueError, match="empty"):
        sess.prefill(0, [])
    sess.prefill(0, [1, 2])
    with pytest.raises(ValueError, match="occupied"):
        sess.prefill(0, [1])
