"""The int8 KV cache of paddle_tpu_torch's decode engine against
paddle_tpu's, on the CPU: calibrated scales, the closed-form and measured
cache bytes, the quantized prefill and step writes byte for byte, greedy
streams, and the session invariants (zeroed reuse, exact rollback) under
the int8 slot table."""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import decode as jax_decode
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.inference import decode as torch_decode
from paddle_tpu_torch.serving import DecodeBatcher

# the two packages' fp32 K/V differ by matmul rounding, so a quantized
# element may land one count apart where x / scale sits on a rounding
# boundary: at most this share of the compared elements, never more
# than +-1
FLIP_SHARE = 1e-3


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_int8") / "lm")
    jax_decode.build_tiny_decode_model(d, vocab_size=32, d_model=16,
                                       n_heads=2, n_layers=2,
                                       max_seq_len=64, eos_id=0, seed=7)
    return d


@pytest.fixture(scope="module")
def jax_q8(art):
    return jax_decode.GenerativePredictor(art, kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def q8(art):
    return torch_decode.GenerativePredictor(art, device="cpu",
                                            kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def q8_jax_scales(art, jax_q8):
    """A port int8 predictor carrying the JAX package's scales."""
    pred = torch_decode.GenerativePredictor(art, device="cpu",
                                            kv_cache_dtype="int8")
    return torch_decode.kv_scales_from_jax(pred, jax_q8.kv_scales())


def _assert_int8_close(ours, theirs, what):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype == np.int8, what
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    flips = int((diff != 0).sum())
    assert diff.max() <= 1, "%s: an element off by %d" % (what, diff.max())
    assert flips <= FLIP_SHARE * diff.size, \
        "%s: %d of %d elements differ" % (what, flips, diff.size)


def test_kv_scales_match_jax(art, q8, jax_q8):
    ours, theirs = q8.kv_scales(), jax_q8.kv_scales()
    assert ours.shape == theirs.shape == (2, 2, 2)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)
    # a function of the artifact alone: every reopen calibrates the same
    again = torch_decode.GenerativePredictor(art, device="cpu",
                                             kv_cache_dtype="int8")
    assert np.array_equal(again.kv_scales(), ours)


def test_kv_cache_bytes_match_jax_closed_form(art, q8, jax_q8):
    fp = torch_decode.GenerativePredictor(art, device="cpu")
    for n in (1, 4, 8):
        assert q8.kv_cache_bytes(n) == jax_q8.kv_cache_bytes(n)
        assert q8.new_session(n).cache_bytes() == q8.kv_cache_bytes(n)
    assert q8.kv_cache_bytes(8) <= 0.27 * fp.kv_cache_bytes(8)
    assert fp.kv_scales() is None and q8.kv_cache_dtype == "int8"
    assert q8.new_session(2)._kc.dtype == torch.int8


def test_prefill_and_steps_write_jax_bytes(q8_jax_scales, jax_q8):
    """With the JAX scales carried across, the quantized prefill and
    eight steps' caches equal the JAX package's byte for byte, up to
    rare one-count flips."""
    js, ts = jax_q8.new_session(4), q8_jax_scales.new_session(4)
    prompts = {0: [3, 5, 7], 2: [9, 4, 1, 2, 8, 8, 30, 21, 7],
               3: list(range(1, 20))}
    for slot, p in prompts.items():
        assert ts.prefill(slot, p) == js.prefill(slot, p)
    live = max(len(p) for p in prompts.values()) + 8
    _assert_int8_close(ts._kc[:, :, :live].numpy(),
                       np.asarray(js._kc)[:, :, :live], "prefill K")
    for _ in range(8):
        tt, jt = ts.decode(), js.decode()
        assert [tt[s] for s in prompts] == [jt[s] for s in prompts]
    _assert_int8_close(ts._kc[:, :, :live].numpy(),
                       np.asarray(js._kc)[:, :, :live], "K after 8 steps")
    _assert_int8_close(ts._vc[:, :, :live].numpy(),
                       np.asarray(js._vc)[:, :, :live], "V after 8 steps")
    assert ts.slot_is_zero(1) and js.slot_is_zero(1)


def test_int8_greedy_stream_matches_jax(q8, jax_q8):
    """The port's own scales; the streams agree token for token, or on
    at least 0.99 of the tokens with the first flip shown."""
    prompts = [[3, 5, 7], [9, 4], [1, 2, 3, 4, 5], [8], [6, 6, 2, 9],
               [12, 30], [21, 7, 14]]
    agree = total = 0
    flips = []
    for p in prompts:
        ours, _ = torch_decode.greedy_decode(q8, p, 16)
        theirs, _ = jax_decode.greedy_decode(jax_q8, p, 16)
        same = next((j for j, (a, b) in enumerate(zip(ours, theirs))
                     if a != b), min(len(ours), len(theirs)))
        if ours != theirs:
            flips.append((p, same, ours, theirs))
        agree += same
        total += max(len(ours), len(theirs))
    assert agree / total >= 0.99, flips


def test_int8_slot_reuse_leaves_exact_zeros(q8):
    sess = q8.new_session(2)
    sess.prefill(0, [3, 5, 7])
    sess.prefill(1, [4, 4])
    for _ in range(3):
        sess.decode()
    sess.free(0)
    assert sess.slot_is_zero(0) and not sess.slot_is_zero(1)
    out = [sess.prefill(0, [9, 4])]
    while len(out) < 6:
        out.append(int(sess.decode()[0]))
    assert out == torch_decode.greedy_decode(q8, [9, 4], 6, n_slots=2)[0]


def test_int8_rollback_equals_never_advanced(q8):
    a, b = q8.new_session(2), q8.new_session(2)
    first = a.prefill(0, [3, 5, 7])
    assert b.prefill(0, [3, 5, 7]) == first
    for _ in range(3):
        a.decode()
    a.rollback(0, 3, last_token=first)
    assert torch.equal(a._kc, b._kc) and torch.equal(a._vc, b._vc)
    assert a.lengths.tolist() == b.lengths.tolist()
    assert a.last_tokens.tolist() == b.last_tokens.tolist()
    assert [int(a.decode()[0]) for _ in range(4)] \
        == [int(b.decode()[0]) for _ in range(4)]


def test_kv_dtype_resolution(art, q8):
    old = FLAGS.serving_kv_cache_dtype
    try:
        FLAGS.serving_kv_cache_dtype = "int8"
        pred = torch_decode.GenerativePredictor(art, device="cpu")
        assert pred.kv_cache_dtype == "int8"
        assert np.array_equal(pred.kv_scales(), q8.kv_scales())
        assert torch_decode.GenerativePredictor(
            art, device="cpu", kv_cache_dtype="fp32").kv_cache_dtype \
            == "float32"
    finally:
        FLAGS.serving_kv_cache_dtype = old
    fp = torch_decode.GenerativePredictor(art, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        torch_decode.kv_scales_from_jax(fp, q8.kv_scales())


def test_int8_batcher_streams_and_kv_cache_info(q8):
    prompts = [[3, 5, 7], [9, 4], [1, 2, 3, 4, 5], [8], [6, 6, 2, 9]]
    budgets = [9, 4, 12, 6, 7]
    b = DecodeBatcher(q8, n_slots=2)
    try:
        assert b.kv_cache_info() == ("int8", q8.kv_cache_bytes(2))
        streams = [b.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, budgets)]
        outs = [s.result(timeout=60)[0].tolist() for s in streams]
    finally:
        b.close()
    for p, m, out in zip(prompts, budgets, outs):
        assert out == torch_decode.greedy_decode(q8, p, m, n_slots=2)[0]
    assert all(b.session.slot_is_zero(s) for s in range(2))
