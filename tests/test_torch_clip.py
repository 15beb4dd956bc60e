"""Gradient and error clipping: paddle_tpu_torch against paddle_tpu on the
CPU.

Under each clip kind (by value, by norm, by global norm in one group or
two, a parameter's own clip beside a program-wide one, and an error clip
on an activation) the program that `minimize` builds is the JAX
package's op for op (types, var names, attrs), and three steps of a
small MLP agree: losses and every state to rtol 1e-5 of each array's
largest magnitude.  Then a 2-layer transformer at d_model 64, trained
with noam_decay, Adam and GradientClipByGlobalNorm (K1/K2's plain
versions here, the JAX kernels in interpret mode), agrees over three
steps the same way.  Every program is built in fresh Programs under
program_guard and unique_name.guard, and set_gradient_clip is always
given its program."""

import numpy as np
import pytest

from torch_train_parity import (Pair, assert_scaled_close, build_both,
                                program_ops)

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.models import transformer as tt


def _mlp(clip_kind):
    def fn(pkg, main):
        c = pkg.clip
        x = pkg.layers.data("x", shape=[12], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        own = None
        if clip_kind == "own_and_global":
            own = pkg.ParamAttr(gradient_clip=c.GradientClipByValue(0.02))
        h = pkg.layers.fc(x, size=16, act="relu", param_attr=own)
        if clip_kind == "error":
            h.error_clip = c.ErrorClipByValue(0.005, -0.004)
        logits = pkg.layers.fc(h, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        params = main.global_block().all_parameters()
        if clip_kind == "value":
            c.set_gradient_clip(c.GradientClipByValue(0.01, -0.02),
                                program=main)
        elif clip_kind == "norm":
            c.set_gradient_clip(c.GradientClipByNorm(0.05), program=main)
        elif clip_kind == "global_norm":
            c.set_gradient_clip(c.GradientClipByGlobalNorm(0.1),
                                program=main)
        elif clip_kind == "two_groups":
            c.set_gradient_clip(c.GradientClipByGlobalNorm(0.1, "a"),
                                param_list=params[:2], program=main)
            c.set_gradient_clip(c.GradientClipByGlobalNorm(0.03, "b"),
                                param_list=[p.name for p in params[2:]],
                                program=main)
        elif clip_kind == "own_and_global":
            c.set_gradient_clip(c.GradientClipByGlobalNorm(0.1),
                                param_list=params[1:], program=main)
        pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
        return loss
    return fn


_KINDS = ["value", "norm", "global_norm", "two_groups", "own_and_global",
          "error"]
_CLIP_OPS = {"value": "clip", "norm": "clip_by_norm",
             "global_norm": "squared_l2_norm", "two_groups": "squared_l2_norm",
             "own_and_global": "clip", "error": "clip"}


@pytest.mark.parametrize("kind", _KINDS)
def test_minimize_under_clip_builds_the_jax_program_and_trains_alike(kind):
    built = build_both(_mlp(kind))
    for i in (0, 1):
        assert program_ops(built["torch"][i]) == program_ops(built["jax"][i])
    types_ = [op.type for op in built["torch"][0].global_block().ops]
    assert _CLIP_OPS[kind] in types_
    if kind in ("global_norm", "two_groups"):
        assert types_.count("squared_l2_norm") == 4
        assert types_.count("sqrt") == (1 if kind == "global_norm" else 2)
    if kind == "error":
        # right after the op that writes the activation's grad, before
        # the grad ops that read it
        i = types_.index("clip")
        assert types_[i - 1] == "fc_grad" or types_[i - 1].endswith("_grad")
        assert "momentum" in types_[i + 1:]
    pair = Pair(built)
    loss = built["torch"][2].name
    rng = np.random.RandomState(7)
    feed = {"x": rng.randn(16, 12).astype(np.float32) * 3,
            "y": rng.randint(0, 4, size=(16, 1)).astype(np.int64)}
    for _ in range(3):
        (jl,), (tl,) = pair.step(feed, [loss])
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    pair.assert_state_close(1e-5)


def test_set_gradient_clip_touches_only_its_program():
    for pkg in (jfluid, tfluid):
        a, b = pkg.Program(), pkg.Program()
        for prog in (a, b):
            with pkg.unique_name.guard(), pkg.program_guard(prog,
                                                            pkg.Program()):
                pkg.layers.fc(pkg.layers.data("x", shape=[3]), size=2)
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByNorm(1.0),
                                   program=a)
        assert all(p.gradient_clip_attr is not None
                   for p in a.global_block().all_parameters())
        assert all(p.gradient_clip_attr is None
                   for p in b.global_block().all_parameters())


def test_a_group_with_two_clip_norms_raises_in_both():
    def fn(pkg, main):
        x = pkg.layers.data("x", shape=[3], dtype="float32")
        h = pkg.layers.fc(pkg.layers.fc(x, size=3), size=2)
        loss = pkg.layers.mean(h)
        params = main.global_block().all_parameters()
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0),
                                   param_list=params[:2], program=main)
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(2.0),
                                   param_list=params[2:], program=main)
        with pytest.raises(ValueError, match="same clip norm"):
            pkg.optimizer.SGD(0.1).minimize(loss)

    build_both(fn)


# ---------------------------------------------------------------------------
# the transformer with noam and global-norm clipping
# ---------------------------------------------------------------------------

TR = dict(vocab_size=64, seq_len=32, d_model=64, n_heads=2, n_layers=2,
          d_ff=128)
TR_BATCH = 2


def _transformer(models):
    def fn(pkg, main):
        tokens = pkg.layers.data("tokens", shape=[TR["seq_len"]],
                                 dtype="int64")
        labels = pkg.layers.data("labels", shape=[TR["seq_len"]],
                                 dtype="int64")
        logits = models.build(tokens, **TR)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.reshape(logits, [-1, TR["vocab_size"]]),
            pkg.layers.reshape(labels, [-1, 1])))
        lr = pkg.layers.noam_decay(TR["d_model"], 4000)
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0),
                                   program=main)
        _, params_grads = pkg.optimizer.Adam(
            lr, beta1=0.9, beta2=0.98, epsilon=1e-9).minimize(loss)
        # the clipped grads' global norm
        norm = pkg.layers.sqrt(pkg.layers.sums(
            [pkg.layers.reduce_sum(pkg.layers.square(g))
             for _, g in params_grads]))
        drops = [op for op in main.global_block().ops
                 if op.type == "dropout"]
        for op in drops:  # the RNG streams differ
            op.attrs["dropout_prob"] = 0.0
        return loss, lr, norm
    return fn


def test_transformer_with_noam_and_global_norm_clip_matches_jax():
    built = {}
    for key, pkg, models in (("jax", jfluid, jt), ("torch", tfluid, tt)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 9
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            built[key] = (main, startup, _transformer(models)(pkg, main))
    for i in (0, 1):
        assert program_ops(built["torch"][i]) == program_ops(built["jax"][i])
    types_ = [op.type for op in built["torch"][0].global_block().ops]
    assert {"flash_attention", "flash_attention_grad", "squared_l2_norm",
            "elementwise_max", "adam", "increment"} <= set(types_)
    pair = Pair(built)
    loss, lr, norm = (v.name for v in built["torch"][2])
    tokens = np.random.RandomState(0).randint(
        0, TR["vocab_size"], size=(TR_BATCH, TR["seq_len"] + 1))
    feed = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    params = sorted(p.name for p in built["jax"][0].all_parameters())
    grads = {}
    for t in range(3):
        fetch = [loss, lr, norm] + ([p + "@GRAD" for p in params]
                                    if t == 0 else [])
        jr, tr = pair.step(feed, fetch)
        for name, j, g in zip(fetch, jr, tr):
            assert_scaled_close(g, j, 1e-5, "%s step %d" % (name, t))
        if t == 0:
            grads = dict(zip(params, jr[3:]))
        step = t + 1
        want_lr = TR["d_model"] ** -0.5 * min(step ** -0.5,
                                               4000 ** -1.5 * step)
        np.testing.assert_allclose(tr[1].ravel(), [want_lr], rtol=1e-6)
        assert float(tr[2].ravel()[0]) <= 1.0 + 1e-5
    pair.assert_state_close(1e-5, [n for n in pair.init if n not in grads])
    # the parameters: rtol 1e-5 of each array's largest magnitude, except
    # where the step-1 gradient is small against the array's largest
    # (below 1e-3 of it: the key bias, which softmax leaves exactly
    # gradient-free, and a few others).  Adam with epsilon 1e-9 divides
    # each element's first moment by the root of its second, so the
    # moments' agreement above (1e-5 of the largest) is a relative error
    # of up to a few percent on such an element's normalised step; those
    # elements get atol = 3 steps x lr, the most Adam can move them
    for name in params:
        want = np.asarray(pair.jscope.get(name))
        got = tfluid.as_numpy(pair.tscope.get(name))
        g = grads[name]
        small = np.abs(g) <= 1e-3 * np.abs(g).max()
        atol = np.where(small, 3 * float(tr[1].ravel()[0]),
                        1e-5 * np.abs(want).max())
        bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
        assert not bad.any(), (name, float(np.abs(got - want).max()))
        assert small.mean() < 0.5, name
