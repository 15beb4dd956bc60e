"""The training slice: paddle_tpu_torch.models.transformer against
paddle_tpu.models.transformer on the CPU at a small width — the same
program, the JAX startup scope carried across by name, and three Adam
steps that agree in loss, step-1 gradients and parameters; plus the
flash_attention op on a [B, S, H*D] input."""

import inspect
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.models import transformer as jt
from paddle_tpu.ops import pallas_kernels as jkernels
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import pallas_kernels as tkernels

SMALL = dict(batch_size=2, seq_len=32, vocab_size=64, d_model=32,
             n_heads=2, n_layers=2, d_ff=64, lr=1e-3)
STEPS = 3


def _build(pkg, models, dropout_off=True):
    with pkg.unique_name.guard():
        main, startup, feeds, loss, _, logits = models.get_model(**SMALL)
    if dropout_off:
        # the RNG streams differ; p = 0 is the identity in both lowerings
        drops = [op for op in main.global_block().ops
                 if op.type == "dropout"]
        assert len(drops) == 1
        drops[0].attrs["dropout_prob"] = 0.0
    return main, startup, feeds, loss, logits


def test_get_model_signature_and_program_equal_jax():
    assert inspect.signature(tt.get_model) == inspect.signature(jt.get_model)
    jm, js, jfeeds, jloss, jlogits = _build(jfluid, jt, dropout_off=False)
    tm, ts, tfeeds, tloss, tlogits = _build(tfluid, tt, dropout_off=False)
    assert tfeeds == jfeeds and tloss.name == jloss.name
    assert tlogits.shape == jlogits.shape == (-1, 32, 64)
    for jp, tp in ((jm, tm), (js, ts)):
        jops, tops = jp.global_block().ops, tp.global_block().ops
        assert [(o.type, o.inputs, o.outputs) for o in tops] == \
            [(o.type, o.inputs, o.outputs) for o in jops]
        assert list(tp.global_block().vars) == list(jp.global_block().vars)
    types_ = {o.type for o in tm.global_block().ops}
    assert {"flash_attention", "flash_attention_grad", "adam", "gelu",
            "remat_tag", "sum", "scale"} <= types_


@pytest.fixture(scope="module")
def trained():
    """Both packages from the JAX startup scope, STEPS Adam steps on one
    seeded batch; step-1 grads fetched on the way."""
    jm, js, _, jloss, _ = _build(jfluid, jt)
    tm, _, _, tloss, _ = _build(tfluid, tt)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), \
        jfluid.executor.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    carried = tfluid.scope_to_jax(tscope)
    texe = tfluid.Executor(tfluid.CPUPlace())

    tokens = np.random.RandomState(0).randint(
        0, SMALL["vocab_size"], size=(SMALL["batch_size"],
                                      SMALL["seq_len"] + 1))
    feed = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    params = sorted(p.name for p in jm.all_parameters())
    losses, grads = {"jax": [], "torch": []}, {}
    for step in range(STEPS):
        fetch = [jloss.name] + ([p + "@GRAD" for p in params]
                                if step == 0 else [])
        with jfluid.scope_guard(jscope):
            jr = jexe.run(jm, feed=feed, fetch_list=fetch)
        with tfluid.scope_guard(tscope):
            tr = texe.run(tm, feed=feed, fetch_list=fetch)
        losses["jax"].append(float(np.asarray(jr[0])))
        losses["torch"].append(float(tr[0]))
        if step == 0:
            grads = {n: (np.asarray(a), b) for n, a, b in
                     zip(fetch[1:], jr[1:], tr[1:])}
    return types.SimpleNamespace(
        init=init, carried=carried, tscope=tscope, jscope=jscope, ts=_build(tfluid, tt)[1],
        losses=losses, grads=grads, params=params)


def test_jax_startup_scope_carries_across_whole(trained):
    persist = {n for n, v in trained.ts.global_block().vars.items()
               if v.persistable}
    assert persist == set(trained.init) == set(trained.carried)
    for n, a in trained.init.items():
        assert np.array_equal(trained.carried[n], a)


def test_losses_agree_at_every_step(trained):
    # fp32 on both sides; XLA and PyTorch sum the matmuls in other orders
    np.testing.assert_allclose(trained.losses["torch"],
                               trained.losses["jax"], rtol=1e-5)
    assert trained.losses["torch"][-1] < trained.losses["torch"][0]


def test_step1_gradients_agree(trained):
    assert len(trained.grads) == len(trained.params)
    for name, (jg, tg) in trained.grads.items():
        # rtol 1e-4 with an absolute floor scaled by the array's largest
        # magnitude (elements near zero carry only rounding noise)
        np.testing.assert_allclose(tg, jg, rtol=1e-4,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)


def test_params_agree_after_three_adam_steps(trained):
    """rtol 1e-4 with a floor of 1e-5 x the array's largest magnitude —
    except where the step-1 gradient is rounding noise (|g| below 1e-5 x
    the array's largest gradient, e.g. the key bias, which softmax makes
    exactly gradient-free): Adam's normalised step m / sqrt(v) turns such
    noise into a step of up to lr either way, so those elements get
    atol = STEPS x lr."""
    lr = SMALL["lr"]
    for name in trained.params:
        ref = np.asarray(trained.jscope.get(name))
        got = trained.tscope.get(name).numpy()
        g = trained.grads[name + "@GRAD"][0]
        noise = np.abs(g) <= 1e-5 * np.abs(g).max()
        atol = np.where(noise, STEPS * lr, 1e-5 * np.abs(ref).max())
        bad = np.abs(got - ref) > atol + 1e-4 * np.abs(ref)
        assert not bad.any(), (name, float(np.abs(got - ref).max()),
                               int(bad.sum()))
        assert noise.mean() < 0.5, name


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_op_matches_jax_op_on_3d_input(causal):
    """The op lowering, [B, S, H*D] with num_heads, against the JAX op
    `_flash_attention_op`, forward and gradient."""
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg
    rng = np.random.RandomState(4)
    q, k, v, do = (rng.randn(2, 32, 32).astype(np.float32)
                   for _ in range(4))
    op = types.SimpleNamespace(type="flash_attention", uid=1, outputs={},
                               inputs={"Q": ["q"], "K": ["k"], "V": ["v"]},
                               attrs={"num_heads": 2, "causal": causal})

    def jop(a, b, c):
        ctx = jreg.ExecContext(op, {"Q": [a], "K": [b], "V": [c]})
        return jkernels._flash_attention_op(ctx)["Out"]

    jout, jvjp = jax.vjp(jop, *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    tctx = treg.ExecContext(op, {"Q": [tq], "K": [tk], "V": [tv]})
    tout = treg.get_op_def("flash_attention").lower(tctx)["Out"]
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=2e-5)
    jgrads = jvjp(jnp.asarray(do))
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    for name, jg, tg in zip("qkv", jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-4,
                                   err_msg="d" + name)
    assert tkernels.launch_counts["flash_attention_fwd"] == 0
