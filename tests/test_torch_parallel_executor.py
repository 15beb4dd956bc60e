"""The port's ParallelExecutor (fluid/parallel_executor.py) on the CPU:
2- and 4-rank gloo worlds (tests/torch_dp_worker.py, started by
parallel.mesh.launch) against the JAX ParallelExecutor on a mesh of as
many of the conftest's virtual CPU devices, and against the port's own
single-process Executor on the global batch.

* A small ResNet with batch norm kept (32 x 32, global batch 8, Momentum
  0.01 with L2Decay, startup state from the JAX package; the small rate
  is explained at torch_dp_worker.LR): 5 steps per op,
  under whole-graph AD and under block_out remat.  The losses agree at
  rtol 1e-5 with both references; the state (parameters, velocities,
  MeanOut/VarianceOut) after each step within rtol 1e-5 of both, the
  absolute floor scaled by the state's largest magnitude (why not each
  array's: _close_state); the moving statistics are the same on every
  rank.
* The control: per-rank statistics (each rank's batch norm and loss mean
  over its own rows, gradients averaged, as plain PyTorch data
  parallelism computes) differ from the global step by far more than
  that tolerance.
* GradientScaleStrategy.One: one step per op and whole graph equals the
  JAX ParallelExecutor's One step, and its update is the world size times
  CoeffNumDevice's gradient step with the weight decay added once.
* run_loop(3) equals three run() calls; the ragged stacked_dynamic_lstm
  and a net whose loss is a ragged mean (the ranks hold different numbers
  of real rows) agree with both references.
* Fetches: the loss is the same on every rank, accuracy's Correct and
  Total are the global batch's, and the prediction (a batch-axis fetch)
  is gathered in rank order: the Executor's on the global batch.
* In one process: a world of one equals the Executor; the strategies'
  knobs, the unported ones raising, and the gradient buckets.
"""

import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
import torch_dp_worker as W
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import stacked_dynamic_lstm as jlstm
from paddle_tpu.parallel.mesh import DATA_AXIS, make_mesh
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.fluid import functionalizer
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import stacked_dynamic_lstm as tlstm
from paddle_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dp_worker.py")
RTOL = 1e-5
# the optimizer accumulators' tolerance, in norm (_close_state): the
# relu flip at 4 ranks puts them 1.2e-3 apart after the first step
ACC_RTOL = 1e-2
# each spawn's own limit; the gloo world's rendezvous and collectives
# time out before it
SPAWN_TIMEOUT_S = 240
LANES = {2: ["coeff", "wg", "remat", "one", "one_wg", "loop", "loop_runs",
             "lstm", "ragged", "cumsum", "slice", "slice_keep", "softmax",
             "reshape", "mt"],
         4: ["coeff", "lstm", "ragged"]}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _flags_back():
    yield
    FLAGS.whole_graph_ad = False
    FLAGS.remat_policy = ""


def _close(got, want, rtol=RTOL, what=""):
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
        err_msg=what)


def _is_accumulator(name):
    """An optimizer's accumulator: Momentum's velocity, Adam's moments."""
    return "_velocity_" in name or "_moment" in name


def _close_state(got, want, step=None, rtol=RTOL, what=""):
    """The parameters and moving statistics of a state ({name: array},
    `got` stacked over steps when `step` is given) each within rtol, the
    absolute floor rtol times the largest magnitude of them all, not of
    each array: a relu whose input is a rounding away from 0 can flip
    between two summation orders, and the batch-norm biases' gradients
    are sums that cancel to about 1% of their terms, so one flip moves
    such a bias by percents (at 4 ranks one flip changed 97 elements of
    one image's gradient at the first batch norm by up to 5%, and that
    bias's gradient by 8.8%).  The optimizer accumulators hold the
    gradients undamped by the learning rate, where one flip moves single
    elements by up to 17%: they are held together, as one vector, to
    ACC_RTOL in norm.  A per-rank statistics error moves every one of
    them by its size (the control test)."""
    assert sorted(got) == sorted(want)
    pick = (lambda v: v) if step is None else (lambda v: v[step])
    plain = [n for n in want if not _is_accumulator(n)]
    floor = rtol * max(float(np.abs(want[n]).max()) for n in plain)
    for name in plain:
        np.testing.assert_allclose(pick(got[name]), want[name], rtol=rtol,
                                   atol=floor, err_msg="%s %s" % (what, name))
    accs = [n for n in want if _is_accumulator(n)]
    if accs:
        diff = np.sqrt(sum(float(np.sum(np.square(
            pick(got[n]).astype(np.float64) - want[n]))) for n in accs))
        norm = np.sqrt(sum(float(np.sum(np.square(
            want[n].astype(np.float64)))) for n in accs))
        assert diff <= ACC_RTOL * norm, (what, diff / norm)


def _jax_init(startup):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return {n: np.asarray(scope.get(n)) for n in scope.keys()}


def _nets():
    """name -> (JAX builder, port builder, global feeds maker)."""
    return {
        "resnet": (lambda: W.small_resnet(jfluid, jresnet),
                   lambda: W.small_resnet(tfluid, tresnet),
                   lambda pkg: W.image_batches()),
        "lstm": (lambda: W.small_lstm(jfluid, jlstm),
                 lambda: W.small_lstm(tfluid, tlstm),
                 lambda pkg: W.ragged_batches(pkg.LoDTensor, steps=3)),
        "ragged": (lambda: W.ragged_mean_net(jfluid),
                   lambda: W.ragged_mean_net(tfluid),
                   lambda pkg: W.ragged_batches(pkg.LoDTensor, steps=3,
                                                labels=False)),
        "mt": (lambda: W.small_mt(jfluid, jmt),
               lambda: W.small_mt(tfluid, tmt),
               lambda pkg: W.mt_batches(pkg.LoDTensor)),
        **{"rowmix_" + op: (lambda op=op: W.rowmix_net(jfluid, op),
                            lambda op=op: W.rowmix_net(tfluid, op),
                            lambda pkg: W.rowmix_batches())
           for op in ("cumsum", "slice", "slice_keep", "softmax")},
    }


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    """The JAX package's startup state of each net, also as the ranks'
    npz files; (workdir, {name: state})."""
    wd = str(tmp_path_factory.mktemp("dp"))
    out = {}
    for name, (jbuild, _, _) in _nets().items():
        out[name] = _jax_init(jbuild()[1])
        np.savez(os.path.join(wd, "init_%s.npz" % name), **out[name])
    return wd, out


def _executor_run(build, init, feeds, fetch_extra=()):
    """The port's single-process Executor on the global batches: (losses,
    fetches per step, state per step)."""
    main, _, loss = build()[:3]
    scope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses, fetched, states = [], [], []
    with tfluid.scope_guard(scope):
        for feed in feeds:
            outs = exe.run(main, feed=feed,
                           fetch_list=[loss] + list(fetch_extra))
            losses.append(float(np.asarray(outs[0]).ravel()[0]))
            fetched.append(outs)
            states.append({n: tfluid.as_numpy(scope.get(n))
                           for n in functionalizer.persistable_names(main)})
    return losses, fetched, states


def _jax_pe_run(build, init, feeds, world, strategy=None):
    """The JAX ParallelExecutor on a mesh of `world` virtual devices:
    (losses, state per step)."""
    main, _, loss = build()[:3]
    scope = jfluid.Scope()
    for k, v in init.items():
        scope.set(k, v)
    losses, states = [], []
    with jfluid.scope_guard(scope):
        pe = jfluid.ParallelExecutor(
            use_cuda=False, loss_name=loss.name, main_program=main,
            build_strategy=strategy,
            mesh=make_mesh({DATA_AXIS: world}, jax.devices()[:world]))
        for feed in feeds:
            out, = pe.run([loss.name], feed=feed)
            losses.append(float(np.asarray(out).ravel()[0]))
            states.append({n: np.asarray(scope.get(n))
                           for n in jfluid.functionalizer.persistable_names(
                               main)})
    return losses, states


def _spawn(n, workdir):
    """A gloo world of n ranks running LANES[n]: each rank's arrays."""
    results = mesh.launch([WORKER, "train", workdir] + LANES[n], n,
                          use_cuda=False, capture=True,
                          timeout=SPAWN_TIMEOUT_S)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, "rank %d failed:\n%s" % (rank, err[-4000:])
    arrays = []
    for rank in range(n):
        with np.load(os.path.join(workdir, "rank%d_train.npz" % rank)) as z:
            arrays.append({k: z[k] for k in z.files})
    return arrays


@pytest.fixture(scope="module")
def world2(inits):
    return 2, _spawn(2, inits[0])


@pytest.fixture(scope="module")
def world4(inits):
    return 4, _spawn(4, inits[0])


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def world(request):
    """Each world in turn: (n, [each rank's arrays])."""
    return request.getfixturevalue("world%d" % request.param)


@pytest.fixture(scope="module")
def references(inits):
    """The port's Executor on the global batches of each net, the
    resnet's with its accuracy counts and prediction fetched."""
    _, init = inits
    out = {}
    for name, (_, tbuild, feeds) in _nets().items():
        extra = ()
        if name == "resnet":
            main, _, _, acc, predict = tbuild()
            extra = (acc.name,) + W.accuracy_counts(main) + (predict.name,)
        elif name.startswith("rowmix_"):
            extra = (tbuild()[3].name,)
        out[name] = _executor_run(tbuild, init[name], feeds(tfluid), extra)
    return out


def _states(arrays, lane):
    pre = lane + "/state/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


@pytest.mark.parametrize("n, lane", [(2, "coeff"), (2, "wg"),
                                      (2, "remat"), (4, "coeff")],
                         ids=["world2-coeff", "world2-wg", "world2-remat",
                              "world4-coeff"])
def test_bn_kept_resnet_matches_the_executor_on_the_global_batch(
        request, references, n, lane):
    _, arrays = request.getfixturevalue("world%d" % n)
    want_losses, _, want_states = references["resnet"]
    for rank in range(n):
        _close(arrays[rank][lane + "/losses"], want_losses,
               what="rank %d losses" % rank)
    got = _states(arrays[0], lane)
    for step, want in enumerate(want_states):
        _close_state(got, want, step, what="step %d" % step)


def test_bn_kept_resnet_matches_the_jax_parallel_executor(world, inits):
    n, arrays = world
    _, init = inits
    jbuild = _nets()["resnet"][0]
    losses, states = _jax_pe_run(jbuild, init["resnet"], W.image_batches(),
                                 n)
    _close(arrays[0]["coeff/losses"], losses)
    got = _states(arrays[0], "coeff")
    stats = [k for k in got if k.endswith(("mean_0", "var_0"))]
    n_bn = [op.type for op in jbuild()[0].global_block().ops].count(
        "batch_norm")
    assert len(stats) == 2 * n_bn == 12  # MeanOut and VarianceOut
    for step, want in enumerate(states):
        _close_state(got, want, step, what="step %d" % step)


def test_moving_statistics_are_the_same_on_every_rank(world):
    n, arrays = world
    st0 = _states(arrays[0], "coeff")
    stats = [k for k in st0 if k.endswith(("mean_0", "var_0"))]
    assert stats and all(
        not np.array_equal(st0[k][-1], st0[k][0]) for k in stats)
    for rank in range(1, n):
        st = _states(arrays[rank], "coeff")
        for k in stats:
            np.testing.assert_array_equal(st[k], st0[k], err_msg=k)


def test_per_rank_statistics_control_differs_beyond_tolerance(world, inits,
                                                              references):
    """What plain PyTorch data parallelism computes (each rank's batch
    norm statistics and loss mean over its own rows, the gradients
    averaged), done by hand with the port's Executor on each rank's
    share: its step-0 loss, gradients and moving variances differ from
    the global step by far more than the tolerance."""
    n, _ = world
    init = inits[1]["resnet"]
    main, _, loss = W.small_resnet(tfluid, tresnet)[:3]
    params = [p.name for p in main.global_block().all_parameters()]
    variances = [k for k in init if k.endswith("var_0")]
    feed = W.image_batches()[0]

    def step(f):
        scope = tfluid.scope_from_jax(init, tfluid.Scope(),
                                      tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            outs = tfluid.Executor(tfluid.CPUPlace()).run(
                main, feed=f,
                fetch_list=[loss] + [p + "@GRAD" for p in params])
            var = {k: tfluid.as_numpy(scope.get(k)) for k in variances}
        return float(np.asarray(outs[0]).ravel()[0]), outs[1:], var

    g_loss, g_grads, g_var = step(feed)
    parts = [step(W.shard(feed, r, n, tfluid.LoDTensor)) for r in range(n)]
    local_loss = np.mean([p[0] for p in parts])
    assert g_loss == pytest.approx(references["resnet"][0][0], rel=RTOL)
    assert abs(local_loss - g_loss) / abs(g_loss) > 30 * RTOL
    worst = max(
        np.abs(np.mean([p[1][i] for p in parts], axis=0) - g).max()
        / np.abs(g).max() for i, g in enumerate(g_grads))
    assert worst > 1000 * RTOL
    var_gap = max(np.abs(np.mean([p[2][k] for p in parts], axis=0)
                         - g_var[k]).max() / np.abs(g_var[k]).max()
                  for k in variances)
    assert var_gap > 30 * RTOL


def test_gradient_scale_one_matches_jax_and_adds_the_decay_once(world2,
                                                                 inits):
    n, arrays = world2
    _, init = inits
    jbuild = _nets()["resnet"][0]
    one = jfluid.BuildStrategy()
    one.gradient_scale_strategy = \
        jfluid.BuildStrategy.GradientScaleStrategy.One
    losses, states = _jax_pe_run(jbuild, init["resnet"],
                                 W.image_batches()[:1], n, strategy=one)
    for lane in ("one", "one_wg"):
        _close(arrays[0][lane + "/losses"], losses, what=lane)
        _close_state(_states(arrays[0], lane), states[0], 0, what=lane)
    # Momentum's first step: p1 = p0 - lr (g + 1e-4 p0) under
    # CoeffNumDevice and p0 - lr (n g + 1e-4 p0) under One
    coeff, one_st = _states(arrays[0], "coeff"), _states(arrays[0], "one")
    main = W.small_resnet(tfluid, tresnet)[0]
    for p in main.global_block().all_parameters():
        p0 = init["resnet"][p.name]
        d_coeff = coeff[p.name][0] - p0
        d_one = one_st[p.name][0] - p0
        want = n * d_coeff + (n - 1) * W.LR * 1e-4 * p0
        # the deltas are differences of fp32 states: a few ulps of p0
        ulps = 4 * np.finfo(np.float32).eps * float(np.abs(p0).max())
        np.testing.assert_allclose(d_one, want, rtol=1e-4, atol=ulps,
                                   err_msg=p.name)


def test_run_loop_equals_run_calls(world2):
    _, arrays = world2
    a = arrays[0]
    assert a["loop/losses"][0] == a["loop_runs/losses"][-1]
    loop, runs = _states(a, "loop"), _states(a, "loop_runs")
    for k in loop:
        np.testing.assert_array_equal(loop[k][-1], runs[k][-1], err_msg=k)


@pytest.mark.parametrize("net", ["lstm", "ragged"])
def test_ragged_nets_match_both_references(world, inits, references, net):
    """Feeds split by whole sequences: the ranks hold different numbers
    of real rows, and the ragged mean is still the global batch's."""
    n, arrays = world
    _, init = inits
    jbuild, _, feeds = _nets()[net]
    jl, jstates = _jax_pe_run(jbuild, init[net], feeds(jfluid), n)
    want, _, wstates = references[net]
    for rank in range(n):
        _close(arrays[rank][net + "/losses"], want, what="rank %d" % rank)
    _close(arrays[0][net + "/losses"], jl)
    got = _states(arrays[0], net)
    _close_state(got, wstates[-1], -1, what="executor")
    _close_state(got, jstates[-1], -1, what="jax")
    if net == "ragged":
        lens = W.ragged_batches(tfluid.LoDTensor, steps=1,
                                labels=False)[0]["words"]
        assert arrays[0]["ragged/hidden_lens"].tolist() == \
            lens.recursive_sequence_lengths()[0]


def test_fetches_follow_the_global_arrays(world, references):
    n, arrays = world
    _, fetched, _ = references["resnet"]
    for rank in range(n):
        a = arrays[rank]
        np.testing.assert_array_equal(a["coeff/losses"],
                                      arrays[0]["coeff/losses"])
        for step, want in enumerate(fetched):
            _close(a["coeff/acc"][step], want[1])
            assert a["coeff/correct"][step].tolist() == want[2].tolist()
            assert a["coeff/total"][step].tolist() == [W.GLOBAL_BATCH]
            assert a["coeff/predict"][step].shape == (W.GLOBAL_BATCH, 10)
            _close(a["coeff/predict"][step], want[4])


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_a_world_of_one_is_the_executor(inits, references, monkeypatch):
    monkeypatch.setenv("CPU_NUM", "1")
    _, init = inits
    main, _, loss = W.small_resnet(tfluid, tresnet)[:3]
    scope = tfluid.scope_from_jax(init["resnet"], tfluid.Scope(),
                                  tfluid.CPUPlace())
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=main, scope=scope)
    assert pe.device_count == 1 and not pe.group.active
    losses = [float(np.asarray(pe.run([loss.name], feed=f)[0]).ravel()[0])
              for f in W.image_batches()[:2]]
    _close(losses, references["resnet"][0][:2])


def test_strategies_and_unported_knobs(monkeypatch):
    monkeypatch.setenv("CPU_NUM", "1")
    es, bs = tfluid.ExecutionStrategy(), tfluid.BuildStrategy()
    assert es.num_threads == 0 and es.num_iteration_per_drop_scope == 100
    assert bs.reduce_strategy == tfluid.BuildStrategy.ReduceStrategy.AllReduce
    assert bs.gradient_scale_strategy == \
        tfluid.BuildStrategy.GradientScaleStrategy.CoeffNumDevice
    main, _, loss = W.mlp(tfluid)[:3]
    for knob, value, match in (
            ("fuse_elewise_add_act_ops", True, "queue 1 item 11"),
            ("debug_graphviz_path", "/dev/null", "queue 1 item 11"),
            ("gradient_scale_strategy",
             tfluid.BuildStrategy.GradientScaleStrategy.Customized,
             "Customized")):
        s = tfluid.BuildStrategy()
        setattr(s, knob, value)
        with pytest.raises(NotImplementedError, match=match):
            tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                    main_program=main, build_strategy=s,
                                    scope=tfluid.Scope())
    # run(as_future=True) is ported: a FetchFuture of the sync fetches
    main, startup, loss = W.mlp(tfluid)[:3]
    outs = []
    for as_future in (False, True):
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            tfluid.Executor(tfluid.CPUPlace()).run(startup)
        pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main, scope=scope)
        out = pe.run([loss.name], feed=W.mlp_batches()[0],
                     as_future=as_future)
        if as_future:
            assert isinstance(out, tfluid.FetchFuture)
            out = out.result()
        outs.append(out[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_num_trainers_without_a_world_raises():
    main, _, loss = W.mlp(tfluid)[:3]
    with pytest.raises(RuntimeError, match="collective world has 1"):
        tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main, num_trainers=2,
                                trainer_id=0, scope=tfluid.Scope())


def test_several_devices_without_a_world_raise(monkeypatch):
    """One process with CPU_NUM=2 and no world does not train a world of
    one quietly: it raises and names the launcher and the way out."""
    monkeypatch.setenv("CPU_NUM", "2")
    main, _, loss = W.mlp(tfluid)[:3]
    with pytest.raises(RuntimeError, match="2 CPU_NUM slots") as e:
        tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main, scope=tfluid.Scope())
    assert "parallel.mesh.launch" in str(e.value)
    assert "fluid_benchmark --parallel" in str(e.value)
    assert "CPU_NUM=1" in str(e.value)


def test_use_cuda_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    main, _, loss = W.mlp(tfluid)[:3]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.ParallelExecutor(use_cuda=True, loss_name=loss.name,
                                main_program=main, scope=tfluid.Scope())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.local_device_count(use_cuda=True)


def test_per_device_feed_lists_are_merged(references, inits, monkeypatch):
    """A list of per-device dicts is one global feed: dense arrays
    concatenated, LoDTensors with their lengths."""
    monkeypatch.setenv("CPU_NUM", "1")
    _, init = inits
    _, tbuild, feeds = _nets()["lstm"]
    main, _, loss = tbuild()[:3]
    scope = tfluid.scope_from_jax(init["lstm"], tfluid.Scope(),
                                  tfluid.CPUPlace())
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=main, scope=scope)
    feed = feeds(tfluid)[0]
    parts = [W.shard(feed, r, 2, tfluid.LoDTensor) for r in range(2)]
    out, = pe.run([loss.name], feed=parts)
    _close(np.asarray(out).ravel(), [references["lstm"][0][0]])


def test_local_device_count_honours_cpu_num(monkeypatch):
    monkeypatch.setenv("CPU_NUM", "3")
    assert mesh.local_device_count(use_cuda=False) == 3
    monkeypatch.delenv("CPU_NUM")
    assert mesh.local_device_count(use_cuda=False) == 1
    assert mesh.DATA_AXIS == "data"


def test_all_reduce_sum_of_a_world_of_one_is_the_identity():
    g = mesh.DataParallelGroup()
    x = torch.randn(5, requires_grad=True)
    y = mesh.all_reduce_sum(x, g, "t")
    y.backward(torch.full((5,), 2.0))
    assert torch.equal(y.detach(), x.detach())
    assert torch.equal(x.grad, torch.full((5,), 2.0))
    assert g.counts == {"t": 1, "t_grad": 1}
    assert mesh.all_reduce_sum(x, None, "t") is x


def test_gradient_buckets_split_at_the_cap():
    ts = [torch.zeros(n) for n in (10, 10, 30, 5, 1)]
    assert functionalizer._grad_buckets(ts, 80) == [[0, 1], [2], [3, 4]]
    assert functionalizer._grad_buckets(ts, 4) == [[0], [1], [2], [3], [4]]
    assert functionalizer._grad_buckets(ts, 1 << 20) == [[0, 1, 2, 3, 4]]


# ---------------------------------------------------------------------------
# on the cards: one NCCL rank per visible card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_parity_on_the_visible_cards(inits):
    """The per-op, whole-graph and ragged lanes on every visible card
    (NCCL, deterministic cuDNN) against the port's Executor on card 0
    with the global batch: losses at rtol 1e-5, the state as on the CPU
    (_close_state), the moving statistics equal on every rank."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more cards, this host has %d" % n)
    if W.GLOBAL_BATCH % n:
        pytest.skip("the global batch of %d does not split over %d cards"
                    % (W.GLOBAL_BATCH, n))
    wd, init = inits
    lanes = ["coeff", "wg", "lstm", "ragged"]
    results = mesh.launch([WORKER, "train", wd] + lanes, n, use_cuda=True,
                          env={"PADDLE_DP_DEVICE": "cuda"}, capture=True,
                          timeout=SPAWN_TIMEOUT_S)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, "rank %d failed:\n%s" % (rank, err[-4000:])
    arrays = []
    for rank in range(n):
        with np.load(os.path.join(wd, "rank%d_train.npz" % rank)) as z:
            arrays.append({k: z[k] for k in z.files})
    torch.backends.cudnn.deterministic = True
    for net, lane_names in (("resnet", ("coeff", "wg")), ("lstm", ("lstm",)),
                            ("ragged", ("ragged",))):
        _, tbuild, feeds = _nets()[net]
        main, _, loss = tbuild()[:3]
        scope = tfluid.scope_from_jax(init[net], tfluid.Scope(),
                                      tfluid.CUDAPlace(0))
        exe = tfluid.Executor(tfluid.CUDAPlace(0))
        losses, states = [], []
        with tfluid.scope_guard(scope):
            for feed in feeds(tfluid):
                out, = exe.run(main, feed=feed, fetch_list=[loss])
                losses.append(float(np.asarray(out).ravel()[0]))
                states.append({k: tfluid.as_numpy(scope.get(k)) for k in
                               functionalizer.persistable_names(main)})
        for lane in lane_names:
            for rank in range(n):
                _close(arrays[rank][lane + "/losses"], losses,
                       what="%s rank %d" % (lane, rank))
            got = _states(arrays[0], lane)
            for step, want in enumerate(states):
                _close_state(got, want, step, what="%s step %d"
                             % (lane, step))
    st0 = _states(arrays[0], "coeff")
    for rank in range(1, n):
        st = _states(arrays[rank], "coeff")
        for k in st0:
            if k.endswith(("mean_0", "var_0")):
                np.testing.assert_array_equal(st[k], st0[k], err_msg=k)


def test_random_ops_draw_per_rank():
    """Each rank's rows get their own draws (the rank is mixed into the
    op's generator seed); a world of one draws as the Executor does."""
    from paddle_tpu_torch.ops import registry

    class _Op:
        attrs = {"seed": 0}
        uid = 3

    def draw(group):
        g = registry.ExecContext(_Op(), {}, step=2, seed=9,
                                 group=group).generator()
        return torch.rand(16, generator=g)

    alone = draw(None)
    assert torch.equal(draw(mesh.DataParallelGroup(1, 0)), alone)
    r0, r1 = (draw(mesh.DataParallelGroup(2, r)) for r in (0, 1))
    assert not torch.equal(r0, r1) and not torch.equal(r0, alone)
    assert torch.equal(draw(mesh.DataParallelGroup(2, 1)), r1)


@pytest.mark.parametrize("op", ["cumsum", "slice", "slice_keep",
                                "softmax"])
def test_row_mixing_ops_match_the_global_step(world2, inits, references, op):
    """cumsum along the batch axis and a slice of global rows compute the
    JAX ParallelExecutor's global step (and the port's Executor's on the
    global batch), not the rank's share; a slice whose output keeps the
    batch axis stays split across the ranks as its input is; softmax
    over the last axis is the control that mixes no rows.  Each rank fetches the op's output as
    the global array."""
    n, arrays = world2
    name = "rowmix_" + op
    jbuild, tbuild = _nets()[name][:2]
    if op == "slice_keep":  # the output keeps the batch axis
        assert tuple(tbuild()[3].shape) == (-1, 2)
    jlosses, _ = _jax_pe_run(jbuild, inits[1][name], W.rowmix_batches(), n)
    elosses, efetched, _ = references[name]
    _close(np.asarray(elosses), np.asarray(jlosses), what="executor vs jax")
    for rank, a in enumerate(arrays):
        _close(a[op + "/losses"], np.asarray(jlosses),
               what="rank %d vs the JAX PE" % rank)
        _close(a[op + "/losses"], np.asarray(elosses),
               what="rank %d vs the executor" % rank)
        for step, f in enumerate(efetched):
            _close(a[op + "/r"][step], f[1],
                   what="rank %d step %d fetch" % (rank, step))


def test_a_reshape_folding_the_batch_axis_raises_at_construction(world2):
    n, arrays = world2
    for a in arrays:
        err = str(a["reshape/error"])
        assert "reshape2" in err and "batch axis" in err, err


def test_machine_translation_matches_the_executor_on_the_global_batch(
        world2, references):
    """The seq2seq model's DynamicRNN (a `recurrent` op over a sub-block)
    under a 2-rank world: the ops inside the step are judged by the
    row-mixing check like any other (a step's [B, D] slice is
    batch-sharded as its sequence is, and none mixes rows), and each rank
    computes the Executor's step on the global batch."""
    n, arrays = world2
    want, _, wstates = references["mt"]
    for rank in range(n):
        _close(arrays[rank]["mt/losses"], want, what="rank %d" % rank)
    _close_state(_states(arrays[0], "mt"), wstates[-1], -1,
                 what="executor")
