"""Port parity: the optimizers, the lr schedule and the strategies of
``gym_tpu_torch.strategy`` in lockstep with ``gym_tpu.strategy`` (optax).

Optimizers run 10 steps on the same numpy gradients; the strategies run at
K = 4 simulated nodes against the JAX strategy on the CPU node mesh, with
different gradients per node, for 6 steps (two DiLoCo outer steps at
H = 2). Tolerance: rtol 1e-5 / atol 1e-6 on every parameter (f32; the two
frameworks may differ in the last bit of pow, sqrt and their sums), rtol
1e-6 on ``comm_bytes``, the port's node mean against the mean of the JAX
package's per-node values. The stochastic strategies draw their masks,
island shuffles and fault draws from JAX's threefry, bit for bit, so the
same random choices are made on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_tpu.strategy as J
import gym_tpu_torch.strategy as T
from gym_tpu.parallel.mesh import NodeRuntime as JRuntime
from gym_tpu.strategy.diloco import DiLoCoStrategy as JDiLoCo
from gym_tpu.strategy.optim import OptimSpec as JSpec
from gym_tpu.strategy.schedule import build_lr_scale as j_build
from gym_tpu.strategy.simple_reduce import SimpleReduceStrategy as JSimple
from gym_tpu_torch.parallel.axis import AxisCtx
from gym_tpu_torch.strategy.base import StrategyLifecycleError
from gym_tpu_torch.strategy.diloco import DiLoCoStrategy as TDiLoCo
from gym_tpu_torch.strategy.optim import OptimSpec as TSpec
from gym_tpu_torch.strategy.optim import apply_updates
from gym_tpu_torch.strategy.schedule import build_lr_scale as t_build
from gym_tpu_torch.strategy.simple_reduce import (
    SimpleReduceStrategy as TSimple)

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"b": (5,), "w": (3, 4)}
# dict order unlike jax.tree.flatten's sorted order (b, h_10.c, h_2.c, w):
# random draws must be keyed by the JAX leaf index, not the dict position
MIXED = {"w": (3, 4), "h_2.c": (4,), "b": (5,), "h_10.c": (2, 3)}


def _grads(rng, lead=(), shapes=SHAPES):
    return {n: rng.standard_normal(lead + s).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("kwargs", [{"cosine_anneal": False},
                                    {"cosine_anneal": True},
                                    {"warmup_steps": 3, "max_steps": 7}])
def test_lambda_cosine_matches(kwargs):
    j = j_build("lambda_cosine", {"warmup_steps": 2, **kwargs}, 12)
    t = t_build("lambda_cosine", {"warmup_steps": 2, **kwargs}, 12)
    for step in range(14):
        # numpy's and XLA's float32 cos may differ in the last bit
        np.testing.assert_allclose(t(step), np.asarray(j(step)), rtol=1e-6,
                                   err_msg=f"step {step}")
    assert t(0) == 0.0  # the first inner update is zero


@pytest.mark.parametrize("name,kwargs,sched", [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}, True),
    ("adamw", {"lr": 3e-3, "betas": (0.8, 0.95)}, False),
    ("adam", {"lr": 1e-2, "weight_decay": 0.05}, False),
    ("sgd", {"lr": 0.7, "momentum": 0.9, "nesterov": True}, False),
    ("sgd", {"lr": 0.1, "momentum": 0.5, "weight_decay": 0.01}, True),
    ("sgd", {"lr": 0.1}, False),
    # optax's rmsprop (eps inside the root, trace momentum after the lr)
    # and adagrad (accumulator from 0.1), torch's L2 decay ahead of each
    ("rmsprop", {"lr": 1e-2}, False),
    ("rmsprop", {"lr": 1e-2, "alpha": 0.9, "momentum": 0.5,
                 "weight_decay": 0.01}, True),
    ("adagrad", {"lr": 0.1}, False),
    ("adagrad", {"lr": 0.1, "eps": 1e-6, "weight_decay": 0.05}, True),
])
def test_optimizer_lockstep_with_optax(name, kwargs, sched):
    rng = np.random.default_rng(0)
    p0 = _grads(rng)
    jsc = j_build("lambda_cosine", {"warmup_steps": 3, "cosine_anneal": True},
                  10) if sched else None
    tsc = t_build("lambda_cosine", {"warmup_steps": 3, "cosine_anneal": True},
                  10) if sched else None
    jtx = JSpec(name, **kwargs).build(jsc)
    ttx = TSpec(name, **kwargs).build(tsc)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.tensor(v) for n, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(10):
        g = _grads(rng)
        ju, js = jtx.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                            jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        tu, ts = ttx.update({n: torch.tensor(v) for n, v in g.items()}, ts,
                            tp)
        tp = apply_updates(tp, tu)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       err_msg=f"{name} step {step} {n}",
                                       **TOL)


def _run_jax(strategy, k, p0, grads_per_step):
    runtime = JRuntime.create(k, jax.devices("cpu")[:k])
    strategy.finalize(len(grads_per_step))
    strategy.bind_ctx(runtime.ctx)

    def init_fn(_):
        p = {n: jnp.asarray(v) for n, v in p0.items()}
        return p, strategy.init(p)

    params, sstate = runtime.init_state(init_fn)

    def node_step(params, sstate, grads, step):
        p, s, m = strategy.step(grads, params, sstate, step, runtime.ctx)
        return p, s, m["comm_bytes"]

    prog = runtime.compile(node_step, donate_state=False)
    out = []
    for step, g in enumerate(grads_per_step):
        params, sstate, comm = prog(
            params, sstate, runtime.shard_batch(g),
            runtime.shard_batch(np.full((k,), step, np.int32)))
        out.append(({n: np.asarray(v) for n, v in params.items()},
                    np.asarray(comm)))
    return out


def _run_torch(strategy, k, p0, grads_per_step):
    strategy.finalize(len(grads_per_step))
    params = {n: torch.tensor(v).unsqueeze(0).repeat(k, *([1] * v.ndim))
              for n, v in p0.items()}
    ctx = AxisCtx(num_nodes=k)
    sstate = strategy.bind_ctx(ctx).init(params)
    out = []
    for step, g in enumerate(grads_per_step):
        params, sstate, m = strategy.step(
            {n: torch.tensor(v) for n, v in g.items()}, params, sstate, step,
            ctx)
        out.append(({n: v.numpy() for n, v in params.items()},
                    float(m["comm_bytes"])))
    return out


def _check_lockstep(jout, tout):
    for step, ((jp, jc), (tp, tc)) in enumerate(zip(jout, tout)):
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], err_msg=f"step {step}",
                                       **TOL)
        np.testing.assert_allclose(tc, jc.astype(np.float64).mean(),
                                   rtol=1e-6, err_msg=f"comm, step {step}")


@pytest.mark.parametrize("which", ["diloco", "diloco_clip", "simple_reduce",
                                   "simple_reduce_clip"])
def test_strategy_matches_jax_on_node_mesh(which):
    k = 4
    rng = np.random.default_rng(1)
    p0 = _grads(rng)
    grads = [_grads(rng, (k,)) for _ in range(6)]
    clip = 0.5 if which.endswith("clip") else None
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": 2})
    if which.startswith("diloco"):
        js = JDiLoCo(JSpec("adamw", lr=1e-2), H=2, max_norm=clip, **sched)
        ts = TDiLoCo(TSpec("adamw", lr=1e-2), H=2, max_norm=clip, **sched)
    else:
        js = JSimple(JSpec("adamw", lr=1e-2), max_norm=clip, **sched)
        ts = TSimple(TSpec("adamw", lr=1e-2), max_norm=clip, **sched)
    jout = _run_jax(js, k, p0, grads)
    tout = _run_torch(ts, k, p0, grads)
    _check_lockstep(jout, tout)
    if which.startswith("diloco"):
        # after an outer step every node holds the same master, bit for bit
        for n in SHAPES:
            assert all(np.array_equal(tout[4][0][n][0], tout[4][0][n][i])
                       for i in range(k))


@pytest.mark.parametrize("kwargs", [{"codec": "int8"}])
def test_later_slice_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        TDiLoCo(TSpec("adamw"), H=2, **kwargs)


def _stochastic(pkg, which):
    """The same stochastic strategy from either package (``pkg`` is the
    JAX package's or the port's strategy module)."""
    spec = (JSpec if pkg is J else TSpec)("adamw", lr=1e-2)
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": 2})
    name, _, opt = which.partition("-")
    if name == "fedavg":
        kw = {"islands": dict(island_size=2),
              "islands3": dict(island_size=3),
              "islands_participation": dict(island_size=2,
                                            participation=0.5),
              "participation": dict(participation=0.5)}.get(opt, {})
        return pkg.FedAvgStrategy(spec, H=1, **kw, **sched)
    if name == "sparta":
        selector = {"shuffled": pkg.ShuffledSequentialIndexSelector,
                    "partitioned": pkg.PartitionedIndexSelector,
                    }.get(opt, pkg.RandomIndexSelector)(0.3)
        kw = {"interval": dict(interval=2),
              "participation": dict(participation=0.5)}.get(opt, {})
        return pkg.SPARTAStrategy(spec, index_selector=selector, **kw,
                                  **sched)
    if name == "sparta_diloco":
        return pkg.SPARTADiLoCoStrategy(spec, p_sparta=0.3, H=2,
                                        participation=0.75, **sched)
    if name == "diloco":
        kw = {"participation": dict(participation=0.5),
              "shard_outer": dict(shard_outer=True)}[opt]
        return pkg.DiLoCoStrategy(spec, H=2, **kw, **sched)
    if name == "zero":
        return pkg.ZeroReduceStrategy(
            spec, max_norm=0.5 if opt == "clip" else None, **sched)
    raise ValueError(which)


STOCHASTIC = ["fedavg", "fedavg-islands", "fedavg-islands3",
              "fedavg-islands_participation", "fedavg-participation",
              "sparta", "sparta-shuffled", "sparta-partitioned",
              "sparta-interval", "sparta-participation", "sparta_diloco",
              "diloco-participation", "diloco-shard_outer", "zero",
              "zero-clip"]


@pytest.mark.parametrize("which", STOCHASTIC)
def test_stochastic_strategy_matches_jax_on_node_mesh(which):
    """Params every step and ``comm_bytes`` against the JAX strategy on the
    CPU node mesh, from the same per-node gradients."""
    k = 4
    rng = np.random.default_rng(4)
    p0 = _grads(rng, shapes=MIXED)
    grads = [_grads(rng, (k,), MIXED) for _ in range(6)]
    jout = _run_jax(_stochastic(J, which), k, p0, grads)
    tout = _run_torch(_stochastic(T, which), k, p0, grads)
    _check_lockstep(jout, tout)
    # the random choices did something: params differ across nodes at
    # some step, or every step was a full average
    if which.startswith("sparta") or "participation" in which:
        assert any(not np.array_equal(p["w"][0], p["w"][1]) for p, _ in
                   tout)


def test_zero_needs_the_node_context():
    strat = T.ZeroReduceStrategy(TSpec("adamw")).finalize(1)
    params = {n: torch.zeros((4,) + s) for n, s in SHAPES.items()}
    with pytest.raises(StrategyLifecycleError, match="bind_ctx"):
        strat.init(params)


def test_zero_state_of_another_node_count_raises():
    strat = T.ZeroReduceStrategy(TSpec("adamw")).finalize(2)
    params = {n: torch.zeros((4,) + s) for n, s in SHAPES.items()}
    state = strat.bind_ctx(AxisCtx(4)).init(params)
    two = {n: p[:2] for n, p in params.items()}
    with pytest.raises(T.NodeCountMismatchError, match="num_nodes=2"):
        strat.step(two, two, state, 0, AxisCtx(2))


@pytest.mark.parametrize("kwargs", [
    pytest.param(dict(shard_outer=True, participation=0.5),
                 id="shard_outer-participation"),
    pytest.param(dict(codec="int8", participation=0.5),
                 id="codec-participation")])
def test_diloco_option_conflicts_raise_as_in_jax(kwargs):
    with pytest.raises(ValueError):
        JDiLoCo(JSpec("adamw"), H=2, **kwargs)
    with pytest.raises(ValueError):
        TDiLoCo(TSpec("adamw"), H=2, **kwargs)


def test_axis_ctx_collectives_match_jax():
    """psum, pmean, all_gather, node_index and broadcast_from over the node
    dimension against the JAX AxisCtx on the CPU node mesh."""
    k = 4
    x = np.random.default_rng(2).standard_normal((k, 3)).astype(np.float32)
    runtime = JRuntime.create(k, jax.devices("cpu")[:k])
    c = runtime.ctx

    def node_fn(v):
        return (c.psum(v), c.pmean(v), c.all_gather(v),
                c.node_index(), c.broadcast_from(v, 2))

    jout = runtime.compile(node_fn, donate_state=False)(
        runtime.shard_batch(x))
    t = AxisCtx(num_nodes=k)
    tx = torch.tensor(x)
    tout = (t.psum(tx), t.pmean(tx), t.all_gather(tx), t.node_index(),
            t.broadcast_from(tx, 2))
    for j, tt in zip(jout, tout):
        np.testing.assert_allclose(tt.numpy(), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("which", ["diloco", "simple_reduce"] + STOCHASTIC)
def test_comm_events_reconcile_with_comm_bytes(which):
    """Summing ``per_node_tx`` over a step's events gives that step's
    ``comm_bytes``, on gated and ungated steps alike."""
    k = 4
    rng = np.random.default_rng(3)
    shapes = MIXED if which in STOCHASTIC else SHAPES
    p0 = _grads(rng, shapes=shapes)
    grads = [_grads(rng, (k,), shapes) for _ in range(5)]
    if which == "diloco":
        strat = TDiLoCo(TSpec("adamw"), H=2)
    elif which == "simple_reduce":
        strat = TSimple(TSpec("adamw"))
    else:
        strat = _stochastic(T, which)
    out = _run_torch(strat, k, p0, grads)
    template = {n: torch.zeros(s) for n, s in shapes.items()}
    for step, (_, comm) in enumerate(out):
        tx = sum(e.per_node_tx() for e in strat.comm_events(step, template, k))
        np.testing.assert_allclose(comm, tx, rtol=1e-6)
