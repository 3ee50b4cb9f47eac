"""Port parity: the optimizers, the lr schedule and the strategies of
``gym_tpu_torch.strategy`` in lockstep with ``gym_tpu.strategy`` (optax).

Optimizers run 10 steps on the same numpy gradients; the strategies run at
K = 4 simulated nodes against the JAX strategy on the CPU node mesh, with
different gradients per node, through two DiLoCo outer steps (H = 2).
Tolerance: rtol 1e-5 / atol 1e-6 on every parameter (f32; the two
frameworks may differ in the last bit of pow, sqrt and their sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.parallel.mesh import NodeRuntime as JRuntime
from gym_tpu.strategy.diloco import DiLoCoStrategy as JDiLoCo
from gym_tpu.strategy.optim import OptimSpec as JSpec
from gym_tpu.strategy.schedule import build_lr_scale as j_build
from gym_tpu.strategy.simple_reduce import SimpleReduceStrategy as JSimple
from gym_tpu_torch.parallel.axis import AxisCtx
from gym_tpu_torch.strategy.diloco import DiLoCoStrategy as TDiLoCo
from gym_tpu_torch.strategy.optim import OptimSpec as TSpec
from gym_tpu_torch.strategy.optim import apply_updates
from gym_tpu_torch.strategy.schedule import build_lr_scale as t_build
from gym_tpu_torch.strategy.simple_reduce import (
    SimpleReduceStrategy as TSimple)

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"b": (5,), "w": (3, 4)}


def _grads(rng, lead=()):
    return {n: rng.standard_normal(lead + s).astype(np.float32)
            for n, s in SHAPES.items()}


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
    sstate = strategy.init(params)
    ctx = AxisCtx(num_nodes=k)
    out = []
    for step, g in enumerate(grads_per_step):
        params, sstate, m = strategy.step(
            {n: torch.tensor(v) for n, v in g.items()}, params, sstate, step,
            ctx)
        out.append(({n: v.numpy() for n, v in params.items()},
                    m["comm_bytes"]))
    return out


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
    for step, ((jp, jc), (tp, tc)) in enumerate(zip(jout, tout)):
        for n in SHAPES:
            np.testing.assert_allclose(tp[n], jp[n], err_msg=f"step {step}",
                                       **TOL)
        np.testing.assert_allclose(tc, jc, rtol=1e-6)
    if which.startswith("diloco"):
        # after an outer step every node holds the same master, bit for bit
        for n in SHAPES:
            assert all(np.array_equal(tout[4][0][n][0], tout[4][0][n][i])
                       for i in range(k))


@pytest.mark.parametrize("kwargs", [{"shard_outer": True},
                                    {"participation": 0.5},
                                    {"codec": "int8"}])
def test_later_slice_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
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


@pytest.mark.parametrize("which", ["diloco", "simple_reduce"])
def test_comm_events_reconcile_with_comm_bytes(which):
    """Summing ``per_node_tx`` over a step's events gives that step's
    ``comm_bytes``, on gated and ungated steps alike."""
    k = 4
    rng = np.random.default_rng(3)
    p0 = _grads(rng)
    grads = [_grads(rng, (k,)) for _ in range(5)]
    strat = (TDiLoCo(TSpec("adamw"), H=2) if which == "diloco"
             else TSimple(TSpec("adamw")))
    out = _run_torch(strat, k, p0, grads)
    template = {n: torch.zeros(s) for n, s in SHAPES.items()}
    for step, (_, comm) in enumerate(out):
        tx = sum(e.per_node_tx() for e in strat.comm_events(step, template, k))
        np.testing.assert_allclose(comm, tx, rtol=1e-6)
