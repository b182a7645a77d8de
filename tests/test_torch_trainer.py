"""The port's trainer against the JAX package's: the same flax variables
(through `training/convert.py`), the same batch, the same draws (the JAX
step's key turned into the port's explicit draws), one jitted JAX step a
configuration and dtype.

Each step is taken in float64 in both packages (the JAX one under
`jax.enable_x64`, whose draws are float64 draws of the same key) and held
directly, at every seed: losses within 1e-5 (relative to max(1, |loss|)),
every gradient leaf within 1e-4 of its largest entry (floored at 1e-3 of
the net's largest: a bias that feeds a train-mode BN has a gradient of
exactly 0, float noise in both packages), BN statistics within 1e-5, and
three steps' losses within 1e-4.  The float64 trees are compared after
the port's `flat_tree` / `flax_variables` round them to float32, 6e-8 of
each entry.

The float32 steps are a second check.  The synthetic bottle's canonical
clouds give BN / GN channels of small variance next to their mean, where
either package's float32 statistics round far from the exact ones (flax's
E[x^2] - E[x]^2 most), and max-pool near-ties can flip: on one draw of
variables either package can land 1e-2 of a gradient leaf off the exact
step.  So both float32 steps are measured against the port's float64 step
with the float32 draws (the step the direct check ties to the JAX
package's), over SEEDS draws of the (perturbed) norm parameters, and the
port's median distance must be within the tolerance above or twice the
JAX package's median distance.  `eval_step` against the JAX package's
directly, within 1e-4.

Variables: the port's seeded draw in flax names, norm parameters and
statistics perturbed (`perturb`; flax's scale 1 / bias 0 leave many GN
groups of two all-zero ReLU channels).  The 3-step cases train with SGD:
Adam's first updates are +-lr for every entry whatever its size, so an
entry whose gradient is float noise (those biases) moves by a random +-lr
in each package, and the float32 losses part at 1e-3 after three steps.
Adam itself is held to optax on the same gradients in
tests/test_torch_losses.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import make_frame_batch as jmake_frame_batch
from captra_tpu.training import trainer as jtrainer
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data.synthetic import make_frame_batch
from captra_tpu_torch.training import trainer as ttrainer
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.training.convert import flat_tree, flax_variables
from tests.torch_port_helpers import (
    jax_train_draws, perturb, tiny_config, to_numpy, tree_leaves,
)

B, N = 4, 128
STEPS = 3
SEEDS = (1, 2, 3, 4, 5)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-5
STEPS_TOL = 1e-4

# (network type, object, norm): each net on the symmetric bottle and the
# two-part laptop, with BatchNorm and with GroupNorm
CASES = [("canon_coord", "bottle", "bn"), ("canon_coord", "laptop", "gn"),
         ("rot", "bottle", "gn"), ("rot", "laptop", "bn")]
IDS = ["-".join(c) for c in CASES]


def train_config(schema, net, obj, norm, optimizer="sgd"):
    cfg = tiny_config(schema, obj, norm, num_points=N)
    return cfg.replace(
        network=dataclasses.replace(cfg.network, type=net, pwm_num=32),
        perturb=dataclasses.replace(cfg.perturb, r=5.0, t=0.03, s=0.02),
        optim=dataclasses.replace(cfg.optim, grad_clip=1.0,
                                  optimizer=optimizer))


def _double(x):
    if isinstance(x, dict):
        return {k: _double(v) for k, v in x.items()}
    if isinstance(x, Pose):
        return x.map(_double)
    x = torch.as_tensor(x)
    return x.double() if x.is_floating_point() else x


def f64_state(trainer, variables):
    """The port's train state in float64 (BN and GN compute their
    statistics in float64 too)."""
    from captra_tpu_torch.training.convert import load_flax_variables
    module = load_flax_variables(
        trainer.net_cls(trainer.cfg, device="cpu"), variables).double()
    params, grads, layout = ttrainer.flatten_parameters(module)
    return ttrainer.TrainState(module=module, params=params, grads=grads,
                               opt_state=trainer.tx.init(params),
                               layout=layout)


def _jax_step(trainer):
    """The body of `Trainer.train_step` (trainer.py:336-359), returning
    the gradients too."""
    @jax.jit
    def step(state, batch, key):
        def lf(params):
            return trainer.loss_fn(trainer.cfg, trainer.module, params,
                                   state.batch_stats, batch, key, train=True)
        (total, (loss_dict, metrics, new_stats)), grads = (
            jax.value_and_grad(lf, has_aux=True)(state.params))
        updates, opt_state = trainer.tx.update(grads, state.opt_state,
                                               state.params)
        params = optax.apply_updates(state.params, updates)
        new_stats = jax.tree.map(
            lambda new, old: jnp.where(jnp.isfinite(new), new, old),
            new_stats, state.batch_stats)
        loss_dict = dict(loss_dict)
        loss_dict["total_loss"] = total
        return (jtrainer.TrainState(params=params, batch_stats=new_stats,
                                    opt_state=opt_state,
                                    step=state.step + 1),
                loss_dict, metrics, grads)
    return step


_RUNS = {}


def _variables(tt, seed):
    """The port's seeded xavier draw in flax names, norm parameters and
    statistics perturbed from `seed`."""
    return perturb(flax_variables(tt.init_state(
        generator=torch.Generator().manual_seed(0)).module),
        np.random.RandomState(seed))


def _jax_state(jt, variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jtrainer.TrainState(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jt.tx.init(params), step=jnp.zeros((), jnp.int32))


def _record(losses, grads, stats, **extra):
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads=grads, stats=stats, **extra)


def _as_f64(tree):
    """A JAX tree (variables, a batch) with its float leaves in float64;
    under `jax.enable_x64(True)`."""
    def leaf(x):
        x = jnp.asarray(x)
        return x.astype(jnp.float64) if jnp.issubdtype(
            x.dtype, jnp.floating) else x
    return jax.tree.map(leaf, tree)


def _np64(tree):
    if hasattr(tree, "items"):
        return {k: _np64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def _port_record(losses, state, **extra):
    return _record(losses, flat_tree(state, state.grads),
                   flax_variables(state.module)["batch_stats"], **extra)


def step_f64(step, tt, xstate, qstate, s, key):
    """Step `s` (the batch of seed `s`, the draws of `key`) in float64 in
    both packages: the JAX state `xstate` through the jitted `step` under
    x64, the port's float64 `qstate` on the same float64 draws.  Returns
    the new states and the (JAX, port) records."""
    with jax.enable_x64(True):
        jbatch = _as_f64(jmake_frame_batch(s, tt.cfg.obj, batch=B,
                                           num_points=N))
        draws = jax_train_draws(tt.cfg, key, jbatch["labels"])
        xstate, xl, _, xg = step(xstate, jbatch, key)
        xrec = _record(xl, _np64(xg), _np64(xstate.batch_stats))
    batch = make_frame_batch(s, tt.cfg.obj, batch=B, num_points=N)
    qstate, ql, _ = tt.train_step(qstate, _double(batch),
                                  draws=_double(draws))
    return xstate, qstate, xrec, _port_record(ql, qstate)


def run_case(net, obj, norm):
    """STEPS steps of both trainers from the variables of SEEDS[0], a batch
    a step, the same draws, in float32 (and the port in float64 on the
    float32 draws) and in float64 in both packages; then the first step
    from each other seed's variables.  Cached per case."""
    key = (net, obj, norm)
    if key in _RUNS:
        return _RUNS[key]
    jcfg = train_config(jschema, net, obj, norm)
    tcfg = train_config(tschema, net, obj, norm)
    jt = jtrainer.Trainer(jcfg, steps_per_epoch=2)
    tt = ttrainer.Trainer(tcfg, steps_per_epoch=2, device="cpu")
    step = _jax_step(jt)
    names = ("jax", "port", "f64", "jax64", "port64")
    out = {name: [] for name in names}
    out.update(trainer=tt, jtrainer=jt, first=[])
    for seed in SEEDS:
        variables = _variables(tt, seed)
        jstate = _jax_state(jt, variables)
        tstate = tt.init_state(variables=variables)
        rstate = f64_state(tt, variables)
        qstate = f64_state(tt, variables)
        with jax.enable_x64(True):
            xstate = _jax_state(jt, _as_f64(variables))
        for s in range(STEPS if seed == SEEDS[0] else 1):
            k = jax.random.PRNGKey(100 + s)
            jbatch = jmake_frame_batch(s, jcfg.obj, batch=B, num_points=N)
            batch = make_frame_batch(s, tcfg.obj, batch=B, num_points=N)
            draws = jax_train_draws(tcfg, k, jbatch["labels"])
            jstate, jl, jm, jg = step(jstate, jbatch, k)
            rstate, rl, _ = tt.train_step(rstate, _double(batch),
                                          draws=_double(draws))
            tstate, tl, tm = tt.train_step(tstate, batch, draws=draws)
            xstate, qstate, x64, q64 = step_f64(step, tt, xstate, qstate,
                                                s, k)
            runs = dict(
                jax=_record(jl, to_numpy(jg), to_numpy(jstate.batch_stats),
                            metrics={k: float(v) for k, v in jm.items()}),
                f64=_port_record(rl, rstate),
                port=_port_record(tl, tstate, metrics={
                    k: float(v) for k, v in tm.items()}),
                jax64=x64, port64=q64)
            if s == 0:
                out["first"].append(runs)
            if seed == SEEDS[0]:
                for name, rec in runs.items():
                    out[name].append(rec)
        if seed == SEEDS[0]:
            out.update(tstate=tstate, jstate=jstate,
                       init_stats=variables["batch_stats"])
    _RUNS[key] = out
    return out


def _distance(got, ref, floor_frac=None):
    """The largest distance of `got` to `ref` over the leaves: relative to
    the leaf's largest entry with `floor_frac` (floored at that share of
    the largest entry of all leaves), else to max(1, |leaf|)."""
    g, r = dict(tree_leaves(got)), dict(tree_leaves(ref))
    assert sorted(g) == sorted(r), sorted(set(g) ^ set(r))
    top = max(float(np.abs(v).max()) for v in r.values())
    out = 0.0
    for name in r:
        if floor_frac is None:
            scale = max(1.0, float(np.abs(r[name]).max()))
        else:
            scale = max(float(np.abs(r[name]).max()), floor_frac * top)
        diff = np.abs(np.asarray(g[name], np.float64) - r[name]).max()
        out = max(out, float(diff) / scale)
    return out


def _assert_f64_matches_jax(runs, field, tol, floor_frac=None):
    """The port's float64 step within `tol` of the JAX package's float64
    step, in every one of `runs`."""
    dist = [_distance(r["port64"][field], r["jax64"][field], floor_frac)
            for r in runs]
    assert max(dist) <= tol, (field, dist)


def _assert_median_near_f64(run, field, tol, floor_frac=None):
    """Over the SEEDS first steps: the port's float32 median distance to
    the float64 step within `tol` or twice the JAX package's median."""
    pairs = [(_distance(r["port"][field], r["f64"][field], floor_frac),
              _distance(r["jax"][field], r["f64"][field], floor_frac))
             for r in run["first"]]
    port = float(np.median([p for p, _ in pairs]))
    jax_ = float(np.median([j for _, j in pairs]))
    assert port <= max(tol, 2 * jax_), (field, pairs)


@pytest.mark.parametrize("net,obj,norm", CASES, ids=IDS)
def test_train_step_losses_match_jax(net, obj, norm):
    run = run_case(net, obj, norm)
    _assert_f64_matches_jax(run["first"], "losses", LOSS_TOL)
    _assert_median_near_f64(run, "losses", LOSS_TOL)
    for k, v in run["jax"][0]["metrics"].items():
        assert abs(run["port"][0]["metrics"][k] - v) <= 1e-3 * max(1, abs(v))


@pytest.mark.parametrize("net,obj,norm", CASES, ids=IDS)
def test_train_step_gradients_match_jax(net, obj, norm):
    run = run_case(net, obj, norm)
    _assert_f64_matches_jax(run["first"], "grads", GRAD_TOL, floor_frac=1e-3)
    _assert_median_near_f64(run, "grads", GRAD_TOL, floor_frac=1e-3)


@pytest.mark.parametrize("net,obj,norm", CASES, ids=IDS)
def test_train_step_statistics_match_jax(net, obj, norm):
    run = run_case(net, obj, norm)
    got, want = run["port"][0]["stats"], run["jax"][0]["stats"]
    if norm == "gn":
        assert got == {} and want == {}
        assert all(r["port64"]["stats"] == {} == r["jax64"]["stats"]
                   for r in run["first"])
        return
    _assert_f64_matches_jax(run["first"], "stats", STAT_TOL)
    _assert_median_near_f64(run, "stats", STAT_TOL)
    # the statistics moved off their initial values
    init = dict(tree_leaves(run["init_stats"]))
    moved = [float(np.abs(v - init[k]).max()) for k, v in tree_leaves(got)]
    assert min(moved) > 0


@pytest.mark.parametrize("net,obj,norm", CASES, ids=IDS)
def test_three_steps_match_jax(net, obj, norm):
    run = run_case(net, obj, norm)
    _assert_f64_matches_jax(
        [{"port64": q, "jax64": x} for q, x in zip(run["port64"],
                                                   run["jax64"])],
        "losses", STEPS_TOL)
    for s in range(STEPS):
        port = _distance(run["port"][s]["losses"], run["f64"][s]["losses"])
        jax_ = _distance(run["jax"][s]["losses"], run["f64"][s]["losses"])
        assert port <= max(STEPS_TOL, 2 * jax_), (s, port, jax_)
    assert len(run["port64"]) == STEPS
    assert run["tstate"].step == STEPS
    assert run["tstate"].opt_state["count"] == STEPS


@pytest.mark.parametrize("net,obj,norm", [("canon_coord", "laptop", "gn"),
                                          ("rot", "laptop", "bn")])
def test_eval_step_matches_jax(net, obj, norm):
    run = run_case(net, obj, norm)
    jt, tt = run["jtrainer"], run["trainer"]
    jbatch = jmake_frame_batch(7, jt.cfg.obj, batch=B, num_points=N)
    k = jax.random.PRNGKey(7)
    want_l, want_m = jt.eval_step(run["jstate"], jbatch, k)
    draws = jax_train_draws(tt.cfg, k, jbatch["labels"])
    stats = flax_variables(run["tstate"].module)["batch_stats"]
    got_l, got_m = tt.eval_step(
        run["tstate"], make_frame_batch(7, tt.cfg.obj, batch=B,
                                        num_points=N), draws=draws)
    for k_, v in want_l.items():
        assert abs(float(got_l[k_]) - float(v)) <= STEPS_TOL * max(
            1.0, abs(float(v))), (k_, float(got_l[k_]), float(v))
    assert sorted(got_m) == sorted(want_m)
    # eval mode: the running statistics did not move
    assert not run["tstate"].module.training
    after = flax_variables(run["tstate"].module)["batch_stats"]
    for k_, v in tree_leaves(after):
        np.testing.assert_array_equal(v, dict(tree_leaves(stats))[k_])


def test_jax_trained_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX state after STEPS SGD steps, saved by the JAX package, loads
    into the port with its params, statistics, step and trace moments
    equal (`TraceState` and `ScaleByScheduleState`'s count mapped)."""
    from captra_tpu.training import checkpoint as jckpt
    from captra_tpu_torch.training import checkpoint as ckpt
    run = run_case("rot", "laptop", "bn")
    jstate = run["jstate"]
    path = jckpt.save_checkpoint(str(tmp_path), 2, jstate)
    tt = run["trainer"]
    state = ckpt.restore_state(ckpt.load_checkpoint(path), tt.init_state())
    assert state.step == STEPS and state.opt_state["count"] == STEPS
    trace = next(s for s in jstate.opt_state
                 if type(s).__name__ == "TraceState").trace
    for got, want in ((flat_tree(state, state.opt_state["trace"]),
                       to_numpy(trace)),
                      (flax_variables(state.module)["params"],
                       to_numpy(jstate.params)),
                      (flax_variables(state.module)["batch_stats"],
                       to_numpy(jstate.batch_stats))):
        w = dict(tree_leaves(want))
        for k, v in tree_leaves(got):
            np.testing.assert_array_equal(v, w[k], err_msg=k)


BF16_SEEDS = SEEDS[:3]


def test_bf16_train_step_within_twice_the_jax_error():
    """One CoordNet step (laptop, bn) with `network/compute_dtype`
    bfloat16 in both packages: over BF16_SEEDS draws of the variables, the
    port's median distance to the port's float64 step (losses relative to
    max(1, |loss|); gradient leaves to their largest entry, floored at 1e-3
    of the net's) within twice the JAX package's bf16 median distance plus
    one bf16 ulp (2^-8), as tests/test_torch_bf16.py holds the nets.  That
    float64 step is held to the JAX package's float64 step of the same
    (float32) configuration at every seed, at the tolerances above."""
    cfgs = {s: train_config(s, "canon_coord", "laptop", "bn")
            for s in (jschema, tschema)}
    jt32 = jtrainer.Trainer(cfgs[jschema], steps_per_epoch=2)
    f32 = ttrainer.Trainer(cfgs[tschema], steps_per_epoch=2, device="cpu")
    cfgs = {s: c.replace(network=dataclasses.replace(
        c.network, compute_dtype="bfloat16")) for s, c in cfgs.items()}
    jt = jtrainer.Trainer(cfgs[jschema], steps_per_epoch=2)
    tt = ttrainer.Trainer(cfgs[tschema], steps_per_epoch=2, device="cpu")
    step, step32 = _jax_step(jt), _jax_step(jt32)
    k = jax.random.PRNGKey(100)
    jbatch = jmake_frame_batch(0, jt.cfg.obj, batch=B, num_points=N)
    batch = make_frame_batch(0, tt.cfg.obj, batch=B, num_points=N)
    draws = jax_train_draws(tt.cfg, k, jbatch["labels"])
    dist = {"losses": [], "grads": []}
    direct = []
    for seed in BF16_SEEDS:
        variables = _variables(tt, seed)
        _, jl, _, jg = step(_jax_state(jt, variables), jbatch, k)
        tstate, tl, _ = tt.train_step(tt.init_state(variables=variables),
                                      batch, draws=draws)
        rstate, rl, _ = f32.train_step(f64_state(f32, variables),
                                       _double(batch), draws=_double(draws))
        with jax.enable_x64(True):
            xstate = _jax_state(jt32, _as_f64(variables))
        _, _, x64, q64 = step_f64(step32, f32, xstate,
                                  f64_state(f32, variables), 0, k)
        direct.append({"jax64": x64, "port64": q64})
        ref = {"losses": {k_: float(v) for k_, v in rl.items()},
               "grads": flat_tree(rstate, rstate.grads)}
        got = {"losses": {k_: float(v) for k_, v in tl.items()},
               "grads": flat_tree(tstate, tstate.grads)}
        want = {"losses": {k_: float(v) for k_, v in jl.items()},
                "grads": to_numpy(jg)}
        for field, floor_frac in (("losses", None), ("grads", 1e-3)):
            dist[field].append(
                (_distance(got[field], ref[field], floor_frac),
                 _distance(want[field], ref[field], floor_frac)))
    _assert_f64_matches_jax(direct, "losses", LOSS_TOL)
    _assert_f64_matches_jax(direct, "grads", GRAD_TOL, floor_frac=1e-3)
    _assert_f64_matches_jax(direct, "stats", STAT_TOL)
    for field, pairs in dist.items():
        port = float(np.median([p for p, _ in pairs]))
        jax_ = float(np.median([j for _, j in pairs]))
        assert port <= 2 * jax_ + 2.0 ** -8, (field, pairs)
