"""The port's last three scripts (`captra_tpu_torch/cli/sym_pwm_ablation.py`,
`smoke_train_track.py` and `init_search_scorer_diag.py`) against the JAX
scripts they counterpart, loaded by path and run once each (module-scoped
fixtures), on the CPU.

The JAX scripts run as written, with three things swapped in around them:
`get_config` makes the net tiny (as tests/test_torch_quality.py does), the
JAX `Trainer` takes its steps in float64 (`jax.enable_x64`; float32 steps
at test sizes are ill-conditioned, tests/test_torch_trainer.py) from the
port's seeded draw, perturbed and `tame`d (`port_variables`), and records
it, the step keys (the scripts' own split order) and every step's losses,
and the tracker's `make_track_step` / `evaluate_track` and the diag's
numpy record the config and what the scripts print rounded.  The port's
loops then take the same steps in float64 from the same variables with
the draws of the same keys (the smoke's with SGD, `with_sgd`).

Bars: train losses within 1e-5 (relative above 1), every leaf of the
trained variables within 1e-4 of its largest entry; tracked and diag
angles within 5e-4 degrees, other means within 1e-5 (relative above 1);
the diag's residual column within 1e-5 relative; its candidate and
perturbation rotations bit for bit.  The tracked rows and the diag run on
the JAX nets' float32 variables (the diag's written by the JAX package's
checkpoint writer, its NOCS head scaled x30 and a seg bias: a random
head's NPCS has no spread and the fits are ill-conditioned)."""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import re
import sys
import types
from os.path import dirname, join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import captra_tpu.config as jconfig
from captra_tpu.config import get_config as jget_config
from captra_tpu.config import schema as jschema
from captra_tpu.tracking import tracker as jtracker
from captra_tpu.training import checkpoint as jckpt
from captra_tpu.training import trainer as jtrainer
from captra_tpu_torch.cli import init_search_scorer_diag as dg
from captra_tpu_torch.cli import smoke_train_track as sm
from captra_tpu_torch.cli import sym_pwm_ablation as pw
from captra_tpu_torch.config import get_config as tget_config
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data.synthetic import make_frame_batch
from captra_tpu_torch.eval import quality
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.tracking import tracker as ttracker
from captra_tpu_torch.training import trainer as ttrainer
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, flax_variables, rotnet_from_flax,
)
from tests.torch_port_helpers import (
    as_float64, f64_train_state, jax_train_draws, one_torch_thread, perturb,
    tiny_config, to_numpy, tree_leaves,
)

ROOT = dirname(dirname(__file__))
N = 128                      # points a cloud
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
ANGLE_TOL, TOL = 5e-4, 1e-5
NOCS_GAIN, SEG_BIAS = 30.0, 3.0
ROT_GAIN = 0.01              # the smoke RotNet's last layer, about identity
IDENTITY_6D = np.array([1, 0, 0, 0, 1, 0], np.float32)
PWM_ARGV = ["--steps", "3", "--batch", "4", "--pwm", "8",
            "--dtype", "float32"]
SMOKE_ARGV = ["--steps", "3", "--num_points", str(N)]
DIAG_ARGV = ["--trajs", "8", "--dtype", "float32", "--norm", "bn",
             "--offsets", "0,30,90,180", "--perturb_j", "3", "--steps", "2"]
BOTTLE = {"obj_config": "obj_info_nocs.yml", "obj_category": "1"}


def _script(name):
    """A script of `scripts/`, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", pjoin(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tiny(real, schema):
    """`get_config` with the tiny net and N points; the rest as loaded."""
    tiny = tiny_config(schema, num_points=N)

    def get_config(config, overrides=None, base_dir=None):
        cfg = real(config, overrides, base_dir)
        return cfg.replace(
            num_points=N, pointnet=tiny.pointnet,
            network=dataclasses.replace(cfg.network, backbone_out_dim=32,
                                        nocs_head_dims=(16,)))
    return get_config


jtiny = _tiny(jget_config, jschema)
ttiny = _tiny(tget_config, tschema)


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kwargs)
    return buf.getvalue(), ret


def _as_f64(tree):
    def leaf(x):
        x = jnp.asarray(x)
        return x.astype(jnp.float64) if jnp.issubdtype(
            x.dtype, jnp.floating) else x
    return jax.tree.map(leaf, tree)


class _Held:
    """A JAX train state held in float64, with the float32 view of its
    variables that the scripts read (`.params`, `.batch_stats`)."""

    def __init__(self, f64, variables32):
        self.f64 = f64
        self.variables = variables32
        self.params = jax.tree.map(jnp.asarray, variables32["params"])
        self.batch_stats = jax.tree.map(jnp.asarray,
                                        variables32["batch_stats"])


def tame(variables: dict) -> dict:
    """Random nets that track without chaos: the NOCS head scaled
    NOCS_GAIN (a random head's NPCS has no spread, and the s / t fits divide
    by it) and a RotNet's last layer scaled ROT_GAIN with the identity's 6D
    as its bias (a random delta a frame compounds: float32 and float64
    tracks of untamed nets part by 0.3 degrees over 14 frames)."""
    params = variables["params"]
    if "nocs_head" in params:
        head = params["nocs_head"]["dense_1"]
        head["kernel"] = head["kernel"] * np.float32(NOCS_GAIN)
    if "regressor" in params:
        last = params["regressor"]["heads"]["dense_3"]
        last["kernel"] = last["kernel"] * np.float32(ROT_GAIN)
        last["bias"] = np.broadcast_to(IDENTITY_6D, last["bias"].shape).copy()
    return variables


def with_sgd(cfg):
    """`cfg` training with SGD: Adam's first steps are +-lr for every entry
    whatever its size, so an entry whose gradient is float noise in either
    package moves by a random +-lr (a RotNet's leaves part by 2e-4 of their
    largest entry in three float64 steps; tests/test_torch_trainer.py's
    3-step cases train with SGD for the same reason)."""
    return cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                 optimizer="sgd"))


def port_variables(cfg) -> dict:
    """The port's seeded draw of the net of `cfg` (the port's config), in
    flax names: perturbed and `tame`d.  The JAX scripts' trainers start
    from it (flax's eager `init` of a net takes ~10 s on the CPU)."""
    trainer = ttrainer.Trainer(cfg, device="cpu")
    module = trainer.init_state(
        generator=torch.Generator().manual_seed(0)).module
    return tame(perturb(flax_variables(module),
                        np.random.RandomState(1)))


def f64_trainer(legs: list, port_cfg, sgd: bool = False):
    """The JAX `Trainer`, its steps taken in float64 (with SGD if `sgd`)
    from `port_variables(port_cfg(cfg))`; each instance appends its record
    to `legs`: {"cfg" (as the script built it), "variables" (float32, the
    start), "keys", "losses" (a dict a step), "final64" (float64 numpy
    variables after the last step)}."""
    class F64Trainer(jtrainer.Trainer):
        def __init__(self, cfg, *args, **kwargs):
            super().__init__(with_sgd(cfg) if sgd else cfg, *args, **kwargs)
            self.leg = {"cfg": cfg, "keys": [], "losses": []}
            legs.append(self.leg)

        def init_state(self, key, example_batch):
            variables = port_variables(port_cfg(self.leg["cfg"]))
            self.leg["variables"] = variables
            with jax.enable_x64(True):
                params = _as_f64(variables["params"])
                f64 = jtrainer.TrainState(
                    params=params,
                    batch_stats=_as_f64(variables["batch_stats"]),
                    opt_state=self.tx.init(params),
                    step=jnp.zeros((), jnp.int32))
            return _Held(f64, variables)

        def train_step(self, state, batch, key):
            with jax.enable_x64(True):
                new, loss, metrics = super().train_step(
                    state.f64, _as_f64(batch), key)
                loss = {k: float(v) for k, v in loss.items()}
                metrics = {k: float(v) for k, v in metrics.items()}
                final = jax.tree.map(lambda x: np.asarray(x, np.float64),
                                     {"params": new.params,
                                      "batch_stats": new.batch_stats})
            self.leg["keys"].append(np.asarray(key))
            self.leg["losses"].append({**loss, **metrics})
            self.leg["final64"] = final
            return _Held(new, to_numpy(final)), loss, metrics
    return F64Trainer


def _jax_draws(cfg, key, labels):
    """The float64 draws of one JAX step's key, for the port."""
    with jax.enable_x64(True):
        return as_float64(jax_train_draws(cfg, jnp.asarray(key),
                                          np.asarray(labels)))


def _run_script(name, argv, patches):
    """Run `scripts/<name>.py` with `argv` and the (object, attribute,
    value) patches; returns (printed text, the exception it raised or
    None)."""
    script = _script(name)
    buf = io.StringIO()
    raised = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        for obj, attr, value in patches:
            mp.setattr(obj, attr, value)
        with contextlib.redirect_stdout(buf):
            try:
                script.main()
            except AssertionError as e:
                raised = e
    return buf.getvalue(), raised


def assert_close(got: float, want: float, tol: float, where):
    assert abs(got - want) <= tol * max(1.0, abs(want)), (where, got, want)


def assert_means(got: dict, want: dict, where):
    """rdiff within ANGLE_TOL degrees; every other mean within TOL, of
    max(1, |value|) above 1."""
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        tol = ANGLE_TOL if k == "rdiff" else TOL * max(1.0, abs(v))
        assert abs(got[k] - v) <= tol, (where, k, got[k], v)


def assert_leaves(got: dict, want: dict, where):
    """Each leaf of the flax tree `got` within LEAF_TOL of the largest
    entry of the same leaf of `want`."""
    got_leaves = dict(tree_leaves(got))
    want_leaves = dict(tree_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves), where
    for path, w in want_leaves.items():
        g = got_leaves[path].astype(np.float64)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= LEAF_TOL * scale, (where, path, err, scale)


_NUMBER = re.compile(r" *[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)")


def skeleton(text: str, port_only: re.Pattern) -> list[str]:
    """The printed lines with every number replaced by '#', without the
    lines only the port prints."""
    return [_NUMBER.sub("#", line) for line in text.splitlines()
            if not port_only.search(line)]


@pytest.fixture(autouse=True)
def tiny_cli(monkeypatch):
    """The port's CLIs on the tiny net, torch on one thread (under the
    parallel test run torch's thread a core oversubscribes the cores)."""
    for module in (pw, dg):
        monkeypatch.setattr(module, "get_config", ttiny)
    with one_torch_thread():
        yield


# ---------------------------------------------------------------------------
# the pwm ablation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pwm():
    legs = []
    args = pw.parse(PWM_ARGV)
    text, raised = _run_script("sym_pwm_ablation", PWM_ARGV, [
        (jconfig, "get_config", jtiny),
        (jtrainer, "Trainer", f64_trainer(legs, lambda cfg: ttiny(
            "config_coordnet.yml", pw.overrides(args, cfg.network.pwm_num))))])
    assert raised is None
    return {"legs": legs, "text": text}


def _port_pwm_leg(args, pwm, leg):
    cfg = pw.config(args, pwm)
    trainer = ttrainer.Trainer(cfg, steps_per_epoch=pw.STEPS_PER_EPOCH,
                               device="cpu")
    state = f64_train_state(trainer, leg["variables"])

    def batch_of(i):
        return as_float64(make_frame_batch(
            i % pw.DISTINCT_BATCHES, cfg.obj, batch=args.batch,
            num_points=cfg.num_points))

    def draws_of(i, batch):
        return _jax_draws(cfg, leg["keys"][i], batch["labels"])
    return cfg, pw.train(trainer, state, args.steps, batch_of, draws_of, pwm)


def test_pwm_legs_match_the_script_in_float64(jax_pwm):
    """Each leg's config equals the script's; three float64 steps from the
    same variables with the draws of the script's keys: every step's total
    loss, the last printed losses and metrics and every trained leaf."""
    args = pw.parse(PWM_ARGV)
    legs = jax_pwm["legs"]
    assert len(legs) == len(pw.pwm_values(args))
    for pwm, leg in zip(pw.pwm_values(args), legs):
        assert len(leg["keys"]) == args.steps
        _, (cfg, (state, last, totals)) = _printed(_port_pwm_leg, args,
                                                    pwm, leg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(leg["cfg"])
        for i, want in enumerate(leg["losses"]):
            assert_close(float(totals[i]), want["total_loss"], LOSS_TOL,
                         (pwm, i))
        assert sorted(last) == sorted(leg["losses"][-1])
        for k, v in leg["losses"][-1].items():
            assert_close(last[k], v, LOSS_TOL, (pwm, k))
        assert_leaves(flax_variables(state.module), leg["final64"], pwm)


def test_pwm_refuses_a_category_that_is_not_symmetric():
    with pytest.raises(ValueError, match="sym category"):
        pw.config(pw.parse(["--category", "3"]), 128)


def test_pwm_prints_the_scripts_lines(jax_pwm):
    """The CLI's printed lines are the script's, number for number
    placeholder (plus its ms-a-step line); its JSON has the script's keys
    and its return value is that JSON."""
    text, results = _printed(pw.main, PWM_ARGV, device="cpu")
    port_only = re.compile(r"ms a step on ")
    assert skeleton(text, port_only) == skeleton(jax_pwm["text"], port_only)
    assert len(port_only.findall(text)) == len(jax_pwm["legs"])
    got = json.loads(text[text.index("\n{") + 1:])
    want = json.loads(jax_pwm["text"][jax_pwm["text"].index("\n{") + 1:])
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(v) for k, v in want.items()}
    assert json.loads(json.dumps(results)) == got


# ---------------------------------------------------------------------------
# the train-and-track smoke
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_smoke():
    legs, track_cfgs, rows = [], [], []

    def make_track_step(cfg, *args, **kwargs):
        track_cfgs.append(cfg)
        return real_step(cfg, *args, **kwargs)

    def evaluate_track(pred, gt, sym):
        errs = real_eval(pred, gt, sym)
        rows.append({k: float(jnp.mean(v)) for k, v in errs.items()})
        return errs

    real_step, real_eval = jtracker.make_track_step, jtracker.evaluate_track
    text, raised = _run_script("smoke_train_track", SMOKE_ARGV, [
        (jtrainer, "Trainer", f64_trainer(
            legs, lambda cfg: sm.configs(N)[cfg.network.type], sgd=True)),
        (jtracker, "make_track_step", make_track_step),
        (jtracker, "evaluate_track", evaluate_track)])
    return {"legs": dict(zip(sm.NETS, legs)), "track_cfgs": track_cfgs,
            "rows": dict(zip(sm.ROWS, rows)), "text": text,
            "gate_failed": raised is not None}


def test_smoke_configs_are_the_scripts(jax_smoke):
    """The configs built in code equal the script's, field by field: both
    trained nets' and the tracker's."""
    cfgs = sm.configs(N)
    want = {net: leg["cfg"] for net, leg in jax_smoke["legs"].items()}
    assert len(jax_smoke["track_cfgs"]) == 2
    want[sm.TRACK_NET] = jax_smoke["track_cfgs"][0]
    assert sorted(cfgs) == sorted(want)
    for net, cfg in cfgs.items():
        for f in dataclasses.fields(tschema.Config):
            got, exp = getattr(cfg, f.name), getattr(want[net], f.name)
            if dataclasses.is_dataclass(got):
                got, exp = dataclasses.asdict(got), dataclasses.asdict(exp)
            assert got == exp, (net, f.name)


@pytest.mark.parametrize("net", sm.NETS)
def test_smoke_training_matches_the_script_in_float64(jax_smoke, net):
    """Three float64 steps of each net (with SGD, `with_sgd`) from the
    script's (perturbed) variables with the draws of its keys: every
    step's losses and metrics, and every trained leaf."""
    leg = jax_smoke["legs"][net]
    cfg = with_sgd(sm.configs(N)[net])
    trainer = ttrainer.Trainer(cfg, steps_per_epoch=sm.STEPS_PER_EPOCH,
                               device="cpu")
    state = f64_train_state(trainer, leg["variables"])

    def batch_of(i):
        return as_float64(make_frame_batch(
            i % sm.DISTINCT_BATCHES, cfg.obj, batch=sm.BATCH, num_points=N))

    def draws_of(i, batch):
        return _jax_draws(cfg, leg["keys"][i], batch["labels"])
    _, (state, log) = _printed(sm.train, trainer, state, net, 3, batch_of,
                               draws_of)
    assert len(log) == len(leg["losses"]) == 3
    for i, (got, want) in enumerate(zip(log, leg["losses"])):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert_close(float(got[k]), v, LOSS_TOL, (net, i, k))
    assert_leaves(flax_variables(state.module), leg["final64"], net)


def test_smoke_rows_match_the_script_on_its_nets(jax_smoke):
    """The trained, untrained and frozen-init rows of the port's tracking
    on the script's float32 variables (the trained nets rounded from its
    float64 steps), against the script's unrounded means; the gate
    decides as the script's did."""
    cfg = sm.configs(N)[sm.TRACK_NET]
    data = sm.track_data(cfg, N)
    gt = data["pose"]
    legs = jax_smoke["legs"]
    variables = {
        "trained": {net: to_numpy(leg["final64"])
                    for net, leg in legs.items()},
        "untrained": {net: leg["variables"] for net, leg in legs.items()}}
    rows = {}
    for name, v in variables.items():
        coord = coordnet_from_flax(cfg, v["canon_coord"], device="cpu")
        rotn = rotnet_from_flax(cfg, v["rot"], device="cpu")
        rows[name] = quality.track_means(cfg, coord, rotn, gt[0],
                                         data["points"], gt, "cpu")[1]
    rows["frozen-init"] = quality.frozen_init(gt, sym=False)
    for name in sm.ROWS:
        assert_means(rows[name], jax_smoke["rows"][name], name)
    report = {**rows}
    if jax_smoke["gate_failed"]:
        with pytest.raises(SystemExit, match="did not help tdiff"):
            sm.check(report)
    else:
        _printed(sm.check, report)


def test_smoke_prints_the_scripts_lines(jax_smoke):
    """`main(--cpu)` prints the script's lines (plus the device line) and
    returns the rows it printed; its gate exits with an error where the
    trained tdiff is not below the frozen init's, as the script's assert
    does."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            report = sm.main([*SMOKE_ARGV, "--cpu"])
        except SystemExit as e:
            report = None
            assert "did not help tdiff" in str(e)
    text = buf.getvalue()
    # the gate's line prints where the gate passes (the port's draws are
    # not the script's, so either run may pass)
    port_only = re.compile(r"^\(on cpu\)$|^OK: ")
    assert skeleton(text, port_only) == skeleton(jax_smoke["text"],
                                                 port_only)
    if report is not None:
        assert text.splitlines()[-1] == (
            "OK: trained tracker beats the frozen-init baseline")
        assert report["device"] == "cpu"
        assert sorted(report["train"]) == sorted(sm.NETS)
        printed = text.splitlines()[-len(sm.ROWS) - 2:-2]
        assert text.splitlines()[-2] == "(on cpu)"
        for name, line in zip(sm.ROWS, printed):
            assert line.startswith(f"{name:12s} rdiff=")
            assert f"tdiff={report[name]['tdiff']:.4f}" in line


def test_smoke_untrained_nets_are_copies_not_views():
    """`train_net` keeps the draw as a copy: training moves the trained
    state's parameters and leaves the untrained state's as drawn."""
    cfg = sm.configs(N)["canon_coord"]
    _, leg = _printed(sm.train_net, cfg, 1, torch.device("cpu"))
    fresh = ttrainer.Trainer(cfg, device="cpu").init_state(
        generator=torch.Generator().manual_seed(sm.INIT_SEED))
    assert torch.equal(leg["untrained"].params, fresh.params)
    assert not torch.equal(leg["trained"].params, fresh.params)


# ---------------------------------------------------------------------------
# the init-search scorer diagnosis
# ---------------------------------------------------------------------------

class _RecordingNumpy(types.SimpleNamespace):
    """numpy for the diag script's module: records what its table prints
    rounded (every `nanmean`, in print order) and the candidate and
    perturbation rotations it composes."""

    def __getattr__(self, name):
        return getattr(np, name)

    def nanmean(self, a, *args, **kwargs):
        value = np.nanmean(a, *args, **kwargs)
        self.means.append(float(value))
        return value

    def einsum(self, subscripts, *operands, **kwargs):
        if subscripts == "jac,bkpcd->bkjpad":
            self.perts, self.cand_R = (np.array(x) for x in operands)
        return np.einsum(subscripts, *operands, **kwargs)


@pytest.fixture(scope="module")
def jax_diag(tmp_path_factory):
    """A CoordNet checkpoint written by the JAX package's writer and the
    JAX script's run on it: {"coord" (path), "text", "means" [K, 5],
    "cand_R", "perts", "picks"}."""
    root = tmp_path_factory.mktemp("diag_ckpt")
    cfg = ttiny("config_track.yml", {**BOTTLE, "network/norm": "bn"})
    cv = perturb(flax_variables(CoordNet(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))),
        np.random.RandomState(1))
    cv["params"]["nocs_head"]["dense_1"]["kernel"] *= np.float32(NOCS_GAIN)
    cv["params"]["seg_head"]["dense_0"]["bias"][:1] += np.float32(SEG_BIAS)
    state = types.SimpleNamespace(
        params=cv["params"], batch_stats=cv["batch_stats"],
        opt_state=optax.adam(1e-3).init(cv["params"]), step=0)
    coord = jckpt.save_checkpoint(str(root / "coord" / "ckpt"), 0, state)
    script = _script("init_search_scorer_diag")
    rec = _RecordingNumpy(means=[])
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["init_search_scorer_diag.py", "--coord",
                                 coord, "--rot", "unused", *DIAG_ARGV])
        mp.setattr(jconfig, "get_config", jtiny)
        mp.setattr(script, "np", rec)
        with contextlib.redirect_stdout(buf):
            script.main()
    text = buf.getvalue()
    picks = {}
    for m in re.finditer(r"argmin\[ *(\S+)\] chooses offsets: (\[.*?\])",
                         text):
        picks[m.group(1)] = ast.literal_eval(m.group(2))
    return {"coord": coord, "text": text, "cand_R": rec.cand_R,
            "perts": rec.perts, "picks": picks,
            "means": np.array(rec.means).reshape(-1, len(dg.COLUMNS))}


def test_axis_angle_is_the_scripts_bit_for_bit():
    script = _script("init_search_scorer_diag")
    a, b = np.random.RandomState(11), np.random.RandomState(11)
    for theta in (0.0, 10.0, 12.0, 90.0, 180.0, 33.3):
        want = script._axis_angle(a, theta)
        got = dg.axis_angle(b, theta)
        assert got.dtype == want.dtype and np.array_equal(got, want), theta


def test_diag_candidates_are_the_scripts_bit_for_bit(jax_diag):
    """The candidate and perturbation rotations at RandomState(11), drawn
    in the script's order, against the ones its run composed."""
    args = dg.parse(["--coord", "c", "--rot", "r", *DIAG_ARGV])
    cfg = dg.config(args)
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    base = batch_trajectories([
        make_trajectory(seed=dg.TRAJ_SEED_BASE + s, obj=cfg.obj,
                        num_frames=dg.TRAJ_FRAMES, num_points=N)
        for s in range(args.trajs)])
    offsets = [float(x) for x in args.offsets.split(",")]
    cand_R, perts = dg.draw_candidates(
        base["pose"][0].rotation.numpy(), offsets, args.perturb_j,
        args.perturb_deg, np.random.RandomState(dg.DRAW_SEED))
    for got, want in ((cand_R, jax_diag["cand_R"]),
                      (perts, jax_diag["perts"])):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("chunk", [ttracker.INIT_SEARCH_CHUNK, 7])
def test_diag_table_and_picks_match_the_script(jax_diag, monkeypatch,
                                               chunk):
    """The port's CLI on the JAX-written checkpoint: each row's means
    (angles within 5e-4 degrees, the residual within 1e-5 relative) and
    every scorer's picks equal the script's; with CoordNet's chunk of 128
    clouds (one chunk here) and of 7 (four, the last short)."""
    monkeypatch.setattr(ttracker, "INIT_SEARCH_CHUNK", chunk)
    text, report = _printed(dg.main, ["--coord", jax_diag["coord"],
                                      "--rot", "unused", *DIAG_ARGV],
                            device="cpu")
    want = jax_diag["means"]
    assert [r["offset"] for r in report["rows"]] == [0.0, 30.0, 90.0, 180.0]
    assert want.shape == (len(report["rows"]), len(dg.COLUMNS))
    for row, w in zip(report["rows"], want):
        for c, v in zip(dg.COLUMNS, w):
            if c == "resid":
                assert abs(row[c] - v) <= TOL * abs(v), (row["offset"], c)
            else:
                assert abs(row[c] - v) <= ANGLE_TOL, (row["offset"], c,
                                                      row[c], v)
    assert report["picks"] == jax_diag["picks"]
    assert report["fitted"].shape == (8, 4, 3, 3, 3)
    port_only = re.compile(r" candidates on cpu\)$")
    assert skeleton(text, port_only) == skeleton(jax_diag["text"], port_only)


def test_diag_refuses_a_mismatched_norm(jax_diag):
    with pytest.raises(ValueError, match="norm=bn.*norm=gn"):
        dg.main(["--coord", jax_diag["coord"], "--rot", "unused"],
                device="cpu")
