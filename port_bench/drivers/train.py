"""The training driver: the port's CoordNet training step
(`captra_tpu_torch.training.trainer.Trainer.train_step`) at the
configuration's batch, on batches drawn from a seeded pool of synthetic
samples on the card.

Set-up builds the trainer and its state from the benchmark's weights and
drives that same state through its first FIRST_STEPS steps, on rows that
all differ, through the window's own call and feed; the window then goes
on training it for --seconds.  Every step's batch rows and the symmetric
NPCS loss's point pairs are drawn on the card from the seed, so a step
synchronises nothing; the window ends with the card drained.

The comparison, once the window has closed and the program is freed: the
reference follows the first FIRST_STEPS steps from the same weights on the
same batches and holds the first step's loss, the first gradient as the
optimizer took it (the program's, worked out from its Adam moment after
one step) and each leaf's change over the FIRST_STEPS steps, by the worst
leaf (the later steps' losses are logged beside them).
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from port_bench import counts, trace, traffic, weights
from port_bench.drivers.track import port_config, quiet_collector, sync
from port_bench.harness import Outcome, derive_seed, reference

FIRST_STEPS = 3
TRACE_STEPS = 8
STEPS_PER_EPOCH = 50          # the synthetic epoch of the train CLI
LEARNABLE = ("linear_w", "linear_b", "bn_w", "bn_b", "gn_w", "gn_b")
# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def train_port_config(cfg: dict):
    """The port's `Config` of the configuration file's training section."""
    import dataclasses

    from captra_tpu_torch.config.schema import OptimCfg, frozen_map
    base = port_config(cfg, {})
    t = cfg["train"]
    optim = OptimCfg(optimizer=t["optimizer"], learning_rate=t[
        "learning_rate"], weight_decay=t["weight_decay"], lr_policy="step",
        lr_gamma=t["lr_gamma"], lr_step_size=t["lr_step_size"],
        lr_clip=t["lr_clip"], grad_clip=t["grad_clip"],
        batch_size=t["batch_size"])
    return base.replace(
        network=dataclasses.replace(base.network, type="canon_coord"),
        optim=optim, batch_size=t["batch_size"],
        loss_weight=frozen_map(t["loss_weight"]))


class PortProgram:
    """The system under test: the port's trainer and its state."""

    def __init__(self, pcfg, device, w: dict, bench: dict):
        from captra_tpu_torch.training.trainer import B1, Trainer
        self.b1 = B1
        self.trainer = Trainer(pcfg, steps_per_epoch=STEPS_PER_EPOCH,
                               device=device)
        self.state = self.trainer.init_state(
            generator=torch.Generator().manual_seed(0))
        self.state.module.load_state_dict(w)

    def step(self, batch: dict, draws: dict):
        """One step on a pool batch; returns its total loss (a tensor on
        the device)."""
        _, loss, _ = self.trainer.train_step(self.state, program_batch(batch),
                                             draws=draws)
        return loss["total_loss"]

    def first_grad(self) -> dict:
        """The gradient the optimizer took at its first step, by leaf:
        its first Adam moment over (1 - b1)."""
        mu = self.state.param_views(self.state.opt_state["mu"])
        return {k: v / (1.0 - self.b1) for k, v in mu.items()}

    def params_now(self) -> dict:
        return self.state.param_views(self.state.params)


class Feed:
    """Batches drawn on the card from the pool: the first FIRST_STEPS
    batches' rows all differ, then rows are drawn uniformly."""

    def __init__(self, pool: dict, batch: int, pwm_num: int, seed: int,
                 device):
        self.pool, self.B, self.pwm_num = pool, batch, pwm_num
        self.N = pool["points"].shape[1]
        self.g = torch.Generator(device=device)
        self.g.manual_seed(derive_seed(seed, "feed"))
        G = pool["points"].shape[0]
        if G < FIRST_STEPS * batch:
            raise ValueError(f"a pool of {G} cannot give {FIRST_STEPS} "
                             f"batches of {batch} distinct rows")
        self.first = torch.randperm(G, generator=self.g,
                                    device=device)[:FIRST_STEPS * batch]
        self.taken = 0

    def next(self):
        if self.taken < FIRST_STEPS:
            rows = self.first[self.taken * self.B:(self.taken + 1) * self.B]
        else:
            rows = torch.randint(0, self.pool["points"].shape[0], (self.B,),
                                 generator=self.g, device=self.g.device)
        self.taken += 1
        batch = {k: v.index_select(0, rows) for k, v in self.pool.items()}
        pwm = torch.randint(0, self.N, (self.B, self.pwm_num),
                            generator=self.g, device=self.g.device)
        return batch, pwm


def program_batch(batch: dict) -> dict:
    """A pool batch as the port's trainer takes it: poses as `Pose`s."""
    from captra_tpu_torch.pose.part_dof import Pose
    pose = ("rotation", "translation", "scale")
    return {"points": batch["points"], "labels": batch["labels"],
            "nocs": batch["nocs"], "corners": batch["corners"],
            "pose": Pose(*(batch[k] for k in pose)),
            "init_pose": Pose(*(batch[f"init_{k}"] for k in pose))}


def _leaf_gap(got: dict, want: dict, keys) -> float:
    """max over the leaves `keys` of |‖got‖ - ‖want‖| / max(‖want‖, the
    median leaf's ‖want‖)."""
    norms = {k: float(torch.linalg.norm(want[k].double())) for k in keys}
    med = statistics.median(norms.values())
    worst = 0.0
    for k in keys:
        g = float(torch.linalg.norm(got[k].double()))
        gap = abs(g - norms[k]) / max(norms[k], med)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def compare(ref_train, cfg: dict, w0: dict, learnable: list, record: dict,
            matmul: str = "float32") -> dict:
    """The reference's first steps against the program's record."""
    want = ref_train.follow(w0, cfg, record["batches"], record["pwm"],
                            learnable, STEPS_PER_EPOCH, matmul)
    gaps = [abs(a - b) / abs(b) if b else math.inf
            for a, b in zip(record["losses"], want["losses"])]
    # the later steps' losses part by Adam's +-lr on float-noise gradients
    # (see PERF.md): the first step's loss is compared, the others logged
    loss_gap = gaps[0]
    grad_gap = _leaf_gap(record["grad"], want["grad"], learnable)
    gnorm = {k: float(torch.linalg.norm(want["grad"][k])) for k in learnable}
    med = statistics.median(gnorm.values())
    moving = [k for k in learnable if gnorm[k] >= STILL_LEAF * med]
    got_change = {k: record["params"][k] - w0[k] for k in moving}
    want_change = {k: want["params"][k] - w0[k] for k in moving}
    change_gap = _leaf_gap(got_change, want_change, moving)
    return {"loss_gap": loss_gap if math.isfinite(loss_gap) else math.inf,
            "grad_gap": grad_gap, "change_gap": change_gap}, gaps


def run(ctx, make_program=PortProgram) -> Outcome:
    dev = ctx.device
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = ctx.cell
    cfg = cell.config
    ref = reference(cfg["reference"])
    ref_train = reference(cfg["train"]["reference"])
    spec = ref.weight_spec(cfg)
    w0 = weights.make({"coord": spec["coord"]}, cfg, ctx.seed, dev,
                      tame=False)["coord"]
    learnable = [n for n, _, k in spec["coord"] if k in LEARNABLE]
    pool = traffic.train_pool(cell.traffic, cfg, ctx.seed, dev)
    B = cfg["train"]["batch_size"]
    feed = Feed(pool, B, cfg["network"]["pwm_num"], ctx.seed, dev)
    pcfg = train_port_config(cfg)
    program = make_program(pcfg, dev, w0, {"cfg": cfg, "ref": ref,
                                           "ref_train": ref_train,
                                           "learnable": learnable})

    # the first steps, through the window's own call and feed
    record = {"batches": [], "pwm": [], "losses": []}
    for i in range(FIRST_STEPS):
        batch, pwm = feed.next()
        record["batches"].append(batch)
        record["pwm"].append(pwm)
        record["losses"].append(program.step(batch, {"pwm_idx": pwm}))
        if i == 0:
            record["grad"] = {k: v.clone()
                              for k, v in program.first_grad().items()}
    record["params"] = {k: v.clone()
                        for k, v in program.params_now().items()}
    sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    quiet_collector()
    setup_s = ctx.clock.since_start()

    steps = 0
    start = time.perf_counter()
    deadline = start + ctx.seconds
    while time.perf_counter() < deadline:
        batch, pwm = feed.next()
        program.step(batch, {"pwm_idx": pwm})
        steps += 1
    sync(dev)
    window_s = time.perf_counter() - start

    summary = None
    if ctx.trace:
        def one():
            batch, pwm = feed.next()
            with torch.profiler.record_function("bench.step"):
                program.step(batch, {"pwm_idx": pwm})
            with torch.profiler.record_function("bench.sync"):
                sync(dev)
        events = trace.profile(one, TRACE_STEPS, cuda)
        summary = trace.summarize(events, TRACE_STEPS)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    record["losses"] = [float(v) for v in record["losses"]]
    failed = sum(not math.isfinite(v) for v in record["losses"])
    del program, feed
    if cuda:
        torch.cuda.empty_cache()
    checks, loss_gaps = compare(ref_train, cfg, w0, learnable, record)
    ctx.log(f"each first step's loss against the reference's: {loss_gaps}")
    flops = 3 * B * counts.coordnet_flops(cfg)
    ctx.log(f"window: {steps} steps of {B} samples in {window_s:.4f} s, "
            f"{1e3 * window_s / max(steps, 1):.4f} ms a step, "
            f"{flops / 1e9:.2f} GFLOP a step; first losses "
            f"{record['losses']}")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
    run_ = TrainRun(steps, window_s, flops, summary)
    return Outcome(attempted=steps + FIRST_STEPS, failed=failed,
                   values={"setup_s": setup_s,
                           "train_samples_per_s": B * steps / window_s},
                   checks=checks, device=device, run=run_,
                   breakdown=trace.breakdown(summary) if summary else None)


class TrainRun:
    """What the per-layer readers read of a training run."""

    def __init__(self, steps, seconds, flops_per_step, summary):
        self.steps = steps
        self.seconds = seconds
        self.flops_per_step = flops_per_step
        self.trace = summary
