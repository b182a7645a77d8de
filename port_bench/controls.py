"""Steps that stand in for the program's, to show that the comparison
fails what it must fail.  The benchmark's own runs never use them; the
calibration tool (`calibrate.py`) and the tests drive a cell with them.

  control     the plain reference in the program's place, its matrix
              products in TF32 (the precision below the configuration's
              float32 with TF32 off)
  unchanged   the program's step returning the carried pose unchanged
  half        the program's step with the second half of the streams' answers
              replaced by the first half's (half of the batch left out)
  altered     the program's step with one stream's translation moved by a
              millimetre where it is produced

Each is a `make_step` for `drivers.track.run`; TRAIN_PROGRAMS are the
same four for `drivers.train.run` (the altered answer: a slice of the
parameters moved by 1e-2 after each step).
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from port_bench.drivers.track import POSE, port_step


def control(pcfg, coord_fn, rot_fn, device, bench):
    from captra_tpu_torch.pose.part_dof import Pose
    ref, cfg, w = bench["ref"], bench["cfg"], bench["w"]
    pr = ref.Precision("tf32")

    @torch.no_grad()
    def step(pose, frame):
        carried = {k: getattr(pose, k) for k in POSE}
        if "depth" in frame:
            out, seg, nocs = ref.track_depth(pr, w["coord"], w["rot"], cfg,
                                             carried, frame["depth"],
                                             frame["shift"])
        else:
            out, seg, nocs = ref.track_points(pr, w["coord"], w["rot"], cfg,
                                              carried, frame["points"])
        return Pose(*(out[k] for k in POSE)), SimpleNamespace(seg=seg,
                                                               nocs=nocs)
    return step


def _wrapped(change):
    def make(pcfg, coord_fn, rot_fn, device, bench):
        real = port_step(pcfg, coord_fn, rot_fn, device, bench)

        def step(pose, frame):
            new, aux = real(pose, frame)
            return change(pose, new, aux)
        return step
    return make


def _unchanged(pose, new, aux):
    return pose, aux


def _half(pose, new, aux):
    from captra_tpu_torch.pose.part_dof import Pose

    def fold(x):
        B = x.shape[0]
        h = B // 2
        return torch.cat([x[:B - h], x[:h]], 0)
    return (Pose(*(fold(getattr(new, k)) for k in POSE)),
            SimpleNamespace(seg=fold(aux.seg), nocs=fold(aux.nocs)))


def _altered(pose, new, aux):
    from captra_tpu_torch.pose.part_dof import Pose
    t = new.translation.clone()
    t[0] = t[0] + 1e-3
    return Pose(new.rotation, t, new.scale), aux


STEPS = {"control": control, "unchanged": _wrapped(_unchanged),
         "half": _wrapped(_half), "altered": _wrapped(_altered)}


# ---------------------------------------------------------------------------
# training: programs that stand in for the port's trainer
# ---------------------------------------------------------------------------

class ReferenceProgram:
    """The training control: the plain reference's steps in the program's
    place, its products in TF32."""

    def __init__(self, pcfg, device, w: dict, bench: dict,
                 matmul: str = "tf32"):
        from port_bench.drivers.train import STEPS_PER_EPOCH
        self.rt = bench["ref_train"]
        self.cfg = bench["cfg"]
        self.pr = bench["ref"].Precision(matmul, train=True)
        self.w = {k: v.detach().clone() for k, v in w.items()}
        self.learnable = bench["learnable"]
        self.params = {k: self.w[k] for k in self.learnable}
        self.opt = self.rt.Adam(self.params, self.cfg["train"],
                                STEPS_PER_EPOCH)
        self.first = None

    def step(self, batch: dict, draws: dict):
        for k in self.learnable:
            self.params[k].requires_grad_(True)
        total = self.rt.loss(self.pr, self.w, self.cfg, batch,
                             draws["pwm_idx"])
        grads = torch.autograd.grad(total, [self.params[k]
                                            for k in self.learnable])
        for k in self.learnable:
            self.params[k].requires_grad_(False)
        g = self.opt.step(dict(zip(self.learnable, grads)), self.params)
        if self.first is None:
            self.first = g
        return total.detach()

    def first_grad(self) -> dict:
        return self.first

    def params_now(self) -> dict:
        return self.params


def _port_program(change):
    from port_bench.drivers.train import PortProgram

    class Faulty(PortProgram):
        def step(self, batch, draws):
            return change(self, batch, draws)
    return Faulty


def _train_unchanged(prog, batch, draws):
    from port_bench.drivers.train import PortProgram
    params = prog.state.params.clone()
    opt = dict(prog.state.opt_state)
    loss = PortProgram.step(prog, batch, draws)
    prog.state.params.copy_(params)
    prog.state.opt_state = opt
    return loss


def _train_half(prog, batch, draws):
    from port_bench.drivers.train import PortProgram
    h = batch["points"].shape[0] // 2
    return PortProgram.step(prog, {k: v[:h] for k, v in batch.items()},
                            {k: v[:h] for k, v in draws.items()})


def _train_altered(prog, batch, draws):
    from port_bench.drivers.train import PortProgram
    loss = PortProgram.step(prog, batch, draws)
    with torch.no_grad():
        prog.state.params[:64] += 1e-2
    return loss


TRAIN_PROGRAMS = {"control": ReferenceProgram,
                  "unchanged": _port_program(_train_unchanged),
                  "half": _port_program(_train_half),
                  "altered": _port_program(_train_altered)}
