"""The transfer-function fitting job: recover a TF from one image of the
volume under another, as the upstream example's backward task does.

A fit takes its pose (drawn in set-up), renders its target once through
the inference path (``render_nondiff`` at ``fw_sampling_rate`` under the
target TF), resets the TF to black in place and makes a fresh
``tf_momentum``.  Each step renders the view through ``render`` (K1, and in
the backward K2 for the TF alone) at ``bw_sampling_rate``, takes
``mse_loss`` against the target, runs the backward, steps the optimizer and
projects the TF onto ``max(., 0)``.  After ``iterations`` steps the next
fit starts.

Set-up runs the first fit's target and its first ``CHECKED`` steps, which
the reference follows after the window, then the fit on to its late step
(two thirds in, where the TF has gone sparse), whose TF and ``d_tf`` it
keeps for the reference, then ``WARM`` more; the window runs steps on,
restarts included.  The traced run is one whole fit from a
restart, one unit a step.
"""
from __future__ import annotations

import contextlib
import math
import time

import torch

from .. import faults, inputs, work, work_tf
from ..inputs import transfer_function
from ..reference import tffit

END_TO_END = ("step_ms",)
CHECKED = 3
WARM = 2
POSES = 64           # the fits' poses drawn in set-up, taken in turn
WORK_EVERY = 20      # the traced fit's steps whose K2 work is counted
BLACK = 1e-2         # the upstream "black" TF: 1e-2 in every channel

# The faults a TF-fitting cell can have.
FAULTS = {"state_unchanged": faults.tf_state_unchanged,
          "top_half_loss": faults.top_half_loss}
# The cells on the CPU in seconds: 16^3, 12^2, 16 texels, fits of 4 steps.
SMALL = {"volume": [16, 16, 16], "image": [12, 12], "tf_resolution": 16,
         "iterations": 4}


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import differender_tpu_torch as P
        self.P, self.cfg, self.dev = P, cfg, torch.device(device)
        self.sync = inputs.syncer(self.dev)
        D, Hv, Wv = cfg["volume"]
        if not D == Hv == Wv:
            raise ValueError("the scenes are cubes")
        if cfg["init_tf"] != "black" or cfg["bw_jitter"]:
            raise ValueError("the fit starts from the black TF, unjittered")
        if cfg["iterations"] < CHECKED:
            raise ValueError(f"the checked steps lie in one fit of at least "
                             f"{CHECKED} iterations")
        gen = inputs.generator(seed, 0, self.dev)
        self.vol_user = inputs.volume(traffic, D, gen)
        R = cfg["tf_resolution"]
        self.tf_target = transfer_function(cfg["target_tf"], R, self.dev)
        self.tf0 = torch.full((4, R), BLACK, dtype=torch.float32,
                              device=self.dev)
        angles = torch.rand(POSES, generator=inputs.generator(seed, 1,
                                                              self.dev),
                            device=self.dev) * (2.0 * math.pi)
        self.poses = inputs.orbit(angles, cfg["orbit_y"], cfg["orbit_dist"],
                                  self.dev)
        self.vol = P.volume_to_internal(self.vol_user).contiguous()
        self.tf_target_int = self.tf_target.t().contiguous()
        self.tf = self.tf0.t().contiguous().requires_grad_(True)
        self.rcfg = P.RenderConfig(
            volume_shape=tuple(self.vol.shape),
            image_shape=tuple(cfg["image"]), tf_resolution=R,
            max_samples=cfg["max_samples"],
            **{k: cfg[k] for k in ("fov", "near", "ambient", "diffuse",
                                   "specular", "shininess", "ert_threshold",
                                   "alpha_skip", "normal_delta")})
        self.late = (2 * cfg["iterations"]) // 3   # a step of the first fit
        self.k = 0
        self.fit = -1
        self.bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.outputs = None     # the checked steps' images and target

    def restart(self):
        """The next fit: its pose and target, the TF black again, a fresh
        optimizer."""
        c, P = self.cfg, self.P
        self.fit += 1
        self.look_from = self.poses[self.fit % POSES]
        with torch.no_grad():
            self.target = P.render_nondiff(
                self.vol, self.tf_target_int, self.look_from, self.rcfg,
                sampling_rate=c["fw_sampling_rate"]).image
            self.tf.fill_(BLACK)
        self.opt = P.tf_momentum([self.tf], lr=c["lr"], gamma=c["mom"],
                                 max_grad=c["clip_grads"],
                                 lr_decay=c["lr_decay"])

    def step(self, span=None, keep_tf=None):
        """One step of the fit, after its restart where one is due;
        ``keep_tf`` (a list) receives the TF that the step renders with."""
        span = span or _no_span
        P = self.P
        if self.k % self.cfg["iterations"] == 0:
            with span("restart"):
                self.restart()
        if keep_tf is not None:
            keep_tf.append(self.tf.detach().clone())
        with span("render"):
            img = P.render(self.vol, self.tf, self.look_from, self.rcfg,
                           self.cfg["bw_sampling_rate"]).image
        with span("loss"):
            loss = P.mse_loss(img, self.target)
        if self.outputs is not None:
            self.outputs.append((img.detach().clone(), self.target.clone()))
        with span("backward"):
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        with span("optim"):
            self.opt.step()
            P.project_nonneg(self.tf)
        self.k += 1
        loss = loss.detach()
        self.bad += (~torch.isfinite(loss)).to(torch.int64)
        return loss

    # -- set-up, window, trace ---------------------------------------------

    def setup(self):
        """The first fit's checked steps and its late step, recorded for the
        reference, then warm-up."""
        self.outputs = []
        late_tf = []
        for i in range(max(CHECKED, self.late + 1)):
            self.step(keep_tf=late_tf if i == self.late else None)
            if i == 0:
                self.grad1 = self.tf.grad.detach().clone()
            if i == CHECKED - 1:
                self.tf_checked = self.tf.detach().clone()
                self.checked_outputs, self.outputs = self.outputs, None
            if i == self.late:
                self.late_tf = late_tf[0]
                self.late_grad = self.tf.grad.detach().clone()
        for _ in range(WARM):
            self.step()
        self.sync()

    def window(self, seconds: float) -> dict:
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        self.sync()
        t = time.perf_counter() - t0
        self.attempted, self.failed = n, int(self.bad)
        return {"step_ms": t / n * 1e3}

    def traced(self, trace_path: str):
        from .. import tracing
        n = self.cfg["iterations"]
        self.k = 0              # the traced fit starts with a restart
        self.work_tfs = []

        def unit(i):
            with tracing.annotate("step"):
                self.step(span=_annotated,
                          keep_tf=self.work_tfs if i % WORK_EVERY == 0
                          else None)
        tr = tracing.profile_units(unit, n, self.sync, trace_path)
        self.attempted, self.failed = n, int(self.bad)
        self.trace = tr
        return tr

    def count_work(self):
        """K2's work at the traced fit's steps 0, WORK_EVERY, ... (after the
        window, the program's state freed)."""
        least = sum(work.least_seconds(*work_tf.k2_tf_launch_work(
            self.vol_user, tf.t(), self.look_from,
            self.cfg["bw_sampling_rate"], self.cfg))
            for tf in self.work_tfs)
        self.trace.work["k2_tf"] = {
            "steps": list(range(0, self.cfg["iterations"], WORK_EVERY)),
            "least_s": least}
        del self.work_tfs

    # -- correctness ---------------------------------------------------------

    def release(self):
        """Frees the program's state; keeps what the check reads."""
        self.program = {"losses": [tffit.mse64(img, tgt) for img, tgt
                                   in self.checked_outputs],
                        "grad1": self.grad1, "tf": self.tf_checked,
                        "late_tf": self.late_tf, "late_grad": self.late_grad}
        del self.opt, self.tf, self.target
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, store=None) -> dict:
        return tffit.fit_steps(self.vol_user, self.tf_target, self.tf0,
                               self.poses[0], self.cfg, CHECKED, store=store,
                               late_tf=self.program["late_tf"])

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers the check compares, each over the reference's norm:
        the largest gap of the checked steps' losses (in float64 from the
        image and the target each step rendered), the gap of the first
        ``d_tf`` (the whole R x 4 vector), that of the TF's change over
        the checked steps, and the gap of the late step's ``d_tf`` (the
        reference's taken at the TF the program had there)."""
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], want["losses"]))
        tf0 = self.tf0.t()
        return {"loss_gap": loss_gap,
                "grad_gap": _rel(got["grad1"], want["grad1"]),
                "change_gap": _rel(got["tf"] - tf0, want["tf"] - tf0),
                "late_grad_gap": _rel(got["late_grad"], want["late_grad"])}


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((x - ref).double())
                 / torch.linalg.vector_norm(ref.double()))


def _no_span(name):
    return contextlib.nullcontext()


def _annotated(name):
    from .. import tracing
    return tracing.annotate(name)
