"""The volume-fitting job: recover a corrupted volume from views of the
clean one.  A step renders the ground truth of its views with the inference
path from the clean volume, renders the same views of the fitted volume
through ``Raycaster.forward``, takes ``dssim_mse_loss`` over the batch in
one graph, steps AdamW under its one-cycle schedule and clamps the volume.

Set-up builds the one training state and drives it through its first
``CHECKED`` steps, which the reference follows after the window, and then
``WARM`` more; the window runs the same ``step`` on fresh poses and jitter.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .. import faults, inputs, work
from ..reference import fit

END_TO_END = ("step_ms",)
# The faults a fitting cell can have.
FAULTS = {"state_unchanged": faults.state_unchanged,
          "half_batch": faults.half_batch}
# The cells on the CPU in seconds: 16^3, two views of 16^2.
SMALL = {"volume": [16, 16, 16], "image": [16, 16], "views": 2,
         "gt_sampling_rate": 2.0}
# A fault's run is held to the sound run's reference of its seed: the
# reference follows the poses and jitter that set-up drew, which no fault
# changes.
FAULTS_SHARE_REFERENCE = True
CHECKED = 3
WARM = 2
TRACED = 12          # steps under the profiler
WORK_STEPS = 4       # of which K2's roofline reads the first
SPAN_STEPS = 8       # steps with synced spans, after the profiler


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import differender_tpu_torch as P
        self.P, self.cfg, self.dev = P, cfg, torch.device(device)
        self.sync = inputs.syncer(self.dev)
        D, Hv, Wv = cfg["volume"]
        if not D == Hv == Wv:
            raise ValueError("the scenes are cubes")
        gen = inputs.generator(seed, 0, self.dev)
        clean = inputs.volume(traffic, D, gen)
        self.tf = inputs.transfer_function(cfg["tf"], cfg["tf_resolution"],
                                           self.dev)
        self.vol_gt = clean[None]
        start = inputs.corrupt(clean, cfg["corruption"], gen)
        self.vol0 = start
        self.vol = start[None].clone().requires_grad_(True)
        self.feed_gen = inputs.generator(seed, 1, self.dev)
        H, W = cfg["image"]
        self.rc = P.Raycaster(
            tuple(cfg["volume"]), (W, H), cfg["tf_resolution"],
            sampling_rate=cfg["sampling_rate"], jitter=cfg["jitter"],
            max_samples=cfg["max_samples"], fov=cfg["fov"],
            near=cfg["near"], device=self.dev,
            **{k: cfg[k] for k in ("ambient", "diffuse", "specular",
                                   "shininess", "ert_threshold",
                                   "alpha_skip", "normal_delta")})
        self.opt, self.sched = self._schedule()
        self.k = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.outputs = None     # the checked steps' images and ground truth

    def _schedule(self):
        c = self.cfg
        return self.P.adamw_onecycle([self.vol], max_lr=c["max_lr"],
                                     total_steps=c["total_steps"],
                                     weight_decay=c["weight_decay"])

    def feed(self):
        """The poses (V, 3) and jitter (V, H, W) of the next step: the
        orbit's pose of this step, then random ones."""
        c = self.cfg
        lfs = torch.cat([
            inputs.orbit(c["orbit_step"] * self.k, c["orbit_y"],
                         c["orbit_dist"], self.dev)[None],
            inputs.random_poses(self.feed_gen, c["views"] - 1,
                                c["random_dist"])])
        u = (torch.rand((c["views"],) + tuple(c["image"]),
                        generator=self.feed_gen, device=self.dev)
             if c["jitter"] else None)
        return lfs, u

    def step(self, lfs, u, span=None):
        span = span or _no_span
        P = self.P
        with span("gt_render"), torch.no_grad():
            gts = self.rc.raycast_nondiff(self.vol_gt, self.tf, lfs,
                                          self.cfg["gt_sampling_rate"])
        with span("render"):
            imgs = self.rc(self.vol, self.tf, lfs, u=u)
        with span("loss"):
            loss = P.dssim_mse_loss(imgs, gts)
        if self.outputs is not None:
            self.outputs.append((imgs.detach().clone(), gts.clone()))
        with span("backward"):
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        with span("optim"):
            self.opt.step()
            self.sched.step()
            P.project_unit(self.vol)
        self.k += 1
        if self.k % self.cfg["total_steps"] == 0:
            # The schedule restarts; AdamW keeps its moments.
            state = self.opt.state[self.vol]
            self.opt, self.sched = self._schedule()
            self.opt.state[self.vol] = state
        loss = loss.detach()
        self.bad += (~torch.isfinite(loss)).to(torch.int64)
        return loss

    # -- set-up, window, trace ---------------------------------------------

    def setup(self):
        """The checked steps, recorded for the reference, then warm-up."""
        self.poses, self.jitters, self.outputs = [], [], []
        for i in range(CHECKED):
            lfs, u = self.feed()
            self.poses.append(lfs)
            self.jitters.append(u)
            self.step(lfs, u)
            if i == 0:
                # The gradient as AdamW took it: its first moment after one
                # step is (1 - beta1) g; no moment, no gradient taken.
                beta1 = self.opt.param_groups[0]["betas"][0]
                m = self.opt.state[self.vol].get("exp_avg")
                self.grad1 = (torch.zeros_like(self.vol0) if m is None
                              else (m[0] / (1.0 - beta1)).clone())
        self.vol_checked = self.vol.detach()[0].clone()
        self.checked_outputs, self.outputs = self.outputs, None
        for _ in range(WARM):
            self.step(*self.feed())
        self.sync()

    def window(self, seconds: float) -> dict:
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step(*self.feed())
            n += 1
        self.sync()
        t = time.perf_counter() - t0
        self.attempted, self.failed = n, int(self.bad)
        return {"step_ms": t / n * 1e3}

    def traced(self, trace_path: str):
        from .. import tracing
        self.work_inputs = []

        def unit(i):
            lfs, u = self.feed()
            if i < WORK_STEPS:
                self.work_inputs.append((i, self.vol.detach()[0].clone(),
                                         lfs, u))
            with tracing.annotate("step"):
                self.step(lfs, u, span=_annotated)
        tr = tracing.profile_units(unit, TRACED, self.sync, trace_path)
        spans = tracing.Spans(self.sync)
        self.sync()
        for _ in range(SPAN_STEPS):
            self.step(*self.feed(), span=spans)
        tr.spans, tr.span_units = spans.seconds, SPAN_STEPS
        self.attempted = TRACED + SPAN_STEPS
        self.failed = int(self.bad)
        self.trace = tr
        return tr

    def count_work(self):
        """K2's work in the traced window's first steps, each view's (after
        the window, the program's state freed)."""
        least = sum(work.least_seconds(*work.k2_launch_work(
            vol, self.tf, lfs[v], None if u is None else u[v], self.cfg))
            for _, vol, lfs, u in self.work_inputs
            for v in range(lfs.shape[0]))
        self.trace.work["k2"] = {"steps": [i for i, *_ in self.work_inputs],
                                 "least_s": least}
        del self.work_inputs

    # -- correctness ---------------------------------------------------------

    def release(self):
        """Frees the program's state; keeps what the check reads."""
        self.program = {"losses": [fit.loss64(imgs, gts) for imgs, gts
                                   in self.checked_outputs],
                        "grad1": self.grad1, "volume": self.vol_checked}
        del self.rc, self.opt, self.sched, self.vol
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, store=None) -> dict:
        return fit.fit_steps(self.vol0, self.vol_gt[0], self.tf, self.poses,
                             self.jitters, self.cfg, store=store)

    def details(self, ref: dict) -> dict:
        """What lies under the numbers (for the calibration): each step's
        loss gap, the share of voxels whose first gradients differ in sign,
        those whose reference gradient is below Adam's eps, and how far the
        volumes after the checked steps lie apart."""
        got = self.program
        g_p, g_r = got["grad1"], ref["grad1"]
        both = (g_p != 0) & (g_r != 0)
        flip = both & ((g_p > 0) != (g_r > 0))
        dv = (got["volume"] - ref["volume"]).abs()
        return {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                              zip(got["losses"], ref["losses"])],
                "flip_share": float(flip.float().mean()),
                "flip_max_abs_grad": float(g_r.abs()[flip].max())
                if bool(flip.any()) else 0.0,
                "tiny_share": float(((g_r != 0) & (g_r.abs() < 1e-8))
                                    .float().mean()),
                "volume_gap_max": float(dv.max()),
                "volume_gap_voxels": int((dv > 1e-6).sum())}

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers the check compares: each step's loss (evaluated in
        float64 from the views and the ground truth the step rendered), the
        first gradient's norm and the norm of the volume's change, each as
        the gap to the reference's over the reference's."""
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], want["losses"]))
        g_got = float(torch.linalg.vector_norm(got["grad1"]))
        g_want = float(torch.linalg.vector_norm(want["grad1"]))
        c_got = float(torch.linalg.vector_norm(got["volume"] - self.vol0))
        c_want = float(torch.linalg.vector_norm(want["volume"] - self.vol0))
        return {"loss_gap": loss_gap,
                "grad_norm_gap": abs(g_got - g_want) / g_want,
                "change_norm_gap": abs(c_got - c_want) / c_want}


def _no_span(name):
    return contextlib.nullcontext()


def _annotated(name):
    from .. import tracing
    return tracing.annotate(name)
