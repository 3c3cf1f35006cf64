"""The transfer-function fit (the benchmark's ``tffit.ct_head`` cell): the
port's fit against the benchmark's plain reference
(``dvrbench/reference/tffit.py``), the cell run whole on the CPU at a small
size, two faults planted in the program, the spans its metrics read, and
the backward's choice of K2's TF-only instantiation.

The tests marked ``card`` run K2's TF-only instantiation against the full
one, a warmed fitting step under ``torch.cuda.set_sync_debug_mode("error")``
and the faults at the cell's own size; they skip without a card.  This file
imports no JAX, so on the card's machine it runs without the suite's
``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_tffit.py
"""
import importlib
import json

import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch.optim import TFMomentum
from dvrbench import calibrate, faults_tf, harness, inputs, run
from dvrbench.jobs import tffit as job_tffit
from dvrbench.reference import tffit

# The module (the package's ``render`` is the function).
PR = importlib.import_module("differender_tpu_torch.render")
CELL = "tffit.ct_head"
# The cell on the CPU in seconds: 16^3, 12^2, 16 texels, fits of 4 steps.
SMALL = faults_tf.SMALL["tffit"]
R = 16


def _cfg(**kw):
    return dict(harness.config("tf_fit_240"), volume=[16, 16, 16],
                image=[12, 12], tf_resolution=R, max_samples=64, **kw)


def _tf(gen, zero_alpha):
    """A seeded (4, R) TF: colours in [0, 1), alphas in [0.05, 0.4), or
    with every other texel's alpha exactly 0."""
    tf = torch.rand((4, R), generator=gen)
    tf[3] = 0.05 + 0.35 * tf[3]
    if zero_alpha:
        tf[3, ::2] = 0.0
    return tf


def _port_fit(vol_user, tf_target, tf0, look_from, cfg, steps):
    """The port's fit as its example runs it: ``render`` -> ``mse_loss``
    -> ``TFMomentum`` -> ``project_nonneg``, the target by
    ``render_nondiff``."""
    vol = P.volume_to_internal(vol_user).contiguous()
    rcfg = P.RenderConfig(volume_shape=tuple(vol.shape),
                          image_shape=tuple(cfg["image"]), tf_resolution=R,
                          max_samples=cfg["max_samples"])
    target = P.render_nondiff(vol, tf_target.t(), look_from, rcfg,
                              sampling_rate=cfg["fw_sampling_rate"]).image
    tf = tf0.t().contiguous().requires_grad_(True)
    opt = TFMomentum([tf], lr=cfg["lr"], gamma=cfg["mom"],
                     max_grad=cfg["clip_grads"], lr_decay=cfg["lr_decay"])
    losses, grad1 = [], None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        img = P.render(vol, tf, look_from, rcfg, cfg["bw_sampling_rate"]).image
        P.mse_loss(img, target).backward()
        grad1 = tf.grad.clone() if grad1 is None else grad1
        opt.step()
        P.project_nonneg(tf)
        losses.append(tffit.mse64(img.detach(), target))
    return {"losses": losses, "grad1": grad1, "tf": tf.detach()}


def _gaps(got, want, tf0):
    rel = job_tffit._rel
    return {"loss": max(abs(a - b) / b for a, b in zip(got["losses"],
                                                        want["losses"])),
            "grad": rel(got["grad1"], want["grad1"]),
            "change": rel(got["tf"] - tf0.t(), want["tf"] - tf0.t())}


# Each tolerance is about 10 times the port's larger reading on the two
# scenes, far below the bfloat16 control's (which reads 4e-3 and more on
# each number):
# - the losses: the two marches composite the same f32 samples, one
#   sequentially, one by chunked cumulative products (readings 8.7e-8 and
#   1.5e-7);
# - d_tf: the port sums it sample by sample, the reference through
#   autograd's index sums (readings 2.5e-7 and 4.3e-7);
# - the TF's change: three clipped momentum steps of those gradients
#   (readings 7.6e-9 and 3.8e-6).
TOL = {"loss": 2e-6, "grad": 5e-6, "change": 4e-5}


@pytest.mark.parametrize("zero_alpha", [False, True],
                         ids=["dense", "zero_alpha"])
def test_three_steps_match_the_reference(zero_alpha):
    gen = torch.Generator().manual_seed(1800 + zero_alpha)
    vol_user = torch.rand((16, 16, 16), generator=gen)
    tf_target, tf0 = _tf(gen, False), _tf(gen, zero_alpha)
    look_from = torch.tensor([1.2, 0.9, 1.9])
    cfg = _cfg()
    want = tffit.fit_steps(vol_user, tf_target, tf0, look_from, cfg, 3)
    got = _port_fit(vol_user, tf_target, tf0, look_from, cfg, 3)
    gaps = _gaps(got, want, tf0)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps
    control = _gaps(tffit.fit_steps(vol_user, tf_target, tf0, look_from,
                                    cfg, 3, store=calibrate.bf16), want, tf0)
    print(json.dumps({"zero_alpha": zero_alpha, "port": gaps,
                      "control": control}))
    assert any(control[k] > TOL[k] for k in TOL), control


def test_the_cell_runs_correct_on_the_cpu():
    r = run.run_cell(CELL, 2 ** 33 + 18, 0.3, False, "cpu", overrides=SMALL)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


FAULTS = faults_tf.FAULTS["tffit"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_read_past_the_limits(fault):
    with FAULTS[fault]():
        r = run.run_cell(CELL, 2 ** 33 + 19, 0.3, False, "cpu",
                         overrides=SMALL)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values()), \
        r["checks"]


def test_optim_host_ms_reads_a_number_from_a_cpu_trace():
    r = run.run_cell(CELL, 2 ** 33 + 20, 0.3, True, "cpu",
                     overrides=dict(SMALL, iterations=3))
    assert r["correct"] is True, r["checks"]
    ms = r["metrics"]["optim_host_ms.tffit"]["value"]
    assert ms > 0.0


# (volume, TF, camera) requiring grad -> K2's volume gradient computed.
NEEDS = {"tf_only": ((False, True, False), False),
         "volume_and_tf": ((True, True, False), True),
         "volume_only": ((True, False, False), True),
         "tf_and_camera": ((False, True, True), True)}


@pytest.mark.parametrize("case", sorted(NEEDS))
def test_backward_takes_tf_only_k2_where_only_the_tf_needs_a_gradient(
        case, monkeypatch):
    """``_MarchDiff``'s choice of K2 instantiation, the calls of K1 and K2
    replaced by stand-ins that record how they were called."""
    (v_req, t_req, c_req), volume_grad = NEEDS[case]
    calls = []

    def k1(volume, tf, soa, config, sampling_rate, ert, counts=None,
           segment=None, views=None):
        H, W = config.image_shape
        return (torch.zeros((H, W, 4)), torch.zeros((H, W),
                                                    dtype=torch.int32))

    def k2(volume, tf, soa, config, sampling_rate, image, grad, ert,
           counts=None, sums=None, segment=None, volume_grad=True,
           into=None):
        calls.append(volume_grad)
        if sums is not None:
            sums.zero_()
        return (torch.zeros_like(volume) if volume_grad else None,
                torch.ones_like(tf), None)
    monkeypatch.setattr(PR, "_launch_march", k1)
    monkeypatch.setattr(PR, "_launch_k2", k2)
    P.reset_launch_counts()
    cfg = P.RenderConfig(volume_shape=(6, 6, 6), image_shape=(4, 5),
                         tf_resolution=8, max_samples=16)
    vol = torch.rand((6, 6, 6)).requires_grad_(v_req)
    tf = torch.rand((8, 4)).requires_grad_(t_req)
    look_from = torch.tensor([1.2, 0.9, 1.9]).requires_grad_(c_req)
    soa = PR._ray_soa(P.make_rays(look_from, cfg, 1.0))
    image, _ = PR._MarchDiff.apply(vol, tf, *soa, cfg, 1.0, True)
    image.sum().backward()
    assert calls == [volume_grad]
    counts = P.launch_counts()
    assert counts["march_diff_fwd"] == counts["march_diff_bwd"] == 1
    assert counts["march_diff_bwd.tf_only"] == int(not volume_grad)
    assert counts["march_diff_bwd.camera"] == int(c_req)
    assert (tf.grad is not None) == t_req
    assert (vol.grad is not None) == v_req


def test_march_diff_bwd_without_volume_grad():
    """The public backward's TF-only form: ``d_volume`` None, the same
    ``d_tf`` and steps as the full backward; ``sums`` refused."""
    gen = torch.Generator().manual_seed(1801)
    cfg = P.RenderConfig(volume_shape=(8, 8, 8), image_shape=(6, 5),
                         tf_resolution=R, max_samples=32)
    vol, tf = torch.rand((8, 8, 8), generator=gen), _tf(gen, True).t()
    rays = P.make_rays(torch.tensor([1.2, 0.9, 1.9]), cfg, 2.0)
    image, _ = P.march_diff_fwd(vol, tf, rays, cfg, 2.0)
    g = torch.rand((6, 5, 4), generator=gen) - 0.5
    d_vol, d_tf, steps = P.march_diff_bwd(vol, tf, rays, cfg, 2.0, image, g)
    got = P.march_diff_bwd(vol, tf, rays, cfg, 2.0, image, g,
                           volume_grad=False)
    assert got[0] is None and d_vol is not None
    assert torch.equal(got[1], d_tf) and torch.equal(got[2], steps)
    with pytest.raises(ValueError):
        P.march_diff_bwd(vol, tf, rays, cfg, 2.0, image, g,
                         sums=torch.empty((6, 5, 12)), volume_grad=False)


def test_loss_and_optimizer_spans_record_under_a_profiler(tmp_path):
    from dvrbench import tracing
    tf = torch.rand((8, 4)).requires_grad_(True)
    opt = TFMomentum([tf])

    def unit(i):
        opt.zero_grad(set_to_none=True)
        P.mse_loss(tf, torch.zeros_like(tf)).backward()
        opt.step()
    tr = tracing.profile_units(unit, 2, lambda: None,
                               str(tmp_path / "trace.json"))
    names = [h[2] for h in tr.host_ops if h[3] == "user_annotation"]
    assert names.count("dr.loss") == 2 and names.count("dr.optim") == 2


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 and the host syncs it checks "
                    "exist only there")


def _cell_inputs(R_, lit=False):
    """The cell's volume (256^3 ct_head), tf5 at ``R_`` texels (``lit``:
    0.01 added to every alpha, so that no sample is quiet), a pose on its
    orbit and the published image."""
    cfg = harness.config("tf_fit_240")
    gen = inputs.generator(2 ** 32 + 18, 0, "cuda")
    vol_user = inputs.volume(harness.traffic("ct_head"), 256, gen)
    vol = P.volume_to_internal(vol_user).contiguous()
    tf = job_tffit.transfer_function("tf5", R_, "cuda").t().contiguous()
    if lit:
        tf[:, 3] += 0.01
    look_from = inputs.orbit(0.7, cfg["orbit_y"], cfg["orbit_dist"], "cuda")
    return cfg, vol, tf, look_from


# The TF-only K2 against the full one: the same f32 terms per sample, summed
# with atomics in an order that varies from run to run.  R <= 1024: per
# block in shared memory, then one add per block into the global d_tf
# (readings 2.8e-7 to 2.4e-6 at R = 128 lit; two runs of the full K2 differ
# by 2.8e-7 to 1.4e-6).  Under tf5 as it is, the air's samples are quiet
# (alpha 0) and add their terms to texel 0 alone.  R > 1024: every term straight into the global d_tf,
# some 1e8 atomics on a few hot texels (readings 6.7e-5 and 9.3e-4 at
# R = 2048; two full runs differ by 7.9e-4).  The test prints both gaps.
DTF_TOL = {False: 1e-5, True: 5e-3}


@pytest.mark.card
@pytest.mark.parametrize("analytic,R_,lit", [
    (False, 128, False), (True, 128, False), (False, 128, True),
    (True, 128, True), (False, 2048, True)])
def test_tf_only_k2_matches_the_full_k2_on_the_card(card, analytic, R_, lit):
    cfg, vol, tf, look_from = _cell_inputs(R_, lit)
    rcfg = P.RenderConfig(volume_shape=tuple(vol.shape),
                          image_shape=tuple(cfg["image"]), tf_resolution=R_,
                          max_samples=cfg["max_samples"],
                          analytic_normals=analytic)
    sr = cfg["bw_sampling_rate"]
    tf_req = tf.clone().requires_grad_(True)
    out = P.render(vol, tf_req, look_from, rcfg, sr)
    g = torch.rand(out.image.shape, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda") - 0.5
    rays = P.make_rays(look_from, rcfg, sr)
    d_vol_full, d_tf_full, _ = P.march_diff_bwd(vol, tf, rays, rcfg, sr,
                                                out.image.detach(), g)
    d_tf_again = P.march_diff_bwd(vol, tf, rays, rcfg, sr,
                                  out.image.detach(), g)[1]
    torch.cuda.synchronize()
    P.reset_launch_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = out.image.grad_fn.apply(g, None)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    d_volume, d_tf = grads[0], grads[1]
    gap = job_tffit._rel(d_tf, d_tf_full)
    print(json.dumps({"analytic": analytic, "R": R_, "lit": lit,
                      "d_tf_gap": gap,
                      "full_runs_gap": job_tffit._rel(d_tf_again, d_tf_full),
                      "backward_extra_bytes": extra,
                      "d_volume_bytes": vol.numel() * 4}))
    assert d_volume is None
    assert gap <= DTF_TOL[R_ > 1024]
    assert P.launch_counts()["march_diff_bwd"] == 1
    assert P.launch_counts()["march_diff_bwd.tf_only"] == 1
    assert extra < vol.numel() * 4
    assert float(torch.linalg.vector_norm(d_vol_full)) > 0.0


@pytest.mark.card
def test_warmed_tf_fit_steps_make_no_host_sync_on_the_card(card):
    """A warmed step and a restart (the target through ``render_nondiff``)
    of the cell's job at its own size make no host sync."""
    w = harness.cell(CELL)
    cfg = harness.config(w["config"])
    job = job_tffit.Job(cfg, harness.traffic(w["traffic"]), 2 ** 32 + 19,
                        "cuda")
    job.setup()
    P.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        job.step()
        job.k = cfg["iterations"]
        job.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert P.launch_counts()["march_diff_bwd.tf_only"] == 2
    assert P.launch_counts()["march_diff_bwd"] == 2


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 32 + 21, 2 ** 32 + 22, 2 ** 32 + 23])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_read_past_the_limits_on_the_card(card, fault, seed):
    with FAULTS[fault]():
        r = run.run_cell(CELL, seed, 1.5, False, "cuda")
    print(json.dumps({"fault": fault, "seed": seed,
                      "checks": {k: c["value"]
                                 for k, c in r["checks"].items()}}))
    assert r["correct"] is False
