"""Volume inverse rendering, the port of the JAX package's
``examples/optimize_volume.py`` (the reference's ``test_opt_tf.py``, which
optimizes the volume): recover a corrupted volume from views rendered of
the clean one.

The recipe: 5% of voxels randomized, 8 poses a step (one on an orbit, 7
random), targets rendered from the clean volume by the inference path at
sampling rate 8, loss (1 - SSIM) + MSE per view, AdamW under a OneCycle
schedule, the volume clamped to [0, 1] after each step.  Each step is
``parallel.train_step_views`` (kernels K1 and K2 per view on the card);
``--checkpoint-every`` writes ``ckpt.pkl`` (the volume, the optimizer's
state and the generator's) and ``--resume`` continues from one, the
schedule taken from the arguments and its count from the checkpoint, as in
the JAX script.  ``--mesh-views N`` splits the views over the N ranks of a
``torch.distributed`` group (start the script under ``torchrun
--nproc-per-node N``; NCCL on the card, gloo with ``--cpu``)::

    python -m differender_tpu_torch.examples.optimize_volume [--cpu]
"""
import argparse
import os
import warnings

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=64, help="volume resolution")
    ap.add_argument("--img-res", type=int, default=128)
    ap.add_argument("--tf-res", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--max-lr", type=float, default=1e-3)
    ap.add_argument("--corruption", type=float, default=0.05)
    ap.add_argument("--sampling-rate", type=float, default=1.0)
    ap.add_argument("--gt-sampling-rate", type=float, default=8.0)
    ap.add_argument("--max-samples", type=int, default=512)
    ap.add_argument("--results", type=str, default="results/opt_volume")
    ap.add_argument("--log-figures-every", type=int, default=0,
                    help="save comparison figures every N steps (0 = off)")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint file to resume from")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain torch versions on the CPU")
    ap.add_argument("--view-mode", choices=["auto", "accum", "shard_map",
                                            "vmap"],
                    default="auto",
                    help="multi-view step strategy: accum = the views in "
                         "turn, each its own forward and backward, "
                         "gradients summed; shard_map = the views split "
                         "over the ranks of a process group (--mesh-views); "
                         "vmap = one autograd graph over all views "
                         "(render_batch: torch.func.vmap cannot trace the "
                         "kernels, and the batch's one K1 launch marches "
                         "every view); auto = shard_map with a group, "
                         "else accum")
    ap.add_argument("--mesh-views", type=int, default=0,
                    help="split the views over this many ranks of a "
                         "torch.distributed group (enables shard_map mode)")
    return ap


def _group(args, dev):
    """The process group of ``--mesh-views`` (None without it), joined from
    the environment that ``torchrun`` sets."""
    import torch.distributed as dist
    if args.mesh_views <= 0:
        return None
    if not dist.is_initialized():
        if dev != "cpu":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if dev == "cpu" else "nccl")
    if dist.get_world_size() != args.mesh_views:
        raise ValueError(f"--mesh-views {args.mesh_views} needs a group of "
                         f"that many ranks; this one has "
                         f"{dist.get_world_size()} (start the script under "
                         f"torchrun --nproc-per-node {args.mesh_views})")
    return dist.group.WORLD


def run(args):
    """The fitting loop.  Returns ``{"volume", "volume_gt", "tf", "losses",
    "start_step", "figures": [(step, prediction, target, log, volume)],
    "lead"}``; writes the checkpoints (every ``--checkpoint-every`` steps,
    and at Ctrl+C) on rank 0 (``lead``)."""
    import torch.distributed as dist
    from differender_tpu_torch import (RenderConfig, adamw_onecycle,
                                       dssim_mse_loss, get_rand_pos, get_tf,
                                       in_circles, project_unit, render,
                                       render_batch, render_nondiff,
                                       render_nondiff_batch)
    from differender_tpu_torch.io import (checkpoint_tensors,
                                          load_checkpoint, save_checkpoint)
    from differender_tpu_torch.parallel import train_step_views

    dev = "cpu" if args.cpu else "cuda"
    group = _group(args, dev)
    if group is not None and dev != "cpu":
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = group is None or dist.get_rank() == 0
    os.makedirs(args.results, exist_ok=True)
    rng = np.random.default_rng(0)
    n = args.res
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(sum(x * x for x in g))
    vol_gt_np = (1.0 / (1.0 + np.exp((r - 0.55) * 14.0))).astype(np.float32)
    vol_np = vol_gt_np.copy()
    mask = rng.random(vol_np.shape) < args.corruption
    vol_np[mask] = rng.random(int(mask.sum()), dtype=np.float32)
    print(f"vol {vol_np.shape}, corrupted {mask.mean():.1%} of voxels")

    cfg = RenderConfig(volume_shape=vol_np.shape,
                       image_shape=(args.img_res, args.img_res),
                       tf_resolution=args.tf_res,
                       max_samples=args.max_samples)
    tf = get_tf("tf1", args.tf_res, device=dev)
    vol_gt = torch.from_numpy(vol_gt_np).to(dev)
    vol = torch.from_numpy(vol_np).to(dev).requires_grad_()
    opt, sched = adamw_onecycle([vol], max_lr=args.max_lr,
                                total_steps=args.iterations)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    start_step = 0
    if args.resume:
        state, start_step = load_checkpoint(args.resume)
        with torch.no_grad():
            vol.copy_(checkpoint_tensors(state["volume"], dev))
        opt.load_state_dict(checkpoint_tensors(state["opt_state"]))
        gen.set_state(checkpoint_tensors(state["generator"]))
        # The schedule of this run's --iterations, at the checkpoint's count
        # (OneCycleLR's rate is a closed form of its step count).
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for _ in range(start_step):
                sched.step()
        print(f"resumed from {args.resume} at step {start_step}")

    if args.view_mode == "vmap":
        mode = None
    elif args.view_mode == "auto":
        mode = "shard_map" if group is not None else "accum"
    else:
        mode = args.view_mode

    def view_loss(img, tgt):
        """(1 - SSIM) + MSE of one (H, W, 4) view."""
        return dssim_mse_loss(img.permute(2, 0, 1), tgt.permute(2, 0, 1))

    def step(lfs, u):
        with torch.no_grad():
            gts = render_nondiff_batch(vol_gt, tf, lfs, cfg,
                                       args.gt_sampling_rate).image
        if mode is None:
            # One graph over all views (one K1 launch on the card), the
            # batch's joint loss.
            v = vol.detach().requires_grad_()
            imgs = render_batch(v, tf, lfs, cfg, args.sampling_rate,
                                u=u).image
            loss = dssim_mse_loss(imgs.permute(0, 3, 1, 2),
                                  gts.permute(0, 3, 1, 2))
            grads, = torch.autograd.grad(loss, v)
        else:
            loss, (grads, _) = train_step_views(
                view_loss, vol, tf, lfs, gts, cfg,
                sampling_rate=args.sampling_rate, u=u, group=group,
                mode=mode)
        vol.grad = grads
        opt.step()
        sched.step()
        project_unit(vol)
        return float(loss.detach()), float(grads.abs().max())

    def checkpoint(i):
        if lead:
            save_checkpoint(f"{args.results}/ckpt.pkl",
                            {"volume": vol, "opt_state": opt.state_dict(),
                             "generator": gen.get_state()}, step=i)

    losses, figures = [], []
    H, W = cfg.image_shape
    i = start_step
    try:
        for i in range(start_step, args.iterations):
            lfs = torch.cat([in_circles(0.1 * i, device=dev)[None],
                             get_rand_pos(gen, args.bs - 1)])
            u = torch.rand((args.bs, H, W), generator=gen, device=dev)
            loss, gmax = step(lfs, u)
            losses.append(loss)
            err = float((vol.detach() - vol_gt).abs().mean())
            log = (f"Step {i:03d}:   Loss: {loss:0.3f}   "
                   f"Vol Grad AbsMax: {gmax:.1e}   Vol err: {err:.5f}")
            print(log)
            if args.log_figures_every and i % args.log_figures_every == 0:
                with torch.no_grad():
                    figures.append((i, render(vol, tf, lfs[0], cfg,
                                              args.sampling_rate).image,
                                    render_nondiff(vol_gt, tf, lfs[0], cfg,
                                                   args.gt_sampling_rate
                                                   ).image, log,
                                    vol.detach().clone()))
            if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                checkpoint(i + 1)
    except KeyboardInterrupt:
        # As the reference: Ctrl+C still saves the state.
        print(f"Ctrl+C stopped at step {i}. Saving checkpoint now.")
        checkpoint(i)
    return {"volume": vol.detach(), "volume_gt": vol_gt, "tf": tf,
            "losses": losses, "start_step": start_step, "figures": figures,
            "lead": lead}


def write(args, out):
    """Writes the logged steps' figures under ``--results`` on rank 0
    (matplotlib)."""
    from differender_tpu_torch.plotting import (plot_comp_render_tf,
                                                save_histogram)
    if not out["lead"]:
        return
    for i, img, gt, log, vol in out["figures"]:
        plot_comp_render_tf([(img, out["tf"], "Prediction"),
                             (gt, out["tf"], "Target")],
                            path=f"{args.results}/comparison_plot_{i:03d}.png",
                            suptitle=log)
        save_histogram(vol, f"{args.results}/hist_{i:03d}.png")


def main(argv=None):
    import torch.distributed as dist
    args = parser().parse_args(argv)
    write(args, run(args))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
