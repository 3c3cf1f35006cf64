"""Transfer-function optimization and orbit rendering, the port of the JAX
package's ``examples/optimize_tf.py`` (the reference's research
prototype): ``backward`` recovers a target TF from one view with the
reference's momentum optimizer (``optim.TFMomentum``: kernels K1 and K2
each step); ``forward`` renders an orbit animation (kernel K3) into a GIF
and an AVI::

    python -m differender_tpu_torch.examples.optimize_tf backward [--cpu]
"""
import argparse
import os

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("TF optimization / orbit rendering")
    ap.add_argument("task", choices=["forward", "backward"])
    ap.add_argument("--res", type=int, default=240, help="render resolution")
    ap.add_argument("--vol-res", type=int, default=64)
    ap.add_argument("--tf-res", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=240)
    ap.add_argument("--ref", type=str, default=None,
                    help="path to a reference image .npy to fit against")
    ap.add_argument("--raw", type=str, default=None)
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    ap.add_argument("--max-samples", type=int, default=2048)
    ap.add_argument("--fw-sampling-rate", type=float, default=8.0)
    ap.add_argument("--bw-sampling-rate", type=float, default=2.0)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--mom", type=float, default=0.9)
    ap.add_argument("--clip-grads", type=float, default=0.1)
    ap.add_argument("--lr-decay", type=float, default=0.99)
    ap.add_argument("--bw-jitter", action="store_true")
    ap.add_argument("--target-tf", type=str, default="tf5")
    ap.add_argument("--init-tf", type=str, default="black")
    ap.add_argument("--results", type=str, default="results/opt_tf")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain torch versions on the CPU")
    return ap


def make_volume(res, raw=None, shape=None, device="cuda"):
    """The script's volume (D, H, W): a raw file, or a soft shell with a
    core."""
    if raw:
        from differender_tpu_torch.io import load_raw_volume
        return load_raw_volume(raw, tuple(shape), device=device)
    xs = np.linspace(-1, 1, res, dtype=np.float32)
    g = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(sum(x * x for x in g))
    shell = np.exp(-((r - 0.6) ** 2) / 0.004) * 0.5
    core = 1.0 / (1.0 + np.exp((r - 0.3) * 25.0)) * 0.3
    return torch.from_numpy((shell + core).astype(np.float32)).to(device)


def run(args):
    """The task's work.  ``forward``: ``{"frames": [(H, W, 4)]}``.
    ``backward``: ``{"reference", "losses", "tf_pred", "tf_target",
    "logged": [(step, tf_pred, image)], "tf_l1"}``: the logged steps' TF
    and render, to be plotted and written as frames."""
    from differender_tpu_torch import (RenderConfig, get_tf, in_circles,
                                       mse_loss, project_nonneg, render,
                                       render_nondiff, volume_to_internal)
    from differender_tpu_torch.optim import TFMomentum
    dev = "cpu" if args.cpu else "cuda"
    vol = volume_to_internal(make_volume(args.vol_res, args.raw, args.shape,
                                         dev)).contiguous()
    cfg = RenderConfig(volume_shape=tuple(vol.shape),
                       image_shape=(args.res, args.res),
                       tf_resolution=args.tf_res,
                       max_samples=args.max_samples)
    look_from = torch.tensor([0.0, 0.9, 2.3], device=dev)

    if args.task == "forward":
        tf = get_tf(args.target_tf, args.tf_res, device=dev)
        frames = []
        for i in range(min(args.iterations, 72)):
            lf = in_circles(2 * np.pi * i / 72.0, y=0.9, dist=2.3,
                            device=dev)
            frames.append(render_nondiff(
                vol, tf, lf, cfg, sampling_rate=args.fw_sampling_rate).image)
            if i % 12 == 0:
                print(f"frame {i}")
        return {"frames": frames}

    tf_target = get_tf(args.target_tf, args.tf_res, device=dev)
    if args.ref:
        reference = torch.from_numpy(np.load(args.ref)).to(dev)
    else:
        reference = render_nondiff(vol, tf_target, look_from, cfg,
                                   sampling_rate=args.fw_sampling_rate).image
    tf_pred = get_tf(args.init_tf, args.tf_res, device=dev).requires_grad_()
    opt = TFMomentum([tf_pred], lr=args.lr, gamma=args.mom,
                     max_grad=args.clip_grads, lr_decay=args.lr_decay)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    losses, logged = [], []
    for i in range(args.iterations):
        u = (torch.rand(cfg.image_shape, generator=gen, device=dev)
             if args.bw_jitter else None)
        opt.zero_grad()
        loss = mse_loss(render(vol, tf_pred, look_from, cfg,
                               args.bw_sampling_rate, u=u).image, reference)
        loss.backward()
        gmax = tf_pred.grad.abs().amax(dim=0)
        opt.step()
        project_nonneg(tf_pred)
        losses.append(float(loss.detach()))
        if i % args.log_every == 0 or i == args.iterations - 1:
            print(f"Step {i:03d}  Loss: {losses[-1]:.5f}  "
                  f"TF grad max (rgba): "
                  + " ".join(f"{float(v):.2e}" for v in gmax))
            with torch.no_grad():
                logged.append((i, tf_pred.detach().clone(), render(
                    vol, tf_pred, look_from, cfg,
                    args.bw_sampling_rate).image))
    tf_l1 = float((tf_pred.detach() - tf_target).abs().mean())
    print(f"final TF L1 vs target: {tf_l1:.4f}")
    return {"reference": reference, "losses": losses,
            "tf_pred": tf_pred.detach(), "tf_target": tf_target,
            "logged": logged, "tf_l1": tf_l1}


def write(args, out):
    """Writes ``run``'s arrays under ``--results`` (PIL, matplotlib)."""
    from differender_tpu_torch.plotting import plot_tfs, save_gif, save_image
    from differender_tpu_torch.video import VideoWriter
    os.makedirs(args.results, exist_ok=True)
    if args.task == "forward":
        frames = out["frames"]
        save_gif(frames, f"{args.results}/orbit.gif", fps=12)
        with VideoWriter(f"{args.results}/orbit.avi", fps=12) as vw:
            for fr in frames:
                vw.write_frame(fr)
        save_image(frames[0], f"{args.results}/frame0.png")
        print(f"saved {args.results}/orbit.gif and orbit.avi")
        return
    if not args.ref:
        np.save(f"{args.results}/temp_reference.npy",
                out["reference"].cpu().numpy())
    video = VideoWriter(f"{args.results}/optimization.avi", fps=12)
    for i, tf_i, image in out["logged"]:
        plot_tfs([(tf_i, "Prediction"), (out["tf_target"], "Target")],
                 path=f"{args.results}/tf_comparison_{i:03d}.png")
        video.write_frame(image)
    if video.n_frames:
        video.close()
        print(f"saved {args.results}/optimization.avi")


def main(argv=None):
    args = parser().parse_args(argv)
    write(args, run(args))


if __name__ == "__main__":
    main()
