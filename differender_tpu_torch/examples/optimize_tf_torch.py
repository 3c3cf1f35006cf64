"""TF optimization in a plain torch training loop, the port of the JAX
package's ``examples/optimize_tf_torch.py``: torch tensors,
``loss.backward()`` and ``torch.optim.Adam`` around
:class:`~differender_tpu_torch.TorchRaycaster` (kernels K1 and K2 each
step on the card)::

    python -m differender_tpu_torch.examples.optimize_tf_torch [--cpu]
"""
import argparse

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("torch-loop TF optimization")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--vol-res", type=int, default=64)
    ap.add_argument("--tf-res", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--sampling-rate", type=float, default=1.0)
    ap.add_argument("--out", type=str, default="tf_torch_opt.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain torch versions on the CPU")
    return ap


def make_volume(res):
    """A soft shell with a core, (D, H, W) numpy."""
    xs = np.linspace(-1, 1, res, dtype=np.float32)
    g = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(sum(x * x for x in g))
    shell = np.exp(-((r - 0.6) ** 2) / 0.004) * 0.5
    core = 1.0 / (1.0 + np.exp((r - 0.3) * 25.0)) * 0.3
    return (shell + core).astype(np.float32)


def run(args):
    """The loop: ``{"losses", "tf", "target_tf"}`` (TFs channel-major
    (4, R))."""
    from differender_tpu_torch import TorchRaycaster, get_tf_torch_layout
    dev = "cpu" if args.cpu else "cuda"
    volume = torch.from_numpy(make_volume(args.vol_res)[None]).to(dev)
    target_tf = get_tf_torch_layout("tf1", args.tf_res, device=dev)
    look_from = torch.tensor([1.2, 0.8, 2.0], device=dev)

    rc = TorchRaycaster(volume.shape[1:], (args.res, args.res), args.tf_res,
                        sampling_rate=args.sampling_rate, jitter=True,
                        max_samples=512, device=dev)
    print(rc)

    with torch.no_grad():
        target = rc(volume, target_tf, look_from)

    tf = torch.full_like(target_tf, 0.3).requires_grad_(True)
    opt = torch.optim.Adam([tf], lr=args.lr)
    losses = []
    for it in range(args.iterations):
        opt.zero_grad()
        img = rc(volume, tf, look_from)
        loss = torch.nn.functional.mse_loss(img, target)
        loss.backward()
        opt.step()
        with torch.no_grad():                 # TF textures live in [0, 1]
            tf.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
        if it % 10 == 0 or it == args.iterations - 1:
            print(f"iter {it:4d}  loss {losses[-1]:.6f}")
    return {"losses": losses, "tf": tf.detach(), "target_tf": target_tf}


def write(args, out):
    """Plots the target and the optimized TF to ``--out`` (matplotlib)."""
    from differender_tpu_torch.plotting import plot_tfs
    plot_tfs([(out["target_tf"].T, "target"), (out["tf"].T, "optimized")],
             path=args.out)
    print(f"wrote {args.out}")


def main(argv=None):
    args = parser().parse_args(argv)
    write(args, run(args))


if __name__ == "__main__":
    main()
