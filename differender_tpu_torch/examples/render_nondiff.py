"""Forward-only (non-differentiable) render, the port of the JAX package's
``examples/render_nondiff.py``: a synthetic skull-like shell by default, or
a raw volume (``--raw``/``--shape``, the skull.raw recipe) or a NIfTI file
(``--nifti``), rendered at 800^2 with sampling rate 16 in 4 row strips
(kernel K3, the occupancy grid by K6 and K7)::

    python -m differender_tpu_torch.examples.render_nondiff [--cpu]
"""
import argparse

import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", type=str, default=None,
                    help="raw uint8 volume file (skull.raw recipe)")
    ap.add_argument("--shape", type=int, nargs=3, default=[256, 256, 256])
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--tf", type=str, default="tf1")
    ap.add_argument("--tf-res", type=int, default=128)
    ap.add_argument("--sampling-rate", type=float, default=16.0)
    ap.add_argument("--out", type=str, default="render.png")
    ap.add_argument("--nifti", type=str, default=None,
                    help="NIfTI volume (.nii/.nii.gz) (io.load_nifti)")
    ap.add_argument("--strips", type=int, default=4,
                    help="render as N row strips, one launch each "
                         "(1 = monolithic)")
    ap.add_argument("--cpu", action="store_true",
                    help="render with the plain torch versions on the CPU")
    return ap


def scene(args):
    """The script's ``(volume (X, Y, Z), tf (R, 4), look_from, config)`` on
    its device."""
    from differender_tpu_torch import (RenderConfig, get_tf,
                                       synthetic_volume, volume_to_internal)
    from differender_tpu_torch.io import load_nifti, load_raw_volume
    dev = "cpu" if args.cpu else "cuda"
    if args.nifti:
        vol_dhw = load_nifti(args.nifti, device=dev)
    elif args.raw:
        vol_dhw = load_raw_volume(args.raw, tuple(args.shape), device=dev)
    else:
        vol_dhw = torch.from_numpy(synthetic_volume(min(args.shape))).to(dev)
    vol = volume_to_internal(vol_dhw).contiguous()
    cfg = RenderConfig(volume_shape=tuple(vol.shape),
                       image_shape=(args.res, args.res),
                       tf_resolution=args.tf_res,
                       max_samples=1,      # the inference march has no cap
                       jitter=False)
    tf = get_tf(args.tf, args.tf_res, device=dev)
    look_from = torch.tensor([0.0, 1.0, -2.3], device=dev)
    return vol, tf, look_from, cfg


def run(args):
    """The render: ``{"image": (H, W, 4), "n_samples": (H, W)}`` on the
    script's device."""
    from differender_tpu_torch import render_nondiff, render_nondiff_strips
    vol, tf, look_from, cfg = scene(args)
    if args.strips > 1 and args.res % args.strips == 0:
        out = render_nondiff_strips(vol, tf, look_from, cfg,
                                    sampling_rate=args.sampling_rate,
                                    n_strips=args.strips)
    else:
        out = render_nondiff(vol, tf, look_from, cfg,
                             sampling_rate=args.sampling_rate)
    return {"image": out.image, "n_samples": out.n_samples}


def write(args, out):
    """Writes ``run``'s image to ``--out`` (PIL, matplotlib)."""
    from differender_tpu_torch.plotting import save_image
    img = out["image"].cpu().numpy()
    save_image(img, args.out)
    print(f"saved {args.out}  (mean alpha {img[..., 3].mean():.3f}, "
          f"max n_samples {int(out['n_samples'].max())})")


def main(argv=None):
    args = parser().parse_args(argv)
    write(args, run(args))


if __name__ == "__main__":
    main()
