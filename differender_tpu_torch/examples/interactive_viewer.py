"""Interactive orbit viewer, the port of the JAX package's
``examples/interactive_viewer.py``: the reference's forward-task viewer
(``a``/``d`` keys orbit the camera) as a local web app.  A stdlib HTTP
server on 127.0.0.1 renders frames on demand (kernel K3, with the
occupancy grid that K6 and K7 built once) and a single-page UI maps the
same keys, the arrows and a slider to the camera angle::

    python -m differender_tpu_torch.examples.interactive_viewer [--cpu] \
        [--port 8731]

Then open http://127.0.0.1:8731/ in a browser.  ``--frames N`` serves N
frames and exits; :func:`run` renders frames without the server.
"""
import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

PAGE = """<!DOCTYPE html>
<html><head><title>differender_tpu_torch orbit viewer</title><style>
 body { background:#111; color:#ddd; font-family:monospace; text-align:center }
 img  { image-rendering:pixelated; width:512px; height:512px;
        border:1px solid #444; margin-top:12px }
 #bar { margin-top:8px }
</style></head><body>
<h3>differender_tpu_torch — orbit viewer (a/d or &#8592;/&#8594; to rotate)</h3>
<img id="view" src="/frame?angle=0">
<div id="bar">angle: <span id="ang">0.00</span> rad
 <input type="range" id="slider" min="0" max="628" value="0" style="width:360px">
</div>
<script>
 let angle = 0, pending = false, queued = null;
 const img = document.getElementById('view');
 const ang = document.getElementById('ang');
 const slider = document.getElementById('slider');
 function show(a) {
   angle = ((a % 6.2832) + 6.2832) % 6.2832;
   ang.textContent = angle.toFixed(2);
   slider.value = Math.round(angle * 100);
   if (pending) { queued = angle; return; }
   pending = true;
   const next = new Image();
   next.onload = () => { img.src = next.src; pending = false;
     if (queued !== null) { const q = queued; queued = null; show(q); } };
   next.src = '/frame?angle=' + angle;
 }
 document.addEventListener('keydown', (e) => {
   if (e.key === 'a' || e.key === 'ArrowLeft')  show(angle - 0.15);
   if (e.key === 'd' || e.key === 'ArrowRight') show(angle + 0.15);
 });
 slider.addEventListener('input', () => show(slider.value / 100));
</script></body></html>"""


def make_handler(render_frame):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/frame":
                q = parse_qs(url.query)
                angle = float(q.get("angle", ["0"])[0])
                body = render_frame(angle)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/health":
                body = json.dumps({"ok": True}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

    return Handler


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8731)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--vol-res", type=int, default=64)
    ap.add_argument("--tf", type=str, default="tf1")
    ap.add_argument("--sampling-rate", type=float, default=2.0)
    ap.add_argument("--raw", type=str, default=None,
                    help="raw uint8 volume file (else synthetic)")
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="render with the plain torch versions on the CPU")
    ap.add_argument("--frames", type=int, default=0,
                    help="exit after serving N frames (testing)")
    return ap


def viewer(args):
    """The scene, built once, and its renderer: returns ``(render_at,
    description)``, ``render_at(angle)`` giving the (H, W, 4) image of the
    orbit camera at ``angle`` on the script's device."""
    from differender_tpu_torch import (RenderConfig, build_occupancy, get_tf,
                                       in_circles, render_nondiff)
    from differender_tpu_torch.io import load_raw_volume
    dev = "cpu" if args.cpu else "cuda"
    if args.raw:
        vol = load_raw_volume(args.raw, tuple(args.shape), device=dev)
    else:
        n = args.vol_res
        xs = np.linspace(-1, 1, n, dtype=np.float32)
        g = np.meshgrid(xs, xs, xs, indexing="ij")
        r = np.sqrt(sum(x * x for x in g))
        vol = torch.from_numpy(np.clip(
            0.8 / (1.0 + np.exp((r - 0.55) * 20.0))
            + 0.3 * ((r > 0.62) & (r < 0.7)), 0, 1).astype(np.float32)
        ).to(dev)
    cfg = RenderConfig(volume_shape=tuple(vol.shape),
                       image_shape=(args.res, args.res))
    tf = get_tf(args.tf, cfg.tf_resolution, device=dev)
    occ = build_occupancy(vol, tf, cfg)

    def render_at(angle: float) -> torch.Tensor:
        lf = in_circles(angle, device=dev)
        return render_nondiff(vol, tf, lf, cfg,
                              sampling_rate=args.sampling_rate,
                              occupancy=occ).image

    return render_at, f"vol {tuple(vol.shape)}, image {cfg.image_shape}"


def run(args):
    """``max(--frames, 1)`` frames without the server, at the angles the
    page's ``d`` key steps through (0, 0.15, ...): ``{"frames": [(H, W,
    4)]}``."""
    render_at, _ = viewer(args)
    return {"frames": [render_at(0.15 * i)
                       for i in range(max(args.frames, 1))]}


def frame_png(image) -> bytes:
    """A rendered (H, W, 4) frame as the PNG the server sends (PIL)."""
    from PIL import Image
    img = image.cpu().numpy()
    rgb = (np.clip(img[..., :3], 0, 1) * 255 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return buf.getvalue()


def main(argv=None):
    args = parser().parse_args(argv)
    render_at, what = viewer(args)
    served = [0]
    lock = threading.Lock()

    def render_frame(angle: float) -> bytes:
        with lock:
            img = render_at(angle)
            served[0] += 1
        return frame_png(img)

    httpd = ThreadingHTTPServer(("127.0.0.1", args.port),
                                make_handler(render_frame))
    print(f"orbit viewer on http://127.0.0.1:{args.port}/ ({what})",
          flush=True)
    if args.frames:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        while served[0] < args.frames:
            time.sleep(0.2)
        httpd.shutdown()
        print(f"served {served[0]} frames, exiting")
    else:
        httpd.serve_forever()


if __name__ == "__main__":
    main()
