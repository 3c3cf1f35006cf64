"""The torch port stands alone: no JAX, no JAX package, lazy kernels, the
config's accepted and refused fields, and the device rule."""
import ast
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch.render import _MarchArgs, _MarchBwdArgs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "differender_tpu_torch")


def _port_files():
    # The parallel tests' rank processes import torch_port_ranks alone.
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_port_ranks.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_leaves_jax_out():
    code = ("import sys, differender_tpu_torch\n"
            "import differender_tpu_torch.occupancy\n"
            "import differender_tpu_torch.ops.bricks\n"
            "import differender_tpu_torch.ops.distance\n"
            "import differender_tpu_torch.ops.shear_warp\n"
            "import differender_tpu_torch.fastpath\n"
            "import differender_tpu_torch.parallel\n"
            "import differender_tpu_torch.parallel.data_parallel\n"
            "import differender_tpu_torch.parallel.train_step\n"
            "import differender_tpu_torch.parallel.volume_sharding\n"
            "import differender_tpu_torch.parallel._collectives\n"
            "import differender_tpu_torch.io\n"
            "import differender_tpu_torch.profiling\n"
            "import differender_tpu_torch.video\n"
            "import differender_tpu_torch.plotting\n"
            "import differender_tpu_torch.torch_interop\n"
            "import differender_tpu_torch.examples.render_nondiff\n"
            "import differender_tpu_torch.examples.optimize_tf\n"
            "import differender_tpu_torch.examples.optimize_tf_torch\n"
            "import differender_tpu_torch.examples.optimize_volume\n"
            "import differender_tpu_torch.examples.interactive_viewer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'matplotlib')]\n"
            "assert not bad, bad\n"
            "assert differender_tpu_torch._build.library.cache_info()"
            ".currsize == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'differender_tpu', 'experiments')]\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "differender_tpu",
                                           "experiments"), (path, m)


def test_cpu_tensors_never_launch():
    P.reset_launch_counts()
    vol = torch.rand((6, 7, 8), generator=torch.Generator().manual_seed(0))
    cfg = P.RenderConfig(volume_shape=(6, 7, 8), image_shape=(4, 5),
                         tf_resolution=16, max_samples=8)
    tf = P.get_tf("tf1", 16, device="cpu")
    lf = torch.tensor([1.2, 0.8, 2.0])
    vol.requires_grad_(True)
    tf.requires_grad_(True)
    P.render(vol, tf, lf, cfg).image.sum().backward()
    P.render_nondiff(vol, tf, lf, cfg)
    P.tf_lookup(tf, torch.rand(10)).sum().backward()
    P.build_occupancy(vol, tf, cfg)
    P.brick_sums(torch.rand((33, 32, 34)),
                 torch.tensor([[0, 0, 0], [1, 0, 2]], dtype=torch.int32))
    P.brick_rows(vol, torch.zeros(2, dtype=torch.int32))
    P.cell_distance(*P.cell_minmax(vol, 2), tf.detach(), 0.0, 3)
    lf_cam = lf.clone().requires_grad_(True)
    P.render(vol, tf, lf_cam, cfg).image.sum().backward()
    rays = P.make_rays(lf_cam, cfg, 1.0)
    padded = P.parallel.pad_halos(vol, 0, 2)
    acc, _ = P.parallel.segment_march(padded, tf, rays, cfg, 1.0, 0, 2, 8)
    acc.sum().backward()
    assert lf_cam.grad is not None
    P.march_segment_bwd(padded, tf, rays, cfg, 1.0, 0, 2, 8, acc,
                        torch.ones_like(acc))
    P.render_fast(vol, tf, lf, cfg, intermediate=6,
                  planes_per_voxel=1.0).image.sum().backward()
    assert P.launch_counts() == {"tf_lookup_fwd": 0, "tf_lookup_bwd": 0,
                                 "march_diff_fwd": 0, "march_diff_bwd": 0,
                                 "march_nondiff": 0, "brick_sums": 0,
                                 "brick_rows": 0, "cell_minmax": 0,
                                 "cell_distance": 0, "march_segment_fwd": 0,
                                 "march_segment_bwd": 0, "shear_warp_fwd": 0,
                                 "shear_warp_bwd": 0}
    assert P.march_diff_bwd.camera_launches == 0
    assert P.march_segment_bwd.camera_launches == 0


@pytest.mark.parametrize("field", ["analytic_normals", "camera_grads"])
def test_unported_fields_raise(field):
    """No field raises any more: the last two that did, the analytic
    normals and the camera gradients, are ported."""
    cfg = P.RenderConfig(volume_shape=(4, 4, 4), image_shape=(2, 2),
                         **{field: True})
    assert getattr(cfg, field) is True


def test_tpu_knobs_accepted():
    knobs = dict(block_size=8, unroll=2, cell_gather=False,
                 march_table="flat", super64_max_bytes=1, march_vjp="sorted",
                 vjp_tile=8, vjp_box=16, vjp_box_rows=4, vjp_window_rows=2,
                 vjp_check=True, occupancy_skip=False, occupancy_cell=4,
                 occupancy_max_dist=3, nondiff_compaction=False,
                 compaction_min=16, occupancy_jump_every=2,
                 ert_block_skip=False, compact_after=1, compact_prefix=0.5)
    cfg = P.RenderConfig(volume_shape=(4, 5, 6), image_shape=(3, 2), **knobs)
    assert cfg.replace(max_samples=7).max_samples == 7
    assert cfg.diff_march_steps(1.0) == min(512, cfg.max_steps_for(1.0))


def test_meta_tensors_are_refused():
    """The device rule has no fallback: a tensor that is neither on the CPU
    nor on a CUDA card raises instead of being moved."""
    with pytest.raises(ValueError, match="device"):
        P.tf_lookup(torch.zeros((4, 4), device="meta"),
                    torch.zeros(3, device="meta"))


def test_march_args_mirror_the_c_struct():
    """The ctypes mirror lists the fields of ``struct MarchArgs`` in order,
    so the kernel reads each argument where Python wrote it."""
    with open(os.path.join(PKG, "csrc", "march_common.cuh")) as f:
        src = f.read()
    body = re.search(r"struct MarchArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = re.findall(r"(\w+)\s*[,;]", body)
    assert c_fields == [name for name, _ in _MarchArgs._fields_]
    # 16 pointers, 17 ints and 20 floats, then 4 bytes of tail padding to
    # the pointers' 8-byte alignment (as the C compiler lays it out).
    assert ctypes.sizeof(_MarchArgs) == 16 * 8 + 17 * 4 + 20 * 4 + 4
    for name in ("occ", "occ_far", "counts", "nx", "ny", "nz", "cell",
                 "jump_every", "cell_world", "sc_x", "sc_y", "sc_z",
                 "analytic"):
        assert name in c_fields
    # The segment instantiations' fields come last.
    assert c_fields[-6:] == ["s_lo", "length", "x_start", "Xp", "x_lo",
                             "x_hi"]


def test_march_bwd_args_mirror_the_c_struct():
    """K2's argument struct wraps K1's and adds four pointers, in order."""
    with open(os.path.join(PKG, "csrc", "march_bwd.cu")) as f:
        src = f.read()
    body = re.search(r"struct MarchBwdArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = re.findall(r"(\w+)\s*[,;]", body)
    assert c_fields == [name for name, _ in _MarchBwdArgs._fields_]
    assert ctypes.sizeof(_MarchBwdArgs) == ctypes.sizeof(_MarchArgs) + 4 * 8


def test_build_is_lazy_and_keyed_on_sources():
    from differender_tpu_torch import _build
    h = _build.source_hash()
    assert re.fullmatch(r"[0-9a-f]{16}", h)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library.cache_info().currsize == 0
    for name in ("march_bwd.cu", "march_common.cuh", "bricks.cu",
                 "distance.cu", "shear_warp.cu"):
        assert name in _build._SOURCES + _build._HEADERS


def test_state_from_numpy_layouts():
    rng = np.random.default_rng(0)
    vol = rng.random((1, 3, 4, 5), np.float32)
    tf = rng.random((4, 8), np.float32)
    v, t, lf = P.state_from_numpy(vol, tf, [1, 2, 3], layout="reference",
                                  device="cpu")
    assert v.shape == (1, 3, 4, 5) and t.shape == (4, 8)
    assert v.dtype == t.dtype == lf.dtype == torch.float32
    assert v.is_contiguous() and np.array_equal(v.numpy(), vol)
    with pytest.raises(ValueError):
        P.state_from_numpy(vol, tf, [1, 2, 3], layout="internal",
                           device="cpu")
    with pytest.raises(ValueError):
        P.state_from_numpy(vol[0], tf.T, [1, 2, 3], layout="bogus",
                           device="cpu")
