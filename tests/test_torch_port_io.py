"""The port's volume IO and checkpoints (``differender_tpu_torch.io``)
against the JAX package's ``io`` on the same files.

Raw volumes load bitwise equal to the JAX package's (its numpy path, and
its native table where the extension is built: both divide in f32, which
the port does on the tensor's device); NIfTI files are built as
``tests/test_io.py`` builds them and load equal to JAX's reader, or raise
its errors; checkpoints written by either package load in the other.
"""
import gzip

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from differender_tpu import io as JIO
from differender_tpu_torch import io as PIO


def _raw(tmp_path, data, name="vol.raw"):
    p = tmp_path / name
    p.write_bytes(data.tobytes())
    return str(p)


def test_raw_uint8_matches_jax(tmp_path):
    """Every byte value, in the skull.raw recipe (swap of axes 0 and 1)."""
    rng = np.random.default_rng(0)
    data = np.concatenate([np.arange(256, dtype=np.uint8),
                           rng.integers(0, 256, 8 * 9 * 10 - 256,
                                        dtype=np.uint8)])
    p = _raw(tmp_path, data)
    got = PIO.load_raw_volume(p, (8, 9, 10), device="cpu")
    want = JIO.load_raw_volume(p, (8, 9, 10))
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == want.shape == (9, 8, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    # The table of the native reader, f32(i) / 255 for every byte.
    np.testing.assert_array_equal(
        np.sort(np.unique(got.numpy())),
        np.arange(256, dtype=np.float32) / np.float32(255.0))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.uint32])
def test_raw_wider_integers_match_jax(tmp_path, dtype):
    info = np.iinfo(dtype)
    data = np.random.default_rng(1).integers(
        max(info.min, -(1 << 30)), min(info.max, 1 << 31) + 1, 4 * 5 * 6,
        dtype=np.int64).astype(dtype)
    data[:2] = (info.min, info.max)
    p = _raw(tmp_path, data)
    for swap in ((0, 1), None):
        got = PIO.load_raw_volume(p, (4, 5, 6), dtype=dtype, swap_axes=swap,
                                  device="cpu")
        want = JIO.load_raw_volume(p, (4, 5, 6), dtype=dtype,
                                   swap_axes=swap)
        np.testing.assert_array_equal(got.numpy(), want)


def test_raw_float_without_normalize_matches_jax(tmp_path):
    data = np.random.default_rng(2).random(3 * 4 * 5).astype(np.float32)
    p = _raw(tmp_path, data)
    got = PIO.load_raw_volume(p, (3, 4, 5), dtype=np.float32,
                              normalize=False, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), JIO.load_raw_volume(p, (3, 4, 5), dtype=np.float32,
                                         normalize=False))


def test_raw_size_mismatch_raises(tmp_path):
    p = _raw(tmp_path, np.zeros(10, np.uint8), "short.raw")
    with pytest.raises(ValueError, match="expected 64 voxels"):
        PIO.load_raw_volume(p, (4, 4, 4), device="cpu")


def _make_nifti(vol, path, end="<", datatype=16, slope=1.0, inter=0.0,
                gz=False, magic=b"n+1\x00", frames=None):
    """A NIfTI-1 file as tests/test_io.py builds one (with a trailing frame
    dimension of ``frames`` if given)."""
    hdr = bytearray(352)
    hdr[0:4] = np.array([348], f"{end}i4").tobytes()
    dim = np.zeros(8, f"{end}i2")
    dim[0] = 3 if frames is None else 4
    dim[1:4] = vol.shape
    if frames is not None:
        dim[4] = frames
    hdr[40:56] = dim.tobytes()
    hdr[70:72] = np.array([datatype], f"{end}i2").tobytes()
    hdr[108:112] = np.array([352.0], f"{end}f4").tobytes()
    hdr[112:116] = np.array([slope], f"{end}f4").tobytes()
    hdr[116:120] = np.array([inter], f"{end}f4").tobytes()
    hdr[344:348] = magic
    dt = {2: np.uint8, 4: np.int16, 16: np.float32, 512: np.uint16}[datatype]
    body = np.asfortranarray(vol.astype(np.dtype(dt).newbyteorder(end))
                             ).tobytes(order="F")
    blob = bytes(hdr) + body
    if gz:
        path += ".gz"
        with gzip.open(path, "wb") as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
    return path


NIFTI_CASES = {
    "f32_le": dict(dtype=np.float32, kw=dict()),
    "u8_be_gz": dict(dtype=np.uint8, kw=dict(end=">", datatype=2, gz=True)),
    "i16_slope_inter": dict(dtype=np.int16,
                            kw=dict(datatype=4, slope=0.5, inter=-10.0)),
    "u16_be_frame": dict(dtype=np.uint16,
                         kw=dict(end=">", datatype=512, frames=1)),
}


@pytest.mark.parametrize("case", sorted(NIFTI_CASES))
@pytest.mark.parametrize("normalize", [False, True])
def test_nifti_matches_jax(tmp_path, case, normalize):
    spec = NIFTI_CASES[case]
    vol = (np.random.default_rng(3).random((7, 5, 3)) * 1000 - 200)
    if spec["dtype"] in (np.uint8,):
        vol = np.abs(vol) % 256
    elif spec["dtype"] in (np.uint16,):
        vol = np.abs(vol)
    vol = vol.astype(spec["dtype"])
    p = _make_nifti(vol, str(tmp_path / f"{case}.nii"), **spec["kw"])
    got = PIO.load_nifti(p, normalize=normalize, device="cpu")
    want = JIO.load_nifti(p, normalize=normalize)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["ni1", "garbage", "datatype", "small"])
def test_nifti_refusals_match_jax(tmp_path, kind):
    p = str(tmp_path / f"{kind}.nii")
    vol = np.zeros((2, 2, 2), np.float32)
    if kind == "ni1":
        _make_nifti(vol, p, magic=b"ni1\x00")
    elif kind == "datatype":
        _make_nifti(vol, p)
        with open(p, "r+b") as f:
            f.seek(70)
            f.write(np.array([1024], "<i2").tobytes())
    else:
        with open(p, "wb") as f:
            f.write(b"\x00" * (400 if kind == "garbage" else 100))
    with pytest.raises(ValueError) as want:
        JIO.load_nifti(p)
    with pytest.raises(ValueError) as got:
        PIO.load_nifti(p, device="cpu")
    assert str(got.value) == str(want.value)


def _state_np():
    rng = np.random.default_rng(4)
    return {"volume": rng.random((4, 5, 6), np.float32),
            "tf": rng.random((8, 4), np.float32),
            "nested": {"count": np.asarray(7), "list": [np.ones(3), 2]}}


def test_checkpoint_from_jax_loads_in_port(tmp_path):
    p = str(tmp_path / "jax.pkl")
    state = _state_np()
    JIO.save_checkpoint(p, {"volume": jnp.asarray(state["volume"]),
                            "tf": jnp.asarray(state["tf"]),
                            "nested": state["nested"]}, step=42)
    loaded, step = PIO.load_checkpoint(p)
    assert step == 42
    np.testing.assert_array_equal(loaded["volume"], state["volume"])
    np.testing.assert_array_equal(loaded["tf"], state["tf"])
    assert int(loaded["nested"]["count"]) == 7
    back = PIO.checkpoint_tensors(loaded)
    assert torch.equal(back["volume"], torch.from_numpy(state["volume"]))


def test_checkpoint_from_port_loads_in_jax(tmp_path):
    p = str(tmp_path / "port.pkl")
    state = _state_np()
    PIO.save_checkpoint(p, {"volume": torch.from_numpy(state["volume"]),
                            "tf": torch.from_numpy(state["tf"]),
                            "nested": state["nested"]}, step=3)
    loaded, step = JIO.load_checkpoint(p)
    assert step == 3
    assert isinstance(loaded["volume"], np.ndarray)
    np.testing.assert_array_equal(loaded["volume"], state["volume"])
    np.testing.assert_array_equal(loaded["tf"], state["tf"])
    assert int(loaded["nested"]["count"]) == 7
    assert loaded["nested"]["list"][1] == 2
    assert not (tmp_path / "port.pkl.tmp").exists()


def test_checkpoint_adamw_and_generator_round_trip(tmp_path):
    """An AdamW state and a generator's state survive save and load: the
    restored optimizer and generator continue exactly as the originals."""
    p = str(tmp_path / "opt.pkl")
    w = torch.nn.Parameter(torch.rand(5, generator=torch.Generator()
                                      .manual_seed(0)))
    opt = torch.optim.AdamW([w], lr=1e-2)
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        w.grad = torch.rand(5, generator=gen)
        opt.step()
    PIO.save_checkpoint(p, {"w": w, "opt": opt.state_dict(),
                            "gen": gen.get_state()}, step=3)
    state, step = PIO.load_checkpoint(p)
    assert step == 3
    state = PIO.checkpoint_tensors(state)
    w2 = torch.nn.Parameter(state["w"].clone())
    opt2 = torch.optim.AdamW([w2], lr=1e-2)
    opt2.load_state_dict(state["opt"])
    gen2 = torch.Generator()
    gen2.set_state(state["gen"])
    for _ in range(2):
        g = torch.rand(5, generator=gen)
        assert torch.equal(g, torch.rand(5, generator=gen2))
        w.grad, w2.grad = g, g.clone()
        opt.step()
        opt2.step()
    assert torch.equal(w, w2)


def test_checkpoint_pickles_no_torch_object(tmp_path):
    with pytest.raises(TypeError, match="no torch object"):
        PIO.save_checkpoint(str(tmp_path / "bad.pkl"),
                            {"gen": torch.Generator()})
