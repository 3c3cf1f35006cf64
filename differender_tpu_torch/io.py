"""Volume IO and checkpointing (counterpart of ``differender_tpu/io.py``).

* :func:`load_raw_volume`: the reference's skull.raw recipe, uint8 ->
  reshape -> ``swapaxes(0, 1)`` -> f32 / 255.  The bytes are read with
  numpy and widened on the device: an f32 division there is correctly
  rounded, so the volume equals the JAX package's bitwise.
* :func:`load_nifti`: a dependency-free NIfTI-1 reader (.nii / .nii.gz),
  parsed on the host as the JAX package parses it, then moved to the
  device.
* :func:`save_checkpoint` / :func:`load_checkpoint`: the JAX package's
  payload, a pickle of ``{"step", "state"}`` with every tensor as a numpy
  array.  No torch object is pickled, so a file that either package writes
  from plain containers, numbers and arrays loads in the other.
  :func:`checkpoint_tensors` turns a loaded state back into tensors.
"""
from __future__ import annotations

import gzip
import os
import pickle
from typing import Any, Optional, Tuple

import numpy as np
import torch


def load_raw_volume(path: str, shape: Tuple[int, int, int], dtype=np.uint8,
                    swap_axes=(0, 1), normalize: bool = True,
                    device="cuda") -> torch.Tensor:
    """Read a raw binary volume of ``shape`` and ``dtype`` into a contiguous
    f32 tensor on ``device``: integers divided by their dtype's max (with
    ``normalize``), then ``swap_axes`` swapped.  Raises ``ValueError`` where
    the file does not hold ``prod(shape)`` voxels."""
    dtype = np.dtype(dtype)
    raw = np.fromfile(path, dtype=dtype)
    n = int(np.prod(shape))
    if raw.size != n:
        raise ValueError(f"{path}: expected {n} voxels for shape {shape}, "
                         f"got {raw.size}")
    raw = raw.reshape(shape)
    # Unsigned types that torch does not compute with travel widened
    # (exactly) to a signed one.
    if dtype in (np.uint16, np.uint32):
        raw = raw.astype(np.int32 if dtype == np.uint16 else np.int64)
    vol = torch.from_numpy(raw).to(device).to(torch.float32)
    if normalize:
        top = float(np.iinfo(dtype).max) if np.issubdtype(dtype, np.integer) \
            else 1.0
        # A divisor on the device: a scalar one may become a product by its
        # reciprocal, which rounds differently.
        vol = vol / torch.tensor(top, dtype=torch.float32, device=vol.device)
    if swap_axes is not None:
        vol = vol.swapaxes(*swap_axes)
    return vol.contiguous()


# NIfTI-1 datatype codes -> numpy dtypes (the common subset).
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}


def load_nifti(path: str, normalize: bool = True,
               device="cuda") -> torch.Tensor:
    """Read a NIfTI-1 volume (.nii or .nii.gz) into an f32 (X, Y, Z) tensor
    on ``device``: the 348-byte header in either byte order, the
    ``scl_slope``/``scl_inter`` transform, Fortran order, a trailing frame
    of 1 squeezed and, with ``normalize``, min-max scaling to [0, 1].
    Refuses detached headers (``ni1``) and unknown datatypes."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    if len(data) < 352:
        raise ValueError(f"{path}: too small for a NIfTI-1 header")
    for end in ("<", ">"):
        if int(np.frombuffer(data, f"{end}i4", 1, 0)[0]) == 348:
            break
    else:
        raise ValueError(f"{path}: bad sizeof_hdr (not NIfTI-1)")
    magic = data[344:348]
    if magic[:3] == b"ni1":
        raise ValueError(
            f"{path}: detached-header NIfTI (.hdr/.img pair, magic 'ni1') "
            "— voxels live in the sibling .img file; convert to a "
            "single-file .nii or pass the data through load_raw_volume")
    if magic[:3] != b"n+1":
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    dim = np.frombuffer(data, f"{end}i2", 8, 40)
    ndim = int(dim[0])
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = int(np.frombuffer(data, f"{end}i2", 1, 70)[0])
    if datatype not in _NIFTI_DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(end)
    vox_offset = int(np.frombuffer(data, f"{end}f4", 1, 108)[0])
    scl_slope = float(np.frombuffer(data, f"{end}f4", 1, 112)[0])
    scl_inter = float(np.frombuffer(data, f"{end}f4", 1, 116)[0])
    n = int(np.prod(shape))
    vol = np.frombuffer(data, dt, n, vox_offset).astype(np.float32)
    vol = vol.reshape(shape, order="F")          # x fastest
    while vol.ndim > 3 and vol.shape[-1] == 1:
        vol = vol[..., 0]
    if vol.ndim != 3:
        raise ValueError(f"{path}: expected a 3D volume, got shape {shape}")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        vol = vol * slope + scl_inter
    if normalize:
        lo, hi = float(vol.min()), float(vol.max())
        vol = (vol - lo) / (hi - lo) if hi > lo else np.zeros_like(vol)
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    return torch.from_numpy(vol).to(device)


def _to_numpy(tree):
    """``tree`` with every tensor as a numpy array, walking dicts, lists and
    tuples; any other torch object raises."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_to_numpy(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if type(tree).__module__.split(".")[0] == "torch":
        raise TypeError(f"a checkpoint holds no torch object; got "
                        f"{type(tree).__name__} (pass its state: a "
                        f"Generator's get_state(), an optimizer's "
                        f"state_dict())")
    return tree


def save_checkpoint(path: str, state: Any, step: Optional[int] = None):
    """Pickle ``{"step": step, "state": state}`` to ``path`` (written to
    ``path + ".tmp"`` and renamed), every tensor of ``state`` as a numpy
    array.  The state may hold tensors on any device, numbers, strings and
    numpy arrays in dicts, lists and tuples: an optimizer's
    ``state_dict()`` and a ``torch.Generator``'s ``get_state()`` among
    them.  A file of the JAX package loads here where it holds such things
    alone; one with optax state needs optax to unpickle."""
    payload = {"step": step, "state": _to_numpy(state)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """``(state, step)`` of a checkpoint, its arrays as numpy (unpickles
    the file: load only files that you trust)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return payload["state"], payload["step"]


def checkpoint_tensors(tree, device="cpu"):
    """A loaded state with every numpy array as a tensor on ``device``
    (numpy scalars as Python numbers), walking dicts, lists and tuples."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, np.generic):
        return tree.item()
    if isinstance(tree, dict):
        return {k: checkpoint_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [checkpoint_tensors(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


__all__ = ["load_raw_volume", "load_nifti", "save_checkpoint",
           "load_checkpoint", "checkpoint_tensors"]
