"""The kernel-launch protocol of ``differender_tpu_torch._build``: the
``launch`` block (its ``dr.launch.<kernel>`` span, its count and tallies in
the one table of ``launch_counts``), ``call`` against a stand-in for the
kernel library, the operand checks, and a scan of the package that holds
every launched name to ``_build.KERNELS``.  Runs on the CPU; imports no
JAX::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_launch.py
"""
import ast
import os

import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch import _build

PKG = os.path.dirname(os.path.abspath(P.__file__))


class _Entry:
    def __init__(self, status):
        self.status, self.calls = status, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.status


class _Library:
    """Stands in for the ctypes library: one entry ``dr_fake`` returning
    ``status``, and CUDA's error strings."""

    def __init__(self, status):
        self.dr_fake = _Entry(status)

    @staticmethod
    def dr_error_string(code):
        return f"stand-in error {code}".encode()


@pytest.fixture
def library(monkeypatch):
    def use(status):
        lib = _Library(status)
        monkeypatch.setattr(_build, "library", lambda: lib)
        monkeypatch.setattr(_build, "stream_of", lambda t: 7)
        P.reset_launch_counts()
        return lib
    return use


def _zero(counts, *but):
    return all(n == 0 for k, n in counts.items() if k not in but)


def test_a_launch_counts_its_kernel_once_and_adds_its_tallies(library):
    lib = library(0)
    like = torch.zeros(4)
    with _build.launch("march_diff_bwd", camera=True, tf_only=False):
        _build.call("dr_fake", 3, 5, like=like)
    assert lib.dr_fake.calls == [(3, 5, like.device.index, 7)]
    with _build.launch("march_nondiff", views=6):
        pass
    _build.count("march_nondiff.views", 2)
    counts = P.launch_counts()
    assert counts["march_diff_bwd"] == counts["march_diff_bwd.camera"] == 1
    assert counts["march_nondiff"] == 1
    assert counts["march_nondiff.views"] == 8
    assert _zero(counts, "march_diff_bwd", "march_diff_bwd.camera",
                 "march_nondiff", "march_nondiff.views")


def test_a_failed_call_raises_with_the_entry_name_and_counts_nothing(
        library):
    library(700)
    with pytest.raises(RuntimeError, match="dr_fake.*700.*stand-in error"):
        with _build.launch("march_diff_bwd", camera=1):
            _build.call("dr_fake", like=torch.zeros(1))
    with pytest.raises(TypeError):
        with _build.launch("tf_lookup_fwd"):
            _build.operand("tf", torch.zeros(2, dtype=torch.int32),
                           torch.device("cpu"))
    assert _zero(P.launch_counts())


@pytest.mark.parametrize("kernel, tallies", [
    ("march_diff", {}), ("march_nondiff", {"camera": 1}),
    ("march_diff_bwd.camera", {})])
def test_an_unknown_kernel_or_tally_raises_before_the_block(kernel, tallies):
    P.reset_launch_counts()
    ran = []
    with pytest.raises(ValueError):
        with _build.launch(kernel, **tallies):
            ran.append(1)
    with pytest.raises(KeyError):
        _build.count(kernel + ".x")
    assert not ran and _zero(P.launch_counts())


def test_reset_zeroes_every_key():
    for key in _build.KERNELS + _build.TALLIES:
        _build.count(key, 3)
    P.reset_launch_counts()
    counts = P.launch_counts()
    assert sorted(counts) == sorted(_build.KERNELS + _build.TALLIES)
    assert len(counts) == 18 and _zero(counts)


def test_the_span_is_dr_launch_kernel():
    P.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with _build.launch("cell_minmax"):
            torch.zeros(3).sum()
    names = [e.name for e in prof.events()]
    assert names.count("dr.launch.cell_minmax") == 1
    assert not [n for n in names if n.startswith("dr.launch.")
                and n != "dr.launch.cell_minmax"]
    assert P.launch_counts()["cell_minmax"] == 1


def _package_calls(name):
    """``(path, call)`` of every call of ``name`` (bare or as an attribute)
    in the package's Python."""
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    fn = node.func
                    called = (fn.attr if isinstance(fn, ast.Attribute)
                              else getattr(fn, "id", None))
                    if called == name:
                        yield path, node


def test_every_launched_name_is_a_kernel_and_every_kernel_is_launched():
    launched = set()
    for path, call in _package_calls("launch"):
        arg = call.args[0]
        assert isinstance(arg, ast.Constant), (path, call.lineno)
        assert arg.value in _build.KERNELS, (path, arg.value)
        for kw in call.keywords:
            assert f"{arg.value}.{kw.arg}" in _build.TALLIES, (path, kw.arg)
        launched.add(arg.value)
    assert launched == set(_build.KERNELS)
    for path, call in _package_calls("count"):
        if os.path.basename(path) != "_build.py" and call.args and \
                isinstance(call.args[0], ast.Constant):
            assert call.args[0].value in _build.TALLIES, (path, call.lineno)
    for path, call in _package_calls("span"):
        arg = call.args[0]
        assert not (isinstance(arg, ast.Constant)
                    and arg.value.startswith("dr.launch.")), path


@pytest.mark.parametrize("case", ["misaligned", "strided", "aligned",
                                  "wildcard"])
def test_operand_returns_a_contiguous_aligned_equal_tensor(case):
    base = torch.arange(40, dtype=torch.float32, requires_grad=True)
    t = {"misaligned": base[1:33].reshape(8, 4),
         "strided": base[:32].reshape(4, 8).t(),
         "aligned": base[:32].reshape(8, 4),
         "wildcard": base[:32].reshape(8, 4)}[case]
    shape = (None, 4) if case == "wildcard" else tuple(t.shape)
    got = _build.operand("x", t, t.device, shape)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, t) and not got.requires_grad
    assert (got.data_ptr() == t.data_ptr()) == (case in ("aligned",
                                                        "wildcard"))


@pytest.mark.parametrize("case, error", [
    ("dtype", TypeError), ("device", ValueError), ("shape", ValueError),
    ("rank", ValueError)])
def test_operand_refuses_a_wrong_dtype_device_or_shape(case, error):
    t = torch.zeros((8, 4))
    args = {"dtype": (t.int(), "cpu", (8, 4)),
            "device": (t, torch.device("cuda", 0), (8, 4)),
            "shape": (t, "cpu", (None, 3)),
            "rank": (t, "cpu", (8, 4, 1))}[case]
    with pytest.raises(error):
        _build.operand("x", args[0], torch.device(args[1]), args[2])


def test_output_is_checked_and_never_copied():
    counts = torch.zeros((3, 5, 2), dtype=torch.int32)
    assert _build.output("counts", counts, counts.device, (3, 5, 2)) \
        is counts
    assert _build.output("counts", None, counts.device, (3, 5, 2)) is None
    with pytest.raises(ValueError):
        _build.output("counts", counts.transpose(0, 1), counts.device,
                      (5, 3, 2))
    with pytest.raises(TypeError):
        _build.output("sums", counts, counts.device, (3, 5, 2),
                      torch.float32)
