"""The host-cost tool (``mri_interpolation_tpu_torch.host_cost``) on the CPU:
every timed call runs (there, through the plain versions) and gives a
finite result of the wrapper's shape; the timing itself runs only on the
card."""

import pytest
import torch

from mri_interpolation_tpu_torch import host_cost


def test_every_timed_call_runs_on_one_row():
    calls = host_cost.calls_to_time(torch.device("cpu"))
    assert len(calls) == 6
    for name, fn in calls.items():
        out = fn()
        tensors = [*out[0], *out[1], out[2]] if isinstance(out, tuple) else [out]  # the backward: (dWs, dbs, dx)
        assert tensors and all(t.shape[0] >= 1 and bool(torch.isfinite(t).all()) for t in tensors), name


def test_runs_only_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host_cost.run(calls=1, repeats=1)


def test_calls_of_another_checkout(tmp_path):
    """``import_checkout`` imports another checkout's package under another
    name, and ``calls_to_time(dev, package)`` times its wrappers: here a
    stand-in checkout whose modules re-export this package's, so both give
    the same results."""
    root = tmp_path / "mri_interpolation_tpu_torch"
    for sub, text in (("", ""), ("encodings", "from mri_interpolation_tpu_torch.encodings import HashGridEncoding\n"),
                      ("ops", "")):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / "__init__.py").write_text(text)
    for name in ("fused_mlp", "hash_encode"):
        (root / "ops" / f"{name}.py").write_text(f"from mri_interpolation_tpu_torch.ops.{name} import *  # noqa\n")
    package = host_cost.import_checkout(str(tmp_path), "stand_in_checkout")
    assert package.__name__ == "stand_in_checkout"
    theirs = host_cost.calls_to_time(torch.device("cpu"), package)
    mine = host_cost.calls_to_time(torch.device("cpu"))
    assert list(theirs) == list(mine)
    for name in mine:
        a, b = mine[name](), theirs[name]()
        flat = (lambda out: [*out[0], *out[1], out[2]] if isinstance(out, tuple) else [out])  # noqa: E731
        assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b))), name


def test_layer_calls_on_the_cpu(monkeypatch):
    """The layered breakdown's op and wrapper calls run on the CPU (the plain
    versions, equal to each other); its ctypes and CUDA-impl calls build the
    kernels or raise, never taking the plain version."""
    from mri_interpolation_tpu_torch.ops import build

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    calls = host_cost.layer_calls(torch.device("cpu"))
    assert len(calls) == 11
    for name, fn in calls.items():
        if name.endswith(("op", "wrapper")):
            out = fn()
            assert (out[-1] if isinstance(out, (tuple, list)) else out).shape[0] >= 1, name  # dx: the backward's last
        else:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                fn()
    assert torch.equal(calls["k5 B: op"](), calls["k5 B: wrapper"]())
