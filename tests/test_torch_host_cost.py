"""The host-cost tool (``mri_interpolation_tpu_torch.host_cost``) on the CPU:
every timed call runs (there, through the plain versions) and gives a
finite result of the wrapper's shape; the timing itself runs only on the
card."""

import pytest
import torch

from mri_interpolation_tpu_torch import host_cost


def test_every_timed_call_runs_on_one_row():
    calls = host_cost.calls_to_time(torch.device("cpu"))
    assert len(calls) == 5
    for name, fn in calls.items():
        out = fn()
        tensors = [*out[0], *out[1], out[2]] if isinstance(out, tuple) else [out]  # the backward: (dWs, dbs, dx)
        assert tensors and all(t.shape[0] >= 1 and bool(torch.isfinite(t).all()) for t in tensors), name


def test_runs_only_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host_cost.run(calls=1, repeats=1)
