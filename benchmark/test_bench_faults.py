"""A broken program reads incorrect. Each case drives a whole run of a tiny
cell (``tiny.py``) on the CPU, the chip check skipped, with a fault planted
under the timed path, and sees ``correct`` come out false; unbroken, the
same run reads correct. The faults are those each cell can have: a fit
step that leaves the state unchanged, and half of each batch left out with
the mean taken over the rest, each in every call of ``Trainer.fit`` and in
the window's call alone (the second, after the warm-up's); a window whose
later steps diverge; a grid answer altered where it is produced, and half
of it left out. (The cells run on one chip: no exchange between chips to
leave out.)"""

import functools
import json

import pytest
import torch

from benchmark import run, spec, tiny
from mri_interpolation_tpu_torch.infer import grid as port_grid
from mri_interpolation_tpu_torch.train import trainer as port_trainer

_ORIGINAL_LOAD = spec.load_cell


def _drive(monkeypatch, capsys, cell):
    monkeypatch.setattr(spec, "load_cell", lambda name, root=spec.ROOT: tiny.shrink(_ORIGINAL_LOAD(name, root)))
    monkeypatch.setattr(run, "require_chips", lambda n: torch.device("cpu"))
    assert run.main(["--workload", cell, "--seed", "2147483659", "--seconds", "0.3", "--trace", "0"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _state_unchanged(monkeypatch):
    step = port_trainer._Updates.step

    def frozen(self):
        held = [p.detach().clone() for p in self.params]
        step(self)
        with torch.no_grad():
            for p, h in zip(self.params, held):
                p.copy_(h)

    monkeypatch.setattr(port_trainer._Updates, "step", frozen)


def _half_batch(monkeypatch):
    step_loss = port_trainer._step_loss

    def half(model, loss_fn, x, y, remat):
        n = x.shape[0] // 2
        return step_loss(model, loss_fn, x[:n], y[:n], remat)

    monkeypatch.setattr(port_trainer, "_step_loss", half)


def _diverges(monkeypatch, after=3):
    step_loss = port_trainer._step_loss
    calls = []

    def diverging(model, loss_fn, x, y, remat):
        calls.append(1)
        loss = step_loss(model, loss_fn, x, y, remat)
        return loss * float("nan") if len(calls) > after else loss

    monkeypatch.setattr(port_trainer, "_step_loss", diverging)


def _window_only(fault):
    """``fault`` planted for the second ``Trainer.fit`` call alone: the
    window's, after the warm-up's."""

    def plant(monkeypatch):
        fit = port_trainer.Trainer.fit
        calls = []

        def second_broken(self, *args, **kwargs):
            calls.append(1)
            if len(calls) != 2:
                return fit(self, *args, **kwargs)
            with pytest.MonkeyPatch.context() as inside:
                fault(inside)
                return fit(self, *args, **kwargs)

        monkeypatch.setattr(port_trainer.Trainer, "fit", second_broken)

    return plant


def _grid_fault(monkeypatch, kind):
    on_device = port_grid._grid_on_device

    def broken(*args, **kwargs):
        y, z = on_device(*args, **kwargs)
        y = y.clone()
        if kind == "altered":
            y[len(y) // 3] += 1e-2 * float(y.abs().max())
        else:
            y[len(y) // 2:] = 0.0
        return y, z

    monkeypatch.setattr(port_grid, "_grid_on_device", broken)


FAULTS = {
    "full4d.fit": {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
                   "window_state_unchanged": _window_only(_state_unchanged),
                   "window_half_batch": _window_only(_half_batch),
                   "window_diverges": _window_only(_diverges)},
    "flagship.interp": {"answer_altered": functools.partial(_grid_fault, kind="altered"),
                        "half_left_out": functools.partial(_grid_fault, kind="half")},
    "full4d.interp": {"answer_altered": functools.partial(_grid_fault, kind="altered"),
                      "half_left_out": functools.partial(_grid_fault, kind="half")},
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_unbroken_reads_correct(cell, monkeypatch, capsys):
    result = _drive(monkeypatch, capsys, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in sorted(FAULTS[c])])
def test_fault_reads_incorrect(cell, fault, monkeypatch, capsys):
    FAULTS[cell][fault](monkeypatch)
    result = _drive(monkeypatch, capsys, cell)
    assert not result["correct"], result["checks"]
