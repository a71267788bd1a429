"""Port parity: the experiment layer (``mri_interpolation_tpu_torch.experiments``)
against ``scripts/experiments.py``, ``scripts/warp_sweep.py``,
``scripts/cache_manifest.py`` and ``scripts/prefill_stacked4d.py``, which are
imported by file path and not edited.

- **The same matrix.** Each subcommand runs in both packages on one small
  synthetic volume with the fits replaced by recorders (``fit_and_eval``,
  ``Trainer``, the protocol functions, the launcher, the stacked protocol,
  ``evaluate_grid``, the traces): the rows' names, their models' parameter
  counts (JAX's through ``jax.eval_shape`` of the init) and every
  ``TrainConfig`` / ``RunConfig`` field are equal, in order.
- **fit_and_eval parity** on a seeded (16, 16, 6) volume for three rows at
  their published widths (the flagship, the tcnn config, siren 352x5): the
  JAX init carried over (``convert.params_from_jax``), batch = n (JAX's
  permutations cannot be drawn in torch), 3 epochs. Tolerances, the
  pipeline's (``test_torch_pipeline.py``): final loss rtol 1e-4, PSNR within
  0.05 dB, SSIM within 5e-3, parameter counts equal.
- **The renderer** on the committed ``results.json``: every table line and
  every section heading as JAX renders them; the title names
  ``out["device"]``; the prose holds none of the TPU claims that the JAX
  renderer states as measured.
- **The CLI**, the roofline's points against ``plan.step_roofline``, the
  microbenches on the CPU, the cache manifest against JAX's.
"""

import dataclasses
import importlib.util
import json
import os
import re
import runpy
import shutil
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mri_interpolation_tpu.launcher as jlauncher
import mri_interpolation_tpu.train.protocols as jprotocols
import mri_interpolation_tpu.train.stacking as jstacking
import mri_interpolation_tpu.utils as jutils
from mri_interpolation_tpu import io as jio
from mri_interpolation_tpu.metrics import param_count as jax_param_count
from mri_interpolation_tpu_torch import io, launcher, plan
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.experiments import (aux, cache_manifest, ceiling, common, full4d, matrix,
                                                     prefill_stacked4d, render, roofline, stacked, warp_sweep)
from mri_interpolation_tpu_torch.experiments.__main__ import main as experiments_main
from mri_interpolation_tpu_torch.metrics import param_count
from mri_interpolation_tpu_torch.train import protocols as tprotocols

REPO = Path(__file__).resolve().parents[1]
VOLUME = (16, 16, 6, 15)  # the sample's axes at 1/22 of its width: slice 3 is a (16, 16, 15) 2-D+t volume
FAKE_Q = {"psnr": 20.0, "ssim": 0.5}
PARITY_ROWS = ("hash_mlp (dense storage)", "hash_mlp (tcnn config)", "siren 352x5")


def load_script(path: Path, name: str):
    """Import a JAX-side script by its file path, with its persistent
    compilation cache (written outside the repository) switched off."""
    saved = jutils.setup_compilation_cache
    jutils.setup_compilation_cache = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        jutils.setup_compilation_cache = saved
    return module


@pytest.fixture(scope="module")
def jexp():
    return load_script(REPO / "scripts" / "experiments.py", "jax_experiments_script")


def jcount(model) -> int:
    return jax_param_count(jax.eval_shape(model.init, jax.random.key(0))[0])


def fields_of(cfg) -> dict:
    return dataclasses.asdict(cfg)


def volume() -> np.ndarray:
    return io.synthetic_volume(VOLUME, seed=11)


def fake_loader(pkg_io):
    vol = volume()

    def load(path, zero_centered=False, slice_axes=None, **kw):
        data = vol[slice_axes] if slice_axes is not None else vol
        return pkg_io.dataset_from_array(data, zero_centered=zero_centered)

    return load


def proto_q():
    return {"odd": dict(FAKE_Q), "full": dict(FAKE_Q), "weights": {"global": {}},
            "uncertainty": {"calibration": {}}, "recon": dict(FAKE_Q), "zero_filled": dict(FAKE_Q)}


class Recorder:
    """Stand-ins for every fit of one package, appending what each was given."""

    def __init__(self, count, params_of=lambda model: None):
        self.count = count
        self.events = []
        self.models = {}
        outer = self

        class FakeTrainer:
            def __init__(self, cfg, **kw):
                self.cfg = cfg

            def fit(self, model, coords, values, **kw):
                outer.events.append(("fit", outer.count(model), fields_of(self.cfg), np.shape(coords)))
                return types.SimpleNamespace(steady_steps_per_sec=100.0, final_loss=0.0, params=None, state=None)

            def fit_frames(self, model, coords, values, **kw):
                outer.events.append(("fit_frames", outer.count(model), fields_of(self.cfg), np.shape(coords),
                                     np.shape(values)))
                return types.SimpleNamespace(steady_steps_per_sec=1.0, final_loss=0.0, params=params_of(model),
                                             state=None)

        self.Trainer = FakeTrainer

    def fit_and_eval(self, name, model, cfg, ds, lo=0.0, data_range=1.0, device=None):
        self.events.append(("fit_and_eval", name, self.count(model), fields_of(cfg), lo, data_range))
        self.models[name] = (model, cfg, lo, data_range)
        return {"name": name, "psnr": 20.0}

    def evaluate_grid(self, model, *args, **kw):
        shape = next(a for a in args if isinstance(a, tuple))
        return np.zeros(shape, np.float32)

    def even_frame_fit_eval(self, model, img, cfg, **kw):
        self.events.append(("even_frame", self.count(model), fields_of(cfg)))
        return None, proto_q()

    def ensembled_warp_fit_eval(self, make_model, img, cfg, seeds=(1337, 7, 23, 99), linear_blend=0.0, **kw):
        try:
            model = make_model(seeds[0])
        except TypeError:  # the JAX factory takes no seed
            model = make_model()
        self.events.append(("ensemble", self.count(model), fields_of(cfg), tuple(seeds), linear_blend))
        return proto_q()

    def registration_interp_eval(self, img, **kw):
        kw.pop("device", None)
        self.events.append(("registration", kw))
        return None, proto_q()

    def two_phase_hash_fit(self, model, coords, values, shape, pretrain_config=None, train_config=None,
                           between_phases=None, **kw):
        self.events.append(("two_phase", self.count(model), tuple(shape), fields_of(pretrain_config),
                            fields_of(train_config)))
        if between_phases is not None:
            between_phases(model)
        res = types.SimpleNamespace(params=None, state=None)
        return res, res

    def undersampled_fit_eval(self, model, img, percentage, config, **kw):
        self.events.append(("undersample", self.count(model), percentage, fields_of(config)))
        return None, proto_q()

    def launcher_run(self, cfg, *args, **kw):
        fields = {k: v for k, v in fields_of(cfg).items() if k not in ("image_path", "output_root")}
        fields["interp_shapes"] = [tuple(s) for s in fields["interp_shapes"]]
        self.events.append(("launcher", fields, os.path.basename(cfg.output_root)))
        return {"psnr": 20.0, "ssim": 0.5, "steady_steps_per_sec": 1.0}

    def stacked_interp_eval(self, img, cfg, families=None, **kw):
        kw.pop("device", None)
        self.events.append(("stacked", img.shape, fields_of(cfg), sorted(families) if families else None, kw))
        return None, proto_q()

    def capture_trace(self, fn, outdir, *args, **kw):
        self.events.append(("trace", os.path.basename(outdir)))


@pytest.fixture
def recorded(jexp, monkeypatch, tmp_path):
    """The JAX script's and the port's subcommands, each fit recorded."""
    monkeypatch.chdir(tmp_path)
    j = Recorder(jcount, lambda model: jax.eval_shape(model.init, jax.random.key(0))[0])
    t = Recorder(param_count)
    j.real = {name: getattr(jexp, name) for name in ("fit_and_eval", "Trainer", "evaluate_grid")}
    t.real = {"fit_and_eval": common.fit_and_eval}
    for name in ("fit_and_eval", "Trainer", "evaluate_grid", "even_frame_fit_eval", "undersampled_fit_eval"):
        monkeypatch.setattr(jexp, name, getattr(j, name))
    monkeypatch.setattr(jexp, "load_volume", fake_loader(jio))
    for name in ("ensembled_warp_fit_eval", "registration_interp_eval", "two_phase_hash_fit"):
        monkeypatch.setattr(jprotocols, name, getattr(j, name))
    monkeypatch.setattr(jutils, "capture_trace", j.capture_trace)
    monkeypatch.setattr(jlauncher, "run", j.launcher_run)
    monkeypatch.setattr(jstacking, "stacked_interp_eval", j.stacked_interp_eval)

    monkeypatch.setattr(common, "fit_and_eval", t.fit_and_eval)
    monkeypatch.setattr(common, "load_volume", fake_loader(io))
    for module in (matrix, aux, full4d, roofline):
        for name in ("Trainer", "evaluate_grid", "even_frame_fit_eval", "ensembled_warp_fit_eval",
                     "registration_interp_eval", "capture_trace", "two_phase_hash_fit", "undersampled_fit_eval"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, getattr(t, name))
    monkeypatch.setattr(launcher, "run", t.launcher_run)
    monkeypatch.setattr(stacked, "stacked_interp_eval", t.stacked_interp_eval)
    return j, t


def run_both(jexp, recorded, subcommand, k, **kw):
    j, t = recorded
    jout, tout = {}, {}
    getattr(jexp, subcommand)(jout, k, **kw)
    port = {"run_2dt": matrix.run_2dt, "run_aux": aux.run_aux, "run_ceiling": ceiling.run_ceiling,
            "run_full4d": full4d.run_full4d, "run_stacked": stacked.run_stacked,
            "run_stacked4d": stacked.run_stacked4d}[subcommand]
    extra = {"out_dir": "out"} if subcommand in ("run_2dt", "run_full4d") else {}
    port(tout, k, device="cpu", **extra, **kw)
    return jout, tout


@pytest.mark.parametrize("k", [1.0, 0.02], ids=["full", "k0.02"])
def test_run_2dt_is_the_same_matrix(jexp, recorded, k):
    j, t = recorded
    jout, tout = run_both(jexp, recorded, "run_2dt", k)
    assert t.events == j.events
    assert [r["name"] for r in tout["rows"]] == [r["name"] for r in jout["rows"]] == ROW_NAMES
    assert [p["name"] for p in tout["protocol"]] == [p["name"] for p in jout["protocol"]]
    assert [e[1] for e in t.events if e[0] == "trace"] == ["flagship_dense_f4", "tpu_native_ngp_3l_f8",
                                                            "grid_eval_fastpath"]
    frames = [(row_t, row_j) for row_t, row_j in zip(tout["rows"], jout["rows"]) if "frame encoders" in row_t["name"]]
    assert len(frames) == 2
    for row_t, row_j in frames:  # the rows that fit_frames makes (fit_and_eval's are the recorder's)
        assert row_t["params"] == row_j["params"] > 0
        assert (row_t["epochs"], row_t["batch"]) == (row_j["epochs"], row_j["batch"])


@pytest.mark.parametrize("subcommand, kw", [
    ("run_aux", {}), ("run_ceiling", {}), ("run_full4d", {}),
    ("run_stacked", {}), ("run_stacked", {"anneal": True, "ens_seeds": 8, "spatial": "nested"}),
    ("run_stacked", {"z4d": True, "anneal": True, "robust": "median_nested"}),
    ("run_stacked4d", {}), ("run_stacked4d", {"classical_only": True, "anneal": True}),
], ids=["aux", "ceiling", "full4d", "stacked", "stacked_s8", "stacked_z4d", "stacked4d", "stacked4d_classical"])
@pytest.mark.parametrize("k", [1.0, 0.2], ids=["full", "fast"])
def test_subcommand_is_the_same_matrix(jexp, recorded, subcommand, kw, k):
    j, t = recorded
    jout, tout = run_both(jexp, recorded, subcommand, k, **kw)
    assert t.events and t.events == j.events
    assert json.loads(json.dumps(tout)) == json.loads(json.dumps(jout))


def test_fit_and_eval_matches_jax_on_three_rows(jexp, recorded):
    """The three rows' models from both matrices, the JAX init carried over,
    fitted by both packages' ``fit_and_eval`` on one seeded volume.

    The flagship's decoder feeds each linear layer into a BatchNorm, so those
    layers' biases have a true gradient of zero: each framework's float noise
    (~1e-5 here) is what Adam normalises into full steps of lr, in directions
    of its own, and the running means track those biases. Its loss curve
    holds at rtol 1e-4, but its eval-mode reconstruction differs by 0.10 dB;
    with those two biases and the two running means taken from the JAX fit
    (every other parameter the port's own) it holds at 0.05 dB / 5e-3."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid
    from mri_interpolation_tpu_torch.metrics import evaluate_reconstruction

    j, t = recorded
    run_both(jexp, recorded, "run_2dt", 1.0)
    fits = []

    class Capture(j.real["Trainer"]):
        def fit(self, *args, **kw):
            fits.append(super().fit(*args, **kw))
            return fits[-1]

    jexp.Trainer, jexp.evaluate_grid = Capture, j.real["evaluate_grid"]  # the JAX fit_and_eval reads them here
    vol = io.synthetic_volume((16, 16, 6), seed=5)
    for name in PARITY_ROWS:
        jm, jcfg, lo, dr = j.models[name]
        tm, tcfg, tlo, tdr = t.models[name]
        assert (lo, dr) == (tlo, tdr)
        zero = lo == -1.0
        jds, tds = jio.dataset_from_array(vol, zero_centered=zero), io.dataset_from_array(vol, zero_centered=zero)
        n = len(tds)
        # one batch of the whole set, in order: JAX's permutations cannot be drawn in torch
        jcfg = dataclasses.replace(jcfg, batch_size=n, epochs=3, shuffle=False)
        tcfg = dataclasses.replace(tcfg, batch_size=n, epochs=3, shuffle=False)
        _, k_init = jax.random.split(jax.random.key(jcfg.seed))  # the JAX trainer's init draw
        params, state = jax.device_get(jm.init(k_init))
        tm.load_state_dict(params_from_jax(params, state))
        want = j.real["fit_and_eval"](name, jm, jcfg, jds, lo=lo, data_range=dr)
        got = t.real["fit_and_eval"](name, tm, tcfg, tds, lo=lo, data_range=dr, device="cpu")
        assert got["params"] == want["params"], name
        assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-4), name
        if name == "hash_mlp (dense storage)":
            fitted = params_from_jax(jax.device_get(fits[-1].params), jax.device_get(fits[-1].state))
            with torch.no_grad():
                for key in ("layers.0.b", "layers.1.b", "bn.0.mean", "bn.1.mean"):
                    tm.state_dict()[key].copy_(fitted[key])
            got = evaluate_reconstruction(evaluate_grid(tm, tds.shape, device="cpu"), tds.image(), device="cpu")
        assert abs(got["psnr"] - want["psnr"]) < 0.05, name
        assert abs(got["ssim"] - want["ssim"]) < 5e-3, name


# scripts/experiments.py's row names, letter for letter (run_2dt, :91-243)
ROW_NAMES = [
    "hash_mlp (dense storage)", "hash_mlp (reference hashed)", "hash_mlp (tcnn config)", "siren 352x5",
    "modulated_siren 256x4", "rff_net 256f", "freq_mlp (siren enc)", "gabor 256x4", "hash_mlp (dense, F=4)",
    "hash_mlp (TPU-native NGP: 3L F8 paper+cosine)", "hash_mlp (TPU-native NGP: 3L F4 paper+cosine)",
    "hash_mlp (TPU-native NGP: 3L F2 paper+cosine)", "hash_mlp (dense F=4, decoder=norm_proper)",
    "hash_mlp (dense F=4, decoder=relu_plain)", "mlp 352x8 (test_script config)", "psf_siren 256x5 (5^3 PSF)",
    "hash_siren 64x4 (10L dense)", "multi_siren 128x4 (15 frame encoders)",
    "multi_hash_mlp (15 frame encoders, 10L dense)"]

# fragments of the JAX renderer's prose that state TPU facts as measured (scripts/experiments.py:919,
# :1082-1089, :1333-1342, :1379, :1395); the port's document holds none of them
TPU_PROSE = ["TPU v5e, single chip", "The TPU scatter wall", "XLA scatter-add on this", "f32 MXU",
             "cost on this chip", "transaction on\n TPU", "TPU either direction", "XLA's in-context fused",
             "Profiler traces for the flagship and TPU-native NGP configs", "v5e public peaks"]


def test_renderer_reproduces_every_table_of_the_committed_results(jexp, monkeypatch, tmp_path):
    out = json.loads((REPO / "results.json").read_text())
    monkeypatch.chdir(tmp_path)
    jexp.write_results_md(out)
    want = (tmp_path / "RESULTS.md").read_text().splitlines()
    got = render.render_results_md(out).splitlines()
    tables = lambda lines: [ln for ln in lines if ln.startswith("|")]  # noqa: E731
    headings = lambda lines: [ln for ln in lines if ln.startswith("##")]  # noqa: E731
    assert tables(got) == tables(want) and len(tables(got)) > 60
    assert headings(got) == headings(want) and len(headings(got)) == 6
    assert got[0] == f"# RESULTS — measured quality & throughput ({out['device']})"
    assert want[0].startswith("# RESULTS — measured quality & throughput (")
    text = "\n".join(got)
    prose = "\n".join(ln for ln in got[1:] if not ln.startswith("|"))  # the title names out["device"]
    for fragment in TPU_PROSE:
        assert fragment not in text, fragment
    for word in ("TPU", "MXU", "XLA"):  # "v5e" stays where the dict's chip_peaks name it
        assert not re.search(rf"\b{word}\b", prose), word
    peaks = out["roofline"]["chip_peaks"]
    assert f"by the {peaks['chip']} peaks recorded with the points ({peaks['hbm_gb_per_s']} GB/s HBM," in text
    # the occlusion probe is the port's now
    assert "Reproduce: `python -m mri_interpolation_tpu_torch.experiments.occlusion_probe`." in text
    assert "not yet ported" not in text and "scripts/occlusion_probe.py" not in text


def test_renderer_reads_the_ports_roofline_peaks():
    peaks = {"chip": "h100_sxm", "hbm_gb_per_s": 3350.0, "f32_tflops": 67.0}
    pt = {"batch": 10000, "steady_steps_per_sec": 100.0, "voxel_evals_per_sec": 1e6, "predicted_step_us": 1.0,
          "transaction_floor_us": 2.0, "measured_step_us": 10000.0, "fraction_of_roofline": 0.0001,
          "fraction_of_transaction_roofline": 0.0002, "scatter_layout": "private 0; global 1; split 1"}
    text = render.render_results_md({"device": "NVIDIA H100 80GB HBM3, 700.00 W", "roofline": {
        "gather_ns_per_element": 0.5, "scatter_ns": {"narrow_ns": 1.0, "wide_below_ns": 2.0, "wide_above_ns": 3.0},
        "flagship": [pt], "ngp_f2": [], "chip_peaks": peaks}})
    assert text.splitlines()[0] == "# RESULTS — measured quality & throughput (NVIDIA H100 80GB HBM3, 700.00 W)"
    assert "by the h100_sxm peaks recorded with the points (3350.0 GB/s HBM, 67.0 TFLOP/s f32)" in text
    assert "| flagship | 10,000 | 100.0 | 1,000,000 | 1.0 | 2.0 | 10000.0 | 0.0% | 0% | private 0; global 1; split 1 |" \
        in text
    assert "flagship: 1000.0 -> 1000.0 ns a voxel from batch 10,000 to 10,000" in text


def test_cli_render_only_writes_only_under_out_dir(monkeypatch, tmp_path):
    root = {name: (REPO / name).read_bytes() for name in ("results.json", "RESULTS.md")}
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    shutil.copy(REPO / "results.json", out_dir / "results.json")
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    experiments_main(["--device", "cpu", "--render-only", "--out_dir", str(out_dir)])
    assert sorted(os.listdir(out_dir)) == ["RESULTS.md", "results.json"] and os.listdir(work) == []
    assert (out_dir / "results.json").read_bytes() == root["results.json"]
    assert (out_dir / "RESULTS.md").read_text() == render.render_results_md(json.loads(root["results.json"]))
    assert {name: (REPO / name).read_bytes() for name in root} == root


def test_cli_oracle_without_caches_touches_no_device(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = experiments_main(["--oracle", "--out_dir", "o"])
    assert out == {"fusion_oracles": {}} and sorted(os.listdir("o")) == ["RESULTS.md", "results.json"]


def test_cli_missing_volume_raises_and_names_it(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    missing = str(tmp_path / "no_such_volume.nii.gz")
    for flags in ([], ["--aux"], ["--ceiling"], ["--roofline"], ["--stacked"]):
        if flags == ["--roofline"]:  # the microbenches run before the volume is read: keep them small
            monkeypatch.setattr(roofline, "gather_ns_microbench", lambda device=None: 1.0)
            monkeypatch.setattr(roofline, "scatter_ns_microbench", lambda device=None: {"narrow_ns": 1.0})
        with pytest.raises(FileNotFoundError, match="no_such_volume"):
            experiments_main(["--device", "cpu", "--image_path", missing, "--out_dir", "o", *flags])


def test_cli_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments_main(["--out_dir", "o"])
    assert common.describe_device("cpu") == "cpu"


def test_microbenches_run_on_the_cpu():
    g = roofline.gather_ns_microbench(rows=4096, n_ids=8192, device="cpu")
    s = roofline.scatter_ns_microbench(n_ids=8192, narrow_rows=4096, below_rows=256, device="cpu")
    assert np.isfinite(g) and g > 0
    assert set(s) == {"narrow_ns", "wide_below_ns", "wide_above_ns"}
    assert all(np.isfinite(v) and v > 0 for v in s.values())


def test_roofline_points_are_plan_step_roofline(jexp, recorded, monkeypatch):
    """Every point's numbers from ``plan.step_roofline(chip="h100_sxm")``
    on the same inputs, the peaks from ``plan.CHIPS``; the fits' models and
    configs are JAX's."""
    j, t = recorded
    scatter = {"narrow_ns": 1.5, "wide_below_ns": 2.5, "wide_above_ns": 7.5}
    monkeypatch.setattr(jexp, "_gather_ns_microbench", lambda: 0.75)
    monkeypatch.setattr(jexp, "_scatter_ns_microbench", lambda: dict(scatter))
    monkeypatch.setattr(roofline, "gather_ns_microbench", lambda device=None: 0.75)
    monkeypatch.setattr(roofline, "scatter_ns_microbench", lambda device=None: dict(scatter))
    jout, tout = {}, {}
    jexp.run_roofline(jout, 1.0)
    roofline.run_roofline(tout, 1.0, device="cpu")
    assert t.events == j.events and len(t.events) == 8
    res = tout["roofline"]
    assert res["chip_peaks"] == {"chip": "h100_sxm", "hbm_gb_per_s": 3350.0, "f32_tflops": 67.0}
    assert res["gather_ns_per_element"] == 0.75 and res["scatter_ns"] == scatter
    for cfg_name, mc in roofline.ROOFLINE_CONFIGS.items():
        mc = dict(mc)
        opt = mc.pop("optimizer")
        mc.pop("lr")
        assert [pt["batch"] for pt in res[cfg_name]] == [pt["batch"] for pt in jout["roofline"][cfg_name]]
        for pt in res[cfg_name]:
            rl = plan.step_roofline(dim_in=3, batch_size=pt["batch"], optimizer=opt, chip="h100_sxm",
                                    measured_steps_per_sec=100.0, measured_gather_ns=0.75,
                                    measured_scatter=scatter, **mc)
            assert pt["bytes_per_step"] == rl["bytes_per_step"]["total"]
            assert pt["random_accesses_per_step"] == rl["random_accesses_per_step"]
            assert pt["binding"] == rl["floor_s"]["binding"]
            assert pt["predicted_step_us"] == round(rl["floor_s"]["predicted_step_s"] * 1e6, 1)
            assert pt["transaction_floor_us"] == round(rl["floor_s"]["transaction"] * 1e6, 1)
            assert pt["measured_step_us"] == round(1e6 / 100.0, 1)
            assert pt["fraction_of_roofline"] == round(rl["measured"]["fraction_of_roofline"], 4)
            assert pt["fraction_of_transaction_roofline"] == round(
                rl["measured"]["fraction_of_transaction_roofline"], 3)
            assert pt["scatter_layout"] == roofline.layout_label(rl["scatter_pricing"]["layout"])


def test_warp_sweep_is_the_same_sweep(recorded, monkeypatch, tmp_path):
    j, t = recorded
    jsweep = load_script(REPO / "scripts" / "warp_sweep.py", "jax_warp_sweep_script")
    for name in ("even_frame_fit_eval", "ensembled_warp_fit_eval"):
        monkeypatch.setattr(jsweep, name, getattr(j, name))
        monkeypatch.setattr(warp_sweep, name, getattr(t, name))
    monkeypatch.setattr(jsweep, "load_volume", fake_loader(jio))
    monkeypatch.setattr(sys, "argv", ["warp_sweep.py", "--fast"])
    monkeypatch.setattr(jutils, "setup_compilation_cache", lambda *a, **k: None)
    sys.path.insert(0, str(REPO / "scripts"))  # its merge step imports experiments.py as a module
    try:
        jsweep.main()
    finally:
        sys.path.remove(str(REPO / "scripts"))
        sys.modules.pop("experiments", None)
    rows = warp_sweep.main(["--fast", "--device", "cpu", "--out_dir", "sweep"])
    assert t.events == j.events and len(t.events) == 18
    jrows = json.loads((tmp_path / "results.json").read_text())["warp_sweep"]
    assert [r["name"] for r in rows] == [r["name"] for r in jrows]
    assert [r["epochs"] for r in rows] == [r["epochs"] for r in jrows]
    assert (tmp_path / "sweep" / "RESULTS.md").exists()


def test_prefill_stacked4d_is_the_same_call(recorded, monkeypatch):
    j, t = recorded
    monkeypatch.setattr(jio, "load_volume", fake_loader(jio))
    monkeypatch.setattr(prefill_stacked4d, "stacked_interp_eval", t.stacked_interp_eval)
    monkeypatch.setattr(os, "chdir", lambda path: None)  # the JAX script moves into the repository
    runpy.run_path(str(REPO / "scripts" / "prefill_stacked4d.py"), run_name="__main__")
    prefill_stacked4d.main(["--image_path", "unused.nii.gz", "--device", "cpu"])
    assert len(j.events) == 1 and j.events[0][0] == "stacked" and t.events == j.events


def test_cache_manifest_matches_jax(tmp_path, monkeypatch):
    jmanifest = load_script(REPO / "scripts" / "cache_manifest.py", "jax_cache_manifest_script")
    a = np.zeros((4, 4, 2), np.float32)
    for which in ("j", "t"):
        cache = tmp_path / which / "runs" / "stacked_cache_ep2"
        cache.mkdir(parents=True)
        np.save(cache / "deploy_x.npy", a)
        np.save(cache / "fold1_x.npy", a[..., :1])
        with open(cache / "deploy_y.npz", "wb") as f:
            np.savez_compressed(f, pred=a.astype(np.float16))
        np.save(cache / "deploy_z.tmp.npy", a)
    want = jmanifest.write_manifest(str(tmp_path / "j" / "runs" / "stacked_cache_ep2"))
    monkeypatch.chdir(tmp_path / "t")
    (got,) = cache_manifest.main([])
    assert got["cache"] == "runs/stacked_cache_ep2"
    assert {k: v for k, v in got.items() if k != "cache"} == {k: v for k, v in want.items() if k != "cache"}
    assert got["complete"] is False and sorted(os.listdir("runs/stacked_cache_ep2"))[-1] == "manifest.json"


def test_isolation_covers_the_new_subpackages():
    from test_torch_isolation import PORT_FILES

    for sub in ("experiments", "examples"):
        files = sorted((REPO / "mri_interpolation_tpu_torch" / sub).glob("*.py"))
        assert files and all(f in PORT_FILES for f in files), sub


def test_two_phase_between_phases_sees_phase_one():
    """``between_phases`` runs once, after phase 1 and before phase 2."""
    from mri_interpolation_tpu_torch.models import make_hash_mlp
    from mri_interpolation_tpu_torch.train import TrainConfig

    ds = io.dataset_from_array(io.synthetic_volume((8, 8, 16), seed=3))
    model = make_hash_mlp(3, n_levels=2, base_resolution=(2, 2, 2), finest_resolution=(8, 8, 16), dim_hidden=8,
                          decoder="relu_plain", device="cpu")
    seen = []
    cfg = TrainConfig(batch_size=256, epochs=1, lr=5e-3)
    p1, p2 = tprotocols.two_phase_hash_fit(
        model, ds.coords, ds.values, ds.shape, pretrain_config=cfg, train_config=cfg, device="cpu",
        between_phases=lambda m: seen.append({k: v.clone() for k, v in m.state_dict().items()}))
    assert len(seen) == 1 and p1.steps == 1 and p2.steps == 4
    assert any(not torch.equal(seen[0][k], v) for k, v in model.state_dict().items())
