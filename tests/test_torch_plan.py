"""Port parity: the capacity planner (``plan.py``: ``plan_run``,
``step_roofline``, the CLI), the launcher's ``--plan`` with
``plan_from_config``, and the sharding planner
(``parallel/sharded_table.py:plan_table_sharding``) against the JAX package.

Exact: the byte and FLOP counts, the levels, the sharding layout and the
recommendations equal JAX's for the same configuration and an explicit
``hbm_bytes``; the floors equal those counts divided by the H100 SXM's
peaks (3.35 TB/s, 67 TFLOP/s fp32). The port names its compute floor
``fp32_cores`` where JAX says ``mxu_f32``, and its scatter layout is the
port's kernel-2 route, so those keys are compared by meaning, not by name.
"""

import json

import numpy as np
import pytest

from mri_interpolation_tpu import plan as jplan
from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGridEncoding
from mri_interpolation_tpu.launcher import plan_from_config as jax_plan_from_config
from mri_interpolation_tpu.parallel.sharded_table import plan_table_sharding as jax_plan_table_sharding
from mri_interpolation_tpu_torch import launcher, plan
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.ops.hash_encode import table_grad_plan
from mri_interpolation_tpu_torch.parallel import plan_table_sharding

CONFIGS = {
    # the full-4D recipe at the ankle's shape (scripts/experiments.py:398-402, rank-adapted)
    "full4d": dict(dim_in=4, n_levels=5, n_features_per_level=4, base_resolution=(64, 64, 2, 3),
                   finest_resolution=(352, 352, 6, 15), growth="paper", decoder="relu_plain", batch_size=50000,
                   volume_shape=(352, 352, 6, 15), optimizer="adam_tcnn"),
    "flagship": dict(dim_in=3, volume_shape=(352, 352, 15)),
    "ngp_remat": dict(dim_in=3, n_levels=3, n_features_per_level=8, base_resolution=(64, 64, 5),
                      finest_resolution=(352, 352, 15), growth="paper", decoder="relu_plain", remat=True,
                      volume_shape=(352, 352, 15), row_fraction=0.1),
    "hashed_norm_proper": dict(dim_in=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                               base_resolution=16, finest_resolution=None, per_level_scale=1.4,
                               decoder="norm_proper", n_devices=4),
    # a budget that forces every recommendation: streaming, table sharding, remat
    "tight": dict(dim_in=4, n_levels=5, n_features_per_level=4, base_resolution=(64, 64, 2, 3),
                  finest_resolution=(352, 352, 6, 15), growth="paper", batch_size=500000,
                  volume_shape=(352, 352, 6, 150), n_devices=8, hbm_bytes=1e9),
}
ROOFLINE_KEYS = ("dim_in", "n_levels", "n_features_per_level", "log2_hashmap_size", "base_resolution",
                 "finest_resolution", "per_level_scale", "growth", "dim_hidden", "n_layers", "decoder", "batch_size",
                 "optimizer")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_run_matches_jax(name):
    kw = {"hbm_bytes": 80e9, **CONFIGS[name]}
    assert plan.plan_run(**kw) == jplan.plan_run(**kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_roofline_matches_jax(name):
    kw = {k: v for k, v in CONFIGS[name].items() if k in ROOFLINE_KEYS}
    got = plan.step_roofline(measured_steps_per_sec=250.0, **kw)
    want = jplan.step_roofline(measured_steps_per_sec=250.0, **kw)
    for key in ("bytes_per_step", "flops_per_step", "random_accesses_per_step"):
        assert got[key] == want[key], key
    peaks = plan.CHIPS["h100_sxm"]
    assert peaks == {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12, "tf32_flops": 494.7e12, "bf16_flops": 989.4e12}
    floor = got["floor_s"]
    assert floor["hbm"] == got["bytes_per_step"]["total"] / 3.35e12
    assert floor["fp32_cores"] == got["flops_per_step"]["total"] / 67e12
    assert floor["binding"] == ("hbm" if floor["hbm"] >= floor["fp32_cores"] else "fp32_cores")
    assert floor["predicted_step_s"] == max(floor["hbm"], floor["fp32_cores"])
    assert got["measured"]["fraction_of_roofline"] == floor["predicted_step_s"] * 250.0
    assert got["chip"] == "h100_sxm" and "mxu_f32" not in floor


def test_scatter_pricing_names_the_ports_route():
    kw = {k: v for k, v in CONFIGS["full4d"].items() if k in ROOFLINE_KEYS}
    got = plan.step_roofline(measured_gather_ns=2.0, measured_scatter={"narrow_ns": 1.5}, **kw)
    enc = HashGridEncoding(dim=4, n_levels=5, n_features_per_level=4, log2_hashmap_size=23,
                           base_resolution=(64, 64, 2, 3), finest_resolution=(352, 352, 6, 15), growth="paper")
    route = table_grad_plan(enc, 50000)
    pricing = got["scatter_pricing"]
    assert pricing["layout"] == {"private_levels": list(route.private_levels),
                                 "global_levels": list(route.global_levels), "corner_split": route.corner_split}
    assert pricing["packed_scatter_s"] == pricing["packed_ids"] * 4 * 1.5 * 1e-9
    assert got["floor_s"]["transaction"] >= got["floor_s"]["fp32_cores"]


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_plan_table_sharding_matches_jax(n_devices):
    geometry = dict(dim=4, n_levels=5, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64, 2, 3),
                    finest_resolution=(352, 352, 6, 15), growth="paper")
    got = plan_table_sharding(HashGridEncoding(**geometry), n_devices)
    want = jax_plan_table_sharding(JaxHashGridEncoding(**geometry), n_devices)
    assert got.slots == want.slots and got.tv_pairs == want.tv_pairs
    for key in ("ndev", "n_slots", "local_rows", "n_levels", "n_features", "dim"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("slot_level", "slot_lo", "slot_len", "slot_off", "scatter", "tv_mask"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


def test_plan_counts_are_the_models_real_bytes():
    """The plan's table, decoder and optimizer bytes are the model's
    parameters and Adam's two moment buffers, exactly (a tiny relu_plain
    recipe, so the CPU can hold it)."""
    import torch

    from mri_interpolation_tpu_torch.train import make_optimizer, TrainConfig

    kw = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=12, base_resolution=(4, 4, 2, 2),
              finest_resolution=(16, 16, 6, 5), growth="paper", decoder="relu_plain", dim_hidden=32, n_layers=2)
    model = make_hash_mlp(4, device="cpu", **kw)
    opt = make_optimizer(TrainConfig(optimizer="adam_tcnn"), model.parameters())
    model(torch.rand(8, 4)).sum().backward()
    opt.step()
    moments = sum(st[k].numel() * 4 for st in opt.state.values() for k in ("exp_avg", "exp_avg_sq"))
    got = plan.plan_run(dim_in=4, batch_size=64, volume_shape=(16, 16, 6, 5), optimizer="adam_tcnn", **kw)["bytes"]
    assert got["table"] == model.encoder.table.numel() * 4
    assert got["table"] + got["decoder_params"] == sum(p.numel() * 4 for p in model.parameters())
    assert got["optimizer_state"] == moments
    assert got["dataset"] == 16 * 16 * 6 * 5 * (4 + 1) * 4


def _volume(tmp_path, shape):
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume(shape, seed=1), path)
    return path


@pytest.mark.parametrize("flags", [dict(), dict(slice_z=2, even_frames_only=True), dict(slice_z=2, undersample_pct=50.0),
                                   dict(even_frames_only=True, remat=True, batch_size=3000)],
                         ids=["whole", "slice_even", "slice_undersample", "even_remat"])
def test_plan_from_config_matches_jax(tmp_path, flags):
    from mri_interpolation_tpu.configs import RunConfig as JaxRunConfig

    path = _volume(tmp_path, (16, 16, 4, 6))
    got = launcher.plan_from_config(RunConfig(image_path=path, **flags), n_devices=4, hbm_bytes=16e9)
    want = jax_plan_from_config(JaxRunConfig(image_path=path, **flags), n_devices=4, hbm_bytes=16e9)
    assert got == want
    if flags.get("slice_z") is not None and flags.get("even_frames_only"):
        assert all(len(l["resolution"]) == 3 for l in got["levels"])
        assert got["bytes"]["dataset"] == 16 * 16 * 3 * 4 * 4  # (16, 16, 3): coords and value, 4 f32


def test_launcher_plan_prints_json_and_touches_no_device(tmp_path, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no device is asked for
    path = _volume(tmp_path, (16, 16, 4, 5))
    out = launcher.main(["--image_path", path, "--plan", "--plan_devices", "4", "--output_root",
                         str(tmp_path / "runs")])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert all(len(l["resolution"]) == 4 for l in printed["levels"])
    assert printed["bytes"]["dataset"] == 16 * 16 * 4 * 5 * 5 * 4 and printed["bytes"]["hbm_budget"] == 80e9
    assert printed["sharding"]["n_devices"] == 4
    assert not (tmp_path / "runs").exists()


def test_plan_cli_prints_json(capsys):
    argv = ["--dim_in", "4", "--n_levels", "5", "--n_features_per_level", "4", "--growth", "paper",
            "--decoder", "relu_plain", "--base_resolution", "64,64,2,3", "--finest_resolution", "352,352,6,15",
            "--volume_shape", "352,352,6,15", "--batch_size", "50000", "--optimizer", "adam_tcnn", "--roofline",
            "--measured_steps_per_sec", "300"]
    out = plan.main(argv)
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    jplan.main(argv + ["--hbm_gb", "80"])
    want = json.loads(capsys.readouterr().out)
    assert printed["bytes"] == want["bytes"] and printed["levels"] == want["levels"]
    assert printed["roofline"]["bytes_per_step"] == want["roofline"]["bytes_per_step"]
    assert printed["roofline"]["measured"]["steps_per_sec"] == 300
