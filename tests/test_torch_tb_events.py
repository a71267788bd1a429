"""Port parity: the TensorBoard event-file view of ``scalars.jsonl``
(``train/tb_events.py``, pure Python, copied) and the launcher's
``tb_events`` branch, against the JAX package.

Exact: for the same ``scalars.jsonl`` and ``wall_time`` the event file's
bytes equal JAX's; each package's reader reads the other's file back, equal
to the records (float32 values, as the proto's ``simple_value``).
"""

import os

import numpy as np
import pytest

from mri_interpolation_tpu.train import tb_events as jtb
from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
from mri_interpolation_tpu_torch.train import read_scalars
from mri_interpolation_tpu_torch.train import tb_events as ttb
from mri_interpolation_tpu_torch.train.scalars import ScalarLogger


def _scalars(tmp_path):
    path = str(tmp_path / "scalars.jsonl")
    rng = np.random.default_rng(0)
    with ScalarLogger(path) as log:
        log.log_epoch_losses(0, 0, rng.random(7).astype(np.float32))
        log.log(7, "psnr", 31.25, epoch=0)
        log.log_epoch_losses(1, 7, rng.random(7).astype(np.float32))
        log.log(3_000_000_000, "psnr", 33.5, epoch=1)
    return path


@pytest.mark.parametrize("wall_time", [1000.0, 1.7e9 + 0.25])
def test_event_file_bytes_equal_jax(tmp_path, wall_time):
    jsonl = _scalars(tmp_path)
    got = ttb.export_scalars_jsonl(jsonl, str(tmp_path / "port"), wall_time=wall_time)
    want = jtb.export_scalars_jsonl(jsonl, str(tmp_path / "jax"), wall_time=wall_time)
    assert os.path.basename(got) == os.path.basename(want)
    assert open(got, "rb").read() == open(want, "rb").read()
    for reader, path in ((ttb.read_event_file, want), (jtb.read_event_file, got)):
        events = list(reader(path))
        assert events[0]["file_version"] == "brain.Event:2" and events[0]["wall_time"] == wall_time
        recs = read_scalars(jsonl)
        assert [(e["step"], e["scalars"][0][0]) for e in events[1:]] == [(r["step"], r["tag"]) for r in recs]
        np.testing.assert_array_equal([e["scalars"][0][1] for e in events[1:]],
                                      np.float32([r["value"] for r in recs]))


def test_crc_and_corruption():
    assert ttb._crc32c(b"123456789") == 0xE3069283 == jtb._crc32c(b"123456789")


def test_launcher_writes_the_event_file(tmp_path):
    """``tb_events`` exports the run's ``scalars.jsonl`` under ``tb/``; the
    file reads back equal to the stream."""
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((12, 10, 6), seed=0), path)
    cfg = RunConfig(image_path=path, output_root=str(tmp_path / "runs"), epochs=2, batch_size=240, dim_hidden=8,
                    base_resolution=(2, 2, 2), finest_resolution=(12, 10, 6), interp_shapes=(), tb_events=True,
                    eval_every_epochs=1, save_checkpoint=False)
    run_dir = launcher.run(cfg, device="cpu")["run_dir"]
    files = os.listdir(os.path.join(run_dir, "tb"))
    assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
    events = list(ttb.read_event_file(os.path.join(run_dir, "tb", files[0])))
    recs = read_scalars(os.path.join(run_dir, "scalars.jsonl"))
    assert [r["tag"] for r in recs].count("psnr") == 2 and len(events) == len(recs) + 1
    assert [(e["step"], e["scalars"][0][0]) for e in events[1:]] == [(r["step"], r["tag"]) for r in recs]
    np.testing.assert_array_equal([e["scalars"][0][1] for e in events[1:]], np.float32([r["value"] for r in recs]))
