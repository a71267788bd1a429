"""Port parity: the serving export (``infer/export.py``: ``save_evaluator``,
``load_evaluator``, ``export_evaluator_bytes``, ``quantize_tables``) and the
dispatcher ops it traces through (``ops/library.py``), on the CPU.

- an artifact against the port's own ``evaluate_grid``: atol 1e-6 (the same
  plain versions on the same coordinates; it holds to 0 here), for the JAX
  test's relu_plain HashMLP (``tests/test_infer.py:168-178``), the flagship
  HashMLP at a small width with its BatchNorm in eval, a multi-frame HashMLP
  at one frame and a SIREN that runs after ``del model``;
- the port's artifact against the JAX package's exported evaluator (its
  Pallas kernels in interpret mode) on the same parameters
  (``convert.params_from_jax``): atol 1e-6, what the plain versions already
  agree to;
- ``quantize_tables``: bf16 tables within 5e-3 of float32
  (``tests/test_infer.py:210``), within 1e-6 of JAX's quantized
  ``evaluate_grid``, and a file smaller by more than 0.4 x the float32
  table's bytes (``tests/test_infer.py:218``);
- each op's CPU impl and fake impl through ``torch.library.opcheck``.
"""

import gc
import io
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from mri_interpolation_tpu import infer as jinfer
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.models import make_siren as jax_make_siren
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.infer import (evaluate_grid, export_evaluator_bytes, load_evaluator, quantize_tables,
                                               save_evaluator)
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_multi_hash_mlp, make_siren
from mri_interpolation_tpu_torch.ops import fused_mlp as fm
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

# tests/test_infer.py:168-178
RELU_PLAIN = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=10, base_resolution=(4, 4, 2),
                  finest_resolution=(12, 12, 6), dim_hidden=16, n_layers=2, decoder="relu_plain")
SHAPE = (10, 11, 12)
# tests/test_infer.py:191-194, the quantisation test's HashMLP: a table of 3,081 rows x 2
QUANTIZED = dict(RELU_PLAIN, n_levels=3, log2_hashmap_size=12, finest_resolution=(16, 16, 8))
ATOL = 1e-6


def _jax_init(kw=RELU_PLAIN, seed=0, table_scale=0.5):
    """JAX parameters with a U(-scale, scale) table (the init's 1e-4 would hide every table effect)."""
    jm = jax_make_hash_mlp(dim_in=3, fused="interpret", **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-table_scale, table_scale, shape).astype(
        np.float32)
    return jm, params, state


def _port(params, state, kw=RELU_PLAIN):
    model = make_hash_mlp(3, device="cpu", **kw)
    model.load_state_dict(params_from_jax(params, state))
    return model


@pytest.mark.parametrize("chunk_size", [1 << 15, 301])
def test_relu_plain_round_trip_matches_evaluate_grid(tmp_path, chunk_size):
    """One chunk over the grid, and 301-voxel chunks whose last one is padded."""
    _, params, state = _jax_init()
    model = _port(params, state)
    ref = evaluate_grid(model, SHAPE, chunk_size=chunk_size, device="cpu")
    path = save_evaluator(str(tmp_path / "eval.pt2"), model, SHAPE, chunk_size=chunk_size, device="cpu")
    vol = load_evaluator(path)()
    assert vol.shape == SHAPE and vol.dtype == np.float32
    np.testing.assert_allclose(vol, ref, rtol=0, atol=ATOL)


def test_flagship_with_batchnorm_in_eval_round_trip(tmp_path):
    """The flagship HashMLP (4 dense levels x F = 1, BatchNorm decoder) after
    a short fit, so that its BatchNorm statistics are the data's: the
    artifact runs the decoder in eval mode, as ``evaluate_grid`` does, by
    its separable route and by the per-chunk one."""
    model = make_hash_mlp(3, base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, device="cpu")
    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=3))
    Trainer(TrainConfig(batch_size=256, epochs=1, lr=1e-2)).fit(model, ds.coords, ds.values, device="cpu")
    assert model.training
    shape = (20, 18, 9)
    per_chunk = evaluate_grid(model, shape, chunk_size=500, device="cpu", transform=lambda x: x)
    separable = evaluate_grid(model, shape, chunk_size=500, device="cpu")
    vol = load_evaluator(save_evaluator(str(tmp_path / "f.pt2"), model, shape, chunk_size=500, device="cpu"))()
    assert model.training  # the export left the model's mode as it was
    np.testing.assert_allclose(vol, per_chunk, rtol=0, atol=ATOL)
    np.testing.assert_allclose(vol, separable, rtol=0, atol=ATOL)


def test_multi_frame_round_trip(tmp_path):
    """A multi-frame HashMLP exported at frame 2 against ``evaluate_grid(...,
    frame_idx=2)``, and another frame's artifact differs."""
    model = make_multi_hash_mlp(dim_in=2, n_frames=3, n_levels=3, log2_hashmap_size=8, dim_hidden=8, device="cpu")
    with torch.no_grad():
        model.encoders.table.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(4))
    shape = (9, 7)
    ref = evaluate_grid(model, shape, frame_idx=2, device="cpu")
    vol = load_evaluator(save_evaluator(str(tmp_path / "m2.pt2"), model, shape, chunk_size=16, frame_idx=2,
                                        device="cpu"))()
    np.testing.assert_allclose(vol, ref, rtol=0, atol=ATOL)
    other = load_evaluator(save_evaluator(str(tmp_path / "m0.pt2"), model, shape, frame_idx=0, device="cpu"))()
    assert np.abs(other - vol).max() > 1e-3


def test_artifact_is_self_contained(tmp_path):
    """The artifact runs after the model is gone (parameters saved with the
    program), as ``tests/test_infer.py:223-235``; a two-output model keeps
    its last axis."""
    model = make_siren(2, dim_hidden=8, n_layers=2, device="cpu")
    ref = evaluate_grid(model, (6, 7), device="cpu")
    path = save_evaluator(str(tmp_path / "s.pt2"), model, (6, 7), device="cpu")
    del model
    gc.collect()
    vol = load_evaluator(path)()
    assert vol.shape == (6, 7) and np.isfinite(vol).all()
    np.testing.assert_allclose(vol, ref, rtol=0, atol=ATOL)
    two = make_siren(2, dim_hidden=8, n_layers=2, dim_out=2, device="cpu")
    assert load_evaluator(save_evaluator(str(tmp_path / "s2.pt2"), two, (6, 7), device="cpu"))().shape == (6, 7, 2)


@pytest.mark.parametrize("family", ["relu_plain", "siren"])
def test_artifact_matches_the_jax_exported_evaluator(tmp_path, family):
    """The same parameters exported by both packages: the JAX artifact (Pallas
    in interpret mode) and the port's agree to 1e-6."""
    if family == "siren":
        jm = jax_make_siren(dim_in=2, dim_hidden=16, n_layers=3, fused="interpret")
        params, state = jax.device_get(jm.init(jax.random.key(2)))
        model = make_siren(2, dim_hidden=16, n_layers=3, device="cpu")
        model.load_state_dict(params_from_jax(params, state))
        shape = (13, 9)
    else:
        jm, params, state = _jax_init()
        model, shape = _port(params, state), SHAPE
    want = jinfer.load_evaluator(jinfer.save_evaluator(str(tmp_path / "jax.bin"), jm, params, state, shape))()
    got = load_evaluator(save_evaluator(str(tmp_path / "port.pt2"), model, shape, device="cpu"))()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_quantize_tables(tmp_path):
    """bf16 tables: the dtype, the decoder untouched, the error against
    float32, JAX's quantized evaluation, and the artifact's bytes."""
    jm, params, state = _jax_init(QUANTIZED, table_scale=0.1)
    model = _port(params, state, QUANTIZED)
    q = quantize_tables(model)
    assert q.encoder.table.dtype == torch.bfloat16 and model.encoder.table.dtype == torch.float32
    for (name, a), (qname, b) in zip(model.named_parameters(), q.named_parameters()):
        assert name == qname
        if not name.endswith("table"):
            assert b.dtype == torch.float32 and torch.equal(a, b), name
    ref = evaluate_grid(model, SHAPE, device="cpu")
    got = evaluate_grid(q, SHAPE, device="cpu")
    err = float(np.abs(got - ref).max())
    assert 0 < err < 5e-3, err
    want = jinfer.evaluate_grid(jm, jinfer.quantize_tables(params), state, SHAPE)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    p32 = save_evaluator(str(tmp_path / "f32.pt2"), model, SHAPE, device="cpu")
    p16 = save_evaluator(str(tmp_path / "bf16.pt2"), model, SHAPE, device="cpu", table_dtype=torch.bfloat16)
    table_bytes = model.encoder.table.numel() * 4
    assert os.path.getsize(p32) - os.path.getsize(p16) > 0.4 * table_bytes
    np.testing.assert_allclose(load_evaluator(p16)(), got, rtol=0, atol=ATOL)
    assert model.encoder.table.dtype == torch.float32  # the export quantised a copy


def test_bytes_metadata_and_the_graph(tmp_path):
    """``export_evaluator_bytes`` is the saved file's archive; its metadata;
    the graph calls each kernel's op once (one node a chunk) and launches
    nothing on the CPU."""
    _, params, state = _jax_init()
    model = _port(params, state)
    blob = export_evaluator_bytes(model, SHAPE, chunk_size=400, device="cpu")
    path = str(tmp_path / "b.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        (name,) = [n for n in archive.namelist() if n.endswith("evaluator.json")]
        meta = json.loads(archive.read(name))
    assert meta == {"shape": list(SHAPE), "lo": 0.0, "hi": 1.0, "chunk_size": 400, "n": 1320, "dim_out": 1,
                    "device": "cpu", "frame_idx": None, "table_dtype": None}
    code = torch.export.load(path).graph_module.code
    assert code.count("mri_torch.hash_encode_forward") == 1 and code.count("mri_torch.fused_mlp_forward") == 1
    he.reset_launches()
    fm.reset_launches()
    np.testing.assert_allclose(load_evaluator(path)(), evaluate_grid(model, SHAPE, device="cpu"), rtol=0, atol=ATOL)
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}


def test_card_artifact_without_a_card_raises(tmp_path, monkeypatch):
    """An artifact whose device is the card, loaded where there is none."""
    model = make_siren(2, dim_hidden=8, n_layers=2, device="cpu")
    src = save_evaluator(str(tmp_path / "cpu.pt2"), model, (4, 4), device="cpu")
    dst = str(tmp_path / "card.pt2")
    with zipfile.ZipFile(src) as a, zipfile.ZipFile(dst, "w") as b:
        for item in a.infolist():
            data = a.read(item)
            if item.filename.endswith("evaluator.json"):
                data = json.dumps({**json.loads(data), "device": "cuda"}).encode()
            b.writestr(item, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_evaluator(dst)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        save_evaluator(str(tmp_path / "x.pt2"), model, (4, 4))
    other = str(tmp_path / "other.zip")
    zipfile.ZipFile(other, "w").close()
    with pytest.raises(ValueError, match="holds no evaluator.json"):
        load_evaluator(other)


GEOMETRIES = {
    "flagship": dict(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23, base_resolution=(64, 64, 5),
                     finest_resolution=(352, 352, 15)),
    "tcnn": dict(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
                 finest_resolution=None, per_level_scale=1.4),
    "isotropic_base": dict(dim=3, n_levels=6, n_features_per_level=2, log2_hashmap_size=12, base_resolution=16,
                           finest_resolution=(352, 352, 15)),
    "hashed_paper": dict(dim=2, n_levels=5, n_features_per_level=4, log2_hashmap_size=14, base_resolution=4,
                         finest_resolution=512, storage="hashed", growth="paper"),
    "full4d": dict(dim=4, n_levels=5, n_features_per_level=4, log2_hashmap_size=24, base_resolution=(16, 16, 2, 2),
                   finest_resolution=(352, 352, 6, 15), growth="paper"),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_geometry_key_rebuilds_the_geometry(name):
    """``from_key(geometry_key())`` has every attribute of the original (one
    cached object a key), the ops' only description of a geometry."""
    enc = HashGridEncoding(**GEOMETRIES[name])
    key = enc.geometry_key()
    assert all(type(k) is int for k in key)
    again = HashGridEncoding.from_key(list(key))
    assert again is HashGridEncoding.from_key(key)
    for attr, value in vars(enc).items():
        other = getattr(again, attr)
        if isinstance(value, np.ndarray):
            assert value.dtype == other.dtype and np.array_equal(value, other), attr
        else:
            assert value == other, attr


OPS = ("hash_encode_forward", "hash_encode_table_grad", "hash_encode_coarse_forward",
       "hash_encode_coarse_table_grad", "fused_mlp_forward", "fused_mlp_backward")


def _op_args(name):
    rng = np.random.default_rng(5)
    enc = HashGridEncoding(dim=2, n_levels=3, n_features_per_level=2, log2_hashmap_size=12, base_resolution=(8, 8),
                           finest_resolution=(33, 33))
    key = list(enc.geometry_key())
    levels = he.coarse_onehot_levels(enc)
    x = torch.from_numpy(rng.random((50, 2), dtype=np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (enc.total_size, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((50, enc.output_dim)).astype(np.float32))
    widths, acts = (3, 16, 16, 2), fm.siren_acts(2, 25.0, 30.0)
    ws = [torch.from_numpy(rng.uniform(-0.5, 0.5, (k, n)).astype(np.float32)) for k, n in zip(widths, widths[1:])]
    bs = [torch.from_numpy(rng.uniform(-0.5, 0.5, (n,)).astype(np.float32)) for n in widths[1:]]
    mx = torch.from_numpy(rng.uniform(-1, 1, (40, 3)).astype(np.float32))
    mg = torch.from_numpy(rng.standard_normal((40, 2)).astype(np.float32))
    params = [t for pair in zip(ws, bs) for t in pair]
    words = list(fm.act_words(acts))
    args = {
        "hash_encode_forward": (table, x, key),
        "hash_encode_table_grad": (x, g, key),
        "hash_encode_coarse_forward": (table, x, key, levels),
        "hash_encode_coarse_table_grad": (x, g[:, :len(levels) * 2].contiguous(), key, levels),
        "fused_mlp_forward": (mx, params, words),
        "fused_mlp_backward": (mx, mg, params, words, True),
    }[name]
    return getattr(torch.ops.mri_torch, name).default, args


@pytest.mark.parametrize("name", OPS)
def test_op_cpu_and_fake_impls(name):
    """``torch.library.opcheck`` on the CPU impl (schema, autograd
    registration, fake tensors, AOT dispatch)."""
    op, args = _op_args(name)
    torch.library.opcheck(op, args)


def test_acts_round_trip_and_unknown_activation():
    for acts in (fm.siren_acts(3, 30.0, 25.0), fm.mlp_acts(2, "gelu"), (("id",),), [["relu"], ["id"]]):
        words = fm.act_words(acts)
        assert len(words) == 2 * len(acts) and fm._acts_of(words) == tuple(tuple(a) for a in acts)
    with pytest.raises(ValueError, match="unknown activation"):
        fm.act_words((("swish",),))
