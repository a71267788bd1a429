"""Port parity: the public names that close the port's ``__all__`` against
the JAX package's: ``encodings.spatial_hash`` (tcnn's spatial hash, held to
the numpy oracle of ``tests/test_encodings.py`` and to the JAX function,
exactly), ``utils.imaging.create_mgrid`` (the reference's name for
``io.volume.make_mgrid``) and the top-level ``io``; and the names each
package exports, compared module by module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mri_interpolation_tpu as jax_pkg
import mri_interpolation_tpu_torch as port
from mri_interpolation_tpu import parallel as jax_parallel
from mri_interpolation_tpu.encodings import spatial_hash as jax_spatial_hash
from mri_interpolation_tpu.utils import imaging as jax_imaging
from mri_interpolation_tpu_torch import parallel
from mri_interpolation_tpu_torch.encodings import HashGridEncoding, spatial_hash
from mri_interpolation_tpu_torch.io import make_mgrid
from mri_interpolation_tpu_torch.utils import imaging


def numpy_hash_oracle(corner: np.ndarray, hashmap_size: int) -> np.ndarray:
    """tcnn ``fast_hash`` in numpy uint64 masked to 32 bits (tests/test_encodings.py)."""
    primes = np.array([1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737],
                      dtype=np.uint64)[: corner.shape[-1]]
    h = (corner.astype(np.uint64) * primes) & np.uint64(0xFFFFFFFF)
    out = h[..., 0]
    for i in range(1, corner.shape[-1]):
        out = out ^ h[..., i]
    return (out % np.uint64(hashmap_size)).astype(np.int64)


@pytest.mark.parametrize("dim", [1, 2, 3, 4, 7])
def test_spatial_hash_matches_the_oracle_and_jax(dim):
    corners = np.random.default_rng(dim).integers(0, 1000, size=(100, dim)).astype(np.int32)
    got = spatial_hash(torch.from_numpy(corners), 2**15)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), numpy_hash_oracle(corners, 2**15))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_spatial_hash(jnp.asarray(corners),
                                                                           jnp.asarray([2**15], jnp.uint32))))


def test_spatial_hash_wraps_modulo_two_to_the_32():
    corner = np.array([[100000, 70000], [2**31 - 1, 2**31 - 1]], dtype=np.int32)
    got = spatial_hash(torch.from_numpy(corner), 2**23).numpy()
    np.testing.assert_array_equal(got, numpy_hash_oracle(corner, 2**23))
    np.testing.assert_array_equal(got, np.asarray(jax_spatial_hash(jnp.asarray(corner),
                                                                   jnp.asarray([2**23], jnp.uint32))))


def test_spatial_hash_first_prime_is_one():
    np.testing.assert_array_equal(spatial_hash(torch.tensor([[7], [129]]), 100).numpy(), [7, 29])


def test_spatial_hash_takes_per_level_sizes():
    corners = torch.from_numpy(np.random.default_rng(0).integers(0, 500, size=(3, 50, 3)).astype(np.int32))
    sizes = torch.tensor([97, 2**10, 2**19])[:, None]
    got = spatial_hash(corners, sizes)
    for l in range(3):
        np.testing.assert_array_equal(got[l].numpy(), numpy_hash_oracle(corners[l].numpy(), int(sizes[l])))


def test_hashed_levels_index_by_spatial_hash():
    enc = HashGridEncoding(dim=3, n_levels=2, n_features_per_level=1, log2_hashmap_size=6, base_resolution=8,
                           finest_resolution=16, storage="hashed")
    x = torch.rand((40, 3), generator=torch.Generator().manual_seed(0))
    ids, _ = enc.corner_ids_and_weights(x)
    for l in range(2):
        cell = (x * float(enc.level_resolutions[l][0])).to(torch.int32)
        got = spatial_hash(cell, int(enc.level_sizes[l])).to(torch.int64) + int(enc.level_offsets[l])
        np.testing.assert_array_equal(ids[:, l, 0].numpy(), got.numpy())  # corner 0: the cell's own vertex


@pytest.mark.parametrize("shape, lo", [((4, 5), 0.0), ((3, 4, 2), -1.0)])
def test_create_mgrid_is_make_mgrid(shape, lo):
    assert imaging.create_mgrid is make_mgrid and "create_mgrid" in imaging.__all__
    np.testing.assert_array_equal(imaging.create_mgrid(shape, lo=lo), jax_imaging.create_mgrid(shape, lo=lo))


def test_top_level_io():
    assert "io" in port.__all__ and port.io.make_mgrid is make_mgrid
    assert sorted(set(jax_pkg.io.__all__) - set(port.io.__all__)) == []


def test_parallel_names_are_jax_names_but_the_mesh_shardings():
    left_out = {"Mesh", "NamedSharding", "P", "replicated", "sharded_batch"}
    assert set(jax_parallel.__all__) - left_out <= set(parallel.__all__)
    assert not left_out & set(parallel.__all__)
