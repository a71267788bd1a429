"""The CUDA hash-encode kernels against their plain PyTorch versions, on the
card. Every test here carries the ``gpu`` marker and skips without a CUDA
device: a CUDA kernel has no CPU mode. The file imports no JAX (the card's
machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q -p no:cacheprovider

Tolerances: forward atol 2e-6 (fp32 sums of 2^d products of magnitude <= 1 in
another order); table gradient atol 1e-5 plus rtol 1e-5: fp32 atomics add in
a run-dependent order, and the error grows with the terms a row sums (about
sqrt(k) * 2^-24 * |sum|; the small tables here take ~200 terms a row).
"""

import numpy as np
import pytest
import torch

from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.ops import hash_encode as he

CONFIGS = {
    "flagship": dict(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                     base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15)),
    "hashed": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=10,
                   base_resolution=(8, 8, 4), finest_resolution=(33, 33, 17), storage="hashed"),
    "d1": dict(dim=1, n_levels=3, n_features_per_level=8, log2_hashmap_size=5,
               base_resolution=(4,), finest_resolution=(64,)),
    "d2": dict(dim=2, n_levels=3, n_features_per_level=2, log2_hashmap_size=12,
               base_resolution=(8, 8), finest_resolution=(33, 33)),
    "d4_hashed": dict(dim=4, n_levels=2, n_features_per_level=3, log2_hashmap_size=9,
                      base_resolution=(3, 3, 2, 2), finest_resolution=(9, 9, 5, 6), storage="hashed"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hash-encode kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cfg, n, device):
    rng = np.random.default_rng(0)
    enc = HashGridEncoding(**cfg)
    x = rng.random((n, cfg["dim"]), dtype=np.float32)
    x[0], x[1] = 0.0, 1.0
    table = rng.uniform(-1, 1, (enc.total_size, cfg["n_features_per_level"])).astype(np.float32)
    g = rng.standard_normal((n, enc.output_dim)).astype(np.float32)
    return (enc, *(torch.from_numpy(a).to(device) for a in (x, table, g)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernels_match_plain_versions(name, cuda_device):
    enc, x, table, g = _inputs(CONFIGS[name], 4099, cuda_device)
    he.reset_launches()
    y = he.hash_encode_forward(enc, table, x)
    dt = he.hash_encode_table_grad(enc, x, g)
    torch.cuda.synchronize()
    assert he.LAUNCHES == {"hash_encode_forward": 1, "hash_encode_table_grad": 1}
    np.testing.assert_allclose(y.cpu().numpy(), he.hash_encode_reference(enc, table, x).cpu().numpy(),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(dt.cpu().numpy(), he.hash_encode_table_grad_reference(enc, x, g).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda_device):
    enc, x, table, g = _inputs(CONFIGS["flagship"], 4, cuda_device)
    he.reset_launches()
    assert he.hash_encode_forward(enc, table, x[:0]).shape == (0, 4)
    assert float(he.hash_encode_table_grad(enc, x[:0], g[:0]).abs().sum()) == 0.0
    assert he.LAUNCHES == {"hash_encode_forward": 0, "hash_encode_table_grad": 0}


@pytest.mark.gpu
def test_wrapper_rejects_bad_tensors(cuda_device):
    enc, x, table, _ = _inputs(CONFIGS["flagship"], 16, cuda_device)
    with pytest.raises(ValueError, match="is on"):
        he.hash_encode_forward(enc, table, x.cpu())
    with pytest.raises(TypeError, match="float32"):
        he.hash_encode_forward(enc, table, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        he.hash_encode_forward(enc, table, x.t().contiguous().t())


@pytest.mark.gpu
def test_model_gradients_on_card_match_cpu(cuda_device):
    kw = dict(base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, seed=1)
    x = torch.rand((512, 3), generator=torch.Generator().manual_seed(2))
    table = None
    grads = {}
    for dev in ("cpu", cuda_device):
        model = make_hash_mlp(3, device=dev, **kw)
        if table is None:  # one well-conditioned table for both (U(+-0.5), not the 1e-4 init)
            table = torch.empty(model.encoder.table.shape).uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            model.encoder.table.copy_(table)
        model(x.to(dev)).square().mean().backward()
        grads[str(dev)] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    for key, want in grads["cpu"].items():
        np.testing.assert_allclose(grads[str(cuda_device)][key].numpy(), want.numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)
