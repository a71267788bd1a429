"""The CUDA kernels (hash encode, fused MLP, probe) against their plain
PyTorch versions, on the card. Every test here carries the ``gpu`` marker and
skips without a CUDA device: a CUDA kernel has no CPU mode. The file imports no JAX (the card's
machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q -p no:cacheprovider

Tolerances of the hash kernels: forward atol 2e-6 (fp32 sums of 2^d products
of magnitude <= 1 in another order); table gradient atol 1e-5 plus rtol 1e-5:
fp32 atomics add in a run-dependent order, and the error grows with the terms
a row sums (about sqrt(k) * 2^-24 * |sum|; the small tables here take ~200
terms a row). Those of the fused MLP are stated above its tests below.
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


# ---------------------------------------------------------------------------
# the fused-MLP kernel pair and the probe
#
# Tolerances, as a share of the largest reference value: 1e-5 for relu, gelu
# and identity stacks (fp32 sums of up to 352 products taken in another order
# on the card, with FMA); 1e-4 where a sine layer at w0 = 30 sits in the stack,
# since the sine multiplies an ulp-level difference of z by w0 at every
# layer. dW and db add the slices' partial sums with atomics in a
# run-dependent order, which the same shares cover.

from mri_interpolation_tpu_torch.models import make_siren  # noqa: E402
from mri_interpolation_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from mri_interpolation_tpu_torch.ops import probe as pr  # noqa: E402

STACKS = {
    # name: (widths, acts, batch)
    "siren_3x32x3": ([3, 32, 32, 32, 1], fm.siren_acts(3, 30.0, 30.0), 1000),
    "siren_w0s": ([3, 48, 48, 2], fm.siren_acts(2, 25.0, 50.0), 777),
    "relu_plain": ([32, 128, 1], fm.mlp_acts(1, "relu"), 4099),
    "gelu_wide": ([40, 200, 136, 3], fm.mlp_acts(2, "gelu"), 513),
    "id_single": ([5, 7], (("id",),), 33),
    "siren_352": ([3, 352, 352, 1], fm.siren_acts(2, 30.0, 30.0), 300),
    "deep_16": ([4] + [24] * 15 + [2], fm.mlp_acts(15, "gelu"), 257),  # the most layers the kernels take
    "wide_832": ([8, 832, 3], fm.mlp_acts(1, "relu"), 100),  # the widest stack that fits shared memory
}


def _stack(name, device):
    widths, acts, batch = STACKS[name]
    rng = np.random.default_rng(1)
    ws, bs = [], []
    for k, n in zip(widths[:-1], widths[1:]):
        if acts[0][0] == "sine":  # the SIREN init
            bound = 1.0 / k if not ws else np.sqrt(6.0 / k) / 30.0
        else:
            bound = 1.0 / np.sqrt(k)
        ws.append(rng.uniform(-bound, bound, (k, n)).astype(np.float32))
        bs.append(rng.uniform(-bound, bound, (n,)).astype(np.float32))
    x = rng.uniform(-1, 1, (batch, widths[0])).astype(np.float32)
    g = rng.standard_normal((batch, widths[-1])).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return [t(w) for w in ws], [t(b) for b in bs], t(x), t(g), acts


def _share(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.fixture
def full_fp32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STACKS))
def test_fused_mlp_matches_plain_versions(name, cuda_device, full_fp32):
    ws, bs, x, g, acts = _stack(name, cuda_device)
    tol = 1e-4 if any(a[0] == "sine" for a in acts) else 1e-5
    fm.reset_launches()
    y = fm.mlp_forward(ws, bs, x, acts)
    dws, dbs, dx = fm.mlp_backward(ws, bs, x, g, acts, need_dx=True)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {"fused_mlp_forward": 1, "fused_mlp_backward": 1}
    assert _share(y, fm.mlp_forward_reference(ws, bs, x, acts)) <= tol
    rdws, rdbs, rdx = fm.mlp_backward_reference(ws, bs, x, g, acts, need_dx=True)
    for l in range(len(ws)):
        assert _share(dws[l], rdws[l]) <= tol, f"dW[{l}]"
        assert _share(dbs[l], rdbs[l]) <= tol, f"db[{l}]"
    assert dx.is_contiguous() and _share(dx, rdx) <= tol
    _, _, none = fm.mlp_backward(ws, bs, x, g, acts, need_dx=False)
    assert none is None


@pytest.mark.gpu
def test_fused_mlp_masked_rows_add_nothing(cuda_device, full_fp32):
    ws, bs, x, g, acts = _stack("relu_plain", cuda_device)
    # a batch of 33 rows: one full tile and one row of the next
    full = fm.mlp_backward(ws, bs, x[:33], g[:33], acts, need_dx=True)
    ref = fm.mlp_backward_reference(ws, bs, x[:33], g[:33], acts, need_dx=True)
    for got, want in zip(full[0] + full[1] + [full[2]], ref[0] + ref[1] + [ref[2]]):
        assert _share(got, want) <= 1e-5


@pytest.mark.gpu
def test_fused_mlp_empty_batch_launches_nothing(cuda_device):
    ws, bs, x, g, acts = _stack("relu_plain", cuda_device)
    fm.reset_launches()
    assert fm.mlp_forward(ws, bs, x[:0], acts).shape == (0, 1)
    dws, _, dx = fm.mlp_backward(ws, bs, x[:0], g[:0], acts, need_dx=True)
    assert dx.shape == (0, 32) and float(dws[0].abs().sum()) == 0.0
    assert fm.LAUNCHES == {"fused_mlp_forward": 0, "fused_mlp_backward": 0}


@pytest.mark.gpu
def test_fused_mlp_wrapper_rejects_bad_stacks(cuda_device):
    ws, bs, x, g, acts = _stack("relu_plain", cuda_device)
    with pytest.raises(ValueError, match="is on"):
        fm.mlp_forward(ws, [b.cpu() for b in bs], x, acts)
    with pytest.raises(TypeError, match="float32"):
        fm.mlp_forward(ws, bs, x.double(), acts)
    with pytest.raises(ValueError, match="shape"):
        fm.mlp_forward(ws[::-1], bs[::-1], x, acts)
    wide = [torch.zeros((32, 1024), device=cuda_device), torch.zeros((1024, 1), device=cuda_device)]
    with pytest.raises(ValueError, match="shared memory"):
        fm.mlp_forward(wide, [torch.zeros(1024, device=cuda_device), torch.zeros(1, device=cuda_device)],
                       x, acts)


@pytest.mark.gpu
def test_fused_mlp_refused_launch_raises(cuda_device, monkeypatch):
    """A stack past the card's shared memory, let through the wrapper's own
    check, is refused by the C side, and the wrapper raises."""
    monkeypatch.setattr(fm, "_MAX_SHARED_BYTES", 1 << 30)
    x = torch.zeros((40, 8), device=cuda_device)
    ws = [torch.zeros((8, 1024), device=cuda_device), torch.zeros((1024, 1), device=cuda_device)]
    bs = [torch.zeros(1024, device=cuda_device), torch.zeros(1, device=cuda_device)]
    fm.reset_launches()
    with pytest.raises(RuntimeError, match="fused_mlp_forward launch failed"):
        fm.mlp_forward(ws, bs, x, fm.mlp_acts(1, "relu"))
    with pytest.raises(RuntimeError, match="fused_mlp_backward launch failed"):
        fm.mlp_backward(ws, bs, x, torch.zeros((40, 1), device=cuda_device), fm.mlp_acts(1, "relu"), True)
    assert fm.LAUNCHES == {"fused_mlp_forward": 0, "fused_mlp_backward": 0}


@pytest.mark.gpu
def test_probe_is_exact(cuda_device):
    pr.reset_launches()
    pr.check_build(cuda_device)
    assert pr.LAUNCHES == {"probe": 1}
    x = torch.randn(pr.PROBE_SHAPE, device=cuda_device)
    assert torch.equal(pr.probe(x), 2 * x)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["siren", "relu_plain"])
def test_fused_model_gradients_on_card_match_cpu(model, cuda_device, full_fp32):
    """One model's parameters on the CPU and on the card: every parameter
    gradient, the hash table's (through dx) included, within 1e-4 of the
    largest."""
    rng = np.random.default_rng(4)
    if model == "siren":
        m = make_siren(3, dim_hidden=32, n_layers=3, device="cpu", seed=2)
        x = torch.from_numpy(rng.uniform(-1, 1, (700, 3)).astype(np.float32))
    else:
        m = make_hash_mlp(3, n_levels=4, n_features_per_level=2, log2_hashmap_size=12, base_resolution=4,
                          finest_resolution=None, per_level_scale=1.5, dim_hidden=64, decoder="relu_plain",
                          device="cpu", seed=2)
        with torch.no_grad():  # a well-conditioned table, not the 1e-4 init
            m.encoder.table.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
        x = torch.from_numpy(rng.random((700, 3), dtype=np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        m.to(dev).zero_grad()
        m(x.to(dev)).square().mean().backward()
        grads[str(dev)] = {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters()}
    for key, want in grads["cpu"].items():
        assert _share(grads[str(cuda_device)][key], want) <= 1e-4, key
