"""The numerics of the fused-MLP backward kernel's tensor-core products.

``csrc/fused_mlp.cu``'s backward kernels form every product of a layer on the
tensor cores in "3xTF32": each fp32 operand a is split into hi = tf32(a)
(``cvt.rna.tf32.f32``: round to nearest, ties away, 10 mantissa bits kept) and
lo = tf32(a - hi), and a*b is taken as hi*hi' + hi*lo' + lo*hi', each a
product of two 11-bit mantissas (exact in fp32), summed in fp32. The dropped
lo*lo' term and the rounding of lo leave about 2^-21 of |a*b|, against 2^-24
for an fp32 product and 2^-11 for plain TF32.

This file emulates that arithmetic in torch on the CPU and holds the
forward, dW, db and dx of the main paths' stacks against float64, at a
quarter of the tolerances that ``chip_smoke.py`` and the card tests hold the
kernel to (``MLP_SHARE`` = 1e-5 of the largest value for relu stacks,
``MLP_SINE_SHARE`` = 1e-4 with sine layers). Every layer kind passes, so the
kernel puts every layer on the tensor cores; the same emulation with plain
TF32 fails at w0 = 30, which is why the kernel does not use it.
"""

import numpy as np
import pytest
import torch

from mri_interpolation_tpu_torch.models import make_hash_mlp, make_multi_hash_mlp, make_multi_siren, make_siren
from mri_interpolation_tpu_torch.ops import fused_mlp as fm

MLP_SHARE, MLP_SINE_SHARE = 1e-5, 1e-4  # chip_smoke.py
MARGIN = 4.0


def tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), as cvt.rna.tf32.f32:
    add half of the 13 dropped bits to the magnitude, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: the two small cross terms, then hi*hi'."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def forward_backward(ws, bs, x, g, acts, mm):
    """The fused stack's forward and backward (``fm.mlp_backward_reference``'s
    algorithm) with every matrix product taken by ``mm``; returns
    (out, dWs, dbs, dx)."""
    hs, zs = [x], []
    for w, b, a in zip(ws, bs, acts):
        zs.append(mm(hs[-1], w) + b)
        hs.append(fm.act_apply(a, zs[-1]))
    dws, dbs = [None] * len(ws), [None] * len(ws)
    dz = g * fm.act_grad(acts[-1], zs[-1])
    for l in range(len(ws) - 1, -1, -1):
        dws[l] = mm(hs[l].T.contiguous(), dz)
        dbs[l] = dz.sum(dim=0)
        dz_w = mm(dz, ws[l].T.contiguous())
        if l > 0:
            dz = dz_w * fm.act_grad(acts[l - 1], zs[l - 1])
    return hs[-1], dws, dbs, dz_w


def _siren_stack(model):
    layers = model.params["layers"] + [model.params["last"]]
    return ([l["w"].detach() for l in layers], [l["b"].detach() for l in layers],
            fm.siren_acts(model.n_layers, model.w0, model.w0_initial))


def stack(name: str, n: int = 384):
    """(weights, biases, x, g, acts) of one main-path stack, from its model's
    own initialisation; x as that path feeds it, g ~ N(0, 1)."""
    rng = np.random.default_rng(7)
    coords = lambda d: torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype(np.float32))  # noqa: E731
    if name == "path_a":  # SIREN preset 3 -> 128 x 6 -> 1, w0 = 30
        ws, bs, acts = _siren_stack(make_siren(3, dim_hidden=128, n_layers=6, device="cpu", seed=1))
        x = coords(3)
    elif name == "siren_352x5":
        ws, bs, acts = _siren_stack(make_siren(3, dim_hidden=352, n_layers=5, device="cpu", seed=1))
        x = coords(3)
    elif name in ("multi_siren_encoder", "multi_siren_decoder"):
        model = make_multi_siren(dim_in=2, dim_hidden=128, n_layers=4, n_frames=2, device="cpu", seed=1)
        enc = model.encoders.params(0)
        enc_ws = [l["w"].detach() for l in enc["layers"] + [enc["last"]]]
        enc_bs = [l["b"].detach() for l in enc["layers"] + [enc["last"]]]
        acts = fm.siren_acts(4, model.w0, model.w0_initial)
        x = coords(2)
        if name == "multi_siren_encoder":
            ws, bs = enc_ws, enc_bs
        else:  # the decoder takes the encoder's features
            dec = model.decoder.params()
            x = fm.mlp_forward_reference(enc_ws, enc_bs, x, acts)
            ws = [l["w"].detach() for l in dec["layers"] + [dec["last"]]]
            bs = [l["b"].detach() for l in dec["layers"] + [dec["last"]]]
    elif name == "path_b":  # relu_plain 32 -> 128 -> 1 behind the tcnn encoder, dx on
        model = make_hash_mlp(3, n_levels=16, n_features_per_level=2, log2_hashmap_size=12, base_resolution=16,
                              per_level_scale=1.4, dim_hidden=128, n_layers=2, decoder="relu_plain",
                              device="cpu", seed=1)
        ws = [l.params["w"].detach() for l in model.layers]
        bs = [l.params["b"].detach() for l in model.layers]
        acts = fm.mlp_acts(1, "relu")
        x = torch.from_numpy(rng.uniform(-1, 1, (n, 32)).astype(np.float32))
    elif name == "multi_hash_decoder":  # relu 20 -> 64 -> 1 behind ten levels x F = 2, dx on
        model = make_multi_hash_mlp(dim_in=2, n_frames=2, n_levels=10, log2_hashmap_size=12, base_resolution=16,
                                    per_level_scale=1.4, dim_hidden=64, device="cpu", seed=1)
        ws = [l.params["w"].detach() for l in model.decoder]
        bs = [l.params["b"].detach() for l in model.decoder]
        acts = fm.mlp_acts(1, "relu")
        x = torch.from_numpy(rng.uniform(-1, 1, (n, 20)).astype(np.float32))
    else:
        raise KeyError(name)
    g = torch.from_numpy(rng.standard_normal((n, ws[-1].shape[1])).astype(np.float32))
    return ws, bs, x, g, acts


STACKS = ["path_a", "multi_siren_encoder", "multi_siren_decoder", "siren_352x5", "path_b", "multi_hash_decoder"]


def shares(name: str, mm) -> dict:
    """Largest |emulated - float64| / max |float64| of the output, every dW,
    every db and dx."""
    ws, bs, x, g, acts = stack(name)
    got = forward_backward(ws, bs, x, g, acts, mm)
    want = forward_backward([w.double() for w in ws], [b.double() for b in bs], x.double(), g.double(), acts,
                            mm_plain)
    out = {"out": got[0], **{f"dW{l}": t for l, t in enumerate(got[1])},
           **{f"db{l}": t for l, t in enumerate(got[2])}, "dx": got[3]}
    ref = {"out": want[0], **{f"dW{l}": t for l, t in enumerate(want[1])},
           **{f"db{l}": t for l, t in enumerate(want[2])}, "dx": want[3]}
    return {k: float((out[k].double() - ref[k]).abs().max() / ref[k].abs().max()) for k in out}


def tolerance(name: str) -> float:
    return MLP_SHARE if name in ("path_b", "multi_hash_decoder") else MLP_SINE_SHARE


@pytest.mark.parametrize("name", STACKS)
def test_3xtf32_sits_four_times_under_the_tolerance(name):
    worst = shares(name, mm_3xtf32)
    limit = tolerance(name) / MARGIN
    assert max(worst.values()) <= limit, {k: v for k, v in worst.items() if v > limit}


def test_plain_tf32_would_break_the_sine_tolerance():
    """Why the kernel splits: one TF32 product per term misses path A's
    tolerance itself, not only the margin."""
    assert max(shares("path_a", mm_tf32).values()) > MLP_SINE_SHARE


def test_tf32_rounding():
    a = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -(1.0 + 2**-11), 3.0e-5, 0.0])
    # ties go away from zero; 10 explicit mantissa bits survive
    assert tf32(a).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), tf32(a)[4].item(), 0.0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0**-21
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0**-11
