"""The ablation tool (``mri_interpolation_tpu_torch.ablate``) on the CPU:
every cut and every variant still matches its source (fused_mlp.cu, or
hash_encode.cu for the coarse pair), the plan variants keep kernel 4's plan
valid, and the tool and ``ablate_staged`` run only on the card."""

import pytest
import torch

from mri_interpolation_tpu_torch import ablate, ablate_staged
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.ops import build
from mri_interpolation_tpu_torch.ops import hash_encode as he


@pytest.mark.parametrize("cut", sorted(ablate.CUTS))
def test_every_cut_matches_the_source_once(cut):
    source = build.SOURCES["fused_mlp"].read_text()
    cut_text = ablate.cut_source(source, cut)
    assert (cut_text == source) == (cut == "none")


@pytest.mark.parametrize("variant", sorted(ablate.VARIANTS))
def test_every_variant_matches_the_source_once(variant):
    source = build.SOURCES["fused_mlp"].read_text()
    assert ablate.cut_source(source, variant) != source
    assert variant not in ablate.CUTS


@pytest.mark.parametrize("cut", sorted(ablate.COARSE_CUTS))
def test_every_coarse_cut_matches_the_source_once(cut):
    source = build.SOURCES["hash_encode"].read_text()
    assert ablate.SOURCE_OF[cut] == "hash_encode"
    assert (ablate.cut_source(source, cut) == source) == (cut == "coarse_none")


@pytest.mark.parametrize("variant", sorted(ablate.PLAN_VARIANTS))
def test_plan_variants_keep_the_source_and_a_valid_plan(variant):
    source = build.SOURCES["hash_encode"].read_text()
    assert ablate.cut_source(source, variant) == source
    enc = HashGridEncoding(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                           finest_resolution=None, per_level_scale=1.4)
    for n in (1, 517, 123_904):
        plan = he.coarse_grad_plan(enc, he.coarse_onehot_levels(enc), n)
        other = ablate.PLAN_VARIANTS[variant](plan)
        assert other.grid % other.cluster == 0 and other.cluster in (1, 2, 4, 8)
        assert other.shared_bytes == plan.shared_bytes // plan.copies * other.copies


def test_a_stale_cut_raises():
    with pytest.raises(ValueError, match="matches 0 times"):
        ablate.cut_source("no kernel here", "trig")


@pytest.mark.parametrize("tool", [ablate, ablate_staged], ids=["ablate", "ablate_staged"])
def test_runs_only_on_the_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
