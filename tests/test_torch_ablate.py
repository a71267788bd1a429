"""The fused-MLP ablation tool (``mri_interpolation_tpu_torch.ablate``) on
the CPU: every cut and every variant still matches the source, and the tool
runs only on the card."""

import pytest
import torch

from mri_interpolation_tpu_torch import ablate
from mri_interpolation_tpu_torch.ops import build


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


def test_a_stale_cut_raises():
    with pytest.raises(ValueError, match="matches 0 times"):
        ablate.cut_source("no kernel here", "trig")


def test_runs_only_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ablate.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ablate.main([])
