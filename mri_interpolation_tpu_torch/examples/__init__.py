"""Runnable, asserted examples (port of ``examples/``):

- ``tutorial``: the model-family progression of the reference's notebook
  (MLP -> RFF -> SIREN -> modulated SIREN -> hash grid) on a small synthetic
  volume;
- ``motion_interpolation``: the warp INR against linear interpolation on a
  moving blob, then the stacked fusion of the registration and linear
  families;
- ``smoke_mlp``: the reference's ``test_script.py`` (an 8-layer ReLU MLP,
  352 wide, batch 20000) as a checked run.

Each runs as ``python -m mri_interpolation_tpu_torch.examples.<name>``, on
the card unless ``--device cpu`` is given.
"""
