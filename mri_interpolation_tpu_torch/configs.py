"""Run configuration (port of the ``RunConfig`` fields of
``mri_interpolation_tpu/configs.py`` that the launcher's default path reads,
with the same defaults: the reference's HashConfig)."""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple, Union

__all__ = ["RunConfig", "export_to_txt"]


@dataclass
class RunConfig:
    # --- data
    image_path: str = "sample_ankle_dyn_mri.nii.gz"
    slice_z: Optional[int] = None        # take the (x, y, t) slice at this z
    even_frames_only: bool = False       # not ported yet (ROADMAP.md)
    undersample_pct: float = 0.0         # not ported yet (ROADMAP.md)
    zero_centered: bool = False          # coords/values in [-1, 1]

    # --- training
    batch_size: int = 10000
    epochs: int = 1
    lr: float = 5e-3
    weight_decay: float = 0.0
    accumulate_grad_batches: int = 1
    seed: int = 1337
    loss: str = "mse"
    optimizer: str = "adam"
    lr_schedule: Optional[str] = None
    cosine_t_max: int = 10
    data_parallel: bool = False          # not ported yet (ROADMAP.md)
    shard_tables: bool = False           # not ported yet (ROADMAP.md)
    stream_shard_voxels: int = 0         # not ported yet (ROADMAP.md)

    # --- model
    model_class: str = "hash_mlp"
    dim_in: int = 0                      # 0 -> derived from the volume at run time
    dim_hidden: int = 64
    dim_out: int = 1
    n_layers: int = 2

    # --- hash encoding
    n_levels: int = 4
    n_features_per_level: int = 1
    log2_hashmap_size: int = 23
    base_resolution: Union[int, Tuple[int, ...]] = (64, 64, 5)
    finest_resolution: Union[int, Tuple[int, ...], None] = (352, 352, 15)
    per_level_scale: Optional[float] = None
    dropout: float = 0.0
    decoder: str = "norm"
    growth: str = "reference"
    temporal_tv: float = 0.0
    level_anneal_steps: int = 0

    # --- inference / output
    interp_shapes: Tuple[Tuple[int, ...], ...] = ((352, 352, 30),)
    output_root: str = "runs"
    save_checkpoint: bool = True

    def model_kwargs(self) -> dict:
        """Keyword arguments of the model factory (``make_hash_mlp``)."""
        return {
            "dim_in": self.dim_in,
            "n_levels": self.n_levels,
            "n_features_per_level": self.n_features_per_level,
            "log2_hashmap_size": self.log2_hashmap_size,
            "base_resolution": self.base_resolution,
            "finest_resolution": self.finest_resolution,
            "per_level_scale": self.per_level_scale,
            "dim_hidden": self.dim_hidden,
            "dim_out": self.dim_out,
            "n_layers": self.n_layers,
            "dropout_rate": self.dropout,
            "decoder": self.decoder,
            "growth": self.growth,
            "temporal_tv": self.temporal_tv,
            "level_anneal_steps": self.level_anneal_steps,
            "seed": self.seed,
        }


def export_to_txt(cfg: RunConfig, file_path: str = "") -> None:
    """``config.txt`` provenance dump, one ``name : value`` line per field."""
    with open(file_path + "config.txt", "w") as f:
        for fld in fields(cfg):
            f.write(f"{fld.name} : {getattr(cfg, fld.name)}\n")
