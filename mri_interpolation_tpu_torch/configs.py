"""Run configuration: port of ``mri_interpolation_tpu/configs.py``.

- ``RunConfig``: the fields the port's launcher reads, with the JAX
  package's defaults (the reference's HashConfig);
- the presets ``default_hash_config`` and ``default_siren_config``;
- the tcnn-style JSON encoding config (``load_json_config``, which
  tolerates ``//`` comments, and ``apply_enco_config``);
- the CLI flags: one per scalar field plus the tuple-valued ones
  (``add_config_flags``, ``override_from_args``, ``parse_tuple_flag``);
- the ``config.txt`` provenance dump.

YAML configs (``load_yaml_config``) are not ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple, Union

__all__ = [
    "RunConfig",
    "default_hash_config",
    "default_siren_config",
    "load_json_config",
    "apply_enco_config",
    "parse_tuple_flag",
    "add_config_flags",
    "override_from_args",
    "export_to_txt",
]


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
    w0: float = 30.0
    w0_initial: float = 30.0
    sigma: float = 6.0

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
        """The union of the model factories' keyword arguments; the launcher
        passes each factory those its signature takes."""
        return {
            "dim_in": self.dim_in,
            "w0": self.w0,
            "w0_initial": self.w0_initial,
            "sigma": self.sigma,
            "lr": self.lr,
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


def default_hash_config() -> RunConfig:
    """The reference's HashConfig defaults."""
    return RunConfig()


def default_siren_config() -> RunConfig:
    """SIREN defaults per the reference's BaseConfig and SirenNet."""
    return RunConfig(
        model_class="siren",
        batch_size=4096,
        lr=1e-4,
        dim_hidden=128,
        n_layers=6,
        zero_centered=True,
    )


# ---------------------------------------------------------------------------
# JSON config (tcnn hash_config.json compatibility)


def _strip_line_comment(line: str) -> str:
    """Cut a ``//`` comment, tracking double-quoted string state so a ``//``
    inside a value (e.g. a URL) survives."""
    in_string = False
    i = 0
    while i < len(line):
        c = line[i]
        if c == '"' and (i == 0 or line[i - 1] != "\\"):
            in_string = not in_string
        elif not in_string and c == "/" and line[i : i + 2] == "//":
            return line[:i] + "\n"
        i += 1
    return line


def load_json_config(path: str) -> Dict[str, Any]:
    """Load a JSON config, tolerating ``//`` comments."""
    with open(path) as f:
        return json.loads("".join(_strip_line_comment(line) for line in f))


def apply_enco_config(cfg: RunConfig, enco: Dict[str, Any]) -> RunConfig:
    """Merge a tcnn-style config dict (encoding/network/optimizer/loss
    sections) into a copy of ``cfg``."""
    out = dataclasses.replace(cfg)
    enc = enco.get("encoding", {})
    if enc.get("otype") == "HashGrid":
        out.n_levels = enc.get("n_levels", out.n_levels)
        out.n_features_per_level = enc.get("n_features_per_level", out.n_features_per_level)
        out.log2_hashmap_size = enc.get("log2_hashmap_size", out.log2_hashmap_size)
        out.base_resolution = enc.get("base_resolution", out.base_resolution)
        if "per_level_scale" in enc:
            out.per_level_scale = enc["per_level_scale"]
            out.finest_resolution = None
    net = enco.get("network", {})
    if net:
        out.dim_hidden = net.get("n_neurons", out.dim_hidden)
        out.n_layers = net.get("n_hidden_layers", out.n_layers)
    opt = enco.get("optimizer", {})
    if opt:
        out.lr = opt.get("learning_rate", out.lr)
        if opt.get("beta2") == 0.99 or opt.get("epsilon", 1) <= 1e-12:
            out.optimizer = "adam_tcnn"
        if opt.get("l2_reg"):
            out.weight_decay = opt["l2_reg"]
    loss = enco.get("loss", {})
    if loss.get("otype") == "RelativeL2":
        out.loss = "relative_l2"
    return out


# ---------------------------------------------------------------------------
# CLI flags

# Fields with tuple (or int-or-tuple) values, settable from the CLI as
# "64,64,5" / "(64,64,5)"; nested tuples like interp_shapes accept
# "(352,352,30),(352,352,60)". A bare int stays an int (the hash encoders
# dispatch isotropic/anisotropic on that).
_TUPLE_FIELDS = ("base_resolution", "finest_resolution", "interp_shapes")


def parse_tuple_flag(text: str):
    """Parse a tuple-valued flag string via ast.literal_eval."""
    import ast

    s = text.strip()
    try:
        val = ast.literal_eval(s)
    except (ValueError, SyntaxError):
        try:
            val = ast.literal_eval(f"({s},)") if "," in s else ast.literal_eval(s)
        except (ValueError, SyntaxError) as e:
            raise argparse.ArgumentTypeError(f"cannot parse tuple flag {text!r}: {e}")
    if isinstance(val, list):
        val = tuple(val)
    if isinstance(val, tuple):
        val = tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in val)
    return val


def add_config_flags(parser: argparse.ArgumentParser, cfg: RunConfig) -> None:
    """One flag per scalar config field (default: unset), plus tuple-valued
    flags for resolutions and shapes."""
    for f in fields(cfg):
        if f.type in ("int", "float", "str", "bool", "Optional[int]", "Optional[float]", "Optional[str]"):
            base = f.type.replace("Optional[", "").rstrip("]")
            typ = {"int": int, "float": float, "str": str, "bool": lambda s: s.lower() in ("1", "true", "yes")}[base]
            parser.add_argument(f"--{f.name}", type=typ, default=None, help=f"override {f.name}")
        elif f.name in _TUPLE_FIELDS:
            parser.add_argument(
                f"--{f.name}", type=parse_tuple_flag, default=None,
                help=f"override {f.name} (e.g. '64,64,5' or '(352,352,30),(352,352,60)')",
            )


def override_from_args(cfg: RunConfig, args: argparse.Namespace) -> RunConfig:
    """Write the parsed flags that are set into a copy of ``cfg``."""
    out = dataclasses.replace(cfg)
    for f in fields(cfg):
        v = getattr(args, f.name, None)
        if v is not None:
            if f.name == "interp_shapes":
                # one flat shape -> tuple-of-shapes; a bare int is rejected
                if isinstance(v, int):
                    raise ValueError("interp_shapes needs full shapes, e.g. '(352,352,30)'")
                if isinstance(v, tuple) and v and all(isinstance(s, int) for s in v):
                    v = (v,)
            setattr(out, f.name, v)
    return out


# ---------------------------------------------------------------------------
# Provenance


def export_to_txt(cfg: RunConfig, file_path: str = "") -> None:
    """``config.txt`` provenance dump, one ``name : value`` line per field."""
    with open(file_path + "config.txt", "w") as f:
        for fld in fields(cfg):
            f.write(f"{fld.name} : {getattr(cfg, fld.name)}\n")
