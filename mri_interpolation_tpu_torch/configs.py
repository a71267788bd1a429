"""Run configuration: port of ``mri_interpolation_tpu/configs.py``.

- ``RunConfig``: the fields the port's launcher reads, with the JAX
  package's defaults (the reference's HashConfig);
- the presets ``default_hash_config`` and ``default_siren_config``;
- the tcnn-style JSON encoding config (``load_json_config``, which
  tolerates ``//`` comments, and ``apply_enco_config``);
- the CLI flags: one per scalar field plus the tuple-valued ones
  (``add_config_flags``, ``override_from_args``, ``parse_tuple_flag``);
- the hydra-style YAML run config (``load_yaml_config``) through
  ``parse_yaml``, a reader of the YAML subset the schema uses (PyYAML is not
  a dependency of the port);
- the ``config.txt`` provenance dump and its reader (``parse_config_txt``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple, Union

__all__ = [
    "RunConfig",
    "default_hash_config",
    "default_siren_config",
    "load_json_config",
    "load_yaml_config",
    "parse_yaml",
    "apply_enco_config",
    "parse_tuple_flag",
    "add_config_flags",
    "override_from_args",
    "export_to_txt",
    "parse_config_txt",
]


@dataclass
class RunConfig:
    # --- data
    image_path: str = "sample_ankle_dyn_mri.nii.gz"
    slice_z: Optional[int] = None        # take the (x, y, t) slice at this z
    even_frames_only: bool = False       # train on the even frames, score the held-out odd ones
    undersample_pct: float = 0.0         # >0: train on this % of the voxels, kept at random (seed)
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
    data_parallel: bool = False          # at world size > 1: DataParallelTrainer (parallel/)
    shard_tables: bool = False           # at world size > 1: ShardedHashTrainer (parallel/)
    stream_shard_voxels: int = 0         # >0: out-of-core fit, this many voxels on the device at a time

    # --- model
    model_class: str = "hash_mlp"
    dim_in: int = 0                      # 0 -> derived from the volume at run time
    dim_hidden: int = 64
    dim_out: int = 1
    n_layers: int = 2
    w0: float = 30.0
    w0_initial: float = 30.0
    sigma: float = 6.0
    n_frequencies: int = 128             # rff_net / freq_mlp: Fourier features or encoder width
    n_frequencies_t: int = 15            # freq_mlp: the temporal encoder's
    n_sample: int = 5                    # psf_siren: PSF points per axis
    encoder_type: str = "hash"           # freq_mlp: gabor | siren | frequency | rff ("hash" raises there)
    skip_connections: Tuple[int, ...] = ()  # freq_mlp: decoder blocks that take the encoding again
    # warp_inr (motion-compensated INR)
    warp_scale: float = 0.05
    warp_w0: float = 5.0
    warp_hidden: int = 64
    warp_layers: int = 3
    residual_scale: float = 0.0          # >0: a small zero-initialised appearance residual

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
    checkpoint_path: Optional[str] = None  # resume: a checkpoints directory (its latest step)
    save_checkpoint: bool = True
    checkpoint_every_epochs: int = 0     # >0: also checkpoint every k epochs
    eval_every_epochs: int = 0           # >0: eval PSNR into scalars.jsonl every k epochs
    save_latents: bool = False           # write the encoder features (latents.nii.gz) of a split model
    tb_events: bool = False              # also export scalars.jsonl as a TensorBoard event file under tb/
    remat: bool = False                  # recompute the forward in the backward (memory for FLOPs)

    def model_kwargs(self) -> dict:
        """The union of the model factories' keyword arguments; the launcher
        passes each factory those its signature takes."""
        return {
            "dim_in": self.dim_in,
            "w0": self.w0,
            "w0_initial": self.w0_initial,
            "sigma": self.sigma,
            "n_sample": self.n_sample,
            "n_frequencies": self.n_frequencies,
            "n_frequencies_t": self.n_frequencies_t,
            "encoder_type": self.encoder_type,
            "skip_connections": self.skip_connections,
            "weight_decay": self.weight_decay,
            "warp_scale": self.warp_scale,
            "warp_w0": self.warp_w0,
            "warp_hidden": self.warp_hidden,
            "warp_layers": self.warp_layers,
            "residual_scale": self.residual_scale,
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
# YAML config: a reader of the subset the run-config schema uses

_YAML_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.-]*):(?:\s+(.*))?$")
_YAML_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_YAML_FLOAT = re.compile(r"^[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?$")
_YAML_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False}
_YAML_NULL = ("null", "Null", "NULL", "~")
# plain scalars that YAML 1.1 (PyYAML) and YAML 1.2 read differently, or that the subset leaves out
_YAML_11_BOOL = r"[yY]|[nN]|yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"
_YAML_AMBIGUOUS = re.compile(rf"^({_YAML_11_BOOL}|[-+]?\.(inf|Inf|INF|nan|NaN|NAN)|[-+]?0[0-9_]+|[-+]?0[xXoObB].*"
                             r"|[-+]?[0-9][0-9_]*_[0-9_]*(\.[0-9_]*)?([eE][-+]?[0-9]+)?"
                             r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?)$")
_YAML_AMBIGUOUS_KEY = re.compile(rf"^({_YAML_11_BOOL})$")
_YAML_INDICATORS = "&*!|>%@`{}[],?'\"#-:"


class YamlSubsetError(ValueError):
    """YAML outside the subset that ``parse_yaml`` reads."""


def _yaml_error(lineno: int, msg: str) -> YamlSubsetError:
    return YamlSubsetError(f"line {lineno}: {msg} (the reader takes nested mappings, scalars and flow lists)")


def _strip_yaml_comment(text: str) -> str:
    """Cut a `` #`` comment outside quotes."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _yaml_quoted(text: str, lineno: int):
    """(the string, the rest) of a quoted scalar at the start of ``text``."""
    q = text[0]
    out, i = [], 1
    escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in escapes:
                raise _yaml_error(lineno, f"escape \\{esc} in a double-quoted string")
            out.append(escapes[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise _yaml_error(lineno, "a quoted string that does not end on its line")


def _yaml_plain(text: str, lineno: int):
    """The value of a plain (unquoted) scalar."""
    if not text:
        return None
    if text[0] in _YAML_INDICATORS and not (text[0] in "-:?" and len(text) > 1 and text[1] not in " ,[]{}"):
        raise _yaml_error(lineno, f"{text!r} starts with an indicator the subset leaves out")
    if ": " in text or text.endswith(":") or " #" in text or "\t" in text:
        raise _yaml_error(lineno, f"{text!r} is not a plain scalar")
    if _YAML_AMBIGUOUS.match(text):
        raise _yaml_error(lineno, f"{text!r} reads differently in YAML 1.1 and 1.2; quote it or write it out")
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if text in _YAML_NULL:
        return None
    if _YAML_INT.match(text):
        return int(text)
    if _YAML_FLOAT.match(text):
        return float(text)
    return text


def _yaml_flow(text: str, lineno: int):
    """(the list, the rest) of a flow sequence at the start of ``text``."""
    items, rest = [], text[1:].lstrip()
    if rest.startswith("]"):
        return items, rest[1:]
    while True:
        if rest.startswith("["):
            item, rest = _yaml_flow(rest, lineno)
        elif rest[:1] in ("'", '"'):
            item, rest = _yaml_quoted(rest, lineno)
        else:
            m = re.match(r"[^,\[\]{}]*", rest)
            token = m.group(0).strip()
            if not token:
                raise _yaml_error(lineno, "an empty item in a flow list")
            item, rest = _yaml_plain(token, lineno), rest[m.end():]
        items.append(item)
        rest = rest.lstrip()
        if rest.startswith(","):
            rest = rest[1:].lstrip()
            if rest.startswith("]"):
                raise _yaml_error(lineno, "a trailing comma in a flow list")
            continue
        if rest.startswith("]"):
            return items, rest[1:]
        raise _yaml_error(lineno, f"a flow list that does not close: {text!r}")


def _yaml_value(text: str, lineno: int):
    if text.startswith("["):
        value, rest = _yaml_flow(text, lineno)
    elif text[:1] in ("'", '"'):
        value, rest = _yaml_quoted(text, lineno)
    else:
        return _yaml_plain(text, lineno)
    if rest.strip():
        raise _yaml_error(lineno, f"text after a value: {rest.strip()!r}")
    return value


def parse_yaml(text: str):
    """Read the YAML subset of the run-config schema: nested mappings by
    indentation (spaces), plain keys; scalars: ints, floats (``0.5``,
    ``1e-3``, ``1.0e-5``), ``true``/``false``, ``null``/``~``/empty,
    single- and double-quoted strings, plain strings; flow lists ``[8, 8,
    2]``, nested ones ``[[16, 16, 8]]``; ``#`` comments. Returns what
    ``yaml.safe_load`` returns for such a document (``None`` for an empty
    one), except that ``1e-3`` is the float of YAML 1.2's core schema
    (PyYAML, on YAML 1.1, reads a float without a dot as a string).

    Raises ``YamlSubsetError`` on anything else, never misreading it:
    anchors and aliases, tags, block sequences (``- item``), block scalars
    (``|``, ``>``), flow mappings, multi-line values, documents markers,
    duplicate keys, tabs in indentation, and the plain scalars (and keys)
    that YAML 1.1 and 1.2 read differently (``yes``/``no``/``on``/``off``, octal,
    hexadecimal, ``1_000``, sexagesimal, ``.inf``/``.nan``)."""
    root: dict = {}
    stack: list = []  # (indentation, mapping), the root first
    pending = None  # (indentation, mapping, key) of a key whose value may be the block below it
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_yaml_comment(raw)
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body.startswith("\t"):
            raise _yaml_error(lineno, "a tab in the indentation")
        if body in ("---", "...") or body.startswith("--- ") or body.startswith("%"):
            raise _yaml_error(lineno, "document markers and directives")
        if body.startswith("- ") or body == "-":
            raise _yaml_error(lineno, "a block sequence; write a flow list [a, b]")
        m = _YAML_KEY.match(body)
        if not m:
            raise _yaml_error(lineno, f"not a 'key: value' line: {body!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if key in _YAML_BOOL or key in _YAML_NULL or _YAML_AMBIGUOUS_KEY.match(key):
            raise _yaml_error(lineno, f"the key {key!r} is not a plain string in every YAML version")
        if not stack:
            stack.append((indent, root))
        if pending is not None and indent > pending[0]:
            child: dict = {}
            pending[1][pending[2]] = child
            stack.append((indent, child))
        pending = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise _yaml_error(lineno, f"indentation {indent} matches no enclosing mapping")
        mapping = stack[-1][1]
        if key in mapping:
            raise _yaml_error(lineno, f"duplicate key {key!r}")
        mapping[key] = _yaml_value(value, lineno) if value else None
        if not value:
            pending = (indent, mapping, key)
    return root if stack else None


def load_yaml_config(path: str, base: Optional[RunConfig] = None) -> RunConfig:
    """Load a hydra-style YAML run config into a RunConfig (JAX
    ``configs.load_yaml_config``, read by :func:`parse_yaml`).

    Understands the reference ``config/base.yaml`` schema (sections
    ``training`` / ``siren`` (model) / ``encoding`` / ``datamodule`` /
    ``optimizer``) plus a flat ``run:`` section whose keys are RunConfig
    field names verbatim. Unknown keys are ignored."""
    with open(path) as f:
        doc = parse_yaml(f.read()) or {}
    cfg = dataclasses.replace(base if base is not None else RunConfig())
    known = {f.name for f in fields(cfg)}

    def put(name: str, value: Any) -> None:
        if name in known and value is not None:
            if isinstance(value, list):
                value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
            setattr(cfg, name, value)

    for k, v in (doc.get("run") or {}).items():
        put(k, v)
    for k, v in (doc.get("training") or {}).items():
        put(k, v)
    # the model section: the reference names it after the model family ("siren:"); "model:" too
    model = doc.get("model") or doc.get("siren") or {}
    if model:
        cls = model.get("cls") or model.get("_target_")
        if cls:
            cfg.model_class = _MODEL_CLASS_ALIASES.get(cls, str(cls))
        for k, v in model.items():
            put({"w0initial": "w0_initial"}.get(k, k), v)
    enc = doc.get("encoding") or {}
    if enc:
        cfg = apply_enco_config(cfg, {"encoding": enc})
    dm = doc.get("datamodule") or {}
    if dm:
        put("image_path", dm.get("mri_path"))
        put("output_root", dm.get("output_path"))
        if isinstance(dm.get("batch_size"), int) and dm["batch_size"] > 1:
            cfg.batch_size = dm["batch_size"]
    opt = doc.get("optimizer") or {}
    if opt and opt.get("_target_") not in (None, "FakeOptimizer"):
        put("optimizer", str(opt["_target_"]).lower())
    if opt:
        lr = opt.get("lr")  # an explicit lr: 0 is honoured
        if lr is None:
            lr = opt.get("learning_rate")
        put("lr", lr)
    return cfg


# the reference's class names -> registry names
_MODEL_CLASS_ALIASES = {
    "SirenNet": "siren",
    "HashMLP": "hash_mlp",
    "ModulatedSirenNet": "modulated_siren",
    "GaborNet": "gabor",
    "RffNet": "rff_net",
    "PsfSirenNet": "psf_siren",
    "TcnnHashMLP": "hash_mlp",
}


# ---------------------------------------------------------------------------
# CLI flags

# Fields with tuple (or int-or-tuple) values, settable from the CLI as
# "64,64,5" / "(64,64,5)"; nested tuples like interp_shapes accept
# "(352,352,30),(352,352,60)". A bare int stays an int (the hash encoders
# dispatch isotropic/anisotropic on that).
_TUPLE_FIELDS = ("base_resolution", "finest_resolution", "interp_shapes", "skip_connections")


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
            elif f.name == "skip_connections" and isinstance(v, int):
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


def parse_config_txt(path: str) -> Dict[str, str]:
    """A ``config.txt`` back as {name: value text}."""
    out = {}
    with open(path) as f:
        for line in f:
            if " : " in line:
                k, v = line.split(" : ", 1)
                out[k.strip()] = v.strip()
    return out
