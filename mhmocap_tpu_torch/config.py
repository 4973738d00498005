"""Config / flag system: argparse + a YAML-subset reader, no PyYAML.

Port of `mhmocap_tpu/config.py`: the same CLI flags, the same YAML
layout (an `ARGS:` mapping merged into the namespace with CLI
precedence, plus the `smpl:` / `data:` / `studio:` / `internet:`
sub-dicts attached as attributes) and `--input_path` overriding
`data['data_path']`. One flag is new: `--device` (default `cuda`), the
counterpart of `JAX_PLATFORMS`.

The machine with the GPU has no PyYAML, so `load_yaml` reads the subset
the repo's configs use and `dump_yaml` writes it: block mappings (nested
by indentation), block and flow lists, single- and double-quoted and
plain scalars, null, the YAML 1.1 booleans (true/false/yes/no/on/off in
their three cases), decimal ints and floats as PyYAML resolves them
(`0.0001`, `1.0e-05`, `.inf`; `1e-05` stays a string), and comments.
Anything else (anchors, tags, multi-line scalars, flow mappings other
than `{}`, ...) raises ValueError.
"""

from __future__ import annotations

import argparse
import math
import os
import re
import subprocess
import sys
from typing import Any, List, Optional

PROJECT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------

_BOOL = {v: b for b, words in ((True, ("yes", "true", "on")),
                               (False, ("no", "false", "off")))
         for w in words for v in (w, w.capitalize(), w.upper())}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)"
                    r"([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
# YAML 1.1 forms PyYAML resolves that this reader does not
_OTHER_NUMBER = re.compile(r"[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|"
                           r"[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?)$")
_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")
_KEY = re.compile(r"([^\s'\"#\[\]{},:&*!|>%@`-][^#:]*?|'[^']*'|\"[^\"]*\")"
                  r"\s*:(\s+|$)")


def _strip_comment(line: str) -> str:
    """Drop a comment (a '#' at the start or after whitespace, outside
    quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        body = tok[1:-1]
        if re.search(r'\\[^\\"nt]', body):
            raise ValueError(f"unsupported YAML escape in {tok!r}")
        return re.sub(r'\\(.)', lambda m: {"n": "\n", "t": "\t"}.get(
            m.group(1), m.group(1)), body)
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _INF.match(tok):
        return -math.inf if tok[0] == "-" else math.inf
    if _NAN.match(tok):
        return math.nan
    if _OTHER_NUMBER.match(tok):
        raise ValueError(f"YAML number form {tok!r} is not supported")
    if tok[0] in "'\"&*!|>%@`{[]}," or tok.startswith(("- ", "? ")) \
            or ": " in tok or tok.endswith(":"):
        raise ValueError(f"unsupported YAML scalar {tok!r}")
    return tok


def _flow(text: str) -> Any:
    """A flow list `[a, b, [c]]` of scalars, or the empty mapping `{}`."""
    text = text.strip()
    if text == "{}":
        return {}
    if not (text.startswith("[") and text.endswith("]")):
        raise ValueError(f"unsupported YAML flow value {text!r}")
    out, stack, tok, quote = [], [], "", None
    cur = out
    for ch in text[1:-1]:
        if quote:
            tok += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            tok += ch
        elif ch == "[":
            stack.append(cur)
            cur.append([])
            cur = cur[-1]
        elif ch == "]":
            if tok.strip():
                cur.append(_scalar(tok))
            tok = ""
            cur = stack.pop()
        elif ch == ",":
            if tok.strip():
                cur.append(_scalar(tok))
            tok = ""
        elif ch in "{}":
            raise ValueError(f"unsupported YAML flow value {text!r}")
        else:
            tok += ch
    if quote or stack:
        raise ValueError(f"unbalanced YAML flow value {text!r}")
    if tok.strip():
        cur.append(_scalar(tok))
    return out


def _value(text: str) -> Any:
    text = text.strip()
    if text[:1] in "[{":
        return _flow(text)
    return _scalar(text)


def load_yaml(text: str) -> Any:
    """Parse the YAML subset of the module docstring."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tab indentation in YAML")
        line = _strip_comment(raw)
        if line.strip() in ("---", "..."):
            raise ValueError("YAML document markers are not supported")
        if line.strip():
            lines.append((len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected YAML line {lines[pos][1]!r}")
    return value


def _block(lines, pos, indent):
    """The block node starting at lines[pos] with this indentation."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        return _block_list(lines, pos, indent)
    if _KEY.match(lines[pos][1]):
        return _block_map(lines, pos, indent)
    if len(lines) == pos + 1 or lines[pos + 1][0] < indent:
        return _value(lines[pos][1]), pos + 1
    raise ValueError(f"unsupported YAML (multi-line scalar?) at "
                     f"{lines[pos][1]!r}")


def _child(lines, pos, indent, inline, allow_same_indent):
    """The value of a key or list item: inline text, or the nested
    block on the following lines."""
    if inline:
        return _value(inline), pos
    if pos < len(lines):
        ind, text = lines[pos]
        nested = ind > indent or (allow_same_indent and ind == indent
                                  and (text.startswith("- ")
                                       or text == "-"))
        if nested:
            return _block(lines, pos, ind)
    return None, pos


def _block_map(lines, pos, indent):
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        text = lines[pos][1]
        m = _KEY.match(text)
        if not m:
            raise ValueError(f"expected a YAML key at {text!r}")
        key = _scalar(m.group(1))
        if key in out:
            raise ValueError(f"duplicate YAML key {key!r}")
        out[key], pos = _child(lines, pos + 1, indent, text[m.end():], True)
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"bad YAML indentation at {lines[pos][1]!r}")
    return out, pos


def _block_list(lines, pos, indent):
    out = []
    while pos < len(lines) and lines[pos][0] == indent and \
            (lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
        inline = lines[pos][1][1:].strip()
        if inline and (_KEY.match(inline) or inline.startswith("- ")):
            raise ValueError(f"compact YAML nesting is not supported: "
                             f"{lines[pos][1]!r}")
        item, pos = _child(lines, pos + 1, indent, inline, False)
        out.append(item)
    return out, pos


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:                 # 1e-05 -> 1.0e-05
            mant, _, exp = r.partition("e")
            r = mant + ".0" + ("e" + exp if exp else "")
        return r
    if isinstance(v, str):
        if "\n" in v:
            raise ValueError("multi-line strings are not supported")
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"cannot write {type(v).__name__} as YAML")


def dump_yaml(data: Any, indent: int = 0) -> str:
    """Block-style YAML that `load_yaml` and `yaml.full_load` read back
    as `data` (dicts of dicts, lists of scalars, scalars)."""
    pad = " " * indent
    if isinstance(data, dict):
        if not data:
            return pad + "{}\n"
        out = []
        for k, v in data.items():
            key = k if isinstance(k, str) and _PLAIN_KEY.match(k) \
                and _scalar(k) == k else _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
            else:
                out.append(f"{pad}{key}: " + dump_yaml(v).strip() + "\n")
        return "".join(out)
    if isinstance(data, (list, tuple)):
        return pad + "[" + ", ".join(dump_yaml(v).strip()
                                     for v in data) + "]\n"
    return pad + _dump_scalar(data) + "\n"


# ---------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Scene-Aware 3D Multi-Human Motion Capture (PyTorch)")
    p.add_argument("-f", type=str, help="compat placeholder")
    p.add_argument("--configs_yml", type=str, default="configs/default.yml")
    p.add_argument("--ts_id", type=int, default=1)
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--cmu_sequence_id", type=str, default="")
    p.add_argument("--cmu_camera_node", type=int, default=16)
    p.add_argument("--cmu_clip_id", type=int, default=1)
    p.add_argument("--input_path", type=str, default="")
    p.add_argument("--output_path", type=str, default="./output")
    p.add_argument("--batch_size", type=int, default=4,
                   help="frames per scan chunk (reference: DataLoader "
                        "batch)")
    p.add_argument("--resize_factor", type=float, default=0.25)
    p.add_argument("--num_iter", type=int, default=200)
    p.add_argument("--proj2d_loss_coef", type=float, default=1.0)
    p.add_argument("--depth_loss_coef", type=float, default=1.0)
    p.add_argument("--silhouette_loss_coef", type=float, default=1.0)
    p.add_argument("--reg_velocity_coef", type=float, default=1.0)
    p.add_argument("--reg_verts_filter_coef", type=float, default=1.0)
    p.add_argument("--reg_poses_coef", type=float, default=10.0)
    p.add_argument("--reg_scales_coef", type=float, default=10.0)
    p.add_argument("--reg_contact_coef", type=float, default=1.0)
    p.add_argument("--reg_foot_sliding_coef", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the fit and of the batched "
                        "ingestion work ('cuda' or 'cpu'); without a GPU "
                        "the entry points fail unless it is 'cpu'")
    return p


def parse_args(input_args: Optional[List[str]] = None):
    """Parse CLI args, then fill everything else from the YAML's ARGS
    mapping (CLI wins). Sub-dicts smpl/data/studio/internet become
    attributes, and --input_path overrides data['data_path']."""
    parser = _build_parser()
    parsed = parser.parse_args(args=input_args)

    yml = parsed.configs_yml
    if not os.path.isabs(yml):
        candidate = os.path.join(PROJECT_DIR, yml)
        yml = candidate if os.path.exists(candidate) else yml
    with open(yml) as f:
        updates = load_yaml(f.read()) or {}

    given = set()
    for arg in (input_args or []):
        if isinstance(arg, str) and arg.startswith("--"):
            given.add(arg[2:].split("=")[0])

    for key, value in (updates.get("ARGS") or {}).items():
        if key in given:
            continue
        setattr(parsed, key, value)

    for group in ("smpl", "data", "studio", "internet"):
        if group in updates:
            setattr(parsed, group, updates[group])

    if "data" in updates and parsed.input_path:
        parsed.data["data_path"] = parsed.input_path

    return parsed


def require_device(device, cpu_hint='device="cpu"'):
    """`torch.device(device)`, refusing a CUDA device without a GPU:
    nothing carries on on the CPU unless the caller asked for it, as
    `cpu_hint` tells them. Every entry point, Python or CLI, checks its
    device here."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           f"(pass {cpu_hint} to run on the CPU)")
    return dev


def gpu_name_and_power() -> str:
    """nvidia-smi's name and power limit of the card, as
    `--query-gpu=name,power.limit --format=csv,noheader` prints them
    ("NVIDIA H100 80GB HBM3, 700.00 W"); raises if nvidia-smi fails."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def resolve_device(parsed):
    """The torch device the CLI entry points run on (`--device`)."""
    return require_device(parsed.device, "--device cpu")


class ConfigContext:
    """Context manager holding the active configuration."""

    parsed_args = None

    def __init__(self, parsed_args=None):
        if parsed_args is not None:
            ConfigContext.parsed_args = parsed_args
        elif ConfigContext.parsed_args is None:
            ConfigContext.parsed_args = parse_args(sys.argv[1:])

    def __enter__(self):
        return ConfigContext.parsed_args

    def __exit__(self, exc_type, exc_val, exc_tb):
        pass


def args():
    return ConfigContext.parsed_args
