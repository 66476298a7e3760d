"""Dataclass-driven CLI parsing: port of ``distributed_lion_tpu/utils/argparsing.py``.

Every dataclass field becomes a ``--flag``, except one whose metadata says
``cli: False`` (a programmatic knob); booleans accept ``--flag`` /
``--flag false``; a list field takes any number of values (``--prompt a
b``); a single JSON-file argument populates all groups. A field
a dataclass does not have is not a flag, so argparse refuses it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import typing
from typing import Optional, Sequence, Type


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def build_parser(dataclass_types: Sequence[Type]) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="distributed_lion_tpu_torch", allow_abbrev=False,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    seen = set()
    for dc in dataclass_types:
        group = parser.add_argument_group(dc.__name__)
        hints = typing.get_type_hints(dc)
        for f in dataclasses.fields(dc):
            if not f.metadata.get("cli", True):
                continue
            if f.name in seen:
                raise ValueError(f"duplicate field {f.name!r} across dataclasses")
            seen.add(f.name)
            tp, _ = _unwrap_optional(hints[f.name])
            default = f.default if f.default is not dataclasses.MISSING else (
                f.default_factory() if f.default_factory is not dataclasses.MISSING
                else None)
            kw: dict = {"default": default, "help": f.metadata.get("help", "")}
            if tp is bool:
                kw.update(type=_str2bool, nargs="?", const=True)
            elif tp in (int, float, str):
                kw.update(type=tp)
            elif typing.get_origin(tp) is list:
                kw.update(type=typing.get_args(tp)[0] if typing.get_args(tp) else str, nargs="*")
            else:
                kw.update(type=str)
            group.add_argument(f"--{f.name}", **kw)
    return parser


def parse_dataclasses(dataclass_types: Sequence[Type],
                      args: Optional[Sequence[str]] = None) -> tuple:
    """Parse argv (or a JSON config file given as the sole argument) into one
    instance per dataclass, in order."""
    argv = list(sys.argv[1:] if args is None else args)
    if len(argv) == 1 and argv[0].endswith(".json"):
        values = json.loads(pathlib.Path(argv[0]).read_text())
    else:
        values = vars(build_parser(dataclass_types).parse_args(argv))
    return tuple(
        dc(**{f.name: values[f.name] for f in dataclasses.fields(dc)
              if f.name in values and f.metadata.get("cli", True)})
        for dc in dataclass_types)
