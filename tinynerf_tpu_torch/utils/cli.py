"""Dataclass-driven CLI, flag-compatible with the reference's Tyro usage.

The reference parses its `Config` dataclass with `tyro.cli`
(src/train.py:162-163), exposing fields as `--iters`, `--n-rand`, ...
with underscores mapped to dashes and `--flag` / `--no-flag` pairs for
booleans. Tyro is not available in this environment, so the framework
ships a small self-contained equivalent covering the reference's flag
surface: int/float/str fields, Optional[int] (accepts "None"), and
bool fields with tyro-style --field / --no-field toggles.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def _unwrap_optional(tp):
    """Return (inner_type, True) for Optional[inner], else (tp, False)."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _optional_parser(inner):
    def parse(s: str):
        if s.lower() in ("none", "null"):
            return None
        return inner(s)

    return parse


def cli(config_cls: Type[T], args: Optional[Sequence[str]] = None, description: str = "") -> T:
    """Parse argv into an instance of the given dataclass.

    Field `foo_bar: int = 3` becomes `--foo-bar 4`; `flag: bool = True`
    becomes `--flag` / `--no-flag`; `Optional[int]` accepts `None`.
    """
    if not dataclasses.is_dataclass(config_cls):
        raise TypeError(f"cli() expects a dataclass, got {config_cls!r}")

    parser = argparse.ArgumentParser(description=description or config_cls.__doc__ or "")
    hints = typing.get_type_hints(config_cls)
    for field in dataclasses.fields(config_cls):
        tp, is_opt = _unwrap_optional(hints[field.name])
        flag = "--" + field.name.replace("_", "-")
        default = (
            field.default
            if field.default is not dataclasses.MISSING
            else field.default_factory()  # type: ignore[misc]
            if field.default_factory is not dataclasses.MISSING
            else None
        )
        if tp is bool and not is_opt:
            group = parser.add_mutually_exclusive_group()
            group.add_argument(flag, dest=field.name, action="store_true")
            group.add_argument(
                "--no-" + field.name.replace("_", "-"), dest=field.name, action="store_false"
            )
            parser.set_defaults(**{field.name: default})
        else:
            parse_fn = _optional_parser(tp) if is_opt else tp
            parser.add_argument(
                flag,
                dest=field.name,
                type=parse_fn,
                default=default,
                help=f"(default: {default})",
            )
    ns = parser.parse_args(args)
    return config_cls(**vars(ns))
