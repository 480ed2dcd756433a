"""Env-var parsing for the port's knobs (a copy of the helpers in
``tpudist/utils/envutil.py``; a typo'd knob falls back to its default)."""

from __future__ import annotations

import os
from typing import Optional


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """``float(os.environ[name])``, or ``default`` when unset, empty or
    unparseable."""
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_positive_float(name: str,
                       default: Optional[float] = None) -> Optional[float]:
    """Like :func:`env_float`, with ``<= 0`` meaning "explicitly disabled"
    (maps to ``default``)."""
    v = env_float(name, None)
    return default if v is None or v <= 0 else v


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """``int(os.environ[name])``, or ``default`` when unset, empty or
    unparseable."""
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: unset → ``default``; ``0``/``false``/``off``/``no``/
    empty (any case) → False; anything else → True."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "off", "no")


def env_rank(default: Optional[int] = None) -> Optional[int]:
    """This process's global rank from the launcher env contracts, in
    precedence order (tpudist > torchrun > SLURM)."""
    for var in ("TPUDIST_PROCESS_ID", "RANK", "SLURM_PROCID"):
        v = os.environ.get(var)
        if v:
            try:
                return int(v)
            except ValueError:
                continue
    return default
