"""Tiny first-party .env loader + typed env readers.

The reference uses python-dotenv (reference api/config.py:7-9); that package
is not part of this image, and the functionality is ~20 lines, so it is
first-party here.
"""

from __future__ import annotations

import os
from pathlib import Path


def load_dotenv(path: str | os.PathLike | None = None, *, override: bool = False) -> dict:
    """Parse KEY=VALUE lines from a .env file into os.environ.

    Lines starting with '#' and blank lines are ignored.  Values may be
    single- or double-quoted.  Returns the parsed mapping.
    """
    p = Path(path) if path is not None else Path.cwd() / ".env"
    parsed: dict[str, str] = {}
    if not p.is_file():
        return parsed
    for raw in p.read_text(encoding="utf-8", errors="replace").splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in ("'", '"'):
            value = value[1:-1]
        if key:
            parsed[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    return parsed


def env_str(name: str, default: str = "") -> str:
    return os.getenv(name, default)


def env_int(name: str, default: int) -> int:
    try:
        return int(os.getenv(name, str(default)))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    try:
        return float(os.getenv(name, str(default)))
    except ValueError:
        return default


def env_bool(name: str, default: bool = False) -> bool:
    raw = os.getenv(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")
