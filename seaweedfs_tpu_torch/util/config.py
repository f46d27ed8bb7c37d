"""TOML config discovery (`weed/util/config.go:40-60`): the port's copy of
`seaweedfs_tpu/util/config.py`.

`load_configuration("filer")` looks for filer.toml in ./, ~/.seaweedfs,
/usr/local/etc/seaweedfs, /etc/seaweedfs (viper search-path order) and
returns the parsed dict ({} when absent and not required).
"""

from __future__ import annotations

import os
try:
    import tomllib
except ModuleNotFoundError:  # py<3.11: same-format tomli fallback
    import tomli as tomllib

SEARCH_DIRS = [
    ".",
    os.path.expanduser("~/.seaweedfs"),
    "/usr/local/etc/seaweedfs",
    "/etc/seaweedfs",
]


def resolve_config_path(name: str) -> str | None:
    fname = name if name.endswith(".toml") else f"{name}.toml"
    for d in SEARCH_DIRS:
        cand = os.path.join(d, fname)
        if os.path.exists(cand):
            return cand
    return None


def load_configuration(name: str, required: bool = False) -> dict:
    path = resolve_config_path(name)
    if path is None:
        if required:
            raise FileNotFoundError(
                f"no {name}.toml found in {SEARCH_DIRS}"
            )
        return {}
    with open(path, "rb") as f:
        return tomllib.load(f)
