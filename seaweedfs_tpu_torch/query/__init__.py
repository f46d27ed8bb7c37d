"""Server-side content filtering (S3-Select-ish).

The port's copy of `seaweedfs_tpu/query/__init__.py` (after
`weed/server/volume_grpc_query.go:12` + `weed/query/json/`): filter JSON
documents stored in needles by field predicates and project selected
fields; CSV input goes through the same machinery. The volume server
exposes it as `POST /query`.

WHERE grammar (mirrors the reference's gjson-based field=value filtering,
extended with the standard comparison set):
    {"field": "age", "op": ">=", "value": 21}
    {"and": [cond, ...]} / {"or": [cond, ...]} / {"not": cond}
Dotted field paths descend into nested objects ("address.city").
"""

from __future__ import annotations

import csv
import io
import json

_OPS = {
    "=": lambda a, b: a == b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a is not None and b is not None and a < b,
    "<=": lambda a, b: a is not None and b is not None and a <= b,
    ">": lambda a, b: a is not None and b is not None and a > b,
    ">=": lambda a, b: a is not None and b is not None and a >= b,
    "like": lambda a, b: isinstance(a, str) and isinstance(b, str)
    and b.strip("%") in a,
}


def get_path(doc: dict, path: str):
    """gjson-style dotted lookup (`weed/query/json/query_json.go`)."""
    cur = doc
    for piece in path.split("."):
        if isinstance(cur, list):
            try:
                cur = cur[int(piece)]
                continue
            except (ValueError, IndexError):
                return None
        if not isinstance(cur, dict) or piece not in cur:
            return None
        cur = cur[piece]
    return cur


def _coerce(a, b):
    """Compare numbers numerically even when one side is a string literal."""
    if isinstance(a, (int, float)) and isinstance(b, str):
        try:
            return a, float(b)
        except ValueError:
            return a, b
    if isinstance(b, (int, float)) and isinstance(a, str):
        try:
            return float(a), b
        except ValueError:
            return a, b
    return a, b


def matches(doc: dict, where) -> bool:
    if where is None:
        return True
    if "and" in where:
        return all(matches(doc, c) for c in where["and"])
    if "or" in where:
        return any(matches(doc, c) for c in where["or"])
    if "not" in where:
        return not matches(doc, where["not"])
    op = _OPS.get(where.get("op", "="))
    if op is None:
        raise ValueError(f"unknown op {where.get('op')!r}")
    a, b = _coerce(get_path(doc, where["field"]), where.get("value"))
    try:
        return bool(op(a, b))
    except TypeError:
        return False


def project(doc: dict, fields: list[str] | None) -> dict:
    if not fields:
        return doc
    return {f: get_path(doc, f) for f in fields}


def query_json_lines(data: bytes, select: list[str] | None = None,
                     where=None, limit: int = 0) -> list[dict]:
    """Filter a needle holding JSON (one doc, a JSON array, or ndjson)."""
    text = data.decode("utf-8", "replace").strip()
    docs: list[dict] = []
    if not text:
        return []
    if text.startswith("["):
        docs = [d for d in json.loads(text) if isinstance(d, dict)]
    else:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if isinstance(d, dict):
                docs.append(d)
    out = []
    for d in docs:
        if matches(d, where):
            out.append(project(d, select))
            if limit and len(out) >= limit:
                break
    return out


def query_csv(data: bytes, select: list[str] | None = None, where=None,
              has_header: bool = True, delimiter: str = ",",
              limit: int = 0) -> list[dict]:
    """CSV rows become dicts (header names or _1.._N), then the same
    predicate machinery applies."""
    text = data.decode("utf-8", "replace")
    reader = csv.reader(io.StringIO(text), delimiter=delimiter)
    rows = list(reader)
    if not rows:
        return []
    if has_header:
        header, rows = rows[0], rows[1:]
    else:
        header = [f"_{i + 1}" for i in range(len(rows[0]))]
    out = []
    for row in rows:
        doc = {h: v for h, v in zip(header, row)}
        if matches(doc, where):
            out.append(project(doc, select))
            if limit and len(out) >= limit:
                break
    return out
