"""Per-path storage rules (`weed/filer/filer_conf.go`): a JSON document at
/etc/seaweedfs/filer.conf whose entries pin collection / replication /
TTL / read-only per location prefix; the LONGEST matching prefix wins.
The filer resolves a rule for every write (query params still override)
and hot-reloads the document via its own metadata subscription.

The port's copy of `seaweedfs_tpu/filer/filer_conf.py`."""

from __future__ import annotations

import json

FILER_CONF_PATH = "/etc/seaweedfs/filer.conf"


class FilerConf:
    def __init__(self, rules: list[dict] | None = None) -> None:
        # each rule: {"location_prefix", "collection", "replication",
        #            "ttl", "read_only"}
        self.rules = sorted(rules or [],
                            key=lambda r: len(r.get("location_prefix", "")),
                            reverse=True)

    @staticmethod
    def from_bytes(raw: bytes) -> "FilerConf":
        try:
            doc = json.loads(raw) if raw else {}
        except ValueError:
            return FilerConf()
        return FilerConf(doc.get("locations") or [])

    def to_bytes(self) -> bytes:
        return json.dumps(
            {"locations": sorted(
                self.rules, key=lambda r: r.get("location_prefix", ""))},
            indent=2,
        ).encode()

    def match(self, path: str) -> dict | None:
        """Longest-prefix rule for `path`, or None."""
        for r in self.rules:  # sorted longest-first
            if path.startswith(r.get("location_prefix", "")):
                return r
        return None

    def upsert(self, rule: dict) -> None:
        prefix = rule.get("location_prefix", "")
        self.rules = [r for r in self.rules
                      if r.get("location_prefix") != prefix]
        self.rules.append(rule)
        self.rules.sort(key=lambda r: len(r.get("location_prefix", "")),
                        reverse=True)

    def delete(self, prefix: str) -> None:
        self.rules = [r for r in self.rules
                      if r.get("location_prefix") != prefix]

    def prefixes(self) -> list[str]:
        return [r.get("location_prefix", "") for r in self.rules]
