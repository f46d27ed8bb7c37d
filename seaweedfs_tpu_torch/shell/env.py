"""Shell command environment: cluster handles + topology snapshot helpers
(reference `weed/shell/command_env.go` CommandEnv).

The port's copy of `seaweedfs_tpu/shell/env.py` over the port's
`server/httpd.py` client helpers. The filer handle (`filer_url`, `cwd`,
`require_filer`, `filer_read`) is left out: no ported command reads a
filer."""

from __future__ import annotations

from ..server.httpd import get_json, post_json


class ShellError(Exception):
    pass


class ServerView:
    """One volume server as seen in /dir/status."""

    def __init__(self, dc: str, rack: str, node: dict) -> None:
        self.dc = dc
        self.rack = rack
        self.id = node["id"]
        self.url = node["url"]
        self.max_volume_count = node.get("max_volume_count", 100)
        self.volumes = {v["id"]: v for v in node.get("volume_infos", [])}
        self.ec_shards = {e["id"]: e["shards"] for e in node.get("ec_shard_infos", [])}
        self.ec_collections = {
            e["id"]: e.get("collection", "")
            for e in node.get("ec_shard_infos", [])
        }

    @property
    def http(self) -> str:
        return f"http://{self.url}"

    def free_slots(self) -> int:
        return self.max_volume_count - len(self.volumes) - len(self.ec_shards)


class CommandEnv:
    def __init__(self, master_url: str, holder: str = "shell") -> None:
        self.master_url = master_url.rstrip("/")
        self.holder = holder
        self.locked = False

    # --- cluster topology -----------------------------------------------------
    def topology(self) -> dict:
        return get_json(f"{self.master_url}/dir/status")["Topology"]

    def servers(self) -> list[ServerView]:
        out = []
        for dc in self.topology().get("data_centers", []):
            for rack in dc.get("racks", []):
                for node in rack.get("nodes", []):
                    out.append(ServerView(dc["name"], rack["name"], node))
        return out

    def volume_replicas(self) -> dict[int, list[ServerView]]:
        """vid -> servers holding a replica."""
        out: dict[int, list[ServerView]] = {}
        for sv in self.servers():
            for vid in sv.volumes:
                out.setdefault(vid, []).append(sv)
        return out

    def locations(self, vid: int) -> list[str]:
        info = get_json(f"{self.master_url}/dir/lookup?volumeId={vid}")
        return [loc["url"] for loc in info.get("locations", [])]

    # --- rpc helpers ----------------------------------------------------------
    def post(self, url: str, payload: dict | None = None, timeout: float = 300):
        return post_json(url, payload, timeout=timeout)

    def get(self, url: str, timeout: float = 60):
        return get_json(url, timeout=timeout)

    # --- admin lock (weed/shell lock/unlock) ----------------------------------
    def acquire_lock(self, timeout: float = 30) -> None:
        self.post(f"{self.master_url}/cluster/lock", {"holder": self.holder},
                  timeout=timeout)
        self.locked = True

    def release_lock(self, timeout: float = 30) -> None:
        self.post(f"{self.master_url}/cluster/unlock",
                  {"holder": self.holder}, timeout=timeout)
        self.locked = False
