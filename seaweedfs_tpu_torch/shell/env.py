"""Shell command environment: cluster handles + topology snapshot helpers
(reference `weed/shell/command_env.go` CommandEnv).

The port's copy of `seaweedfs_tpu/shell/env.py` over the port's
`server/httpd.py` client helpers, with the filer handle the `fs.*` verbs
read (`filer_url`, `cwd`, `require_filer`, which finds a registered filer
through the master's `/cluster/ps` when none was given, and
`filer_read`)."""

from __future__ import annotations

from ..server.httpd import get_json, http_request, peer_url, post_json


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
        return peer_url(self.url)  # https under process mTLS

    def free_slots(self) -> int:
        return self.max_volume_count - len(self.volumes) - len(self.ec_shards)


class CommandEnv:
    def __init__(
        self, master_url: str, filer_url: str = "", holder: str = "shell"
    ) -> None:
        self.master_url = master_url.rstrip("/")
        self.filer_url = filer_url.rstrip("/") if filer_url else ""
        self.holder = holder
        self.locked = False
        self.cwd = "/"  # fs.cd / fs.pwd working directory

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

    def require_filer(self) -> str:
        if not self.filer_url:
            # auto-discover from cluster membership (filers register with
            # the master — weed/cluster)
            try:
                ps = self.get(f"{self.master_url}/cluster/ps")
                filers = ps.get("filers") or []
                if filers:
                    self.filer_url = filers[0]["address"]
            except Exception:
                pass
        if not self.filer_url:
            raise ShellError("this command needs a filer (pass filer_url)")
        return self.filer_url

    def filer_read(self, path: str, query: str = "") -> tuple[int, dict, bytes]:
        url = f"{self.require_filer()}{path}"
        if query:
            url += f"?{query}"
        return http_request("GET", url, timeout=60)
