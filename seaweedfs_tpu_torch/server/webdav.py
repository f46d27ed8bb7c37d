"""WebDAV gateway over the filer.

Behavioral port of `weed/server/webdav_server.go:144-641` (which adapts
golang.org/x/net/webdav's FileSystem onto the filer): here the WebDAV
protocol layer itself is implemented directly — OPTIONS, PROPFIND (Depth
0/1), GET/HEAD/PUT/DELETE, MKCOL, MOVE, COPY, and class-2 LOCK/UNLOCK
(in-memory lock table, enough for macOS/Windows clients that refuse to
write without locks).

All storage operations go through the filer's HTTP API via FilerClient, so
the gateway is stateless like the reference's.

The port's copy of `seaweedfs_tpu/server/webdav.py`, over the port's
`FilerClient` and `HTTPService`: a PUT's chunks are hashed by the port
filer's device, and a file's `getetag` is the MD5 its hash service gave.
The service is metered as role "webdav" (no `/metrics` route: every path
is a file); `slow_ms` is its `-slowMs` span threshold. Like the S3
gateway it has no master link of its own, so `master_url` starts a
`TelemetryPusher` that ships its frames to the master's aggregate.
"""

from __future__ import annotations

import time
import urllib.parse
import uuid
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

from ..filer.filer_client import FilerClient

from ..stats import aggregate as agg_mod
from ..stats import trace
from .httpd import HTTPService, Request, Response

DAV_NS = "DAV:"


def _rfc1123(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))


def _iso8601(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


class WebDavServer:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 7333, read_only: bool = False,
                 slow_ms: float | None = None,
                 master_url: str | None = None) -> None:
        self.fc = FilerClient(filer_url)
        self.read_only = read_only
        self.master_url = master_url
        self._telemetry_pusher = None
        self.service = HTTPService(host, port)
        self.service.enable_metrics("webdav", serve_route=False)
        if slow_ms is not None:  # -slowMs: the role's slow-span threshold
            trace.set_slow_threshold_ms(slow_ms, role="webdav")
        # path -> (token, expiry). Locks are actually enforced: mutations on
        # a locked path demand the token via the If header, LOCK on a live
        # lock is refused (423), and entries expire at the advertised
        # timeout (advisor r1 finding #3).
        self._locks: dict[str, tuple[str, float]] = {}
        self.lock_timeout = 3600.0
        self._routes()

    def start(self) -> None:
        self.service.start()
        if self.master_url:
            self._telemetry_pusher = agg_mod.TelemetryPusher(
                "webdav", lambda: self.url, self.master_url)
            self._telemetry_pusher.start()

    def stop(self) -> None:
        if self._telemetry_pusher is not None:
            self._telemetry_pusher.stop()
            self._telemetry_pusher = None
        self.service.stop()
        self.fc.close()

    @property
    def url(self) -> str:
        return self.service.url

    # --- helpers -------------------------------------------------------------
    @staticmethod
    def _norm(path: str) -> str:
        path = urllib.parse.unquote(path)
        if path != "/" and path.endswith("/"):
            path = path.rstrip("/")
        return path or "/"

    def _entry(self, path: str) -> dict | None:
        if path == "/":
            return {"full_path": "/", "is_directory": True,
                    "attributes": {"mtime": 0, "mime": ""}}
        return self.fc.get_entry(path)

    def _prop_xml(self, href_path: str, entry: dict) -> str:
        attrs = entry.get("attributes") or {}
        is_dir = bool(entry.get("is_directory"))
        mtime = attrs.get("mtime", 0)
        size = attrs.get("file_size", 0)
        mime = attrs.get("mime", "") or "application/octet-stream"
        href = urllib.parse.quote(href_path + ("/" if is_dir and href_path != "/" else ""))
        restype = "<D:resourcetype><D:collection/></D:resourcetype>" if is_dir \
            else "<D:resourcetype/>"
        length = "" if is_dir else f"<D:getcontentlength>{size}</D:getcontentlength>"
        ctype = "" if is_dir else f"<D:getcontenttype>{escape(mime)}</D:getcontenttype>"
        etag = attrs.get("md5", "") or str(mtime)
        return (
            f"<D:response><D:href>{href}</D:href>"
            f"<D:propstat><D:prop>"
            f"{restype}{length}{ctype}"
            f"<D:getlastmodified>{_rfc1123(mtime)}</D:getlastmodified>"
            f"<D:creationdate>{_iso8601(attrs.get('crtime', mtime))}</D:creationdate>"
            f'<D:getetag>"{escape(etag)}"</D:getetag>'
            f"<D:displayname>{escape(entry['full_path'].rsplit('/', 1)[-1] or '/')}"
            f"</D:displayname>"
            f"</D:prop><D:status>HTTP/1.1 200 OK</D:status></D:propstat>"
            f"</D:response>"
        )

    def _multistatus(self, parts: list[str]) -> Response:
        body = (
            '<?xml version="1.0" encoding="utf-8"?>'
            '<D:multistatus xmlns:D="DAV:">' + "".join(parts) + "</D:multistatus>"
        ).encode()
        return Response(body, 207,
                        {"Content-Type": 'application/xml; charset="utf-8"'})

    # --- locking -------------------------------------------------------------
    def _live_lock(self, path: str) -> str | None:
        """Current unexpired token for path, dropping expired entries."""
        held = self._locks.get(path)
        if held is None:
            return None
        token, expiry = held
        if time.time() >= expiry:
            self._locks.pop(path, None)
            return None
        return token

    def _lock_conflict(
        self, req: Request, path: str, check_descendants: bool = False
    ) -> Response | None:
        """423 unless the request carries the live lock token in its If
        header (RFC 4918 §6; clients send `If: (<token>)`). Locks are
        depth-infinity (RFC 4918 §7): a lock on a collection covers every
        member, so ancestors of the target are checked too; recursive
        DELETE/MOVE also checks locks held below the target."""
        if_header = req.headers.get("If", "")
        probe = path
        while True:
            token = self._live_lock(probe)
            if token is not None and token not in if_header:
                return Response({"error": "locked"}, 423)
            if probe == "/":
                break
            probe = probe.rsplit("/", 1)[0] or "/"
        if check_descendants:
            prefix = path.rstrip("/") + "/"
            for locked in list(self._locks):
                if locked.startswith(prefix):
                    token = self._live_lock(locked)
                    if token is not None and token not in if_header:
                        return Response({"error": "locked"}, 423)
        return None

    def _drop_locks_under(self, path: str) -> None:
        """Forget the lock on `path` and on everything below it (after a
        successful DELETE or MOVE — the resources the locks named are gone)."""
        self._locks.pop(path, None)
        prefix = path.rstrip("/") + "/"
        for locked in list(self._locks):
            if locked.startswith(prefix):
                self._locks.pop(locked, None)

    # --- routes --------------------------------------------------------------
    def _routes(self) -> None:
        svc = self.service
        any_path = r"(/.*)"

        @svc.route("OPTIONS", any_path)
        def options(req: Request) -> Response:
            return Response(b"", 200, {
                "DAV": "1, 2",
                "MS-Author-Via": "DAV",
                "Allow": "OPTIONS, GET, HEAD, PUT, DELETE, PROPFIND, "
                         "PROPPATCH, MKCOL, MOVE, COPY, LOCK, UNLOCK",
            })

        @svc.route("PROPFIND", any_path)
        def propfind(req: Request) -> Response:
            path = self._norm(req.path)
            depth = req.headers.get("Depth", "1")
            entry = self._entry(path)
            if entry is None:
                return Response({"error": "not found"}, 404)
            parts = [self._prop_xml(path, entry)]
            if entry.get("is_directory") and depth != "0":
                listing = self.fc.list(path if path != "/" else "/")
                for e in listing.get("Entries") or []:
                    child = {
                        "full_path": e["FullPath"],
                        "is_directory": e["IsDirectory"],
                        "attributes": {
                            "mtime": e.get("Mtime", 0),
                            "file_size": e.get("FileSize", 0),
                            "mime": e.get("Mime", ""),
                            "md5": e.get("Md5", ""),
                        },
                    }
                    parts.append(self._prop_xml(e["FullPath"], child))
            return self._multistatus(parts)

        @svc.route("PROPPATCH", any_path)
        def proppatch(req: Request) -> Response:
            path = self._norm(req.path)
            if self._entry(path) is None:
                return Response({"error": "not found"}, 404)
            # accept-and-ignore property writes like the reference's
            # (go webdav has no proppatch persistence hooks either)
            return self._multistatus([
                f"<D:response><D:href>{urllib.parse.quote(path)}</D:href>"
                f"<D:propstat><D:prop/>"
                f"<D:status>HTTP/1.1 200 OK</D:status></D:propstat></D:response>"
            ])

        @svc.route("GET", any_path)
        def get(req: Request) -> Response:
            return self._get(req, head=False)

        @svc.route("HEAD", any_path)
        def head(req: Request) -> Response:
            return self._get(req, head=True)

        @svc.route("PUT", any_path)
        def put(req: Request) -> Response:
            if self.read_only:
                return Response({"error": "read-only"}, 403)
            path = self._norm(req.path)
            conflict = self._lock_conflict(req, path)
            if conflict is not None:
                return conflict
            mime = req.headers.get("Content-Type", "")
            try:
                self.fc.put(path, req.body, content_type=mime)
            except OSError as e:
                return Response({"error": str(e)}, 409)
            return Response(b"", 201)

        @svc.route("DELETE", any_path)
        def delete(req: Request) -> Response:
            if self.read_only:
                return Response({"error": "read-only"}, 403)
            path = self._norm(req.path)
            conflict = self._lock_conflict(req, path, check_descendants=True)
            if conflict is not None:
                return conflict
            if self._entry(path) is None:
                return Response({"error": "not found"}, 404)
            self.fc.delete(path, recursive=True)
            self._drop_locks_under(path)  # RFC 4918 §9.6: DELETE removes
            return Response(b"", 204)     # locks on the deleted resources

        @svc.route("MKCOL", any_path)
        def mkcol(req: Request) -> Response:
            if self.read_only:
                return Response({"error": "read-only"}, 403)
            path = self._norm(req.path)
            conflict = self._lock_conflict(req, path)
            if conflict is not None:
                return conflict
            if self._entry(path) is not None:
                return Response({"error": "exists"}, 405)
            self.fc.mkdir(path)
            return Response(b"", 201)

        @svc.route("MOVE", any_path)
        def move(req: Request) -> Response:
            return self._move_or_copy(req, is_move=True)

        @svc.route("COPY", any_path)
        def copy(req: Request) -> Response:
            return self._move_or_copy(req, is_move=False)

        @svc.route("LOCK", any_path)
        def lock(req: Request) -> Response:
            path = self._norm(req.path)
            held = self._live_lock(path)
            if held is not None:
                if held in req.headers.get("If", ""):  # refresh own lock
                    self._locks[path] = (held, time.time() + self.lock_timeout)
                    token = held
                else:
                    return Response({"error": "locked"}, 423)
            else:
                # an exclusive depth-infinity lock anywhere above or below
                # forbids creating this one (RFC 4918 §7: a collection lock
                # covers members; a new lock would cover locked descendants)
                conflict = self._lock_conflict(req, path, check_descendants=True)
                if conflict is not None:
                    return conflict
                token = f"opaquelocktoken:{uuid.uuid4()}"
                self._locks[path] = (token, time.time() + self.lock_timeout)
            owner = ""
            if req.body:
                try:
                    root = ET.fromstring(req.body)
                    o = root.find(f"{{{DAV_NS}}}owner")
                    if o is not None and o.text:
                        owner = o.text
                except ET.ParseError:
                    pass
            body = (
                '<?xml version="1.0" encoding="utf-8"?>'
                '<D:prop xmlns:D="DAV:"><D:lockdiscovery><D:activelock>'
                "<D:locktype><D:write/></D:locktype>"
                "<D:lockscope><D:exclusive/></D:lockscope>"
                "<D:depth>infinity</D:depth>"
                f"<D:owner>{escape(owner)}</D:owner>"
                "<D:timeout>Second-3600</D:timeout>"
                f"<D:locktoken><D:href>{token}</D:href></D:locktoken>"
                "</D:activelock></D:lockdiscovery></D:prop>"
            ).encode()
            return Response(body, 200, {
                "Content-Type": 'application/xml; charset="utf-8"',
                "Lock-Token": f"<{token}>",
            })

        @svc.route("UNLOCK", any_path)
        def unlock(req: Request) -> Response:
            path = self._norm(req.path)
            token = self._live_lock(path)
            if token is not None and \
                    token not in req.headers.get("Lock-Token", ""):
                return Response({"error": "wrong lock token"}, 409)
            self._locks.pop(path, None)
            return Response(b"", 204)

    def _get(self, req: Request, head: bool) -> Response:
        path = self._norm(req.path)
        entry = self._entry(path)
        if entry is None:
            return Response({"error": "not found"}, 404)
        if entry.get("is_directory"):
            return Response({"error": "is a collection"}, 405)
        headers = {}
        rng = req.headers.get("Range")
        status, resp_headers, body = self.fc.get(
            path, range_header=rng
        )
        if status >= 300:
            return Response(body or b"", status)
        for h in ("Content-Type", "ETag", "Last-Modified", "Content-Range",
                  "Accept-Ranges"):
            if resp_headers.get(h):
                headers[h] = resp_headers[h]
        if head:
            headers["Content-Length"] = str(
                (entry.get("attributes") or {}).get("file_size", len(body))
            )
            return Response(b"", status, headers)
        return Response(body, status, headers)

    def _move_or_copy(self, req: Request, is_move: bool) -> Response:
        if self.read_only:
            return Response({"error": "read-only"}, 403)
        src = self._norm(req.path)
        dest_header = req.headers.get("Destination", "")
        if not dest_header:
            return Response({"error": "missing Destination"}, 400)
        dst = self._norm(urllib.parse.urlparse(dest_header).path)
        if is_move:  # COPY does not mutate the source
            conflict = self._lock_conflict(req, src, check_descendants=True)
            if conflict is not None:
                return conflict
        conflict = self._lock_conflict(req, dst, check_descendants=True)
        if conflict is not None:
            return conflict
        entry = self._entry(src)
        if entry is None:
            return Response({"error": "not found"}, 404)
        overwrite = req.headers.get("Overwrite", "T") != "F"
        existed = self._entry(dst) is not None
        if existed and not overwrite:
            return Response({"error": "destination exists"}, 412)
        if is_move:
            try:
                self.fc.rename(src, dst)
            except OSError as e:
                return Response({"error": str(e)}, 409)
            self._drop_locks_under(src)  # locks name paths, not resources
        else:
            if entry.get("is_directory"):
                self._copy_tree(src, dst)
            else:
                data = self.fc.read(src)
                mime = (entry.get("attributes") or {}).get("mime", "")
                self.fc.put(dst, data, content_type=mime)
        return Response(b"", 204 if existed else 201)

    def _copy_tree(self, src: str, dst: str) -> None:
        self.fc.mkdir(dst)
        for e in self.fc.list(src).get("Entries") or []:
            child_src = e["FullPath"]
            child_dst = dst + "/" + child_src.rsplit("/", 1)[-1]
            if e["IsDirectory"]:
                self._copy_tree(child_src, child_dst)
            else:
                self.fc.put(child_dst, self.fc.read(child_src),
                            content_type=e.get("Mime", ""))
