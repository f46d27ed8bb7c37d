"""S3 REST gateway server.

Router and handlers for bucket CRUD, object CRUD + copy, ListObjects V1/V2,
batch delete, multipart uploads (assembled by filer chunk concatenation),
object/bucket tagging, ACL/versioning/lifecycle stubs, SigV4 auth with
per-identity actions, and a concurrency circuit breaker.

Reference: `weed/s3api/s3api_server.go:110-290` (router),
`s3api_object_handlers*.go`, `s3api_bucket_handlers.go`,
`filer_multipart.go` (chunk-concatenation completion).

Objects live in the filer under `/buckets/<bucket>/<key>`; multipart parts
stage under `/buckets/<bucket>/.uploads/<uploadId>/`.

The port's copy of `seaweedfs_tpu/s3api/s3_server.py`, over the port's
`filer/filer_client.py`, `filer/meta_aggregator.py` and `server/httpd.py`.
Every object byte reaches the port's filer through `FilerClient.put`,
where each chunk's ETag goes through `md5_batch` and each needle's
checksum through `crc32c_batch` (`ops/hash_service.py`). The gateway's own
ETags (an object's MD5, a multipart upload's MD5 of its parts' MD5s) are
`hashlib`, as in the reference, so they stay equal to its answers.
`faults_spec` is the `-faults` flag (see `util/faults.opt_in`).

The service is metered as role "s3" (no `/metrics` route: the bucket
namespace is a catch-all); `slow_ms` is its `-slowMs` span threshold.

Not ported: the native front (the engine relay, its per-bucket flags and
upload registry, `url`'s engine branch; ROADMAP 10a-3), QoS admission,
usage accounting, the telemetry spool and the `TelemetryPusher` (10d-4c);
the constructor takes none of their options. The
`s3-meta-objects` marker an x-amz-meta PUT writes on its bucket entry is
kept, so a store written here reads the same to a gateway that has the
native front.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

from ..filer.filer_client import FilerClient
from ..filer.meta_aggregator import MetaSubscriber
from ..server.httpd import HTTPService, Request, Response
from ..stats import trace
from ..util import faults

from . import policy as bucket_policy
from .auth import (
    ACTION_ADMIN,
    ACTION_LIST,
    ACTION_READ,
    ACTION_TAGGING,
    ACTION_WRITE,
    Identity,
    IdentityAccessManagement,
    S3ApiError,
    deframe_streaming_body,
    err,
)
from .circuit_breaker import CircuitBreaker

BUCKETS_DIR = "/buckets"
UPLOADS_FOLDER = ".uploads"
VERSIONS_FOLDER = ".versions"
TAG_PREFIX = "X-Amz-Tagging-"
AMZ_META_PREFIX = "x-amz-meta-"
XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def xml_response(tag: str, inner: str, status: int = 200) -> Response:
    body = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<{tag} xmlns="{XMLNS}">{inner}</{tag}>'
    ).encode()
    return Response(body, status, {"Content-Type": "application/xml"})


def error_response(e: S3ApiError, resource: str = "") -> Response:
    inner = (
        f"<Code>{e.code}</Code><Message>{escape(e.message)}</Message>"
        f"<Resource>{escape(resource)}</Resource>"
    )
    body = f'<?xml version="1.0" encoding="UTF-8"?><Error>{inner}</Error>'.encode()
    return Response(body, e.status, {"Content-Type": "application/xml"})


def amz_time(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


class S3Server:
    def __init__(
        self,
        filer_url: str,
        host: str = "127.0.0.1",
        port: int = 8333,
        config: dict | None = None,
        circuit_breaker: CircuitBreaker | None = None,
        faults_spec: str | None = None,
        slow_ms: float | None = None,
    ) -> None:
        faults.opt_in(faults_spec)  # the -faults flag
        self.fc = FilerClient(filer_url)
        self.iam = IdentityAccessManagement()
        if config:
            self.iam.load_config(config)
        self.cb = circuit_breaker or CircuitBreaker()
        self.lifecycle_sweep_interval = 3600.0  # 0 disables the sweeper
        self._sweep_stop = None
        self.service = HTTPService(host, port)
        self.service.enable_metrics("s3", serve_route=False)
        if slow_ms is not None:  # -slowMs: the role's slow-span threshold
            trace.set_slow_threshold_ms(slow_ms, role="s3")
        self._iam_subscriber = None
        # buckets this gateway has marked as holding x-amz-meta objects
        self._meta_dirty: set[str] = set()
        self._routes()

    def start(self) -> None:
        self.service.start()
        try:
            self.fc.mkdir(BUCKETS_DIR)
        except IOError:
            pass
        self._load_iam_from_filer()
        self._watch_iam()
        if self.lifecycle_sweep_interval > 0:
            self._sweep_stop = threading.Event()

            def sweeper():  # pragma: no cover - timing loop
                while not self._sweep_stop.wait(self.lifecycle_sweep_interval):
                    try:
                        self.run_lifecycle_sweep()
                    except Exception:
                        pass

            threading.Thread(target=sweeper, daemon=True).start()

    def stop(self) -> None:
        if self._sweep_stop is not None:
            self._sweep_stop.set()
        if self._iam_subscriber is not None:
            self._iam_subscriber.stop()
        self.service.stop()
        self.fc.close()

    @property
    def url(self) -> str:
        return self.service.url

    # --- IAM config hot reload (`auth_credentials_subscribe.go`) ---------------
    IAM_CONFIG_PATH = "/etc/iam/identity.json"

    def _load_iam_from_filer(self) -> None:
        try:
            status, _, body = self.fc.get(self.IAM_CONFIG_PATH)
            if status == 200 and body:
                self.iam.load_json(body)
        except Exception:
            pass

    def _watch_iam(self) -> None:
        def on_event(ev: dict) -> None:
            e = ev.get("new_entry")
            if e and e.get("full_path") == self.IAM_CONFIG_PATH:
                self._load_iam_from_filer()

        try:
            sub = MetaSubscriber(
                self.fc.filer_url, on_event, path_prefix="/etc/iam",
                since_ns=time.time_ns(),
            )
            sub.start()
            self._iam_subscriber = sub
        except Exception:
            self._iam_subscriber = None

    # --- routing ----------------------------------------------------------------
    def _routes(self) -> None:
        svc = self.service

        @svc.route("GET", r"/")
        def list_buckets(req: Request) -> Response:
            return self._dispatch(req, "", "")

        for method in ("OPTIONS",):
            # CORS preflight carries no credentials; matched against the
            # bucket's CORS config only (`s3api_server.go` cors.New wrapper)
            @svc.route(method, r"/([^/]+)")
            def bucket_preflight(req: Request) -> Response:
                return self._preflight(req, req.match.group(1))

            @svc.route(method, r"/([^/]+)/(.*)")
            def object_preflight(req: Request) -> Response:
                return self._preflight(req, req.match.group(1))

        for method in ("GET", "PUT", "POST", "DELETE", "HEAD"):
            @svc.route(method, r"/([^/]+)")
            def bucket_level(req: Request) -> Response:
                return self._dispatch(req, req.match.group(1), "")

            @svc.route(method, r"/([^/]+)/(.*)")
            def object_level(req: Request) -> Response:
                return self._dispatch(
                    req, req.match.group(1), req.match.group(2)
                )

    def _query_pairs(self, req: Request) -> list[tuple[str, str]]:
        # S3 subresources are empty-valued query keys ("?uploads"); the
        # default Request.query drops them, so re-parse keeping blanks
        parsed = urllib.parse.urlparse(req.handler.path)
        return urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)

    def _dispatch(self, req: Request, bucket: str, key: str) -> Response:
        pairs = self._query_pairs(req)
        q = dict(pairs)
        resource = f"/{bucket}/{key}" if key else f"/{bucket}"
        if (
            req.method == "POST"
            and bucket
            and not key
            and "multipart/form-data" in req.headers.get("Content-Type", "")
        ):
            # browser POST upload, authenticated by its signed form policy
            # (`s3api_object_handlers_postpolicy.go`)
            try:
                with self.cb.limit(ACTION_WRITE, bucket):
                    resp = self._post_policy_upload(req, bucket)
            except S3ApiError as e:
                resp = error_response(e, resource)
            self._apply_cors_headers(req, bucket, resp)
            return resp
        try:
            body = req.body
            try:
                ident = self.iam.authenticate(
                    req.method,
                    urllib.parse.unquote(
                        urllib.parse.urlparse(req.handler.path).path
                    ),
                    pairs,
                    dict(req.headers),
                    body,
                )
            except S3ApiError as e:
                # unauthenticated (NOT mis-signed) requests proceed as the
                # anonymous principal: a bucket policy may Allow "*"
                if e.code != "AccessDenied":
                    raise
                ident = Identity("anonymous", [], [])
            action = self._required_action(req.method, bucket, key, q)
            # bucket-policy evaluation (s3api/policy.py): explicit Deny
            # wins; Allow unions with the identity's IAM grants
            decision = None
            if bucket:
                doc = self._bucket_policy_doc(bucket)
                if doc is not None:
                    decision = bucket_policy.evaluate(
                        doc,
                        ident.name,
                        self._s3_action_name(req.method, bucket, key, q),
                        bucket_policy.arn(bucket, urllib.parse.unquote(key)),
                    )
            if decision == bucket_policy.DENY:
                raise err(
                    "AccessDenied", f"policy denies {resource} to {ident.name}"
                )
            if decision != bucket_policy.ALLOW and not ident.can_do(
                action, bucket, key
            ):
                raise err("AccessDenied", f"{ident.name} cannot {action} {resource}")
            # CopyObject also reads the source object — authorize both sides
            copy_source = req.headers.get("x-amz-copy-source")
            if req.method == "PUT" and key and copy_source:
                src = urllib.parse.unquote(copy_source).lstrip("/")
                src_bucket, _, src_key = src.partition("/")
                if not ident.can_do(ACTION_READ, src_bucket, src_key):
                    raise err(
                        "AccessDenied", f"{ident.name} cannot Read /{src}"
                    )
            with self.cb.limit(action, bucket):
                resp = self._handle(
                    req, bucket, urllib.parse.unquote(key), q, ident
                )
        except S3ApiError as e:
            resp = error_response(e, resource)
        except Exception as e:  # any internal failure → S3 XML error surface
            resp = error_response(err("InternalError", str(e)), resource)
        if bucket:
            self._apply_cors_headers(req, bucket, resp)
        return resp

    @staticmethod
    def _required_action(method: str, bucket: str, key: str, q: dict) -> str:
        if "policy" in q or "cors" in q or "lifecycle" in q or (
            "versioning" in q and method == "PUT"
        ):
            return ACTION_ADMIN  # bucket-owner configuration surfaces
        if "tagging" in q:
            return ACTION_TAGGING
        if not bucket:
            return ACTION_LIST  # ListBuckets (filtered per identity)
        if not key:
            if method in ("PUT", "DELETE"):
                return ACTION_ADMIN  # create/delete bucket
            if method == "POST":
                return ACTION_WRITE  # batch delete
            return ACTION_LIST
        if method in ("GET", "HEAD"):
            return ACTION_READ
        return ACTION_WRITE

    @staticmethod
    def _s3_action_name(method: str, bucket: str, key: str, q: dict) -> str:
        """Canonical AWS action name for policy matching."""
        if "acl" in q:
            kind = "Object" if key else "Bucket"
            return {"GET": f"s3:Get{kind}Acl",
                    "PUT": f"s3:Put{kind}Acl"}.get(method, f"s3:Get{kind}Acl")
        if "policy" in q:
            return {"GET": "s3:GetBucketPolicy", "PUT": "s3:PutBucketPolicy",
                    "DELETE": "s3:DeleteBucketPolicy"}.get(method, "s3:GetBucketPolicy")
        if "cors" in q:
            return {"GET": "s3:GetBucketCors", "PUT": "s3:PutBucketCors",
                    "DELETE": "s3:DeleteBucketCors"}.get(method, "s3:GetBucketCors")
        if "lifecycle" in q:
            return {"GET": "s3:GetLifecycleConfiguration",
                    "PUT": "s3:PutLifecycleConfiguration",
                    "DELETE": "s3:PutLifecycleConfiguration"}.get(
                method, "s3:GetLifecycleConfiguration")
        if "tagging" in q:
            kind = "Object" if key else "Bucket"
            return {"GET": f"s3:Get{kind}Tagging", "PUT": f"s3:Put{kind}Tagging",
                    "DELETE": f"s3:Delete{kind}Tagging"}.get(
                method, f"s3:Get{kind}Tagging")
        if not key:
            if method == "PUT":
                return "s3:CreateBucket"
            if method == "DELETE":
                return "s3:DeleteBucket"
            if method == "POST":
                return "s3:DeleteObject"  # batch delete
            if "uploads" in q:
                return "s3:ListBucketMultipartUploads"
            return "s3:ListBucket"
        if "uploadId" in q or "uploads" in q:
            return {"DELETE": "s3:AbortMultipartUpload",
                    "GET": "s3:ListMultipartUploadParts"}.get(
                method, "s3:PutObject")
        if method in ("GET", "HEAD"):
            return "s3:GetObject"
        if method == "DELETE":
            return "s3:DeleteObject"
        return "s3:PutObject"

    def _handle(
        self, req: Request, bucket: str, key: str, q: dict, ident
    ) -> Response:
        m = req.method
        if not bucket:
            return self._list_buckets(ident)
        if not key:
            if "tagging" in q:  # before bucket CRUD — a Tagging-only identity
                path = self._bucket_path(bucket)  # must never create/delete
                if m == "GET":
                    return self._get_tagging(path)
                if m == "PUT":
                    return self._put_tagging(path, req.body)
                if m == "DELETE":
                    return self._delete_tagging(path)
            if "policy" in q:
                if m == "GET":
                    return self._get_bucket_policy(bucket)
                if m == "PUT":
                    return self._put_bucket_policy(bucket, req.body)
                if m == "DELETE":
                    return self._delete_bucket_policy(bucket)
            if "cors" in q:
                if m == "GET":
                    return self._get_bucket_cors(bucket)
                if m == "PUT":
                    return self._put_bucket_cors(bucket, req.body)
                if m == "DELETE":
                    return self._delete_bucket_ext(bucket, "cors", 204)
            if "lifecycle" in q:
                if m == "GET":
                    return self._get_bucket_lifecycle(bucket)
                if m == "PUT":
                    return self._put_bucket_lifecycle(bucket, req.body)
                if m == "DELETE":
                    return self._delete_bucket_ext(bucket, "lifecycle", 204)
            if m == "PUT":
                if "versioning" in q:
                    return self._put_bucket_versioning(bucket, req.body)
                if "acl" in q:
                    return self._put_acl(req, ident, bucket)
                grants = self._parse_request_acl(req, ident)
                resp = self._put_bucket(bucket)
                if grants is None:
                    # record the creator as owner even without ACL headers
                    # so GET ?acl reports a stable owner, not the caller
                    from . import acl as acl_mod

                    grants = acl_mod.grants_from_canned(
                        "private", ident.account_id)
                self._apply_acl(ident.account_id, bucket, None, grants)
                return resp
            if m == "DELETE":
                return self._delete_bucket(bucket)
            if m == "HEAD":
                return self._head_bucket(bucket)
            if m == "POST" and "delete" in q:
                return self._delete_objects(req, bucket)
            if m == "GET":
                if "uploads" in q:
                    return self._list_multipart_uploads(bucket)
                if "location" in q:
                    return xml_response("LocationConstraint", "")
                if "versioning" in q:
                    return self._get_bucket_versioning(bucket)
                if "versions" in q:
                    return self._list_object_versions(bucket, q)
                if "acl" in q:
                    return self._get_acl(ident, bucket)
                return self._list_objects(req, bucket, q)
        else:
            if "uploadId" in q:
                if m == "PUT":
                    return self._upload_part(req, bucket, key, q)
                if m == "POST":
                    return self._complete_multipart(req, bucket, key, q)
                if m == "DELETE":
                    return self._abort_multipart(bucket, key, q)
                if m == "GET":
                    return self._list_parts(bucket, key, q)
            if m == "POST" and "uploads" in q:
                return self._create_multipart(req, bucket, key)
            if "tagging" in q:
                path = self._object_path(bucket, key)
                if m == "GET":
                    return self._get_tagging(path)
                if m == "PUT":
                    return self._put_tagging(path, req.body)
                if m == "DELETE":
                    return self._delete_tagging(path)
            if "acl" in q:
                if m == "GET":
                    return self._get_acl(ident, bucket, key)
                if m == "PUT":
                    return self._put_acl(req, ident, bucket, key)
            if m == "PUT":
                grants = self._parse_request_acl(req, ident)
                if req.headers.get("x-amz-copy-source"):
                    resp = self._copy_object(req, bucket, key)
                else:
                    resp = self._put_object(req, bucket, key)
                self._apply_acl(ident.account_id, bucket, key, grants)
                return resp
            if m in ("GET", "HEAD"):
                if "versionId" in q:
                    return self._get_object_version(
                        req, bucket, key, q["versionId"], head=(m == "HEAD")
                    )
                return self._get_object(req, bucket, key, head=(m == "HEAD"))
            if m == "DELETE":
                if "versionId" in q:
                    return self._delete_object_version(
                        bucket, key, q["versionId"]
                    )
                return self._delete_object(bucket, key)
        raise err("NotImplemented", f"{m} {req.path}?{urllib.parse.urlencode(q)}")

    # --- path helpers -----------------------------------------------------------
    @staticmethod
    def _bucket_path(bucket: str) -> str:
        if not bucket or "/" in bucket or bucket.startswith("."):
            raise err("InvalidBucketName", bucket)
        return f"{BUCKETS_DIR}/{bucket}"

    def _object_path(self, bucket: str, key: str) -> str:
        return f"{self._bucket_path(bucket)}/{key}"

    def _require_bucket(self, bucket: str) -> dict:
        entry = self.fc.get_entry(self._bucket_path(bucket))
        if entry is None or not entry.get("is_directory"):
            raise err("NoSuchBucket", bucket)
        return entry

    def _require_writable_bucket(self, bucket: str) -> dict:
        """Uploads into a read-only bucket are rejected — the state
        `s3.bucket.quota.enforce -apply` flips when usage exceeds the
        quota (`command_s3_bucket_quota_check.go` semantics)."""
        entry = self._require_bucket(bucket)
        if (entry.get("extended") or {}).get("s3-read-only"):
            raise err("AccessDenied", f"bucket {bucket} is read-only"
                                      " (quota enforcement)")
        return entry

    # --- bucket handlers --------------------------------------------------------
    def _list_buckets(self, ident) -> Response:
        listing = self.fc.list(BUCKETS_DIR, limit=10_000)
        inner = ""
        for e in listing.get("Entries", []):
            if not e.get("IsDirectory"):
                continue
            name = e["FullPath"].rsplit("/", 1)[-1]
            if name.startswith("."):
                continue
            if not (
                ident.can_do(ACTION_LIST, name) or ident.can_do(ACTION_READ, name)
            ):
                continue
            inner += (
                f"<Bucket><Name>{escape(name)}</Name>"
                f"<CreationDate>{amz_time(e.get('Mtime', 0))}</CreationDate>"
                f"</Bucket>"
            )
        owner = (
            f"<Owner><ID>{escape(ident.account_id)}</ID>"
            f"<DisplayName>{escape(ident.name)}</DisplayName></Owner>"
        )
        return xml_response(
            "ListAllMyBucketsResult", f"{owner}<Buckets>{inner}</Buckets>"
        )

    def _put_bucket(self, bucket: str) -> Response:
        path = self._bucket_path(bucket)
        if self.fc.exists(path):
            raise err("BucketAlreadyExists", bucket)
        self.fc.mkdir(path)
        return Response(b"", 200, {"Location": f"/{bucket}"})

    def _delete_bucket(self, bucket: str) -> Response:
        self._require_bucket(bucket)
        listing = self.fc.list(self._bucket_path(bucket), limit=2)
        entries = [
            e for e in listing.get("Entries", [])
            if e["FullPath"].rsplit("/", 1)[-1]
            not in (UPLOADS_FOLDER, VERSIONS_FOLDER)
        ]
        if entries:
            raise err("BucketNotEmpty", bucket)
        self.fc.delete(self._bucket_path(bucket), recursive=True)
        # a bucket recreated under the same name starts meta-clean (the
        # persistent marker died with the directory entry)
        self._meta_dirty.discard(bucket)
        return Response(b"", 204)

    def _head_bucket(self, bucket: str) -> Response:
        self._require_bucket(bucket)
        return Response(b"", 200)

    # --- bucket configuration (policy / CORS / lifecycle) -------------------
    # Stored as extended attributes of the bucket directory entry, the same
    # place the reference keeps bucket metadata (`bucket_metadata.go` reads
    # entry.Extended). Policy documents are JSON; CORS and lifecycle keep
    # their original XML.

    _EXT_POLICY = "s3-policy"
    _EXT_CORS = "s3-cors"
    _EXT_LIFECYCLE = "s3-lifecycle"
    # set once the bucket holds an x-amz-meta-carrying object: a native
    # GET relay can't serve metadata headers, so its reads stay on Python.
    # Persisted so a gateway with the native front sharing this store sees it.
    _EXT_META_DIRTY = "s3-meta-objects"

    def _bucket_ext_get(self, bucket: str, attr: str) -> str | None:
        entry = self._require_bucket(bucket)
        return (entry.get("extended") or {}).get(attr)

    def _bucket_ext_set(self, bucket: str, attr: str, value: str | None) -> None:
        path = self._bucket_path(bucket)
        entry = self._require_bucket(bucket)
        ext = entry.setdefault("extended", {})
        if value is None:
            ext.pop(attr, None)
        else:
            ext[attr] = value
        self.fc.put_entry(path, entry)

    def _mark_meta_dirty(self, bucket: str) -> None:
        """Persist the marker once a gateway process (best-effort, as in
        the reference)."""
        if bucket in self._meta_dirty:
            return
        self._meta_dirty.add(bucket)
        try:
            self._bucket_ext_set(bucket, self._EXT_META_DIRTY, "1")
        except Exception:
            pass

    def _delete_bucket_ext(self, bucket: str, kind: str, status: int) -> Response:
        attr = {"cors": self._EXT_CORS, "lifecycle": self._EXT_LIFECYCLE,
                "policy": self._EXT_POLICY}[kind]
        self._bucket_ext_set(bucket, attr, None)
        return Response(b"", status)

    def _bucket_policy_doc(self, bucket: str) -> dict | None:
        try:
            raw = self._bucket_ext_get(bucket, self._EXT_POLICY)
        except S3ApiError:
            return None  # NoSuchBucket surfaces from the handler itself
        if not raw:
            return None
        try:
            return json.loads(raw)
        except ValueError:  # pragma: no cover - validated at put time
            return None

    def _get_bucket_policy(self, bucket: str) -> Response:
        raw = self._bucket_ext_get(bucket, self._EXT_POLICY)
        if not raw:
            raise err("NoSuchBucketPolicy", bucket)
        return Response(raw.encode(), 200, {"Content-Type": "application/json"})

    def _put_bucket_policy(self, bucket: str, body: bytes) -> Response:
        self._require_bucket(bucket)
        try:
            doc = bucket_policy.validate(body, bucket)
        except ValueError as e:
            raise err("MalformedPolicy", str(e))
        self._bucket_ext_set(
            bucket, self._EXT_POLICY, json.dumps(doc, separators=(",", ":"))
        )
        return Response(b"", 204)

    def _delete_bucket_policy(self, bucket: str) -> Response:
        return self._delete_bucket_ext(bucket, "policy", 204)

    # CORS (`s3api_server.go` cors wrapper; AWS CORSConfiguration semantics)
    def _parse_cors_rules(self, xml_text: str) -> list[dict]:
        try:
            root = ET.fromstring(xml_text)
        except ET.ParseError:
            raise err("MalformedXML", "bad CORSConfiguration")
        rules = []
        for rule_el in root.iter():
            if not (rule_el.tag == "CORSRule" or rule_el.tag.endswith("}CORSRule")):
                continue
            rule: dict = {"origins": [], "methods": [], "headers": [],
                          "expose": [], "max_age": None}
            for c in rule_el:
                tag = c.tag.rsplit("}", 1)[-1]
                text = (c.text or "").strip()
                if tag == "AllowedOrigin":
                    rule["origins"].append(text)
                elif tag == "AllowedMethod":
                    rule["methods"].append(text.upper())
                elif tag == "AllowedHeader":
                    rule["headers"].append(text)
                elif tag == "ExposeHeader":
                    rule["expose"].append(text)
                elif tag == "MaxAgeSeconds":
                    rule["max_age"] = int(text or 0)
            if rule["origins"] and rule["methods"]:
                rules.append(rule)
        if not rules:
            raise err("MalformedXML", "CORSConfiguration has no valid rules")
        return rules

    def _cors_rules(self, bucket: str) -> list[dict]:
        try:
            raw = self._bucket_ext_get(bucket, self._EXT_CORS)
        except S3ApiError:
            return []
        if not raw:
            return []
        try:
            return self._parse_cors_rules(raw)
        except S3ApiError:  # pragma: no cover - validated at put time
            return []

    @staticmethod
    def _match_cors_rule(rules: list[dict], origin: str, method: str,
                         req_headers: list[str]) -> dict | None:
        from .policy import _wild_match

        for rule in rules:
            if not any(_wild_match(o, origin) for o in rule["origins"]):
                continue
            if method not in rule["methods"]:
                continue
            if req_headers and not all(
                any(_wild_match(h.lower(), want.lower())
                    for h in rule["headers"])
                for want in req_headers
            ):
                continue
            return rule
        return None

    def _get_bucket_cors(self, bucket: str) -> Response:
        raw = self._bucket_ext_get(bucket, self._EXT_CORS)
        if not raw:
            raise err("NoSuchCORSConfiguration", bucket)
        return Response(raw.encode(), 200, {"Content-Type": "application/xml"})

    def _put_bucket_cors(self, bucket: str, body: bytes) -> Response:
        self._require_bucket(bucket)
        self._parse_cors_rules(body.decode("utf-8", "replace"))  # validate
        self._bucket_ext_set(bucket, self._EXT_CORS,
                             body.decode("utf-8", "replace"))
        return Response(b"", 200)

    def _preflight(self, req: Request, bucket: str) -> Response:
        origin = req.headers.get("origin", "")
        method = req.headers.get("access-control-request-method", "")
        want_headers = [
            h.strip()
            for h in req.headers.get("access-control-request-headers", "").split(",")
            if h.strip()
        ]
        rule = self._match_cors_rule(
            self._cors_rules(bucket), origin, method, want_headers
        )
        if origin == "" or method == "" or rule is None:
            return Response(b"", 403)
        headers = {
            "Access-Control-Allow-Origin":
                "*" if rule["origins"] == ["*"] else origin,
            "Access-Control-Allow-Methods": ", ".join(rule["methods"]),
            "Vary": "Origin, Access-Control-Request-Headers",
        }
        allow_headers = want_headers or rule["headers"]
        if allow_headers:
            headers["Access-Control-Allow-Headers"] = ", ".join(allow_headers)
        if rule["expose"]:
            headers["Access-Control-Expose-Headers"] = ", ".join(rule["expose"])
        if rule["max_age"] is not None:
            headers["Access-Control-Max-Age"] = str(rule["max_age"])
        return Response(b"", 200, headers)

    def _apply_cors_headers(self, req: Request, bucket: str, resp: Response) -> None:
        origin = req.headers.get("origin", "")
        if not origin:
            return
        rule = self._match_cors_rule(
            self._cors_rules(bucket), origin, req.method, []
        )
        if rule is None:
            return
        resp.headers.setdefault(
            "Access-Control-Allow-Origin",
            "*" if rule["origins"] == ["*"] else origin,
        )
        if rule["expose"]:
            resp.headers.setdefault(
                "Access-Control-Expose-Headers", ", ".join(rule["expose"])
            )
        resp.headers.setdefault("Vary", "Origin")

    # lifecycle (`s3api_bucket_handlers.go:308-435`; expiry applied here by
    # an explicit sweep over the namespace rather than collection TTLs)
    def _get_bucket_lifecycle(self, bucket: str) -> Response:
        raw = self._bucket_ext_get(bucket, self._EXT_LIFECYCLE)
        if not raw:
            raise err("NoSuchLifecycleConfiguration", bucket)
        return Response(raw.encode(), 200, {"Content-Type": "application/xml"})

    def _parse_lifecycle_rules(self, xml_text: str) -> list[dict]:
        try:
            root = ET.fromstring(xml_text)
        except ET.ParseError:
            raise err("MalformedXML", "bad LifecycleConfiguration")
        rules = []
        for rule_el in root.iter():
            if not (rule_el.tag == "Rule" or rule_el.tag.endswith("}Rule")):
                continue
            status = ""
            prefix = ""
            days = 0
            for c in rule_el.iter():
                tag = c.tag.rsplit("}", 1)[-1]
                text = (c.text or "").strip()
                if tag == "Status":
                    status = text
                elif tag == "Prefix" and text:
                    prefix = text
                elif tag == "Days" and text:
                    days = int(text)
            if status == "Enabled" and days > 0:
                rules.append({"prefix": prefix, "days": days})
        return rules

    def _put_bucket_lifecycle(self, bucket: str, body: bytes) -> Response:
        self._require_bucket(bucket)
        text = body.decode("utf-8", "replace")
        if not self._parse_lifecycle_rules(text):
            raise err(
                "MalformedXML",
                "no Enabled rule with Expiration Days found",
            )
        self._bucket_ext_set(bucket, self._EXT_LIFECYCLE, text)
        return Response(b"", 200)

    def run_lifecycle_sweep(self, now: float | None = None) -> dict:
        """Apply every bucket's lifecycle expiry rules: delete objects whose
        mtime is older than the rule's Days (prefix-filtered). Returns
        {bucket: expired_count}. Driven by the background sweeper thread
        (lifecycle_sweep_interval) or called directly (tests, operators
        embedding the gateway)."""
        now = now or time.time()
        out: dict[str, int] = {}
        listing = self.fc.list(BUCKETS_DIR, limit=10_000)
        for e in listing.get("Entries", []):
            if not e.get("IsDirectory"):
                continue
            bucket = e["FullPath"].rsplit("/", 1)[-1]
            if bucket.startswith("."):
                continue
            raw = self._bucket_ext_get(bucket, self._EXT_LIFECYCLE)
            if not raw:
                continue
            try:
                rules = self._parse_lifecycle_rules(raw)
            except S3ApiError:
                continue
            vstate = self._versioning_state(bucket)
            expired = 0
            for rule in rules:
                cutoff = now - rule["days"] * 86400
                expired += self._expire_prefix(
                    bucket, rule["prefix"], cutoff, vstate
                )
            if expired:
                out[bucket] = expired
        return out

    def _expire_prefix(
        self, bucket: str, prefix: str, cutoff: float, vstate: str = ""
    ) -> int:
        removed = 0
        base = self._bucket_path(bucket)

        def walk(dir_path: str, rel: str) -> None:
            nonlocal removed
            listing = self.fc.list(dir_path, limit=100_000)
            for e in listing.get("Entries", []):
                name = e["FullPath"].rsplit("/", 1)[-1]
                if name in (UPLOADS_FOLDER, VERSIONS_FOLDER):
                    continue
                rel_key = f"{rel}{name}"
                if e.get("IsDirectory"):
                    walk(e["FullPath"], rel_key + "/")
                    continue
                if not rel_key.startswith(prefix):
                    continue
                if e.get("Mtime", 0) < cutoff:
                    try:
                        # expiry on a versioned bucket leaves a delete
                        # marker (AWS lifecycle semantics), not destruction
                        self._versioned_delete(bucket, rel_key, vstate)
                        removed += 1
                    except IOError:
                        pass

        walk(base, "")
        return removed

    # --- ACLs (`s3api_acl_helper.go:33-93`) -----------------------------------
    # Stored as extended attributes on the bucket/object entries, like the
    # other bucket metadata. GET serves the stored ACP (default: owner
    # FULL_CONTROL); PUT accepts canned/grant headers or an
    # AccessControlPolicy body, fully validated.

    _EXT_ACL = "s3-acl"

    def _acl_entry(self, bucket: str, key: str | None):
        if key is None:
            return self._bucket_path(bucket), self._require_bucket(bucket)
        path = self._object_path(bucket, key)
        entry = self.fc.get_entry(path)
        if entry is None:
            raise err("NoSuchKey", key)
        return path, entry

    def _acl_owner(self, bucket: str, key: str | None, ident) -> str:
        """The resource's recorded owner: its own stored ACP, else the
        BUCKET's stored ACP (objects inherit the bucket owner), else the
        requester (pre-ACL resources with no record of their creator)."""
        from . import acl as acl_mod

        _, entry = self._acl_entry(bucket, key)
        raw = (entry.get("extended") or {}).get(self._EXT_ACL)
        if not raw and key is not None:
            _, bentry = self._acl_entry(bucket, None)
            raw = (bentry.get("extended") or {}).get(self._EXT_ACL)
        if raw:
            return acl_mod.loads(raw)[0]
        return ident.account_id

    def _get_acl(self, ident, bucket: str, key: str | None = None) -> Response:
        from . import acl as acl_mod

        _, entry = self._acl_entry(bucket, key)
        raw = (entry.get("extended") or {}).get(self._EXT_ACL)
        if raw:
            owner, grants = acl_mod.loads(raw)
        else:
            owner = self._acl_owner(bucket, key, ident)
            grants = [{"type": "CanonicalUser", "value": owner,
                       "perm": "FULL_CONTROL"}]
        return xml_response("AccessControlPolicy",
                            acl_mod.acp_to_xml_inner(owner, grants))

    def _put_acl(self, req: Request, ident, bucket: str,
                 key: str | None = None) -> Response:
        from . import acl as acl_mod

        owner = self._acl_owner(bucket, key, ident)
        grants = self._parse_request_acl(req, ident)
        if grants is None:
            if not req.body:
                # bare PUT ?acl: private (owner-only), as on AWS
                grants = acl_mod.grants_from_canned("private", owner)
            else:
                owner_in, grants = acl_mod.acp_from_xml(req.body)
                # AWS rejects an ACP whose Owner differs from the
                # resource's actual owner — accepting it would let any
                # writer spoof ownership
                if owner_in and owner_in != owner:
                    raise err("AccessDenied",
                              "ACP owner does not match resource owner")
        self._apply_acl(owner, bucket, key, grants)
        return Response(b"", 200)

    def _parse_request_acl(self, req: Request, ident) -> list | None:
        """Validate x-amz-acl / x-amz-grant-* headers on PUT bucket/object
        BEFORE the write happens (bad grants must fail the request without
        side effects); returns the grants or None when absent."""
        from . import acl as acl_mod

        headers = {k.lower(): v for k, v in req.headers.items()}
        return acl_mod.extract_acl(headers, ident.account_id,
                                   bucket_owner_id=ident.account_id)

    def _apply_acl(self, owner: str, bucket: str, key: str | None,
                   grants: list | None) -> None:
        from . import acl as acl_mod

        if grants is None:
            return
        path, entry = self._acl_entry(bucket, key)
        entry.setdefault("extended", {})[self._EXT_ACL] = acl_mod.dumps(
            owner, grants)
        self.fc.put_entry(path, entry)

    def _post_policy_upload(self, req: Request, bucket: str) -> Response:
        """POST object via browser form (sigv4-HTTPPOSTConstructPolicy):
        verify the form's signature over its base64 policy, enforce every
        policy condition, then store under the form's key."""
        import base64
        import hmac as hmac_mod

        from .auth import signing_key

        self._require_writable_bucket(bucket)
        fields, file_part = req.multipart_form()
        if file_part is None:
            raise err("MalformedPOSTRequest", "form has no file part")
        filename, file_ctype, data = file_part
        fields_ci = {k.lower(): v for k, v in fields.items()}
        key = fields_ci.get("key", "")
        if not key:
            raise err("MalformedPOSTRequest", "form has no key field")
        key = key.replace("${filename}", filename)

        policy_b64 = fields_ci.get("policy", "")
        if not policy_b64:
            raise err("AccessDenied", "POST without policy is not allowed")
        if ("awsaccesskeyid" in fields_ci
                and "x-amz-algorithm" not in fields_ci):
            # POST-policy V2 (`auth_signature_v2.go` DoesPolicySignatureV2
            # Match): signature = base64(HMAC-SHA1(secret, policy_b64))
            akid = fields_ci["awsaccesskeyid"]
            ident, secret = self.iam.lookup(akid)
            if not hmac_mod.compare_digest(
                self.iam._v2_sign(secret, policy_b64),
                fields_ci.get("signature", ""),
            ):
                raise err("SignatureDoesNotMatch", "post policy v2 signature")
        else:
            if fields_ci.get("x-amz-algorithm") != "AWS4-HMAC-SHA256":
                raise err("MalformedPOSTRequest",
                          "unsupported x-amz-algorithm")
            cred = fields_ci.get("x-amz-credential", "")
            parts = cred.split("/")
            if (len(parts) != 5 or parts[3] != "s3"
                    or parts[4] != "aws4_request"):
                raise err("MalformedPOSTRequest", f"bad credential {cred!r}")
            akid, date, region = parts[0], parts[1], parts[2]
            ident, secret = self.iam.lookup(akid)
            want = hmac_mod.new(
                signing_key(secret, date, region, "s3"),
                policy_b64.encode(),
                hashlib.sha256,
            ).hexdigest()
            if not hmac_mod.compare_digest(
                want, fields_ci.get("x-amz-signature", "")
            ):
                raise err("SignatureDoesNotMatch", "post policy signature")
        try:
            doc = json.loads(base64.b64decode(policy_b64))
            bucket_policy.check_post_policy(
                doc, {**fields_ci, "bucket": bucket, "key": key}, len(data)
            )
        except ValueError as e:
            raise err("AccessDenied", f"policy check failed: {e}")
        if not ident.can_do(ACTION_WRITE, bucket, key):
            raise err("AccessDenied", f"{ident.name} cannot Write /{bucket}/{key}")

        ctype = fields_ci.get("content-type", file_ctype)
        self.fc.put(self._object_path(bucket, key), data, ctype)
        etag = hashlib.md5(data).hexdigest()
        status = int(fields_ci.get("success_action_status", "204") or 204)
        headers = {"ETag": f'"{etag}"', "Location": f"/{bucket}/{key}"}
        if status == 201:
            inner = (
                f"<Location>/{escape(bucket)}/{escape(key)}</Location>"
                f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
                f'<ETag>"{etag}"</ETag>'
            )
            resp = xml_response("PostResponse", inner, 201)
            resp.headers.update(headers)
            return resp
        if status not in (200, 204):
            status = 204
        return Response(b"", status, headers)

    # --- versioning (`s3api_object_handlers_put.go` versioning flags; real
    # version retention rather than the reference's pass-through) ------------
    _EXT_VERSIONING = "s3-versioning"
    _EXT_VID = "s3-vid"
    _EXT_DELETE_MARKER = "s3-delete-marker"

    def _versioning_state(self, bucket: str) -> str:
        try:
            return self._bucket_ext_get(bucket, self._EXT_VERSIONING) or ""
        except S3ApiError:
            return ""

    def _get_bucket_versioning(self, bucket: str) -> Response:
        self._require_bucket(bucket)
        state = self._versioning_state(bucket)
        inner = f"<Status>{state}</Status>" if state else ""
        return xml_response("VersioningConfiguration", inner)

    def _put_bucket_versioning(self, bucket: str, body: bytes) -> Response:
        self._require_bucket(bucket)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise err("MalformedXML", "bad VersioningConfiguration")
        status = ""
        for el in root.iter():
            if el.tag.rsplit("}", 1)[-1] == "Status":
                status = (el.text or "").strip()
        if status not in ("Enabled", "Suspended"):
            raise err("MalformedXML", "Status must be Enabled or Suspended")
        self._bucket_ext_set(bucket, self._EXT_VERSIONING, status)
        return Response(b"", 200)

    @staticmethod
    def _new_version_id() -> str:
        return f"{time.time_ns():020d}.{uuid.uuid4().hex[:8]}"

    def _versions_dir(self, bucket: str, key: str) -> str:
        return f"{self._bucket_path(bucket)}/{VERSIONS_FOLDER}/{key}"

    def _entry_vid(self, entry: dict | None) -> str:
        if not entry:
            return ""
        return (entry.get("extended") or {}).get(self._EXT_VID, "null")

    def _retire_current_version(
        self, bucket: str, key: str, only_real_vid: bool = False
    ) -> None:
        """Move the current object into the versions folder under its own
        version id (chunks move with the entry — no data copy).
        only_real_vid: leave a "null"-version current in place (Suspended
        semantics: the null version is the one that gets overwritten)."""
        path = self._object_path(bucket, key)
        cur = self.fc.get_entry(path)
        if cur is None or cur.get("is_directory"):
            return
        vid = self._entry_vid(cur)
        if only_real_vid and vid == "null":
            return
        try:
            self.fc.rename(path, f"{self._versions_dir(bucket, key)}/{vid}")
        except IOError:
            pass

    def _stamp_vid(self, path: str, vid: str) -> None:
        entry = self.fc.get_entry(path)
        if entry is not None:
            entry.setdefault("extended", {})[self._EXT_VID] = vid
            self.fc.put_entry(path, entry)

    # --- object handlers --------------------------------------------------------
    def _put_object(self, req: Request, bucket: str, key: str) -> Response:
        self._require_writable_bucket(bucket)
        body = req.body
        sha_hdr = req.headers.get("x-amz-content-sha256", "")
        if sha_hdr.startswith("STREAMING-"):
            body = deframe_streaming_body(body)
        if key.endswith("/"):
            self.fc.mkdir(self._object_path(bucket, key.rstrip("/")))
            return Response(b"", 200, {"ETag": '"d41d8cd98f00b204e9800998ecf8427e"'})
        etag = hashlib.md5(body).hexdigest()
        content_type = req.headers.get("Content-Type", "")
        vstate = self._versioning_state(bucket)
        vid = ""
        if vstate == "Enabled":
            self._retire_current_version(bucket, key)
            vid = self._new_version_id()
        elif vstate == "Suspended":
            # AWS: suspension only stops MINTING ids — versions written
            # while enabled stay retained; only the "null" version is
            # overwritten in place
            self._retire_current_version(bucket, key, only_real_vid=True)
            vid = "null"
        self.fc.put(self._object_path(bucket, key), body, content_type)
        if vid:
            self._stamp_vid(self._object_path(bucket, key), vid)
        # x-amz-meta-* headers persist as extended attributes
        meta = {
            k.lower()[len(AMZ_META_PREFIX):]: v
            for k, v in req.headers.items()
            if k.lower().startswith(AMZ_META_PREFIX)
        }
        if meta:
            path = self._object_path(bucket, key)
            entry = self.fc.get_entry(path)
            if entry is not None:
                entry.setdefault("extended", {}).update(
                    {f"{AMZ_META_PREFIX}{k}": v for k, v in meta.items()}
                )
                self.fc.put_entry(path, entry)
            self._mark_meta_dirty(bucket)
        headers = {"ETag": f'"{etag}"'}
        if vid:
            headers["x-amz-version-id"] = vid
        return Response(b"", 200, headers)

    def _copy_object(self, req: Request, bucket: str, key: str) -> Response:
        self._require_writable_bucket(bucket)
        src = urllib.parse.unquote(req.headers["x-amz-copy-source"]).lstrip("/")
        src_bucket, _, src_key = src.partition("/")
        src_entry = self.fc.get_entry(self._object_path(src_bucket, src_key))
        if src_entry is None or src_entry.get("is_directory"):
            raise err("NoSuchKey", src)
        # replicate metadata + chunk list; the blobs are shared until the
        # source is deleted and reclaimed, so materialize the data instead
        data = self.fc.read(self._object_path(src_bucket, src_key))
        self.fc.put(
            self._object_path(bucket, key),
            data,
            src_entry.get("attributes", {}).get("mime", ""),
        )
        etag = hashlib.md5(data).hexdigest()
        inner = (
            f"<ETag>\"{etag}\"</ETag>"
            f"<LastModified>{amz_time(time.time())}</LastModified>"
        )
        return xml_response("CopyObjectResult", inner)

    def _get_object(
        self, req: Request, bucket: str, key: str, head: bool,
        path_override: str | None = None,
    ) -> Response:
        self._require_bucket(bucket)
        path = path_override or self._object_path(bucket, key)
        entry = self.fc.get_entry(path)
        if entry is None or entry.get("is_directory"):
            raise err("NoSuchKey", key)
        attrs = entry.get("attributes", {})
        headers = {
            "ETag": f'"{attrs.get("md5") or ""}"',
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(attrs.get("mtime", 0))
            ),
            "Accept-Ranges": "bytes",
        }
        if attrs.get("mime"):
            headers["Content-Type"] = attrs["mime"]
        for k, v in (entry.get("extended") or {}).items():
            if k.startswith(AMZ_META_PREFIX):
                headers[k] = v
        size = attrs.get("file_size", 0) or sum(
            c["size"] for c in entry.get("chunks", [])
        )
        if entry.get("content"):
            size = len(entry["content"]) // 2  # hex-encoded
        if head:
            headers["Content-Length"] = str(size)
            return Response(b"", 200, headers)
        status, fh, body = self.fc.get(path, req.headers.get("Range"))
        if status >= 400:
            raise err("NoSuchKey", key)
        if "Content-Range" in fh:
            headers["Content-Range"] = fh["Content-Range"]
        return Response(body, status, headers)

    def _versioned_delete(self, bucket: str, key: str, vstate: str) -> dict:
        """Versioning-aware delete shared by DELETE, batch delete and the
        lifecycle sweep; returns the response headers. Enabled: retire the
        current version, leave a delete marker. Suspended: real-vid current
        versions are still retained; the null version dies and a null
        marker takes its place. Off: plain destructive delete."""
        if vstate not in ("Enabled", "Suspended"):
            self.fc.delete(self._object_path(bucket, key), recursive=True)
            return {}
        if vstate == "Enabled":
            self._retire_current_version(bucket, key)
            vid = self._new_version_id()
        else:
            self._retire_current_version(bucket, key, only_real_vid=True)
            try:
                self.fc.delete(self._object_path(bucket, key))
            except IOError:
                pass
            vid = "null"
        marker_path = f"{self._versions_dir(bucket, key)}/{vid}"
        self.fc.put(marker_path, b"", "")
        entry = self.fc.get_entry(marker_path)
        if entry is not None:
            entry.setdefault("extended", {}).update(
                {self._EXT_VID: vid, self._EXT_DELETE_MARKER: "1"}
            )
            self.fc.put_entry(marker_path, entry)
        return {"x-amz-delete-marker": "true", "x-amz-version-id": vid}

    def _delete_object(self, bucket: str, key: str) -> Response:
        self._require_bucket(bucket)
        vstate = self._versioning_state(bucket)
        if vstate in ("Enabled", "Suspended"):
            return Response(b"", 204, self._versioned_delete(bucket, key, vstate))
        self.fc.delete(self._object_path(bucket, key), recursive=True)
        return Response(b"", 204)

    def _iter_versions(self, bucket: str, key: str) -> list[dict]:
        """All retired versions of one key, newest first (version ids are
        time-ordered)."""
        try:
            listing = self.fc.list(
                self._versions_dir(bucket, key), limit=10_000
            )
        except IOError:
            return []  # key has no retained versions
        out = [
            e for e in listing.get("Entries", [])
            if not e.get("IsDirectory")
        ]
        # newest first; the "null" (pre-versioning) id is always oldest
        out.sort(
            key=lambda e: (
                "" if (n := e["FullPath"].rsplit("/", 1)[-1]) == "null" else n
            ),
            reverse=True,
        )
        return out

    def _get_object_version(
        self, req: Request, bucket: str, key: str, vid: str, head: bool
    ) -> Response:
        self._require_bucket(bucket)
        cur = self.fc.get_entry(self._object_path(bucket, key))
        if cur is not None and self._entry_vid(cur) == vid:
            return self._get_object(req, bucket, key, head=head)
        path = f"{self._versions_dir(bucket, key)}/{vid}"
        entry = self.fc.get_entry(path)
        if entry is None:
            raise err("NoSuchKey", f"{key}?versionId={vid}")
        if (entry.get("extended") or {}).get(self._EXT_DELETE_MARKER):
            return Response(
                b"", 405,
                {"x-amz-delete-marker": "true", "x-amz-version-id": vid,
                 "Allow": "DELETE"},
            )
        resp = self._get_object(
            req, bucket, key, head=head, path_override=path
        )
        resp.headers["x-amz-version-id"] = vid
        return resp

    def _delete_object_version(self, bucket: str, key: str, vid: str) -> Response:
        """Permanent removal of one version; the next-newest non-marker
        version is promoted back to the current path when the current slot
        is empty (AWS: the latest remaining version becomes current)."""
        self._require_bucket(bucket)
        cur_path = self._object_path(bucket, key)
        cur = self.fc.get_entry(cur_path)
        marker = False
        if cur is not None and self._entry_vid(cur) == vid:
            self.fc.delete(cur_path)
        else:
            path = f"{self._versions_dir(bucket, key)}/{vid}"
            entry = self.fc.get_entry(path)
            if entry is None:
                return Response(b"", 204)
            marker = bool(
                (entry.get("extended") or {}).get(self._EXT_DELETE_MARKER)
            )
            self.fc.delete(path)
        # promote: only when no live current remains and the newest
        # remaining version is a real object (not a delete marker)
        if self.fc.get_entry(cur_path) is None:
            for v in self._iter_versions(bucket, key):
                entry = self.fc.get_entry(v["FullPath"])
                vext = (entry or {}).get("extended") or {}
                if vext.get(self._EXT_DELETE_MARKER):
                    break  # a marker is the latest: stay deleted
                try:
                    self.fc.rename(v["FullPath"], cur_path)
                except IOError:
                    pass
                break
        headers = {"x-amz-version-id": vid}
        if marker:
            headers["x-amz-delete-marker"] = "true"
        return Response(b"", 204, headers)

    def _list_object_versions(self, bucket: str, q: dict) -> Response:
        """GET ?versions — Version + DeleteMarker elements, newest first per
        key, current object marked IsLatest."""
        self._require_bucket(bucket)
        prefix = q.get("prefix", "")
        key_marker = q.get("key-marker", "")
        max_keys = min(int(q.get("max-keys", "1000") or 1000), 1000)
        inner = [
            f"<Name>{escape(bucket)}</Name>",
            f"<Prefix>{escape(prefix)}</Prefix>",
            f"<KeyMarker>{escape(key_marker)}</KeyMarker>",
            f"<MaxKeys>{max_keys}</MaxKeys>",
        ]

        def emit(key: str, entry: dict, is_latest: bool) -> None:
            ext = entry.get("extended") or {}
            vid = ext.get(self._EXT_VID, "null")
            mtime = entry.get("attributes", {}).get("mtime", 0)
            if ext.get(self._EXT_DELETE_MARKER):
                inner.append(
                    f"<DeleteMarker><Key>{escape(key)}</Key>"
                    f"<VersionId>{vid}</VersionId>"
                    f"<IsLatest>{'true' if is_latest else 'false'}</IsLatest>"
                    f"<LastModified>{amz_time(mtime)}</LastModified>"
                    f"</DeleteMarker>"
                )
            else:
                size = entry.get("attributes", {}).get("file_size", 0)
                inner.append(
                    f"<Version><Key>{escape(key)}</Key>"
                    f"<VersionId>{vid}</VersionId>"
                    f"<IsLatest>{'true' if is_latest else 'false'}</IsLatest>"
                    f"<LastModified>{amz_time(mtime)}</LastModified>"
                    f"<Size>{size}</Size></Version>"
                )

        # keys with retained versions, discovered from the versions tree
        vroot = f"{self._bucket_path(bucket)}/{VERSIONS_FOLDER}"
        keys: set[str] = set()

        def walk(dir_path: str, rel: str) -> None:
            listing = self.fc.list(dir_path, limit=100_000)
            entries = listing.get("Entries", [])
            if entries and all(not e.get("IsDirectory") for e in entries):
                keys.add(rel.rstrip("/"))
                return
            for e in entries:
                name = e["FullPath"].rsplit("/", 1)[-1]
                if e.get("IsDirectory"):
                    walk(e["FullPath"], rel + name + "/")
                else:
                    keys.add(rel.rstrip("/"))

        if self.fc.exists(vroot):
            walk(vroot, "")
        # current objects too (they may have no retired versions yet)
        marker = ""
        while True:
            contents, _, truncated, marker = self._walk(
                bucket, prefix, "", marker, 1000
            )
            for item in contents:
                keys.add(item["key"])
            if not truncated or not contents:
                break
        selected = sorted(
            k for k in keys
            if k.startswith(prefix) and (not key_marker or k > key_marker)
        )
        truncated = len(selected) > max_keys
        for key in selected[:max_keys]:
            cur = self.fc.get_entry(self._object_path(bucket, key))
            emitted_latest = False
            if cur is not None and not cur.get("is_directory"):
                emit(key, cur, True)
                emitted_latest = True
            for v in self._iter_versions(bucket, key):
                entry = self.fc.get_entry(v["FullPath"])
                if entry is not None:
                    emit(key, entry, not emitted_latest)
                    emitted_latest = True
        inner.append(
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
        )
        if truncated:
            inner.append(
                f"<NextKeyMarker>{escape(selected[max_keys - 1])}"
                f"</NextKeyMarker>"
            )
        return xml_response("ListVersionsResult", "".join(inner))

    def _delete_objects(self, req: Request, bucket: str) -> Response:
        self._require_bucket(bucket)
        try:
            root = ET.fromstring(req.body)
        except ET.ParseError:
            raise err("MalformedXML", "bad Delete document")
        deleted, errors = [], []
        vstate = self._versioning_state(bucket)
        for obj in root.iter():
            if not obj.tag.endswith("Object"):
                continue
            key_el = next(
                (c for c in obj if c.tag.endswith("Key")), None
            )
            if key_el is None or not key_el.text:
                continue
            k = key_el.text
            try:
                # same semantics as single-object DELETE: a versioned
                # bucket gets markers, not destruction
                self._versioned_delete(bucket, k, vstate)
                deleted.append(k)
            except Exception as e:
                errors.append((k, str(e)))
        inner = "".join(
            f"<Deleted><Key>{escape(k)}</Key></Deleted>" for k in deleted
        ) + "".join(
            f"<Error><Key>{escape(k)}</Key><Code>InternalError</Code>"
            f"<Message>{escape(msg)}</Message></Error>"
            for k, msg in errors
        )
        return xml_response("DeleteResult", inner)

    # --- listing ----------------------------------------------------------------
    def _list_objects(self, req: Request, bucket: str, q: dict) -> Response:
        self._require_bucket(bucket)
        v2 = q.get("list-type") == "2"
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        try:
            max_keys = min(int(q.get("max-keys", "1000") or 1000), 1000)
        except ValueError:
            raise err("InvalidArgument", "bad max-keys")
        marker = (
            q.get("continuation-token") or q.get("start-after", "")
            if v2
            else q.get("marker", "")
        )
        contents, prefixes, truncated, next_marker = self._walk(
            bucket, prefix, delimiter, marker, max_keys
        )
        inner = (
            f"<Name>{escape(bucket)}</Name><Prefix>{escape(prefix)}</Prefix>"
            f"<MaxKeys>{max_keys}</MaxKeys>"
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
        )
        if delimiter:
            inner += f"<Delimiter>{escape(delimiter)}</Delimiter>"
        for item in contents:
            inner += (
                "<Contents>"
                f"<Key>{escape(item['key'])}</Key>"
                f"<LastModified>{amz_time(item['mtime'])}</LastModified>"
                f"<ETag>\"{item['etag']}\"</ETag>"
                f"<Size>{item['size']}</Size>"
                "<StorageClass>STANDARD</StorageClass>"
                "</Contents>"
            )
        for p in prefixes:
            inner += f"<CommonPrefixes><Prefix>{escape(p)}</Prefix></CommonPrefixes>"
        if v2:
            inner += f"<KeyCount>{len(contents) + len(prefixes)}</KeyCount>"
            if truncated:
                inner += (
                    f"<NextContinuationToken>{escape(next_marker)}"
                    "</NextContinuationToken>"
                )
            return xml_response("ListBucketResult", inner)
        if truncated:
            inner += f"<NextMarker>{escape(next_marker)}</NextMarker>"
        return xml_response("ListBucketResult", inner)

    def _iter_bucket(self, bucket: str, prefix: str, marker: str, delimiter: str):
        """Depth-first walk yielding ("key", dict) / ("prefix", str) items in
        S3 lexicographic KEY order (`s3api_object_handlers_list.go`).

        Ordering subtlety: the filer sorts a directory's children by name,
        but S3 sorts by full key — so directory "a" (whose keys start "a/")
        must sort as "a/", AFTER file "a.txt" ('.' < '/'). Each directory
        page is therefore re-sorted by effective key before descending.
        When delimiter is "/", a qualifying subtree rolls up into a single
        prefix item without being descended."""
        base = self._bucket_path(bucket)

        def walk_dir(dir_rel: str):
            dir_abs = f"{base}/{dir_rel}".rstrip("/")
            entries: list[dict] = []
            last = ""
            while True:
                page = self.fc.list(dir_abs, last_file_name=last, limit=1024).get(
                    "Entries", []
                )
                entries.extend(page)
                if len(page) < 1024:
                    break
                last = page[-1]["FullPath"].rsplit("/", 1)[-1]

            def eff_key(e: dict) -> str:
                name = e["FullPath"].rsplit("/", 1)[-1]
                return name + "/" if e.get("IsDirectory") else name

            for e in sorted(entries, key=eff_key):
                name = e["FullPath"].rsplit("/", 1)[-1]
                rel = dir_rel + name
                if not dir_rel and name in (UPLOADS_FOLDER, VERSIONS_FOLDER):
                    continue
                if e.get("IsDirectory"):
                    sub = rel + "/"
                    # prune subtrees that can't contain the prefix, or whose
                    # entire key range precedes the marker
                    if prefix and not (
                        sub.startswith(prefix) or prefix.startswith(sub)
                    ):
                        continue
                    if marker and sub < marker and not marker.startswith(sub):
                        continue
                    if (
                        delimiter == "/"
                        and sub.startswith(prefix)
                        and len(sub) > len(prefix)
                    ):
                        yield ("prefix", sub)
                        continue
                    yield from walk_dir(sub)
                else:
                    if not rel.startswith(prefix):
                        continue
                    if marker and rel <= marker:
                        continue
                    yield (
                        "key",
                        {
                            "key": rel,
                            "size": e.get("FileSize", 0),
                            "mtime": e.get("Mtime", 0),
                            "etag": e.get("Md5", "") or "",
                        },
                    )

        yield from walk_dir("")

    def _walk(
        self, bucket: str, prefix: str, delimiter: str, marker: str, max_keys: int
    ) -> tuple[list[dict], list[str], bool, str]:
        """Apply delimiter grouping + max-keys truncation over the ordered
        key stream. Arbitrary delimiters group at the first occurrence after
        the prefix; "/" additionally benefits from subtree rollup in
        _iter_bucket."""
        contents: list[dict] = []
        prefixes: list[str] = []
        last_emitted = ""
        for kind, item in self._iter_bucket(bucket, prefix, marker, delimiter):
            if kind == "key" and delimiter and delimiter != "/":
                key = item["key"]
                idx = key.find(delimiter, len(prefix))
                if idx >= 0:
                    group = key[: idx + len(delimiter)]
                    if marker and (group <= marker or marker.startswith(group)):
                        continue
                    if prefixes and prefixes[-1] == group:
                        continue  # groups are contiguous in key order
                    kind, item = "prefix", group
            if len(contents) + len(prefixes) >= max_keys:
                return contents, prefixes, True, last_emitted
            if kind == "prefix":
                prefixes.append(item)  # type: ignore[arg-type]
                last_emitted = item  # type: ignore[assignment]
            else:
                contents.append(item)  # type: ignore[arg-type]
                last_emitted = item["key"]  # type: ignore[index]
        return contents, prefixes, False, last_emitted

    # --- multipart --------------------------------------------------------------
    def _uploads_dir(self, bucket: str, upload_id: str = "") -> str:
        d = f"{self._bucket_path(bucket)}/{UPLOADS_FOLDER}"
        return f"{d}/{upload_id}" if upload_id else d

    def _create_multipart(self, req: Request, bucket: str, key: str) -> Response:
        self._require_writable_bucket(bucket)
        upload_id = uuid.uuid4().hex
        staging = self._uploads_dir(bucket, upload_id)
        self.fc.mkdir(staging)
        manifest = {
            "key": key,
            "content_type": req.headers.get("Content-Type", ""),
            "meta": {
                k.lower()[len(AMZ_META_PREFIX):]: v
                for k, v in req.headers.items()
                if k.lower().startswith(AMZ_META_PREFIX)
            },
        }
        self.fc.put(f"{staging}/upload.json", json.dumps(manifest).encode())
        inner = (
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
        )
        return xml_response("InitiateMultipartUploadResult", inner)

    def _get_upload_manifest(self, bucket: str, upload_id: str) -> dict:
        staging = self._uploads_dir(bucket, upload_id)
        status, _, body = self.fc.get(f"{staging}/upload.json")
        if status != 200:
            raise err("NoSuchUpload", upload_id)
        return json.loads(body)

    def _upload_part(self, req: Request, bucket: str, key: str, q: dict) -> Response:
        # quota read-only covers in-flight uploads too, or a pre-flip
        # uploadId could keep pouring parts into a frozen bucket
        self._require_writable_bucket(bucket)
        upload_id = q["uploadId"]
        self._get_upload_manifest(bucket, upload_id)
        try:
            part_num = int(q.get("partNumber", "0"))
        except ValueError:
            raise err("InvalidArgument", "bad partNumber")
        if not 1 <= part_num <= 10_000:
            raise err("InvalidArgument", f"partNumber {part_num} out of range")
        body = req.body
        if req.headers.get("x-amz-content-sha256", "").startswith("STREAMING-"):
            body = deframe_streaming_body(body)
        etag = hashlib.md5(body).hexdigest()
        staging = self._uploads_dir(bucket, upload_id)
        self.fc.put(f"{staging}/{part_num:05d}.part", body)
        return Response(b"", 200, {"ETag": f'"{etag}"'})

    def _complete_multipart(
        self, req: Request, bucket: str, key: str, q: dict
    ) -> Response:
        self._require_writable_bucket(bucket)
        upload_id = q["uploadId"]
        manifest = self._get_upload_manifest(bucket, upload_id)
        staging = self._uploads_dir(bucket, upload_id)
        try:
            root = ET.fromstring(req.body)
        except ET.ParseError:
            raise err("MalformedXML", "bad CompleteMultipartUpload document")
        parts: list[tuple[int, str]] = []
        for p in root.iter():
            if not p.tag.endswith("Part"):
                continue
            num = next((c.text for c in p if c.tag.endswith("PartNumber")), None)
            etag = next((c.text for c in p if c.tag.endswith("ETag")), "")
            if num is None:
                raise err("MalformedXML", "Part missing PartNumber")
            parts.append((int(num), (etag or "").strip('"')))
        if parts != sorted(parts, key=lambda x: x[0]) or len(parts) != len(
            {n for n, _ in parts}
        ):
            raise err("InvalidPartOrder", "parts must be ascending and unique")
        if not parts:
            raise err("MalformedXML", "no parts")

        # collect part entries; assemble by chunk concatenation
        # (`filer_multipart.go` CompleteMultipartUpload)
        chunks: list[dict] = []
        offset = 0
        md5s = b""
        part_entries: dict[int, dict] = {}
        any_inline = False
        for num, etag in parts:
            part_path = f"{staging}/{num:05d}.part"
            entry = self.fc.get_entry(part_path)
            if entry is None:
                raise err("InvalidPart", f"part {num} not uploaded")
            part_entries[num] = entry
            md5s += bytes.fromhex(entry["attributes"].get("md5", "") or "")
            if entry.get("content"):
                any_inline = True
        if any_inline:
            # small parts were inlined by the filer — materialize the whole
            # object and store it as a regular put (tiny total by construction)
            data = b"".join(
                self.fc.read(f"{staging}/{num:05d}.part") for num, _ in parts
            )
            self.fc.put(
                self._object_path(bucket, manifest["key"]),
                data,
                manifest.get("content_type", ""),
            )
            final_size = len(data)
        else:
            for num, etag in parts:
                entry = part_entries[num]
                part_size = entry["attributes"].get("file_size", 0)
                for c in sorted(entry.get("chunks", []), key=lambda c: c["offset"]):
                    # carry every chunk field (incl. cipher_key/is_compressed)
                    # — dropping them would leave ciphered parts unreadable
                    nc = dict(c)
                    nc["offset"] = offset + c["offset"]
                    nc["modified_ts_ns"] = time.time_ns()
                    chunks.append(nc)
                offset += part_size
            final_size = offset
            final_entry = {
                "full_path": self._object_path(bucket, manifest["key"]),
                "is_directory": False,
                "attributes": {
                    "mtime": time.time(),
                    "mode": 0o644,
                    "mime": manifest.get("content_type", ""),
                    "file_size": final_size,
                    "md5": "",
                },
                "chunks": chunks,
                "extended": {
                    f"{AMZ_META_PREFIX}{k}": v
                    for k, v in manifest.get("meta", {}).items()
                },
                "content": "",
            }
            self.fc.put_entry(final_entry["full_path"], final_entry)
            # drop the part entries WITHOUT reclaiming blobs (the final entry
            # owns them now): rewrite each part to chunkless, then delete
            for num, _ in parts:
                entry = part_entries[num]
                entry["chunks"] = []
                self.fc.put_entry(f"{staging}/{num:05d}.part", entry)
        if manifest.get("meta"):
            self._mark_meta_dirty(bucket)
        multipart_etag = f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"
        self.fc.delete(staging, recursive=True)
        inner = (
            f"<Location>/{escape(bucket)}/{escape(manifest['key'])}</Location>"
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(manifest['key'])}</Key>"
            f"<ETag>\"{multipart_etag}\"</ETag>"
        )
        return xml_response("CompleteMultipartUploadResult", inner)

    def _abort_multipart(self, bucket: str, key: str, q: dict) -> Response:
        upload_id = q["uploadId"]
        self._get_upload_manifest(bucket, upload_id)
        self.fc.delete(self._uploads_dir(bucket, upload_id), recursive=True)
        return Response(b"", 204)

    def _list_parts(self, bucket: str, key: str, q: dict) -> Response:
        # ListParts is a READ: it must keep working on quota-frozen buckets
        upload_id = q["uploadId"]
        manifest = self._get_upload_manifest(bucket, upload_id)
        staging = self._uploads_dir(bucket, upload_id)
        listing = self.fc.list(staging, limit=10_001)
        inner = (
            f"<Bucket>{escape(bucket)}</Bucket>"
            f"<Key>{escape(manifest['key'])}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
        )
        for e in listing.get("Entries", []):
            name = e["FullPath"].rsplit("/", 1)[-1]
            if not name.endswith(".part"):
                continue
            inner += (
                "<Part>"
                f"<PartNumber>{int(name[:-5])}</PartNumber>"
                f"<LastModified>{amz_time(e.get('Mtime', 0))}</LastModified>"
                f"<ETag>\"{e.get('Md5', '')}\"</ETag>"
                f"<Size>{e.get('FileSize', 0)}</Size>"
                "</Part>"
            )
        return xml_response("ListPartsResult", inner)

    def _list_multipart_uploads(self, bucket: str) -> Response:
        self._require_bucket(bucket)
        listing = self.fc.list(self._uploads_dir(bucket), limit=1000)
        inner = f"<Bucket>{escape(bucket)}</Bucket>"
        for e in listing.get("Entries", []):
            if not e.get("IsDirectory"):
                continue
            upload_id = e["FullPath"].rsplit("/", 1)[-1]
            try:
                manifest = self._get_upload_manifest(bucket, upload_id)
            except S3ApiError:
                continue
            inner += (
                "<Upload>"
                f"<Key>{escape(manifest['key'])}</Key>"
                f"<UploadId>{upload_id}</UploadId>"
                f"<Initiated>{amz_time(e.get('Mtime', 0))}</Initiated>"
                "</Upload>"
            )
        return xml_response("ListMultipartUploadsResult", inner)

    # --- tagging ----------------------------------------------------------------
    def _get_tagging(self, path: str) -> Response:
        entry = self.fc.get_entry(path)
        if entry is None:
            raise err("NoSuchKey", path)
        tags = {
            k[len(TAG_PREFIX):]: v
            for k, v in (entry.get("extended") or {}).items()
            if k.startswith(TAG_PREFIX)
        }
        inner = "<TagSet>" + "".join(
            f"<Tag><Key>{escape(k)}</Key><Value>{escape(v)}</Value></Tag>"
            for k, v in sorted(tags.items())
        ) + "</TagSet>"
        return xml_response("Tagging", inner)

    def _put_tagging(self, path: str, body: bytes) -> Response:
        entry = self.fc.get_entry(path)
        if entry is None:
            raise err("NoSuchKey", path)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise err("MalformedXML", "bad Tagging document")
        tags = {}
        for tag_el in root.iter():
            if not tag_el.tag.endswith("}Tag") and tag_el.tag != "Tag":
                continue
            k = next((c.text for c in tag_el if c.tag.endswith("Key")), None)
            v = next((c.text for c in tag_el if c.tag.endswith("Value")), "")
            if k:
                tags[k] = v or ""
        ext = entry.setdefault("extended", {})
        for k in [k for k in ext if k.startswith(TAG_PREFIX)]:
            del ext[k]
        for k, v in tags.items():
            ext[f"{TAG_PREFIX}{k}"] = v
        self.fc.put_entry(path, entry)
        return Response(b"", 200)

    def _delete_tagging(self, path: str) -> Response:
        entry = self.fc.get_entry(path)
        if entry is None:
            raise err("NoSuchKey", path)
        ext = entry.get("extended") or {}
        entry["extended"] = {
            k: v for k, v in ext.items() if not k.startswith(TAG_PREFIX)
        }
        self.fc.put_entry(path, entry)
        return Response(b"", 204)
