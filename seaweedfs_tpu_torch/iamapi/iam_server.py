"""AWS IAM-compatible REST API managing S3 identities.

Form-encoded `Action=` requests (CreateUser, ListUsers, CreateAccessKey,
PutUserPolicy, ...) with IAM XML responses. Identities persist into the
filer at `/etc/iam/identity.json` — the same file the S3 gateway watches
via the metadata subscription, so changes apply live.

Reference: `weed/iamapi/iamapi_server.go:24`,
`iamapi_management_handlers.go` (action dispatch + policy→action mapping).

The port's copy of `seaweedfs_tpu/iamapi/iam_server.py`, over the port's
`filer/filer_client.py`, `s3api/auth.py` and `server/httpd.py`. The
service is metered as role "iam" (no `/metrics` route, as in the JAX
server); `slow_ms` sets the role's slow-span threshold.
"""

from __future__ import annotations

import json
import secrets
import threading
import urllib.parse
import uuid
from xml.sax.saxutils import escape

from ..filer.filer_client import FilerClient
from ..s3api.auth import (
    ACTION_ADMIN,
    ACTION_LIST,
    ACTION_READ,
    ACTION_TAGGING,
    ACTION_WRITE,
    IdentityAccessManagement,
    S3ApiError,
)
from ..server.httpd import HTTPService, Request, Response
from ..stats import trace

IAM_XMLNS = "https://iam.amazonaws.com/doc/2010-05-08/"
IDENTITY_PATH = "/etc/iam/identity.json"
POLICIES_PATH = "/etc/iam/policies.json"


def iam_response(action: str, inner: str, status: int = 200) -> Response:
    body = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<{action}Response xmlns="{IAM_XMLNS}">'
        f"<{action}Result>{inner}</{action}Result>"
        f"<ResponseMetadata><RequestId>{uuid.uuid4()}</RequestId>"
        f"</ResponseMetadata></{action}Response>"
    ).encode()
    return Response(body, status, {"Content-Type": "text/xml"})


def iam_error(code: str, message: str, status: int = 400) -> Response:
    body = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<ErrorResponse xmlns="{IAM_XMLNS}"><Error>'
        f"<Code>{code}</Code><Message>{escape(message)}</Message>"
        f"</Error></ErrorResponse>"
    ).encode()
    return Response(body, status, {"Content-Type": "text/xml"})


def policy_to_actions(policy_doc: dict) -> list[str]:
    """Map an IAM policy document's s3 statements onto identity actions
    (`iamapi_management_handlers.go` GetActions)."""
    out: list[str] = []
    statements = policy_doc.get("Statement", [])
    if isinstance(statements, dict):
        statements = [statements]
    for st in statements:
        if st.get("Effect") != "Allow":
            continue
        actions = st.get("Action", [])
        if isinstance(actions, str):
            actions = [actions]
        resources = st.get("Resource", [])
        if isinstance(resources, str):
            resources = [resources]
        buckets: list[str] = []
        for res in resources:
            if not res.startswith("arn:aws:s3:::"):
                continue
            tail = res[len("arn:aws:s3:::"):]
            if tail in ("*", ""):
                buckets.append("")
            else:
                bucket = tail.split("/", 1)[0]
                buckets.append(bucket.rstrip("*"))
        if not buckets:
            buckets = [""]
        for act in actions:
            act = act.lower()
            mapped: list[str] = []
            if act in ("s3:*", "*"):
                mapped = [ACTION_ADMIN]
            elif "tagging" in act:
                mapped = [ACTION_TAGGING]
            elif act.startswith("s3:get") or act.startswith("s3:head"):
                mapped = [ACTION_READ]
            elif act.startswith("s3:put") or act.startswith(
                "s3:delete"
            ) or act.startswith("s3:abort") or act.startswith("s3:create"):
                mapped = [ACTION_WRITE]
            elif act.startswith("s3:list"):
                mapped = [ACTION_LIST]
            for m in mapped:
                for b in buckets:
                    entry = f"{m}:{b}" if b and m != ACTION_ADMIN else m
                    if entry not in out:
                        out.append(entry)
    return out


class IamServer:
    def __init__(
        self,
        filer_url: str,
        host: str = "127.0.0.1",
        port: int = 8111,
        slow_ms: float | None = None,
    ) -> None:
        self.fc = FilerClient(filer_url)
        self.service = HTTPService(host, port)
        self.service.enable_metrics("iam", serve_route=False)
        if slow_ms is not None:  # -slowMs: the role's slow-span threshold
            trace.set_slow_threshold_ms(slow_ms, role="iam")
        # serializes read-modify-write of identity.json across the threaded
        # HTTP server — without it concurrent mutations lose updates
        self._mutate_lock = threading.Lock()
        self._routes()

    def start(self) -> None:
        self.service.start()

    def stop(self) -> None:
        self.service.stop()
        self.fc.close()

    @property
    def url(self) -> str:
        return self.service.url

    # --- persistence ------------------------------------------------------------
    def _load_config(self) -> dict:
        status, _, body = self.fc.get(IDENTITY_PATH)
        if status == 200 and body:
            return json.loads(body)
        return {"identities": []}

    def _save_config(self, config: dict) -> None:
        self.fc.put(
            IDENTITY_PATH,
            json.dumps(config, indent=2).encode(),
            "application/json",
        )

    def _load_policies(self) -> dict:
        status, _, body = self.fc.get(POLICIES_PATH)
        if status == 200 and body:
            return json.loads(body)
        return {"policies": {}}

    def _save_policies(self, policies: dict) -> None:
        self.fc.put(
            POLICIES_PATH,
            json.dumps(policies, indent=2).encode(),
            "application/json",
        )

    @staticmethod
    def _find_user(config: dict, name: str) -> dict | None:
        for ident in config.get("identities", []):
            if ident.get("name") == name:
                return ident
        return None

    # --- request handling -------------------------------------------------------
    def _routes(self) -> None:
        @self.service.route("POST", r"/")
        def handle(req: Request) -> Response:
            return self._handle(req)

    def _authorize(self, req: Request, config: dict) -> Response | None:
        """IAM requests must be signed by an Admin identity. Bootstrap mode:
        until some identity holds BOTH the Admin action and credentials,
        requests are open so the first admin can self-provision."""
        iam = IdentityAccessManagement()
        iam.load_config(config)
        has_admin = any(
            ACTION_ADMIN in i.actions and i.credentials for i in iam.identities
        )
        if not has_admin:
            return None
        try:
            parsed = urllib.parse.urlparse(req.handler.path)
            pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
            ident = iam.authenticate(
                req.method, parsed.path, pairs, dict(req.headers), req.body
            )
        except S3ApiError as e:
            return iam_error(e.code, e.message, e.status)
        if not ident.can_do(ACTION_ADMIN):
            return iam_error("AccessDenied", "IAM requires Admin", 403)
        return None

    def _handle(self, req: Request) -> Response:
        params = dict(urllib.parse.parse_qsl(req.body.decode("utf-8", "replace")))
        action = params.get("Action", "")
        fn = getattr(self, f"_do_{action}", None)
        with self._mutate_lock:
            config = self._load_config()
            denied = self._authorize(req, config)
            if denied is not None:
                return denied
            if fn is None:
                return iam_error("NotImplemented", f"Action {action!r}", 501)
            try:
                return fn(params, config)
            except S3ApiError as e:
                return iam_error(e.code, e.message, e.status)
            except json.JSONDecodeError as e:
                return iam_error("MalformedPolicyDocument", str(e), 400)
            except KeyError as e:
                return iam_error("MissingParameter", str(e), 400)

    # --- user actions -----------------------------------------------------------
    def _do_CreateUser(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        if self._find_user(config, name) is not None:
            return iam_error("EntityAlreadyExists", f"user {name} exists", 409)
        config.setdefault("identities", []).append(
            {"name": name, "credentials": [], "actions": []}
        )
        self._save_config(config)
        return iam_response(
            "CreateUser",
            f"<User><UserName>{escape(name)}</UserName>"
            f"<UserId>{uuid.uuid4().hex[:16]}</UserId>"
            f"<Arn>arn:aws:iam:::user/{escape(name)}</Arn></User>",
        )

    def _do_GetUser(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        if self._find_user(config, name) is None:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        return iam_response(
            "GetUser",
            f"<User><UserName>{escape(name)}</UserName>"
            f"<Arn>arn:aws:iam:::user/{escape(name)}</Arn></User>",
        )

    def _do_ListUsers(self, params: dict, config: dict) -> Response:
        users = "".join(
            f"<member><UserName>{escape(i['name'])}</UserName>"
            f"<Arn>arn:aws:iam:::user/{escape(i['name'])}</Arn></member>"
            for i in config.get("identities", [])
        )
        return iam_response(
            "ListUsers", f"<Users>{users}</Users><IsTruncated>false</IsTruncated>"
        )

    def _do_DeleteUser(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        before = len(config.get("identities", []))
        config["identities"] = [
            i for i in config.get("identities", []) if i.get("name") != name
        ]
        if len(config["identities"]) == before:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        self._save_config(config)
        return iam_response("DeleteUser", "")

    def _do_UpdateUser(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        new_name = params.get("NewUserName", "")
        user = self._find_user(config, name)
        if user is None:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        if new_name:
            if self._find_user(config, new_name) is not None:
                return iam_error(
                    "EntityAlreadyExists", f"user {new_name} exists", 409
                )
            user["name"] = new_name
        self._save_config(config)
        return iam_response("UpdateUser", "")

    # --- access keys ------------------------------------------------------------
    def _do_CreateAccessKey(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        user = self._find_user(config, name)
        if user is None:
            # AWS auto-creates on CreateAccessKey for the calling user; the
            # reference creates the identity implicitly too
            user = {"name": name, "credentials": [], "actions": []}
            config.setdefault("identities", []).append(user)
        access_key = "AKID" + secrets.token_hex(8).upper()
        secret_key = secrets.token_urlsafe(30)
        user.setdefault("credentials", []).append(
            {"accessKey": access_key, "secretKey": secret_key}
        )
        self._save_config(config)
        return iam_response(
            "CreateAccessKey",
            "<AccessKey>"
            f"<UserName>{escape(name)}</UserName>"
            f"<AccessKeyId>{access_key}</AccessKeyId>"
            f"<SecretAccessKey>{secret_key}</SecretAccessKey>"
            "<Status>Active</Status></AccessKey>",
        )

    def _do_DeleteAccessKey(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        key_id = params["AccessKeyId"]
        user = self._find_user(config, name)
        if user is None:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        before = len(user.get("credentials", []))
        user["credentials"] = [
            c for c in user.get("credentials", []) if c.get("accessKey") != key_id
        ]
        if len(user["credentials"]) == before:
            return iam_error("NoSuchEntity", f"key {key_id} not found", 404)
        self._save_config(config)
        return iam_response("DeleteAccessKey", "")

    def _do_ListAccessKeys(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        user = self._find_user(config, name)
        if user is None:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        members = "".join(
            "<member>"
            f"<UserName>{escape(name)}</UserName>"
            f"<AccessKeyId>{c['accessKey']}</AccessKeyId>"
            "<Status>Active</Status></member>"
            for c in user.get("credentials", [])
        )
        return iam_response(
            "ListAccessKeys",
            f"<AccessKeyMetadata>{members}</AccessKeyMetadata>"
            "<IsTruncated>false</IsTruncated>",
        )

    # --- policies ---------------------------------------------------------------
    def _do_CreatePolicy(self, params: dict, config: dict) -> Response:
        name = params["PolicyName"]
        doc = json.loads(params["PolicyDocument"])
        policies = self._load_policies()
        policies.setdefault("policies", {})[name] = doc
        self._save_policies(policies)
        return iam_response(
            "CreatePolicy",
            f"<Policy><PolicyName>{escape(name)}</PolicyName>"
            f"<PolicyId>{uuid.uuid4().hex[:16]}</PolicyId>"
            f"<Arn>arn:aws:iam:::policy/{escape(name)}</Arn></Policy>",
        )

    def _do_PutUserPolicy(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        doc = json.loads(params["PolicyDocument"])
        config = self._load_config()
        user = self._find_user(config, name)
        if user is None:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        user["actions"] = policy_to_actions(doc)
        self._save_config(config)
        return iam_response("PutUserPolicy", "")

    def _do_GetUserPolicy(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        user = self._find_user(config, name)
        if user is None:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        # reconstruct a policy document from the stored actions
        statements = [
            {
                "Effect": "Allow",
                "Action": [f"s3:{a.split(':')[0]}*"],
                "Resource": [
                    "arn:aws:s3:::" + (a.split(":", 1)[1] + "/*" if ":" in a else "*")
                ],
            }
            for a in user.get("actions", [])
        ]
        doc = json.dumps({"Version": "2012-10-17", "Statement": statements})
        return iam_response(
            "GetUserPolicy",
            f"<UserName>{escape(name)}</UserName>"
            f"<PolicyName>{escape(params.get('PolicyName', 'default'))}</PolicyName>"
            f"<PolicyDocument>{escape(doc)}</PolicyDocument>",
        )

    def _do_DeleteUserPolicy(self, params: dict, config: dict) -> Response:
        name = params["UserName"]
        user = self._find_user(config, name)
        if user is None:
            return iam_error("NoSuchEntity", f"user {name} not found", 404)
        user["actions"] = []
        self._save_config(config)
        return iam_response("DeleteUserPolicy", "")
