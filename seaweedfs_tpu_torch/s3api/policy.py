"""AWS bucket-policy evaluation for the S3 gateway.

The reference gateway stubs the bucket-policy REST handlers with 501s
(`weed/s3api/s3api_bucket_skip_handlers.go:27-39`) and scopes access purely
through per-identity IAM actions (`auth_credentials.go`). This module
implements the AWS evaluation model those APIs define so bucket owners can
grant or deny access across identities — including anonymous principals —
with standard policy documents:

* explicit Deny beats everything;
* otherwise access is allowed if EITHER the caller's IAM grants permit the
  action OR a policy statement allows it;
* statements match on Principal (name or wildcard), Action (s3:* patterns,
  case-insensitive like AWS), and Resource (arn:aws:s3:::bucket[/key]).

Condition blocks are not supported and are rejected at PutBucketPolicy time
rather than silently ignored — a policy that appears stricter than it is
would be a security hole.

The port's copy of `seaweedfs_tpu/s3api/policy.py`.
"""

from __future__ import annotations

import json
import re

ALLOW = "allow"
DENY = "deny"

_ARN_PREFIX = "arn:aws:s3:::"


def _as_list(x) -> list:
    if x is None:
        return []
    return x if isinstance(x, list) else [x]


def _wild_match(pattern: str, value: str, ci: bool = False) -> bool:
    """AWS-style wildcard match: '*' any run, '?' one char; no [] classes."""
    if ci:
        pattern, value = pattern.lower(), value.lower()
    rx = "".join(
        ".*" if c == "*" else "." if c == "?" else re.escape(c)
        for c in pattern
    )
    return re.fullmatch(rx, value) is not None


def _principals(stmt: dict) -> list[str]:
    p = stmt.get("Principal")
    if p == "*":
        return ["*"]
    if isinstance(p, dict):
        return [str(a) for a in _as_list(p.get("AWS"))]
    return []


def _stmt_matches(stmt: dict, principal: str, action: str, resource: str) -> bool:
    principals = _principals(stmt)
    if not any(a == "*" or _wild_match(a, principal) for a in principals):
        return False
    if not any(
        _wild_match(a, action, ci=True) for a in _as_list(stmt.get("Action"))
    ):
        return False
    return any(
        _wild_match(r, resource) for r in _as_list(stmt.get("Resource"))
    )


def evaluate(doc: dict, principal: str, action: str, resource: str) -> str | None:
    """Returns DENY on any matching Deny statement, else ALLOW on any
    matching Allow statement, else None (no opinion — IAM decides)."""
    decision = None
    for stmt in _as_list(doc.get("Statement")):
        if not isinstance(stmt, dict):
            continue
        if not _stmt_matches(stmt, principal, action, resource):
            continue
        if stmt.get("Effect") == "Deny":
            return DENY
        if stmt.get("Effect") == "Allow":
            decision = ALLOW
    return decision


def validate(payload: bytes, bucket: str) -> dict:
    """Parse + validate a policy document for PutBucketPolicy; raises
    ValueError with a caller-facing message. Every Resource must target the
    policy's own bucket (AWS rejects cross-bucket resources the same way)."""
    try:
        doc = json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        raise ValueError("policy is not valid JSON")
    if not isinstance(doc, dict):
        raise ValueError("policy must be a JSON object")
    if doc.get("Version") not in ("2012-10-17", "2008-10-17"):
        raise ValueError("unsupported policy Version")
    stmts = _as_list(doc.get("Statement"))
    if not stmts:
        raise ValueError("policy has no Statement")
    for stmt in stmts:
        if not isinstance(stmt, dict):
            raise ValueError("Statement must be an object")
        if stmt.get("Effect") not in ("Allow", "Deny"):
            raise ValueError("Statement Effect must be Allow or Deny")
        if "NotPrincipal" in stmt or "NotAction" in stmt or "NotResource" in stmt:
            raise ValueError("NotPrincipal/NotAction/NotResource unsupported")
        if "Condition" in stmt:
            raise ValueError("Condition blocks are not supported")
        if not _principals(stmt):
            raise ValueError("Statement needs Principal ('*' or {'AWS': ...})")
        actions = _as_list(stmt.get("Action"))
        if not actions or not all(
            isinstance(a, str) and a.lower().startswith("s3:") for a in actions
        ):
            raise ValueError("Action entries must be 's3:...' strings")
        resources = _as_list(stmt.get("Resource"))
        if not resources:
            raise ValueError("Statement needs Resource")
        for r in resources:
            if not isinstance(r, str) or not r.startswith(_ARN_PREFIX):
                raise ValueError(f"Resource must start with {_ARN_PREFIX}")
            target = r[len(_ARN_PREFIX):]
            if not (
                target == bucket or target.startswith(bucket + "/")
            ):
                raise ValueError(
                    f"Resource {r} does not target bucket {bucket}"
                )
    return doc


def arn(bucket: str, key: str = "") -> str:
    return f"{_ARN_PREFIX}{bucket}/{key}" if key else f"{_ARN_PREFIX}{bucket}"


# --- POST form policies (browser uploads) ----------------------------------
# Reference: `weed/s3api/policy/post-policy.go`, `postpolicyform.go`,
# `s3api_object_handlers_postpolicy.go`. The policy document is the base64
# form field the client signs; every other form field (bar the exempt set)
# must be covered by a condition, and conditions must all hold.

_POST_EXEMPT = {
    "file", "policy", "x-amz-signature", "success_action_status",
    "x-amz-algorithm", "x-amz-credential", "x-amz-date",
    # Signature V2 POST-policy auth fields (auth_signature_v2.go)
    "awsaccesskeyid", "signature",
}


def check_post_policy(doc: dict, fields: dict, file_size: int) -> None:
    """Raises ValueError when the form violates its signed policy."""
    import calendar as _calendar
    import time as _time

    exp = doc.get("expiration")
    if not exp:
        raise ValueError("policy missing expiration")
    try:
        expires = _calendar.timegm(
            _time.strptime(exp.split(".")[0].rstrip("Z"), "%Y-%m-%dT%H:%M:%S")
        )
    except ValueError:
        raise ValueError(f"bad expiration {exp!r}")
    if expires < _time.time():
        raise ValueError("policy has expired")

    fields_ci = {k.lower(): v for k, v in fields.items()}
    covered: set[str] = set()

    def field_value(name: str) -> str:
        return fields_ci.get(name.lower(), "")

    for cond in _as_list(doc.get("conditions")):
        if isinstance(cond, dict):
            items = [["eq", f"${k}", v] for k, v in cond.items()]
        elif isinstance(cond, list) and len(cond) == 3:
            items = [cond]
        else:
            raise ValueError(f"bad condition {cond!r}")
        for op, name, want in items:
            op = str(op).lower()
            if op == "content-length-range":
                lo, hi = int(name), int(want)
                if not lo <= file_size <= hi:
                    raise ValueError(
                        f"file size {file_size} outside [{lo}, {hi}]"
                    )
                continue
            key = str(name).lstrip("$").lower()
            covered.add(key)
            have = field_value(key)
            if op == "eq":
                if have != str(want):
                    raise ValueError(f"condition eq ${key} failed")
            elif op == "starts-with":
                if not have.startswith(str(want)):
                    raise ValueError(f"condition starts-with ${key} failed")
            else:
                raise ValueError(f"unsupported condition op {op!r}")

    for name in fields_ci:
        if name in _POST_EXEMPT or name.startswith("x-ignore-"):
            continue
        if name not in covered:
            raise ValueError(f"form field {name!r} not covered by policy")
