"""S3 ACL grant model: canned ACLs, grant headers, AccessControlPolicy
XML, for buckets and objects.

Reference: `weed/s3api/s3api_acl_helper.go:33-93` (grant-header and canned
parsing/validation, grantee types id/uri/emailAddress, group URIs) and
`s3api_bucket_handlers.go` / `s3api_object_handlers_acl.go` surface. ACPs
persist as extended attributes on the bucket/object entries — the same
place the reference keeps them (entry.Extended). Access ENFORCEMENT in
this rebuild rides the identity/policy engine (auth.py + policy.py); the
ACL model is the stored, validated, served representation S3 clients
expect.

The port's copy of `seaweedfs_tpu/s3api/acl.py`.
"""

from __future__ import annotations

import json
import re
from xml.sax.saxutils import escape

from .auth import err

GROUP_ALL_USERS = "http://acs.amazonaws.com/groups/global/AllUsers"
GROUP_AUTH_USERS = "http://acs.amazonaws.com/groups/global/AuthenticatedUsers"
GROUP_LOG_DELIVERY = "http://acs.amazonaws.com/groups/s3/LogDelivery"
_GROUPS = {GROUP_ALL_USERS, GROUP_AUTH_USERS, GROUP_LOG_DELIVERY}

PERMISSIONS = ("READ", "WRITE", "READ_ACP", "WRITE_ACP", "FULL_CONTROL")

# header -> permission (`s3api_acl_helper.go` Grant* header walk)
GRANT_HEADERS = {
    "x-amz-grant-read": "READ",
    "x-amz-grant-write": "WRITE",
    "x-amz-grant-read-acp": "READ_ACP",
    "x-amz-grant-write-acp": "WRITE_ACP",
    "x-amz-grant-full-control": "FULL_CONTROL",
}

CANNED_ACLS = {
    "private", "public-read", "public-read-write", "authenticated-read",
    "bucket-owner-read", "bucket-owner-full-control", "log-delivery-write",
    "aws-exec-read",
}

_GRANTEE_KV = re.compile(r'\s*(id|uri|emailAddress)\s*=\s*"([^"]*)"\s*$')
_EMAIL = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")


def _grant(gtype: str, value: str, perm: str) -> dict:
    return {"type": gtype, "value": value, "perm": perm}


def parse_grantee(token: str) -> tuple[str, str]:
    """One grantee from a grant header: id="...", uri="..." or
    emailAddress="..." — anything else is InvalidArgument, as is an
    unknown group URI or a malformed email."""
    m = _GRANTEE_KV.match(token)
    if m is None:
        raise err("InvalidArgument", f"invalid grantee {token!r}")
    kind, value = m.group(1), m.group(2)
    if not value:
        raise err("InvalidArgument", f"empty grantee in {token!r}")
    if kind == "uri":
        if value not in _GROUPS:
            raise err("InvalidArgument", f"unknown grantee group {value!r}")
        return "Group", value
    if kind == "emailAddress":
        if not _EMAIL.match(value):
            raise err("InvalidArgument", f"invalid email grantee {value!r}")
        return "AmazonCustomerByEmail", value
    return "CanonicalUser", value


def grants_from_headers(headers: dict) -> list[dict]:
    """Parse every x-amz-grant-* header (comma-separated grantee lists)."""
    grants: list[dict] = []
    for header, perm in GRANT_HEADERS.items():
        raw = headers.get(header, "")
        if not raw:
            continue
        for token in raw.split(","):
            if not token.strip():
                raise err("InvalidArgument",
                          f"empty grantee in {header}: {raw!r}")
            gtype, value = parse_grantee(token)
            grants.append(_grant(gtype, value, perm))
    return grants


def grants_from_canned(acl: str, owner_id: str,
                       bucket_owner_id: str = "") -> list[dict]:
    """Expand a canned x-amz-acl into explicit grants
    (`s3api_acl_helper.go` canned table)."""
    if acl not in CANNED_ACLS:
        raise err("InvalidArgument", f"invalid canned acl {acl!r}")
    grants = [_grant("CanonicalUser", owner_id, "FULL_CONTROL")]
    if acl == "public-read":
        grants.append(_grant("Group", GROUP_ALL_USERS, "READ"))
    elif acl == "public-read-write":
        grants.append(_grant("Group", GROUP_ALL_USERS, "READ"))
        grants.append(_grant("Group", GROUP_ALL_USERS, "WRITE"))
    elif acl == "authenticated-read":
        grants.append(_grant("Group", GROUP_AUTH_USERS, "READ"))
    elif acl == "aws-exec-read":
        pass  # EC2 service grantee has no analog here; owner-only
    elif acl == "bucket-owner-read" and bucket_owner_id:
        grants.append(_grant("CanonicalUser", bucket_owner_id, "READ"))
    elif acl == "bucket-owner-full-control" and bucket_owner_id:
        grants.append(
            _grant("CanonicalUser", bucket_owner_id, "FULL_CONTROL"))
    elif acl == "log-delivery-write":
        grants.append(_grant("Group", GROUP_LOG_DELIVERY, "WRITE"))
        grants.append(_grant("Group", GROUP_LOG_DELIVERY, "READ_ACP"))
    return grants


def extract_acl(headers: dict, owner_id: str,
                bucket_owner_id: str = "") -> list[dict] | None:
    """The request's ACL intent from headers, or None when no ACL headers
    are present. Canned + explicit grant headers together are rejected,
    as on AWS (InvalidRequest)."""
    canned = headers.get("x-amz-acl", "")
    grant_present = any(headers.get(h) for h in GRANT_HEADERS)
    if canned and grant_present:
        raise err("InvalidRequest",
                  "Specifying both Canned ACLs and Header Grants is"
                  " not allowed")
    if canned:
        return grants_from_canned(canned, owner_id, bucket_owner_id)
    if grant_present:
        return grants_from_headers(headers)
    return None


def acp_to_xml_inner(owner_id: str, grants: list[dict]) -> str:
    parts = [f"<Owner><ID>{escape(owner_id)}</ID></Owner>",
             "<AccessControlList>"]
    for g in grants:
        if g["type"] == "Group":
            grantee = (f'<Grantee xmlns:xsi="http://www.w3.org/2001/'
                       f'XMLSchema-instance" xsi:type="Group">'
                       f"<URI>{escape(g['value'])}</URI></Grantee>")
        elif g["type"] == "AmazonCustomerByEmail":
            grantee = (f'<Grantee xmlns:xsi="http://www.w3.org/2001/'
                       f'XMLSchema-instance" xsi:type="AmazonCustomerByEmail">'
                       f"<EmailAddress>{escape(g['value'])}</EmailAddress>"
                       f"</Grantee>")
        else:
            grantee = (f'<Grantee xmlns:xsi="http://www.w3.org/2001/'
                       f'XMLSchema-instance" xsi:type="CanonicalUser">'
                       f"<ID>{escape(g['value'])}</ID></Grantee>")
        parts.append(f"<Grant>{grantee}"
                     f"<Permission>{g['perm']}</Permission></Grant>")
    parts.append("</AccessControlList>")
    return "".join(parts)


def acp_from_xml(body: bytes) -> tuple[str, list[dict]]:
    """Parse a PUT ?acl AccessControlPolicy body -> (owner_id, grants)."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise err("MalformedACLError", str(e))
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]
    owner_id = root.findtext(f"{ns}Owner/{ns}ID", "")
    grants: list[dict] = []
    for g in root.findall(f"{ns}AccessControlList/{ns}Grant"):
        perm = g.findtext(f"{ns}Permission", "")
        if perm not in PERMISSIONS:
            raise err("MalformedACLError", f"bad permission {perm!r}")
        grantee = g.find(f"{ns}Grantee")
        if grantee is None:
            raise err("MalformedACLError", "grant without grantee")
        uri = grantee.findtext(f"{ns}URI")
        gid = grantee.findtext(f"{ns}ID")
        email = grantee.findtext(f"{ns}EmailAddress")
        if uri:
            if uri not in _GROUPS:
                raise err("InvalidArgument", f"unknown group {uri!r}")
            grants.append(_grant("Group", uri, perm))
        elif gid:
            grants.append(_grant("CanonicalUser", gid, perm))
        elif email:
            if not _EMAIL.match(email):
                raise err("InvalidArgument", f"invalid email {email!r}")
            grants.append(_grant("AmazonCustomerByEmail", email, perm))
        else:
            raise err("MalformedACLError", "grantee without ID/URI/Email")
    return owner_id, grants


def dumps(owner_id: str, grants: list[dict]) -> str:
    return json.dumps({"owner": owner_id, "grants": grants})


def loads(raw: str) -> tuple[str, list[dict]]:
    d = json.loads(raw)
    return d.get("owner", ""), d.get("grants", [])
