"""Cloud notification queues speaking the providers' REST protocols.

The reference wraps vendor SDKs (`weed/notification/aws_sqs/aws_sqs_pub.go`,
`google_pub_sub/google_pub_sub.go`); here the wire protocols are implemented
directly:

  - `SqsQueue`       — AWS SQS query protocol (GetQueueUrl + SendMessage)
    signed with SigV4 (service "sqs"), the `key` carried as a String
    message attribute and DelaySeconds=10, matching `aws_sqs_pub.go:74-95`.
  - `GooglePubSubQueue` — Pub/Sub REST `projects.topics.publish` with
    base64 payloads and the key as a message attribute, matching
    `google_pub_sub.go:60-88` (topic auto-create included).

Endpoints are overridable so contract tests drive the real client against
in-process fakes (`tests/test_torch_cloud_sinks.py`).

The port's copy of `seaweedfs_tpu/notification/cloud.py`, signed with the
port's `s3api/auth.py` and sent over the port's `http_request`.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse

from ..s3api.auth import (
    canonical_request,
    signing_key,
    string_to_sign,
)
from ..server.httpd import http_request

from . import NotificationQueue


class SqsQueue(NotificationQueue):
    kind = "aws_sqs"

    def __init__(
        self,
        access_key: str,
        secret_key: str,
        region: str,
        queue_name: str,
        endpoint: str | None = None,
    ) -> None:
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.endpoint = (
            endpoint or f"https://sqs.{region}.amazonaws.com"
        ).rstrip("/")
        self.queue_url = self._get_queue_url(queue_name)

    def _signed_post(self, url: str, form: dict[str, str]) -> bytes:
        body = urllib.parse.urlencode(form).encode()
        parsed = urllib.parse.urlparse(url)
        now = time.gmtime()
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
        date = time.strftime("%Y%m%d", now)
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = {
            "host": parsed.netloc,
            "x-amz-date": amz_date,
            "content-type": "application/x-www-form-urlencoded",
        }
        signed = sorted(headers)
        canon = canonical_request(
            "POST", parsed.path or "/", [], headers, signed, payload_hash
        )
        scope = f"{date}/{self.region}/sqs/aws4_request"
        sig = hmac.new(
            signing_key(self.secret_key, date, self.region, "sqs"),
            string_to_sign(amz_date, scope, canon).encode(),
            hashlib.sha256,
        ).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"
        )
        headers["x-amz-content-sha256"] = payload_hash
        status, _, resp = http_request("POST", url, body, headers)
        if status >= 400:
            raise IOError(f"sqs {form.get('Action')} -> {status}: {resp[:200]!r}")
        return resp

    def _get_queue_url(self, queue_name: str) -> str:
        resp = self._signed_post(
            self.endpoint + "/",
            {"Action": "GetQueueUrl", "QueueName": queue_name,
             "Version": "2012-11-05"},
        )
        # <GetQueueUrlResponse><GetQueueUrlResult><QueueUrl>...</QueueUrl>
        import xml.etree.ElementTree as ET

        root = ET.fromstring(resp)
        for el in root.iter():
            if el.tag.endswith("QueueUrl") and el.text:
                return el.text
        raise IOError(f"queue {queue_name} not found")

    def send_message(self, key: str, message: dict) -> None:
        self._signed_post(
            self.queue_url,
            {
                "Action": "SendMessage",
                "Version": "2012-11-05",
                "MessageBody": json.dumps(message),
                "DelaySeconds": "10",
                "MessageAttribute.1.Name": "key",
                "MessageAttribute.1.Value.DataType": "String",
                "MessageAttribute.1.Value.StringValue": key,
            },
        )


class GooglePubSubQueue(NotificationQueue):
    kind = "google_pub_sub"

    def __init__(
        self,
        project: str,
        topic: str,
        token_provider=None,
        endpoint: str = "https://pubsub.googleapis.com",
    ) -> None:
        self.project = project
        self.topic = topic
        if token_provider is None and "googleapis.com" in endpoint:
            raise ValueError(
                "google_pub_sub against the real endpoint needs credentials "
                "(google_application_credentials or token_provider)"
            )
        self.token = token_provider or (lambda: "")
        self.endpoint = endpoint.rstrip("/")
        self._ensure_topic()

    def _headers(self) -> dict[str, str]:
        h = {"Content-Type": "application/json"}
        tok = self.token()
        if tok:
            h["Authorization"] = f"Bearer {tok}"
        return h

    def _topic_path(self) -> str:
        return f"projects/{self.project}/topics/{self.topic}"

    def _ensure_topic(self) -> None:
        """google_pub_sub.go:45-55 creates the topic when it is absent.
        Anything other than found/absent (401/403/5xx) fails construction:
        a misconfigured queue must not pass startup and then drop events."""
        url = f"{self.endpoint}/v1/{self._topic_path()}"
        status, _, body = http_request("GET", url, None, self._headers())
        if status == 404:
            status, _, body = http_request("PUT", url, b"{}", self._headers())
            if status >= 400 and status != 409:
                raise IOError(f"pubsub create topic -> {status}: {body[:200]!r}")
        elif status >= 400:
            raise IOError(f"pubsub topic check -> {status}: {body[:200]!r}")

    def send_message(self, key: str, message: dict) -> None:
        payload = json.dumps(
            {
                "messages": [
                    {
                        "data": base64.b64encode(
                            json.dumps(message).encode()
                        ).decode(),
                        "attributes": {"key": key},
                    }
                ]
            }
        ).encode()
        url = f"{self.endpoint}/v1/{self._topic_path()}:publish"
        status, _, body = http_request("POST", url, payload, self._headers())
        if status >= 400:
            raise IOError(f"pubsub publish -> {status}: {body[:200]!r}")
