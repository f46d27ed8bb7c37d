"""IP whitelist guard (`weed/security/guard.go:42-50`).

White list entries may be exact IPs, CIDR networks, or the wildcard "*".
An empty white list admits everyone (same default as the reference).
The port's copy of `seaweedfs_tpu/security/guard.py`.
"""

from __future__ import annotations

import ipaddress


class Guard:
    def __init__(self, white_list: list[str] | None = None) -> None:
        self.white_list = list(white_list or [])
        self._nets = []
        self._ips = set()
        self._any = not self.white_list
        for item in self.white_list:
            if item == "*":
                self._any = True
            elif "/" in item:
                self._nets.append(ipaddress.ip_network(item, strict=False))
            else:
                self._ips.add(item)

    def is_allowed(self, remote_ip: str) -> bool:
        if self._any:
            return True
        if remote_ip in self._ips:
            return True
        try:
            addr = ipaddress.ip_address(remote_ip)
        except ValueError:
            return False
        return any(addr in net for net in self._nets)
