"""FTP gateway over the filer.

The reference ships only an unwired ftpserverlib skeleton
(`weed/ftpd/ftp_server.go`, 81 LoC). This build wires a working minimal
FTP server (passive mode, binary type) straight onto the filer: USER/PASS
(accept-all or fixed credentials), PWD/CWD/CDUP, PASV, LIST/NLST, RETR,
STOR, DELE, MKD/RMD, SIZE, QUIT — enough for stock clients (tested with
stdlib ftplib).

The port's copy of `seaweedfs_tpu/ftpd/__init__.py`, over the port's
`FilerClient` (and so a port filer, whose device hashes every chunk).
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time

from ..filer.filer_client import FilerClient


class FtpServer:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 2121, user: str = "", password: str = "",
                 anonymous: bool = False) -> None:
        """With no user/password configured the gateway REFUSES logins unless
        `anonymous=True` is passed explicitly — an unconfigured server must
        not silently expose the whole filer namespace read-write (advisor r1
        finding #5)."""
        self.filer_url = filer_url
        self.host = host
        self.user = user
        self.password = password
        self.anonymous = anonymous
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                fc = FilerClient(outer.filer_url)
                try:
                    outer._session(self, fc)
                finally:
                    fc.close()  # the session's keep-alive filer connections

        self._server = socketserver.ThreadingTCPServer(
            (host, port), Handler, bind_and_activate=False
        )
        self._server.allow_reuse_address = True
        self._server.daemon_threads = True
        self._server.server_bind()
        self._server.server_activate()
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # --- one control session ---------------------------------------------------
    def _session(self, h: socketserver.StreamRequestHandler,
                 fc: FilerClient) -> None:
        cwd = "/"
        authed_user = ""
        logged_in = False
        data_listener: socket.socket | None = None

        def send(line: str) -> None:
            h.wfile.write((line + "\r\n").encode())

        def resolve(arg: str) -> str:
            """Absolute/relative resolution with '.'/'..' canonicalization so
            no un-normalized dot segments ever reach the filer."""
            if not arg or arg == ".":
                return cwd
            if arg.startswith("/"):
                path = arg
            else:
                path = cwd.rstrip("/") + "/" + arg
            parts: list[str] = []
            for seg in path.split("/"):
                if seg in ("", "."):
                    continue
                if seg == "..":
                    if parts:
                        parts.pop()
                    continue
                parts.append(seg)
            return "/" + "/".join(parts) if parts else "/"

        def open_data() -> socket.socket | None:
            nonlocal data_listener
            if data_listener is None:
                return None
            conn, _ = data_listener.accept()
            data_listener.close()
            data_listener = None
            return conn

        send("220 seaweedfs-tpu FTP ready")
        while True:
            raw = h.rfile.readline()
            if not raw:
                break
            line = raw.decode("utf-8", "replace").strip()
            cmd, _, arg = line.partition(" ")
            cmd = cmd.upper()
            try:
                if cmd == "USER":
                    authed_user = arg
                    send("331 password please")
                elif cmd == "PASS":
                    if self.user:
                        ok = authed_user == self.user and arg == self.password
                    else:
                        ok = self.anonymous  # accept-all needs explicit opt-in
                    if ok:
                        logged_in = True
                        send("230 logged in")
                    else:
                        send("530 login incorrect")
                elif cmd in ("SYST",):
                    send("215 UNIX Type: L8")
                elif cmd == "FEAT":
                    send("211-Features:")
                    send(" SIZE")
                    send(" PASV")
                    send("211 End")
                elif cmd == "TYPE":
                    send("200 type set")
                elif cmd == "NOOP":
                    send("200 ok")
                elif not logged_in:
                    # every filesystem verb demands a completed login
                    send("530 please login with USER and PASS")
                elif cmd == "PWD":
                    send(f'257 "{cwd}"')
                elif cmd == "CWD":
                    target = resolve(arg)
                    e = fc.get_entry(target) if target != "/" else {
                        "is_directory": True}
                    if e and e.get("is_directory"):
                        cwd = target
                        send("250 cwd ok")
                    else:
                        send("550 no such directory")
                elif cmd == "CDUP":
                    cwd = cwd.rsplit("/", 1)[0] or "/"
                    send("250 cwd ok")
                elif cmd == "PASV":
                    if data_listener is not None:
                        data_listener.close()
                    data_listener = socket.socket()
                    data_listener.bind((self.host, 0))
                    data_listener.listen(1)
                    p = data_listener.getsockname()[1]
                    hbytes = self.host.split(".")
                    send(
                        "227 Entering Passive Mode "
                        f"({','.join(hbytes)},{p >> 8},{p & 255})"
                    )
                elif cmd in ("LIST", "NLST"):
                    conn = open_data()
                    if conn is None:
                        send("425 use PASV first")
                        continue
                    send("150 here comes the directory listing")
                    target = resolve(arg) if arg and not arg.startswith("-") \
                        else cwd
                    listing = fc.list(target, limit=10000)
                    lines = []
                    for e in listing.get("Entries") or []:
                        name = e["FullPath"].rsplit("/", 1)[-1]
                        if cmd == "NLST":
                            lines.append(name)
                            continue
                        kind = "d" if e["IsDirectory"] else "-"
                        size = e.get("FileSize", 0)
                        mtime = time.strftime(
                            "%b %d %H:%M", time.localtime(e.get("Mtime", 0))
                        )
                        lines.append(
                            f"{kind}rw-r--r-- 1 weed weed {size:>12} "
                            f"{mtime} {name}"
                        )
                    conn.sendall(("\r\n".join(lines) + "\r\n").encode())
                    conn.close()
                    send("226 directory send ok")
                elif cmd == "SIZE":
                    e = fc.get_entry(resolve(arg))
                    if e is None or e.get("is_directory"):
                        send("550 no such file")
                    else:
                        send(f"213 {(e.get('attributes') or {}).get('file_size', 0)}")
                elif cmd == "RETR":
                    conn = open_data()
                    if conn is None:
                        send("425 use PASV first")
                        continue
                    try:
                        data = fc.read(resolve(arg))
                    except OSError:
                        conn.close()
                        send("550 no such file")
                        continue
                    send("150 opening data connection")
                    conn.sendall(data)
                    conn.close()
                    send("226 transfer complete")
                elif cmd == "STOR":
                    conn = open_data()
                    if conn is None:
                        send("425 use PASV first")
                        continue
                    send("150 ok to send data")
                    buf = bytearray()
                    while True:
                        piece = conn.recv(1 << 16)
                        if not piece:
                            break
                        buf.extend(piece)
                    conn.close()
                    fc.put(resolve(arg), bytes(buf))
                    send("226 transfer complete")
                elif cmd == "DELE":
                    if fc.delete(resolve(arg)):
                        send("250 deleted")
                    else:
                        send("550 delete failed")
                elif cmd == "MKD":
                    fc.mkdir(resolve(arg))
                    send(f'257 "{resolve(arg)}" created')
                elif cmd == "RMD":
                    if fc.delete(resolve(arg), recursive=True):
                        send("250 removed")
                    else:
                        send("550 remove failed")
                elif cmd == "QUIT":
                    send("221 bye")
                    break
                else:
                    send(f"502 {cmd} not implemented")
            except Exception as e:  # keep the session alive on errors
                try:
                    send(f"451 error: {e}")
                except Exception:
                    break
