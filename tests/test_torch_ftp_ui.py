"""FTP gateway (stdlib ftplib client), HTML status UIs, metrics push loop
of the port: the JAX package's tests/test_ftp_ui.py over seaweedfs_tpu_torch."""

import ftplib
import io
import threading

import pytest

from seaweedfs_tpu_torch.ftpd import FtpServer


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    tmp = tmp_path_factory.mktemp("ftp")
    master = MasterServer(port=0)
    master.start()
    vol = VolumeServer([str(tmp / "v")], master_url=master.url, port=0, device="cpu")
    vol.start()
    vol.heartbeat_once()
    filer = FilerServer(master_url=master.url, port=0, device="cpu")
    filer.start()
    yield master, vol, filer
    filer.stop()
    vol.stop()
    master.stop()


class TestFtp:
    @pytest.fixture(scope="class")
    def ftp_srv(self, cluster):
        master, vol, filer = cluster
        srv = FtpServer(filer.url, port=0, anonymous=True)
        srv.start()
        yield srv
        srv.stop()

    def _client(self, srv) -> ftplib.FTP:
        c = ftplib.FTP()
        c.connect("127.0.0.1", srv.port, timeout=10)
        c.login("anonymous", "x")
        return c

    def test_login_pwd_mkd_cwd(self, ftp_srv):
        c = self._client(ftp_srv)
        assert c.pwd() == "/"
        c.mkd("/ftpdir")
        c.cwd("/ftpdir")
        assert c.pwd() == "/ftpdir"
        c.quit()

    def test_stor_retr_list_dele(self, ftp_srv):
        c = self._client(ftp_srv)
        c.mkd("/xfer")
        c.cwd("/xfer")
        payload = b"ftp transfer payload " * 100
        c.storbinary("STOR data.bin", io.BytesIO(payload))
        assert c.size("data.bin") == len(payload)
        out = io.BytesIO()
        c.retrbinary("RETR data.bin", out.write)
        assert out.getvalue() == payload
        names = c.nlst()
        assert "data.bin" in names
        lines = []
        c.retrlines("LIST", lines.append)
        assert any("data.bin" in ln for ln in lines)
        c.delete("data.bin")
        assert "data.bin" not in c.nlst()
        c.quit()

    def test_fixed_credentials(self, cluster):
        master, vol, filer = cluster
        srv = FtpServer(filer.url, port=0, user="admin", password="secret")
        srv.start()
        try:
            c = ftplib.FTP()
            c.connect("127.0.0.1", srv.port, timeout=10)
            with pytest.raises(ftplib.error_perm):
                c.login("admin", "wrong")
            c2 = ftplib.FTP()
            c2.connect("127.0.0.1", srv.port, timeout=10)
            c2.login("admin", "secret")
            assert c2.pwd() == "/"
            c2.quit()
        finally:
            srv.stop()


class TestStatusUI:
    def test_master_and_volume_ui(self, cluster):
        from seaweedfs_tpu_torch.server.httpd import http_request

        master, vol, filer = cluster
        status, headers, body = http_request("GET", master.url + "/ui")
        assert status == 200 and b"Master" in body
        assert "text/html" in headers.get("Content-Type", "")
        status, headers, body = http_request("GET", vol.url + "/ui")
        assert status == 200 and b"Volume server" in body


class TestMetricsPush:
    def test_push_loop_hits_gateway(self):
        from seaweedfs_tpu_torch.server.httpd import HTTPService, Response
        from seaweedfs_tpu_torch.stats.metrics import start_push_loop

        received = []
        gw = HTTPService("127.0.0.1", 0)

        @gw.route("PUT", r"/metrics/job/(.*)")
        def take(req):
            received.append((req.path, req.body[:100]))
            return Response(b"", 202)

        gw.start()
        stop = threading.Event()
        try:
            start_push_loop(gw.url, "testrole", "inst:1",
                            interval_sec=0.1, stop_event=stop)
            import time

            deadline = time.time() + 5
            while not received and time.time() < deadline:
                time.sleep(0.05)
            assert received
            path, body = received[0]
            assert "/metrics/job/testrole/instance/inst%3A1" in path or \
                "/metrics/job/testrole" in path
        finally:
            stop.set()
            gw.stop()


@pytest.fixture(autouse=True, scope="module")
def _stop_port_history_loop():
    """The port's metered servers start the process's history loop; stop it
    when this module is done, so no thread of this file outlives it."""
    yield
    from seaweedfs_tpu_torch.stats import history

    history.default_history().stop()
