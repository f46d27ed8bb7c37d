// Standalone sanitizer harness for the fastlane engine — the native-code
// arm of the suite's race-detection strategy (tests/test_torch_fastlane_tsan.py
// builds this with -fsanitize=thread / address and runs it).
//
// It stands up a real engine (plus a trivial in-process backend server),
// registers a volume on scratch files, then hammers it from concurrent
// client threads with interleaved native writes/reads/deletes, proxied
// requests, Python-side-style lock/tail/map calls, drains, and
// register/unregister churn — the exact cross-thread surfaces the Python
// suite exercises through servers, minus Python.
//
// Build: g++ -std=c++17 -fsanitize=thread -DSW_FASTLANE_SANITY_MAIN \
//        fastlane_sanity.cpp fastlane.cpp crc32c_host.cpp sha256.cpp md5_host.cpp -o t
#ifdef SW_FASTLANE_SANITY_MAIN

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int sw_fl_start(const char* host, int port, const char* backend_host,
                int backend_port, int workers, int secure_reads,
                int secure_writes, int max_backend,
                const char* jwt_write_key, const char* jwt_read_key,
                const char* tls_cert, const char* tls_key,
                const char* tls_ca, const char* tls_allowed_cns);
int sw_fl_port(int h);
void sw_fl_stop(int h);
int sw_fl_register_volume(int h, uint32_t vid, int dat_fd, int idx_fd,
                          int version, unsigned long long tail,
                          unsigned long long last_append_ns, int readonly,
                          int forward_writes);
int sw_fl_volume_serving(int h, uint32_t vid);
int sw_fl_unregister_volume(int h, uint32_t vid);
int sw_fl_set_flags(int h, uint32_t vid, int readonly, int forward_writes);
int sw_fl_volume_lock(int h, uint32_t vid);
int sw_fl_volume_unlock(int h, uint32_t vid);
unsigned long long sw_fl_tail_get(int h, uint32_t vid);
int sw_fl_tail_set(int h, uint32_t vid, unsigned long long tail,
                   unsigned long long last_ns);
int sw_fl_map_put(int h, uint32_t vid, uint64_t key,
                  unsigned long long offset, int32_t size);
long sw_fl_drain_events(int h, uint8_t* out, size_t max_events);
void sw_fl_get_stats(int h, unsigned long long* out6);
long sw_fl_get_metrics(int h, unsigned long long* out, size_t cap);
int sw_fl_get_volume_metrics(int h, uint32_t vid, unsigned long long* out6);
int sw_fl_filer_enable(int h, const char* journal_path,
                       unsigned long long chunk_limit, int compress);
int sw_fl_filer_lease_set(int h, const char* vol_host, int vol_port,
                          uint32_t vid, uint32_t cookie,
                          unsigned long long key_start,
                          unsigned long long key_end, const char* upload_auth,
                          const char* read_auth);
unsigned long long sw_fl_filer_lease_remaining(int h);
int sw_fl_filer_cache_put(int h, const char* path, const char* host,
                          int port, const char* fid, const char* mime,
                          const char* md5_hex, unsigned long long size,
                          unsigned long long mtime, const void* inline_data,
                          size_t inline_len);
int sw_fl_filer_cache_del(int h, const char* path);
long sw_fl_filer_drain(int h, uint8_t* out, size_t cap);
long sw_fl_filer_journal_reset(int h);
}

namespace {

// minimal backend: accepts, answers every request with a tiny 200
void backend_loop(int listen_fd, std::atomic<bool>* running) {
    while (running->load()) {
        int fd = accept(listen_fd, nullptr, nullptr);
        if (fd < 0) continue;
        std::thread([fd, running] {
            char buf[8192];
            std::string in;
            while (running->load()) {
                ssize_t n = recv(fd, buf, sizeof buf, 0);
                if (n <= 0) break;
                in.append(buf, n);
                size_t he;
                while ((he = in.find("\r\n\r\n")) != std::string::npos) {
                    size_t cl = 0;
                    const char* f = strcasestr(in.c_str(), "content-length:");
                    if (f && f < in.c_str() + he)
                        cl = strtoull(f + 15, nullptr, 10);
                    if (in.size() < he + 4 + cl) break;
                    in.erase(0, he + 4 + cl);
                    const char* resp =
                        "HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok";
                    if (send(fd, resp, strlen(resp), MSG_NOSIGNAL) <= 0)
                        break;
                }
            }
            close(fd);
        }).detach();
    }
}

int tcp_listen(int* port_out) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    struct sockaddr_in sa;
    memset(&sa, 0, sizeof sa);
    sa.sin_family = AF_INET;
    sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    bind(fd, (struct sockaddr*)&sa, sizeof sa);
    listen(fd, 64);
    socklen_t sl = sizeof sa;
    getsockname(fd, (struct sockaddr*)&sa, &sl);
    *port_out = ntohs(sa.sin_port);
    return fd;
}

int dial(int port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    struct sockaddr_in sa;
    memset(&sa, 0, sizeof sa);
    sa.sin_family = AF_INET;
    sa.sin_port = htons(port);
    sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (connect(fd, (struct sockaddr*)&sa, sizeof sa) != 0) {
        close(fd);
        return -1;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    return fd;
}

// one keep-alive request; returns the status code or -1
int do_req(int fd, const std::string& req) {
    if (send(fd, req.data(), req.size(), MSG_NOSIGNAL) <= 0) return -1;
    std::string resp;
    char buf[8192];
    for (;;) {
        ssize_t n = recv(fd, buf, sizeof buf, 0);
        if (n <= 0) return -1;
        resp.append(buf, n);
        size_t he = resp.find("\r\n\r\n");
        if (he == std::string::npos) continue;
        size_t cl = 0;
        const char* f = strcasestr(resp.c_str(), "content-length:");
        if (f && f < resp.c_str() + he) cl = strtoull(f + 15, nullptr, 10);
        if (resp.size() >= he + 4 + cl)
            return atoi(resp.c_str() + 9);
    }
}

}  // namespace

// process-lifetime flag: detached backend threads may outlive main()'s
// frame, so this must not live on main's stack
static std::atomic<bool> g_running{true};

// scratch files go under argv[1], else $TMPDIR, else /tmp
static std::string g_scratch = "/tmp";

// mkstemp under g_scratch; `path` receives the name
static int scratch_file(const char* stem, std::string* path) {
    std::string tmpl = g_scratch + "/" + stem + "_XXXXXX";
    std::vector<char> buf(tmpl.begin(), tmpl.end());
    buf.push_back('\0');
    int fd = mkstemp(buf.data());
    *path = buf.data();
    return fd;
}

int main(int argc, char** argv) {
    const char* env_tmp = getenv("TMPDIR");
    if (argc > 1) g_scratch = argv[1];
    else if (env_tmp && *env_tmp) g_scratch = env_tmp;
    std::atomic<bool>& running = g_running;
    int backend_port = 0;
    int backend_fd = tcp_listen(&backend_port);
    std::thread bt(backend_loop, backend_fd, &running);

    int h = sw_fl_start("127.0.0.1", 0, "127.0.0.1", backend_port, 4, 0, 0,
                        8, "", "", "", "", "", "");
    if (h < 0) { fprintf(stderr, "engine start failed\n"); return 1; }
    int port = sw_fl_port(h);

    std::string dat_path, idx_path;
    int dat_fd = scratch_file("fl_sanity_dat", &dat_path);
    int idx_fd = scratch_file("fl_sanity_idx", &idx_path);
    if (dat_fd < 0 || idx_fd < 0) {
        fprintf(stderr, "no scratch files under %s\n", g_scratch.c_str());
        return 1;
    }
    // superblock filler so offsets are nonzero like a real volume
    uint8_t super[8] = {0};
    (void)!write(dat_fd, super, 8);
    fcntl(idx_fd, F_SETFL, O_APPEND);
    sw_fl_register_volume(h, 7, dup(dat_fd), dup(idx_fd), 3, 8, 0, 0, 0);
    sw_fl_volume_serving(h, 7);

    const int THREADS = 6, OPS = 400;
    std::atomic<uint64_t> next_key{1};
    std::atomic<int> errors{0};
    std::vector<std::thread> ts;
    for (int t = 0; t < THREADS; t++) {
        ts.emplace_back([&, t] {
            int fd = dial(port);
            if (fd < 0) { errors++; return; }
            char req[512];
            for (int i = 0; i < OPS; i++) {
                uint64_t key = next_key.fetch_add(1);
                int n = snprintf(req, sizeof req,
                                 "POST /7,%llxdeadbeef HTTP/1.1\r\nHost: x\r\n"
                                 "Content-Length: 64\r\n\r\n",
                                 (unsigned long long)key);
                std::string r(req, n);
                r.append(64, (char)('a' + t));
                int st = do_req(fd, r);
                if (st != 201 && st != 200) { errors++; break; }
                n = snprintf(req, sizeof req,
                             "GET /7,%llxdeadbeef HTTP/1.1\r\nHost: x\r\n\r\n",
                             (unsigned long long)key);
                st = do_req(fd, std::string(req, n));
                if (st != 200) { errors++; break; }
                if (i % 7 == 0) {  // proxied path
                    st = do_req(fd, "GET /status HTTP/1.1\r\nHost: x\r\n\r\n");
                    if (st != 200) { errors++; break; }
                }
                if (i % 5 == 0) {
                    n = snprintf(req, sizeof req,
                                 "DELETE /7,%llxdeadbeef HTTP/1.1\r\n"
                                 "Host: x\r\n\r\n",
                                 (unsigned long long)key);
                    if (do_req(fd, std::string(req, n)) != 202) {
                        errors++;
                        break;
                    }
                }
            }
            close(fd);
        });
    }
    // Python-side style interleaving: drains, flag flips, lock/tail hooks
    std::thread admin([&] {
        // 48 = sizeof(Event) in fastlane.cpp (grew from 40 when trace_id
        // was added): a 40B/event buffer overflows whenever >= 214 events
        // back up between drains — which the hammering workers on a slow
        // box absolutely produce (ASan caught exactly that)
        uint8_t evbuf[48 * 256];
        for (int i = 0; i < 300; i++) {
            sw_fl_drain_events(h, evbuf, 256);
            sw_fl_set_flags(h, 7, 0, 0);
            sw_fl_volume_lock(h, 7);
            unsigned long long tail = sw_fl_tail_get(h, 7);
            sw_fl_tail_set(h, 7, tail, 0);
            sw_fl_volume_unlock(h, 7);
            // put + delete churn: both sides of the map_mu surface
            sw_fl_map_put(h, 7, 1000000 + i, 4096 + 8 * i, 128);
            sw_fl_map_put(h, 7, 1000000 + i, 0, 0);
            // concurrent metrics scrapes against the hammering workers
            // (the per-op histograms are relaxed atomics; any
            // accidental non-atomic path shows up here under TSAN)
            unsigned long long mbuf[256], vm[6];
            sw_fl_get_metrics(h, mbuf, 256);
            sw_fl_get_volume_metrics(h, 7, vm);
            usleep(1000);
        }
    });
    for (auto& th : ts) th.join();
    admin.join();

    unsigned long long stats[6];
    sw_fl_get_stats(h, stats);
    fprintf(stderr,
            "requests=%llu native_writes=%llu native_reads=%llu "
            "deletes=%llu proxied=%llu errors=%d\n",
            stats[0], stats[2], stats[1], stats[3], stats[4], errors.load());
    {
        // the metrics snapshot must agree with the plain counters
        unsigned long long m[256];
        long written = sw_fl_get_metrics(h, m, 256);
        if (written < 2) { fprintf(stderr, "get_metrics failed\n"); return 1; }
        size_t nb = (size_t)m[1];
        unsigned long long reads = m[2 + nb];      // op 0 count
        unsigned long long writes = m[2 + nb + (3 + nb + 1)];
        if (reads != stats[1] || writes != stats[2]) {
            fprintf(stderr, "metrics/stats mismatch r=%llu/%llu w=%llu/%llu\n",
                    reads, stats[1], writes, stats[2]);
            return 1;
        }
    }

    // ---- filer-mode phase: a SECOND engine acts as the filer, leasing
    // fids against the first (volume) engine — inline writes (journal +
    // cache under filer_mu/fcache_mu), chunk uploads (engine->engine
    // BackendConn pools), reads (inline serve + relay), against
    // concurrent drains, cache churn, and re-leases
    int fh = sw_fl_start("127.0.0.1", 0, "127.0.0.1", backend_port, 4, 0, 0,
                         8, "", "", "", "", "", "");
    if (fh < 0) { fprintf(stderr, "filer engine start failed\n"); return 1; }
    std::string jpath;
    int jfd = scratch_file("fl_sanity_journal", &jpath);
    if (jfd < 0) {
        fprintf(stderr, "no scratch file under %s\n", g_scratch.c_str());
        return 1;
    }
    close(jfd);
    sw_fl_filer_enable(fh, jpath.c_str(), 4u << 20, 0);
    sw_fl_filer_lease_set(fh, "127.0.0.1", port, 7, 0xcafe1234u,
                          1u << 20, (1u << 20) + 100000, "", "");
    int fport = sw_fl_port(fh);
    std::atomic<int> ferrors{0};
    std::vector<std::thread> fts;
    for (int t = 0; t < THREADS; t++) {
        fts.emplace_back([&, t] {
            int fd = dial(fport);
            if (fd < 0) { ferrors++; return; }
            char req[512];
            for (int i = 0; i < OPS / 2; i++) {
                bool inline_write = (i % 2) == 0;
                size_t body = inline_write ? 512 : 8192;
                int n = snprintf(req, sizeof req,
                                 "POST /s/t%d-f%d HTTP/1.1\r\nHost: x\r\n"
                                 "Content-Length: %zu\r\n\r\n",
                                 t, i, body);
                std::string r(req, n);
                r.append(body, (char)('a' + t));
                int st = do_req(fd, r);
                if (st != 201) { ferrors++; break; }
                n = snprintf(req, sizeof req,
                             "GET /s/t%d-f%d HTTP/1.1\r\nHost: x\r\n\r\n",
                             t, i);
                st = do_req(fd, std::string(req, n));
                // chunk reads may miss the cache into the proxied 200
                if (st != 200) { ferrors++; break; }
            }
            close(fd);
        });
    }
    std::thread fadmin([&] {
        uint8_t fbuf[1 << 16];
        char path[64];
        for (int i = 0; i < 200; i++) {
            sw_fl_filer_drain(fh, fbuf, sizeof fbuf);
            sw_fl_filer_journal_reset(fh);
            snprintf(path, sizeof path, "/adm/x%d", i);
            sw_fl_filer_cache_put(fh, path, "127.0.0.1", port, "7,1deadbeef",
                                  "", "0123456789abcdef0123456789abcdef",
                                  64, 1234, "inlinebytes", 11);
            if (i % 3 == 0) sw_fl_filer_cache_del(fh, path);
            if (i % 50 == 0)  // re-lease churn (flease_mu writers)
                sw_fl_filer_lease_set(fh, "127.0.0.1", port, 7, 0xcafe1234u,
                                      (2u << 20) + i * 1000,
                                      (2u << 20) + i * 1000 + 100000, "", "");
            sw_fl_filer_lease_remaining(fh);
            usleep(1000);
        }
    });
    for (auto& th : fts) th.join();
    fadmin.join();
    unsigned long long fstats[6];
    sw_fl_get_stats(fh, fstats);
    fprintf(stderr,
            "filer: requests=%llu native_writes=%llu native_reads=%llu "
            "proxied=%llu errors=%d\n",
            fstats[0], fstats[2], fstats[1], fstats[4], ferrors.load());
    sw_fl_stop(fh);
    unlink(jpath.c_str());
    if (ferrors.load() != 0) { fprintf(stderr, "filer phase errors\n"); return 1; }

    // register/unregister churn against live traffic already stopped;
    // exercise the lifecycle surface once more
    unsigned long long final_tail = sw_fl_tail_get(h, 7);
    sw_fl_unregister_volume(h, 7);
    sw_fl_register_volume(h, 7, dup(dat_fd), dup(idx_fd), 3,
                          final_tail, 0, 0, 0);
    sw_fl_volume_serving(h, 7);
    sw_fl_unregister_volume(h, 7);

    sw_fl_stop(h);
    running.store(false);
    shutdown(backend_fd, SHUT_RDWR);
    close(backend_fd);
    bt.join();
    close(dat_fd);
    close(idx_fd);
    unlink(dat_path.c_str());
    unlink(idx_path.c_str());

    if (errors.load() != 0) return 2;
    if (stats[2] < (unsigned long long)(THREADS * OPS * 0.9)) return 3;
    fprintf(stderr, "fastlane sanity OK\n");
    return 0;
}

#endif  // SW_FASTLANE_SANITY_MAIN
