// Minimal epoll HTTP load generator — measures the fastlane engine's
// ceiling without a GIL-bound client in the way (the small-file
// write/read runs of chip_smoke.py's fastlane phase). One thread, N keep-alive connections, one in-flight request
// per connection; counts 2xx and completes when every path ran once.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

struct LgConn {
    int fd = -1;
    std::string out;
    size_t out_off = 0;
    std::string in;
    size_t expect = 0;   // response bytes needed (0 = headers not parsed)
    int path_idx = -1;
};

uint64_t lg_now_ns() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

int lg_connect(uint32_t ip, int port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    struct sockaddr_in sa;
    memset(&sa, 0, sizeof sa);
    sa.sin_family = AF_INET;
    sa.sin_port = htons(port);
    sa.sin_addr.s_addr = ip;
    if (connect(fd, (struct sockaddr*)&sa, sizeof sa) != 0) {
        close(fd);
        return -1;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
    return fd;
}

}  // namespace

extern "C" {

// paths: npaths zero-terminated strings, back to back. method "GET",
// "POST", "PUT" or "DELETE". body sent with every POST/PUT when non-null.
// out[0]=ok count, out[1]=error count, out[2]=elapsed ns.
int sw_loadgen(const char* host, int port, int n_conns, const char* method,
               const char* paths, size_t npaths, const char* body,
               size_t body_len, unsigned long long* out3) {
    uint32_t ip = inet_addr(host && *host ? host : "127.0.0.1");
    std::vector<const char*> pv;
    pv.reserve(npaths);
    const char* p = paths;
    for (size_t i = 0; i < npaths; i++) {
        pv.push_back(p);
        p += strlen(p) + 1;
    }
    bool is_post =
        strcmp(method, "POST") == 0 || strcmp(method, "PUT") == 0;
    size_t next_path = 0, done = 0, ok = 0, errs = 0;
    int ep = epoll_create1(0);
    std::vector<LgConn> conns(n_conns);

    auto arm = [&](LgConn& c) -> bool {
        if (next_path >= pv.size()) return false;
        c.path_idx = (int)next_path++;
        char hdr[512];
        int n;
        if (is_post)
            n = snprintf(hdr, sizeof hdr,
                         "%s %s HTTP/1.1\r\nHost: lg\r\nContent-Length: %zu\r\n\r\n",
                         method, pv[c.path_idx], body_len);
        else
            n = snprintf(hdr, sizeof hdr, "%s %s HTTP/1.1\r\nHost: lg\r\n\r\n",
                         method, pv[c.path_idx]);
        c.out.assign(hdr, n);
        if (is_post && body_len) c.out.append(body, body_len);
        c.out_off = 0;
        c.in.clear();
        c.expect = 0;
        return true;
    };

    uint64_t t0 = lg_now_ns();
    for (int i = 0; i < n_conns && (size_t)i < pv.size(); i++) {
        conns[i].fd = lg_connect(ip, port);
        if (conns[i].fd < 0) { out3[0] = 0; out3[1] = npaths; out3[2] = 0; close(ep); return -1; }
        arm(conns[i]);
        struct epoll_event ev;
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.u32 = i;
        epoll_ctl(ep, EPOLL_CTL_ADD, conns[i].fd, &ev);
    }

    struct epoll_event evs[128];
    while (done < pv.size()) {
        int n = epoll_wait(ep, evs, 128, 10000);
        if (n <= 0) break;  // stall: bail out rather than hang the bench
        for (int i = 0; i < n; i++) {
            LgConn& c = conns[evs[i].data.u32];
            if (c.fd < 0) continue;
            bool fail = (evs[i].events & (EPOLLERR | EPOLLHUP)) != 0;
            if (!fail && (evs[i].events & EPOLLOUT)) {
                while (c.out_off < c.out.size()) {
                    ssize_t w = send(c.fd, c.out.data() + c.out_off,
                                     c.out.size() - c.out_off, MSG_NOSIGNAL);
                    if (w > 0) { c.out_off += w; continue; }
                    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
                    fail = true;
                    break;
                }
                if (!fail && c.out_off >= c.out.size()) {
                    struct epoll_event ev;
                    ev.events = EPOLLIN;
                    ev.data.u32 = evs[i].data.u32;
                    epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
                }
            }
            if (!fail && (evs[i].events & EPOLLIN)) {
                char buf[65536];
                for (;;) {
                    ssize_t r = recv(c.fd, buf, sizeof buf, 0);
                    if (r > 0) { c.in.append(buf, r); continue; }
                    if (r == 0) { fail = true; }
                    else if (errno != EAGAIN && errno != EWOULDBLOCK) fail = true;
                    break;
                }
                if (!fail && c.expect == 0) {
                    size_t he = c.in.find("\r\n\r\n");
                    if (he != std::string::npos) {
                        size_t cl = 0;
                        const char* f = strcasestr(c.in.c_str(), "content-length:");
                        if (f && f < c.in.c_str() + he) cl = strtoull(f + 15, nullptr, 10);
                        c.expect = he + 4 + cl;
                    }
                }
                if (!fail && c.expect && c.in.size() >= c.expect) {
                    if (c.in.compare(0, 10, "HTTP/1.1 2") == 0) ok++;
                    else errs++;
                    done++;
                    if (arm(c)) {
                        struct epoll_event ev;
                        ev.events = EPOLLIN | EPOLLOUT;
                        ev.data.u32 = evs[i].data.u32;
                        epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
                    } else {
                        epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
                        close(c.fd);
                        c.fd = -1;
                    }
                }
            }
            if (fail) {
                errs++;
                done++;  // count the in-flight request as failed
                epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
                close(c.fd);
                c.fd = lg_connect(ip, port);  // reconnect and continue
                if (c.fd >= 0 && arm(c)) {
                    struct epoll_event ev;
                    ev.events = EPOLLIN | EPOLLOUT;
                    ev.data.u32 = evs[i].data.u32;
                    epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev);
                } else if (c.fd >= 0) {
                    close(c.fd);
                    c.fd = -1;
                }
            }
        }
    }
    uint64_t t1 = lg_now_ns();
    for (auto& c : conns)
        if (c.fd >= 0) close(c.fd);
    close(ep);
    out3[0] = ok;
    out3[1] = errs + (pv.size() - done);
    out3[2] = t1 - t0;
    return 0;
}

// Per-file assign -> write flow (`weed benchmark` semantics): every file
// costs one GET /dir/assign on the master and one POST of the body to the
// returned volume location. n_conns independent two-socket slots.
int sw_loadgen_assign_write(const char* host, int master_port, int n_conns,
                            size_t n_files, const char* assign_path,
                            const char* body, size_t body_len,
                            unsigned long long* out3) {
    struct Slot {
        LgConn m;  // master leg
        LgConn v;  // volume leg
        int phase = 0;      // 0 assigning, 1 writing
        std::string vaddr;  // host:port the volume conn points at
    };
    uint32_t mip = inet_addr(host && *host ? host : "127.0.0.1");
    size_t launched = 0, done = 0, ok = 0, errs = 0;
    int ep = epoll_create1(0);
    std::vector<Slot> slots(n_conns);

    char assign_req[256];
    int assign_len = snprintf(assign_req, sizeof assign_req,
                              "GET %s HTTP/1.1\r\nHost: lg\r\n\r\n",
                              assign_path && *assign_path ? assign_path
                                                          : "/dir/assign");

    auto mod = [&](int fd, uint32_t data, uint32_t events) {
        struct epoll_event ev;
        ev.events = events;
        ev.data.u32 = data;
        epoll_ctl(ep, EPOLL_CTL_MOD, fd, &ev);
    };

    auto start_assign = [&](size_t si) -> bool {
        if (launched >= n_files) return false;
        launched++;
        Slot& s = slots[si];
        s.phase = 0;
        s.m.out.assign(assign_req, assign_len);
        s.m.out_off = 0;
        s.m.in.clear();
        s.m.expect = 0;
        mod(s.m.fd, (uint32_t)(si * 2), EPOLLIN | EPOLLOUT);
        return true;
    };

    uint64_t t0 = lg_now_ns();
    for (int i = 0; i < n_conns && (size_t)i < n_files; i++) {
        slots[i].m.fd = lg_connect(mip, master_port);
        if (slots[i].m.fd < 0) {
            out3[0] = 0; out3[1] = n_files; out3[2] = 0;
            close(ep);
            return -1;
        }
        struct epoll_event ev;
        ev.events = 0;
        ev.data.u32 = (uint32_t)(i * 2);
        epoll_ctl(ep, EPOLL_CTL_ADD, slots[i].m.fd, &ev);
        start_assign(i);
    }

    auto fail_slot = [&](size_t si) {
        // count the in-flight file as failed and move on with fresh conns
        Slot& s = slots[si];
        errs++;
        done++;
        if (s.m.fd >= 0) { epoll_ctl(ep, EPOLL_CTL_DEL, s.m.fd, nullptr); close(s.m.fd); }
        if (s.v.fd >= 0) { epoll_ctl(ep, EPOLL_CTL_DEL, s.v.fd, nullptr); close(s.v.fd); s.v.fd = -1; s.vaddr.clear(); }
        s.m.fd = lg_connect(mip, master_port);
        if (s.m.fd >= 0) {
            struct epoll_event ev;
            ev.events = 0;
            ev.data.u32 = (uint32_t)(si * 2);
            epoll_ctl(ep, EPOLL_CTL_ADD, s.m.fd, &ev);
            start_assign(si);
        }
    };

    struct epoll_event evs[128];
    while (done < n_files) {
        int n = epoll_wait(ep, evs, 128, 10000);
        if (n <= 0) break;
        for (int i = 0; i < n; i++) {
            size_t si = evs[i].data.u32 / 2;
            bool is_vol = evs[i].data.u32 & 1;
            Slot& s = slots[si];
            LgConn& c = is_vol ? s.v : s.m;
            if (c.fd < 0) continue;
            bool fail = (evs[i].events & (EPOLLERR | EPOLLHUP)) != 0;
            if (!fail && (evs[i].events & EPOLLOUT)) {
                while (c.out_off < c.out.size()) {
                    ssize_t w = send(c.fd, c.out.data() + c.out_off,
                                     c.out.size() - c.out_off, MSG_NOSIGNAL);
                    if (w > 0) { c.out_off += w; continue; }
                    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
                    fail = true;
                    break;
                }
                if (!fail && c.out_off >= c.out.size())
                    mod(c.fd, evs[i].data.u32, EPOLLIN);
            }
            if (!fail && (evs[i].events & EPOLLIN)) {
                char buf[65536];
                for (;;) {
                    ssize_t r = recv(c.fd, buf, sizeof buf, 0);
                    if (r > 0) { c.in.append(buf, r); continue; }
                    if (r == 0) fail = true;
                    else if (errno != EAGAIN && errno != EWOULDBLOCK) fail = true;
                    break;
                }
                if (!fail && c.expect == 0) {
                    size_t he = c.in.find("\r\n\r\n");
                    if (he != std::string::npos) {
                        size_t cl = 0;
                        const char* f = strcasestr(c.in.c_str(), "content-length:");
                        if (f && f < c.in.c_str() + he)
                            cl = strtoull(f + 15, nullptr, 10);
                        c.expect = he + 4 + cl;
                    }
                }
                if (!fail && c.expect && c.in.size() >= c.expect) {
                    bool ok2xx = c.in.compare(0, 10, "HTTP/1.1 2") == 0;
                    if (s.phase == 0) {
                        // parse {"fid": "...", ..., "publicUrl": "..."}
                        std::string fid, purl;
                        const char* fp = strstr(c.in.c_str(), "\"fid\": \"");
                        if (fp) {
                            fp += 8;
                            const char* e = strchr(fp, '"');
                            if (e) fid.assign(fp, e - fp);
                        }
                        const char* pp = strstr(c.in.c_str(), "\"publicUrl\": \"");
                        if (pp) {
                            pp += 14;
                            const char* e = strchr(pp, '"');
                            if (e) purl.assign(pp, e - pp);
                        }
                        if (!ok2xx || fid.empty() || purl.empty()) {
                            fail_slot(si);
                            continue;
                        }
                        if (s.v.fd < 0 || s.vaddr != purl) {
                            if (s.v.fd >= 0) {
                                epoll_ctl(ep, EPOLL_CTL_DEL, s.v.fd, nullptr);
                                close(s.v.fd);
                            }
                            size_t colon = purl.rfind(':');
                            std::string vh = purl.substr(0, colon);
                            int vp = atoi(purl.c_str() + colon + 1);
                            s.v.fd = lg_connect(inet_addr(vh.c_str()), vp);
                            if (s.v.fd < 0) { fail_slot(si); continue; }
                            s.vaddr = purl;
                            struct epoll_event ev;
                            ev.events = 0;
                            ev.data.u32 = (uint32_t)(si * 2 + 1);
                            epoll_ctl(ep, EPOLL_CTL_ADD, s.v.fd, &ev);
                        }
                        char hdr[256];
                        int hl = snprintf(
                            hdr, sizeof hdr,
                            "POST /%s HTTP/1.1\r\nHost: lg\r\n"
                            "Content-Length: %zu\r\n\r\n",
                            fid.c_str(), body_len);
                        s.v.out.assign(hdr, hl);
                        s.v.out.append(body, body_len);
                        s.v.out_off = 0;
                        s.v.in.clear();
                        s.v.expect = 0;
                        s.phase = 1;
                        mod(s.v.fd, (uint32_t)(si * 2 + 1), EPOLLIN | EPOLLOUT);
                    } else {
                        if (ok2xx) ok++;
                        else errs++;
                        done++;
                        start_assign(si);
                    }
                    continue;
                }
            }
            if (fail) fail_slot(si);
        }
    }
    uint64_t t1 = lg_now_ns();
    for (auto& s : slots) {
        if (s.m.fd >= 0) close(s.m.fd);
        if (s.v.fd >= 0) close(s.v.fd);
    }
    close(ep);
    out3[0] = ok;
    out3[1] = errs + (n_files - done);
    out3[2] = t1 - t0;
    return 0;
}

}  // extern "C"
