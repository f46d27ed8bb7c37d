// Fastlane: epoll HTTP/1.1 front door for the volume-server data plane.
//
// The reference serves its data plane from Go (one goroutine per
// connection, all cores; `weed/server/volume_server_handlers_read.go:45`,
// `_write.go:18`). A Python http.server cannot reach that under the GIL,
// so this engine owns the hot path natively inside the same process:
//
//   GET/HEAD /<vid>,<fid>       -> lock-free-ish map lookup + pread + parse
//   POST/PUT /<vid>,<fid>       -> needle encode + append + map/idx update
//   DELETE   /<vid>,<fid>       -> tombstone append
//   everything else             -> proxied verbatim to the Python backend
//                                  (admin plane, range reads, TTL writes,
//                                  overwrites, replicated volumes, JWT...)
//
// Python stays the owner of volume lifecycle: it registers volumes
// (dup'd .dat/.idx fds + a bulk map load), routes its own rare appends
// through this engine's per-volume lock/tail, and drains an event queue
// to keep its needle map in sync (storage/fastlane.py).
//
// On-disk formats written here are bit-identical to storage/needle.py
// (v2/v3 needle records) and storage/idx.py (16-byte idx entries).

#include <arpa/inet.h>
#include <ctype.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" uint32_t sw_crc32c_update(uint32_t crc, const char* data, size_t len);
extern "C" void sw_hmac_sha256(const uint8_t* key, size_t key_len,
                               const uint8_t* data, size_t len,
                               uint8_t out[32]);
extern "C" void sw_md5_batch_var(const unsigned char* const* ptrs,
                                 const size_t* lens, size_t n,
                                 unsigned char* out);

namespace {

// ---------------------------------------------------------------------------
// TLS via dlopen'd OpenSSL 3 (this image ships libssl.so.3 but no headers).
// The engine terminates mTLS itself (`weed/security/tls.go` semantics:
// client certs REQUIRED, allowed-commonNames gate per request) so hardened
// clusters keep the native data plane instead of falling back to the
// GIL-bound Python proxy. Only the stable OpenSSL C ABI is used; every
// symbol is resolved at runtime and a resolution failure makes sw_fl_start
// report TLS-unavailable so Python serves TLS itself.
// ---------------------------------------------------------------------------

// stable ABI constants (openssl/ssl.h, openssl/obj_mac.h)
constexpr int kSSL_FILETYPE_PEM = 1;
constexpr int kSSL_VERIFY_PEER = 0x01;
constexpr int kSSL_VERIFY_FAIL_IF_NO_PEER_CERT = 0x02;
constexpr int kSSL_CTRL_MODE = 33;
constexpr long kSSL_MODE_ENABLE_PARTIAL_WRITE = 0x1;
constexpr long kSSL_MODE_ACCEPT_MOVING_WRITE_BUFFER = 0x2;
constexpr int kSSL_ERROR_WANT_READ = 2;
constexpr int kSSL_ERROR_WANT_WRITE = 3;
constexpr int kNID_commonName = 13;

struct TlsApi {
    void* (*TLS_server_method)();
    void* (*TLS_client_method)();
    void (*SSL_set_connect_state)(void*);
    void* (*SSL_CTX_new)(void*);
    void (*SSL_CTX_free)(void*);
    int (*SSL_CTX_use_certificate_chain_file)(void*, const char*);
    int (*SSL_CTX_use_PrivateKey_file)(void*, const char*, int);
    int (*SSL_CTX_load_verify_locations)(void*, const char*, const char*);
    void (*SSL_CTX_set_verify)(void*, int, void*);
    long (*SSL_CTX_ctrl)(void*, int, long, void*);
    void* (*SSL_new)(void*);
    void (*SSL_free)(void*);
    int (*SSL_set_fd)(void*, int);
    void (*SSL_set_accept_state)(void*);
    int (*SSL_do_handshake)(void*);
    int (*SSL_read)(void*, void*, int);
    int (*SSL_write)(void*, const void*, int);
    int (*SSL_get_error)(const void*, int);
    int (*SSL_shutdown)(void*);
    void* (*SSL_get1_peer_certificate)(const void*);
    void* (*X509_get_subject_name)(const void*);
    int (*X509_NAME_get_text_by_NID)(void*, int, char*, int);
    void (*X509_free)(void*);
    bool ok = false;
};

std::atomic<TlsApi*> g_tls_api{nullptr};

TlsApi* tls_api() {
    // lock-free once resolved: every TLS read/write on every worker calls
    // this, and a shared mutex here would serialize the whole data plane
    TlsApi* ready = g_tls_api.load(std::memory_order_acquire);
    if (ready != nullptr) return ready->ok ? ready : nullptr;
    static TlsApi api;
    static pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
    static bool tried = false;
    pthread_mutex_lock(&mu);
    if (!tried) {
        tried = true;
        void* ssl = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
        if (!ssl) ssl = dlopen("libssl.so.1.1", RTLD_NOW | RTLD_GLOBAL);
        void* crypto = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
        if (!crypto) crypto = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_GLOBAL);
        if (ssl && crypto) {
            bool all = true;
            auto S = [&](const char* n) -> void* {
                void* p = dlsym(ssl, n);
                if (!p) p = dlsym(crypto, n);
                if (!p) all = false;
                return p;
            };
            *(void**)&api.TLS_server_method = S("TLS_server_method");
            *(void**)&api.TLS_client_method = S("TLS_client_method");
            *(void**)&api.SSL_set_connect_state = S("SSL_set_connect_state");
            *(void**)&api.SSL_CTX_new = S("SSL_CTX_new");
            *(void**)&api.SSL_CTX_free = S("SSL_CTX_free");
            *(void**)&api.SSL_CTX_use_certificate_chain_file =
                S("SSL_CTX_use_certificate_chain_file");
            *(void**)&api.SSL_CTX_use_PrivateKey_file =
                S("SSL_CTX_use_PrivateKey_file");
            *(void**)&api.SSL_CTX_load_verify_locations =
                S("SSL_CTX_load_verify_locations");
            *(void**)&api.SSL_CTX_set_verify = S("SSL_CTX_set_verify");
            *(void**)&api.SSL_CTX_ctrl = S("SSL_CTX_ctrl");
            *(void**)&api.SSL_new = S("SSL_new");
            *(void**)&api.SSL_free = S("SSL_free");
            *(void**)&api.SSL_set_fd = S("SSL_set_fd");
            *(void**)&api.SSL_set_accept_state = S("SSL_set_accept_state");
            *(void**)&api.SSL_do_handshake = S("SSL_do_handshake");
            *(void**)&api.SSL_read = S("SSL_read");
            *(void**)&api.SSL_write = S("SSL_write");
            *(void**)&api.SSL_get_error = S("SSL_get_error");
            *(void**)&api.SSL_shutdown = S("SSL_shutdown");
            // OpenSSL 3 renamed it (get1 = caller owns the ref); 1.1 name
            // has identical semantics for our use
            void* g = dlsym(ssl, "SSL_get1_peer_certificate");
            if (!g) g = dlsym(ssl, "SSL_get_peer_certificate");
            if (!g) all = false;
            *(void**)&api.SSL_get1_peer_certificate = g;
            *(void**)&api.X509_get_subject_name = S("X509_get_subject_name");
            *(void**)&api.X509_NAME_get_text_by_NID =
                S("X509_NAME_get_text_by_NID");
            *(void**)&api.X509_free = S("X509_free");
            api.ok = all;
        }
        g_tls_api.store(&api, std::memory_order_release);
    }
    pthread_mutex_unlock(&mu);
    return api.ok ? &api : nullptr;
}

// '*'-wildcard match, same semantics as security/tls.py compile_cn_pattern
bool glob_match(const char* pat, const char* s) {
    if (*pat == 0) return *s == 0;
    if (*pat == '*') {
        for (const char* t = s;; t++) {
            if (glob_match(pat + 1, t)) return true;
            if (*t == 0) return false;
        }
    }
    return *pat == *s && glob_match(pat + 1, s + 1);
}

// ---------------------------------------------------------------------------
// needle map: open addressing, u64 key -> (offset bytes u64, size i32)
// ---------------------------------------------------------------------------

struct NMap {
    struct Slot { uint64_t key; uint64_t off; int32_t size; uint8_t state; };
    // state: 0 empty, 1 live, 2 hole (deleted; key kept for probing)
    std::vector<Slot> slots;
    size_t live = 0, used = 0;

    NMap() { slots.resize(1024); }

    static uint64_t hash(uint64_t k) {
        k ^= k >> 33; k *= 0xff51afd7ed558ccdULL; k ^= k >> 33;
        k *= 0xc4ceb9fe1a85ec53ULL; k ^= k >> 33; return k;
    }
    void grow() {
        std::vector<Slot> old;
        old.swap(slots);
        slots.resize(old.size() * 2);
        used = live = 0;  // place() recounts while replaying live entries
        for (auto& s : old)
            if (s.state == 1) place(s.key, s.off, s.size);
    }
    void place(uint64_t key, uint64_t off, int32_t size) {
        size_t mask = slots.size() - 1;
        size_t i = hash(key) & mask;
        while (slots[i].state == 1 && slots[i].key != key) i = (i + 1) & mask;
        if (slots[i].state != 1) { if (slots[i].state == 0) used++; live++; }
        slots[i] = {key, off, size, 1};
    }
    void put(uint64_t key, uint64_t off, int32_t size) {
        if ((used + 1) * 10 >= slots.size() * 7) grow();
        // overwrite-in-place if present (incl. reviving a hole)
        size_t mask = slots.size() - 1;
        size_t i = hash(key) & mask;
        size_t first_hole = SIZE_MAX;
        while (slots[i].state != 0) {
            if (slots[i].key == key) {
                if (slots[i].state != 1) live++;
                slots[i].off = off; slots[i].size = size; slots[i].state = 1;
                return;
            }
            if (slots[i].state == 2 && first_hole == SIZE_MAX) first_hole = i;
            i = (i + 1) & mask;
        }
        if (first_hole != SIZE_MAX) i = first_hole; else used++;
        slots[i] = {key, off, size, 1};
        live++;
    }
    bool get(uint64_t key, uint64_t* off, int32_t* size) const {
        size_t mask = slots.size() - 1;
        size_t i = hash(key) & mask;
        while (slots[i].state != 0) {
            if (slots[i].state == 1 && slots[i].key == key) {
                *off = slots[i].off; *size = slots[i].size; return true;
            }
            i = (i + 1) & mask;
        }
        return false;
    }
    bool del(uint64_t key) {
        size_t mask = slots.size() - 1;
        size_t i = hash(key) & mask;
        while (slots[i].state != 0) {
            if (slots[i].state == 1 && slots[i].key == key) {
                slots[i].state = 2; live--; return true;
            }
            i = (i + 1) & mask;
        }
        return false;
    }
};

// ---------------------------------------------------------------------------
// volume registry
// ---------------------------------------------------------------------------

struct Vol {
    uint32_t vid;
    int dat_fd = -1, idx_fd = -1;
    int version = 3;
    std::atomic<bool> serving{false};  // false until the map bulk-load lands
    std::atomic<uint64_t> tail{0};
    std::atomic<uint64_t> last_ns{0};
    std::atomic<bool> readonly{false};
    std::atomic<bool> forward_writes{false};
    // online-EC stripe accumulator (sw_fl_ec_online_*): the Python-side
    // striper arms stripe_bytes + its encode watermark; the drain loop
    // polls readiness in O(1) off the append tail instead of draining
    // events just to learn nothing new accumulated. 0 = not armed.
    std::atomic<uint64_t> ec_stripe{0};
    std::atomic<uint64_t> ec_watermark{0};
    // per-volume native-op counters (sw_fl_get_volume_metrics)
    std::atomic<uint64_t> m_reads{0}, m_writes{0}, m_deletes{0},
        m_read_bytes{0}, m_write_bytes{0};
    // tenant tag for sw_fl_get_usage; guarded by Engine::reg_mu, not an
    // atomic — it is written once at registration time before traffic
    char collection[64] = {0};
    std::mutex append_mu;           // serializes .dat appends (C++ and Python)
    std::shared_mutex map_mu;       // guards nmap
    NMap nmap;
    ~Vol() {
        if (dat_fd >= 0) close(dat_fd);
        if (idx_fd >= 0) close(idx_fd);
    }
};

struct Event {  // mirrored by storage/fastlane.py (48 bytes, little-endian)
    uint32_t vid;
    uint32_t op;        // 0 put, 1 delete-tombstone
    uint64_t key;
    uint64_t offset;    // byte offset of the written record
    int32_t size;       // needle body size (put) or freed size (delete)
    uint32_t pad;
    uint64_t append_ns;
    uint64_t trace_id;  // X-Sw-Trace-Id of the originating request (0=none):
                        // drain-synthesized spans join the caller's trace
};

struct Engine;
std::vector<Engine*> g_engines;   // slot per started engine; null when stopped
std::mutex g_engine_mu;

Engine* engine_at(int h) {
    std::lock_guard<std::mutex> gl(g_engine_mu);
    if (h < 0 || (size_t)h >= g_engines.size()) return nullptr;
    return g_engines[h];
}

struct Stats {
    std::atomic<uint64_t> requests{0}, native_reads{0}, native_writes{0},
        native_deletes{0}, native_assigns{0}, proxied{0};
};

// --- per-op engine metrics ---------------------------------------------------
// Fixed-bucket latency histograms + byte counters, all relaxed atomics so
// the hot path pays a handful of uncontended fetch_adds. Host profilers
// cannot see into this engine's epoll loop, so it carries its own
// instrumentation surface, exported raw through sw_fl_get_metrics and
// rendered into Prometheus families by the Python side.

constexpr int kOpRead = 0, kOpWrite = 1, kOpDelete = 2, kOpAssign = 3,
              kOpProxy = 4;
constexpr int kNumOps = 5;
constexpr int kLatBuckets = 16;
// finite bucket upper bounds in ns (50us..5s); each OpStat carries one
// extra overflow slot that Python renders as +Inf
constexpr uint64_t kLatBoundsNs[kLatBuckets] = {
    50000ull,      100000ull,     250000ull,     500000ull,
    1000000ull,    2500000ull,    5000000ull,    10000000ull,
    25000000ull,   50000000ull,   100000000ull,  250000000ull,
    500000000ull,  1000000000ull, 2500000000ull, 5000000000ull,
};

struct OpStat {
    std::atomic<uint64_t> count{0}, bytes{0}, ns_sum{0};
    std::atomic<uint64_t> buckets[kLatBuckets + 1] = {};

    void observe(uint64_t ns, uint64_t nbytes) {
        count.fetch_add(1, std::memory_order_relaxed);
        if (nbytes) bytes.fetch_add(nbytes, std::memory_order_relaxed);
        ns_sum.fetch_add(ns, std::memory_order_relaxed);
        int i = 0;
        while (i < kLatBuckets && ns > kLatBoundsNs[i]) i++;
        buckets[i].fetch_add(1, std::memory_order_relaxed);
    }
};

// ---------------------------------------------------------------------------
// HTTP connection state
// ---------------------------------------------------------------------------

struct BackendConn;

struct Conn {
    int kind = 0;        // epoll data discriminator: 0 = client connection
    int fd = -1;
    std::string in;      // accumulated request bytes
    std::string out;     // pending response bytes
    size_t out_off = 0;
    // zero-copy body channel: large response bodies ride here instead of
    // being memcpy'd into `out` — flush_out sends headers + body with one
    // writev. Either an owned buffer (out2, moved in) or a pinned shared
    // one (out2_pin keeps it alive); out2_data/len point at the bytes.
    std::string out2;
    std::shared_ptr<const void> out2_pin;
    const char* out2_data = nullptr;
    size_t out2_len = 0, out2_off = 0;
    bool want_close = false;
    bool sent_continue = false;  // answered Expect: 100-continue this request
    size_t chunk_scan = 0;       // chunked decode: resume position in `in`
    std::string chunk_body;      // chunked decode: body decoded so far
    BackendConn* upstream = nullptr;  // pending proxied request, if any
    uint64_t req_start_ns = 0;   // mono_ns at dispatch of the current request
    time_t last_active = 0;
    void* ssl = nullptr;  // OpenSSL SSL* when the engine terminates TLS
    int tls_hs = 0;       // 0 plaintext, 1 handshaking, 2 established
    bool cn_ok = true;    // false: CA-valid cert, disallowed CommonName
};

// One in-flight upstream request. The worker never blocks on it: the
// upstream socket sits in the same epoll and this struct is the parse
// state machine for its response. Targets the Python backend by default;
// filer mode also points these at volume servers (chunk uploads, read
// relays) — `mode` picks the completion handler.
struct BackendConn {
    int kind = 1;
    int fd = -1;
    bool counted = false;     // holds a slot under the backend cap
    bool head_request = false;  // HEAD: response framing carries no body
    Conn* client = nullptr;   // null if the client went away mid-flight
    std::string req;          // original request bytes (kept for one retry)
    size_t req_off = 0;       // send progress
    std::string resp;
    size_t hdr_end = 0;       // 0 until headers parsed
    size_t body_need = 0;     // with content-length: total expected bytes
    int body_mode = 0;        // 0 unknown, 1 content-length, 2 chunked, 3 to-EOF
    size_t chunk_pos = 0;     // chunked scan cursor
    bool backend_close = false;
    bool retried = false;
    bool from_pool = false;   // current fd came from the idle keep-alive pool
    time_t started = 0;
    uint64_t start_ns = 0;    // mono_ns at proxy launch (latency metrics)
    uint32_t target_ip = 0;   // 0 = engine's default Python backend
    int target_port = 0;
    int mode = 0;             // 0 proxy, 1 filer chunk upload, 2 filer relay,
                              // 3 s3 get relay, 4 s3 put relay, 5 s3 delete
    void* ssl = nullptr;      // TLS client session (mTLS upstream hops)
    uint32_t armed = 0;       // current epoll interest mask
    // filer-write context (mode 1) / relay fallback (mode 2)
    std::string f_path, f_fid, f_mime, f_md5hex;
    uint64_t f_size = 0;
    uint64_t f_mtime = 0;
    uint64_t f_trace = 0;     // trace id riding the upstream hop
    std::shared_ptr<struct FilerLease> f_lease;  // lease that minted f_fid:
                              // an upload failure drops THIS lease only
    std::string client_req;   // original client request (fallback replay)
};

struct Worker {
    int epfd = -1;
    // keep-alive conns not currently in epoll: (fd, SSL* or null).
    // idle_backends: the engine's Python backend (always plaintext);
    // idle_targets: other targets (volume engines), keyed ip<<16|port —
    // the TLS session must live as long as its socket
    std::vector<std::pair<int, void*>> idle_backends;
    std::unordered_map<uint64_t, std::vector<std::pair<int, void*>>>
        idle_targets;
    std::vector<BackendConn*> pending;  // in-flight proxied requests
    size_t capped_inflight = 0;         // pending entries counted under the cap
    std::deque<BackendConn*> waiting;   // queued: backend concurrency capped
    std::mutex conns_mu;            // acceptor adds, worker removes
    std::vector<Conn*> conns;       // for idle sweep / teardown
    std::vector<Conn*> graveyard;   // closed this loop pass; freed next pass
    std::vector<BackendConn*> back_graveyard;
    pthread_t thread;
};

// Prebuilt assign responder for one exact /dir/assign query string: the
// Python master computes the eligible volume set + a leased file-key range
// and installs it; the engine then mints fids round-robin without Python.
struct AssignProfile {
    std::vector<uint32_t> vids;
    std::vector<std::string> tails;  // per-volume JSON after the fid field
    std::atomic<uint64_t> next_key{0};
    uint64_t end_key = 0;
    std::atomic<uint64_t> rr{0};
};

// ---------------------------------------------------------------------------
// filer mode: native small-file write path + path->location read cache
// (VERDICT r4 next #3 — the filer was GIL-capped at ~3k req/s while the
// volume plane it feeds does 60k/95k). Reference hot path:
// `weed/server/filer_server_handlers_write_autochunk.go:26-155`.
// ---------------------------------------------------------------------------

// one cached file location: either inline bytes (small content, served
// straight from memory) or a single plain chunk on a volume server
// (served by natively relaying to that server's engine)
struct FilerCacheEnt {
    uint32_t ip = 0;
    int port = 0;
    std::string fid;
    std::string inline_data;  // non-empty => inline entry
    std::string mime, md5_hex;
    uint64_t size = 0;
    uint64_t mtime = 0;  // seconds
    uint64_t seq = 0;    // FIFO generation: stale queue entries are no-ops
    bool tombstone = false;  // natively-acked DELETE not yet drained:
                             // read-your-deletes across engine cores
};

// leased fid range from the master (one /dir/assign?count=N): the engine
// mints fids locally so a native write costs zero master round-trips.
// The engine holds a POOL of these (one per volume) refreshed by Python —
// chunk writes round-robin across live leases instead of stalling on one
// spent range, and a failed volume drops only its own lease.
struct FilerLease {
    uint32_t vol_ip = 0;
    int vol_port = 0;
    uint32_t vid = 0;
    uint32_t cookie = 0;
    std::atomic<uint64_t> next_key{0};
    uint64_t end_key = 0;
    std::string auth;  // Authorization value for uploads ("" = none)
};

// front-door accounting: every data-plane-shaped request on a filer/S3
// front either serves natively or falls back to the Python proxy for a
// REASON — exported via sw_fl_front_metrics so a silent fallback regime
// (a rejected lease, say) is a metric + alert, not a log line.
constexpr int kFrRead = 0, kFrWrite = 1, kFrDelete = 2;
constexpr int kNumFrontOps = 3;
constexpr int kFbCacheMiss = 0, kFbNoLease = 1, kFbLeaseSpent = 2,
              kFbTooLarge = 3, kFbBodyShape = 4, kFbSystemPath = 5,
              kFbQuery = 6, kFbBackpressure = 7, kFbUpstream = 8,
              kFbAuth = 9, kFbBucketState = 10, kFbOther = 11;
constexpr int kNumFbReasons = 12;

// per-bucket native permission bits (sw_fl_s3_bucket_set)
constexpr int kS3Read = 1, kS3Write = 2, kS3Delete = 4;

struct Engine {
    int listen_fd = -1;
    int port = 0;
    int backend_port = 0;
    uint32_t backend_ip = 0;  // where the Python service listens
    // ceiling on concurrent proxied requests per worker: a GIL-bound
    // backend serves N requests faster than 4N threads convoying
    size_t max_backend = 16;
    bool secure_writes = false;     // JWT configured -> proxy writes
    bool secure_reads = false;
    std::string jwt_write_key;      // non-empty: verify HS256 write JWTs natively
    std::string jwt_read_key;       // non-empty: verify read JWTs natively too
    void* tls_ctx = nullptr;        // OpenSSL SSL_CTX* (engine-terminated mTLS)
    void* tls_client_ctx = nullptr;  // client ctx: upstream hops under mTLS
    std::vector<std::string> allowed_cns;  // '*'-glob CommonName allow-list
    std::atomic<bool> running{true};
    std::deque<Worker> workers;  // deque: Worker holds mutexes, never moves
    pthread_t accept_thread;
    std::shared_mutex reg_mu;
    std::unordered_map<uint32_t, std::shared_ptr<Vol>> vols;
    std::shared_mutex assign_mu;
    std::unordered_map<std::string, std::shared_ptr<AssignProfile>> assigns;
    std::mutex ev_mu;
    std::deque<Event> events;
    Stats stats;
    OpStat op_stats[kNumOps];

    // --- filer mode ---
    std::atomic<bool> filer_mode{false};
    size_t filer_chunk_limit = 4 << 20;  // larger bodies proxy (multi-chunk)
    size_t filer_inline_limit = 2048;    // SMALL_CONTENT_LIMIT (filer.py)
    bool filer_compress = false;  // Python would compress some mimes >inline
    int filer_journal_fd = -1;
    std::mutex filer_mu;                 // journal append + event frames
    std::deque<std::string> filer_events;
    size_t filer_events_bytes = 0;
    std::shared_mutex fcache_mu;
    std::unordered_map<std::string, std::shared_ptr<FilerCacheEnt>> fcache;
    size_t fcache_inline_bytes = 0;
    uint64_t fcache_seq = 0;
    std::deque<std::pair<std::string, uint64_t>> fcache_fifo;  // (path, seq)
    std::shared_mutex flease_mu;
    // lease POOL, one entry per volume (sw_fl_filer_lease_set upserts by
    // vid): chunk writes round-robin across unspent leases, and an upload
    // failure drops only the failed volume's lease
    std::vector<std::shared_ptr<FilerLease>> fleases;
    std::atomic<uint64_t> flease_rr{0};
    std::string filer_read_auth;  // wildcard read JWT for relays (guarded
                                  // by flease_mu; refreshed with the lease)
    std::shared_mutex frules_mu;
    // fs.configure location prefixes: writes under them carry per-path
    // storage rules only the Python pipeline resolves
    std::vector<std::string> frule_prefixes;

    // --- s3 front mode ---
    // The gateway's engine relays gated object GET/PUT/DELETE straight to
    // the FILER's engine front door (protocol translation only — auth'd /
    // versioned / policied / meta-carrying requests all fall back to the
    // Python handlers, which keep the full S3 surface).
    std::atomic<bool> s3_mode{false};
    uint32_t s3_filer_ip = 0;
    int s3_filer_port = 0;
    std::shared_mutex s3_mu;
    std::unordered_map<std::string, int> s3_buckets;  // bucket -> flag bits
    std::unordered_set<std::string> s3_uploads;  // "<bucket>/<uploadId>"

    // front-door accounting (filer + s3 modes)
    std::atomic<uint64_t> fr_native[kNumFrontOps] = {};
    std::atomic<uint64_t> fr_fallback[kNumFrontOps][kNumFbReasons] = {};

    // any-state lookup (registration plumbing)
    std::shared_ptr<Vol> vol_raw(uint32_t vid) {
        std::shared_lock<std::shared_mutex> l(reg_mu);
        auto it = vols.find(vid);
        return it == vols.end() ? nullptr : it->second;
    }
    // request-path lookup: a volume whose map is still bulk-loading is
    // treated as absent so its traffic proxies to Python
    std::shared_ptr<Vol> vol(uint32_t vid) {
        auto v = vol_raw(vid);
        return (v && v->serving.load(std::memory_order_acquire)) ? v : nullptr;
    }
    void push_event(const Event& e) {
        std::lock_guard<std::mutex> l(ev_mu);
        events.push_back(e);
    }
};

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

uint64_t now_ns() {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

void front_native_inc(Engine* E, int op) {
    E->fr_native[op].fetch_add(1, std::memory_order_relaxed);
}
void front_fb_inc(Engine* E, int op, int reason) {
    E->fr_fallback[op][reason].fetch_add(1, std::memory_order_relaxed);
}

// round-robin over the lease pool, atomically minting one key from the
// first unspent range; null when the pool is empty (*reason=kFbNoLease)
// or fully spent (*reason=kFbLeaseSpent) — the caller proxies and the
// Python side re-leases against live topology
std::shared_ptr<FilerLease> take_filer_lease(Engine* E, uint64_t* key,
                                             int* reason) {
    std::shared_lock<std::shared_mutex> l(E->flease_mu);
    size_t n = E->fleases.size();
    if (n == 0) {
        *reason = kFbNoLease;
        return nullptr;
    }
    size_t start = E->flease_rr.fetch_add(1, std::memory_order_relaxed);
    for (size_t i = 0; i < n; i++) {
        auto& L = E->fleases[(start + i) % n];
        uint64_t k = L->next_key.fetch_add(1, std::memory_order_relaxed);
        if (k < L->end_key) {
            *key = k;
            return L;
        }
    }
    *reason = kFbLeaseSpent;
    return nullptr;
}

// a failed upload condemns ONLY the lease that minted its fid (the volume
// died / moved / was deleted); the other volumes' leases keep serving
void drop_filer_lease(Engine* E, const std::shared_ptr<FilerLease>& L) {
    if (!L) return;
    std::unique_lock<std::shared_mutex> l(E->flease_mu);
    for (size_t i = 0; i < E->fleases.size(); i++)
        if (E->fleases[i] == L) {
            E->fleases.erase(E->fleases.begin() + i);
            return;
        }
}

// parse a 16-hex-char X-Sw-Trace-Id into the u64 that rides Event frames
// (stats/trace.py ids are os.urandom(8).hex()); 0 = absent/foreign format
uint64_t parse_trace_id(const std::string& s) {
    if (s.empty() || s.size() > 16) return 0;
    uint64_t v = 0;
    for (char c : s) {
        if (!isxdigit((unsigned char)c)) return 0;
        v = (v << 4) | (uint64_t)(c >= '0' && c <= '9' ? c - '0'
                                  : (c | 0x20) - 'a' + 10);
    }
    return v;
}

uint64_t mono_ns() {  // latency measurement must not jump with wall time
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

// record one completed engine-served request into the per-op metrics;
// c->req_start_ns was stamped when dispatch picked the request up, so
// async completions (filer relays/uploads) include their upstream hop
void observe_op(Engine* E, Conn* c, int op, uint64_t nbytes) {
    E->op_stats[op].observe(mono_ns() - c->req_start_ns, nbytes);
}

void put_u32be(uint8_t* p, uint32_t v) {
    p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
void put_u64be(uint8_t* p, uint64_t v) {
    put_u32be(p, v >> 32); put_u32be(p + 4, (uint32_t)v);
}
uint32_t get_u32be(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}
uint64_t get_u64be(const uint8_t* p) {
    return ((uint64_t)get_u32be(p) << 32) | get_u32be(p + 4);
}

bool set_nonblock(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    return fl >= 0 && fcntl(fd, F_SETFL, fl | O_NONBLOCK) == 0;
}

// TLS-aware client-socket IO. Returns >0 bytes moved, 0 peer closed,
// -1 would-block (retry on the next read event), -2 hard error,
// -3 would-block on WRITE (TLS renegotiation/KeyUpdate with a full send
// buffer: the caller must arm EPOLLOUT or the conn stalls).
int conn_read(Conn* c, char* buf, int n) {
    if (c->ssl == nullptr) {
        ssize_t r = recv(c->fd, buf, n, 0);
        if (r > 0) return (int)r;
        if (r == 0) return 0;
        return (errno == EAGAIN || errno == EWOULDBLOCK) ? -1 : -2;
    }
    TlsApi* T = tls_api();
    int r = T->SSL_read(c->ssl, buf, n);
    if (r > 0) return r;
    int e = T->SSL_get_error(c->ssl, r);
    if (e == kSSL_ERROR_WANT_READ) return -1;
    if (e == kSSL_ERROR_WANT_WRITE) return -3;
    return r == 0 ? 0 : -2;  // clean TLS shutdown reads as EOF
}

int conn_write(Conn* c, const char* buf, int n) {
    if (c->ssl == nullptr) {
        ssize_t r = send(c->fd, buf, n, MSG_NOSIGNAL);
        if (r >= 0) return (int)r;
        return (errno == EAGAIN || errno == EWOULDBLOCK) ? -1 : -2;
    }
    TlsApi* T = tls_api();
    int r = T->SSL_write(c->ssl, buf, n);
    if (r > 0) return r;
    int e = T->SSL_get_error(c->ssl, r);
    if (e == kSSL_ERROR_WANT_READ || e == kSSL_ERROR_WANT_WRITE) return -1;
    return -2;
}

// upstream-socket IO (mTLS hops to volume engines ride a TLS CLIENT
// session; SSL_read/SSL_write drive the handshake implicitly on the
// nonblocking fd). Returns >0 bytes, 0 EOF, -1 wait-for-READ,
// -3 wait-for-WRITE, -2 hard error.
int back_recv(struct BackendConn* b, char* buf, int n);
int back_send(struct BackendConn* b, const char* buf, int n);

// case-insensitive header lookup inside [hdr_begin, hdr_end); returns value
// with surrounding spaces trimmed, or empty string
std::string find_header(const char* b, const char* e, const char* name) {
    size_t nlen = strlen(name);
    const char* p = b;
    while (p < e) {
        const char* eol = (const char*)memchr(p, '\n', e - p);
        if (!eol) break;
        const char* colon = (const char*)memchr(p, ':', eol - p);
        if (colon && (size_t)(colon - p) == nlen && strncasecmp(p, name, nlen) == 0) {
            const char* v = colon + 1;
            const char* ve = eol;
            if (ve > v && ve[-1] == '\r') ve--;
            while (v < ve && (*v == ' ' || *v == '\t')) v++;
            while (ve > v && (ve[-1] == ' ' || ve[-1] == '\t')) ve--;
            return std::string(v, ve - v);
        }
        p = eol + 1;
    }
    return "";
}

void json_escape(const std::string& s, std::string& out) {
    for (unsigned char c : s) {
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if (c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else out += (char)c;
        }
    }
}

// parse "<vid>,<hexkey+cookie8>[_delta]" -> ok
bool parse_fid(const char* p, const char* end, uint32_t* vid, uint64_t* key,
               uint32_t* cookie) {
    // vid digits
    uint64_t v = 0;
    const char* q = p;
    while (q < end && *q >= '0' && *q <= '9') { v = v * 10 + (*q - '0'); q++; }
    if (q == p || q >= end || *q != ',' || v > 0xFFFFFFFFull) return false;
    q++;
    // hex run
    const char* h0 = q;
    while (q < end && isxdigit((unsigned char)*q)) q++;
    size_t hlen = q - h0;
    if (hlen <= 8 || hlen > 24) return false;  // cookie is 8 hex; key 1..16
    uint64_t delta = 0;
    if (q < end && *q == '_') {
        q++;
        const char* d0 = q;
        while (q < end && *q >= '0' && *q <= '9') { delta = delta * 10 + (*q - '0'); q++; }
        if (q == d0) return false;
    }
    // optional .ext
    if (q < end && *q == '.') {
        q++;
        while (q < end && *q != '/' ) q++;
    }
    if (q != end) return false;
    auto hexval = [](char c) -> uint64_t {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        return c - 'A' + 10;
    };
    uint64_t k = 0;
    for (size_t i = 0; i < hlen - 8; i++) k = (k << 4) | hexval(h0[i]);
    uint32_t ck = 0;
    for (size_t i = hlen - 8; i < hlen; i++) ck = (ck << 4) | (uint32_t)hexval(h0[i]);
    *vid = (uint32_t)v;
    *key = k + delta;
    *cookie = ck;
    return true;
}

int padding_len(int32_t size, int version) {
    int fixed = 16 + size + 4 + (version == 3 ? 8 : 0);
    return 8 - (fixed % 8);  // always 1..8
}
int64_t actual_size(int32_t size, int version) {
    return 16 + size + 4 + (version == 3 ? 8 : 0) + padding_len(size, version);
}

// RFC 7233 single-range parse shared by every native read surface.
// Returns 0 valid (start/end set), -1 unintelligible (serve full entity,
// both the Python handlers and handle_read ignore such specs), 1 valid
// syntax but unsatisfiable (start past end after clamping).
int parse_range_spec(const std::string& range, uint64_t total,
                     long long* start, long long* end) {
    if (range.rfind("bytes=", 0) != 0) return -1;
    const char* spec = range.c_str() + 6;
    const char* dash = strchr(spec, '-');
    if (dash == nullptr) return -1;
    for (const char* q = spec; q < dash; q++)
        if (!isdigit((unsigned char)*q)) return -1;
    for (const char* q = dash + 1; *q; q++)
        if (!isdigit((unsigned char)*q)) return -1;
    if (dash == spec && !*(dash + 1)) return -1;  // bare "bytes=-"
    if (dash != spec) {  // "start-" or "start-end"
        *start = atoll(spec);
        *end = *(dash + 1) ? atoll(dash + 1) : (long long)total - 1;
    } else {  // "-suffix": last N bytes
        long long sfx = atoll(dash + 1);
        *start = (long long)total - sfx;
        if (*start < 0) *start = 0;
        *end = (long long)total - 1;
    }
    if (*end > (long long)total - 1) *end = (long long)total - 1;
    return *start <= *end ? 0 : 1;
}

void append_response(Conn* c, int status, const char* reason,
                     const std::string& ctype,
                     const std::string& extra_headers,
                     const char* body, size_t body_len, bool head) {
    char hdr[512];
    int n = snprintf(hdr, sizeof hdr,
                     "HTTP/1.1 %d %s\r\nContent-Length: %zu\r\n", status,
                     reason, body_len);
    c->out.append(hdr, n);
    if (!ctype.empty()) {
        c->out += "Content-Type: ";
        c->out += ctype;
        c->out += "\r\n";
    }
    c->out += extra_headers;
    c->out += "\r\n";
    if (!head && body_len) c->out.append(body, body_len);
}

void json_response(Conn* c, int status, const char* reason,
                   const std::string& body) {
    append_response(c, status, reason, "application/json", "", body.data(),
                    body.size(), false);
}

// defined next to flush_out (they share the out/out2 lane layout)
void respond_zc_owned(Conn* c, int status, const char* reason,
                      const std::string& ctype, const std::string& extra,
                      std::string&& body, size_t off, size_t n);
void respond_zc_pinned(Conn* c, int status, const char* reason,
                       const std::string& ctype, const std::string& extra,
                       std::shared_ptr<const void> pin, const char* data,
                       size_t n);

// bodies at least this large ride the zero-copy out2 channel; smaller
// ones are cheaper to memcpy into the header buffer than to writev
constexpr size_t kZeroCopyMin = 4096;

// ---------------------------------------------------------------------------
// native read
// ---------------------------------------------------------------------------

bool handle_read(Engine* E, Conn* c, std::shared_ptr<Vol>& v, uint64_t key,
                 uint32_t cookie, bool head, const std::string& range) {
    uint64_t off; int32_t size;
    {
        std::shared_lock<std::shared_mutex> l(v->map_mu);
        if (!v->nmap.get(key, &off, &size) || size <= 0) {
            append_response(c, 404, "Not Found", "", "", "", 0, false);
            return true;
        }
    }
    int64_t total = actual_size(size, v->version);
    std::string blob;
    blob.resize(total);
    ssize_t got = pread(v->dat_fd, &blob[0], total, off);
    if (got < total) {
        json_response(c, 500, "Internal Server Error",
                      "{\"error\": \"short read\"}");
        return true;
    }
    const uint8_t* b = (const uint8_t*)blob.data();
    uint32_t rcookie = get_u32be(b);
    if (rcookie != cookie) {
        append_response(c, 404, "Not Found", "", "", "", 0, false);
        return true;
    }
    int32_t rsize = (int32_t)get_u32be(b + 12);
    if (rsize != size) {
        json_response(c, 500, "Internal Server Error",
                      "{\"error\": \"size mismatch\"}");
        return true;
    }
    // body parse (needle.py _read_body_v2)
    const uint8_t* body = b + 16;
    const uint8_t* bend = body + size;
    if (body + 4 > bend) {
        json_response(c, 500, "Internal Server Error",
                      "{\"error\": \"truncated needle\"}");
        return true;
    }
    uint32_t data_size = get_u32be(body);
    const uint8_t* data = body + 4;
    if (data + data_size > bend) {
        json_response(c, 500, "Internal Server Error",
                      "{\"error\": \"needle data out of range\"}");
        return true;
    }
    const uint8_t* p = data + data_size;
    uint8_t flags = p < bend ? *p : 0;
    p += 1;
    std::string name, mime;
    if ((flags & 0x02) && p < bend) {               // HAS_NAME
        uint8_t nl = *p++;
        if (p + nl <= bend) name.assign((const char*)p, nl);
        p += nl;
    }
    if ((flags & 0x04) && p < bend) {               // HAS_MIME
        uint8_t ml = *p++;
        if (p + ml <= bend) mime.assign((const char*)p, ml);
        p += ml;
    }
    uint64_t last_modified = 0;
    if ((flags & 0x08) && p + 5 <= bend) {          // HAS_LAST_MODIFIED
        for (int i = 0; i < 5; i++) last_modified = (last_modified << 8) | p[i];
        p += 5;
    }
    if (flags & 0x10) {                              // HAS_TTL
        if (p + 2 <= bend) {
            uint32_t count = p[0], unit = p[1];
            static const uint64_t mins[7] = {0, 1, 60, 1440, 10080, 43200, 525600};
            uint64_t m = unit < 7 ? mins[unit] : 0;
            if (count && m && (flags & 0x08)) {
                uint64_t expires = last_modified + count * m * 60;
                if (expires < (uint64_t)time(nullptr)) {
                    append_response(c, 404, "Not Found", "", "", "", 0, false);
                    return true;
                }
            }
        }
        p += 2;
    }
    // CRC check (needle.from_bytes): stored raw or legacy transform
    uint32_t stored = get_u32be(b + 16 + size);
    uint32_t actual = sw_crc32c_update(0, (const char*)data, data_size);
    uint32_t rotated = ((actual >> 15) | (actual << 17));
    uint32_t legacy = rotated + 0xA282EAD8u;
    if (stored != actual && stored != legacy) {
        json_response(c, 500, "Internal Server Error",
                      "{\"error\": \"CRC error! Data On Disk Corrupted\"}");
        return true;
    }
    std::string extra = "Accept-Ranges: bytes\r\n";
    {
        char etag[32];
        snprintf(etag, sizeof etag, "ETag: \"%08x\"\r\n", actual);
        extra += etag;
    }
    if (!name.empty()) {
        extra += "Content-Disposition: inline; filename=\"";
        // match urllib.parse.quote: conservative percent-encoding
        for (unsigned char ch : name) {
            if (isalnum(ch) || ch == '_' || ch == '.' || ch == '-' || ch == '~' || ch == '/')
                extra += (char)ch;
            else {
                char buf[4];
                snprintf(buf, sizeof buf, "%%%02X", ch);
                extra += buf;
            }
        }
        extra += "\"\r\n";
    }
    if (flags & 0x01) extra += "Content-Encoding: gzip\r\n";  // IS_COMPRESSED
    std::string ctype = mime.empty() ? "application/octet-stream" : mime;
    // single-range slicing (server/volume.py _do_read semantics; multi-part
    // ranges were already filtered to the proxy by the caller)
    int status = 200;
    const char* out_p = (const char*)data;
    size_t out_n = data_size;
    if (!range.empty()) {
        long long start, end;
        // unintelligible or unsatisfiable specs serve the full entity
        // (volume.py _do_read applies the same rule)
        if (parse_range_spec(range, data_size, &start, &end) == 0) {
            char cr[96];
            snprintf(cr, sizeof cr, "Content-Range: bytes %lld-%lld/%u\r\n",
                     start, end, data_size);
            extra += cr;
            out_p = (const char*)data + start;
            out_n = (size_t)(end - start + 1);
            status = 206;
        }
    }
    if (head) {
        char hint[64];
        snprintf(hint, sizeof hint, "Content-Length-Hint: %zu\r\n", out_n);
        extra += hint;
        append_response(c, status, status == 206 ? "Partial Content" : "OK",
                        ctype, extra, "", 0, false);
    } else if (out_n >= kZeroCopyMin) {
        // zero-copy: the pread blob moves onto the out2 lane; headers +
        // body leave in one writev instead of a second body memcpy
        respond_zc_owned(c, status, status == 206 ? "Partial Content" : "OK",
                         ctype, extra, std::move(blob),
                         (size_t)(out_p - blob.data()), out_n);
    } else {
        append_response(c, status, status == 206 ? "Partial Content" : "OK",
                        ctype, extra, out_p, out_n, false);
    }
    uint64_t served = head ? 0 : (uint64_t)out_n;
    v->m_reads.fetch_add(1, std::memory_order_relaxed);
    v->m_read_bytes.fetch_add(served, std::memory_order_relaxed);
    observe_op(E, c, kOpRead, served);
    E->stats.native_reads++;
    return true;
}

// first file part of a multipart/form-data body (filename= present) —
// mirrors httpd.py Request.multipart_file. Returns false if no file part
// (caller proxies; Python answers exactly as before).
bool multipart_first_file(const std::string& ctype, const char* body,
                          size_t body_len, std::string* filename,
                          std::string* part_type, const char** data,
                          size_t* data_len) {
    size_t bpos = ctype.find("boundary=");
    if (bpos == std::string::npos) return false;
    std::string boundary = ctype.substr(bpos + 9);
    if (!boundary.empty() && boundary[0] == '"') {
        size_t endq = boundary.find('"', 1);
        boundary = boundary.substr(1, endq == std::string::npos
                                          ? std::string::npos : endq - 1);
    } else {
        size_t semi = boundary.find(';');
        if (semi != std::string::npos) boundary = boundary.substr(0, semi);
    }
    if (boundary.empty()) return false;
    std::string delim = "--" + boundary;
    // raw-memory scan: no copy of the (possibly multi-MB) upload body
    const char* end = body + body_len;
    const char* pos = (const char*)memmem(body, body_len, delim.data(),
                                          delim.size());
    while (pos != nullptr) {
        pos += delim.size();
        const char* hdr_end = (const char*)memmem(pos, (size_t)(end - pos),
                                                  "\r\n\r\n", 4);
        if (!hdr_end) break;
        std::string head(pos, (size_t)(hdr_end - pos));
        const char* dstart = hdr_end + 4;
        const char* dend = (const char*)memmem(
            dstart, (size_t)(end - dstart), delim.data(), delim.size());
        if (!dend) break;
        size_t plen = (size_t)(dend - dstart);
        // part data ends before the CRLF preceding the next delimiter
        if (plen >= 2 && dend[-2] == '\r' && dend[-1] == '\n') plen -= 2;
        size_t fpos = head.find("filename=\"");
        if (fpos != std::string::npos) {
            size_t fend = head.find('"', fpos + 10);
            if (fend == std::string::npos) return false;
            *filename = head.substr(fpos + 10, fend - fpos - 10);
            part_type->clear();
            size_t ct = 0;
            // case-insensitive Content-Type scan within the part head
            for (size_t i = 0; i + 13 <= head.size(); i++)
                if (strncasecmp(head.c_str() + i, "content-type:", 13) == 0) {
                    ct = i + 13;
                    break;
                }
            if (ct) {
                size_t eol = head.find('\r', ct);
                if (eol == std::string::npos) eol = head.size();
                while (ct < eol && (head[ct] == ' ' || head[ct] == '\t'))
                    ct++;
                while (eol > ct &&
                       (head[eol - 1] == ' ' || head[eol - 1] == '\t'))
                    eol--;
                *part_type = head.substr(ct, eol - ct);
            }
            *data = dstart;
            *data_len = plen;
            return true;
        }
        pos = dend;
    }
    return false;
}

// ---------------------------------------------------------------------------
// native write / delete
// ---------------------------------------------------------------------------

bool handle_write(Engine* E, Conn* c, std::shared_ptr<Vol>& v, uint64_t key,
                  uint32_t cookie, const char* data, size_t data_len,
                  const std::string& name, const std::string& mime,
                  uint64_t trace_id = 0) {
    if (data_len > 0xFFFFFFFFull) return false;
    // build the v2/v3 record (needle.py to_bytes with data non-empty)
    uint8_t flags = 0x08;  // HAS_LAST_MODIFIED (server always sets it)
    std::string nm = name.substr(0, 255);
    std::string mm = mime;
    if (!nm.empty()) flags |= 0x02;
    if (!mm.empty()) flags |= 0x04;
    int32_t size = 4 + (int32_t)data_len + 1 + 5;
    if (!nm.empty()) size += 1 + (int32_t)nm.size();
    if (!mm.empty()) size += 1 + (int32_t)mm.size();
    int version = v->version;
    int64_t total = actual_size(size, version);
    std::string rec;
    rec.resize(total, 0);
    uint8_t* o = (uint8_t*)&rec[0];
    put_u32be(o, cookie);
    put_u64be(o + 4, key);
    put_u32be(o + 12, (uint32_t)size);
    uint8_t* w = o + 16;
    put_u32be(w, (uint32_t)data_len); w += 4;
    memcpy(w, data, data_len); w += data_len;
    *w++ = flags;
    if (!nm.empty()) { *w++ = (uint8_t)nm.size(); memcpy(w, nm.data(), nm.size()); w += nm.size(); }
    if (!mm.empty()) { *w++ = (uint8_t)mm.size(); memcpy(w, mm.data(), mm.size()); w += mm.size(); }
    uint64_t lm = (uint64_t)time(nullptr);
    for (int i = 4; i >= 0; i--) *w++ = (uint8_t)(lm >> (8 * i));
    uint32_t crc = sw_crc32c_update(0, data, data_len);
    put_u32be(w, crc); w += 4;
    uint64_t ns;
    uint64_t offset;
    {
        std::lock_guard<std::mutex> l(v->append_mu);
        if (v->readonly.load()) return false;  // raced a readonly flip: proxy
        ns = now_ns();
        uint64_t last = v->last_ns.load(std::memory_order_relaxed);
        if (ns <= last) ns = last + 1;
        if (version == 3) { put_u64be(w, ns); }
        offset = v->tail.load(std::memory_order_relaxed);
        if (offset % 8) offset += 8 - offset % 8;
        if (offset + total > (1ull << 35)) return false;  // 4B idx offsets
        ssize_t wr = pwrite(v->dat_fd, rec.data(), total, offset);
        if (wr != total) {
            json_response(c, 500, "Internal Server Error",
                          "{\"error\": \"write failed\"}");
            return true;
        }
        // idx entry: key u64 BE | offset/8 u32 BE | size u32 BE (O_APPEND fd)
        uint8_t ie[16];
        put_u64be(ie, key);
        put_u32be(ie + 8, (uint32_t)(offset / 8));
        put_u32be(ie + 12, (uint32_t)size);
        if (write(v->idx_fd, ie, 16) != 16) {
            json_response(c, 500, "Internal Server Error",
                          "{\"error\": \"idx write failed\"}");
            return true;
        }
        {
            std::unique_lock<std::shared_mutex> ml(v->map_mu);
            v->nmap.put(key, offset, size);
        }
        v->tail.store(offset + total, std::memory_order_relaxed);
        v->last_ns.store(ns, std::memory_order_relaxed);
    }
    E->push_event({v->vid, 0, key, offset, size, 0, ns, trace_id});
    std::string body = "{\"name\": \"";
    json_escape(nm, body);
    char tailbuf[64];
    snprintf(tailbuf, sizeof tailbuf, "\", \"size\": %zu, \"eTag\": \"%08x\"}",
             data_len, crc);
    body += tailbuf;
    json_response(c, 201, "Created", body);
    v->m_writes.fetch_add(1, std::memory_order_relaxed);
    v->m_write_bytes.fetch_add(data_len, std::memory_order_relaxed);
    observe_op(E, c, kOpWrite, data_len);
    E->stats.native_writes++;
    return true;
}

bool handle_delete(Engine* E, Conn* c, std::shared_ptr<Vol>& v, uint64_t key,
                   uint32_t cookie, uint64_t trace_id = 0) {
    // no cookie check on delete — matches storage/volume.py delete_needle
    uint64_t off; int32_t size;
    {
        std::shared_lock<std::shared_mutex> l(v->map_mu);
        if (!v->nmap.get(key, &off, &size) || size <= 0) {
            json_response(c, 202, "Accepted", "{\"size\": 0}");
            return true;
        }
    }
    // tombstone record: empty needle (size=0) + idx entry size=-1
    int version = v->version;
    int32_t zsize = 0;
    int64_t total = actual_size(zsize, version);
    std::string rec;
    rec.resize(total, 0);
    uint8_t* o = (uint8_t*)&rec[0];
    put_u32be(o, cookie);
    put_u64be(o + 4, key);
    put_u32be(o + 12, 0);
    put_u32be(o + 16, 0);  // crc32c of empty = 0
    uint64_t ns, offset;
    int32_t freed = size;
    {
        std::lock_guard<std::mutex> l(v->append_mu);
        if (v->readonly.load()) return false;
        {
            // re-check under the append lock (racing delete/overwrite)
            std::shared_lock<std::shared_mutex> ml(v->map_mu);
            if (!v->nmap.get(key, &off, &freed) || freed <= 0) {
                json_response(c, 202, "Accepted", "{\"size\": 0}");
                return true;
            }
        }
        ns = now_ns();
        uint64_t last = v->last_ns.load(std::memory_order_relaxed);
        if (ns <= last) ns = last + 1;
        if (version == 3) put_u64be(o + 20, ns);
        offset = v->tail.load(std::memory_order_relaxed);
        if (offset % 8) offset += 8 - offset % 8;
        if (pwrite(v->dat_fd, rec.data(), total, offset) != total) {
            json_response(c, 500, "Internal Server Error",
                          "{\"error\": \"write failed\"}");
            return true;
        }
        uint8_t ie[16];
        put_u64be(ie, key);
        put_u32be(ie + 8, (uint32_t)(offset / 8));
        put_u32be(ie + 12, 0xFFFFFFFFu);  // tombstone size -1
        if (write(v->idx_fd, ie, 16) != 16) {
            json_response(c, 500, "Internal Server Error",
                          "{\"error\": \"idx write failed\"}");
            return true;
        }
        {
            std::unique_lock<std::shared_mutex> ml(v->map_mu);
            v->nmap.del(key);
        }
        v->tail.store(offset + total, std::memory_order_relaxed);
        v->last_ns.store(ns, std::memory_order_relaxed);
    }
    E->push_event({v->vid, 1, key, offset, freed, 0, ns, trace_id});
    char body[48];
    snprintf(body, sizeof body, "{\"size\": %d}", freed);
    json_response(c, 202, "Accepted", body);
    v->m_deletes.fetch_add(1, std::memory_order_relaxed);
    observe_op(E, c, kOpDelete, 0);
    E->stats.native_deletes++;
    return true;
}

// ---------------------------------------------------------------------------
// proxy to the Python backend
// ---------------------------------------------------------------------------

int back_recv(BackendConn* b, char* buf, int n) {
    if (b->ssl == nullptr) {
        ssize_t r = recv(b->fd, buf, n, 0);
        if (r > 0) return (int)r;
        if (r == 0) return 0;
        return (errno == EAGAIN || errno == EWOULDBLOCK) ? -1 : -2;
    }
    TlsApi* T = tls_api();
    int r = T->SSL_read(b->ssl, buf, n);
    if (r > 0) return r;
    int e = T->SSL_get_error(b->ssl, r);
    if (e == kSSL_ERROR_WANT_READ) return -1;
    if (e == kSSL_ERROR_WANT_WRITE) return -3;
    return r == 0 ? 0 : -2;
}

int back_send(BackendConn* b, const char* buf, int n) {
    if (b->ssl == nullptr) {
        ssize_t r = send(b->fd, buf, n, MSG_NOSIGNAL);
        if (r >= 0) return (int)r;
        // plain-socket EAGAIN on send = the send buffer is full: resume
        // on WRITABILITY (-3), not readability
        return (errno == EAGAIN || errno == EWOULDBLOCK) ? -3 : -2;
    }
    TlsApi* T = tls_api();
    int r = T->SSL_write(b->ssl, buf, n);
    if (r > 0) return r;
    int e = T->SSL_get_error(b->ssl, r);
    if (e == kSSL_ERROR_WANT_READ) return -1;
    if (e == kSSL_ERROR_WANT_WRITE) return -3;
    return -2;
}

// take a healthy pooled keep-alive conn (fd + optional TLS session) or
// return -1; dead entries (peer closed while idle) are discarded
int pool_take(std::vector<std::pair<int, void*>>& pool, void** ssl_out) {
    while (!pool.empty()) {
        int fd = pool.back().first;
        void* ssl = pool.back().second;
        pool.pop_back();
        char probe;
        ssize_t r = recv(fd, &probe, 1, MSG_PEEK | MSG_DONTWAIT);
        if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
            if (ssl != nullptr) tls_api()->SSL_free(ssl);
            close(fd);
            continue;
        }
        *ssl_out = ssl;
        return fd;
    }
    *ssl_out = nullptr;
    return -1;
}

void back_free_ssl(BackendConn* b) {
    if (b->ssl != nullptr) {
        tls_api()->SSL_free(b->ssl);
        b->ssl = nullptr;
    }
}

int backend_connect(uint32_t ip, int port) {
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
    set_nonblock(fd);
    return fd;
}

void flush_out(Worker* w, Conn* c);
void process_buffered(Engine* E, Worker* w, Conn* c);
void drain_buffered(Engine* E, Worker* w, Conn* c);

void backend_finish(Worker* w, BackendConn* b, bool reusable) {
    for (size_t i = 0; i < w->pending.size(); i++)
        if (w->pending[i] == b) {
            w->pending[i] = w->pending.back();
            w->pending.pop_back();
            if (b->counted) w->capped_inflight--;
            break;
        }
    if (b->fd >= 0) {
        epoll_ctl(w->epfd, EPOLL_CTL_DEL, b->fd, nullptr);
        auto& pool =
            b->target_ip != 0
                ? w->idle_targets[((uint64_t)b->target_ip << 16) |
                                  (uint16_t)b->target_port]
                : w->idle_backends;
        if (reusable && pool.size() < 8) {
            pool.emplace_back(b->fd, b->ssl);  // TLS session rides along
            b->ssl = nullptr;
        } else {
            back_free_ssl(b);
            close(b->fd);
        }
        b->fd = -1;
    }
    back_free_ssl(b);  // non-pooled leftovers
    w->back_graveyard.push_back(b);
}

// launch (or relaunch, on retry) the upstream request; never blocks
bool backend_launch(Engine* E, Worker* w, BackendConn* b) {
    uint32_t ip = b->target_ip ? b->target_ip : E->backend_ip;
    int port = b->target_ip ? b->target_port : E->backend_port;
    void* ssl = nullptr;
    auto& pool = b->target_ip != 0
                     ? w->idle_targets[((uint64_t)b->target_ip << 16) |
                                       (uint16_t)b->target_port]
                     : w->idle_backends;
    int fd = pool_take(pool, &ssl);
    bool pooled = fd >= 0;
    for (;;) {
        if (fd < 0) {
            fd = backend_connect(ip, port);
            if (fd < 0) return false;
            // upstream hops to non-Python targets speak the cluster's
            // mTLS (a volume engine terminates TLS): attach a CLIENT
            // session presenting this node's cert; the handshake rides
            // the first SSL_write/SSL_read on the nonblocking fd
            if (b->target_ip != 0 && E->tls_client_ctx != nullptr) {
                TlsApi* T = tls_api();
                ssl = T->SSL_new(E->tls_client_ctx);
                if (ssl == nullptr) {
                    close(fd);
                    return false;
                }
                T->SSL_set_fd(ssl, fd);
                T->SSL_set_connect_state(ssl);
            }
        }
        b->fd = fd;
        b->ssl = ssl;
        b->from_pool = pooled;
        b->req_off = 0;
        b->resp.clear();
        b->hdr_end = 0;
        b->body_mode = 0;
        b->started = time(nullptr);
        // optimistic send; leftover bytes flush on the next epoll event
        bool want_write = false, failed = false;
        while (b->req_off < b->req.size()) {
            int n = back_send(b, b->req.data() + b->req_off,
                              (int)std::min(b->req.size() - b->req_off,
                                            (size_t)1 << 20));
            if (n > 0) { b->req_off += n; continue; }
            if (n == -1) break;                       // wait for read
            if (n == -3) { want_write = true; break; }  // wait for write
            failed = true;
            break;
        }
        if (failed) {
            back_free_ssl(b);
            close(fd);
            b->fd = -1;
            fd = -1;
            ssl = nullptr;
            if (pooled) {  // a pooled conn died between probe and send
                pooled = false;  // (TLS close_notify buffered behind the
                continue;        // peek): retry once on a fresh socket
            }
            return false;
        }
        struct epoll_event ev;
        // EPOLLOUT only when the last operation blocked on WRITE: a TLS
        // handshake blocked on READ with unsent bytes must not arm it,
        // or the empty send buffer makes epoll spin at 100% CPU
        ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
        b->armed = ev.events;
        ev.data.ptr = b;
        epoll_ctl(w->epfd, EPOLL_CTL_ADD, fd, &ev);
        return true;
    }
}

// Connection is hop-by-hop (RFC 7230 §6.1): forwarding a client's
// "Connection: close" verbatim makes the Python backend close its side
// AFTER responding — without advertising close in the response — so the
// engine pools a socket that is already dying. Enough close-mode clients
// (urllib sends it on every request) turn the whole idle pool into
// corpses, and a proxied request that pops two in a row 502s. Rewrite
// the header to keep-alive on the backend hop; the client-side close is
// the engine's own business.
void rewrite_hop_connection(std::string& req) {
    size_t he = req.find("\r\n\r\n");
    if (he == std::string::npos) return;
    for (size_t pos = req.find("\r\n"); pos < he;
         pos = req.find("\r\n", pos + 2)) {
        size_t ls = pos + 2;
        if (ls + 11 > he) break;
        if (strncasecmp(req.data() + ls, "connection:", 11) != 0) continue;
        size_t le = req.find("\r\n", ls);
        req.replace(ls, le - ls, "Connection: keep-alive");
        return;
    }
}

// bypass_cap: long-poll endpoints (meta subscriptions) park cheaply in a
// Python thread for up to 30s — counting them against the backend cap
// would let a couple of subscribers starve every other request
void proxy_request(Engine* E, Worker* w, Conn* c, const char* req, size_t len,
                   bool bypass_cap = false) {
    auto* b = new BackendConn();
    b->client = c;
    b->req.assign(req, len);
    rewrite_hop_connection(b->req);
    b->started = time(nullptr);
    b->start_ns = mono_ns();
    b->counted = !bypass_cap;
    b->head_request = len >= 5 && memcmp(req, "HEAD ", 5) == 0;
    c->upstream = b;  // halts further request processing on this client
    if (b->counted && w->capped_inflight >= E->max_backend) {
        w->waiting.push_back(b);  // dispatched as in-flight requests finish
        return;
    }
    if (!backend_launch(E, w, b)) {
        c->upstream = nullptr;
        delete b;
        json_response(c, 502, "Bad Gateway",
                      "{\"error\": \"backend unavailable\"}");
        c->want_close = true;
        return;
    }
    if (b->counted) w->capped_inflight++;
    w->pending.push_back(b);
}

// dispatch queued proxied requests into freed backend slots
void drain_waiting(Engine* E, Worker* w) {
    while (!w->waiting.empty() && w->capped_inflight < E->max_backend) {
        BackendConn* b = w->waiting.front();
        w->waiting.pop_front();
        if (b->client == nullptr) {  // client vanished while queued
            w->back_graveyard.push_back(b);
            continue;
        }
        if (!backend_launch(E, w, b)) {
            Conn* c = b->client;
            c->upstream = nullptr;
            json_response(c, 502, "Bad Gateway",
                          "{\"error\": \"backend unavailable\"}");
            c->want_close = true;
            flush_out(w, c);
            w->back_graveyard.push_back(b);
            continue;
        }
        w->capped_inflight++;
        w->pending.push_back(b);
    }
}

void filer_upload_finish(Engine* E, Worker* w, BackendConn* b, bool ok);
void filer_relay_finish(Engine* E, Worker* w, BackendConn* b, bool ok);
void s3_get_finish(Engine* E, Worker* w, BackendConn* b, bool ok);
void s3_put_finish(Engine* E, Worker* w, BackendConn* b, bool ok);
void s3_delete_finish(Engine* E, Worker* w, BackendConn* b, bool ok);

// deliver the completed (or failed) upstream response and resume the
// client's request pipeline; filer-mode conns have their own finishers
void backend_complete(Engine* E, Worker* w, BackendConn* b, bool ok,
                      bool client_keep, bool reusable) {
    if (b->mode == 1) { filer_upload_finish(E, w, b, ok); return; }
    if (b->mode == 2) { filer_relay_finish(E, w, b, ok); return; }
    if (b->mode == 3) { s3_get_finish(E, w, b, ok); return; }
    if (b->mode == 4) { s3_put_finish(E, w, b, ok); return; }
    if (b->mode == 5) { s3_delete_finish(E, w, b, ok); return; }
    Conn* c = b->client;
    if (c != nullptr) {
        c->upstream = nullptr;
        if (ok) {
            c->out += b->resp;
            if (!client_keep) c->want_close = true;
            E->op_stats[kOpProxy].observe(mono_ns() - b->start_ns,
                                          b->resp.size());
            E->stats.proxied++;
        } else {
            json_response(c, 502, "Bad Gateway",
                          "{\"error\": \"backend unavailable\"}");
            c->want_close = true;
        }
    }
    backend_finish(w, b, reusable);
    drain_waiting(E, w);
    if (c != nullptr) {
        drain_buffered(E, w, c);
    }
}

// returns true when the buffered response is complete
bool backend_parse(BackendConn* b) {
    if (b->hdr_end == 0) {
        size_t he = b->resp.find("\r\n\r\n");
        if (he == std::string::npos) return false;
        // interim 1xx responses (100 Continue to a forwarded Expect
        // header) precede the real one: drop and keep parsing
        if (b->resp.compare(0, 9, "HTTP/1.1 ") == 0 && b->resp[9] == '1') {
            b->resp.erase(0, he + 4);
            return backend_parse(b);
        }
        b->hdr_end = he + 4;
        const char* hb = b->resp.data();
        const char* hend = hb + b->hdr_end;
        std::string cl = find_header(hb, hend, "content-length");
        std::string te = find_header(hb, hend, "transfer-encoding");
        std::string ch = find_header(hb, hend, "connection");
        b->backend_close = strcasecmp(ch.c_str(), "close") == 0;
        if (b->head_request) {
            // HEAD responses advertise the entity size but ship no body
            b->body_mode = 1;
            b->body_need = b->hdr_end;
        } else if (!cl.empty()) {
            b->body_mode = 1;
            b->body_need = b->hdr_end + strtoull(cl.c_str(), nullptr, 10);
        } else if (strcasecmp(te.c_str(), "chunked") == 0) {
            b->body_mode = 2;
            b->chunk_pos = b->hdr_end;
        } else {
            b->body_mode = 3;  // close-delimited
        }
    }
    if (b->body_mode == 1) return b->resp.size() >= b->body_need;
    if (b->body_mode == 2) {
        for (;;) {
            size_t le = b->resp.find("\r\n", b->chunk_pos);
            if (le == std::string::npos) return false;
            size_t chunk = strtoull(b->resp.c_str() + b->chunk_pos, nullptr, 16);
            size_t need = le + 2 + chunk + 2;
            if (b->resp.size() < need) return false;
            b->chunk_pos = need;
            if (chunk == 0) return true;
        }
    }
    return false;  // close-delimited: completes on EOF
}

void on_backend_event(Engine* E, Worker* w, BackendConn* b, uint32_t events) {
    bool want_write = false;
    if (b->req_off < b->req.size()) {
        while (b->req_off < b->req.size()) {
            int n = back_send(b, b->req.data() + b->req_off,
                              (int)std::min(b->req.size() - b->req_off,
                                            (size_t)1 << 20));
            if (n > 0) { b->req_off += n; continue; }
            if (n == -1) break;
            if (n == -3) { want_write = true; break; }
            events |= EPOLLERR;
            break;
        }
    }
    bool eof = false, err = (events & EPOLLERR) != 0;
    if (!err) {
        char buf[65536];
        for (;;) {
            int n = back_recv(b, buf, sizeof buf);
            if (n > 0) { b->resp.append(buf, n); continue; }
            if (n == 0) { eof = true; break; }
            if (n == -1) break;
            if (n == -3) { want_write = true; break; }
            err = true;
            break;
        }
    }
    if (!err && !eof) {
        // keep the interest mask exact: EPOLLOUT only while an operation
        // is blocked on WRITE — a stale EPOLLOUT on an idle-writable
        // socket is a level-triggered busy-spin
        uint32_t want = EPOLLIN | (want_write ? EPOLLOUT : 0);
        if (want != b->armed) {
            struct epoll_event ev;
            ev.events = want;
            ev.data.ptr = b;
            epoll_ctl(w->epfd, EPOLL_CTL_MOD, b->fd, &ev);
            b->armed = want;
        }
    }
    if (!err && backend_parse(b)) {
        backend_complete(E, w, b, true, true, !b->backend_close && !eof);
        return;
    }
    if (eof && !err && b->body_mode == 3 && b->hdr_end != 0) {
        // close-delimited response fully read: forward, close client too
        backend_complete(E, w, b, true, false, false);
        return;
    }
    if (err || eof) {
        // nothing usable arrived — relaunch. A POOLED keep-alive socket
        // dying between requests is routine (the peer may close after
        // responding without having advertised Connection: close), and
        // the pool can hold SEVERAL such corpses at once, so pooled
        // deaths retry for as long as the launch keeps drawing from the
        // pool; only a FRESH connection gets exactly one retry before
        // the 502 — that one really means the backend is unavailable.
        if (b->resp.empty() && (b->from_pool || !b->retried)) {
            if (!b->from_pool) b->retried = true;
            epoll_ctl(w->epfd, EPOLL_CTL_DEL, b->fd, nullptr);
            back_free_ssl(b);
            close(b->fd);
            b->fd = -1;
            if (backend_launch(E, w, b)) return;
        }
        backend_complete(E, w, b, false, false, false);
    }
}

// ---------------------------------------------------------------------------
// HS256 write-JWT verification (`weed/security/jwt.go`; Python mirror
// security/jwt.py). The engine only accepts tokens it can fully verify;
// anything else proxies to Python, which produces the exact 401 bodies.
// ---------------------------------------------------------------------------

int b64url_decode(const char* in, size_t n, uint8_t* out, size_t cap) {
    struct Table {
        int8_t t[256];
        Table() {
            memset(t, -1, sizeof t);
            const char* az = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                             "abcdefghijklmnopqrstuvwxyz0123456789-_";
            for (int i = 0; i < 64; i++) t[(uint8_t)az[i]] = (int8_t)i;
        }
    };
    static const Table tbl;  // C++11 magic static: thread-safe init
    const int8_t* T = tbl.t;
    uint32_t acc = 0;
    int bits = 0;
    size_t o = 0;
    for (size_t i = 0; i < n; i++) {
        int8_t v = T[(uint8_t)in[i]];
        if (v < 0) return -1;
        acc = (acc << 6) | (uint32_t)v;
        bits += 6;
        if (bits >= 8) {
            bits -= 8;
            if (o >= cap) return -1;
            out[o++] = (uint8_t)(acc >> bits);
        }
    }
    return (int)o;
}

// verify "BEARER <jwt>" against `key` and the request's base fid
// ("<vid>,<hexkey+cookie>" with any _delta stripped). Wildcard fid claims
// ("") are accepted, as the filer's tokens use them. Shared by the write
// path (jwt.signing.key) and the read path (jwt.signing.read.key) —
// `weed/server/volume_server_handlers.go:33-75` checks both the same way.
bool jwt_fid_ok(const std::string& key, const std::string& auth,
                const char* fid_path, size_t fid_len) {
    if (key.empty()) return true;
    if (strncasecmp(auth.c_str(), "BEARER ", 7) != 0) return false;
    const char* tok = auth.c_str() + 7;
    const char* dot1 = strchr(tok, '.');
    if (!dot1) return false;
    const char* dot2 = strchr(dot1 + 1, '.');
    if (!dot2) return false;
    // signature check first (constant-time-ish compare)
    uint8_t want[32], got[40];
    sw_hmac_sha256((const uint8_t*)key.data(), key.size(),
                   (const uint8_t*)tok, (size_t)(dot2 - tok), want);
    int got_n = b64url_decode(dot2 + 1, strlen(dot2 + 1), got, sizeof got);
    if (got_n != 32) return false;
    uint8_t diff = 0;
    for (int i = 0; i < 32; i++) diff |= want[i] ^ got[i];
    if (diff) return false;
    // claims: {"fid":"...","exp":N} (our own compact encoder)
    uint8_t payload[512];
    int pn = b64url_decode(dot1 + 1, (size_t)(dot2 - dot1 - 1), payload,
                           sizeof payload - 1);
    if (pn < 0) return false;
    payload[pn] = 0;
    const char* ps = (const char*)payload;
    const char* fp = strstr(ps, "\"fid\":");
    if (!fp) return false;
    fp += 6;
    while (*fp == ' ') fp++;
    if (*fp != '"') return false;
    fp++;
    const char* fe = strchr(fp, '"');
    if (!fe) return false;
    size_t claim_len = (size_t)(fe - fp);
    if (claim_len != 0) {  // empty claim = wildcard token
        // base fid: strip any _delta suffix from the request's fid part
        size_t base_len = fid_len;
        for (size_t i = 0; i < fid_len; i++)
            if (fid_path[i] == '_' || fid_path[i] == '.') { base_len = i; break; }
        if (claim_len != base_len || memcmp(fp, fid_path, base_len) != 0)
            return false;
    }
    const char* ep = strstr(ps, "\"exp\":");
    if (ep) {
        long long exp = atoll(ep + 6);
        if (exp > 0 && (long long)time(nullptr) > exp) return false;
    }
    return true;
}

// ---------------------------------------------------------------------------
// native /dir/assign (master fastlane)
// ---------------------------------------------------------------------------

// fid key+cookie hex per storage/file_id.py: the 8-byte key's leading zero
// BYTES are stripped (whole bytes, so always an even digit count), then the
// 8 cookie digits always follow
void format_fid_hex(uint64_t key, uint32_t cookie, char* out) {
    static const char* hexd = "0123456789abcdef";
    int lead = 0;
    while (lead < 8 && ((key >> (56 - 8 * lead)) & 0xFF) == 0) lead++;
    char* p = out;
    for (int i = lead; i < 8; i++) {
        uint8_t b = (key >> (56 - 8 * i)) & 0xFF;
        *p++ = hexd[b >> 4];
        *p++ = hexd[b & 0xF];
    }
    for (int i = 7; i >= 0; i--) *p++ = hexd[(cookie >> (4 * i)) & 0xF];
    *p = 0;
}

bool handle_assign(Engine* E, Conn* c, const char* query, size_t qlen) {
    std::shared_ptr<AssignProfile> ap;
    {
        std::shared_lock<std::shared_mutex> l(E->assign_mu);
        auto it = E->assigns.find(std::string(query, qlen));
        if (it == E->assigns.end()) return false;
        ap = it->second;
    }
    uint64_t key = ap->next_key.fetch_add(1, std::memory_order_relaxed);
    if (key >= ap->end_key) return false;  // lease spent: Python re-leases
    size_t vi = ap->rr.fetch_add(1, std::memory_order_relaxed) % ap->vids.size();
    // xorshift cookie seeded per call from the key + clock
    static thread_local uint64_t rng = 0x9e3779b97f4a7c15ull ^ now_ns();
    rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17;
    uint32_t cookie = (uint32_t)(rng ^ (rng >> 32));
    char hex[32];
    format_fid_hex(key, cookie, hex);
    char fid[48];
    int fl = snprintf(fid, sizeof fid, "%u,%s", ap->vids[vi], hex);
    std::string body = "{\"fid\": \"";
    body.append(fid, fl);
    body += "\", ";
    body += ap->tails[vi];
    json_response(c, 200, "OK", body);
    observe_op(E, c, kOpAssign, 0);
    E->stats.native_assigns++;
    return true;
}

// ---------------------------------------------------------------------------
// filer-mode plumbing
// ---------------------------------------------------------------------------

// entry frame, shared by the journal (crash replay) and the Python drain:
// u32 frame_len | u8 kind (0 chunk, 1 inline) | u8 pad[3] | u64 size |
// u64 mtime_sec | char md5_hex[32] | u16 path_len | u16 fid_len |
// u16 mime_len | u16 content_len | path | fid | mime | content
std::string filer_frame(uint8_t kind, uint64_t size, uint64_t mtime,
                        const char md5_hex[32], const std::string& path,
                        const std::string& fid, const std::string& mime,
                        const char* content, size_t content_len) {
    uint32_t total = 4 + 4 + 8 + 8 + 32 + 8 + (uint32_t)path.size() +
                     (uint32_t)fid.size() + (uint32_t)mime.size() +
                     (uint32_t)content_len;
    std::string f;
    f.reserve(total);
    auto le32 = [&](uint32_t v) { f.append((const char*)&v, 4); };
    auto le64 = [&](uint64_t v) { f.append((const char*)&v, 8); };
    auto le16 = [&](uint16_t v) { f.append((const char*)&v, 2); };
    le32(total);
    f.push_back((char)kind);
    f.append(3, '\0');
    le64(size);
    le64(mtime);
    f.append(md5_hex, 32);
    le16((uint16_t)path.size());
    le16((uint16_t)fid.size());
    le16((uint16_t)mime.size());
    le16((uint16_t)content_len);
    f += path;
    f += fid;
    f += mime;
    if (content_len) f.append(content, content_len);
    return f;
}

void md5_hex_of(const char* data, size_t len, char out_hex[33]) {
    unsigned char digest[16];
    const unsigned char* ptr = (const unsigned char*)data;
    size_t l = len;
    sw_md5_batch_var(&ptr, &l, 1, digest);
    static const char* hexd = "0123456789abcdef";
    for (int i = 0; i < 16; i++) {
        out_hex[2 * i] = hexd[digest[i] >> 4];
        out_hex[2 * i + 1] = hexd[digest[i] & 0xF];
    }
    out_hex[32] = 0;
}

// journal-before-ack (the filer analog of the volume engine writing .idx
// before acking): append the frame, then queue it for the Python drain.
// Returns false when the event backlog says Python stalled — the caller
// must proxy instead of acking writes nobody will ever apply.
bool filer_commit(Engine* E, const std::string& frame) {
    std::lock_guard<std::mutex> l(E->filer_mu);
    if (E->filer_events.size() >= 100000) return false;  // backpressure
    if (E->filer_journal_fd >= 0) {
        off_t before = lseek(E->filer_journal_fd, 0, SEEK_END);
        ssize_t wr = write(E->filer_journal_fd, frame.data(), frame.size());
        if (wr != (ssize_t)frame.size()) {
            // a torn frame mid-file would desynchronize crash replay once
            // later frames append after it — cut it off before proxying
            if (before >= 0) {
                if (ftruncate(E->filer_journal_fd, before) != 0) {
                    // can't restore a clean tail: stop journaling (and
                    // with it all native writes) rather than corrupt it
                    close(E->filer_journal_fd);
                    E->filer_journal_fd = -1;
                    E->filer_mode.store(false, std::memory_order_release);
                }
            }
            return false;
        }
    }
    E->filer_events.push_back(frame);
    E->filer_events_bytes += frame.size();
    return true;
}

void fcache_put(Engine* E, const std::string& path,
                std::shared_ptr<FilerCacheEnt> ent) {
    std::unique_lock<std::shared_mutex> l(E->fcache_mu);
    auto old = E->fcache.find(path);
    bool carried = false;
    if (old != E->fcache.end() && !old->second->inline_data.empty()) {
        if (ent->inline_data.empty() && old->second->md5_hex == ent->md5_hex) {
            // same entity (md5 = full-body hash), chunk-backed re-put —
            // a meta-log replay or Python-read cache refresh must not
            // DEMOTE a promoted object back to relaying (slow boxes hit
            // this every refresh; the promotion looked permanently hot
            // but quietly died). Carry the inline body over; its bytes
            // are already accounted in fcache_inline_bytes.
            ent->inline_data = old->second->inline_data;
            carried = true;
        } else {
            E->fcache_inline_bytes -= old->second->inline_data.size();
        }
    }
    if (!ent->inline_data.empty() && !carried)
        E->fcache_inline_bytes += ent->inline_data.size();
    ent->seq = ++E->fcache_seq;
    E->fcache_fifo.emplace_back(path, ent->seq);
    E->fcache[path] = std::move(ent);
    // FIFO eviction, bounding inline payload bytes AND total entry count
    // (chunk-backed entries cost a few hundred bytes each and a busy
    // filer touches millions of paths). A re-put leaves its old FIFO
    // slot behind as a stale (path, seq) pair — the seq check makes
    // popping it a no-op, and the queue itself is compacted whenever it
    // outgrows the live set so overwrite churn cannot leak queue slots.
    int budget = 64;  // amortized: each put cleans at most 64 queue slots
    while (!E->fcache_fifo.empty() && budget-- > 0) {
        bool over_bytes = E->fcache_inline_bytes > (128u << 20);
        bool over_count = E->fcache.size() > 1000000;
        bool over_fifo =
            E->fcache_fifo.size() > 2 * E->fcache.size() + 1024;
        if (!over_bytes && !over_count && !over_fifo) break;
        auto victim = std::move(E->fcache_fifo.front());
        E->fcache_fifo.pop_front();
        auto it = E->fcache.find(victim.first);
        if (it != E->fcache.end() && it->second->seq == victim.second) {
            if (over_bytes || over_count) {
                if (!it->second->inline_data.empty())
                    E->fcache_inline_bytes -= it->second->inline_data.size();
                E->fcache.erase(it);
            } else {
                // compaction only: rotate the live head to the back so the
                // stale slots behind it become poppable
                E->fcache_fifo.push_back(std::move(victim));
            }
        }
    }
}

// compare-and-promote: attach inline bytes to an existing chunk-backed
// entry, atomically against the meta-log subscriber's puts/dels — the
// check and the insert share one unique lock, so a racing overwrite's
// fresh entry (different md5) can never be clobbered by stale bytes
void fcache_promote(Engine* E, const std::string& path,
                    const std::string& md5_hex, const char* body,
                    size_t blen) {
    std::unique_lock<std::shared_mutex> l(E->fcache_mu);
    auto it = E->fcache.find(path);
    if (it == E->fcache.end()) return;
    auto& old = it->second;
    if (old->md5_hex != md5_hex || !old->inline_data.empty()) return;
    auto ent = std::make_shared<FilerCacheEnt>(*old);
    ent->inline_data.assign(body, blen);
    E->fcache_inline_bytes += blen;
    ent->seq = ++E->fcache_seq;
    E->fcache_fifo.emplace_back(path, ent->seq);
    it->second = std::move(ent);
    // budget enforcement happens on the next fcache_put pass; one
    // 64KB-capped promotion cannot meaningfully overshoot 128MB
}

void fcache_del(Engine* E, const std::string& path) {
    std::unique_lock<std::shared_mutex> l(E->fcache_mu);
    if (path.empty()) {
        E->fcache.clear();
        E->fcache_fifo.clear();
        E->fcache_inline_bytes = 0;
        return;
    }
    auto it = E->fcache.find(path);
    if (it != E->fcache.end()) {
        if (!it->second->inline_data.empty())
            E->fcache_inline_bytes -= it->second->inline_data.size();
        E->fcache.erase(it);
    }
}

// serve a cached INLINE entry straight from memory: ETag/304, single
// Range, Content-Type — the same surface filer.py _do_read produces
void filer_serve_inline(Engine* E, Conn* c,
                        const std::shared_ptr<FilerCacheEnt>& ent,
                        const char* req, size_t hdr_len, bool head) {
    const char* he = req + hdr_len;
    std::string etag = "\"" + ent->md5_hex + "\"";
    std::string extra = "Accept-Ranges: bytes\r\nETag: " + etag + "\r\n";
    {
        char lm[64];
        time_t t = (time_t)ent->mtime;
        struct tm g;
        gmtime_r(&t, &g);
        strftime(lm, sizeof lm, "Last-Modified: %a, %d %b %Y %H:%M:%S GMT\r\n",
                 &g);
        extra += lm;
    }
    std::string inm = find_header(req, he, "if-none-match");
    std::string ctype =
        ent->mime.empty() ? "application/octet-stream" : ent->mime;
    if (!inm.empty() && inm == etag) {
        append_response(c, 304, "Not Modified", ctype, extra, "", 0, false);
        observe_op(E, c, kOpRead, 0);
        E->stats.native_reads++;
        front_native_inc(E, kFrRead);
        return;
    }
    const std::string& data = ent->inline_data;
    int status = 200;
    size_t off = 0, n = data.size();
    std::string range = find_header(req, he, "range");
    if (!range.empty() && range.find(',') == std::string::npos) {
        long long start, end;
        int rr = parse_range_spec(range, data.size(), &start, &end);
        if (rr == 1) {  // valid syntax, unsatisfiable: filer.py sends 416
            char cr[64];
            snprintf(cr, sizeof cr, "Content-Range: bytes */%zu\r\n",
                     data.size());
            append_response(c, 416, "Range Not Satisfiable", "", cr, "", 0,
                            false);
            observe_op(E, c, kOpRead, 0);
            E->stats.native_reads++;
            front_native_inc(E, kFrRead);
            return;
        }
        if (rr == 0) {
            char cr[96];
            snprintf(cr, sizeof cr, "Content-Range: bytes %lld-%lld/%zu\r\n",
                     start, end, data.size());
            extra += cr;
            off = (size_t)start;
            n = (size_t)(end - start + 1);
            status = 206;
        }
    }
    if (head) {
        char cl[64];
        snprintf(cl, sizeof cl, "X-File-Size: %zu\r\n", data.size());
        extra += cl;
    }
    if (!head && n >= kZeroCopyMin) {
        // serve straight out of the cache entry: the shared_ptr pins the
        // bytes for the write's lifetime, no copy into the conn buffer
        respond_zc_pinned(
            c, status, status == 206 ? "Partial Content" : "OK", ctype,
            extra,
            std::shared_ptr<const void>(ent, (const void*)ent.get()),
            data.data() + off, n);
    } else {
        append_response(c, status, status == 206 ? "Partial Content" : "OK",
                        ctype, extra, data.data() + off, n, head);
    }
    observe_op(E, c, kOpRead, head ? 0 : n);
    E->stats.native_reads++;
    front_native_inc(E, kFrRead);
}

// finish a native filer write once the entry is journaled: cache + respond
void filer_write_ack(Engine* E, Conn* c, const std::string& path,
                     uint64_t size, const char* md5_hex) {
    std::string base = path.substr(path.rfind('/') + 1);
    std::string body = "{\"name\": \"";
    json_escape(base, body);
    char tail[96];
    snprintf(tail, sizeof tail, "\", \"size\": %llu, \"md5\": \"%.32s\"}",
             (unsigned long long)size, md5_hex);
    body += tail;
    json_response(c, 201, "Created", body);
    observe_op(E, c, kOpWrite, size);
    E->stats.native_writes++;
    front_native_inc(E, kFrWrite);
}

// mode-1 completion: the volume server answered the chunk upload
void filer_upload_finish(Engine* E, Worker* w, BackendConn* b, bool ok) {
    Conn* c = b->client;
    int status = 0;
    if (ok && b->resp.size() > 12 && memcmp(b->resp.data(), "HTTP/1.1 ", 9) == 0)
        status = atoi(b->resp.c_str() + 9);
    bool good = ok && status == 201;
    uint64_t mtime = (uint64_t)time(nullptr);
    if (good) {
        std::string frame =
            filer_frame(0, b->f_size, mtime, b->f_md5hex.c_str(), b->f_path,
                        b->f_fid, b->f_mime, nullptr, 0);
        good = filer_commit(E, frame);
    }
    if (good) {
        auto ent = std::make_shared<FilerCacheEnt>();
        ent->ip = b->target_ip;
        ent->port = b->target_port;
        ent->fid = b->f_fid;
        ent->mime = b->f_mime;
        ent->md5_hex = b->f_md5hex;
        ent->size = b->f_size;
        ent->mtime = mtime;
        fcache_put(E, b->f_path, std::move(ent));
    }
    if (c != nullptr && !good) {
        // the upload failed (volume down / moved / DELETED under the
        // lease — volume.delete.empty on a not-yet-written volume does
        // exactly this): drop the lease THAT MINTED THIS FID so Python
        // re-leases against live topology (the rest of the pool keeps
        // serving), and replay THIS request through the Python path so
        // the client still gets its write
        drop_filer_lease(E, b->f_lease);
        front_fb_inc(E, kFrWrite, kFbUpstream);
        Conn* cc = c;
        std::string original = std::move(b->client_req);
        backend_finish(w, b, false);
        drain_waiting(E, w);
        cc->upstream = nullptr;
        proxy_request(E, w, cc, original.data(), original.size(), false);
        flush_out(w, cc);
        return;
    }
    if (c != nullptr) {
        c->upstream = nullptr;
        filer_write_ack(E, c, b->f_path, b->f_size, b->f_md5hex.c_str());
    }
    backend_finish(w, b, ok && !b->backend_close);
    if (c != nullptr) {
        drain_buffered(E, w, c);
    }
}

void proxy_request(Engine* E, Worker* w, Conn* c, const char* req, size_t len,
                   bool bypass_cap);

// mode-2 completion: relay the volume response, ETag rewritten to the
// entry's md5 (what the Python filer serves); on any failure drop the
// cache entry and replay the original request through the Python path
void filer_relay_finish(Engine* E, Worker* w, BackendConn* b, bool ok) {
    Conn* c = b->client;
    int status = 0;
    if (ok && b->resp.size() > 12 && memcmp(b->resp.data(), "HTTP/1.1 ", 9) == 0)
        status = atoi(b->resp.c_str() + 9);
    if (ok && (status == 200 || status == 206 || status == 304) &&
        b->hdr_end != 0) {
        if (c != nullptr) {
            c->upstream = nullptr;
            // rewrite the ETag header inside the buffered head
            std::string head = b->resp.substr(0, b->hdr_end);
            size_t p = 0;
            bool replaced = false;
            while (p < head.size()) {
                size_t eol = head.find("\r\n", p);
                if (eol == std::string::npos) break;
                if (strncasecmp(head.c_str() + p, "etag:", 5) == 0) {
                    head.replace(p, eol - p, "ETag: \"" + b->f_md5hex + "\"");
                    replaced = true;
                    break;
                }
                p = eol + 2;
            }
            if (!replaced)
                head.insert(head.size() - 2,
                            "ETag: \"" + b->f_md5hex + "\"\r\n");
            if (b->f_mtime) {  // filer.py also serves Last-Modified
                char lm[64];
                time_t t = (time_t)b->f_mtime;
                struct tm g;
                gmtime_r(&t, &g);
                strftime(lm, sizeof lm,
                         "Last-Modified: %a, %d %b %Y %H:%M:%S GMT\r\n", &g);
                head.insert(head.size() - 2, lm);
            }
            size_t blen = b->resp.size() - b->hdr_end;
            observe_op(E, c, kOpRead, blen);
            E->stats.native_reads++;
            front_native_inc(E, kFrRead);
            // promote small hot objects: a FULL-entity, length-framed
            // relay body moves into the inline cache (same 128MB budget +
            // FIFO eviction, same meta-log invalidation), so repeat reads
            // skip the volume hop entirely. body_mode==1 only — chunked/
            // close-delimited responses carry framing or may be truncated.
            if (status == 200 && b->body_mode == 1 && blen > 0 &&
                blen <= 65536)
                fcache_promote(E, b->f_path, b->f_md5hex,
                               b->resp.data() + b->hdr_end, blen);
            c->out += head;
            if (blen >= kZeroCopyMin && c->out2_len == 0) {
                // relay body rides the zero-copy lane: the upstream
                // response buffer moves as-is, out2_data skips its head
                c->out2 = std::move(b->resp);
                c->out2_data = c->out2.data() + b->hdr_end;
                c->out2_len = blen;
                c->out2_off = 0;
            } else {
                c->out.append(b->resp, b->hdr_end, blen);
            }
        }
        backend_finish(w, b, !b->backend_close);
        drain_waiting(E, w);
        if (c != nullptr) {
            drain_buffered(E, w, c);
        }
        return;
    }
    // miss/moved/error: forget the location and let Python serve it
    fcache_del(E, b->f_path);
    front_fb_inc(E, kFrRead, kFbUpstream);
    std::string original = std::move(b->client_req);
    backend_finish(w, b, false);
    drain_waiting(E, w);
    if (c != nullptr) {
        c->upstream = nullptr;
        proxy_request(E, w, c, original.data(), original.size(), false);
        flush_out(w, c);
    }
}

// native filer write: inline entries commit synchronously; chunk-backed
// entries mint a leased fid and upload to the volume engine async.
// Returns false when any gate says the Python path must take it.
bool handle_filer_write(Engine* E, Worker* w, Conn* c,
                        const std::string& path, const char* req,
                        size_t hdr_len, const char* body, size_t body_len) {
    const char* he = req + hdr_len;
    std::string ctype = find_header(req, he, "content-type");
    const char* data = body;
    size_t dlen = body_len;
    std::string mime = ctype;
    auto fb = [&](int reason) {  // typed fallback: metric, then proxy
        front_fb_inc(E, kFrWrite, reason);
        return false;
    };
    if (ctype.rfind("multipart/form-data", 0) == 0) {
        std::string pn, pt;
        if (!multipart_first_file(ctype, body, body_len, &pn, &pt, &data,
                                  &dlen))
            return fb(kFbBodyShape);
        mime = pt;
    } else if (ctype.rfind("multipart/", 0) == 0) {
        return fb(kFbBodyShape);
    }
    if (mime == "application/x-www-form-urlencoded") mime.clear();
    if (mime.size() >= 250 || mime.find_first_of("\r\n") != std::string::npos)
        return fb(kFbBodyShape);
    if (path.size() > 60000) return fb(kFbOther);  // frame lengths are u16
    // the /etc/ config area (filer.conf, IAM, dedup index) must be
    // visible the moment the write acks — config consumers read through
    // Python, so skip the drain-delayed native path entirely. The system
    // meta-log tree emits NO meta events (filer_notify skips it), so a
    // natively-cached entry there could never be invalidated — skip too.
    if (path.compare(0, 5, "/etc/") == 0) return fb(kFbSystemPath);
    if (path.compare(0, 16, "/topics/.system/") == 0) return fb(kFbSystemPath);
    {
        // paths under an fs.configure rule prefix carry storage options
        // (collection/replication/ttl/read-only) that only the Python
        // write pipeline resolves
        std::shared_lock<std::shared_mutex> rl(E->frules_mu);
        for (const auto& pre : E->frule_prefixes)
            if (path.compare(0, pre.size(), pre) == 0)
                return fb(kFbSystemPath);
    }
    if (dlen <= E->filer_inline_limit) {
        // small-content inlining (filer.py SMALL_CONTENT_LIMIT): no volume
        // hop at all — journal, cache, ack
        char md5hex[33];
        md5_hex_of(data, dlen, md5hex);
        uint64_t mtime = (uint64_t)time(nullptr);
        std::string frame =
            filer_frame(1, dlen, mtime, md5hex, path, "", mime, data, dlen);
        if (!filer_commit(E, frame)) return fb(kFbBackpressure);
        auto ent = std::make_shared<FilerCacheEnt>();
        ent->inline_data.assign(data, dlen);
        ent->mime = mime;
        ent->md5_hex = md5hex;
        ent->size = dlen;
        ent->mtime = mtime;
        fcache_put(E, path, std::move(ent));
        filer_write_ack(E, c, path, dlen, md5hex);
        return true;
    }
    if (dlen > E->filer_chunk_limit)
        return fb(kFbTooLarge);  // multi-chunk: Python
    if (E->filer_compress) {
        // the Python pipeline compresses by mime AND by extension
        // (util/compression.py is_compressable_file_type); anything its
        // heuristic might gzip must take the Python path
        if (!mime.empty() && mime != "application/octet-stream")
            return fb(kFbBodyShape);
        size_t dot = path.rfind('.');
        size_t slash = path.rfind('/');
        if (dot != std::string::npos &&
            (slash == std::string::npos || dot > slash)) {
            std::string ext = path.substr(dot);
            for (auto& ch : ext) ch = (char)tolower((unsigned char)ch);
            static const char* kTextExt[] = {
                ".csv", ".txt", ".json", ".xml", ".html", ".htm", ".css",
                ".js", ".log", ".md", ".yaml", ".yml", ".toml", ".svg",
                ".conf", ".ini", ".py", ".go", ".java", ".c", ".cpp", ".h",
                ".rs", ".ts", ".sql", ".sh", ".pdf",
            };
            for (const char* t : kTextExt)
                if (ext == t) return fb(kFbBodyShape);
        }
    }
    uint64_t key = 0;
    int lease_reason = kFbNoLease;
    std::shared_ptr<FilerLease> L = take_filer_lease(E, &key, &lease_reason);
    if (!L) return fb(lease_reason);
    char hex[32];
    format_fid_hex(key, L->cookie, hex);
    char fid[48];
    int fl = snprintf(fid, sizeof fid, "%u,%s", L->vid, hex);
    char md5hex[33];
    md5_hex_of(data, dlen, md5hex);
    auto* b = new BackendConn();
    b->client = c;
    b->mode = 1;
    b->target_ip = L->vol_ip;
    b->target_port = L->vol_port;
    b->f_lease = L;  // a failed upload drops exactly this lease
    // kept for the failure path: a dead/moved/deleted lease volume makes
    // the finisher replay this request through the Python backend
    b->client_req.assign(req, hdr_len + body_len);
    b->f_path = path;
    b->f_fid.assign(fid, fl);
    b->f_mime = mime;
    b->f_md5hex = md5hex;
    b->f_size = dlen;
    b->f_trace = parse_trace_id(find_header(req, he, "x-sw-trace-id"));
    b->started = time(nullptr);
    std::string& r = b->req;
    r.reserve(dlen + 256 + path.size());
    r = "POST /";
    r.append(fid, fl);
    r += " HTTP/1.1\r\nHost: v\r\n";
    std::string base = path.substr(path.rfind('/') + 1);
    if (!base.empty() && base.size() < 250 &&
        base.find_first_of("\r\n") == std::string::npos) {
        r += "X-File-Name: ";
        r += base;
        r += "\r\n";
    }
    if (!mime.empty()) {
        r += "Content-Type: ";
        r += mime;
        r += "\r\n";
    }
    if (!L->auth.empty()) {
        r += "Authorization: ";
        r += L->auth;
        r += "\r\n";
    }
    if (b->f_trace) {
        // the volume engine stamps this id on its append event, so the
        // drain-synthesized span joins the caller's trace end to end
        char th[48];
        snprintf(th, sizeof th, "X-Sw-Trace-Id: %016llx\r\n",
                 (unsigned long long)b->f_trace);
        r += th;
    }
    char cl[48];
    snprintf(cl, sizeof cl, "Content-Length: %zu\r\n\r\n", dlen);
    r += cl;
    r.append(data, dlen);
    c->upstream = b;
    if (!backend_launch(E, w, b)) {
        c->upstream = nullptr;
        delete b;
        return fb(kFbUpstream);  // volume unreachable: Python's surface
    }
    w->pending.push_back(b);
    return true;
}

// native filer read of a chunk-backed entry: relay to the volume engine
void filer_relay_launch(Engine* E, Worker* w, Conn* c,
                        const std::shared_ptr<FilerCacheEnt>& ent,
                        const std::string& path, const char* req,
                        size_t req_len, size_t hdr_len) {
    auto* b = new BackendConn();
    b->client = c;
    b->mode = 2;
    b->target_ip = ent->ip;
    b->target_port = ent->port;
    b->f_path = path;
    b->f_md5hex = ent->md5_hex;
    b->f_mtime = ent->mtime;
    b->client_req.assign(req, req_len);
    b->started = time(nullptr);
    std::string& r = b->req;
    r = "GET /" + ent->fid + " HTTP/1.1\r\nHost: v\r\n";
    const char* he = req + hdr_len;
    std::string range = find_header(req, he, "range");
    if (!range.empty()) {
        r += "Range: ";
        r += range;
        r += "\r\n";
    }
    {
        std::shared_lock<std::shared_mutex> l(E->flease_mu);
        if (!E->filer_read_auth.empty()) {
            r += "Authorization: ";
            r += E->filer_read_auth;
            r += "\r\n";
        }
    }
    r += "\r\n";
    c->upstream = b;
    if (!backend_launch(E, w, b)) {
        c->upstream = nullptr;
        delete b;
        front_fb_inc(E, kFrRead, kFbUpstream);
        proxy_request(E, w, c, req, req_len, false);
        return;
    }
    w->pending.push_back(b);
}

// native filer DELETE: known (cached) file entries tombstone + journal +
// ack without a Python hop — the same journal-before-ack contract as the
// write path, with frame kind 2 applied as Filer.delete_entry by the
// drain. Returns false when the Python path must take it (with the typed
// fallback reason counted).
bool handle_filer_delete(Engine* E, Conn* c, const std::string& path) {
    auto fb = [&](int reason) {
        front_fb_inc(E, kFrDelete, reason);
        return false;
    };
    // config-area deletes must be visible to Python consumers the moment
    // they ack; fs.configure prefixes may be read_only (Python enforces)
    if (path.compare(0, 5, "/etc/") == 0) return fb(kFbSystemPath);
    if (path.compare(0, 16, "/topics/.system/") == 0)
        return fb(kFbSystemPath);
    if (path.size() > 60000) return fb(kFbOther);
    {
        std::shared_lock<std::shared_mutex> rl(E->frules_mu);
        for (const auto& pre : E->frule_prefixes)
            if (path.compare(0, pre.size(), pre) == 0)
                return fb(kFbSystemPath);
    }
    std::shared_ptr<FilerCacheEnt> ent;
    {
        std::shared_lock<std::shared_mutex> l(E->fcache_mu);
        auto it = E->fcache.find(path);
        if (it != E->fcache.end()) ent = it->second;
    }
    // only entries the cache KNOWS to be plain files delete natively —
    // a miss could be a directory (recursive semantics) or a missing
    // path (409 surface); Python answers those exactly
    if (ent == nullptr) return fb(kFbCacheMiss);
    if (ent->tombstone) {
        // double-delete before the drain lands: Python would 409 "not
        // found" — route it there for the exact surface
        return fb(kFbCacheMiss);
    }
    static const char kZeroMd5[33] = "00000000000000000000000000000000";
    uint64_t mtime = (uint64_t)time(nullptr);
    std::string frame =
        filer_frame(2, ent->size, mtime, kZeroMd5, path, "", "", nullptr, 0);
    if (!filer_commit(E, frame)) return fb(kFbBackpressure);
    auto tomb = std::make_shared<FilerCacheEnt>();
    tomb->tombstone = true;
    tomb->size = ent->size;
    tomb->mtime = mtime;
    fcache_put(E, path, std::move(tomb));
    append_response(c, 204, "No Content", "", "", "", 0, false);
    observe_op(E, c, kOpDelete, 0);
    E->stats.native_deletes++;
    front_native_inc(E, kFrDelete);
    return true;
}

// ---------------------------------------------------------------------------
// s3 front mode: protocol-translating relays onto the FILER's engine front
// door. The gateway's Python surface keeps everything stateful (sigv4,
// policies, versioning, ACLs, CORS, x-amz metadata); the engine serves the
// gated plain-object subset — which is the bench/production hot path — by
// rewriting /bucket/key <-> /buckets/bucket/key and translating status
// codes, so object bytes never cross the GIL.
// ---------------------------------------------------------------------------

void xml_escape(const std::string& s, std::string& out) {
    for (char ch : s) {
        switch (ch) {
            case '<': out += "&lt;"; break;
            case '>': out += "&gt;"; break;
            case '&': out += "&amp;"; break;
            default: out += ch;
        }
    }
}

// same XML error surface s3_server.py error_response produces
void s3_error_response(Conn* c, int status, const char* reason,
                       const char* code, const char* msg,
                       const std::string& resource) {
    std::string body =
        "<?xml version=\"1.0\" encoding=\"UTF-8\"?><Error><Code>";
    body += code;
    body += "</Code><Message>";
    body += msg;
    body += "</Message><Resource>";
    xml_escape(resource, body);
    body += "</Resource></Error>";
    append_response(c, status, reason, "application/xml", "", body.data(),
                    body.size(), false);
}

// replay the original client request through the Python S3 surface (the
// filer answered something the translation table doesn't cover)
void s3_replay_python(Engine* E, Worker* w, BackendConn* b, int frop) {
    front_fb_inc(E, frop, kFbUpstream);
    Conn* c = b->client;
    std::string original = std::move(b->client_req);
    backend_finish(w, b, false);
    drain_waiting(E, w);
    if (c != nullptr) {
        c->upstream = nullptr;
        proxy_request(E, w, c, original.data(), original.size(), false);
        flush_out(w, c);
    }
}

void s3_finish_common(Engine* E, Worker* w, BackendConn* b, Conn* c) {
    backend_finish(w, b, !b->backend_close);
    drain_waiting(E, w);
    if (c != nullptr) {
        drain_buffered(E, w, c);
    }
}

// mode 3: object GET — the filer front's response is already S3-shaped
// (ETag = "md5", Content-Type, Accept-Ranges, Last-Modified); forward its
// head verbatim and the body zero-copy
void s3_get_finish(Engine* E, Worker* w, BackendConn* b, bool ok) {
    Conn* c = b->client;
    int status = 0;
    if (ok && b->resp.size() > 12 &&
        memcmp(b->resp.data(), "HTTP/1.1 ", 9) == 0)
        status = atoi(b->resp.c_str() + 9);
    if (ok && b->hdr_end != 0 &&
        (status == 200 || status == 206 || status == 304)) {
        if (c != nullptr) {
            c->upstream = nullptr;
            size_t blen = b->resp.size() - b->hdr_end;
            observe_op(E, c, kOpRead, blen);
            E->stats.native_reads++;
            front_native_inc(E, kFrRead);
            if (blen >= kZeroCopyMin && c->out2_len == 0) {
                c->out.append(b->resp, 0, b->hdr_end);
                c->out2 = std::move(b->resp);
                c->out2_data = c->out2.data() + b->hdr_end;
                c->out2_len = blen;
                c->out2_off = 0;
            } else {
                c->out += b->resp;
            }
        }
        s3_finish_common(E, w, b, c);
        return;
    }
    if (ok && b->hdr_end != 0 && status == 404) {
        if (c != nullptr) {
            c->upstream = nullptr;
            s3_error_response(c, 404, "Not Found", "NoSuchKey",
                              "no such key", b->f_path);
            observe_op(E, c, kOpRead, 0);
            E->stats.native_reads++;
            front_native_inc(E, kFrRead);
        }
        s3_finish_common(E, w, b, c);
        return;
    }
    s3_replay_python(E, w, b, kFrRead);
}

// mode 4: object/part PUT — filer 201 becomes S3 200 with the ETag the
// engine already computed (md5 of the body, exactly hashlib.md5 in
// _put_object/_upload_part)
void s3_put_finish(Engine* E, Worker* w, BackendConn* b, bool ok) {
    Conn* c = b->client;
    int status = 0;
    if (ok && b->resp.size() > 12 &&
        memcmp(b->resp.data(), "HTTP/1.1 ", 9) == 0)
        status = atoi(b->resp.c_str() + 9);
    if (ok && b->hdr_end != 0 && status == 201) {
        if (c != nullptr) {
            c->upstream = nullptr;
            std::string extra = "ETag: \"" + b->f_md5hex + "\"\r\n";
            append_response(c, 200, "OK", "", extra, "", 0, false);
            observe_op(E, c, kOpWrite, b->f_size);
            E->stats.native_writes++;
            front_native_inc(E, kFrWrite);
        }
        s3_finish_common(E, w, b, c);
        return;
    }
    s3_replay_python(E, w, b, kFrWrite);
}

// mode 5: object DELETE — S3 answers 204 whether or not the key existed,
// so success and 404 translate to 204. A 409 is NOT accepted: the filer
// answers 409 both for a missing entry AND for a non-empty directory, and
// the Python path deletes directories recursively (fc.delete
// recursive=True) — acking 409 as 204 would silently no-op a subtree
// delete the slow path executes. Python resolves both 409 flavors to the
// right outcome, so replay instead.
void s3_delete_finish(Engine* E, Worker* w, BackendConn* b, bool ok) {
    Conn* c = b->client;
    int status = 0;
    if (ok && b->resp.size() > 12 &&
        memcmp(b->resp.data(), "HTTP/1.1 ", 9) == 0)
        status = atoi(b->resp.c_str() + 9);
    if (ok && b->hdr_end != 0 && (status < 300 || status == 404)) {
        if (c != nullptr) {
            c->upstream = nullptr;
            append_response(c, 204, "No Content", "", "", "", 0, false);
            observe_op(E, c, kOpDelete, 0);
            E->stats.native_deletes++;
            front_native_inc(E, kFrDelete);
        }
        s3_finish_common(E, w, b, c);
        return;
    }
    s3_replay_python(E, w, b, kFrDelete);
}

// gate + launch for one s3-front request; returns false when the request
// must take the Python path (typed fallback reason counted by the caller
// only for transport failures — gates count their own)
bool handle_s3_front(Engine* E, Worker* w, Conn* c, const std::string& method,
                     const char* req, size_t req_len, size_t hdr_len,
                     const char* body, size_t body_len, const char* path,
                     const char* fid_end, const char* qmark,
                     const char* path_end) {
    const char* he = req + hdr_len;
    int frop = method == "GET" ? kFrRead
               : method == "DELETE" ? kFrDelete
                                    : kFrWrite;
    auto fb = [&](int reason) {
        front_fb_inc(E, frop, reason);
        return false;
    };
    // /<bucket>/<key...>: both parts non-empty, canonical (the Python side
    // normalizes/unquotes anything else). Bucket-level requests are
    // namespace ops, not object traffic — they proxy without front-door
    // accounting.
    std::string pstr(path, fid_end - path);
    if (pstr.size() < 4 || pstr[0] != '/') return false;
    size_t slash = pstr.find('/', 1);
    if (slash == std::string::npos || slash + 1 >= pstr.size())
        return false;  // bucket-level op
    if (pstr.back() == '/') return fb(kFbOther);  // directory-style key
    if (pstr.find('%') != std::string::npos ||
        pstr.find("//") != std::string::npos ||
        pstr.find("/./") != std::string::npos ||
        pstr.find("/../") != std::string::npos)
        return fb(kFbOther);
    std::string bucket = pstr.substr(1, slash - 1);
    if (bucket == "." || bucket.find('.') == 0) return fb(kFbOther);
    // signed requests need sigv4 (Python); Origin-carrying ones need the
    // bucket's CORS decoration; x-amz-* semantics (meta, copy, streaming
    // bodies, tagging, acl) all live in the Python handlers
    if (!find_header(req, he, "authorization").empty()) return fb(kFbAuth);
    if (!find_header(req, he, "origin").empty()) return fb(kFbOther);
    {
        const char* p = req;
        while (p < he) {
            const char* eol = (const char*)memchr(p, '\n', he - p);
            if (!eol) break;
            if (eol - p >= 6 && strncasecmp(p, "x-amz-", 6) == 0 &&
                strncasecmp(p, "x-amz-date:", 11) != 0 &&
                strncasecmp(p, "x-amz-content-sha256:", 21) != 0)
                return fb(kFbBodyShape);
            p = eol + 1;
        }
        // streaming-framed bodies need Python's deframer
        if (find_header(req, he, "x-amz-content-sha256")
                .rfind("STREAMING-", 0) == 0)
            return fb(kFbBodyShape);
        // multipart/form-data bodies are browser POST-policy territory
        if (find_header(req, he, "content-type").rfind("multipart/", 0) == 0)
            return fb(kFbBodyShape);
    }
    // query: only the multipart part-upload shape is served natively
    std::string up_path;  // filer-side target path
    if (qmark != nullptr) {
        if (method != "PUT") return fb(kFbQuery);
        std::string q(qmark + 1, path_end - qmark - 1);
        long part_num = -1;
        std::string upload_id;
        size_t pos = 0;
        bool clean = true;
        while (pos < q.size()) {
            size_t amp = q.find('&', pos);
            if (amp == std::string::npos) amp = q.size();
            std::string kv = q.substr(pos, amp - pos);
            if (kv.rfind("partNumber=", 0) == 0) {
                const char* v = kv.c_str() + 11;
                char* endp = nullptr;
                part_num = strtol(v, &endp, 10);
                if (endp == v || *endp != 0) clean = false;
            } else if (kv.rfind("uploadId=", 0) == 0) {
                upload_id = kv.substr(9);
            } else {
                clean = false;
            }
            pos = amp + 1;
        }
        if (!clean || part_num < 1 || part_num > 10000 || upload_id.empty()
            || upload_id.find_first_not_of(
                   "0123456789abcdefABCDEF") != std::string::npos)
            return fb(kFbQuery);
        {
            std::shared_lock<std::shared_mutex> l(E->s3_mu);
            if (E->s3_uploads.find(bucket + "/" + upload_id) ==
                E->s3_uploads.end())
                return fb(kFbBucketState);  // unknown upload: NoSuchUpload
        }
        char part[16];
        snprintf(part, sizeof part, "%05ld.part", part_num);
        up_path = "/buckets/" + bucket + "/.uploads/" + upload_id + "/" +
                  part;
    }
    // bucket gate: Python installs flags only for buckets whose state the
    // native path can honor (exists, open IAM, no policy/versioning/
    // read-only/meta history) and re-validates them continuously
    int need = frop == kFrRead ? kS3Read
               : frop == kFrWrite ? kS3Write
                                  : kS3Delete;
    {
        std::shared_lock<std::shared_mutex> l(E->s3_mu);
        auto it = E->s3_buckets.find(bucket);
        if (it == E->s3_buckets.end() || (it->second & need) == 0)
            return fb(kFbBucketState);
    }
    if (up_path.empty()) up_path = "/buckets" + pstr;

    auto* b = new BackendConn();
    b->client = c;
    b->target_ip = E->s3_filer_ip;
    b->target_port = E->s3_filer_port;
    b->client_req.assign(req, req_len);
    b->f_path = pstr;
    b->started = time(nullptr);
    std::string& r = b->req;
    if (frop == kFrRead) {
        b->mode = 3;
        r = "GET " + up_path + " HTTP/1.1\r\nHost: f\r\nX-Sw-S3: 1\r\n";
        std::string range = find_header(req, he, "range");
        if (range.find(',') != std::string::npos) {
            delete b;
            return fb(kFbBodyShape);  // multi-range: Python's surface
        }
        if (!range.empty()) r += "Range: " + range + "\r\n";
        std::string inm = find_header(req, he, "if-none-match");
        if (!inm.empty()) r += "If-None-Match: " + inm + "\r\n";
        r += "\r\n";
    } else if (frop == kFrWrite) {
        b->mode = 4;
        char md5hex[33];
        md5_hex_of(body, body_len, md5hex);
        b->f_md5hex = md5hex;
        b->f_size = body_len;
        r.reserve(body_len + 256);
        r = "PUT " + up_path + " HTTP/1.1\r\nHost: f\r\nX-Sw-S3: 1\r\n";
        std::string ctype = find_header(req, he, "content-type");
        if (!ctype.empty() && ctype.size() < 250 &&
            ctype.find_first_of("\r\n") == std::string::npos)
            r += "Content-Type: " + ctype + "\r\n";
        char cl[48];
        snprintf(cl, sizeof cl, "Content-Length: %zu\r\n\r\n", body_len);
        r += cl;
        r.append(body, body_len);
    } else {
        b->mode = 5;
        r = "DELETE " + up_path +
            " HTTP/1.1\r\nHost: f\r\nX-Sw-S3: 1\r\n\r\n";
    }
    c->upstream = b;
    if (!backend_launch(E, w, b)) {
        c->upstream = nullptr;
        delete b;
        return fb(kFbUpstream);  // filer unreachable: Python's surface
    }
    w->pending.push_back(b);
    return true;
}

// ---------------------------------------------------------------------------
// request dispatch
// ---------------------------------------------------------------------------

// handles one complete buffered request [req, req+req_len) whose headers end
// at hdr_len; body follows. Returns nothing — always produces output bytes.
void dispatch(Engine* E, Worker* w, Conn* c, const char* req, size_t req_len,
              size_t hdr_len, const char* body, size_t body_len) {
    E->stats.requests++;
    c->req_start_ns = mono_ns();
    if (!c->cn_ok) {
        // CA-valid client cert with a disallowed CommonName: same per-request
        // 403 surface the Python gate produces (httpd.py _dispatch)
        json_response(c, 403, "Forbidden",
                      "{\"error\": \"client certificate CN not allowed\"}");
        return;
    }
    const char* line_end = (const char*)memchr(req, '\r', hdr_len);
    if (!line_end) { c->want_close = true; return; }
    const char* sp1 = (const char*)memchr(req, ' ', line_end - req);
    if (!sp1) { c->want_close = true; return; }
    const char* sp2 = (const char*)memchr(sp1 + 1, ' ', line_end - sp1 - 1);
    if (!sp2) { c->want_close = true; return; }
    std::string method(req, sp1 - req);
    const char* path = sp1 + 1;
    const char* path_end = sp2;
    const char* qmark = (const char*)memchr(path, '?', path_end - path);
    const char* fid_end = qmark ? qmark : path_end;
    bool has_query = qmark != nullptr;
    const char* he = req + hdr_len;

    if (method == "GET" && (size_t)(fid_end - path) == 11 &&
        memcmp(path, "/dir/assign", 11) == 0) {
        const char* q = has_query ? qmark + 1 : "";
        size_t qlen = has_query ? (size_t)(path_end - qmark - 1) : 0;
        if (handle_assign(E, c, q, qlen)) return;
        proxy_request(E, w, c, req, req_len);  // miss/spent: Python (re)installs
        return;
    }

    // long-poll surfaces: filer meta subscriptions and any wait= query
    bool bypass_cap = false;
    if ((size_t)(fid_end - path) >= 10 && memcmp(path, "/__meta__/", 10) == 0)
        bypass_cap = true;
    else if (has_query) {
        size_t qn = (size_t)(path_end - qmark - 1);
        const char* q = qmark + 1;
        for (size_t i = 0; i + 5 <= qn; i++)
            if (memcmp(q + i, "wait=", 5) == 0 &&
                (i == 0 || q[i - 1] == '&')) {
                bypass_cap = true;
                break;
            }
    }

    // filer mode: serve the path namespace natively where the cache/lease
    // allow; every gate failure counts a typed fallback reason and falls
    // through to the Python proxy below. Percent-escapes and dot-segments
    // would need Python's normalize(); such paths (rare) always proxy so
    // cache keys stay canonical. Directory listings (trailing /) are
    // namespace ops, not chunk traffic — excluded from the accounting.
    if (E->filer_mode.load(std::memory_order_relaxed) && path < fid_end &&
        path[0] == '/' && fid_end[-1] != '/' &&
        !((size_t)(fid_end - path) >= 3 && memcmp(path, "/__", 3) == 0) &&
        (method == "GET" || method == "HEAD" || method == "POST" ||
         method == "PUT" || method == "DELETE")) {
        int frop = (method == "GET" || method == "HEAD") ? kFrRead
                   : method == "DELETE"                  ? kFrDelete
                                                         : kFrWrite;
        std::string pstr(path, fid_end - path);
        bool canonical = pstr.find('%') == std::string::npos &&
                         pstr.find("//") == std::string::npos &&
                         pstr.find("/./") == std::string::npos &&
                         pstr.find("/../") == std::string::npos;
        if (has_query) {
            front_fb_inc(E, frop, kFbQuery);
        } else if (!canonical) {
            front_fb_inc(E, frop, kFbOther);
        } else if (frop == kFrRead) {
            std::shared_ptr<FilerCacheEnt> ent;
            {
                std::shared_lock<std::shared_mutex> l(E->fcache_mu);
                auto it = E->fcache.find(pstr);
                if (it != E->fcache.end()) ent = it->second;
            }
            if (ent == nullptr) {
                front_fb_inc(E, frop, kFbCacheMiss);
            } else if (ent->tombstone) {
                // natively-acked DELETE whose drain hasn't landed yet:
                // read-your-deletes must hold on every engine core, so
                // the tombstone answers 404 instead of proxying into the
                // still-stale Python store
                append_response(c, 404, "Not Found", "", "", "", 0, false);
                observe_op(E, c, kOpRead, 0);
                E->stats.native_reads++;
                front_native_inc(E, kFrRead);
                return;
            } else {
                if (!ent->inline_data.empty()) {
                    filer_serve_inline(E, c, ent, req, hdr_len,
                                       method == "HEAD");
                    return;
                }
                std::string range = find_header(req, he, "range");
                bool multi = range.find(',') != std::string::npos;
                std::string inm = find_header(req, he, "if-none-match");
                if (!inm.empty() && inm == "\"" + ent->md5_hex + "\"") {
                    append_response(c, 304, "Not Modified", "",
                                    "ETag: " + inm + "\r\n", "", 0, false);
                    observe_op(E, c, kOpRead, 0);
                    E->stats.native_reads++;
                    front_native_inc(E, kFrRead);
                    return;
                }
                if (!range.empty() && !multi) {
                    // unsatisfiable ranges 416 here (filer.py semantics);
                    // the volume engine would serve the full entity and
                    // the answer must not depend on cache state
                    long long rs, re2;
                    if (parse_range_spec(range, ent->size, &rs, &re2) == 1) {
                        char cr[64];
                        snprintf(cr, sizeof cr,
                                 "Content-Range: bytes */%llu\r\n",
                                 (unsigned long long)ent->size);
                        append_response(c, 416, "Range Not Satisfiable", "",
                                        cr, "", 0, false);
                        observe_op(E, c, kOpRead, 0);
                        E->stats.native_reads++;
                        front_native_inc(E, kFrRead);
                        return;
                    }
                }
                if (method == "GET" && !multi) {
                    filer_relay_launch(E, w, c, ent, pstr, req, req_len,
                                       hdr_len);
                    return;
                }
                front_fb_inc(E, frop, kFbBodyShape);  // HEAD/multi-range
            }
        } else if (frop == kFrWrite) {
            if (handle_filer_write(E, w, c, pstr, req, hdr_len, body,
                                   body_len))
                return;
            // handle_filer_write counted its own fallback reason
        } else if (handle_filer_delete(E, c, pstr)) {
            return;
        }
    }

    // s3 front mode: gated object GET/PUT/DELETE relays to the filer
    // engine; everything else (bucket ops, auth'd/versioned/meta'd
    // requests) proxies to the Python S3 surface below
    if (E->s3_mode.load(std::memory_order_relaxed) &&
        (method == "GET" || method == "PUT" || method == "DELETE")) {
        if (handle_s3_front(E, w, c, method, req, req_len, hdr_len, body,
                            body_len, path, fid_end, qmark, path_end))
            return;
    }

    uint32_t vid; uint64_t key; uint32_t cookie;
    bool is_fid = path < fid_end && path[0] == '/' &&
                  parse_fid(path + 1, fid_end, &vid, &key, &cookie);
    if (is_fid) {
        auto v = E->vol(vid);
        if (method == "GET" || method == "HEAD") {
            std::string range = find_header(req, he, "range");
            bool multi = range.find(',') != std::string::npos;
            // secure_reads with a key: verify the read JWT natively so
            // hardened clusters keep the native plane; a missing/invalid
            // token proxies to Python for its exact 401 body. ?jwt= query
            // tokens also proxy (has_query), header tokens stay native.
            bool read_ok = !E->secure_reads;
            if (!read_ok && !E->jwt_read_key.empty())
                read_ok = jwt_fid_ok(E->jwt_read_key,
                                     find_header(req, he, "authorization"),
                                     path + 1,
                                     (size_t)(fid_end - path - 1));
            if (v && !has_query && !multi && read_ok) {
                if (handle_read(E, c, v, key, cookie, method == "HEAD",
                                range))
                    return;
            }
            proxy_request(E, w, c, req, req_len, bypass_cap);
            return;
        }
        if (method == "POST" || method == "PUT") {
            // cheap gates first: a request the proxy will take anyway
            // must not pay body parsing
            bool exists = false;
            if (v) {
                uint64_t off_; int32_t size_;
                std::shared_lock<std::shared_mutex> l(v->map_mu);
                exists = v->nmap.get(key, &off_, &size_) && size_ > 0;
            }
            bool jwt_ok = true;
            if (!E->jwt_write_key.empty())
                jwt_ok = jwt_fid_ok(E->jwt_write_key,
                                    find_header(req, he, "authorization"),
                                      path + 1, (size_t)(fid_end - path - 1));
            bool gates_ok = v && !has_query && !exists && jwt_ok &&
                            !E->secure_writes && !v->readonly.load() &&
                            !v->forward_writes.load();
            if (!gates_ok) {
                proxy_request(E, w, c, req, req_len, bypass_cap);
                return;
            }
            std::string ctype = find_header(req, he, "content-type");
            std::string fname = find_header(req, he, "x-file-name");
            const char* wdata = body;
            size_t wlen = body_len;
            std::string mime = ctype;
            bool is_multipart = ctype.rfind("multipart/form-data", 0) == 0;
            bool unsupported =
                !is_multipart && ctype.rfind("multipart/", 0) == 0;
            if (is_multipart) {
                // curl -F / browser-form uploads: extract the file part
                // natively (the reference's own clients upload this way)
                std::string part_name, part_type;
                if (multipart_first_file(ctype, body, body_len, &part_name,
                                         &part_type, &wdata, &wlen)) {
                    fname = part_name;
                    mime = part_type;
                } else {
                    unsupported = true;  // no file part: Python's error path
                }
            } else {
                // header-mime branch only (volume.py _do_write): form and
                // json defaults are transport noise, not the blob's type
                if (mime == "application/json" ||
                    mime == "application/x-www-form-urlencoded")
                    mime.clear();
            }
            bool jpg = false;
            {
                std::string lower = fname;
                for (auto& ch : lower) ch = tolower(ch);
                if (lower.size() >= 4 &&
                    (lower.rfind(".jpg") == lower.size() - 4 ||
                     (lower.size() >= 5 && lower.rfind(".jpeg") == lower.size() - 5)))
                    jpg = true;
                if (mime == "image/jpeg") jpg = true;
            }
            if (!unsupported && !jpg) {
                if (mime == "application/octet-stream" || mime.size() >= 256)
                    mime.clear();  // common needle-set rule (both branches)
                if (handle_write(E, c, v, key, cookie, wdata, wlen, fname,
                                 mime,
                                 parse_trace_id(
                                     find_header(req, he, "x-sw-trace-id"))))
                    return;
            }
            proxy_request(E, w, c, req, req_len, bypass_cap);
            return;
        }
        if (method == "DELETE") {
            bool jwt_ok = true;
            if (!E->jwt_write_key.empty())
                jwt_ok = jwt_fid_ok(E->jwt_write_key,
                                    find_header(req, he, "authorization"),
                                      path + 1, (size_t)(fid_end - path - 1));
            if (v && !has_query && jwt_ok && !E->secure_writes &&
                !v->readonly.load() && !v->forward_writes.load()) {
                if (handle_delete(E, c, v, key, cookie,
                                  parse_trace_id(find_header(
                                      req, he, "x-sw-trace-id"))))
                    return;
            }
            proxy_request(E, w, c, req, req_len, bypass_cap);
            return;
        }
    }
    proxy_request(E, w, c, req, req_len, bypass_cap);
}

// ---------------------------------------------------------------------------
// event loop
// ---------------------------------------------------------------------------

// closes the socket and queues the Conn for deferred deletion — other
// epoll events in the same wait batch may still point at it, so the object
// must stay alive until the next loop pass
void close_conn(Worker* w, Conn* c) {
    if (c->fd >= 0) {
        if (c->upstream != nullptr) {
            // orphan the in-flight (or still-queued) proxy; it completes
            // into the void and its backend conn is not reused
            c->upstream->client = nullptr;
            c->upstream = nullptr;
        }
        if (c->ssl != nullptr) {
            TlsApi* T = tls_api();
            T->SSL_shutdown(c->ssl);  // best-effort close_notify
            T->SSL_free(c->ssl);
            c->ssl = nullptr;
        }
        epoll_ctl(w->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
        close(c->fd);
        c->fd = -1;
        std::lock_guard<std::mutex> l(w->conns_mu);
        for (size_t i = 0; i < w->conns.size(); i++)
            if (w->conns[i] == c) {
                w->conns[i] = w->conns.back();
                w->conns.pop_back();
                break;
            }
        w->graveyard.push_back(c);
    }
}

void flush_out(Worker* w, Conn* c) {
    // two output lanes: `out` (headers + small bodies, always first) and
    // the zero-copy body channel out2. Plaintext sockets push both with a
    // single sendmsg (writev) so a native read costs one syscall and zero
    // body memcpys; TLS writes them sequentially through SSL_write.
    for (;;) {
        bool have_hdr = c->out_off < c->out.size();
        bool have_body = c->out2_off < c->out2_len;
        if (!have_hdr && !have_body) break;
        if (have_hdr && have_body && c->ssl == nullptr) {
            struct iovec iov[2];
            iov[0].iov_base = (void*)(c->out.data() + c->out_off);
            iov[0].iov_len = c->out.size() - c->out_off;
            iov[1].iov_base = (void*)(c->out2_data + c->out2_off);
            iov[1].iov_len = c->out2_len - c->out2_off;
            struct msghdr mh;
            memset(&mh, 0, sizeof mh);
            mh.msg_iov = iov;
            mh.msg_iovlen = 2;
            ssize_t n = sendmsg(c->fd, &mh, MSG_NOSIGNAL);
            if (n < 0) {
                if (errno == EAGAIN || errno == EWOULDBLOCK) {
                    struct epoll_event ev;
                    ev.events = EPOLLIN | EPOLLOUT;
                    ev.data.ptr = c;
                    epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
                    return;
                }
                close_conn(w, c);
                return;
            }
            size_t hn = std::min((size_t)n, iov[0].iov_len);
            c->out_off += hn;
            c->out2_off += (size_t)n - hn;
            continue;
        }
        const char* p;
        size_t left;
        if (have_hdr) {
            p = c->out.data() + c->out_off;
            left = c->out.size() - c->out_off;
        } else {
            p = c->out2_data + c->out2_off;
            left = c->out2_len - c->out2_off;
        }
        int n = conn_write(c, p, (int)std::min(left, (size_t)1 << 20));
        if (n > 0) {
            if (have_hdr) c->out_off += n; else c->out2_off += n;
            continue;
        }
        if (n == -1) {
            struct epoll_event ev;
            ev.events = EPOLLIN | EPOLLOUT;
            ev.data.ptr = c;
            epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
            return;
        }
        close_conn(w, c);
        return;
    }
    c->out.clear();
    c->out_off = 0;
    std::string().swap(c->out2);  // release, don't retain multi-MB bodies
    c->out2_pin.reset();
    c->out2_data = nullptr;
    c->out2_len = c->out2_off = 0;
    if (c->want_close) { close_conn(w, c); return; }
    struct epoll_event ev;
    ev.events = EPOLLIN;
    ev.data.ptr = c;
    epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// zero-copy responders: headers build into c->out, the body parks on the
// out2 channel (flush_out sends both with one writev). Worth the lane
// juggling only for large bodies — small ones append_response directly.
void respond_zc_head(Conn* c, int status, const char* reason,
                     const std::string& ctype, const std::string& extra,
                     size_t body_len) {
    char hdr[512];
    int hn = snprintf(hdr, sizeof hdr,
                      "HTTP/1.1 %d %s\r\nContent-Length: %zu\r\n", status,
                      reason, body_len);
    c->out.append(hdr, hn);
    if (!ctype.empty()) {
        c->out += "Content-Type: ";
        c->out += ctype;
        c->out += "\r\n";
    }
    c->out += extra;
    c->out += "\r\n";
}

void respond_zc_owned(Conn* c, int status, const char* reason,
                      const std::string& ctype, const std::string& extra,
                      std::string&& body, size_t off, size_t n) {
    respond_zc_head(c, status, reason, ctype, extra, n);
    c->out2 = std::move(body);
    c->out2_data = c->out2.data() + off;
    c->out2_len = n;
    c->out2_off = 0;
}

void respond_zc_pinned(Conn* c, int status, const char* reason,
                       const std::string& ctype, const std::string& extra,
                       std::shared_ptr<const void> pin, const char* data,
                       size_t n) {
    respond_zc_head(c, status, reason, ctype, extra, n);
    c->out2_pin = std::move(pin);
    c->out2_data = data;
    c->out2_len = n;
    c->out2_off = 0;
}

// A chunked request body (curl -T -, streaming clients) carries no
// Content-Length; decode it and rebuild the request with one so both the
// native handlers and the Python backend (which only frames by length)
// can serve it. Returns 1 when a rebuilt request replaced c->in's head,
// 0 when more bytes are needed, -1 on a framing error.
int dechunk_request(Conn* c, size_t hdr_len) {
    // resume from the prior scan position: re-walking every chunk per
    // read event would be O(n^2) on large streamed uploads
    size_t pos = c->chunk_scan ? c->chunk_scan : hdr_len;
    for (;;) {
        size_t le = c->in.find("\r\n", pos);
        if (le == std::string::npos) { c->chunk_scan = pos; return 0; }
        if (!isxdigit((unsigned char)c->in[pos])) return -1;  // malformed
        size_t chunk = strtoull(c->in.c_str() + pos, nullptr, 16);
        size_t data_at = le + 2;
        if (chunk == 0) {
            // optional trailers end with a blank line
            size_t fin = c->in.find("\r\n\r\n", le);
            size_t end;
            if (c->in.compare(le, 4, "\r\n\r\n") == 0) end = le + 4;
            else if (fin != std::string::npos) end = fin + 4;
            else { c->chunk_scan = pos; return 0; }
            // rebuild: headers minus Transfer-Encoding, plus Content-Length
            std::string head(c->in, 0, hdr_len - 2);  // keep one CRLF off
            std::string rebuilt;
            size_t line = 0;
            while (line < head.size()) {
                size_t eol = head.find("\r\n", line);
                if (eol == std::string::npos) eol = head.size();
                // drop TE and any client Content-Length: keeping the
                // latter would leave two conflicting lengths in the
                // rebuilt request (smuggling/desync vector)
                if (strncasecmp(head.c_str() + line, "transfer-encoding:",
                                18) != 0 &&
                    strncasecmp(head.c_str() + line, "content-length:",
                                15) != 0)
                    rebuilt.append(head, line, eol + 2 - line);
                line = eol + 2;
            }
            char clh[48];
            snprintf(clh, sizeof clh, "Content-Length: %zu\r\n\r\n",
                     c->chunk_body.size());
            rebuilt += clh;
            rebuilt += c->chunk_body;
            c->in.replace(0, end, rebuilt);
            c->chunk_scan = 0;
            c->chunk_body.clear();
            return 1;
        }
        if (chunk > (1ull << 31)) return -1;
        if (c->in.size() < data_at + chunk + 2) { c->chunk_scan = pos; return 0; }
        c->chunk_body.append(c->in, data_at, chunk);
        pos = data_at + chunk + 2;
        if (c->chunk_body.size() > (1ull << 31)) return -1;
    }
}

// drain complete buffered requests; stops while a proxied request is in
// flight (responses must stay ordered per connection) or while a
// zero-copy body occupies the out2 lane (a later response appended to
// `out` would overtake it on the wire)
void process_buffered(Engine* E, Worker* w, Conn* c) {
    while (c->upstream == nullptr && !c->want_close && c->out2_len == 0) {
        size_t hdr_end = c->in.find("\r\n\r\n");
        if (hdr_end == std::string::npos) {
            if (c->in.size() > (1u << 20)) close_conn(w, c);
            return;
        }
        size_t hdr_len = hdr_end + 4;
        // clients streaming a body often wait for 100 Continue first
        if (!c->sent_continue) {
            std::string expect = find_header(
                c->in.data(), c->in.data() + hdr_len, "expect");
            if (strncasecmp(expect.c_str(), "100-", 4) == 0) {
                c->sent_continue = true;
                c->out += "HTTP/1.1 100 Continue\r\n\r\n";
                flush_out(w, c);
                if (c->fd < 0) return;
            }
        }
        std::string te = find_header(c->in.data(), c->in.data() + hdr_len,
                                     "transfer-encoding");
        if (strcasecmp(te.c_str(), "chunked") == 0) {
            int rc = dechunk_request(c, hdr_len);
            if (rc == 0) return;          // need more chunks
            if (rc < 0) { close_conn(w, c); return; }
            continue;  // re-parse the rebuilt, length-framed request
        }
        std::string cl = find_header(c->in.data(), c->in.data() + hdr_len,
                                     "content-length");
        size_t body_len = cl.empty() ? 0 : strtoull(cl.c_str(), nullptr, 10);
        if (body_len > (1ull << 31)) { close_conn(w, c); return; }
        if (c->in.size() < hdr_len + body_len) return;  // need more body
        size_t req_len = hdr_len + body_len;
        dispatch(E, w, c, c->in.data(), req_len, hdr_len,
                 c->in.data() + hdr_len, body_len);
        c->in.erase(0, req_len);
        c->sent_continue = false;
    }
}

// serve every request already buffered in c->in, interleaving flushes:
// a zero-copy response parks process_buffered until its out2 body lane
// clears, and after a backend completion no further read event will
// arrive to resume the pipeline — a single process_buffered+flush_out
// pass would leave an already-buffered pipelined request stalled until
// the idle sweep. Loops until blocked (partial flush, upstream hop,
// close) or c->in stops shrinking.
void drain_buffered(Engine* E, Worker* w, Conn* c) {
    for (;;) {
        // flush FIRST: when a backend completion parks its body on out2
        // before calling here, process_buffered is gated until the lane
        // clears — flushing last would read "no input consumed" as done
        // and strand the buffered request
        flush_out(w, c);
        if (c->fd < 0 || c->upstream != nullptr || c->want_close ||
            c->out_off < c->out.size() || c->out2_len != 0 || c->in.empty())
            return;
        size_t before = c->in.size();
        process_buffered(E, w, c);
        if (c->fd < 0) return;
        if (c->in.size() == before && c->out_off >= c->out.size() &&
            c->out2_len == 0)
            return;  // no progress and nothing new to flush
    }
}

// drive a pending TLS handshake; afterwards either tls_hs==2 (established,
// CN checked) or the conn is closed or still handshaking (tls_hs==1)
void tls_handshake_step(Engine* E, Worker* w, Conn* c) {
    TlsApi* T = tls_api();
    int r = T->SSL_do_handshake(c->ssl);
    if (r == 1) {
        c->tls_hs = 2;
        if (!E->allowed_cns.empty()) {
            // per-request 403 on CN mismatch (same surface the Python gate
            // produces) — the handshake itself already proved CA validity
            c->cn_ok = false;
            void* cert = T->SSL_get1_peer_certificate(c->ssl);
            if (cert != nullptr) {
                char cn[256] = {0};
                void* name = T->X509_get_subject_name(cert);
                if (name != nullptr &&
                    T->X509_NAME_get_text_by_NID(name, kNID_commonName, cn,
                                                 sizeof cn) > 0) {
                    for (const auto& pat : E->allowed_cns)
                        if (glob_match(pat.c_str(), cn)) {
                            c->cn_ok = true;
                            break;
                        }
                }
                T->X509_free(cert);
            }
        }
        struct epoll_event ev;
        ev.events = EPOLLIN;
        ev.data.ptr = c;
        epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
        return;
    }
    int e = T->SSL_get_error(c->ssl, r);
    if (e == kSSL_ERROR_WANT_READ || e == kSSL_ERROR_WANT_WRITE) {
        struct epoll_event ev;
        ev.events = e == kSSL_ERROR_WANT_WRITE ? (EPOLLIN | EPOLLOUT)
                                               : EPOLLIN;
        ev.data.ptr = c;
        epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
        return;
    }
    close_conn(w, c);  // bad cert, protocol error, or peer gave up
}

void on_readable(Engine* E, Worker* w, Conn* c) {
    char buf[65536];
    for (;;) {
        int n = conn_read(c, buf, sizeof buf);
        if (n > 0) {
            c->in.append(buf, n);
            if (c->in.size() > (1ull << 31)) { close_conn(w, c); return; }
            continue;
        }
        if (n == -1) break;
        if (n == -3) {  // SSL_read blocked on WRITE: wake on writability
            struct epoll_event ev;
            ev.events = EPOLLIN | EPOLLOUT;
            ev.data.ptr = c;
            epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
            break;
        }
        close_conn(w, c);  // EOF or error
        return;
    }
    c->last_active = time(nullptr);
    drain_buffered(E, w, c);
}

void* worker_main(void* arg) {
    auto* pair = (std::pair<Engine*, Worker*>*)arg;
    Engine* E = pair->first;
    Worker* w = pair->second;
    delete pair;
    struct epoll_event evs[256];
    time_t last_sweep = time(nullptr);
    while (E->running.load()) {
        int n = epoll_wait(w->epfd, evs, 256, 500);
        for (int i = 0; i < n; i++) {
            int kind = *(int*)evs[i].data.ptr;  // first field of both structs
            if (kind == 1) {
                BackendConn* b = (BackendConn*)evs[i].data.ptr;
                if (b->fd < 0) continue;
                on_backend_event(E, w, b, evs[i].events);
                continue;
            }
            Conn* c = (Conn*)evs[i].data.ptr;
            if (c->fd < 0) continue;  // closed earlier in this batch
            if (evs[i].events & (EPOLLHUP | EPOLLERR)) { close_conn(w, c); continue; }
            if (c->tls_hs == 1) {
                tls_handshake_step(E, w, c);
                if (c->fd < 0 || c->tls_hs != 2) continue;
                // fall through: the handshake's last flight may have
                // arrived together with the first request bytes
            }
            if (evs[i].events & EPOLLOUT) {
                flush_out(w, c);
                if (c->fd < 0) continue;
            }
            // EPOLLOUT (without EPOLLIN) also retries reads: a TLS read
            // that blocked on WRITE (conn_read -3) resumes on writability
            if (evs[i].events & (EPOLLIN | EPOLLOUT)) on_readable(E, w, c);
        }
        {
            std::lock_guard<std::mutex> l(w->conns_mu);
            for (auto* c : w->graveyard) delete c;
            w->graveyard.clear();
        }
        for (auto* b : w->back_graveyard) delete b;
        w->back_graveyard.clear();
        time_t now = time(nullptr);
        if (now - last_sweep > 30) {
            last_sweep = now;
            std::vector<Conn*> idle;
            {
                std::lock_guard<std::mutex> l(w->conns_mu);
                for (auto* c : w->conns)
                    if (now - c->last_active > 300 && c->upstream == nullptr)
                        idle.push_back(c);
            }
            for (auto* c : idle) close_conn(w, c);
            // Reclaim proxied requests: orphans (client gone) promptly,
            // client-attached ones only after an hour — admin operations
            // (vacuum, ec encode, tiering) legitimately run many minutes
            // and had no front-door timeout before this engine existed
            std::vector<BackendConn*> stuck;
            for (auto* b : w->pending) {
                long age = now - b->started;
                // the hour-long allowance is for proxied ADMIN operations
                // (vacuum, ec encode); filer chunk uploads/relays are
                // small-blob volume hops that answer in milliseconds —
                // a wedged one must fail the client fast
                long limit = b->mode != 0 ? 30 : 3600;
                if ((b->client == nullptr && age > 75) || age > limit)
                    stuck.push_back(b);
            }
            for (auto* b : stuck) backend_complete(E, w, b, false, false, false);
            // queued (capped) requests age out too: wedged in-flight
            // requests must not hang queued clients without a response
            std::vector<BackendConn*> stale_q;
            for (auto* b : w->waiting)
                if (b->client == nullptr || now - b->started > 600)
                    stale_q.push_back(b);
            for (auto* b : stale_q) {
                for (size_t i = 0; i < w->waiting.size(); i++)
                    if (w->waiting[i] == b) {
                        w->waiting.erase(w->waiting.begin() + i);
                        break;
                    }
                if (b->client) {
                    b->client->upstream = nullptr;
                    json_response(b->client, 504, "Gateway Timeout",
                                  "{\"error\": \"backend queue timeout\"}");
                    b->client->want_close = true;
                    flush_out(w, b->client);
                }
                w->back_graveyard.push_back(b);
            }
            for (auto* b : w->back_graveyard) delete b;
            w->back_graveyard.clear();
        }
    }
    {
        std::lock_guard<std::mutex> l(w->conns_mu);
        for (auto* c : w->conns) {
            if (c->ssl != nullptr) tls_api()->SSL_free(c->ssl);
            if (c->fd >= 0) close(c->fd);
            delete c;
        }
        w->conns.clear();
        for (auto* c : w->graveyard) delete c;
        w->graveyard.clear();
    }
    for (auto* b : w->pending) {
        back_free_ssl(b);
        if (b->fd >= 0) close(b->fd);
        delete b;
    }
    w->pending.clear();
    for (auto* b : w->waiting) delete b;
    w->waiting.clear();
    for (auto* b : w->back_graveyard) delete b;
    w->back_graveyard.clear();
    auto drain_pool = [](std::vector<std::pair<int, void*>>& pool) {
        for (auto& pooled : pool) {
            if (pooled.second != nullptr) tls_api()->SSL_free(pooled.second);
            close(pooled.first);
        }
        pool.clear();
    };
    drain_pool(w->idle_backends);
    for (auto& kv : w->idle_targets) drain_pool(kv.second);
    w->idle_targets.clear();
    return nullptr;
}

void* accept_main(void* arg) {
    Engine* E = (Engine*)arg;
    size_t next = 0;
    while (E->running.load()) {
        struct sockaddr_in sa;
        socklen_t sl = sizeof sa;
        int fd = accept(E->listen_fd, (struct sockaddr*)&sa, &sl);
        if (fd < 0) {
            if (errno == EINTR || errno == EAGAIN) continue;
            if (!E->running.load()) break;
            usleep(10000);
            continue;
        }
        set_nonblock(fd);
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        Worker& w = E->workers[next % E->workers.size()];
        next++;
        Conn* c = new Conn();
        c->fd = fd;
        c->last_active = time(nullptr);
        if (E->tls_ctx != nullptr) {
            TlsApi* T = tls_api();
            c->ssl = T->SSL_new(E->tls_ctx);
            if (c->ssl == nullptr) { close(fd); delete c; continue; }
            T->SSL_set_fd(c->ssl, fd);
            T->SSL_set_accept_state(c->ssl);
            c->tls_hs = 1;  // handshake driven by epoll events
        }
        struct epoll_event ev;
        ev.events = EPOLLIN;
        ev.data.ptr = c;
        {
            std::lock_guard<std::mutex> l(w.conns_mu);
            w.conns.push_back(c);
        }
        epoll_ctl(w.epfd, EPOLL_CTL_ADD, fd, &ev);
    }
    return nullptr;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// returns an engine handle (>=0); the bound port comes from sw_fl_port().
// tls_cert non-empty turns on engine-terminated mTLS (client certs
// REQUIRED, CA = tls_ca, optional comma-separated '*'-glob CN allow-list);
// -4/-5 = TLS requested but unavailable/misconfigured, so the caller can
// fall back to serving TLS from Python.
int sw_fl_start(const char* host, int port, const char* backend_host,
                int backend_port, int workers, int secure_reads,
                int secure_writes, int max_backend,
                const char* jwt_write_key, const char* jwt_read_key,
                const char* tls_cert, const char* tls_key,
                const char* tls_ca, const char* tls_allowed_cns) {
    void* tls_ctx = nullptr;
    void* tls_client_ctx = nullptr;
    if (tls_cert && *tls_cert) {
        TlsApi* T = tls_api();
        if (T == nullptr) return -4;  // no OpenSSL runtime on this host
        tls_ctx = T->SSL_CTX_new(T->TLS_server_method());
        if (tls_ctx == nullptr) return -4;
        if (T->SSL_CTX_use_certificate_chain_file(tls_ctx, tls_cert) != 1 ||
            T->SSL_CTX_use_PrivateKey_file(tls_ctx, tls_key,
                                           kSSL_FILETYPE_PEM) != 1 ||
            (tls_ca && *tls_ca &&
             T->SSL_CTX_load_verify_locations(tls_ctx, tls_ca, nullptr) != 1)) {
            T->SSL_CTX_free(tls_ctx);
            return -5;
        }
        T->SSL_CTX_set_verify(
            tls_ctx, kSSL_VERIFY_PEER | kSSL_VERIFY_FAIL_IF_NO_PEER_CERT,
            nullptr);
        // partial writes: flush_out retries from a moving offset
        T->SSL_CTX_ctrl(tls_ctx, kSSL_CTRL_MODE,
                        kSSL_MODE_ENABLE_PARTIAL_WRITE |
                            kSSL_MODE_ACCEPT_MOVING_WRITE_BUFFER,
                        nullptr);
        // client context for upstream hops (filer engine -> volume engine
        // under mTLS): this node's cert doubles as the client cert, the
        // server's cert must chain to the CA (identity = CA + CN, no
        // hostname check — security/tls.py client semantics)
        tls_client_ctx = T->SSL_CTX_new(T->TLS_client_method());
        if (tls_client_ctx != nullptr) {
            if (T->SSL_CTX_use_certificate_chain_file(tls_client_ctx,
                                                      tls_cert) != 1 ||
                T->SSL_CTX_use_PrivateKey_file(tls_client_ctx, tls_key,
                                               kSSL_FILETYPE_PEM) != 1 ||
                (tls_ca && *tls_ca &&
                 T->SSL_CTX_load_verify_locations(tls_client_ctx, tls_ca,
                                                  nullptr) != 1)) {
                T->SSL_CTX_free(tls_client_ctx);
                tls_client_ctx = nullptr;  // upstream hops stay on Python
            } else {
                T->SSL_CTX_set_verify(tls_client_ctx, kSSL_VERIFY_PEER,
                                      nullptr);
                T->SSL_CTX_ctrl(tls_client_ctx, kSSL_CTRL_MODE,
                                kSSL_MODE_ENABLE_PARTIAL_WRITE |
                                    kSSL_MODE_ACCEPT_MOVING_WRITE_BUFFER,
                                nullptr);
            }
        }
    }
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
        if (tls_ctx) tls_api()->SSL_CTX_free(tls_ctx);
        if (tls_client_ctx) tls_api()->SSL_CTX_free(tls_client_ctx);
        return -2;
    }
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    struct sockaddr_in sa;
    memset(&sa, 0, sizeof sa);
    sa.sin_family = AF_INET;
    sa.sin_port = htons(port);
    sa.sin_addr.s_addr = host && *host ? inet_addr(host) : htonl(INADDR_ANY);
    if (bind(fd, (struct sockaddr*)&sa, sizeof sa) != 0 ||
        listen(fd, 1024) != 0) {
        close(fd);
        if (tls_ctx) tls_api()->SSL_CTX_free(tls_ctx);
        if (tls_client_ctx) tls_api()->SSL_CTX_free(tls_client_ctx);
        return -3;
    }
    socklen_t sl = sizeof sa;
    getsockname(fd, (struct sockaddr*)&sa, &sl);
    Engine* E = new Engine();
    E->listen_fd = fd;
    E->port = ntohs(sa.sin_port);
    E->backend_port = backend_port;
    E->backend_ip = htonl(INADDR_LOOPBACK);
    if (backend_host && *backend_host &&
        strcmp(backend_host, "0.0.0.0") != 0) {
        uint32_t ip = inet_addr(backend_host);
        if (ip != INADDR_NONE) E->backend_ip = ip;
    }
    E->secure_reads = secure_reads != 0;
    E->secure_writes = secure_writes != 0;
    if (max_backend > 0) E->max_backend = (size_t)max_backend;
    // fixed before any worker/accept thread exists: workers read these
    // lock-free on the request path
    if (jwt_write_key && *jwt_write_key) E->jwt_write_key = jwt_write_key;
    if (jwt_read_key && *jwt_read_key) E->jwt_read_key = jwt_read_key;
    E->tls_ctx = tls_ctx;
    E->tls_client_ctx = tls_client_ctx;
    if (tls_allowed_cns && *tls_allowed_cns) {
        const char* p = tls_allowed_cns;
        while (*p) {
            const char* comma = strchr(p, ',');
            size_t n = comma ? (size_t)(comma - p) : strlen(p);
            while (n > 0 && (*p == ' ' || *p == '\t')) { p++; n--; }
            while (n > 0 && (p[n - 1] == ' ' || p[n - 1] == '\t')) n--;
            if (n > 0) E->allowed_cns.emplace_back(p, n);
            p = comma ? comma + 1 : p + n;
        }
    }
    if (workers < 1) workers = 2;
    if (workers > 32) workers = 32;
    E->workers.resize(workers);
    for (auto& w : E->workers) {
        w.epfd = epoll_create1(0);
        auto* pair = new std::pair<Engine*, Worker*>(E, &w);
        pthread_create(&w.thread, nullptr, worker_main, pair);
    }
    pthread_create(&E->accept_thread, nullptr, accept_main, E);
    std::lock_guard<std::mutex> gl(g_engine_mu);
    g_engines.push_back(E);
    return (int)g_engines.size() - 1;
}

int sw_fl_port(int h) {
    Engine* E = engine_at(h);
    return E ? E->port : -1;
}

void sw_fl_stop(int h) {
    Engine* E;
    {
        std::lock_guard<std::mutex> gl(g_engine_mu);
        if (h < 0 || (size_t)h >= g_engines.size()) return;
        E = g_engines[h];
        g_engines[h] = nullptr;
    }
    if (!E) return;
    E->running.store(false);
    shutdown(E->listen_fd, SHUT_RDWR);
    close(E->listen_fd);
    pthread_join(E->accept_thread, nullptr);
    for (auto& w : E->workers) {
        pthread_join(w.thread, nullptr);
        close(w.epfd);
    }
    if (E->tls_ctx != nullptr) tls_api()->SSL_CTX_free(E->tls_ctx);
    if (E->tls_client_ctx != nullptr)
        tls_api()->SSL_CTX_free(E->tls_client_ctx);
    if (E->filer_journal_fd >= 0) close(E->filer_journal_fd);
    delete E;
}

int sw_fl_register_volume(int h, uint32_t vid, int dat_fd, int idx_fd,
                          int version, unsigned long long tail,
                          unsigned long long last_append_ns, int readonly,
                          int forward_writes) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = std::make_shared<Vol>();
    v->vid = vid;
    v->dat_fd = dat_fd;
    v->idx_fd = idx_fd;
    v->version = version;
    v->tail.store(tail);
    v->last_ns.store(last_append_ns);
    v->readonly.store(readonly != 0);
    v->forward_writes.store(forward_writes != 0);
    std::unique_lock<std::shared_mutex> l(E->reg_mu);
    E->vols[vid] = v;
    return 0;
}

// Tag a registered volume with its collection so sw_fl_get_usage can
// aggregate native-op counters per tenant (the usage ABI).
int sw_fl_volume_collection_set(int h, uint32_t vid, const char* coll) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::unique_lock<std::shared_mutex> l(E->reg_mu);
    auto it = E->vols.find(vid);
    if (it == E->vols.end()) return -2;
    const char* src = (coll != nullptr) ? coll : "";
    strncpy(it->second->collection, src, sizeof(it->second->collection) - 1);
    it->second->collection[sizeof(it->second->collection) - 1] = '\0';
    return 0;
}

// arms the data plane once the Python-side bulk map load has landed
int sw_fl_volume_serving(int h, uint32_t vid) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    v->serving.store(true, std::memory_order_release);
    return 0;
}

int sw_fl_load_entries(int h, uint32_t vid, const uint64_t* keys,
                       const uint64_t* offsets, const int32_t* sizes,
                       size_t n) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    std::unique_lock<std::shared_mutex> ml(v->map_mu);
    for (size_t i = 0; i < n; i++)
        if (sizes[i] > 0) v->nmap.put(keys[i], offsets[i], sizes[i]);
    return 0;
}

int sw_fl_unregister_volume(int h, uint32_t vid) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::shared_ptr<Vol> v;
    {
        std::unique_lock<std::shared_mutex> l(E->reg_mu);
        auto it = E->vols.find(vid);
        if (it == E->vols.end()) return 0;
        v = it->second;
        E->vols.erase(it);
    }
    // wait out any in-flight append; readers hold the shared_ptr and the
    // fds stay open until the last reference drops
    v->append_mu.lock();
    v->append_mu.unlock();
    return 0;
}

int sw_fl_set_flags(int h, uint32_t vid, int readonly, int forward_writes) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    v->readonly.store(readonly != 0);
    v->forward_writes.store(forward_writes != 0);
    return 0;
}

int sw_fl_volume_lock(int h, uint32_t vid) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    v->append_mu.lock();
    return 0;
}

int sw_fl_volume_unlock(int h, uint32_t vid) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    v->append_mu.unlock();
    return 0;
}

unsigned long long sw_fl_tail_get(int h, uint32_t vid) {
    Engine* E = engine_at(h);
    if (!E) return 0;
    auto v = E->vol_raw(vid);
    return v ? v->tail.load() : 0;
}

int sw_fl_tail_set(int h, uint32_t vid, unsigned long long tail,
                   unsigned long long last_ns) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    v->tail.store(tail);
    if (last_ns) v->last_ns.store(last_ns);
    return 0;
}

// --- online-EC stripe accumulator ------------------------------------------
// Arms per-volume stripe tracking for the write-path erasure coder
// (storage/erasure_coding/online.py): stripe_bytes is one full row
// (DATA_SHARDS x block), watermark the .dat offset parity covers so far.
int sw_fl_ec_online_arm(int h, uint32_t vid, unsigned long long stripe_bytes,
                        unsigned long long watermark) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    v->ec_stripe.store(stripe_bytes);
    v->ec_watermark.store(watermark);
    return 0;
}

// Complete stripes accumulated past the watermark (the drain hook's O(1)
// readiness check). out2 (optional, 2 slots) receives {watermark, tail}.
// -1 bad handle, -2 unknown volume, -3 not armed.
long long sw_fl_ec_online_pending(int h, uint32_t vid,
                                  unsigned long long* out2) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    uint64_t stripe = v->ec_stripe.load(std::memory_order_relaxed);
    uint64_t wm = v->ec_watermark.load(std::memory_order_relaxed);
    uint64_t tail = v->tail.load(std::memory_order_relaxed);
    if (out2 != nullptr) {
        out2[0] = wm;
        out2[1] = tail;
    }
    if (stripe == 0) return -3;
    if (tail <= wm) return 0;
    return (long long)((tail - wm) / stripe);
}

int sw_fl_ec_online_advance(int h, uint32_t vid,
                            unsigned long long watermark) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    v->ec_watermark.store(watermark);
    return 0;
}

int sw_fl_map_put(int h, uint32_t vid, uint64_t key, unsigned long long offset,
                  int32_t size) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    std::unique_lock<std::shared_mutex> ml(v->map_mu);
    if (size > 0) v->nmap.put(key, offset, size);
    else v->nmap.del(key);
    return 0;
}

// install/replace the assign responder for one exact query string.
// tails: n zero-terminated JSON fragments (everything after the fid field).
int sw_fl_assign_set(int h, const char* query, const uint32_t* vids,
                     const char* tails, size_t n,
                     unsigned long long key_start,
                     unsigned long long key_end) {
    Engine* E = engine_at(h);
    if (!E || n == 0) return -1;
    auto ap = std::make_shared<AssignProfile>();
    ap->vids.assign(vids, vids + n);
    const char* p = tails;
    for (size_t i = 0; i < n; i++) {
        ap->tails.emplace_back(p);
        p += strlen(p) + 1;
    }
    ap->next_key.store(key_start);
    ap->end_key = key_end;
    std::unique_lock<std::shared_mutex> l(E->assign_mu);
    E->assigns[query] = ap;
    return 0;
}

int sw_fl_assign_clear(int h) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::unique_lock<std::shared_mutex> l(E->assign_mu);
    E->assigns.clear();
    return 0;
}

// --- filer mode --------------------------------------------------------------

// turn on the native filer paths. journal_path: entry WAL appended before
// every native-write ack (crash replay); "" disables journaling (memory
// stores). compress: the Python pipeline would compress compressible
// mimes, so chunk-backed native writes restrict to incompressible ones.
int sw_fl_filer_enable(int h, const char* journal_path,
                       unsigned long long chunk_limit, int compress) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    if (journal_path && *journal_path) {
        int fd = open(journal_path, O_WRONLY | O_APPEND | O_CREAT, 0644);
        if (fd < 0) return -2;
        E->filer_journal_fd = fd;
    }
    if (chunk_limit > 0) E->filer_chunk_limit = (size_t)chunk_limit;
    E->filer_compress = compress != 0;
    E->filer_mode.store(true, std::memory_order_release);
    return 0;
}

// can this engine reach (possibly TLS) upstream targets natively? Under
// mTLS that needs the client context; plaintext clusters always can.
int sw_fl_tls_client_ok(int h) {
    Engine* E = engine_at(h);
    if (!E) return 0;
    return (E->tls_ctx == nullptr || E->tls_client_ctx != nullptr) ? 1 : 0;
}

// typed error strings for the negative rcs this ABI returns — the Python
// side logs these instead of a bare rc so a fallback regime names itself
const char* sw_fl_error_str(int rc) {
    switch (rc) {
        case 0: return "ok";
        case -1: return "engine handle invalid or already stopped";
        case -2: return "host is not an IPv4 address (hostname targets"
                        " stay on the Python path)";
        case -3: return "mTLS configured but no native TLS client context"
                        " (OpenSSL runtime missing)";
        case -4: return "TLS requested but OpenSSL runtime unavailable";
        case -5: return "TLS certificate/key/CA failed to load";
        default: return "unknown error";
    }
}

// upsert one volume's lease into the POOL (keyed by vid): chunk writes
// round-robin across unspent leases, and a failed volume drops only its
// own entry. Python tops the pool up via sw_fl_filer_lease_count.
int sw_fl_filer_lease_set(int h, const char* vol_host, int vol_port,
                          uint32_t vid, uint32_t cookie,
                          unsigned long long key_start,
                          unsigned long long key_end, const char* upload_auth,
                          const char* read_auth) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    if (E->tls_ctx != nullptr && E->tls_client_ctx == nullptr)
        return -3;  // mTLS without a client ctx: uploads would hit a TLS
                    // listener in plaintext and 500 — stay on Python
    auto L = std::make_shared<FilerLease>();
    L->vol_ip = htonl(INADDR_LOOPBACK);
    if (vol_host && *vol_host && strcmp(vol_host, "0.0.0.0") != 0) {
        uint32_t ip = inet_addr(vol_host);
        if (ip == INADDR_NONE) return -2;  // hostname: Python path only
        L->vol_ip = ip;
    }
    L->vol_port = vol_port;
    L->vid = vid;
    L->cookie = cookie;
    L->next_key.store(key_start);
    L->end_key = key_end;
    if (upload_auth && *upload_auth) L->auth = upload_auth;
    std::unique_lock<std::shared_mutex> l(E->flease_mu);
    bool replaced = false;
    for (auto& ex : E->fleases)
        if (ex->vid == vid) {
            uint64_t next = ex->next_key.load(std::memory_order_relaxed);
            if (next < ex->end_key && ex->end_key - next >= 5000) {
                // the held range is still healthy: inherit it instead of
                // replacing (a replace abandons the unspent keys — on a
                // cluster with fewer writable volumes than the pool
                // target every top-up probe lands on an already-held
                // vid, and the discard would waste ~count fids per probe
                // forever) while refreshing endpoint + auth so a
                // slow-draining range never outlives its JWT. The swap
                // is safe under the unique lock: take_filer_lease mints
                // under the shared lock, so no key can be drawn between
                // the next_key load and the pointer swap, and in-flight
                // writers hold their own shared_ptr to the immutable old
                // object. rc=1 tells the filer the master granted a
                // duplicate vid — the pool is as wide as the cluster
                // allows, stop topping up.
                L->cookie = ex->cookie;
                L->next_key.store(next);
                L->end_key = ex->end_key;
                ex = std::move(L);
                E->filer_read_auth =
                    read_auth && *read_auth ? read_auth : "";
                return 1;
            }
            ex = std::move(L);
            replaced = true;
            break;
        }
    if (!replaced) E->fleases.push_back(std::move(L));
    E->filer_read_auth = read_auth && *read_auth ? read_auth : "";
    return 0;
}

unsigned long long sw_fl_filer_lease_remaining(int h) {
    Engine* E = engine_at(h);
    if (!E) return 0;
    std::shared_lock<std::shared_mutex> l(E->flease_mu);
    uint64_t total = 0;
    for (const auto& L : E->fleases) {
        uint64_t next = L->next_key.load(std::memory_order_relaxed);
        if (next < L->end_key) total += L->end_key - next;
    }
    return total;
}

// live (unspent) leases in the pool; -1 = bad handle so the Python side
// can tell "engine stopped" from "pool empty" (lease_remaining
// conflates the two, which a shutdown race would log as a bare rc=-1)
long sw_fl_filer_lease_count(int h) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::shared_lock<std::shared_mutex> l(E->flease_mu);
    long n = 0;
    for (const auto& L : E->fleases)
        if (L->next_key.load(std::memory_order_relaxed) < L->end_key) n++;
    return n;
}

int sw_fl_filer_cache_put(int h, const char* path, const char* host,
                          int port, const char* fid, const char* mime,
                          const char* md5_hex, unsigned long long size,
                          unsigned long long mtime, const void* inline_data,
                          size_t inline_len) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto ent = std::make_shared<FilerCacheEnt>();
    if (inline_len > 0) {
        ent->inline_data.assign((const char*)inline_data, inline_len);
    } else {
        ent->ip = htonl(INADDR_LOOPBACK);
        if (host && *host && strcmp(host, "0.0.0.0") != 0) {
            uint32_t ip = inet_addr(host);
            if (ip == INADDR_NONE) return -2;
            ent->ip = ip;
        }
        ent->port = port;
        ent->fid = fid ? fid : "";
        if (ent->fid.empty()) return -3;
    }
    ent->mime = mime ? mime : "";
    ent->md5_hex = md5_hex ? md5_hex : "";
    ent->size = size;
    ent->mtime = mtime;
    fcache_put(E, path, std::move(ent));
    return 0;
}

// install the fs.configure rule prefixes (NUL-joined, n entries):
// native writes under them defer to Python
int sw_fl_filer_rules_set(int h, const char* prefixes, size_t n) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::vector<std::string> out;
    const char* p = prefixes;
    for (size_t i = 0; i < n; i++) {
        out.emplace_back(p);
        p += out.back().size() + 1;
    }
    std::unique_lock<std::shared_mutex> l(E->frules_mu);
    E->frule_prefixes = std::move(out);
    return 0;
}

int sw_fl_filer_cache_del(int h, const char* path) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    fcache_del(E, path ? path : "");
    return 0;
}

// pop queued entry frames into `out` (whole frames only); returns bytes
long sw_fl_filer_drain(int h, uint8_t* out, size_t cap) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::lock_guard<std::mutex> l(E->filer_mu);
    size_t off = 0;
    while (!E->filer_events.empty()) {
        const std::string& f = E->filer_events.front();
        if (off + f.size() > cap) break;
        memcpy(out + off, f.data(), f.size());
        off += f.size();
        E->filer_events_bytes -= f.size();
        E->filer_events.pop_front();
    }
    return (long)off;
}

// truncate the journal once Python has applied everything it drained.
// Refuses (returns pending count) while frames are still queued — those
// would be lost to a crash between truncate and their drain.
long sw_fl_filer_journal_reset(int h) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::lock_guard<std::mutex> l(E->filer_mu);
    if (!E->filer_events.empty()) return (long)E->filer_events.size();
    if (E->filer_journal_fd >= 0) {
        if (ftruncate(E->filer_journal_fd, 0) != 0) return -2;
        lseek(E->filer_journal_fd, 0, SEEK_SET);
    }
    return 0;
}

long sw_fl_drain_events(int h, uint8_t* out, size_t max_events) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::lock_guard<std::mutex> l(E->ev_mu);
    size_t n = E->events.size() < max_events ? E->events.size() : max_events;
    for (size_t i = 0; i < n; i++) {
        memcpy(out + i * sizeof(Event), &E->events.front(), sizeof(Event));
        E->events.pop_front();
    }
    return (long)n;
}

void sw_fl_get_stats(int h, unsigned long long* out6) {
    Engine* E = engine_at(h);
    if (!E) { memset(out6, 0, 6 * sizeof(unsigned long long)); return; }
    out6[0] = E->stats.requests.load();
    out6[1] = E->stats.native_reads.load();
    out6[2] = E->stats.native_writes.load();
    out6[3] = E->stats.native_deletes.load();
    out6[4] = E->stats.proxied.load();
    out6[5] = E->stats.native_assigns.load();
}

// Self-describing per-op metrics snapshot (storage/fastlane.py binds it
// beside the plain sw_fl_get_stats counters). Layout:
//   out[0] = n_ops   (read, write, delete, assign, proxied — in order)
//   out[1] = n_buckets (finite bucket bounds; each op then carries
//            n_buckets+1 counters, the last being the +Inf overflow)
//   out[2 .. 2+n_buckets)  bucket upper bounds in NANOSECONDS
//   then per op: count, bytes, ns_sum, bucket[n_buckets+1]
// Returns u64 values written; -1 bad handle, -2 cap too small.
long sw_fl_get_metrics(int h, unsigned long long* out, size_t cap) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    size_t need = 2 + kLatBuckets + (size_t)kNumOps * (3 + kLatBuckets + 1);
    if (cap < need) return -2;
    size_t o = 0;
    out[o++] = (unsigned long long)kNumOps;
    out[o++] = (unsigned long long)kLatBuckets;
    for (int i = 0; i < kLatBuckets; i++) out[o++] = kLatBoundsNs[i];
    for (int op = 0; op < kNumOps; op++) {
        OpStat& s = E->op_stats[op];
        out[o++] = s.count.load(std::memory_order_relaxed);
        out[o++] = s.bytes.load(std::memory_order_relaxed);
        out[o++] = s.ns_sum.load(std::memory_order_relaxed);
        for (int i = 0; i <= kLatBuckets; i++)
            out[o++] = s.buckets[i].load(std::memory_order_relaxed);
    }
    return (long)o;
}

// Front-door accounting snapshot. Layout:
//   out[0] = n_ops (read, write, delete — kNumFrontOps)
//   out[1] = n_reasons (kNumFbReasons, in the kFb* order)
//   out[2 .. 2+n_ops)                     native counts per op
//   then n_ops rows of n_reasons fallback counts
// Returns u64s written; -1 bad handle, -2 cap too small.
long sw_fl_front_metrics(int h, unsigned long long* out, size_t cap) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    size_t need = 2 + kNumFrontOps + (size_t)kNumFrontOps * kNumFbReasons;
    if (cap < need) return -2;
    size_t o = 0;
    out[o++] = (unsigned long long)kNumFrontOps;
    out[o++] = (unsigned long long)kNumFbReasons;
    for (int op = 0; op < kNumFrontOps; op++)
        out[o++] = E->fr_native[op].load(std::memory_order_relaxed);
    for (int op = 0; op < kNumFrontOps; op++)
        for (int r = 0; r < kNumFbReasons; r++)
            out[o++] = E->fr_fallback[op][r].load(std::memory_order_relaxed);
    return (long)o;
}

// --- s3 front mode -----------------------------------------------------------

// point the gateway's engine at the FILER's front door; object GET/PUT/
// DELETE on natively-flagged buckets then relay without touching Python
int sw_fl_s3_enable(int h, const char* filer_host, int filer_port) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    if (E->tls_ctx != nullptr && E->tls_client_ctx == nullptr) return -3;
    uint32_t ip = htonl(INADDR_LOOPBACK);
    if (filer_host && *filer_host && strcmp(filer_host, "0.0.0.0") != 0) {
        ip = inet_addr(filer_host);
        if (ip == INADDR_NONE) return -2;  // hostname: Python path only
    }
    E->s3_filer_ip = ip;
    E->s3_filer_port = filer_port;
    E->s3_mode.store(true, std::memory_order_release);
    return 0;
}

int sw_fl_s3_disable(int h) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    E->s3_mode.store(false, std::memory_order_release);
    std::unique_lock<std::shared_mutex> l(E->s3_mu);
    E->s3_buckets.clear();
    E->s3_uploads.clear();
    return 0;
}

// flags: kS3Read|kS3Write|kS3Delete bits; negative = forget the bucket
int sw_fl_s3_bucket_set(int h, const char* bucket, int flags) {
    Engine* E = engine_at(h);
    if (!E || !bucket || !*bucket) return -1;
    std::unique_lock<std::shared_mutex> l(E->s3_mu);
    if (flags < 0) E->s3_buckets.erase(bucket);
    else E->s3_buckets[bucket] = flags;
    return 0;
}

// multipart upload registry: parts for unknown uploadIds proxy to Python
// (which answers NoSuchUpload); create/complete/abort maintain it
int sw_fl_s3_upload_set(int h, const char* bucket, const char* upload_id,
                        int on) {
    Engine* E = engine_at(h);
    if (!E || !bucket || !upload_id) return -1;
    std::string key = std::string(bucket) + "/" + upload_id;
    std::unique_lock<std::shared_mutex> l(E->s3_mu);
    if (on) E->s3_uploads.insert(std::move(key));
    else E->s3_uploads.erase(key);
    return 0;
}

// Per-volume native-op counters: out6 = reads, writes, deletes,
// read_bytes, write_bytes, tail. Returns 0; -1 bad handle, -2 no volume.
int sw_fl_get_volume_metrics(int h, uint32_t vid, unsigned long long* out6) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    auto v = E->vol_raw(vid);
    if (!v) return -2;
    out6[0] = v->m_reads.load(std::memory_order_relaxed);
    out6[1] = v->m_writes.load(std::memory_order_relaxed);
    out6[2] = v->m_deletes.load(std::memory_order_relaxed);
    out6[3] = v->m_read_bytes.load(std::memory_order_relaxed);
    out6[4] = v->m_write_bytes.load(std::memory_order_relaxed);
    out6[5] = v->tail.load(std::memory_order_relaxed);
    return 0;
}

// Per-collection usage rollup over every registered volume's native-op
// counters. Text exposition (one line per collection, tab-separated):
//   <collection>\t<reads>\t<writes>\t<deletes>\t<read_bytes>\t<write_bytes>\n
// Untagged volumes aggregate under the empty collection name (the Python
// side maps it to its configured default). Returns bytes written;
// -1 bad handle, -2 cap too small for the full snapshot.
long sw_fl_get_usage(int h, char* out, size_t cap) {
    Engine* E = engine_at(h);
    if (!E) return -1;
    std::map<std::string, std::array<unsigned long long, 5>> agg;
    {
        std::shared_lock<std::shared_mutex> l(E->reg_mu);
        for (auto& kv : E->vols) {
            Vol* v = kv.second.get();
            auto& row = agg[std::string(v->collection)];
            row[0] += v->m_reads.load(std::memory_order_relaxed);
            row[1] += v->m_writes.load(std::memory_order_relaxed);
            row[2] += v->m_deletes.load(std::memory_order_relaxed);
            row[3] += v->m_read_bytes.load(std::memory_order_relaxed);
            row[4] += v->m_write_bytes.load(std::memory_order_relaxed);
        }
    }
    size_t o = 0;
    for (auto& kv : agg) {
        char line[256];
        int n = snprintf(line, sizeof(line),
                         "%s\t%llu\t%llu\t%llu\t%llu\t%llu\n",
                         kv.first.c_str(), kv.second[0], kv.second[1],
                         kv.second[2], kv.second[3], kv.second[4]);
        if (n < 0) continue;
        if (o + (size_t)n > cap) return -2;
        memcpy(out + o, line, (size_t)n);
        o += (size_t)n;
    }
    return (long)o;
}

}  // extern "C"
