// In-memory CPU stand-in for the reference Go/Badger search pipeline.
//
// Replicates the reference's per-query hot loop SHAPE -- for every query
// k-mer: a key-value lookup resolving the k-mer to its protein-id postings
// list, then one counter increment per posting entry; finally the counter
// map is sorted by count (sortMapByValue) and filtered by
// MinKMatch/MinKRatio and MaxResults.  Reference: search.go:421-436
// (KmerSearch), search.go:132-152 (sort), search.go:189-220 (filter).
//
// DELIBERATELY FASTER than the reference everywhere it differs: the two
// Badger LSM point reads per k-mer become one std::unordered_map lookup,
// the KComb protobuf unmarshal is skipped entirely (postings are a raw
// in-memory CSR array), and there is no HTTP/goroutine overhead.  The
// queries/s it reports is therefore a conservative UPPER bound on what the
// Go/Badger reference could do on this host, making throughput.py's
// vs_baseline a lower bound.
//
// Input: a flat binary written by kaamer_tpu_torch/bench/cpu_baseline.py.
// Output: one JSON line on stdout.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

static uint64_t rd64(FILE* f) {
    uint64_t v = 0;
    if (fread(&v, 8, 1, f) != 1) { fprintf(stderr, "short read\n"); exit(1); }
    return v;
}

template <class T>
static std::vector<T> rdvec(FILE* f, uint64_t n) {
    std::vector<T> v(n);
    if (n && fread(v.data(), sizeof(T), n, f) != n) {
        fprintf(stderr, "short read\n");
        exit(1);
    }
    return v;
}

// mode 0 ("idealized"): uint32 keys, local flat counter map, zero-copy
//   postings -- an upper bound on any CPU port of the reference ALGORITHM.
// mode 1 ("reference-shape"): models the reference's actual per-element
//   work (search.go:421-436) minus storage: per k-mer a freshly allocated
//   postings copy (proto.Unmarshal allocates ProteinKeys each call --
//   memcpy here, which is cheaper than varint decoding), per posting
//   strconv.Itoa (snprintf to a stack buffer) + a STRING-keyed counter
//   increment (the zorino/counters CounterBox is string-keyed,
//   search.go:432; a thread-local std::unordered_map<string,int> is
//   cheaper than its sharded concurrent map + atomics).  Still strictly
//   faster than Go/Badger in every remaining respect.
int main(int argc, char** argv) {
    if (argc < 2) { fprintf(stderr, "usage: %s dump.bin [threads] [mode]\n", argv[0]); return 1; }
    FILE* f = fopen(argv[1], "rb");
    if (!f) { perror("open"); return 1; }
    uint64_t nk = rd64(f), npost = rd64(f), nq = rd64(f), L = rd64(f);
    auto keys = rdvec<uint32_t>(f, nk);
    auto starts = rdvec<uint32_t>(f, nk);
    auto lens = rdvec<uint32_t>(f, nk);
    auto postings = rdvec<uint32_t>(f, npost);
    auto qk = rdvec<uint32_t>(f, nq * L);
    fclose(f);

    // kmer -> (start, len); one lookup replaces the reference's two LSM
    // point reads (kmer_store then kcomb_store)
    std::unordered_map<uint32_t, std::pair<uint32_t, uint32_t>> table;
    table.reserve(nk * 2);
    for (uint64_t i = 0; i < nk; ++i) table[keys[i]] = {starts[i], lens[i]};

    int T = argc > 2 ? atoi(argv[2]) : 2;
    int mode = argc > 3 ? atoi(argv[3]) : 0;
    const int kMinKMatch = 10, kMaxResults = 10;
    const double kMinKRatio = 0.05;

    std::atomic<uint64_t> sink{0};
    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) {
        th.emplace_back([&, t] {
            uint64_t local = 0;
            std::unordered_map<uint32_t, int> cnt;
            std::unordered_map<std::string, int> scnt;
            std::vector<std::pair<uint32_t, int>> hits;
            std::vector<uint32_t> setbuf;
            char idbuf[16];
            for (uint64_t q = t; q < nq; q += T) {
                cnt.clear();
                scnt.clear();
                const uint32_t* kp = &qk[q * L];
                for (uint64_t l = 0; l < L; ++l) {
                    auto it = table.find(kp[l]);
                    if (it == table.end()) continue;
                    uint32_t s = it->second.first, n = it->second.second;
                    // the reference's counter loop: one increment per
                    // posting entry (search.go:431-433)
                    if (mode == 0) {
                        for (uint32_t j = 0; j < n; ++j)
                            ++cnt[postings[s + j]];
                    } else {
                        // proto.Unmarshal allocates kC.ProteinKeys anew per
                        // k-mer (search.go:427-428)
                        setbuf.assign(postings.begin() + s,
                                      postings.begin() + s + n);
                        for (uint32_t id : setbuf) {
                            // strconv.Itoa + string-keyed counter
                            // (search.go:432)
                            int m = snprintf(idbuf, sizeof idbuf, "%u", id);
                            ++scnt[std::string(idbuf, m)];
                        }
                    }
                }
                if (mode == 0) {
                    hits.assign(cnt.begin(), cnt.end());
                } else {
                    hits.clear();
                    for (auto& kv : scnt)
                        hits.emplace_back(
                            (uint32_t)strtoul(kv.first.c_str(), nullptr, 10),
                            kv.second);
                }
                std::sort(hits.begin(), hits.end(),
                          [](const std::pair<uint32_t, int>& a,
                             const std::pair<uint32_t, int>& b) {
                              return a.second != b.second ? a.second > b.second
                                                          : a.first < b.first;
                          });
                int kept = 0;
                for (auto& h : hits) {
                    if (h.second < kMinKMatch ||
                        h.second < kMinKRatio * (double)L)
                        break;
                    local += h.first;  // defeat dead-code elimination
                    if (++kept >= kMaxResults) break;
                }
            }
            sink += local;
        });
    }
    for (auto& x : th) x.join();
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
    printf("{\"queries_per_s\": %.1f, \"n_queries\": %llu, \"threads\": %d, "
           "\"wall_s\": %.3f, \"checksum\": %llu}\n",
           nq / dt, (unsigned long long)nq, T, dt,
           (unsigned long long)sink.load());
    return 0;
}
