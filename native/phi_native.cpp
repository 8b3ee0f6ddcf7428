// PHI-TPU native runtime components (host side).
//
// Host-side equivalents of the reference's C substrate: streaming GFA and
// FASTA/FASTQ ingest that lands directly in dense arrays ready for device
// upload (replacing the reference's gfa-io.cpp/gfa-base.cpp/kseq.h),
// a Kahn toposort, and a banded block Myers bit-parallel edit distance for
// the evaluation harness (the reference shells out to edlib-aligner,
// data/edlib_edits.py).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// 0 = auto (hardware_concurrency capped at 8); set via phi_set_threads
// (the CLI's -t flag, reference main.cpp:53 semantics)
std::atomic<int> g_n_threads{0};

unsigned pool_size() {
  int n = g_n_threads.load(std::memory_order_relaxed);
  if (n > 0) return static_cast<unsigned>(n);
  return std::max(1u,
                  std::min<unsigned>(std::thread::hardware_concurrency(), 8));
}

// ---------------------------------------------------------------- gz lines
class GzReader {
 public:
  explicit GzReader(const char* path) : f_(gzopen(path, "rb")) {
    gzbuffer(f_, 1 << 20);
  }
  ~GzReader() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }
  // gzread returned an error (corrupt/truncated stream) — callers must
  // treat the parse as failed, not as a silently smaller dataset
  bool error() const { return err_; }
  // Reads one line (without trailing \n, and without a trailing \r so CRLF
  // input parses identically to Unix line endings — kseq.h:146 semantics)
  // into line. Returns false at EOF.
  bool getline(std::string& line) {
    line.clear();
    for (;;) {
      if (pos_ >= len_) {
        len_ = gzread(f_, buf_, sizeof(buf_));
        pos_ = 0;
        if (len_ <= 0) {
          // a truncated gzip member ends with ret=0 and Z_BUF_ERROR (not a
          // negative return) — interrogate zlib so premature EOF fails the
          // parse instead of passing as a silently smaller dataset
          int errnum = Z_OK;
          gzerror(f_, &errnum);
          if (len_ < 0 || (errnum != Z_OK && errnum != Z_STREAM_END))
            err_ = true;
          if (!line.empty() && line.back() == '\r') line.pop_back();
          return !line.empty();
        }
      }
      char* nl = static_cast<char*>(memchr(buf_ + pos_, '\n', len_ - pos_));
      if (nl) {
        line.append(buf_ + pos_, nl - (buf_ + pos_));
        pos_ = (nl - buf_) + 1;
        if (!line.empty() && line.back() == '\r') line.pop_back();
        return true;
      }
      line.append(buf_ + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gzFile f_ = nullptr;
  char buf_[1 << 20];
  int len_ = 0, pos_ = 0;
  bool err_ = false;
};

const uint8_t* base_lut() {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, 4, sizeof(lut));
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
    init = true;
  }
  return lut;
}

struct GfaHandle {
  std::vector<int64_t> node_len;
  std::vector<int64_t> node_off;
  std::vector<uint8_t> seq_code;
  std::vector<int32_t> edge_u, edge_v;
  std::vector<int32_t> walk_concat;  // vertex ids of all walks, concatenated
  std::vector<int64_t> walk_off;     // [n_walks + 1]
  std::string seg_names;             // '\0'-joined
  std::string walk_names;            // '\0'-joined "sample.hap"
  std::string seg_tags;              // '\0'-joined raw S-line tag suffixes
  std::string walk_meta;             // '\0'-joined "seq_name\tstart\tend"
  std::string error;
};

struct ReadsHandle {
  std::vector<uint8_t> codes;  // concatenated read codes
  std::vector<int64_t> off;    // [n + 1]
  std::string names;           // '\0'-joined
  std::string error;
};

std::vector<std::string> split_tab(const std::string& s, size_t max_fields) {
  std::vector<std::string> out;
  size_t start = 0;
  while (out.size() + 1 < max_fields) {
    size_t tab = s.find('\t', start);
    if (tab == std::string::npos) break;
    out.emplace_back(s, start, tab - start);
    start = tab + 1;
  }
  out.emplace_back(s, start);
  return out;
}

}  // namespace

extern "C" {

// Thread-count override for every native pool (0 = auto). The CLI's -t.
void phi_set_threads(int n) { g_n_threads.store(n); }

// ------------------------------------------------------------------- GFA
void* phi_gfa_parse(const char* path) {
  auto* h = new GfaHandle();
  h->error.reserve(64);  // catch-path assignment must not allocate
  try {
  GzReader rd(path);
  if (!rd.ok()) {
    h->error = "cannot open file";
    return h;
  }
  const uint8_t* lut = base_lut();
  // string_view keys over stable deque storage: segment lookups (hot in
  // W-line walks, millions of steps) never allocate or copy the name
  std::unordered_map<std::string_view, int32_t> seg_id;
  seg_id.reserve(1 << 20);
  std::deque<std::string> names;        // deque: elements never move
  std::vector<std::string> seqs;
  std::vector<std::string> tags;        // raw S-line tag suffix per segment
  std::vector<int64_t> declared_len;    // LN:i for '*'-sequence segments
  // raw links (u, ou, v, ov)
  std::vector<int64_t> links;
  int64_t fa_seg = -1;  // embedded-FASTA mode (gfa-io.cpp:479-499)

  // Numeric-name fast path: chopped graphs (vg/gfa2gbwt output, all the
  // reference data) use canonical decimal segment names, and W-line walks
  // look each name up millions of times — a direct-mapped table beats the
  // hash map ~20x. Non-canonical (leading-zero) or huge names fall through
  // to the map; both paths assign ids in first-appearance order.
  std::vector<int32_t> num_ids;
  constexpr uint64_t kNumCap = 1ULL << 26;  // table bounded at 256 MB

  auto add_seg = [&](std::string_view name) -> int32_t {
    int32_t id = static_cast<int32_t>(names.size());
    names.emplace_back(name);
    seg_id.emplace(std::string_view(names.back()), id);
    seqs.emplace_back();
    tags.emplace_back();
    declared_len.push_back(0);
    return id;
  };

  auto get_seg = [&](std::string_view name) -> int32_t {
    if (!name.empty() && name.size() <= 8 &&
        (name.size() == 1 || name[0] != '0')) {
      uint64_t v = 0;
      bool num = true;
      for (char c : name) {
        if (c < '0' || c > '9') {
          num = false;
          break;
        }
        v = v * 10 + static_cast<uint64_t>(c - '0');
      }
      if (num && v < kNumCap) {
        if (v < num_ids.size() && num_ids[v] >= 0) return num_ids[v];
        int32_t id = add_seg(name);
        if (v >= num_ids.size()) num_ids.resize(v + 1, -1);
        num_ids[v] = id;
        return id;
      }
    }
    auto it = seg_id.find(name);
    if (it != seg_id.end()) return it->second;
    return add_seg(name);
  };

  std::string line;
  while (rd.getline(line)) {
    if (line.size() < 2 || line[1] != '\t') {
      // embedded-FASTA mode: '>name' switches the stream; plain lines
      // append sequence to that segment
      if (!line.empty() && line[0] == '>') {
        size_t sp = line.find_first_of(" \t");
        fa_seg = get_seg(line.substr(1, sp == std::string::npos
                                            ? std::string::npos : sp - 1));
        seqs[fa_seg].clear();
      } else if (fa_seg >= 0 && !line.empty()) {
        seqs[fa_seg] += line;
      }
      continue;
    }
    fa_seg = -1;
    char t = line[0];
    if (t == 'S') {
      auto f = split_tab(line, 4);
      if (f.size() < 3) continue;
      int32_t id = get_seg(f[1]);
      if (f[2] != "*") seqs[id] = f[2];
      if (f.size() > 3) {
        tags[id] = f[3];
        if (f[2] == "*") {
          // LN:i:<len> declares the length of a sequence-less segment
          size_t pos = f[3].find("LN:i:");
          if (pos != std::string::npos &&
              (pos == 0 || f[3][pos - 1] == '\t')) {
            declared_len[id] = atoll(f[3].c_str() + pos + 5);
          }
        }
      }
    } else if (t == 'L') {
      auto f = split_tab(line, 6);
      if (f.size() < 5) continue;
      if ((f[2] != "+" && f[2] != "-") || (f[4] != "+" && f[4] != "-")) {
        h->error = "bad L-line orientation";
        return h;
      }
      int64_t u = get_seg(f[1]);
      int64_t ou = (f[2] == "-") ? 1 : 0;
      int64_t v = get_seg(f[3]);
      int64_t ov = (f[4] == "-") ? 1 : 0;
      links.push_back(u << 2 | ou << 1 | 0);
      links.push_back(v << 2 | ov << 1 | 1);
    } else if (t == 'W') {
      // view-based field split: W lines are megabytes (the whole walk) and
      // copying field 7 per walk costs ~1 GB at chromosome scale
      std::string_view lv(line);
      std::string_view f[7];
      size_t start = 0, nf = 0;
      while (nf + 1 < 7) {
        size_t tab = lv.find('\t', start);
        if (tab == std::string_view::npos) break;
        f[nf++] = lv.substr(start, tab - start);
        start = tab + 1;
      }
      f[nf++] = lv.substr(start);
      if (nf < 7) continue;
      // optional typed tags may follow the walk on GFA 1.1 W lines —
      // the walk field ends at the next tab
      size_t wt = f[6].find('\t');
      if (wt != std::string_view::npos) f[6] = f[6].substr(0, wt);
      h->walk_names.append(f[1]);
      h->walk_names.push_back('.');
      h->walk_names.append(f[2]);
      h->walk_names.push_back('\0');
      for (int c = 3; c <= 5; c++) {
        h->walk_meta.append(f[c]);
        h->walk_meta.push_back(c < 5 ? '\t' : '\0');
      }
      // parse >s1>s2<s3...
      std::string_view wk = f[6];
      std::vector<int64_t> verts;  // seg<<1 | strand
      size_t i = 0;
      while (i < wk.size()) {
        char c = wk[i];
        if (c != '>' && c != '<') {
          h->error = "bad walk char";
          return h;
        }
        size_t j = i + 1;
        while (j < wk.size() && wk[j] != '>' && wk[j] != '<') j++;
        int64_t id = get_seg(std::string_view(wk).substr(i + 1, j - i - 1));
        verts.push_back(id << 1 | (c == '<' ? 1 : 0));
        i = j;
      }
      // majority-strand flip (gfa_walk_flip semantics, gfa-io.cpp:64-115)
      size_t n_rev = 0;
      for (int64_t v : verts) n_rev += (v & 1);
      if (n_rev * 2 > verts.size()) {
        std::reverse(verts.begin(), verts.end());
        for (auto& v : verts) v ^= 1;
      }
      for (int64_t v : verts) {
        if (v & 1) {
          h->error = "walk has reverse-strand vertices after flip";
          return h;
        }
        h->walk_concat.push_back(static_cast<int32_t>(v >> 1));
      }
      h->walk_off.push_back(static_cast<int64_t>(h->walk_concat.size()));
    }
  }

  if (rd.error()) {
    h->error = "gzip stream error (corrupt or truncated input)";
    return h;
  }
  size_t n = names.size();
  // '*'-sequence segments with declared LN:i lengths: fill with 'N' so the
  // tensor invariant sum(node_len) == len(seq_code) holds
  for (size_t i = 0; i < n; i++) {
    if (declared_len[i] > 0 && seqs[i].empty())
      seqs[i].assign(static_cast<size_t>(declared_len[i]), 'N');
  }
  h->node_len.resize(n);
  h->node_off.resize(n + 1);
  int64_t off = 0;
  for (size_t i = 0; i < n; i++) {
    h->node_off[i] = off;
    h->node_len[i] = static_cast<int64_t>(seqs[i].size());
    off += h->node_len[i];
  }
  h->node_off[n] = off;
  h->seq_code.resize(off);
  for (size_t i = 0; i < n; i++) {
    const std::string& s = seqs[i];
    uint8_t* dst = h->seq_code.data() + h->node_off[i];
    for (size_t j = 0; j < s.size(); j++) dst[j] = lut[(uint8_t)s[j]];
  }
  for (const std::string& name : names) {
    h->seg_names += name;
    h->seg_names.push_back('\0');
  }
  for (const std::string& tg : tags) {
    h->seg_tags += tg;
    h->seg_tags.push_back('\0');
  }
  // walk_off needs leading 0
  h->walk_off.insert(h->walk_off.begin(), 0);

  // fold links to forward edges (ILP_index.cpp:53-84 semantics):
  //   ou=='+' -> u->v ; ov=='-' -> v->u
  std::vector<int64_t> packed;
  packed.reserve(links.size() / 2);
  for (size_t i = 0; i + 1 < links.size(); i += 2) {
    int64_t u = links[i] >> 2, ou = (links[i] >> 1) & 1;
    int64_t v = links[i + 1] >> 2, ov = (links[i + 1] >> 1) & 1;
    if (ou == 0) packed.push_back(u << 32 | v);
    if (ov == 1) packed.push_back(v << 32 | u);
  }
  std::sort(packed.begin(), packed.end());
  packed.erase(std::unique(packed.begin(), packed.end()), packed.end());
  h->edge_u.reserve(packed.size());
  h->edge_v.reserve(packed.size());
  for (int64_t p : packed) {
    h->edge_u.push_back(static_cast<int32_t>(p >> 32));
    h->edge_v.push_back(static_cast<int32_t>(p & 0xFFFFFFFF));
  }
  return h;
  } catch (...) {
    *h = GfaHandle{};  // drop partial contents (move-assign, no alloc)
    h->error = "native allocation failure";
    return h;
  }
}

const char* phi_gfa_error(void* hp) {
  return static_cast<GfaHandle*>(hp)->error.c_str();
}
int64_t phi_gfa_n_vtx(void* hp) {
  return static_cast<int64_t>(static_cast<GfaHandle*>(hp)->node_len.size());
}
int64_t phi_gfa_n_edges(void* hp) {
  return static_cast<int64_t>(static_cast<GfaHandle*>(hp)->edge_u.size());
}
int64_t phi_gfa_n_walks(void* hp) {
  return static_cast<int64_t>(static_cast<GfaHandle*>(hp)->walk_off.size()) - 1;
}
int64_t phi_gfa_seq_len(void* hp) {
  return static_cast<int64_t>(static_cast<GfaHandle*>(hp)->seq_code.size());
}
int64_t phi_gfa_walk_total(void* hp) {
  return static_cast<int64_t>(static_cast<GfaHandle*>(hp)->walk_concat.size());
}
const int64_t* phi_gfa_node_len(void* hp) {
  return static_cast<GfaHandle*>(hp)->node_len.data();
}
const int64_t* phi_gfa_node_off(void* hp) {
  return static_cast<GfaHandle*>(hp)->node_off.data();
}
const uint8_t* phi_gfa_seq_code(void* hp) {
  return static_cast<GfaHandle*>(hp)->seq_code.data();
}
const int32_t* phi_gfa_edge_u(void* hp) {
  return static_cast<GfaHandle*>(hp)->edge_u.data();
}
const int32_t* phi_gfa_edge_v(void* hp) {
  return static_cast<GfaHandle*>(hp)->edge_v.data();
}
const int32_t* phi_gfa_walk_concat(void* hp) {
  return static_cast<GfaHandle*>(hp)->walk_concat.data();
}
const int64_t* phi_gfa_walk_off(void* hp) {
  return static_cast<GfaHandle*>(hp)->walk_off.data();
}
const char* phi_gfa_seg_names(void* hp, int64_t* len) {
  auto* h = static_cast<GfaHandle*>(hp);
  *len = static_cast<int64_t>(h->seg_names.size());
  return h->seg_names.data();
}
const char* phi_gfa_walk_names(void* hp, int64_t* len) {
  auto* h = static_cast<GfaHandle*>(hp);
  *len = static_cast<int64_t>(h->walk_names.size());
  return h->walk_names.data();
}
const char* phi_gfa_seg_tags(void* hp, int64_t* len) {
  auto* h = static_cast<GfaHandle*>(hp);
  *len = static_cast<int64_t>(h->seg_tags.size());
  return h->seg_tags.data();
}
const char* phi_gfa_walk_meta(void* hp, int64_t* len) {
  auto* h = static_cast<GfaHandle*>(hp);
  *len = static_cast<int64_t>(h->walk_meta.size());
  return h->walk_meta.data();
}
void phi_gfa_free(void* hp) { delete static_cast<GfaHandle*>(hp); }

// ------------------------------------------------------------- FASTA/FASTQ
void* phi_reads_load(const char* path) {
  auto* h = new ReadsHandle();
  h->error.reserve(64);  // catch-path assignment must not allocate
  try {
  GzReader rd(path);
  if (!rd.ok()) {
    h->error = "cannot open file";
    return h;
  }
  const uint8_t* lut = base_lut();
  h->off.push_back(0);
  std::string line;
  bool have_first = rd.getline(line);
  if (!have_first) return h;
  auto append_seq = [&](const std::string& s) {
    size_t base = h->codes.size();
    h->codes.resize(base + s.size());
    for (size_t j = 0; j < s.size(); j++) h->codes[base + j] = lut[(uint8_t)s[j]];
  };
  if (line[0] == '>') {  // FASTA
    for (;;) {
      size_t sp = line.find_first_of(" \t");
      h->names.append(line, 1, (sp == std::string::npos ? line.size() : sp) - 1);
      h->names.push_back('\0');
      bool more = false;
      while ((more = rd.getline(line))) {
        if (line[0] == '>') break;
        append_seq(line);
      }
      h->off.push_back(static_cast<int64_t>(h->codes.size()));
      if (!more) break;
    }
  } else if (line[0] == '@') {  // FASTQ
    for (;;) {
      size_t names_mark = h->names.size();
      size_t sp = line.find_first_of(" \t");
      h->names.append(line, 1, (sp == std::string::npos ? line.size() : sp) - 1);
      h->names.push_back('\0');
      std::string seq;
      if (!rd.getline(seq)) {
        h->names.resize(names_mark);  // truncated record: drop its name
        break;
      }
      append_seq(seq);
      h->off.push_back(static_cast<int64_t>(h->codes.size()));
      std::string plus, qual;
      if (!rd.getline(plus) || !rd.getline(qual)) break;
      if (!rd.getline(line) || line.empty() || line[0] != '@') break;
    }
  } else {
    h->error = "not FASTA/FASTQ";
  }
  if (rd.error()) h->error = "gzip stream error (corrupt or truncated input)";
  return h;
  } catch (...) {
    *h = ReadsHandle{};
    h->error = "native allocation failure";
    return h;
  }
}

const char* phi_reads_error(void* hp) {
  return static_cast<ReadsHandle*>(hp)->error.c_str();
}
int64_t phi_reads_count(void* hp) {
  return static_cast<int64_t>(static_cast<ReadsHandle*>(hp)->off.size()) - 1;
}
int64_t phi_reads_total(void* hp) {
  return static_cast<int64_t>(static_cast<ReadsHandle*>(hp)->codes.size());
}
const uint8_t* phi_reads_codes(void* hp) {
  return static_cast<ReadsHandle*>(hp)->codes.data();
}
const int64_t* phi_reads_off(void* hp) {
  return static_cast<ReadsHandle*>(hp)->off.data();
}
const char* phi_reads_names(void* hp, int64_t* len) {
  auto* h = static_cast<ReadsHandle*>(hp);
  *len = static_cast<int64_t>(h->names.size());
  return h->names.data();
}
void phi_reads_free(void* hp) { delete static_cast<ReadsHandle*>(hp); }

// ---------------------------------------------------------------- toposort
// Kahn; returns 0 on success, 1 on cycle. order must hold n entries.
int phi_toposort(int64_t n, int64_t m, const int32_t* eu, const int32_t* ev,
                 int32_t* order) {
  std::vector<int64_t> indeg(n, 0), off(n + 1, 0);
  for (int64_t i = 0; i < m; i++) {
    indeg[ev[i]]++;
    off[eu[i] + 1]++;
  }
  for (int64_t i = 0; i < n; i++) off[i + 1] += off[i];
  std::vector<int32_t> succ(m);
  std::vector<int64_t> fill(off.begin(), off.end() - 1);
  for (int64_t i = 0; i < m; i++) succ[fill[eu[i]]++] = ev[i];
  std::vector<int32_t> stack;
  for (int64_t i = n - 1; i >= 0; i--)
    if (indeg[i] == 0) stack.push_back(static_cast<int32_t>(i));
  int64_t done = 0;
  while (!stack.empty()) {
    int32_t u = stack.back();
    stack.pop_back();
    order[done++] = u;
    for (int64_t j = off[u]; j < off[u + 1]; j++) {
      if (--indeg[succ[j]] == 0) stack.push_back(succ[j]);
    }
  }
  return done == n ? 0 : 1;
}

// ------------------------------------------------------- minimizer scan
// Exact counterpart of the JAX sketch semantics (which in turn mirror the
// reference's string-deque scan, ILP_index.cpp:359-445): canonical k-mer =
// numeric min(fwd, revcomp) of the 2-bit big-endian packing, window minimum
// with rightmost tie-break, consecutive equal-value emissions deduplicated,
// k-mers containing non-ACGT codes excluded. Used as the CPU fast path.
//
// Returns the emission count; writes up to cap triples. If the count
// exceeds cap, output beyond cap is dropped (caller retries with a larger
// cap using the returned count).
}  // extern "C" (template below; linkage resumes after)

// Feed-based minimizer scan state machine: callers push base codes one at
// a time (contiguous arrays, or walks streamed straight from graph
// tensors). Exact reference semantics (see phi_minimizers note below).
// Value type V is uint64_t for k <= 31 (collision-free 2-bit packing) or
// unsigned __int128 for k in (31, 63] — selection and consecutive-dup
// removal compare the FULL canonical packing (== the reference's
// lexicographic string order for ACGT), and only the emitted JOIN KEY is
// folded to 64 bits (fold128_64 below; the reference itself joins on a
// folded 128-bit MurmurHash, ILP_index.cpp:10-18).
template <class V, class Emit>
struct MinScan {
  const int k, w;
  const V mask;
  const int rc_shift;
  Emit emit;
  V fwd = 0, rc = 0;
  int valid_run = 0;
  std::vector<V> dqv;
  std::vector<int64_t> dqp;
  size_t rmask, head = 0, tail = 0;  // [head, tail)
  V prev_val = ~(V)0;
  bool have_prev = false;
  int64_t j = 0;  // bases consumed

  MinScan(int k_, int w_, Emit emit_)
      : k(k_), w(w_),
        mask((2 * k_ < (int)(8 * sizeof(V))) ? (((V)1 << (2 * k_)) - 1)
                                             : ~(V)0),
        rc_shift(2 * (k_ - 1)), emit(emit_) {
    size_t ring = 8;
    while (ring < (size_t)(w + 1)) ring <<= 1;
    rmask = ring - 1;
    dqv.resize(ring);
    dqp.resize(ring);
  }

  inline void feed(uint8_t c) {
    if (c < 4) {
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((V)(3 - c) << rc_shift);
      valid_run++;
    } else {
      valid_run = 0;
    }
    int64_t i = j++ - k + 1;  // k-mer start index
    if (i < 0) return;
    if (valid_run >= k) {
      V cur = fwd < rc ? fwd : rc;
      while (tail > head && dqv[(tail - 1) & rmask] >= cur) tail--;
      dqv[tail & rmask] = cur;
      dqp[tail & rmask] = i;
      tail++;
    }
    if (tail > head && dqp[head & rmask] <= i - w) head++;
    if (i >= w - 1 && tail > head) {
      V best = dqv[head & rmask];
      if (!have_prev || best != prev_val) {
        prev_val = best;
        have_prev = true;
        emit(best, dqp[head & rmask]);
      }
    }
  }
};

// splitmix64 finalizer — must match the python twin
// (phi_tpu/sketch/encode.py::fold128_64) bit for bit.
static inline uint64_t phi_mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

static inline uint64_t fold128_64(unsigned __int128 v) {
  return phi_mix64((uint64_t)(v >> 64) * 0x9E3779B97F4A7C15ULL
                   ^ phi_mix64((uint64_t)v));
}

static const int PHI_MAX_K_WIDE = 63;

template <class Emit>
static inline void minimizer_scan(const uint8_t* codes, int64_t n, int k,
                                  int w, Emit emit) {
  if (k < 1 || k > PHI_MAX_K_WIDE || w < 1 || n < (int64_t)(k + w - 1))
    return;
  if (k <= 31) {
    MinScan<uint64_t, Emit> scan(k, w, emit);
    for (int64_t j = 0; j < n; j++) scan.feed(codes[j]);
  } else {
    auto wrap = [&](unsigned __int128 best, int64_t pos) {
      emit(fold128_64(best), pos);
    };
    MinScan<unsigned __int128, decltype(wrap)> scan(k, w, wrap);
    for (int64_t j = 0; j < n; j++) scan.feed(codes[j]);
  }
}

extern "C" {

int64_t phi_minimizers(const uint8_t* codes, int64_t n, int k, int w,
                       uint32_t* out_hi, uint32_t* out_lo, int32_t* out_pos,
                       int64_t cap) {
  int64_t count = 0;
  minimizer_scan(codes, n, k, w, [&](uint64_t best, int64_t pos) {
    if (count < cap) {
      out_hi[count] = (uint32_t)(best >> 32);
      out_lo[count] = (uint32_t)best;
      out_pos[count] = (int32_t)pos;
    }
    count++;
  });
  return count;
}

// ------------------------------------------------- per-read spectrum scan
// Each read of the ragged concatenation is scanned independently (the
// reference's per-read compute_hashes semantics, ILP_index.cpp:447-493);
// emitted canonical keys (hi<<32|lo, duplicates included) are collected.
// The spectrum is a set, so buffer order across threads is irrelevant.
// Returns the total emission count; writes keys only when total <= cap
// (caller retries with the returned count as the new cap).
int64_t phi_spectrum(const uint8_t* concat, const int64_t* off,
                     int64_t n_reads, int k, int w, uint64_t* out,
                     int64_t cap) try {
  unsigned n_thr = pool_size();
  if (n_reads < 64) n_thr = 1;
  std::vector<std::vector<uint64_t>> bufs(n_thr);
  std::atomic<int64_t> next{0};
  const int64_t grain = 256;  // reads per work unit
  auto work = [&](unsigned t) {
    auto& buf = bufs[t];
    for (int64_t g; (g = next.fetch_add(grain)) < n_reads;) {
      int64_t end = std::min(g + grain, n_reads);
      for (int64_t r = g; r < end; r++)
        minimizer_scan(concat + off[r], off[r + 1] - off[r], k, w,
                       [&](uint64_t best, int64_t) { buf.push_back(best); });
    }
  };
  if (n_thr == 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < n_thr; t++) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
  }
  int64_t total = 0;
  for (auto& b : bufs) total += (int64_t)b.size();
  if (total <= cap) {
    int64_t at = 0;
    for (auto& b : bufs) {
      std::copy(b.begin(), b.end(), out + at);
      at += (int64_t)b.size();
    }
  }
  return total;
} catch (...) {
  return -1;
}

// ---------------------------------------------------- haplotype sketch+join
// Scan one sequence (exact minimizer semantics above) and binary-search each
// emission against the sorted spectrum keys — the host fast path of the
// per-haplotype join (ILP_index.cpp:495-526's hash join, done on sorted
// arrays). Writes matching (k-mer start pos, spectrum id) pairs. Returns the
// hit count; *n_min_out gets the total emission count. Output is written
// only while hits <= cap (caller retries with the returned count).
// bucket_off ([1 << prefix_bits] + 1 entries, from numpy searchsorted over
// the key top bits) turns the full binary search into a first-probe table
// lookup plus a short in-bucket search — at multi-Gbp scale the ~23 random
// cacheline reads per emission were the join's whole cost. Pass
// bucket_off = NULL / prefix_bits = 0 for the plain binary search.
int64_t phi_hap_join_walk(const uint8_t* seq_code, const int64_t* node_off,
                          const int32_t* walk, int64_t n_walk, int k, int w,
                          const uint64_t* keys, int64_t n_keys,
                          const int64_t* bucket_off, int prefix_bits,
                          int32_t* out_pos, int32_t* out_sid, int64_t cap,
                          int64_t* n_min_out);

int64_t phi_hap_join(const uint8_t* codes, int64_t n, int k, int w,
                     const uint64_t* keys, int64_t n_keys,
                     const int64_t* bucket_off, int prefix_bits,
                     int32_t* out_pos, int32_t* out_sid, int64_t cap,
                     int64_t* n_min_out) {
  // one-node walk over the contiguous array: a single join implementation
  const int64_t off[2] = {0, n};
  const int32_t one_walk[1] = {0};
  return phi_hap_join_walk(codes, off, one_walk, 1, k, w, keys, n_keys,
                           bucket_off, prefix_bits, out_pos, out_sid, cap,
                           n_min_out);
}

// Walk-streaming variant: scan the haplotype straight out of the graph
// tensors (seq_code gathered node by node) — no 2.25 GB of materialized
// walk concatenations at chromosome scale. Join semantics identical to
// phi_hap_join.
int64_t phi_hap_join_walk(const uint8_t* seq_code, const int64_t* node_off,
                          const int32_t* walk, int64_t n_walk, int k, int w,
                          const uint64_t* keys, int64_t n_keys,
                          const int64_t* bucket_off, int prefix_bits,
                          int32_t* out_pos, int32_t* out_sid, int64_t cap,
                          int64_t* n_min_out) try {
  *n_min_out = 0;
  if (k < 1 || k > PHI_MAX_K_WIDE || w < 1) return 0;
  int64_t n_min = 0, n_hit = 0;
  const int shift = 64 - prefix_bits;
  // Prefetch-batched probing: at chromosome scale the join issues ~200M
  // bucketed binary searches over a ~50 MB key array — pure random-miss
  // latency. Emissions buffer into a small batch; one pass prefetches each
  // probe's bucket bounds, a second prefetches the bucket's key lines,
  // then the searches run on resident lines. Hit order (and so output
  // order) is exactly emission order.
  constexpr int kBatch = 16;
  uint64_t bb[kBatch];
  int64_t bp[kBatch];
  int nb = 0;
  auto probe_one = [&](uint64_t best, int64_t pos) {
    const uint64_t* lo = keys;
    const uint64_t* hi = keys + n_keys;
    if (bucket_off) {
      uint64_t b = best >> shift;
      lo = keys + bucket_off[b];
      hi = keys + bucket_off[b + 1];
    }
    const uint64_t* it = std::lower_bound(lo, hi, best);
    if (it != hi && *it == best) {
      if (n_hit < cap) {
        out_pos[n_hit] = (int32_t)pos;
        out_sid[n_hit] = (int32_t)(it - keys);
      }
      n_hit++;
    }
  };
  auto flush = [&] {
    if (bucket_off) {
      for (int i = 0; i < nb; i++)
        __builtin_prefetch(&bucket_off[bb[i] >> shift]);
      for (int i = 0; i < nb; i++) {
        const uint64_t* lo = keys + bucket_off[bb[i] >> shift];
        const uint64_t* hi = keys + bucket_off[(bb[i] >> shift) + 1];
        for (const uint64_t* q = lo; q < hi; q += 8) __builtin_prefetch(q);
        if (hi > lo) __builtin_prefetch(hi - 1);
      }
    }
    for (int i = 0; i < nb; i++) probe_one(bb[i], bp[i]);
    nb = 0;
  };
  auto emit = [&](uint64_t best, int64_t pos) {
    n_min++;
    bb[nb] = best;
    bp[nb] = pos;
    if (++nb == kBatch) flush();
  };
  if (k <= 31) {
    MinScan<uint64_t, decltype(emit)> scan(k, w, emit);
    for (int64_t i = 0; i < n_walk; i++) {
      const uint8_t* p = seq_code + node_off[walk[i]];
      const uint8_t* e = seq_code + node_off[walk[i] + 1];
      for (; p < e; ++p) scan.feed(*p);
    }
  } else {
    auto wrap = [&](unsigned __int128 best, int64_t pos) {
      emit(fold128_64(best), pos);
    };
    MinScan<unsigned __int128, decltype(wrap)> scan(k, w, wrap);
    for (int64_t i = 0; i < n_walk; i++) {
      const uint8_t* p = seq_code + node_off[walk[i]];
      const uint8_t* e = seq_code + node_off[walk[i] + 1];
      for (; p < e; ++p) scan.feed(*p);
    }
  }
  flush();
  *n_min_out = n_min;
  return n_hit;
} catch (...) {
  return -1;  // bad_alloc etc. must not cross the C ABI (aborts Python)
}

// Two-pointer merge: idx[i] = number of sorted_keys <= sorted_queries[i]
// (searchsorted side='right' over ASCENDING queries) — O(n+m) sequential
// instead of m binary searches over a cold array.
void phi_merge_upper(const uint64_t* keys, int64_t n,
                     const uint64_t* queries, int64_t m, int64_t* out_idx) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; i++) {
    uint64_t q = queries[i];
    while (p < n && keys[p] <= q) p++;
    out_idx[i] = p;
  }
}

// ------------------------------------------------- banded Myers edit distance
// Block bit-parallel Myers (Hyyro 2003) with Ukkonen band doubling — the
// algorithm family behind edlib, written from scratch. query = rows,
// target = columns, codes 0..4 (4 matches nothing, not even itself, matching
// edit-distance over literal N mismatches conservatively).
namespace myers {

struct Block {
  uint64_t vp = ~0ULL, vn = 0;
  int score = 0;
};

inline int advance_block(Block& b, uint64_t eq, int hin) {
  uint64_t pv = b.vp, mv = b.vn;
  uint64_t xv = eq | mv;
  if (hin < 0) eq |= 1ULL;
  uint64_t xh = (((eq & pv) + pv) ^ pv) | eq;
  uint64_t ph = mv | ~(xh | pv);
  uint64_t mh = pv & xh;
  int hout = 0;
  if (ph & (1ULL << 63)) hout = 1;
  if (mh & (1ULL << 63)) hout = -1;
  ph <<= 1;
  mh <<= 1;
  if (hin < 0) mh |= 1ULL;
  if (hin > 0) ph |= 1ULL;
  b.vp = mh | ~(xv | ph);
  b.vn = ph & xv;
  b.score += hout;
  return hout;
}

// Lower bound on the final-cell cost of any path through block b at column j:
// min over rows i in the block of |(qlen-1-i) - (tlen-1-j)| (every remaining
// step changes (row gap - col gap) by at most 1).
inline int64_t block_tail_lb(int64_t b, int64_t j, int64_t qlen, int64_t tlen,
                             int64_t nblk) {
  int64_t a = b * 64;
  int64_t z = std::min(b * 64 + 63, qlen - 1);
  int64_t i_star = j + qlen - tlen;  // row with zero tail imbalance
  int64_t i = std::min(std::max(i_star, a), z);
  int64_t d = (qlen - 1 - i) - (tlen - 1 - j);
  return d < 0 ? -d : d;
}

int distance(const uint8_t* q, int64_t qlen, const uint8_t* t, int64_t tlen,
             int64_t k_limit) {
  if (qlen == 0) return static_cast<int>(tlen);
  if (tlen == 0) return static_cast<int>(qlen);
  int64_t nblk = (qlen + 63) / 64;
  std::vector<uint64_t> peq(nblk * 5, 0);
  for (int64_t i = 0; i < qlen; i++) {
    int c = q[i];
    if (c < 4) peq[(i / 64) * 5 + c] |= 1ULL << (i % 64);
  }
  int64_t k = (k_limit > 0) ? k_limit
                            : std::max<int64_t>(128, (qlen > tlen ? qlen - tlen
                                                                  : tlen - qlen) * 2);
  for (;;) {
    std::vector<Block> blk(nblk);
    for (int64_t b = 0; b < nblk; b++)
      blk[b].score = static_cast<int>((b + 1) * 64);
    int64_t first = 0;
    int64_t last = std::min(nblk - 1, k / 64 + 1);
    int best_final = -1;
    bool band_empty = false;
    for (int64_t j = 0; j < tlen; j++) {
      // advance the band top: a block whose bottom row i satisfies
      // (j - i) + |(j - i) + qlen - tlen| > k is permanently hopeless
      // (D[i][j] >= j - i above the diagonal, and the certificate is
      // monotone in j), so the virtual incrementing boundary row is sound.
      while (first <= last) {
        int64_t ib = std::min(64 * (first + 1) - 1, qlen - 1);
        int64_t di = j - ib;
        if (di > 0 && di + std::abs(di + qlen - tlen) > static_cast<int64_t>(k))
          first++;
        else
          break;
      }
      if (first > last) {
        band_empty = true;
        break;
      }
      int c = t[j];
      int hin = 1;  // true D[-1][j] boundary at first==0; virtual row above otherwise
      for (int64_t b = first; b <= last; b++) {
        uint64_t eq = (c < 4) ? peq[b * 5 + c] : 0;
        hin = advance_block(blk[b], eq, hin);
      }
      // extend: add blocks (vertical-only init at this column) while a cell
      // in them could still lie on a <=k path (mirror of the prune test:
      // any cell below is >= min cell of the current last block)
      while (last < nblk - 1 &&
             static_cast<int64_t>(blk[last].score) - 63 +
                     block_tail_lb(last + 1, j, qlen, tlen, nblk)
                 <= static_cast<int64_t>(k)) {
        Block nb;
        nb.vp = ~0ULL;
        nb.vn = 0;
        nb.score = blk[last].score + 64;
        blk[last + 1] = nb;
        last++;
      }
      // shrink: drop blocks whose every cell is provably hopeless
      while (last > first &&
             static_cast<int64_t>(blk[last].score) - 63 +
                     block_tail_lb(last, j, qlen, tlen, nblk) >
                 static_cast<int64_t>(k)) {
        last--;
      }
      if (last == nblk - 1 && j == tlen - 1) {
        int sc = blk[last].score;
        int extra = static_cast<int>(nblk * 64 - qlen);
        uint64_t vp = blk[last].vp, vn = blk[last].vn;
        for (int e = 0; e < extra; e++) {  // walk up over padded rows
          uint64_t bit = 1ULL << (63 - e);
          if (vp & bit) sc--;
          else if (vn & bit) sc++;
        }
        best_final = sc;
      }
    }
    (void)band_empty;
    if (best_final >= 0 && best_final <= k) return best_final;
    if (k >= qlen + tlen)
      return best_final >= 0 ? best_final
                             : static_cast<int>(std::max(qlen, tlen));
    k *= 2;
  }
}

}  // namespace myers

int64_t phi_edit_distance(const uint8_t* q, int64_t qlen, const uint8_t* t,
                          int64_t tlen, int64_t k_limit) {
  return myers::distance(q, qlen, t, tlen, k_limit);
}

// ------------------------------------------------------------------ anchors
// Single-pass anchor-table construction (the hot part of
// anchors/join.py:anchor_tables_from_hits, which is the rebuild of
// ILP_index.cpp:495-526 compute_anchors + :670-722 threshold filter):
// per-hap hit base positions -> walk-position intervals (linear merge with
// the walk's cumulative base lengths), a splitmix64 run-identity hash over
// the spanned vertices, sort-based (kmer, run)-group counting, and the
// drop-the-whole-kmer filter. Hash constants match the Python reference
// implementation bit-for-bit so the two paths are parity-testable.

namespace anchors {

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

struct Handle {
  std::vector<int32_t> occ_hap, occ_start, occ_end, occ_kmer;
  std::vector<int64_t> per_hap_anchors;
  int64_t n_model_kmers = 0;
  int64_t filtered_kmers = 0;
};

// PHI_NATIVE_TIMING=1: phase wall-clocks on stderr (perf diagnosis only)
inline bool timing_enabled() {
  static const bool on = [] {
    const char* e = getenv("PHI_NATIVE_TIMING");
    return e && *e == '1';
  }();
  return on;
}

inline double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

}  // namespace anchors

// Anchor-table construction from per-haplotype join hits. hit_pos_ph /
// hit_sid_ph are PER-HAP pointers (no host-side concatenation: at
// chromosome scale the hit arrays are ~1 GB and the copy the old
// single-buffer signature forced was the dominant cost of the phase).
// Hits must ascend in pos within each hap (the join emits them that way);
// pass 1 verifies while advancing and the call returns nullptr on
// violation, which callers treat as "fall back to the numpy path".
void* phi_anchors(int64_t n_haps, int64_t P, const int32_t* walk_mat,
                  const int32_t* walk_len, const int64_t* node_len,
                  const int64_t* hit_cnt, const int32_t* const* hit_pos_ph,
                  const int32_t* const* hit_sid_ph, int64_t spectrum_size,
                  int32_t k, double threshold) try {
  auto* h = new anchors::Handle();
  std::vector<int64_t> hit_off(n_haps + 1, 0);
  for (int64_t hp = 0; hp < n_haps; hp++)
    hit_off[hp + 1] = hit_off[hp] + hit_cnt[hp];
  int64_t total = hit_off[n_haps];
  h->per_hap_anchors.assign(n_haps, 0);
  double t0 = anchors::timing_enabled() ? anchors::now_s() : 0.0;

  // pass 1: intervals + run hashes; haps are independent, so split them
  // across a small thread pool (each hap's hit range is contiguous)
  std::vector<int32_t> o_hap(total), o_start(total), o_end(total);
  std::vector<int32_t> g_sid(total);  // linear-access sid view for passes 2/3
  std::vector<uint64_t> group_key(total);
  std::atomic<bool> bad_order{false};
  auto pass1 = [&](int64_t hp) {
    const int32_t* wm = walk_mat + hp * P;
    const int32_t* pos_a = hit_pos_ph[hp];
    const int32_t* sid_a = hit_sid_ph[hp];
    int64_t L = walk_len[hp];
    int64_t s_idx = 0, e_idx = 0;       // walk positions of interval ends
    int64_t s_base = 0, e_base = 0;     // base offset of position starts
    int64_t prev_pos = -1;
    for (int64_t j = 0; j < hit_cnt[hp]; j++) {
      int64_t i = hit_off[hp] + j;
      int64_t pos = pos_a[j];
      if (pos < prev_pos) { bad_order.store(true); return; }
      prev_pos = pos;
      int64_t last = pos + k - 1;
      // advance (hits ascend in pos within a hap)
      while (s_idx + 1 < L && s_base + node_len[wm[s_idx]] <= pos)
        s_base += node_len[wm[s_idx++]];
      if (e_idx < s_idx) { e_idx = s_idx; e_base = s_base; }
      while (e_idx + 1 < L && e_base + node_len[wm[e_idx]] <= last)
        e_base += node_len[wm[e_idx++]];
      o_hap[i] = static_cast<int32_t>(hp);
      o_start[i] = static_cast<int32_t>(s_idx);
      o_end[i] = static_cast<int32_t>(e_idx);
      g_sid[i] = sid_a[j];
      uint64_t rh = 1;
      for (int64_t p = s_idx; p <= e_idx; p++)
        rh = anchors::mix64(rh ^ static_cast<uint64_t>(wm[p]));
      group_key[i] = anchors::mix64(static_cast<uint64_t>(sid_a[j]) ^ rh);
    }
  };
  unsigned n_thr = pool_size();
  if (n_haps <= 1 || n_thr <= 1) {
    for (int64_t hp = 0; hp < n_haps; hp++) pass1(hp);
  } else {
    std::vector<std::thread> pool;
    std::atomic<int64_t> next_hp{0};
    for (unsigned t = 0; t < n_thr; t++)
      pool.emplace_back([&] {
        for (int64_t hp; (hp = next_hp.fetch_add(1)) < n_haps;) pass1(hp);
      });
    for (auto& th : pool) th.join();
  }
  if (bad_order.load()) { delete h; return nullptr; }

  if (anchors::timing_enabled()) {
    fprintf(stderr, "[phi_anchors] pass1 %.2f s (%lld hits)\n",
            anchors::now_s() - t0, (long long)total);
    t0 = anchors::now_s();
  }

  // pass 2: group counting (sorted (key, sid) pairs — direct sort is
  // cache-friendlier than an indirect comparator) -> bad groups -> bad k-mers
  // (shared atomic flags: relaxed same-value stores from any thread are
  // race-free and avoid per-thread spectrum_size scratch + a serial merge)
  std::unique_ptr<std::atomic<uint8_t>[]> bad_sid(
      new std::atomic<uint8_t>[spectrum_size]());
  {
    // group_key values are mix64 outputs (uniform), so an 8-bit top-prefix
    // partition splits the pairs into 256 balanced buckets; groups never
    // cross buckets, so each bucket sorts and run-scans independently on
    // the thread pool — no global sort, no merge. The partition itself is
    // a two-phase parallel scatter: threads own contiguous input chunks,
    // count per bucket, then write into disjoint per-(thread,bucket)
    // slices (order within a bucket is irrelevant — it gets sorted).
    constexpr int kBk = 256;
    unsigned nt = pool_size();
    int64_t chunk = nt > 1 ? (total + nt - 1) / nt : total;
    unsigned n_chunks = nt > 1 && total
        ? static_cast<unsigned>((total + chunk - 1) / chunk) : 1;
    std::vector<std::vector<int64_t>> tcnt(n_chunks,
                                           std::vector<int64_t>(kBk, 0));
    std::vector<std::pair<uint64_t, int32_t>> ks(total);
    auto count_chunk = [&](unsigned t) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(total, lo + chunk);
      auto& c = tcnt[t];
      for (int64_t i = lo; i < hi; i++) c[group_key[i] >> 56]++;
    };
    std::vector<int64_t> bcnt(kBk + 1, 0);
    if (n_chunks <= 1) {
      count_chunk(0);
    } else {
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < n_chunks; t++)
        pool.emplace_back(count_chunk, t);
      for (auto& th : pool) th.join();
    }
    for (int b = 0; b < kBk; b++) {
      bcnt[b + 1] = bcnt[b];
      for (unsigned t = 0; t < n_chunks; t++) bcnt[b + 1] += tcnt[t][b];
    }
    {
      // per-(thread,bucket) start offsets, then independent scatters
      std::vector<std::vector<int64_t>> tfill(n_chunks,
                                              std::vector<int64_t>(kBk));
      for (int b = 0; b < kBk; b++) {
        int64_t at = bcnt[b];
        for (unsigned t = 0; t < n_chunks; t++) {
          tfill[t][b] = at;
          at += tcnt[t][b];
        }
      }
      auto fill_chunk = [&](unsigned t) {
        int64_t lo = t * chunk, hi = std::min<int64_t>(total, lo + chunk);
        auto& f = tfill[t];
        for (int64_t i = lo; i < hi; i++)
          ks[f[group_key[i] >> 56]++] = {group_key[i], g_sid[i]};
      };
      if (n_chunks <= 1) {
        fill_chunk(0);
      } else {
        std::vector<std::thread> pool;
        for (unsigned t = 0; t < n_chunks; t++)
          pool.emplace_back(fill_chunk, t);
        for (auto& th : pool) th.join();
      }
    }
    double cutoff = threshold * static_cast<double>(n_haps);
    std::atomic<int64_t> next_bk{0};
    auto work_bucket = [&] {
      for (int64_t b; (b = next_bk.fetch_add(1)) < kBk;) {
        auto* lo = ks.data() + bcnt[b];
        auto* hi = ks.data() + bcnt[b + 1];
        std::sort(lo, hi,
                  [](const auto& a, const auto& c) { return a.first < c.first; });
        for (auto* run = lo; run < hi;) {
          auto* end = run;
          while (end < hi && end->first == run->first) end++;
          if (static_cast<double>(end - run) >= cutoff) {
            for (auto* j = run; j < end; j++)
              bad_sid[j->second].store(1, std::memory_order_relaxed);
          }
          run = end;
        }
      }
    };
    if (nt <= 1) {
      work_bucket();
    } else {
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < nt; t++) pool.emplace_back(work_bucket);
      for (auto& th : pool) th.join();
    }
  }
  for (int64_t s = 0; s < spectrum_size; s++)
    h->filtered_kmers += bad_sid[s].load(std::memory_order_relaxed);

  if (anchors::timing_enabled()) {
    fprintf(stderr, "[phi_anchors] pass2 %.2f s\n", anchors::now_s() - t0);
    t0 = anchors::now_s();
  }

  // pass 3: retained occurrences; solver keeps multi-vertex ones. Haps own
  // contiguous ranges, so count-per-hap then fill-at-offset parallelizes
  // without any merge; model_sid flags use the same relaxed-store trick as
  // bad_sid (same-value stores from any thread are race-free).
  std::unique_ptr<std::atomic<uint8_t>[]> model_sid(
      new std::atomic<uint8_t>[spectrum_size]());
  std::vector<int64_t> keep_off(n_haps + 1, 0);
  {
    auto count_hap = [&](int64_t hp) {
      int64_t keep = 0, anch = 0;
      for (int64_t i = hit_off[hp]; i < hit_off[hp + 1]; i++) {
        if (bad_sid[g_sid[i]].load(std::memory_order_relaxed)) continue;
        anch++;
        if (o_end[i] > o_start[i]) keep++;
      }
      keep_off[hp + 1] = keep;
      h->per_hap_anchors[hp] = anch;
    };
    unsigned nt = pool_size();
    if (n_haps <= 1 || nt <= 1) {
      for (int64_t hp = 0; hp < n_haps; hp++) count_hap(hp);
    } else {
      std::vector<std::thread> pool;
      std::atomic<int64_t> next_hp{0};
      for (unsigned t = 0; t < nt; t++)
        pool.emplace_back([&] {
          for (int64_t hp; (hp = next_hp.fetch_add(1)) < n_haps;)
            count_hap(hp);
        });
      for (auto& th : pool) th.join();
    }
  }
  for (int64_t hp = 0; hp < n_haps; hp++) keep_off[hp + 1] += keep_off[hp];
  int64_t n_keep = keep_off[n_haps];
  h->occ_hap.resize(n_keep);
  h->occ_start.resize(n_keep);
  h->occ_end.resize(n_keep);
  h->occ_kmer.resize(n_keep);
  {
    auto fill_hap = [&](int64_t hp) {
      int64_t at = keep_off[hp];
      for (int64_t i = hit_off[hp]; i < hit_off[hp + 1]; i++) {
        int32_t sid = g_sid[i];
        if (bad_sid[sid].load(std::memory_order_relaxed)) continue;
        if (o_end[i] <= o_start[i]) continue;
        h->occ_hap[at] = o_hap[i];
        h->occ_start[at] = o_start[i];
        h->occ_end[at] = o_end[i];
        h->occ_kmer[at] = sid;
        at++;
        model_sid[sid].store(1, std::memory_order_relaxed);
      }
    };
    unsigned nt = pool_size();
    if (n_haps <= 1 || nt <= 1) {
      for (int64_t hp = 0; hp < n_haps; hp++) fill_hap(hp);
    } else {
      std::vector<std::thread> pool;
      std::atomic<int64_t> next_hp{0};
      for (unsigned t = 0; t < nt; t++)
        pool.emplace_back([&] {
          for (int64_t hp; (hp = next_hp.fetch_add(1)) < n_haps;)
            fill_hap(hp);
        });
      for (auto& th : pool) th.join();
    }
  }
  for (int64_t s = 0; s < spectrum_size; s++)
    h->n_model_kmers += model_sid[s].load(std::memory_order_relaxed);
  if (anchors::timing_enabled())
    fprintf(stderr, "[phi_anchors] pass3 %.2f s (%lld kept)\n",
            anchors::now_s() - t0, (long long)n_keep);
  return h;
} catch (...) {
  return nullptr;
}

// ------------------------------------------------- solver table build (host)
// Dense S/B credit planes + W straddle stack from the occurrence columns —
// the host-side counterpart of solve.dp._build_sbw_jit for the CPU backend,
// where XLA's scatter is serial per update (337 s at 25M occ x [64, 3M];
// this build: seconds). Semantics are prep.straddle_layers_from_occ /
// anchors.credit_arrays: S[h,p] = sum w over {start < p}, B[h,p] = sum w
// over {end <= p}, W[j,h,p] = sum w over {start < p-j <= p < end}.
// Layers (and the S/B pair) are built by a thread pool, each scattering
// into its own output plane then prefix-summing rows in place.
// Output buffers MUST arrive zeroed (np.zeros = calloc zero pages): the
// builder never memsets — untouched pages stay virtual zeros, and each
// row's prefix sum runs only over the touched index range. W scatters come
// in canceling (+w at a, -w at b) pairs, so outside [min_touch, max_touch]
// the running sum is exactly zero and the page is never written; high W
// layers (long k-mer spans, rare) therefore cost almost nothing. S/B rows
// have no canceling pairs — their suffix from min_touch on is nonzero, so
// they cumsum through to P.
// w_lo/w_hi (nullable, [L*H] each): per (layer, lane) touched column range
// [lo, hi] outside of which W is exactly zero — the native solver skips
// those columns' W reads (phi_solve_exact).
int phi_build_sbw(const int32_t* oh, const int32_t* os, const int32_t* oe,
                  const float* ow, int64_t n, int64_t H, int64_t P,
                  int64_t L, int64_t H_real, float* S_out, float* B_out,
                  float* W_out, int64_t* w_lo, int64_t* w_hi) try {
  const int64_t plane = H * P;
  auto row_cumsum = [&](float* p, const int64_t* lo, const int64_t* hi) {
    for (int64_t h = 0; h < H_real; h++) {
      if (lo[h] > hi[h]) continue;
      double acc = 0.0;  // float64 accumulate, float32 store
      float* row = p + h * P;
      for (int64_t x = lo[h]; x <= hi[h]; x++) {
        acc += row[x];
        row[x] = static_cast<float>(acc);
      }
    }
  };
  // Span-descending occurrence index: W layer j needs only occurrences
  // with span oe-os >= j+2 (typically a small fraction past layer 0 — a
  // k-mer spans few chopped nodes), so each layer scans a prefix of this
  // index instead of all n occurrences (was L+1 full scans of the
  // occurrence arrays at chromosome scale). Counting sort, stable within
  // a span class, built once up front.
  std::vector<int64_t> sidx;
  std::vector<int64_t> until(L + 1, 0);  // until[j] = #occ with span >= j+2
  if (L > 0 && n > 0) {
    int64_t dmax = L + 1;
    std::vector<int64_t> dcnt(dmax + 2, 0);
    for (int64_t i = 0; i < n; i++) {
      int64_t d = static_cast<int64_t>(oe[i]) - os[i];
      if (d > dmax) d = dmax;
      if (d >= 2) dcnt[d]++;
    }
    // dstart[d] = #occ with span > d = write offset of span class d
    std::vector<int64_t> dstart(dmax + 2, 0);
    for (int64_t d = dmax; d >= 2; d--)
      dstart[d] = dstart[d + 1] + dcnt[d + 1];
    int64_t n_rel = dstart[2] + dcnt[2];
    sidx.resize(n_rel);
    std::vector<int64_t> fill(dstart.begin(), dstart.end());
    for (int64_t i = 0; i < n; i++) {
      int64_t d = static_cast<int64_t>(oe[i]) - os[i];
      if (d > dmax) d = dmax;
      if (d >= 2) sidx[fill[d]++] = i;
    }
    for (int64_t j = 0; j < L; j++) {
      int64_t need = j + 2;
      until[j] = need <= dmax ? dstart[need] + dcnt[need] : 0;
    }
  }

  // The S/B task (full scatter + two full-row cumsums) is the straggler
  // once W layers scan only their span prefix; occurrences arrive sorted
  // by lane (phi_anchors emits them per-hap), so it splits into per-lane-
  // range subtasks: each scatters its own occurrence slice and cumsums its
  // own rows. Verify the ordering once; fall back to one serial S/B task
  // if an exotic caller hands unsorted occurrences.
  bool oh_sorted = true;
  for (int64_t i = 1; i < n; i++)
    if (oh[i] < oh[i - 1]) { oh_sorted = false; break; }
  int64_t n_sb = (oh_sorted && H_real > 1)
      ? std::min<int64_t>(pool_size(), H_real) : 1;
  // lane chunk c covers haps [hsplit[c], hsplit[c+1]); occ slice found by
  // binary search over the sorted oh
  std::vector<int64_t> hsplit(n_sb + 1, H_real);
  hsplit[0] = 0;
  for (int64_t c = 1; c < n_sb; c++)
    hsplit[c] = H_real * c / n_sb;
  auto sb_task = [&](int64_t c) {
    int64_t hlo = hsplit[c], hhi = hsplit[c + 1];
    if (hlo >= hhi) return;
    int64_t ilo = 0, ihi = n;
    if (n_sb > 1) {
      ilo = std::lower_bound(oh, oh + n, static_cast<int32_t>(hlo)) - oh;
      ihi = std::lower_bound(oh, oh + n, static_cast<int32_t>(hhi)) - oh;
    }
    std::vector<int64_t> lo(H_real, P), hi(H_real, -1);
    for (int64_t i = ilo; i < ihi; i++) {
      int64_t h = oh[i], base = h * P;
      B_out[base + oe[i]] += ow[i];
      int64_t sn = static_cast<int64_t>(os[i]) + 1;
      if (sn < P) S_out[base + sn] += ow[i];
      int64_t first = sn < oe[i] ? sn : oe[i];
      if (first < lo[h]) lo[h] = first;
    }
    for (int64_t h = hlo; h < hhi; h++) hi[h] = P - 1;  // no canceling pairs
    row_cumsum(S_out, lo.data(), hi.data());
    row_cumsum(B_out, lo.data(), hi.data());
  };

  // task ids: 0..n_sb-1 -> S+B lane chunks, n_sb..n_sb+L-1 -> W layer id-n_sb
  std::atomic<int64_t> next{0};
  auto work = [&] {
    std::vector<int64_t> lo(H_real), hi(H_real);
    for (int64_t id; (id = next.fetch_add(1)) < n_sb + L;) {
      if (id < n_sb) {
        sb_task(id);
      } else {
        int64_t j = id - n_sb;
        float* Wj = W_out + j * plane;
        std::fill(lo.begin(), lo.end(), P);
        std::fill(hi.begin(), hi.end(), -1);
        for (int64_t s = 0; s < until[j]; s++) {
          int64_t i = sidx[s];
          int64_t h = oh[i], base = h * P;
          int64_t a = static_cast<int64_t>(os[i]) + 1 + j, b = oe[i];
          Wj[base + a] += ow[i];
          Wj[base + b] -= ow[i];
          if (a < lo[h]) lo[h] = a;
          if (b > hi[h]) hi[h] = b;
        }
        row_cumsum(Wj, lo.data(), hi.data());
        if (w_lo && w_hi) {
          for (int64_t h = 0; h < H_real; h++) {
            w_lo[j * H + h] = lo[h];
            w_hi[j * H + h] = hi[h];
          }
          for (int64_t h = H_real; h < H; h++) {
            w_lo[j * H + h] = P;  // empty range
            w_hi[j * H + h] = -1;
          }
        }
      }
    }
  };
  unsigned n_thr = std::min<unsigned>(pool_size(),
                                      static_cast<unsigned>(n_sb + L));
  if (n_thr <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < n_thr; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return 0;
} catch (...) {
  return -1;
}

// ----------------------------------------------------- exact solver (host)
// CPU-backend counterpart of solve.dp._solve_exact_jit: prefix-min
// relaxation sweeps to fixpoint with exact straddle-corrected credit. The
// arithmetic replicates the XLA program operation for operation in float32
// (mins are exact; the add/sub chains are identical), so M, ends, and the
// sweep count match the device solver bit for bit. Two exactness-preserving
// shortcuts: a monotonic-deque windowed min covers every layer whose W is
// zero at a column (W >= 0, so an uncorrected A can only overestimate a
// corrected term that is itself included), and per-(layer,lane) touched
// ranges from phi_build_sbw skip W reads where the plane is identically
// zero. Returns the sweep count.
int64_t phi_solve_exact(const float* S, const float* B, const float* W,
                        const int64_t* w_lo, const int64_t* w_hi,
                        const int32_t* eh, const int32_t* ep,
                        const int32_t* et, int64_t n_esrc,
                        const int32_t* sv, const int32_t* walk_len, float R,
                        int64_t n_vtx, int64_t H, int64_t P, int64_t L,
                        int64_t max_sweeps, float* M_out, float* ends_out) try {
  const float INF = std::numeric_limits<float>::infinity();
  std::vector<float> M(static_cast<size_t>(H) * P, INF);
  std::vector<float> Mn(static_cast<size_t>(H) * P);
  std::vector<float> ent(static_cast<size_t>(n_vtx));
  unsigned n_thr = pool_size();

  // per-thread entry buffers (scatter-min over esrc rows), merged serially
  std::vector<std::vector<float>> ent_t(n_thr);
  for (auto& e : ent_t) e.assign(n_vtx, INF);

  auto run_pool = [&](auto fn) {
    if (n_thr <= 1) {
      fn(0);
      return;
    }
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < n_thr; t++) pool.emplace_back(fn, t);
    for (auto& th : pool) th.join();
  };

  std::atomic<int64_t> next{0};
  std::atomic<bool> changed{false};
  int64_t it = 0;
  while (it < std::max<int64_t>(max_sweeps, 2)) {
    if (it >= 2 && !changed.load()) break;
    // 1. entry values per vertex
    next.store(0);
    run_pool([&](unsigned t) {
      auto& e = ent_t[t];
      if (it > 0) std::fill(e.begin(), e.end(), INF);
      const int64_t grain = 1 << 16;
      for (int64_t g; (g = next.fetch_add(grain)) < n_esrc;) {
        int64_t end = std::min(g + grain, n_esrc);
        for (int64_t i = g; i < end; i++) {
          int64_t h = eh[i], p = ep[i];
          if (p >= walk_len[h]) continue;
          float d = M[h * P + p] - B[h * P + p];
          float& slot = e[et[i]];
          if (d < slot) slot = d;
        }
      }
    });
    for (int64_t v = 0; v < n_vtx; v++) {
      float m = ent_t[0][v];
      for (unsigned t = 1; t < n_thr; t++) m = std::min(m, ent_t[t][v]);
      ent[v] = m;
    }
    // 2. per-lane relaxation
    changed.store(false);
    next.store(0);
    run_pool([&](unsigned t) {
      (void)t;
      std::vector<float> A(P);
      // monotonic deque over the last L values of A (windowed min)
      std::vector<float> dqv(std::max<int64_t>(L, 1) + 1);
      std::vector<int64_t> dqp(std::max<int64_t>(L, 1) + 1);
      bool any_change = false;
      for (int64_t h; (h = next.fetch_add(1)) < H;) {
        const int32_t* svr = sv + h * P;
        const float* Sr = S + h * P;
        const float* Mr = M.data() + h * P;
        float* Mo = Mn.data() + h * P;
        int64_t len = walk_len[h];
        float scan = INF;  // cummin of A[0 .. p-L], maintained below
        size_t head = 0, tail = 0;
        const size_t dqn = dqv.size();
        for (int64_t p = 0; p < P; p++) {
          float e_state = INF;
          if (svr[p] >= 0) e_state = ent[svr[p]] + R;
          if (p == 0) e_state = std::min(e_state, 0.0f);
          float a = (p < len) ? e_state + Sr[p] : INF;
          A[p] = a;
          // windowed min of A over [p-L+1, p] via monotonic deque
          // (the L recent-entry layers with zero straddle weight)
          while (tail > head && dqv[(tail - 1) % dqn] >= a) tail--;
          dqv[tail % dqn] = a;
          dqp[tail % dqn] = p;
          tail++;
          if (tail > head && dqp[head % dqn] <= p - L) head++;
          float mn;
          if (p >= L) {
            scan = std::min(scan, A[p - L]);
            mn = scan;
          } else {
            mn = INF;
          }
          if (L > 0) {
            mn = std::min(mn, dqv[head % dqn]);
            for (int64_t j = 0; j < L; j++) {
              int64_t lo_j = w_lo[j * H + h];
              if (p < lo_j || p > w_hi[j * H + h] || p < j) continue;
              float wv = W[(j * H + h) * P + p];
              if (wv != 0.0f) mn = std::min(mn, A[p - j] - wv);
            }
          }
          Mo[p] = mn;
          if (!any_change && mn < Mr[p] - 1e-4f) any_change = true;
        }
      }
      if (any_change) changed.store(true);
    });
    M.swap(Mn);
    it++;
  }
  std::memcpy(M_out, M.data(), sizeof(float) * H * P);
  for (int64_t h = 0; h < H; h++) {
    int64_t len = walk_len[h];
    if (len > 0) {
      int64_t p = len - 1;
      ends_out[h] = M[h * P + p] - B[h * P + p];
    } else {
      ends_out[h] = INF;
    }
  }
  return it;
} catch (...) {
  return -1;
}

// ------------------------------------------------------- graph tensor utils

// lanes_of_vertex CSR by counting sort: for each vertex, the flat lane
// states h*P+p in row-major order (same order as the numpy stable-argsort
// path in pangenome.build_csr). Caller allocates off[n_vtx+1], values[total].
// vertex -> flat lane states CSR (counting sort). Parallel and
// DETERMINISTIC: the count pass uses per-thread count arrays over
// contiguous walk chunks; the scatter pass partitions by VERTEX RANGE —
// every thread rescans all walks but writes only vertices in its range, so
// each vertex's list keeps the exact serial (h, p) order (downstream
// tie-breaking, and therefore emitted paths, stay byte-identical).
// Rescans are cheap sequential reads; the wins are parallel first-touch of
// the ~GB `values` buffer (the old serial scatter was fault-storm-bound at
// chromosome scale: 98 s for 160M entries) and parallel counting.
void phi_lane_csr(int64_t H, int64_t P, const int32_t* walk_mat,
                  const int32_t* walk_len, int64_t n_vtx, int64_t* off,
                  int64_t* values) {
  unsigned nt = pool_size();
  int64_t total_rows = H;
  if (nt <= 1 || total_rows == 0 || n_vtx == 0) {
    std::vector<int64_t> cnt(static_cast<size_t>(n_vtx) + 1, 0);
    for (int64_t h = 0; h < H; h++) {
      const int32_t* row = walk_mat + h * P;
      int64_t L = walk_len[h];
      for (int64_t p = 0; p < L; p++)
        if (row[p] >= 0) cnt[row[p]]++;
    }
    off[0] = 0;
    for (int64_t v = 0; v < n_vtx; v++) off[v + 1] = off[v] + cnt[v];
    std::vector<int64_t> cur(off, off + n_vtx);
    for (int64_t h = 0; h < H; h++) {
      const int32_t* row = walk_mat + h * P;
      int64_t L = walk_len[h];
      for (int64_t p = 0; p < L; p++)
        if (row[p] >= 0) values[cur[row[p]]++] = h * P + p;
    }
    return;
  }
  // count: per-thread count arrays over hap chunks, then reduce
  std::vector<std::vector<int64_t>> tcnt(nt);
  {
    std::vector<std::thread> pool;
    std::atomic<int64_t> next_h{0};
    for (unsigned t = 0; t < nt; t++)
      pool.emplace_back([&, t] {
        auto& c = tcnt[t];
        c.assign(static_cast<size_t>(n_vtx), 0);
        for (int64_t h; (h = next_h.fetch_add(1)) < H;) {
          const int32_t* row = walk_mat + h * P;
          int64_t L = walk_len[h];
          for (int64_t p = 0; p < L; p++)
            if (row[p] >= 0) c[row[p]]++;
        }
      });
    for (auto& th : pool) th.join();
  }
  off[0] = 0;
  for (int64_t v = 0; v < n_vtx; v++) {
    int64_t c = 0;
    for (unsigned t = 0; t < nt; t++) c += tcnt[t][v];
    off[v + 1] = off[v] + c;
  }
  int64_t total = off[n_vtx];
  // vertex-range split balanced by entry count
  std::vector<int64_t> vsplit(nt + 1, n_vtx);
  vsplit[0] = 0;
  for (unsigned t = 1; t < nt; t++) {
    int64_t want = total * t / nt;
    vsplit[t] = std::lower_bound(off, off + n_vtx + 1, want) - off;
    if (vsplit[t] > n_vtx) vsplit[t] = n_vtx;
  }
  {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < nt; t++)
      pool.emplace_back([&, t] {
        int64_t vlo = vsplit[t], vhi = vsplit[t + 1];
        if (vlo >= vhi) return;
        std::vector<int64_t> cur(off + vlo, off + vhi);
        for (int64_t h = 0; h < H; h++) {
          const int32_t* row = walk_mat + h * P;
          int64_t L = walk_len[h];
          for (int64_t p = 0; p < L; p++) {
            int32_t v = row[p];
            if (v >= vlo && v < vhi) values[cur[v - vlo]++] = h * P + p;
          }
        }
      });
    for (auto& th : pool) th.join();
  }
}

// concatenated base codes of one walk (ILP_index.cpp:363-366 analog);
// returns the total length written (caller allocates sum(node_len[walk])).
int64_t phi_walk_codes(const uint8_t* seq_code, const int64_t* node_off,
                       const int32_t* walk, int64_t walk_len, uint8_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < walk_len; i++) {
    int32_t v = walk[i];
    int64_t n = node_off[v + 1] - node_off[v];
    memcpy(out + pos, seq_code + node_off[v], static_cast<size_t>(n));
    pos += n;
  }
  return pos;
}

int64_t phi_anchors_n_occ(void* hp) {
  return static_cast<int64_t>(static_cast<anchors::Handle*>(hp)->occ_hap.size());
}
int64_t phi_anchors_n_model_kmers(void* hp) {
  return static_cast<anchors::Handle*>(hp)->n_model_kmers;
}
int64_t phi_anchors_filtered_kmers(void* hp) {
  return static_cast<anchors::Handle*>(hp)->filtered_kmers;
}
const int32_t* phi_anchors_occ_hap(void* hp) {
  return static_cast<anchors::Handle*>(hp)->occ_hap.data();
}
const int32_t* phi_anchors_occ_start(void* hp) {
  return static_cast<anchors::Handle*>(hp)->occ_start.data();
}
const int32_t* phi_anchors_occ_end(void* hp) {
  return static_cast<anchors::Handle*>(hp)->occ_end.data();
}
const int32_t* phi_anchors_occ_kmer(void* hp) {
  return static_cast<anchors::Handle*>(hp)->occ_kmer.data();
}
const int64_t* phi_anchors_per_hap(void* hp) {
  return static_cast<anchors::Handle*>(hp)->per_hap_anchors.data();
}
void phi_anchors_free(void* hp) { delete static_cast<anchors::Handle*>(hp); }

}  // extern "C"
