// Copy of the JAX package's native/elmio.cc, kept by elmkernels_torch
// (the port loads no binary of the JAX tree).  Changed here, and nowhere
// else: this header; the build line below; and a guard at the end that
// joins unfinished prefetch threads when the library is unloaded (a
// prefetched file never taken left a joinable std::thread in
// g_prefetch, whose destructor calls std::terminate at process exit).
//
// elmio: native NetCDF-3 (classic + 64-bit offset) reader with async
// prefetch, exposed as a C ABI for ctypes.
//
// Replacement for the reference's (P)NetCDF ingestion layer
// (read_netcdf.hh, read_pnetcdf.hh): each host reads its
// domain-decomposed forcing hyperslabs from the classic-format files; a
// background prefetch warms the next month while the device computes (the
// reference reads synchronously per window, atm_data_impl.hh:248-319).
//
// Scope: read-only, classic (CDF-1) and 64-bit-offset (CDF-2) formats,
// all numeric types, record and fixed variables, double/attribute access.
//
// Build: elmkernels_torch/io/native.py builds it with g++ at first use
// (-std=c++17 -O2 -fPIC -Wall -pthread -shared) into build/native/.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Dim {
  std::string name;
  int64_t len;  // 0 => record dimension
};

struct Var {
  std::string name;
  std::vector<int> dimids;
  int nc_type = 0;
  int64_t vsize = 0;
  int64_t begin = 0;
  bool is_record = false;
  std::map<std::string, double> num_attrs;
};

struct File {
  std::string path;
  std::vector<char> data;  // whole file resident (forcing files are
                           // month-sized; simplicity + page-cache reuse)
  int version = 0;         // 1 = classic, 2 = 64-bit offset
  int64_t numrecs = 0;
  std::vector<Dim> dims;
  std::vector<Var> vars;
  int64_t recsize = 0;
  std::string error;
};

int type_size(int t) {
  switch (t) {
    case 1: return 1;  // byte
    case 2: return 1;  // char
    case 3: return 2;  // short
    case 4: return 4;  // int
    case 5: return 4;  // float
    case 6: return 8;  // double
    default: return 0;
  }
}

class Reader {
 public:
  explicit Reader(File* f) : f_(f), p_(0) {}
  bool ok() const { return p_ <= f_->data.size(); }
  uint32_t u32() {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v = (v << 8) | byte();
    return v;
  }
  int64_t i64() {
    int64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | byte();
    return v;
  }
  uint8_t byte() {
    if (p_ >= f_->data.size()) { p_ = f_->data.size() + 1; return 0; }
    return static_cast<uint8_t>(f_->data[p_++]);
  }
  std::string name() {
    uint32_t n = u32();
    std::string s(f_->data.data() + p_, n);
    p_ += n;
    pad();
    return s;
  }
  void skip(size_t n) { p_ += n; }
  void pad() { p_ = (p_ + 3) & ~size_t(3); }
  size_t pos() const { return p_; }

 private:
  File* f_;
  size_t p_;
};

bool parse_header(File* f) {
  Reader r(f);
  if (f->data.size() < 8 || f->data[0] != 'C' || f->data[1] != 'D' ||
      f->data[2] != 'F') {
    f->error = "not a NetCDF classic file";
    return false;
  }
  f->version = f->data[3];
  if (f->version != 1 && f->version != 2) {
    f->error = "unsupported NetCDF version (classic/64-bit offset only)";
    return false;
  }
  r.skip(4);
  f->numrecs = static_cast<int64_t>(r.u32());  // STREAMING(0xFFFFFFFF) unsupported

  // dim_list
  uint32_t tag = r.u32();
  uint32_t n = r.u32();
  if (tag == 0x0A) {  // NC_DIMENSION
    for (uint32_t i = 0; i < n; ++i) {
      Dim d;
      d.name = r.name();
      d.len = static_cast<int64_t>(r.u32());
      f->dims.push_back(d);
    }
  }

  // skip global attributes
  auto skip_atts = [&]() {
    uint32_t t = r.u32();
    uint32_t cnt = r.u32();
    if (t != 0x0C) return std::map<std::string, double>{};
    std::map<std::string, double> out;
    for (uint32_t i = 0; i < cnt; ++i) {
      std::string aname = r.name();
      uint32_t at = r.u32();
      uint32_t an = r.u32();
      int sz = type_size(static_cast<int>(at));
      // record first numeric value for scale_factor/add_offset support
      if ((at >= 3 && at <= 6) && an >= 1) {
        size_t save = r.pos();
        double val = 0;
        if (at == 3) {
          int16_t v = static_cast<int16_t>((r.byte() << 8) | r.byte());
          val = v;
        } else if (at == 4) {
          val = static_cast<int32_t>(r.u32());
        } else if (at == 5) {
          uint32_t bits = r.u32();
          float fv;
          std::memcpy(&fv, &bits, 4);
          val = fv;
        } else {
          uint64_t bits = (static_cast<uint64_t>(r.u32()) << 32) | r.u32();
          double dv;
          std::memcpy(&dv, &bits, 8);
          val = dv;
        }
        out[aname] = val;
        // skip remaining values
        size_t consumed = r.pos() - save;
        r.skip(static_cast<size_t>(an) * sz - consumed);
      } else {
        r.skip(static_cast<size_t>(an) * sz);
      }
      r.pad();
    }
    return out;
  };
  skip_atts();

  // var_list
  tag = r.u32();
  n = r.u32();
  if (tag == 0x0B) {  // NC_VARIABLE
    for (uint32_t i = 0; i < n; ++i) {
      Var v;
      v.name = r.name();
      uint32_t nd = r.u32();
      for (uint32_t k = 0; k < nd; ++k)
        v.dimids.push_back(static_cast<int>(r.u32()));
      v.num_attrs = skip_atts();
      v.nc_type = static_cast<int>(r.u32());
      v.vsize = static_cast<int64_t>(r.u32());
      v.begin = (f->version == 2) ? r.i64()
                                  : static_cast<int64_t>(r.u32());
      v.is_record = !v.dimids.empty() && f->dims[v.dimids[0]].len == 0;
      f->vars.push_back(v);
    }
  }
  for (const auto& v : f->vars)
    if (v.is_record) f->recsize += v.vsize;
  return r.ok();
}

// convert big-endian typed data at src to double
inline double be_to_double(const char* src, int t) {
  switch (t) {
    case 1: return static_cast<double>(static_cast<int8_t>(src[0]));
    case 2: return static_cast<double>(static_cast<uint8_t>(src[0]));
    case 3: {
      int16_t v = static_cast<int16_t>(
          (static_cast<uint8_t>(src[0]) << 8) |
          static_cast<uint8_t>(src[1]));
      return v;
    }
    case 4: {
      int32_t v = (static_cast<uint8_t>(src[0]) << 24) |
                  (static_cast<uint8_t>(src[1]) << 16) |
                  (static_cast<uint8_t>(src[2]) << 8) |
                  static_cast<uint8_t>(src[3]);
      return v;
    }
    case 5: {
      uint32_t bits = (static_cast<uint8_t>(src[0]) << 24) |
                      (static_cast<uint8_t>(src[1]) << 16) |
                      (static_cast<uint8_t>(src[2]) << 8) |
                      static_cast<uint8_t>(src[3]);
      float f;
      std::memcpy(&f, &bits, 4);
      return f;
    }
    case 6: {
      uint64_t bits = 0;
      for (int i = 0; i < 8; ++i)
        bits = (bits << 8) | static_cast<uint8_t>(src[i]);
      double d;
      std::memcpy(&d, &bits, 8);
      return d;
    }
  }
  return 0.0;
}

std::mutex g_mu;
std::map<int, std::unique_ptr<File>> g_files;
int g_next = 1;
std::string g_error;

File* get(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_files.find(h);
  return it == g_files.end() ? nullptr : it->second.get();
}

}  // namespace

extern "C" {

int elmio_open(const char* path) {
  auto f = std::make_unique<File>();
  f->path = path;
  std::ifstream in(path, std::ios::binary | std::ios::ate);
  if (!in) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_error = std::string("cannot open ") + path;
    return -1;
  }
  auto sz = in.tellg();
  f->data.resize(static_cast<size_t>(sz));
  in.seekg(0);
  in.read(f->data.data(), sz);
  if (!parse_header(f.get())) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_error = f->error.empty() ? "header parse failed" : f->error;
    return -1;
  }
  std::lock_guard<std::mutex> lk(g_mu);
  int h = g_next++;
  g_files[h] = std::move(f);
  return h;
}

void elmio_close(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_files.erase(h);
}

const char* elmio_last_error() {
  return g_error.c_str();
}

// number of dims of a variable; fills dims[] with lengths (record dim
// reports numrecs). Returns -1 if var not found.
int elmio_var_ndims(int h, const char* name, int64_t* dims) {
  File* f = get(h);
  if (!f) return -1;
  for (const auto& v : f->vars) {
    if (v.name == name) {
      for (size_t i = 0; i < v.dimids.size(); ++i) {
        int64_t len = f->dims[v.dimids[i]].len;
        dims[i] = (len == 0) ? f->numrecs : len;
      }
      return static_cast<int>(v.dimids.size());
    }
  }
  return -1;
}

// on-disk NetCDF type of a variable (NC_BYTE=1 .. NC_DOUBLE=6);
// negative on error.  Lets callers ship data at source precision
// (an f32 variable read as f64 carries no extra information).
int elmio_var_type(int h, const char* name) {
  File* f = get(h);
  if (!f) return -1;
  for (const auto& v : f->vars)
    if (v.name == name) return v.nc_type;
  return -2;
}

// read attribute (scale_factor/add_offset etc.); returns 0 on success
int elmio_get_att(int h, const char* var, const char* att, double* out) {
  File* f = get(h);
  if (!f) return -1;
  for (const auto& v : f->vars) {
    if (v.name == var) {
      auto it = v.num_attrs.find(att);
      if (it == v.num_attrs.end()) return -1;
      *out = it->second;
      return 0;
    }
  }
  return -1;
}

// read a hyperslab [start, start+count) per dim into out (as double,
// row-major). Returns 0 on success.
int elmio_read_f64(int h, const char* name, const int64_t* start,
                   const int64_t* count, double* out) {
  File* f = get(h);
  if (!f) return -1;
  const Var* var = nullptr;
  for (const auto& v : f->vars)
    if (v.name == name) { var = &v; break; }
  if (!var) return -2;

  const int nd = static_cast<int>(var->dimids.size());
  const int ts = type_size(var->nc_type);
  // shape with record dim resolved
  std::vector<int64_t> shape(nd);
  for (int i = 0; i < nd; ++i) {
    int64_t len = f->dims[var->dimids[i]].len;
    shape[i] = (len == 0) ? f->numrecs : len;
  }
  // strides in elements within one record (or the whole var if fixed)
  std::vector<int64_t> stride(nd, 1);
  for (int i = nd - 2; i >= 0; --i) {
    if (var->is_record && i == 0) continue;
    stride[i] = stride[i + 1] * shape[i + 1];
  }

  // iterate output elements
  std::vector<int64_t> idx(nd, 0);
  int64_t total = 1;
  for (int i = 0; i < nd; ++i) total *= count[i];

  for (int64_t n = 0; n < total; ++n) {
    // compute source offset
    int64_t off;
    if (var->is_record && nd > 0) {
      int64_t rec = start[0] + idx[0];
      int64_t inner = 0;
      for (int i = 1; i < nd; ++i) inner += (start[i] + idx[i]) * stride[i];
      off = var->begin + rec * f->recsize + inner * ts;
    } else {
      int64_t inner = 0;
      for (int i = 0; i < nd; ++i) inner += (start[i] + idx[i]) * stride[i];
      off = var->begin + inner * ts;
    }
    if (off + ts > static_cast<int64_t>(f->data.size())) return -3;
    out[n] = be_to_double(f->data.data() + off, var->nc_type);
    // increment index
    for (int i = nd - 1; i >= 0; --i) {
      if (++idx[i] < count[i]) break;
      idx[i] = 0;
    }
  }
  return 0;
}

// ---------------- async prefetch ------------------------------------------
namespace {
std::mutex g_pf_mu;
std::map<std::string, std::thread> g_prefetch;
std::map<std::string, int> g_prefetched;  // path -> handle
}  // namespace

// start loading a file in the background; a later elmio_open of the same
// path returns instantly from the warmed entry
void elmio_prefetch(const char* path) {
  std::string p(path);
  std::lock_guard<std::mutex> lk(g_pf_mu);
  if (g_prefetch.count(p) || g_prefetched.count(p)) return;
  g_prefetch[p] = std::thread([p]() {
    int h = elmio_open(p.c_str());
    std::lock_guard<std::mutex> lk2(g_pf_mu);
    g_prefetched[p] = h;
  });
}

// retrieve a prefetched handle (joins the loader thread); -1 if not
// prefetched — caller falls back to elmio_open
int elmio_take_prefetched(const char* path) {
  std::string p(path);
  std::thread t;
  {
    std::lock_guard<std::mutex> lk(g_pf_mu);
    auto it = g_prefetch.find(p);
    if (it == g_prefetch.end()) {
      auto done = g_prefetched.find(p);
      if (done != g_prefetched.end()) {
        int h = done->second;
        g_prefetched.erase(done);
        return h;
      }
      return -1;
    }
    t = std::move(it->second);
    g_prefetch.erase(it);
  }
  if (t.joinable()) t.join();
  std::lock_guard<std::mutex> lk(g_pf_mu);
  auto done = g_prefetched.find(p);
  if (done == g_prefetched.end()) return -1;
  int h = done->second;
  g_prefetched.erase(done);
  return h;
}

}  // extern "C"

namespace {
// Defined after the prefetch maps, so destroyed before them: joins every
// loader thread still in g_prefetch (each records its handle in
// g_prefetched, which must outlive it) when the library is unloaded.
struct JoinPrefetchesAtExit {
  ~JoinPrefetchesAtExit() {
    std::map<std::string, std::thread> pending;
    {
      std::lock_guard<std::mutex> lk(g_pf_mu);
      pending.swap(g_prefetch);
    }
    for (auto& kv : pending)
      if (kv.second.joinable()) kv.second.join();
  }
} g_join_prefetches_at_exit;
}  // namespace
