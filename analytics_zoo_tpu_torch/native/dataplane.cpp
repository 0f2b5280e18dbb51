// zoo_dataplane: host-side native data plane for the TPU rebuild.
//
// Reference obligation (SURVEY.md §2.3 "Native (C++/JNI) component list"):
// analytics-zoo's native layer is MKL-DNN/TF-JNI/libtorch-JNI/OpenVINO/
// memkind-PMEM (ref: zoo/pipeline/inference/, zoo feature/pmem/).  The TPU
// rebuild keeps compute native via XLA; *this* module is the host data plane
// that replaces Spark's parallel ingest + the FeatureSet DRAM/PMEM tiers
// (ref: zoo feature/dataset/, feature/pmem/ArrayLike over memkind):
//
//   1. zrb_*  — bounded byte ring buffer (condvar-blocking MPSC) used to
//               hand off batches from a native reader thread to the Python
//               consumer; calls block with the GIL released (ctypes).
//   2. zcsv_* — multithreaded numeric CSV parser (chunk at newline
//               boundaries, strtod per field) -> column-major double arrays.
//               Replaces Spark's parallel csv ingest for the numeric tables
//               the reference's recommendation/timeseries pipelines use.
//   3. zrec_* — length-prefixed record file with u64 index footer, mmap'd
//               zero-copy reads.  The DiskFeatureSet / ArrayRecord analog.
//   4. zpf_*  — background std::thread streaming records (in caller-given
//               order, optionally looping) from a zrec file into a zrb ring:
//               file IO + memcpy overlap JAX device compute.
//
// C ABI only — consumed from Python via ctypes (no pybind11 in this image).

#include <atomic>
#include <cerrno>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <functional>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

// ---------------------------------------------------------------------------
// 1. Ring buffer
// ---------------------------------------------------------------------------

struct RingBuffer {
  size_t capacity_bytes;
  size_t max_items;
  std::deque<std::vector<uint8_t>> items;
  size_t bytes = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
};

bool wait_pred(std::unique_lock<std::mutex> &lk, std::condition_variable &cv,
               int timeout_ms, const std::function<bool()> &pred) {
  if (timeout_ms < 0) {
    cv.wait(lk, pred);
    return true;
  }
  return cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
}

}  // namespace

extern "C" {

void *zrb_create(size_t capacity_bytes, long max_items) {
  auto *rb = new RingBuffer();
  rb->capacity_bytes = capacity_bytes ? capacity_bytes : SIZE_MAX;
  rb->max_items = max_items > 0 ? (size_t)max_items : SIZE_MAX;
  return rb;
}

void zrb_destroy(void *h) { delete static_cast<RingBuffer *>(h); }

void zrb_close(void *h) {
  auto *rb = static_cast<RingBuffer *>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  rb->closed = true;
  rb->not_empty.notify_all();
  rb->not_full.notify_all();
}

// 0 ok; -1 timeout; -2 closed; -3 item larger than capacity.
int zrb_push(void *h, const void *data, size_t len, int timeout_ms) {
  auto *rb = static_cast<RingBuffer *>(h);
  if (len > rb->capacity_bytes) return -3;
  std::unique_lock<std::mutex> lk(rb->mu);
  bool ok = wait_pred(lk, rb->not_full, timeout_ms, [&] {
    return rb->closed || (rb->bytes + len <= rb->capacity_bytes &&
                          rb->items.size() < rb->max_items);
  });
  if (rb->closed) return -2;
  if (!ok) return -1;
  rb->items.emplace_back((const uint8_t *)data, (const uint8_t *)data + len);
  rb->bytes += len;
  rb->not_empty.notify_one();
  return 0;
}

// Length of the next item (>=0); -1 timeout; -2 closed and drained.
long zrb_peek_len(void *h, int timeout_ms) {
  auto *rb = static_cast<RingBuffer *>(h);
  std::unique_lock<std::mutex> lk(rb->mu);
  bool ok = wait_pred(lk, rb->not_empty, timeout_ms,
                      [&] { return rb->closed || !rb->items.empty(); });
  if (!rb->items.empty()) return (long)rb->items.front().size();
  if (rb->closed) return -2;
  (void)ok;
  return -1;
}

// Bytes written (>=0); -1 timeout; -2 closed+drained; -3 out too small.
long zrb_pop(void *h, void *out, size_t out_cap, int timeout_ms) {
  auto *rb = static_cast<RingBuffer *>(h);
  std::unique_lock<std::mutex> lk(rb->mu);
  wait_pred(lk, rb->not_empty, timeout_ms,
            [&] { return rb->closed || !rb->items.empty(); });
  if (rb->items.empty()) return rb->closed ? -2 : -1;
  auto &front = rb->items.front();
  if (front.size() > out_cap) return -3;
  size_t n = front.size();
  std::memcpy(out, front.data(), n);
  rb->bytes -= n;
  rb->items.pop_front();
  rb->not_full.notify_one();
  return (long)n;
}

long zrb_depth(void *h) {
  auto *rb = static_cast<RingBuffer *>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  return (long)rb->items.size();
}

long zrb_bytes(void *h) {
  auto *rb = static_cast<RingBuffer *>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  return (long)rb->bytes;
}

const char *zdp_last_error() { return g_last_error.c_str(); }

}  // extern "C"

// ---------------------------------------------------------------------------
// 2. CSV parser
// ---------------------------------------------------------------------------

namespace {

// A column being parsed: integer storage while every field looks like an
// int64 (pandas dtype parity — "1" is int64, "1.0"/""/NaN promote the whole
// column to float64), with lossless int64 precision via strtoll.
struct ColBuf {
  std::vector<int64_t> ivals;
  std::vector<double> dvals;
  bool is_int = true;

  void promote() {
    if (!is_int) return;
    dvals.reserve(ivals.size());
    for (int64_t v : ivals) dvals.push_back((double)v);
    ivals.clear();
    is_int = false;
  }
  void push_double(double v) {
    promote();
    dvals.push_back(v);
  }
  size_t size() const { return is_int ? ivals.size() : dvals.size(); }
};

struct CsvTable {
  std::vector<std::string> names;
  std::vector<ColBuf> cols;  // column-major
  long nrows = 0;
  std::string error;
};

bool looks_int(const char *buf, size_t n) {
  size_t i = (buf[0] == '+' || buf[0] == '-') ? 1 : 0;
  if (i == n) return false;
  for (; i < n; ++i)
    if (buf[i] < '0' || buf[i] > '9') return false;
  return true;
}

// Parse [begin, end) — full lines only — into ncols column buffers.
// Returns false on malformed / non-numeric input.
bool parse_chunk(const char *begin, const char *end, size_t ncols,
                 std::vector<ColBuf> &cols, std::string &err) {
  cols.assign(ncols, {});
  const char *p = begin;
  while (p < end) {
    const char *eol = (const char *)memchr(p, '\n', end - p);
    const char *line_end = eol ? eol : end;
    // tolerate CRLF and blank trailing lines
    const char *le = line_end;
    if (le > p && le[-1] == '\r') --le;
    if (le > p) {
      size_t c = 0;
      const char *f = p;
      while (true) {
        const char *comma = (const char *)memchr(f, ',', le - f);
        const char *fe = comma ? comma : le;
        if (c >= ncols) {
          err = "row has more fields than header";
          return false;
        }
        if (fe == f) {
          cols[c].push_double(NAN);  // empty field (pandas: NaN -> float64)
        } else {
          char *parse_end = nullptr;
          // strto* need NUL-terminated; fields are short — copy to buf.
          char buf[64];
          size_t n = (size_t)(fe - f);
          if (n >= sizeof(buf)) {
            err = "field too long for numeric parse";
            return false;
          }
          std::memcpy(buf, f, n);
          buf[n] = 0;
          if (looks_int(buf, n)) {
            errno = 0;
            int64_t iv = strtoll(buf, &parse_end, 10);
            if (errno == ERANGE) {
              // Out-of-int64-range literal: pandas keeps it exact
              // (uint64/object); a double would silently lose precision.
              // Fail the native parse so callers fall back to pandas.
              err = std::string("integer out of int64 range: '") + buf + "'";
              return false;
            }
            if (parse_end && *parse_end == 0) {
              if (cols[c].is_int)
                cols[c].ivals.push_back(iv);
              else
                cols[c].dvals.push_back((double)iv);
              goto next_field;
            }
          }
          {
            // strtod accepts C99 hex floats ("0x1A" -> 26.0) which pandas
            // treats as strings — reject them to keep auto-mode fallback
            // behaviour identical to pandas.
            if (memchr(buf, 'x', n) || memchr(buf, 'X', n)) {
              err = std::string("non-numeric field: '") + buf + "'";
              return false;
            }
            double v = strtod(buf, &parse_end);
            while (parse_end && *parse_end == ' ') ++parse_end;
            if (!parse_end || *parse_end != 0 || parse_end == buf) {
              err = std::string("non-numeric field: '") + buf + "'";
              return false;
            }
            cols[c].push_double(v);
          }
        }
      next_field:
        ++c;
        if (!comma) break;
        f = comma + 1;
        if (f == le) {  // trailing comma -> empty last field
          if (c >= ncols) {
            err = "row has more fields than header";
            return false;
          }
          cols[c++].push_double(NAN);
          break;
        }
      }
      if (c != ncols) {
        err = "row has fewer fields than header";
        return false;
      }
    }
    if (!eol) break;
    p = eol + 1;
  }
  return true;
}

}  // namespace

extern "C" {

void *zcsv_open(const char *path, int n_threads) {
  FILE *fp = fopen(path, "rb");
  if (!fp) {
    set_error(std::string("cannot open ") + path + ": " + strerror(errno));
    return nullptr;
  }
  fseek(fp, 0, SEEK_END);
  long sz = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  std::vector<char> data((size_t)sz);
  if (sz > 0 && fread(data.data(), 1, (size_t)sz, fp) != (size_t)sz) {
    fclose(fp);
    set_error("short read");
    return nullptr;
  }
  fclose(fp);

  auto *t = new CsvTable();
  // header line
  const char *begin = data.data();
  const char *end = begin + data.size();
  const char *eol = (const char *)memchr(begin, '\n', data.size());
  if (!eol) {
    set_error("no header line");
    delete t;
    return nullptr;
  }
  {
    const char *he = eol;
    if (he > begin && he[-1] == '\r') --he;
    const char *f = begin;
    while (f <= he) {
      const char *comma = (const char *)memchr(f, ',', he - f);
      const char *fe = comma ? comma : he;
      std::string name(f, fe);
      // strip quotes/space
      while (!name.empty() && (name.front() == ' ' || name.front() == '"'))
        name.erase(name.begin());
      while (!name.empty() && (name.back() == ' ' || name.back() == '"'))
        name.pop_back();
      t->names.push_back(name);
      if (!comma) break;
      f = comma + 1;
      if (f > he) break;
    }
  }
  size_t ncols = t->names.size();
  if (ncols == 0) {
    set_error("empty header");
    delete t;
    return nullptr;
  }

  // split body into chunks at newline boundaries
  const char *body = eol + 1;
  size_t body_len = (size_t)(end - body);
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  size_t min_chunk = 1 << 20;  // 1 MiB: don't spawn threads for small files
  int chunks = (int)std::min<size_t>((size_t)nt,
                                     std::max<size_t>(1, body_len / min_chunk));
  std::vector<std::pair<const char *, const char *>> ranges;
  const char *cp = body;
  for (int i = 0; i < chunks; ++i) {
    const char *ce = (i == chunks - 1)
                         ? end
                         : body + body_len * (size_t)(i + 1) / (size_t)chunks;
    if (ce < end) {
      const char *nl = (const char *)memchr(ce, '\n', end - ce);
      ce = nl ? nl + 1 : end;
    }
    if (cp < ce) ranges.emplace_back(cp, ce);
    cp = ce;
  }

  std::vector<std::vector<ColBuf>> parts(ranges.size());
  std::vector<std::string> errs(ranges.size());
  std::vector<std::thread> threads;
  for (size_t i = 0; i < ranges.size(); ++i) {
    threads.emplace_back([&, i] {
      parse_chunk(ranges[i].first, ranges[i].second, ncols, parts[i],
                  errs[i]);
    });
  }
  for (auto &th : threads) th.join();
  for (auto &e : errs) {
    if (!e.empty()) {
      set_error(e);
      delete t;
      return nullptr;
    }
  }
  // stitch: a column is int64 only if every chunk kept it int
  t->cols.assign(ncols, {});
  size_t total = 0;
  for (auto &p : parts) total += p.empty() ? 0 : p[0].size();
  for (size_t c = 0; c < ncols; ++c) {
    bool is_int = true;
    for (auto &p : parts)
      if (!p.empty() && !p[c].is_int) is_int = false;
    ColBuf &dst = t->cols[c];
    dst.is_int = is_int;
    if (is_int) {
      dst.ivals.reserve(total);
      for (auto &p : parts)
        if (!p.empty())
          dst.ivals.insert(dst.ivals.end(), p[c].ivals.begin(),
                           p[c].ivals.end());
    } else {
      dst.dvals.reserve(total);
      for (auto &p : parts) {
        if (p.empty()) continue;
        p[c].promote();
        dst.dvals.insert(dst.dvals.end(), p[c].dvals.begin(),
                         p[c].dvals.end());
      }
    }
  }
  t->nrows = (long)total;
  return t;
}

long zcsv_nrows(void *h) { return static_cast<CsvTable *>(h)->nrows; }
int zcsv_ncols(void *h) {
  return (int)static_cast<CsvTable *>(h)->names.size();
}
const char *zcsv_col_name(void *h, int i) {
  auto *t = static_cast<CsvTable *>(h);
  if (i < 0 || (size_t)i >= t->names.size()) return nullptr;
  return t->names[(size_t)i].c_str();
}
// 1 if column i is int64-typed (pandas dtype parity), else 0.
int zcsv_col_is_int(void *h, int i) {
  auto *t = static_cast<CsvTable *>(h);
  if (i < 0 || (size_t)i >= t->cols.size()) return 0;
  return t->cols[(size_t)i].is_int ? 1 : 0;
}
const double *zcsv_col_data(void *h, int i) {
  auto *t = static_cast<CsvTable *>(h);
  if (i < 0 || (size_t)i >= t->cols.size() || t->cols[(size_t)i].is_int)
    return nullptr;
  return t->cols[(size_t)i].dvals.data();
}
const int64_t *zcsv_col_idata(void *h, int i) {
  auto *t = static_cast<CsvTable *>(h);
  if (i < 0 || (size_t)i >= t->cols.size() || !t->cols[(size_t)i].is_int)
    return nullptr;
  return t->cols[(size_t)i].ivals.data();
}
void zcsv_close(void *h) { delete static_cast<CsvTable *>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// 3. Record store (ZREC)
// ---------------------------------------------------------------------------
//
// Layout:  "ZREC0001" | records: [u64 len | bytes]* |
//          index: u64 offset * n | u64 n | u64 index_off | "ZRECIDX1"

namespace {

constexpr char kMagic[9] = "ZREC0001";
constexpr char kFooter[9] = "ZRECIDX1";

struct RecWriter {
  FILE *fp = nullptr;
  std::vector<uint64_t> offsets;
  uint64_t pos = 0;
};

struct RecReader {
  int fd = -1;
  const uint8_t *map = nullptr;
  size_t map_len = 0;
  const uint64_t *index = nullptr;
  uint64_t n = 0;
};

}  // namespace

extern "C" {

void *zrec_writer_open(const char *path) {
  FILE *fp = fopen(path, "wb");
  if (!fp) {
    set_error(std::string("cannot create ") + path + ": " + strerror(errno));
    return nullptr;
  }
  auto *w = new RecWriter();
  w->fp = fp;
  fwrite(kMagic, 1, 8, fp);
  w->pos = 8;
  return w;
}

long zrec_write(void *h, const void *data, size_t len) {
  auto *w = static_cast<RecWriter *>(h);
  uint64_t len64 = (uint64_t)len;
  w->offsets.push_back(w->pos);
  if (fwrite(&len64, 8, 1, w->fp) != 1 ||
      (len && fwrite(data, 1, len, w->fp) != len)) {
    set_error("write failed");
    return -1;
  }
  w->pos += 8 + len;
  return (long)(w->offsets.size() - 1);
}

int zrec_writer_close(void *h) {
  auto *w = static_cast<RecWriter *>(h);
  uint64_t index_off = w->pos;
  uint64_t n = (uint64_t)w->offsets.size();
  int ok = 1;
  if (n && fwrite(w->offsets.data(), 8, n, w->fp) != n) ok = 0;
  if (fwrite(&n, 8, 1, w->fp) != 1) ok = 0;
  if (fwrite(&index_off, 8, 1, w->fp) != 1) ok = 0;
  if (fwrite(kFooter, 1, 8, w->fp) != 8) ok = 0;
  fclose(w->fp);
  delete w;
  if (!ok) set_error("footer write failed");
  return ok ? 0 : -1;
}

void *zrec_open(const char *path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    set_error(std::string("cannot open ") + path + ": " + strerror(errno));
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 8 + 24) {
    close(fd);
    set_error("not a ZREC file (too small)");
    return nullptr;
  }
  void *map = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    set_error(std::string("mmap failed: ") + strerror(errno));
    return nullptr;
  }
  const uint8_t *base = (const uint8_t *)map;
  size_t len = (size_t)st.st_size;
  if (memcmp(base, kMagic, 8) != 0 ||
      memcmp(base + len - 8, kFooter, 8) != 0) {
    munmap(map, len);
    close(fd);
    set_error("bad ZREC magic/footer");
    return nullptr;
  }
  uint64_t index_off, n;
  memcpy(&index_off, base + len - 16, 8);
  memcpy(&n, base + len - 24, 8);
  if (index_off + n * 8 + 24 != len) {
    munmap(map, len);
    close(fd);
    set_error("corrupt ZREC index");
    return nullptr;
  }
  auto *r = new RecReader();
  r->fd = fd;
  r->map = base;
  r->map_len = len;
  r->index = (const uint64_t *)(base + index_off);
  r->n = n;
  return r;
}

long zrec_count(void *h) { return (long)static_cast<RecReader *>(h)->n; }

long zrec_len(void *h, long i) {
  auto *r = static_cast<RecReader *>(h);
  if (i < 0 || (uint64_t)i >= r->n) return -1;
  uint64_t len;
  memcpy(&len, r->map + r->index[i], 8);
  return (long)len;
}

const void *zrec_ptr(void *h, long i) {
  auto *r = static_cast<RecReader *>(h);
  if (i < 0 || (uint64_t)i >= r->n) return nullptr;
  return r->map + r->index[i] + 8;
}

long zrec_read(void *h, long i, void *out, size_t cap) {
  auto *r = static_cast<RecReader *>(h);
  long len = zrec_len(h, i);
  if (len < 0) return -1;
  if ((size_t)len > cap) return -3;
  memcpy(out, r->map + r->index[i] + 8, (size_t)len);
  return len;
}

void zrec_close(void *h) {
  auto *r = static_cast<RecReader *>(h);
  if (r->map) munmap((void *)r->map, r->map_len);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

// -------------------------------------------------------------------------
// 4. Prefetcher: reader thread zrec -> zrb
// -------------------------------------------------------------------------

struct Prefetcher {
  std::thread th;
  std::atomic<bool> stop{false};
};

void *zpf_start(void *rec_h, void *rb_h, const long *order, long n,
                int loop) {
  auto *r = static_cast<RecReader *>(rec_h);
  auto *rb = static_cast<RingBuffer *>(rb_h);
  std::vector<long> ord(order, order + n);
  auto *pf = new Prefetcher();
  pf->th = std::thread([r, rb, ord = std::move(ord), loop, pf] {
    // Close the ring on EVERY exit path: a consumer blocked in zrb_pop with
    // an infinite timeout must never be stranded by a dead producer.
    do {
      for (long i : ord) {
        if (pf->stop.load()) {
          zrb_close((void *)rb);
          return;
        }
        long len = zrec_len((void *)r, i);
        if (len < 0) continue;
        const void *p = zrec_ptr((void *)r, i);
        // push with short timeouts so `stop` is honoured promptly
        while (!pf->stop.load()) {
          int rc = zrb_push((void *)rb, p, (size_t)len, 50);
          if (rc == 0) break;
          if (rc == -2 || rc == -3) {  // ring closed by consumer / oversized
            zrb_close((void *)rb);
            return;
          }
        }
      }
    } while (loop && !pf->stop.load());
    zrb_close((void *)rb);
  });
  return pf;
}

void zpf_stop(void *h) {
  auto *pf = static_cast<Prefetcher *>(h);
  pf->stop.store(true);
  if (pf->th.joinable()) pf->th.join();
  delete pf;
}

}  // extern "C"

// -------------------------------------------------------------------------
// 5. Image decode: JPEG (libjpeg) / PNG (libpng) -> RGB8 HWC buffers.
//
// The reference's image path was OpenCV behind BigDL's JNI wrapper (SURVEY
// §2.2 ImageSet row, §2.3 native obligations: host-side C++ decode, no
// pure-Python stand-ins).  System libjpeg/libpng replace OpenCV here; the
// Python side (ImageSet / NNImageReader) threads over files with the GIL
// released, so decode parallelism matches the Spark-partition decode the
// reference got for free.
// -------------------------------------------------------------------------

#ifdef ZOO_WITH_IMAGE
#include <csetjmp>
#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto *e = reinterpret_cast<JpegErr *>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->msg);
  longjmp(e->jb, 1);
}

unsigned char *decode_jpeg(const unsigned char *data, size_t n, long *h,
                           long *w, int *c) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  unsigned char *out = nullptr;
  if (setjmp(err.jb)) {
    set_error(std::string("jpeg decode: ") + err.msg);
    std::free(out);
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char *>(data), n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const long W = cinfo.output_width, H = cinfo.output_height;
  const int C = cinfo.output_components;  // 3 after JCS_RGB
  out = static_cast<unsigned char *>(std::malloc((size_t)W * H * C));
  if (!out) longjmp(err.jb, 1);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char *row = out + (size_t)cinfo.output_scanline * W * C;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *h = H; *w = W; *c = C;
  return out;
}

unsigned char *decode_png(const unsigned char *data, size_t n, long *h,
                          long *w, int *c) {
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, data, n)) {
    set_error(std::string("png decode: ") + img.message);
    return nullptr;
  }
  img.format = PNG_FORMAT_RGB;
  const size_t stride = PNG_IMAGE_ROW_STRIDE(img);
  auto *out = static_cast<unsigned char *>(
      std::malloc(PNG_IMAGE_BUFFER_SIZE(img, stride)));
  if (!out) {
    png_image_free(&img);
    set_error("png decode: oom");
    return nullptr;
  }
  if (!png_image_finish_read(&img, nullptr, out, (png_int_32)stride,
                             nullptr)) {
    set_error(std::string("png decode: ") + img.message);
    std::free(out);
    return nullptr;
  }
  *h = img.height; *w = img.width; *c = 3;
  return out;
}

}  // namespace

extern "C" {

unsigned char *zimg_decode_mem(const void *data, size_t n, long *h, long *w,
                               int *c) {
  const auto *p = static_cast<const unsigned char *>(data);
  if (n >= 2 && p[0] == 0xFF && p[1] == 0xD8) return decode_jpeg(p, n, h, w, c);
  if (n >= 4 && p[0] == 0x89 && p[1] == 'P' && p[2] == 'N' && p[3] == 'G')
    return decode_png(p, n, h, w, c);
  set_error("unrecognized image magic (JPEG/PNG supported natively)");
  return nullptr;
}

unsigned char *zimg_decode(const char *path, long *h, long *w, int *c) {
  FILE *f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("open ") + path + ": " + std::strerror(errno));
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> buf((size_t)std::max(0L, n));
  size_t got = n > 0 ? std::fread(buf.data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  if ((long)got != n) {
    set_error(std::string("short read on ") + path);
    return nullptr;
  }
  return zimg_decode_mem(buf.data(), buf.size(), h, w, c);
}

void zimg_free(unsigned char *p) { std::free(p); }

}  // extern "C"
#endif  // ZOO_WITH_IMAGE
