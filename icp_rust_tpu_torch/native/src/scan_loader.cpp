// Native scan-data loader: the host-side IO runtime of the engine.
//
// The reference's data layer is native (Rust: examples/scan2d.rs:10-34
// parses whitespace "x y" text per frame; examples/scan3d.rs:34-61 reads
// HDF5 packets).  This is the C++ equivalent for the text format: a
// mmap-free, locale-free, allocation-light bulk parser that loads a whole
// scan directory into one padded (F, N_max, 2) float32 block + validity
// mask in a single call — the shape the TPU engine uploads directly.
//
// Exposed over the C ABI for ctypes (no pybind11 in this image).

#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Locale-independent float parse: std::from_chars always uses '.' as the
// decimal separator, unlike strtod which honors LC_NUMERIC (a comma-
// decimal locale in the embedding process would silently parse "1.5" as
// 1.0 — ADVICE r1).
inline const char* parse_double(const char* p, const char* end, double* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  if (p >= end) return nullptr;
  double v = 0.0;
  auto res = std::from_chars(p, end, v);
  if (res.ec != std::errc()) return nullptr;
  *out = v;
  return res.ptr;
}

struct Frame {
  std::vector<float> xy;  // interleaved x,y
};

bool load_file(const char* path, Frame* f) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  std::fseek(fp, 0, SEEK_END);
  long sz = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(sz));
  size_t rd = std::fread(buf.data(), 1, buf.size(), fp);
  std::fclose(fp);
  buf.resize(rd);
  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    double x, y;
    const char* q = parse_double(p, line_end, &x);
    if (q) {
      q = parse_double(q, line_end, &y);
      if (q) {
        f->xy.push_back(static_cast<float>(x));
        f->xy.push_back(static_cast<float>(y));
      }
      // Lines with only one parsable number are skipped, like the
      // reference's parse-failure branch (examples/scan2d.rs:23-26).
    }
    p = line_end + 1;
  }
  return true;
}

}  // namespace

extern "C" {

// Pass 1: scan the directory listing (caller supplies the file list as a
// single \n-joined string) and report frame count + max points.
// Returns an opaque handle (heap pointer) or null.
void* scan2d_open(const char* joined_paths) {
  auto* frames = new std::vector<Frame>();
  const char* p = joined_paths;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    std::string path = nl ? std::string(p, nl) : std::string(p);
    if (!path.empty()) {
      Frame f;
      if (!load_file(path.c_str(), &f)) {
        delete frames;
        return nullptr;
      }
      frames->push_back(std::move(f));
    }
    if (!nl) break;
    p = nl + 1;
  }
  return frames;
}

int64_t scan2d_num_frames(void* handle) {
  return static_cast<int64_t>(static_cast<std::vector<Frame>*>(handle)->size());
}

int64_t scan2d_max_points(void* handle) {
  int64_t mx = 0;
  for (const auto& f : *static_cast<std::vector<Frame>*>(handle)) {
    int64_t n = static_cast<int64_t>(f.xy.size() / 2);
    if (n > mx) mx = n;
  }
  return mx;
}

// Pass 2: fill caller-allocated (F, pad_to, 2) float32 points and
// (F, pad_to) uint8 mask buffers.  pad_to must be >= max_points.
void scan2d_fill(void* handle, int64_t pad_to, float* points,
                 uint8_t* mask) {
  auto* frames = static_cast<std::vector<Frame>*>(handle);
  for (size_t i = 0; i < frames->size(); ++i) {
    const auto& xy = (*frames)[i].xy;
    int64_t n = static_cast<int64_t>(xy.size() / 2);
    float* dst = points + i * pad_to * 2;
    uint8_t* m = mask + i * pad_to;
    std::memcpy(dst, xy.data(), sizeof(float) * xy.size());
    std::memset(dst + n * 2, 0, sizeof(float) * 2 *
                static_cast<size_t>(pad_to - n));
    std::memset(m, 1, static_cast<size_t>(n));
    std::memset(m + n, 0, static_cast<size_t>(pad_to - n));
  }
}

void scan2d_close(void* handle) {
  delete static_cast<std::vector<Frame>*>(handle);
}

}  // extern "C"
