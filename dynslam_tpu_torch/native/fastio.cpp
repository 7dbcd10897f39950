// fastio — the staged path's file parsers in C++, behind a plain C ABI.
//
// The counterpart of dynslam_tpu/native/fastio.cpp (a CPython extension
// there): the same three parsers, plus the PNG row unfilter, with no
// Python or numpy header. The caller (native/fastio.py) allocates every
// output array, passes its pointer and size, and turns the returned code
// into an exception. Called through ctypes, each function runs without
// the interpreter lock, so a reader thread (io/prefetch.py) parses while
// the frame thread runs Python.
//
//   fastio_read_text_mask  numpy-text binary masks of the MNC dumps
//   fastio_pfm_header      a PFM file's dims, channels, byte order, offset
//   fastio_read_pfm        its payload, top-down, in host byte order
//   fastio_read_file       a whole file into a buffer (velodyne scans)
//   fastio_png_unfilter    undo the five PNG row filters
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (native/build.py).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// return codes; native/fastio.py maps each to its exception
enum {
  kOk = 0,
  kCannotOpen = 1,   // FileNotFoundError
  kBadToken = 2,     // info[0]: byte offset of the token
  kRowLength = 3,    // info[0]: row, info[1]: values in it
  kRowCount = 4,     // info[0]: rows, info[1]: values in all
  kNotPfm = 5,
  kPfmHeader = 6,    // truncated header or bad dims
  kTruncated = 7,    // payload shorter than the header says
  kBadFilter = 8,    // info[0]: row, info[1]: its filter byte
};

bool ReadFile(const char *path, std::vector<char> &buf) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  buf.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(buf.data(), 1, buf.size(), f) : 0;
  std::fclose(f);
  return got == buf.size();
}

bool IsBlank(char c) { return c == ' ' || c == '\t' || c == '\r'; }

bool IsLittleEndianHost() {
  const uint16_t one = 1;
  return *reinterpret_cast<const uint8_t *>(&one) == 1;
}

int PaethPredict(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

int fastio_abi_version() { return 1; }

// A (height, width) mask of whitespace-separated numbers ("1.000e+00" or
// "1"), one row a line, as np.loadtxt(ndmin=2).astype(uint8) reads it:
// every non-empty line must hold width values and there must be height
// such lines.
int fastio_read_text_mask(const char *path, int height, int width,
                          uint8_t *out, int64_t *info) {
  std::vector<char> buf;
  if (!ReadFile(path, buf)) return kCannotOpen;
  const char *p = buf.data();
  const char *end = p + buf.size();
  int64_t row = 0, in_row = 0, total = 0;
  const int64_t cap = static_cast<int64_t>(height) * width;
  while (p < end) {
    if (IsBlank(*p)) {
      ++p;
      continue;
    }
    if (*p == '\n') {
      if (in_row) {
        if (in_row != width) {
          info[0] = row;
          info[1] = in_row;
          return kRowLength;
        }
        ++row;
        in_row = 0;
      }
      ++p;
      continue;
    }
    char *next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) {
      info[0] = p - buf.data();
      return kBadToken;
    }
    if (total < cap) out[total] = static_cast<uint8_t>(v);
    ++total;
    ++in_row;
    p = next;
  }
  if (in_row) {  // a last line without its newline
    if (in_row != width) {
      info[0] = row;
      info[1] = in_row;
      return kRowLength;
    }
    ++row;
  }
  if (row != height || total != cap) {
    info[0] = row;
    info[1] = total;
    return kRowCount;
  }
  return kOk;
}

// dims[0..3] = width, height, channels (1 "Pf" or 3 "PF"), 1 if the
// payload is little-endian (negative scale); *offset = its first byte.
int fastio_pfm_header(const char *path, int64_t *dims, int64_t *offset) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return kCannotOpen;
  char head[512];
  size_t n = std::fread(head, 1, sizeof(head), f);
  std::fclose(f);
  const char *p = head;
  const char *end = head + n;
  auto next_token = [&](std::string &tok) -> bool {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    while (p < end && *p == '#') {  // comment lines
      while (p < end && *p != '\n') ++p;
      while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    }
    tok.clear();
    while (p < end && !std::isspace(static_cast<unsigned char>(*p)))
      tok.push_back(*p++);
    return !tok.empty();
  };
  std::string kind, ws, hs, ss;
  if (!next_token(kind) || (kind != "PF" && kind != "Pf")) return kNotPfm;
  if (!next_token(ws) || !next_token(hs) || !next_token(ss) || p >= end)
    return kPfmHeader;
  dims[0] = std::strtol(ws.c_str(), nullptr, 10);
  dims[1] = std::strtol(hs.c_str(), nullptr, 10);
  dims[2] = kind == "PF" ? 3 : 1;
  dims[3] = std::strtod(ss.c_str(), nullptr) < 0.0;
  if (dims[0] <= 0 || dims[1] <= 0) return kPfmHeader;
  *offset = (p - head) + 1;  // one whitespace byte after the scale
  return kOk;
}

// The payload of a PFM file (fastio_pfm_header's values) into out
// (height, width[, channels]) float32: rows flipped to top-down, bytes
// swapped where the file's order is not the host's.
int fastio_read_pfm(const char *path, int64_t offset, int64_t width,
                    int64_t height, int64_t channels, int little,
                    float *out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return kCannotOpen;
  const int64_t row = width * channels;
  std::vector<float> buf(static_cast<size_t>(row * height));
  std::fseek(f, static_cast<long>(offset), SEEK_SET);
  size_t got = std::fread(buf.data(), sizeof(float), buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return kTruncated;
  const bool swap = (little != 0) != IsLittleEndianHost();
  for (int64_t r = 0; r < height; ++r) {
    const float *src = buf.data() + (height - 1 - r) * row;
    float *dst = out + r * row;
    if (!swap) {
      std::memcpy(dst, src, row * sizeof(float));
      continue;
    }
    for (int64_t c = 0; c < row; ++c) {
      uint32_t v;
      std::memcpy(&v, &src[c], 4);
      v = __builtin_bswap32(v);
      std::memcpy(&dst[c], &v, 4);
    }
  }
  return kOk;
}

// A whole file of exactly nbytes bytes into out.
int fastio_read_file(const char *path, void *out, int64_t nbytes) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return kCannotOpen;
  size_t got = nbytes ? std::fread(out, 1, static_cast<size_t>(nbytes), f)
                      : 0;
  int extra = std::fgetc(f);
  std::fclose(f);
  return (static_cast<int64_t>(got) == nbytes && extra == EOF) ? kOk
                                                               : kTruncated;
}

// Undo the PNG row filters (None, Sub, Up, Average, Paeth) row by row:
// raw row r starts at raw + r * raw_stride (width * bpp filtered bytes),
// its filter byte is ftype[r * ftype_stride]; out is (height, width *
// bpp) contiguous.
int fastio_png_unfilter(const uint8_t *raw, int64_t raw_stride,
                        const uint8_t *ftype, int64_t ftype_stride,
                        int height, int width, int bpp, uint8_t *out,
                        int64_t *info) {
  const int64_t n = static_cast<int64_t>(width) * bpp;
  for (int r = 0; r < height; ++r) {
    const uint8_t *src = raw + r * raw_stride;
    uint8_t *dst = out + r * n;
    const uint8_t *up = r ? dst - n : nullptr;
    const int kind = ftype[r * ftype_stride];
    switch (kind) {
      case 0:
        std::memcpy(dst, src, n);
        break;
      case 1:
        for (int64_t i = 0; i < n; ++i)
          dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < n; ++i) dst[i] = src[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < n; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < n; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + PaethPredict(a, b, c));
        }
        break;
      default:
        info[0] = r;
        info[1] = kind;
        return kBadFilter;
    }
  }
  return kOk;
}

}  // extern "C"
