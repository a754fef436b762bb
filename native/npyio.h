// Minimal .npy reader/writer (v1/v2) — native equivalent of the reference's
// dual_npu/code_predictor_cpp/npy_reader.h (component #7 in SURVEY §2),
// extended with write support and int dtypes for this runtime's weight
// and tensor IO. No external dependencies.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace ttsrt {

struct NpyArray {
  std::vector<int64_t> shape;
  std::string dtype;       // e.g. "<f4", "<i4", "<i8", "<f8"
  std::vector<uint8_t> data;

  size_t elems() const {
    size_t n = 1;
    for (auto d : shape) n *= static_cast<size_t>(d);
    return n;
  }
  size_t itemsize() const {
    if (dtype.size() < 3) return 0;
    return static_cast<size_t>(dtype[2] - '0');
  }
  const float* f32() const { return reinterpret_cast<const float*>(data.data()); }
  const int32_t* i32() const { return reinterpret_cast<const int32_t*>(data.data()); }
  const int64_t* i64() const { return reinterpret_cast<const int64_t*>(data.data()); }
};

// ---------------------------------------------------------------------------
// Reading
// ---------------------------------------------------------------------------

inline bool npy_read(const char* path, NpyArray& out, std::string* err = nullptr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { if (err) *err = "open failed"; return false; }

  uint8_t magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    if (err) *err = "bad magic";
    std::fclose(f);
    return false;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t h16 = 0;
    if (std::fread(&h16, 2, 1, f) != 1) { std::fclose(f); return false; }
    header_len = h16;
  } else {
    if (std::fread(&header_len, 4, 1, f) != 1) { std::fclose(f); return false; }
  }
  std::string header(header_len, '\0');
  if (std::fread(header.data(), 1, header_len, f) != header_len) {
    std::fclose(f);
    return false;
  }

  // parse "descr"
  auto dpos = header.find("'descr'");
  if (dpos == std::string::npos) { std::fclose(f); return false; }
  auto q1 = header.find('\'', dpos + 7);
  auto q2 = header.find('\'', q1 + 1);
  out.dtype = header.substr(q1 + 1, q2 - q1 - 1);

  // parse fortran_order (we require C order)
  if (header.find("'fortran_order': True") != std::string::npos) {
    if (err) *err = "fortran order unsupported";
    std::fclose(f);
    return false;
  }

  // parse shape tuple
  auto spos = header.find("'shape'");
  auto p1 = header.find('(', spos);
  auto p2 = header.find(')', p1);
  out.shape.clear();
  {
    std::string tup = header.substr(p1 + 1, p2 - p1 - 1);
    const char* s = tup.c_str();
    while (*s) {
      while (*s == ' ' || *s == ',') ++s;
      if (!*s) break;
      out.shape.push_back(std::strtoll(s, const_cast<char**>(&s), 10));
    }
  }

  size_t bytes = out.elems() * out.itemsize();
  out.data.resize(bytes);
  if (bytes && std::fread(out.data.data(), 1, bytes, f) != bytes) {
    if (err) *err = "short read";
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  // float64 -> float32 convenience conversion (like the reference reader)
  if (out.dtype == "<f8") {
    const double* src = reinterpret_cast<const double*>(out.data.data());
    std::vector<uint8_t> conv(out.elems() * 4);
    float* dst = reinterpret_cast<float*>(conv.data());
    for (size_t i = 0; i < out.elems(); ++i) dst[i] = static_cast<float>(src[i]);
    out.data.swap(conv);
    out.dtype = "<f4";
  }
  return true;
}

// ---------------------------------------------------------------------------
// Writing
// ---------------------------------------------------------------------------

inline bool npy_write(const char* path, const void* data,
                      const std::vector<int64_t>& shape,
                      const std::string& dtype) {
  std::string shape_s = "(";
  for (size_t i = 0; i < shape.size(); ++i) {
    shape_s += std::to_string(shape[i]);
    if (i + 1 < shape.size() || shape.size() == 1) shape_s += ",";
  }
  shape_s += ")";
  std::string header = "{'descr': '" + dtype +
                       "', 'fortran_order': False, 'shape': " + shape_s + ", }";
  size_t unpadded = 10 + header.size() + 1;
  size_t pad = (64 - unpadded % 64) % 64;
  header += std::string(pad, ' ');
  header += '\n';

  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  std::fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  uint16_t hlen = static_cast<uint16_t>(header.size());
  std::fwrite(&hlen, 2, 1, f);
  std::fwrite(header.data(), 1, header.size(), f);
  size_t itemsize = static_cast<size_t>(dtype[2] - '0');
  size_t n = 1;
  for (auto d : shape) n *= static_cast<size_t>(d);
  std::fwrite(data, 1, n * itemsize, f);
  std::fclose(f);
  return true;
}

}  // namespace ttsrt
