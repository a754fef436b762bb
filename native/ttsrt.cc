// libttsrt — native runtime for the Qwen3-TTS framework.
//
// Counterparts of the reference's host-native components
// (SURVEY §2): npy IO (#7 npy_reader.h), the socket server/framing plumbing
// shared by the three reference servers (#2/#5/#9 recv_exact/send_exact
// loops, e.g. code_predictor_server.cpp:91-109), WAV output
// (tts_client.py:262-271), and zero-copy safetensors weight access
// (replacing the GGUF/npz extraction toolchain, scripts 12-15).
//
// Exposed as a C ABI for ctypes (the same pattern the reference uses for
// llama_wrapper.c, minus the struct-by-value pitfalls it works around).
//
// Build: make -C native

#include <arpa/inet.h>
#include <fcntl.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#include <atomic>
#include <map>
#include <string>
#include <vector>

#include "npyio.h"

extern "C" {

// ---------------------------------------------------------------------------
// npy IO
// ---------------------------------------------------------------------------

struct NpyHandle {
  ttsrt::NpyArray arr;
};

void* ttsrt_npy_read(const char* path) {
  auto* h = new NpyHandle();
  std::string err;
  if (!ttsrt::npy_read(path, h->arr, &err)) {
    delete h;
    return nullptr;
  }
  return h;
}

int ttsrt_npy_ndim(void* h) {
  return static_cast<int>(static_cast<NpyHandle*>(h)->arr.shape.size());
}

int64_t ttsrt_npy_dim(void* h, int i) {
  return static_cast<NpyHandle*>(h)->arr.shape[i];
}

const char* ttsrt_npy_dtype(void* h) {
  return static_cast<NpyHandle*>(h)->arr.dtype.c_str();
}

const void* ttsrt_npy_data(void* h) {
  return static_cast<NpyHandle*>(h)->arr.data.data();
}

void ttsrt_npy_free(void* h) { delete static_cast<NpyHandle*>(h); }

int ttsrt_npy_write(const char* path, const void* data, const int64_t* shape,
                    int ndim, const char* dtype) {
  std::vector<int64_t> s(shape, shape + ndim);
  return ttsrt::npy_write(path, data, s, dtype) ? 0 : -1;
}

// ---------------------------------------------------------------------------
// safetensors: mmap + header parse (zero-copy tensor access)
// ---------------------------------------------------------------------------

struct StTensor {
  std::string dtype;
  std::vector<int64_t> shape;
  uint64_t begin, end;  // offsets into data section
};

void ttsrt_st_close(void* h);  // defined below; used by ttsrt_st_open

struct StFile {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t data_off = 0;
  std::map<std::string, StTensor> tensors;
  std::vector<std::string> names;
};

// Tiny JSON scanner sufficient for the safetensors header format:
// {"name":{"dtype":"F32","shape":[a,b],"data_offsets":[s,e]},...}
static bool parse_st_header(const char* js, size_t len, StFile* f) {
  size_t i = 0;
  auto skip_ws = [&] { while (i < len && (js[i] == ' ' || js[i] == '\n' || js[i] == '\t' || js[i] == '\r' || js[i] == ',')) ++i; };
  auto parse_string = [&](std::string& out) -> bool {
    if (js[i] != '"') return false;
    ++i;
    out.clear();
    while (i < len && js[i] != '"') {
      if (js[i] == '\\' && i + 1 < len) ++i;
      out += js[i++];
    }
    if (i >= len) return false;
    ++i;
    return true;
  };
  skip_ws();
  if (js[i] != '{') return false;
  ++i;
  while (true) {
    skip_ws();
    if (i >= len) return false;
    if (js[i] == '}') return true;
    std::string name;
    if (!parse_string(name)) return false;
    skip_ws();
    if (js[i] != ':') return false;
    ++i;
    skip_ws();
    if (js[i] != '{') return false;
    ++i;
    StTensor t;
    while (true) {
      skip_ws();
      if (js[i] == '}') { ++i; break; }
      std::string key;
      if (!parse_string(key)) return false;
      skip_ws();
      if (js[i] != ':') return false;
      ++i;
      skip_ws();
      if (key == "dtype") {
        if (!parse_string(t.dtype)) return false;
      } else if (key == "shape" || key == "data_offsets") {
        if (js[i] != '[') return false;
        ++i;
        std::vector<int64_t> vals;
        while (true) {
          skip_ws();
          if (i >= len) return false;
          if (js[i] == ']') { ++i; break; }
          char* endp = nullptr;
          vals.push_back(strtoll(js + i, &endp, 10));
          if (endp == js + i) return false;  // no digits: corrupt header
          i = endp - js;
        }
        if (key == "shape") t.shape = vals;
        else if (vals.size() == 2) { t.begin = vals[0]; t.end = vals[1]; }
      } else {
        // skip arbitrary value (string / object / array) — metadata
        if (js[i] == '"') { std::string tmp; if (!parse_string(tmp)) return false; }
        else if (js[i] == '{' || js[i] == '[') {
          char open = js[i], close = (open == '{') ? '}' : ']';
          int depth = 0;
          while (i < len) {
            if (js[i] == '"') { std::string tmp; if (!parse_string(tmp)) return false; continue; }
            if (js[i] == open) ++depth;
            if (js[i] == close && --depth == 0) { ++i; break; }
            ++i;
          }
        } else {
          while (i < len && js[i] != ',' && js[i] != '}') ++i;
        }
      }
    }
    if (name != "__metadata__") {
      f->tensors[name] = t;
      f->names.push_back(name);
    }
  }
}

void* ttsrt_st_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  auto* f = new StFile();
  f->fd = fd;
  f->size = static_cast<size_t>(st.st_size);
  f->base = static_cast<uint8_t*>(
      mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, fd, 0));
  if (f->base == MAP_FAILED) { close(fd); delete f; return nullptr; }
  uint64_t hlen;
  if (f->size < 8) { ttsrt_st_close(f); return nullptr; }
  memcpy(&hlen, f->base, 8);
  // hlen near UINT64_MAX would wrap 8 + hlen to a small data_off and pass
  // the old check — compare against the remaining bytes instead
  if (hlen > f->size - 8 ||
      !parse_st_header(reinterpret_cast<const char*>(f->base + 8), hlen, f)) {
    ttsrt_st_close(f);
    return nullptr;
  }
  f->data_off = 8 + hlen;
  // validate every tensor's data_offsets against the mapped data region:
  // a truncated checkpoint with an intact header would otherwise SIGBUS
  // on the first read past the file end (the Python fallback raises)
  const uint64_t data_len = f->size - f->data_off;
  for (const auto& kv : f->tensors) {
    const StTensor& t = kv.second;  // begin/end are uint64 (negatives wrap
    if (t.end < t.begin || t.end > data_len) {  // huge and fail > data_len)
      ttsrt_st_close(f);
      return nullptr;
    }
  }
  return f;
}

int ttsrt_st_count(void* h) {
  return static_cast<int>(static_cast<StFile*>(h)->names.size());
}

const char* ttsrt_st_name(void* h, int i) {
  return static_cast<StFile*>(h)->names[i].c_str();
}

// Fills dtype (caller buffer >= 8), shape (caller buffer >= 8 dims).
// Returns ndim, or -1 if not found. nbytes receives the byte size.
int ttsrt_st_info(void* h, const char* name, char* dtype, int64_t* shape,
                  int64_t* nbytes) {
  auto* f = static_cast<StFile*>(h);
  auto it = f->tensors.find(name);
  if (it == f->tensors.end()) return -1;
  snprintf(dtype, 8, "%s", it->second.dtype.c_str());
  for (size_t i = 0; i < it->second.shape.size() && i < 8; ++i)
    shape[i] = it->second.shape[i];
  *nbytes = static_cast<int64_t>(it->second.end - it->second.begin);
  return static_cast<int>(it->second.shape.size());
}

const void* ttsrt_st_data(void* h, const char* name) {
  auto* f = static_cast<StFile*>(h);
  auto it = f->tensors.find(name);
  if (it == f->tensors.end()) return nullptr;
  return f->base + f->data_off + it->second.begin;
}

void ttsrt_st_close(void* h) {
  auto* f = static_cast<StFile*>(h);
  if (f->base) munmap(f->base, f->size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

// ---------------------------------------------------------------------------
// WAV writer (16-bit mono PCM)
// ---------------------------------------------------------------------------

int ttsrt_wav_write(const char* path, const int16_t* data, int64_t n,
                    int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = static_cast<uint32_t>(n * 2);
  uint32_t chunk = 36 + data_bytes;
  uint16_t fmt = 1, ch = 1, bits = 16;
  uint32_t byte_rate = sample_rate * 2;
  uint16_t block_align = 2;
  // every write checked: a full disk (ENOSPC) must surface as rc != 0,
  // not a silently truncated WAV (review finding)
  bool ok = true;
  ok &= fwrite("RIFF", 1, 4, f) == 4;
  ok &= fwrite(&chunk, 4, 1, f) == 1;
  ok &= fwrite("WAVEfmt ", 1, 8, f) == 8;
  uint32_t fmt_size = 16;
  ok &= fwrite(&fmt_size, 4, 1, f) == 1;
  ok &= fwrite(&fmt, 2, 1, f) == 1;
  ok &= fwrite(&ch, 2, 1, f) == 1;
  ok &= fwrite(&sample_rate, 4, 1, f) == 1;
  ok &= fwrite(&byte_rate, 4, 1, f) == 1;
  ok &= fwrite(&block_align, 2, 1, f) == 1;
  ok &= fwrite(&bits, 2, 1, f) == 1;
  ok &= fwrite("data", 1, 4, f) == 4;
  ok &= fwrite(&data_bytes, 4, 1, f) == 1;
  ok &= fwrite(data, 2, n, f) == static_cast<size_t>(n);
  ok &= fclose(f) == 0;
  return ok ? 0 : -1;
}

// float [-1,1] -> int16 with the reference's clip semantics
void ttsrt_f32_to_i16(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = static_cast<int16_t>(v);
  }
}

// ---------------------------------------------------------------------------
// Unix-socket daemon runtime: accept loop + exact framing, dispatching each
// request to a registered callback (Python via ctypes CFUNCTYPE).
//
// Frame format (little-endian), preserving the reference's framing style
// (llamacpp_talker_server.py:13-27):
//   request:  [u32 len][len bytes]
//   response: [u32 len][len bytes]
// ---------------------------------------------------------------------------

// Handler contract: fill `resp` and return its length (>= 0) for a single
// framed response; return TTSRT_HANDLED after writing frames directly to
// `fd` (chunked/streaming responses); any other negative -> error sentinel.
#define TTSRT_HANDLED (-2)
typedef int64_t (*ttsrt_handler)(const uint8_t* req, int64_t req_len,
                                 uint8_t* resp, int64_t resp_cap, int fd);

static std::atomic<int> g_stop_flag{0};

static bool recv_exact(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  size_t got = 0;
  while (got < n) {
    ssize_t r = recv(fd, p + got, n - got, 0);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return true;
}

static bool send_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = send(fd, p + sent, n - sent, 0);
    if (r <= 0) return false;
    sent += static_cast<size_t>(r);
  }
  return true;
}

void ttsrt_serve_stop(void) { g_stop_flag.store(1); }

// Re-arm after a previous stop. Deliberately a SEPARATE call from
// ttsrt_serve_unix: if the loop itself cleared the flag at entry, a
// stop() racing the worker thread's loop entry (e.g. a SIGTERM between
// thread start and the C call) would be silently erased and the first
// signal lost. Callers reset, then re-check their own stop state, then
// enter the loop — stop() is sticky from that point on.
void ttsrt_serve_reset(void) { g_stop_flag.store(0); }

// Serves until ttsrt_serve_stop() or error. Returns 0 on clean stop.
// max_req / resp_cap bound message sizes (the reference bounds at 64 KiB
// for headers; audio responses need more).
int ttsrt_serve_unix(const char* socket_path, ttsrt_handler handler,
                     int64_t max_req, int64_t resp_cap) {
  unlink(socket_path);
  int srv = socket(AF_UNIX, SOCK_STREAM, 0);
  if (srv < 0) return -1;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", socket_path);
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(srv, 8) != 0) {
    close(srv);
    return -1;
  }
  chmod(socket_path, 0666);

  timeval tv{1, 0};  // 1 s accept timeout to poll the stop flag
  setsockopt(srv, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));

  std::vector<uint8_t> req(static_cast<size_t>(max_req));
  std::vector<uint8_t> resp(static_cast<size_t>(resp_cap));

  while (!g_stop_flag.load()) {
    int conn = accept(srv, nullptr, nullptr);
    if (conn < 0) continue;
    setsockopt(conn, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    uint32_t len = 0;
    if (recv_exact(conn, &len, 4) && len <= max_req &&
        recv_exact(conn, req.data(), len)) {
      int64_t rlen = handler(req.data(), len, resp.data(), resp_cap, conn);
      if (rlen >= 0) {
        uint32_t rl = static_cast<uint32_t>(rlen);
        send_exact(conn, &rl, 4);
        send_exact(conn, resp.data(), rl);
      } else if (rlen != TTSRT_HANDLED) {
        int32_t sentinel = -2;  // reference error sentinel
        uint32_t rl = 4;
        send_exact(conn, &rl, 4);
        send_exact(conn, &sentinel, 4);
      }
    }
    close(conn);
  }
  close(srv);
  unlink(socket_path);
  return 0;
}

}  // extern "C"
