// nbf — native binary format for optimized-model artifacts.
//
// Copy of paddle_lite_tpu/native/nbf.cc, byte layout and magic unchanged, so
// an artifact written by either package loads in the other.
//
// A re-design of Paddle-Lite's NaiveBuffer serializer
// (lite/model_parser/naive_buffer/): the `.nb` deployment artifact written
// by the opt tool and loaded by the light predictor.  Same role, new format:
// a versioned header, a JSON metadata section (graph structure + tensor
// manifest), then 64-byte-aligned raw tensor blobs, each CRC32-checked.
// The reference's protobuf-free loader motivation maps here to a
// numpy/orbax-free loader: one mmap-able file, C ABI, ctypes-bound
// (Python-side: paddle_lite_tpu_torch/formats/artifact.py).
//
// Layout:
//   [0..8)    magic "PLTPUNB1"
//   [8..12)   u32 version (=1)
//   [12..16)  u32 header crc32 (of bytes 0..12)
//   [16..24)  u64 meta_len
//   [24..28)  u32 meta crc32
//   [28..28+meta_len) meta JSON (UTF-8)
//   then per tensor, at the offsets recorded in the manifest:
//   64-aligned raw blob; manifest records {name, dtype, shape, offset,
//   nbytes, crc32}.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kMagic[8] = {'P', 'L', 'T', 'P', 'U', 'N', 'B', '1'};
constexpr uint32_t kVersion = 1;
constexpr uint64_t kAlign = 64;

uint32_t crc32_table[256];
bool crc32_init_done = false;

void crc32_init() {
  if (crc32_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc32_init_done = true;
}

uint32_t crc32(const uint8_t* data, uint64_t len, uint32_t seed = 0) {
  crc32_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; ++i)
    c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint64_t align_up(uint64_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

thread_local std::string g_error;

void set_error(const std::string& e) { g_error = e; }

}  // namespace

extern "C" {

// ---- error reporting ------------------------------------------------------
const char* nbf_last_error() { return g_error.c_str(); }

// ---- layout helper: where will blob i land?  ------------------------------
// Python computes the manifest (with offsets) before writing; this keeps the
// offset arithmetic in ONE place shared by writer and reader.
uint64_t nbf_blob_offset(uint64_t meta_len, const uint64_t* blob_sizes,
                         uint64_t idx) {
  uint64_t off = align_up(28 + meta_len);
  for (uint64_t i = 0; i < idx; ++i) off = align_up(off + blob_sizes[i]);
  return off;
}

uint32_t nbf_crc32(const void* data, uint64_t len) {
  return crc32(static_cast<const uint8_t*>(data), len);
}

// ---- writer ---------------------------------------------------------------
// blobs[i] points at blob_sizes[i] bytes. Returns 0 on success.
int nbf_write(const char* path, const char* meta, uint64_t meta_len,
              const void* const* blobs, const uint64_t* blob_sizes,
              uint64_t n_blobs) {
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    set_error(std::string("cannot open for write: ") + path);
    return 1;
  }
  uint8_t header[12];
  std::memcpy(header, kMagic, 8);
  std::memcpy(header + 8, &kVersion, 4);
  uint32_t hcrc = crc32(header, 12);
  uint32_t mcrc = crc32(reinterpret_cast<const uint8_t*>(meta), meta_len);
  bool ok = std::fwrite(header, 1, 12, f) == 12 &&
            std::fwrite(&hcrc, 4, 1, f) == 1 &&
            std::fwrite(&meta_len, 8, 1, f) == 1 &&
            std::fwrite(&mcrc, 4, 1, f) == 1 &&
            std::fwrite(meta, 1, meta_len, f) == meta_len;
  uint64_t pos = 28 + meta_len;
  static const uint8_t zeros[kAlign] = {0};
  for (uint64_t i = 0; ok && i < n_blobs; ++i) {
    uint64_t target = align_up(pos);
    if (target > pos) ok &= std::fwrite(zeros, 1, target - pos, f) == target - pos;
    pos = target;
    ok &= std::fwrite(blobs[i], 1, blob_sizes[i], f) == blob_sizes[i];
    pos += blob_sizes[i];
  }
  if (std::fclose(f) != 0) ok = false;
  if (!ok) {
    set_error(std::string("short write: ") + path);
    return 2;
  }
  return 0;
}

// ---- reader ---------------------------------------------------------------
// Validates magic/version/header-crc; returns meta_len, or 0 on error.
uint64_t nbf_read_meta_len(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open: ") + path);
    return 0;
  }
  uint8_t header[12];
  uint32_t hcrc = 0;
  uint64_t meta_len = 0;
  bool ok = std::fread(header, 1, 12, f) == 12 &&
            std::fread(&hcrc, 4, 1, f) == 1 &&
            std::fread(&meta_len, 8, 1, f) == 1;
  std::fclose(f);
  if (!ok || std::memcmp(header, kMagic, 8) != 0) {
    set_error("bad magic or truncated header");
    return 0;
  }
  uint32_t version;
  std::memcpy(&version, header + 8, 4);
  if (version != kVersion) {
    set_error("unsupported artifact version " + std::to_string(version));
    return 0;
  }
  if (crc32(header, 12) != hcrc) {
    set_error("header crc mismatch");
    return 0;
  }
  return meta_len;
}

// Reads + crc-checks the meta JSON into out (caller allocates meta_len).
int nbf_read_meta(const char* path, char* out, uint64_t meta_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open: ") + path);
    return 1;
  }
  uint32_t mcrc = 0;
  bool ok = std::fseek(f, 24, SEEK_SET) == 0 &&
            std::fread(&mcrc, 4, 1, f) == 1 &&
            std::fread(out, 1, meta_len, f) == meta_len;
  std::fclose(f);
  if (!ok) {
    set_error("truncated meta section");
    return 2;
  }
  if (crc32(reinterpret_cast<const uint8_t*>(out), meta_len) != mcrc) {
    set_error("meta crc mismatch");
    return 3;
  }
  return 0;
}

// Reads one blob at (offset, nbytes) into out and verifies expected_crc
// (pass 0xFFFFFFFF to skip the check).
int nbf_read_blob(const char* path, uint64_t offset, uint64_t nbytes,
                  void* out, uint32_t expected_crc) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open: ") + path);
    return 1;
  }
  bool ok = std::fseek(f, static_cast<long>(offset), SEEK_SET) == 0 &&
            std::fread(out, 1, nbytes, f) == nbytes;
  std::fclose(f);
  if (!ok) {
    set_error("truncated blob");
    return 2;
  }
  if (expected_crc != 0xFFFFFFFFu &&
      crc32(static_cast<const uint8_t*>(out), nbytes) != expected_crc) {
    set_error("blob crc mismatch");
    return 3;
  }
  return 0;
}

}  // extern "C"
