// RecordIO reader and writer in host C++ (the port's copy of the JAX
// package's native/recordio.cc): dmlc-core's on-disk format,
// [magic:u32][cflag|len:u32][payload][zeros to a multiple of 4 bytes],
// so .rec files written by either package read in the other.  The
// Python classes of recordio.py keep their own reader; the image-record
// pipeline (image_pipeline.cc) scans offsets and reads payloads with
// positioned reads of its own.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

inline uint32_t EncodeLRec(uint32_t cflag, uint32_t length) {
  return (cflag << 29U) | length;
}
inline uint32_t DecodeLength(uint32_t rec) { return rec & ((1U << 29U) - 1U); }

struct Writer {
  FILE* fp;
};

struct Reader {
  FILE* fp;
  std::string buf;
};

}  // namespace

extern "C" {

void* rio_writer_create(const char* path) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return nullptr;
  return new Writer{fp};
}

// The byte offset of the record (for the .idx file), or -1.
int64_t rio_writer_write(void* h, const char* data, uint64_t len) {
  auto* w = static_cast<Writer*>(h);
  int64_t pos = static_cast<int64_t>(std::ftell(w->fp));
  uint32_t magic = kMagic;
  uint32_t lrec = EncodeLRec(0, static_cast<uint32_t>(len));
  if (std::fwrite(&magic, 4, 1, w->fp) != 1) return -1;
  if (std::fwrite(&lrec, 4, 1, w->fp) != 1) return -1;
  if (len && std::fwrite(data, 1, len, w->fp) != len) return -1;
  uint64_t pad = (4 - (len & 3U)) & 3U;
  uint32_t zero = 0;
  if (pad && std::fwrite(&zero, 1, pad, w->fp) != pad) return -1;
  return pos;
}

int64_t rio_writer_tell(void* h) {
  return static_cast<int64_t>(std::ftell(static_cast<Writer*>(h)->fp));
}

void rio_writer_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  std::fclose(w->fp);
  delete w;
}

void* rio_reader_create(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  return new Reader{fp, std::string()};
}

// Reads the next record; *out points into reader-owned storage valid
// until the next call.  1 on success, 0 at the end, -1 if corrupt.
int rio_reader_next(void* h, const char** out, uint64_t* len) {
  auto* r = static_cast<Reader*>(h);
  uint32_t magic = 0, lrec = 0;
  if (std::fread(&magic, 4, 1, r->fp) != 1) return 0;
  if (magic != kMagic) return -1;
  if (std::fread(&lrec, 4, 1, r->fp) != 1) return -1;
  uint32_t length = DecodeLength(lrec);
  r->buf.resize(length);
  if (length && std::fread(&r->buf[0], 1, length, r->fp) != length) return -1;
  uint64_t pad = (4 - (length & 3U)) & 3U;
  if (pad) std::fseek(r->fp, static_cast<long>(pad), SEEK_CUR);
  *out = r->buf.data();
  *len = length;
  return 1;
}

void rio_reader_seek(void* h, int64_t pos) {
  std::fseek(static_cast<Reader*>(h)->fp, static_cast<long>(pos), SEEK_SET);
}

int64_t rio_reader_tell(void* h) {
  return static_cast<int64_t>(std::ftell(static_cast<Reader*>(h)->fp));
}

void rio_reader_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  std::fclose(r->fp);
  delete r;
}

}  // extern "C"
