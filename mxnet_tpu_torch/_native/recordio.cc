// Native RecordIO chunk reader — the C++ component of the data pipeline.
//
// Reference counterpart: dmlc-core's recordio.cc + the chunk readers in
// src/io/iter_image_recordio_2.cc (OMP-parallel record parsing). Here the
// file is mmap'd once and scanned into an ordinal index of logical
// records (continuation-split parts are tracked and reassembled on
// read), so Python-side iteration is one memcpy per record instead of
// per-record struct unpacking — the host-side half of keeping the TPU
// input-bound pipeline off the interpreter.
//
// Record layout (recordio spec):
//   [magic u32le = 0xced7230a][lrec u32le: cflag<<29 | len]
//   [payload][pad to 4B]
// cflag: 0 whole, 1 first, 2 middle, 3 last — split parts rejoin with
// the magic word between them.

#include <cstdint>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Part {
  uint64_t off;
  uint32_t len;
};

struct RioFile {
  const uint8_t* base = nullptr;
  uint64_t size = 0;
  int fd = -1;
  // flattened parts; record i spans parts [starts[i], starts[i+1])
  std::vector<Part> parts;
  std::vector<uint64_t> starts;
  std::vector<uint64_t> offsets;  // byte offset of record i's header
};

inline uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

}  // namespace

extern "C" {

void* rio_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  RioFile* f = new RioFile();
  f->base = static_cast<const uint8_t*>(mem);
  f->size = static_cast<uint64_t>(st.st_size);
  f->fd = fd;

  uint64_t pos = 0;
  bool in_split = false;
  while (pos + 8 <= f->size) {
    if (read_u32(f->base + pos) != kMagic) break;  // torn tail: stop
    uint32_t lrec = read_u32(f->base + pos + 4);
    uint32_t cflag = lrec >> 29u;
    uint32_t len = lrec & ((1u << 29) - 1u);
    if (pos + 8 + len > f->size) break;
    if (cflag == 0 || cflag == 1) {
      f->starts.push_back(f->parts.size());
      f->offsets.push_back(pos);
      in_split = (cflag == 1);
    } else if (!in_split) {
      break;  // corrupt: continuation without a first part
    }
    f->parts.push_back(Part{pos + 8, len});
    if (cflag == 0 || cflag == 3) in_split = false;
    pos += 8 + len + ((4 - (len & 3u)) & 3u);
  }
  if (pos != f->size || in_split) {
    // torn or non-recordio content: refuse, so the caller falls back to
    // the strict Python reader (which raises at the corrupt offset
    // instead of silently truncating the epoch)
    munmap(const_cast<uint8_t*>(f->base), f->size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  f->starts.push_back(f->parts.size());
  return f;
}

long rio_count(void* h) {
  RioFile* f = static_cast<RioFile*>(h);
  return static_cast<long>(f->starts.size()) - 1;
}

long rio_num_parts(void* h) {
  RioFile* f = static_cast<RioFile*>(h);
  return static_cast<long>(f->parts.size());
}

// one-shot index export so the Python side can slice its own mmap with
// zero per-record FFI calls: rec_starts (count+1), part offsets/lengths
// (num_parts), header offsets (count)
void rio_export(void* h, int64_t* rec_starts, int64_t* part_offs,
                int64_t* part_lens, int64_t* hdr_offs) {
  RioFile* f = static_cast<RioFile*>(h);
  for (size_t i = 0; i < f->starts.size(); ++i)
    rec_starts[i] = static_cast<int64_t>(f->starts[i]);
  for (size_t i = 0; i < f->parts.size(); ++i) {
    part_offs[i] = static_cast<int64_t>(f->parts[i].off);
    part_lens[i] = static_cast<int64_t>(f->parts[i].len);
  }
  for (size_t i = 0; i < f->offsets.size(); ++i)
    hdr_offs[i] = static_cast<int64_t>(f->offsets[i]);
}

void rio_close(void* h) {
  RioFile* f = static_cast<RioFile*>(h);
  if (f == nullptr) return;
  munmap(const_cast<uint8_t*>(f->base), f->size);
  ::close(f->fd);
  delete f;
}

}  // extern "C"
