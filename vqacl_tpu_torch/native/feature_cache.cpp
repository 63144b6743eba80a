// vqacl_tpu_torch native feature cache — memory-mapped region-feature pack
// (the same source and pack format as vqacl_tpu/native/feature_cache.cpp,
// so a pack written by either package reads in the other).
//
// Replaces the HDF5 C library + per-item h5py reads on the data hot path
// (reference: VL-T5/src/vqa_data_memory.py:141-189 reads 36x2048 features
// per example through h5py). The pack is a flat mmap'd file; batch
// gathers run multi-threaded straight into the caller's pinned buffer,
// with box normalization (x/img_w, y/img_h, clip to [0,1]) fused in —
// the work the python loader did per item.
//
// File layout (little-endian):
//   [0]  u64 magic 0x56514143'4c504b31  ("VQACLPK1")
//   [8]  u32 version, u32 n_images, u32 n_boxes, u32 feat_dim
//   [24] index: n_images x { u64 name_hash; u64 offset; f32 img_h, img_w }
//   blobs at offset: feat[n_boxes*feat_dim] f32, boxes[n_boxes*4] f32
//
// name_hash = FNV-1a over the image-id string; collisions are rejected at
// pack time by the python builder. Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr uint64_t kMagic = 0x56514143'4c504b31ULL;

struct IndexEntry {
  uint64_t name_hash;
  uint64_t offset;
  float img_h;
  float img_w;
};

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint32_t n_images = 0, n_boxes = 0, feat_dim = 0;
  const IndexEntry* index = nullptr;  // sorted by name_hash
};

inline float clip01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

}  // namespace

extern "C" {

uint64_t vf_hash(const char* s) {
  // FNV-1a 64-bit
  uint64_t h = 1469598103934665603ULL;
  for (const unsigned char* p = (const unsigned char*)s; *p; ++p) {
    h ^= *p;
    h *= 1099511628211ULL;
  }
  return h;
}

void* vf_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { ::close(fd); return nullptr; }
  madvise(base, st.st_size, MADV_WILLNEED);
  auto* p = new Pack;
  p->fd = fd;
  p->base = (const uint8_t*)base;
  p->size = st.st_size;
  uint64_t magic;
  memcpy(&magic, p->base, 8);
  if (magic != kMagic) { delete p; return nullptr; }
  uint32_t hdr[4];
  memcpy(hdr, p->base + 8, 16);
  p->n_images = hdr[1];
  p->n_boxes = hdr[2];
  p->feat_dim = hdr[3];
  p->index = (const IndexEntry*)(p->base + 24);
  return p;
}

void vf_close(void* h) {
  auto* p = (Pack*)h;
  if (!p) return;
  munmap((void*)p->base, p->size);
  ::close(p->fd);
  delete p;
}

uint32_t vf_n_images(void* h) { return ((Pack*)h)->n_images; }
uint32_t vf_n_boxes(void* h) { return ((Pack*)h)->n_boxes; }
uint32_t vf_feat_dim(void* h) { return ((Pack*)h)->feat_dim; }

// binary search the sorted index; returns slot or -1
int64_t vf_find(void* h, uint64_t name_hash) {
  auto* p = (Pack*)h;
  const IndexEntry* lo = p->index;
  const IndexEntry* hi = p->index + p->n_images;
  const IndexEntry* it = std::lower_bound(
      lo, hi, name_hash,
      [](const IndexEntry& e, uint64_t v) { return e.name_hash < v; });
  if (it == hi || it->name_hash != name_hash) return -1;
  return it - lo;
}

// Gather a batch: slots[n] → feats[n, n_boxes, feat_dim] and
// boxes[n, n_boxes, 4] (normalized + clipped). Negative slot → zeros.
void vf_gather(void* h, const int64_t* slots, int n,
               float* out_feats, float* out_boxes, int n_threads) {
  auto* p = (Pack*)h;
  const size_t feat_len = (size_t)p->n_boxes * p->feat_dim;
  const size_t box_len = (size_t)p->n_boxes * 4;

  auto work = [&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      float* feat_dst = out_feats + (size_t)i * feat_len;
      float* box_dst = out_boxes + (size_t)i * box_len;
      int64_t slot = slots[i];
      if (slot < 0 || slot >= (int64_t)p->n_images) {
        memset(feat_dst, 0, feat_len * 4);
        memset(box_dst, 0, box_len * 4);
        continue;
      }
      const IndexEntry& e = p->index[slot];
      const uint8_t* blob = p->base + e.offset;
      memcpy(feat_dst, blob, feat_len * 4);
      const float* src_boxes = (const float*)(blob + feat_len * 4);
      const float inv_w = 1.0f / e.img_w;
      const float inv_h = 1.0f / e.img_h;
      for (uint32_t b = 0; b < p->n_boxes; ++b) {
        box_dst[b * 4 + 0] = clip01(src_boxes[b * 4 + 0] * inv_w);
        box_dst[b * 4 + 1] = clip01(src_boxes[b * 4 + 1] * inv_h);
        box_dst[b * 4 + 2] = clip01(src_boxes[b * 4 + 2] * inv_w);
        box_dst[b * 4 + 3] = clip01(src_boxes[b * 4 + 3] * inv_h);
      }
    }
  };

  if (n_threads <= 1 || n < 4) {
    work(0, n);
    return;
  }
  n_threads = std::min(n_threads, n);
  std::vector<std::thread> threads;
  int per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int b = t * per, e = std::min(n, b + per);
    if (b >= e) break;
    threads.emplace_back(work, b, e);
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
