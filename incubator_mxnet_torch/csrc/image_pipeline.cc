// Threaded image decode / augment / batch pipeline over RecordIO shards
// (the port's copy of the JAX package's native/image_pipeline.cc, with
// OpenCV replaced).
//
// What is kept:
//   * pread() record fetch on one shared fd and a header scan for the
//     record offsets at construction;
//   * batch slots in a ring, FREE -> FILLING -> READY -> IN_USE -> FREE,
//     one mutex and two condvars; pixel work happens outside the mutex;
//   * the JPEG SOF peek that decodes a large image at 1/2, 1/4 or 1/8 of
//     its size (libjpeg's scaled IDCTs);
//   * resize_short, then the resize that grows a small image to the crop,
//     the random or centre crop and the mirror, with per-worker
//     std::mt19937 draws seeded seed + 77551 * (tid + 1);
//   * NCHW float32 output with mean/std, or NHWC uint8;
//   * label_width and label-array records, part_index / num_parts, reset
//     and the per-epoch reshuffle, and the decode-failure count.
//
// What differs:
//   * the decode is the port's own (jpeg_codec.cc), straight to RGB;
//     only JPEG payloads decode here (another format counts as a decode
//     failure and is zero-filled);
//   * the resize is OpenCV's INTER_LINEAR on 8-bit data as OpenCV computes
//     it: coefficients in 11-bit fixed point, the horizontal pass in
//     int32, the vertical blend as OpenCV's SIMD row kernel does it,
//     ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2;
//   * the slots' memory belongs to the caller (pointers at create time),
//     so that on a CUDA machine they are page-locked tensors the card
//     copies from directly.
#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "jpeg_codec.h"

namespace {

constexpr uint32_t kMagic = 0xced7230a;

#pragma pack(push, 1)
struct IRHeader {        // recordio.py _IR_FORMAT "<IfQQ"
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};
#pragma pack(pop)

enum SlotState { kFree = 0, kFilling, kReady, kInUse };

struct Slot {
  void* data = nullptr;    // caller's: batch * c * h * w uint8 or float32
  float* label = nullptr;  // caller's: batch * label_width float32
  int state = kFree;
  int remaining = 0;       // samples still being filled (under mutex)
  int64_t batch_id = -1;   // which epoch-batch occupies this slot
};

struct Task {
  int64_t batch_id;
  int pos;                 // position within the batch
  int64_t sample;          // index into order_
};

struct Config {
  int batch = 1, c = 3, h = 224, w = 224;
  int threads = 4, prefetch = 2;
  int shuffle = 0;
  uint64_t seed = 0;
  int resize_short = 0;    // 0 = off
  int rand_crop = 0, rand_mirror = 0;
  float mean[3] = {0, 0, 0}, stdv[3] = {1, 1, 1};
  int out_uint8 = 0;       // 0: NCHW float32, 1: NHWC uint8
  int label_width = 1;
};

// JPEG dimensions from the SOF marker (no decode); false for other
// payloads or truncated streams.
bool JpegPeekDims(const uint8_t* p, size_t n, int* h, int* w) {
  if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) return false;
  size_t i = 2;
  while (i + 9 < n) {
    if (p[i] != 0xFF) return false;
    uint8_t m = p[i + 1];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD9)) { i += 2; continue; }
    uint32_t seglen = (uint32_t(p[i + 2]) << 8) | p[i + 3];
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (i + 9 >= n) return false;
      *h = (int(p[i + 5]) << 8) | p[i + 6];
      *w = (int(p[i + 7]) << 8) | p[i + 8];
      return *h > 0 && *w > 0;
    }
    i += 2 + seglen;
  }
  return false;
}

// OpenCV's INTER_LINEAR coefficients of one axis (resize.cpp,
// resizeGeneric_): the source index and the two 11-bit weights.  The x
// axis clamps its index and weight at the borders; the y axis keeps the
// weights and clamps the rows it reads.
void LinearCoeffs(int src, int dst, bool clamp, std::vector<int>* ofs,
                  std::vector<int>* coef, int* xmax) {
  double scale = 1.0 / (static_cast<double>(dst) / src);
  ofs->resize(dst);
  coef->resize(2 * dst);
  *xmax = dst;
  for (int d = 0; d < dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    if (clamp) {
      if (s < 0) { f = 0.f; s = 0; }
      if (s + 1 >= src) {
        *xmax = std::min(*xmax, d);
        if (s >= src - 1) { f = 0.f; s = src - 1; }
      }
    }
    (*ofs)[d] = s;
    (*coef)[2 * d] = static_cast<int>(std::nearbyint((1.f - f) * 2048.f));
    (*coef)[2 * d + 1] = static_cast<int>(std::nearbyint(f * 2048.f));
  }
}

// HWC uint8 with 3 channels, (sh, sw) -> (dh, dw).
void ResizeLinear(const std::vector<uint8_t>& src, int sh, int sw,
                  std::vector<uint8_t>* dst, int dh, int dw) {
  const int cn = 3;
  std::vector<int> xo, xc, yo, yc;
  int xmax, unused;
  LinearCoeffs(sw, dw, true, &xo, &xc, &xmax);
  LinearCoeffs(sh, dh, false, &yo, &yc, &unused);
  // horizontal pass of every source row, computed once
  std::vector<int32_t> hrow(static_cast<size_t>(sh) * dw * cn);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* s = src.data() + static_cast<size_t>(y) * sw * cn;
    int32_t* o = hrow.data() + static_cast<size_t>(y) * dw * cn;
    for (int x = 0; x < dw; ++x) {
      int sx = xo[x] * cn;
      for (int k = 0; k < cn; ++k) {
        if (x < xmax)
          o[x * cn + k] = s[sx + k] * xc[2 * x] + s[sx + k + cn] * xc[2 * x + 1];
        else
          o[x * cn + k] = s[sx + k] * 2048;
      }
    }
  }
  dst->resize(static_cast<size_t>(dh) * dw * cn);
  const int width = dw * cn;
  for (int y = 0; y < dh; ++y) {
    int r0 = std::min(std::max(yo[y], 0), sh - 1);
    int r1 = std::min(std::max(yo[y] + 1, 0), sh - 1);
    const int32_t* s0 = hrow.data() + static_cast<size_t>(r0) * width;
    const int32_t* s1 = hrow.data() + static_cast<size_t>(r1) * width;
    int b0 = yc[2 * y], b1 = yc[2 * y + 1];
    uint8_t* o = dst->data() + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) {
      int v = (((s0[x] >> 4) * b0) >> 16) + (((s1[x] >> 4) * b1) >> 16);
      v = (v + 2) >> 2;
      o[x] = static_cast<uint8_t>(std::min(255, std::max(0, v)));
    }
  }
}

class Pipe {
 public:
  Pipe(const char* rec_path, const Config& cfg, int part_index, int num_parts,
       void** slot_data, float** slot_label)
      : cfg_(cfg) {
    fd_ = ::open(rec_path, O_RDONLY);
    if (fd_ < 0) { err_ = std::string("cannot open ") + rec_path; return; }
    ScanOffsets();
    if (num_parts > 1) {
      int64_t n = offsets_.size(), per = n / num_parts;
      int64_t lo = part_index * per;
      int64_t hi = (part_index == num_parts - 1) ? n : lo + per;
      offsets_.assign(offsets_.begin() + lo, offsets_.begin() + hi);
    }
    num_batches_ = static_cast<int64_t>(offsets_.size()) / cfg_.batch;
    order_.resize(offsets_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    slots_.resize(cfg_.prefetch);
    for (int k = 0; k < cfg_.prefetch; ++k) {
      slots_[k].data = slot_data[k];
      slots_[k].label = slot_label[k];
    }
    Rearm();
    for (int t = 0; t < cfg_.threads; ++t)
      workers_.emplace_back([this, t] { WorkerLoop(t); });
  }

  ~Pipe() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_task_.notify_all();
    cv_ready_.notify_all();
    for (auto& th : workers_) th.join();
    if (fd_ >= 0) ::close(fd_);
  }

  // Blocks until the next batch is ready: 1 and its slot index (the slot
  // stays the caller's until the following Next or Reset), or 0 at the
  // end of the epoch.
  int Next(int* slot) {
    std::unique_lock<std::mutex> lk(mu_);
    ReleaseInUseLocked();
    if (consume_cursor_ >= num_batches_) return 0;
    int k = static_cast<int>(consume_cursor_ % slots_.size());
    Slot& s = slots_[k];
    cv_ready_.wait(lk, [&] {
      return stop_ || (s.state == kReady && s.batch_id == consume_cursor_);
    });
    if (stop_) return 0;
    s.state = kInUse;
    in_use_slot_ = k;
    ++consume_cursor_;
    *slot = k;
    return 1;
  }

  void Reset() {
    std::unique_lock<std::mutex> lk(mu_);
    tasks_.clear();
    cv_ready_.wait(lk, [&] { return inflight_ == 0; });
    in_use_slot_ = -1;
    ++epoch_;
    Rearm();
    lk.unlock();
    cv_task_.notify_all();
  }

  int64_t num_batches() const { return num_batches_; }
  int64_t decode_failures() const { return decode_failures_.load(); }
  const char* error() const { return err_.empty() ? nullptr : err_.c_str(); }

 private:
  void ScanOffsets() {
    int64_t pos = 0;
    uint8_t hdr[8];
    while (true) {
      if (::pread(fd_, hdr, 8, pos) != 8) break;
      uint32_t magic, lrec;
      std::memcpy(&magic, hdr, 4);
      std::memcpy(&lrec, hdr + 4, 4);
      if (magic != kMagic) { err_ = "corrupt recordio (bad magic)"; break; }
      uint32_t len = lrec & ((1U << 29) - 1U);
      offsets_.push_back(pos);
      pos += 8 + ((len + 3) & ~3U);
    }
  }

  void Rearm() {           // caller holds mu_
    if (cfg_.shuffle) {
      std::mt19937_64 rng(cfg_.seed + 0x9E3779B9u * epoch_);
      std::shuffle(order_.begin(), order_.end(), rng);
    }
    for (auto& s : slots_) { s.state = kFree; s.batch_id = -1; }
    schedule_cursor_ = 0;
    consume_cursor_ = 0;
    in_use_slot_ = -1;
    ScheduleLocked();
  }

  void ReleaseInUseLocked() {
    if (in_use_slot_ >= 0) {
      slots_[in_use_slot_].state = kFree;
      in_use_slot_ = -1;
      ScheduleLocked();
      cv_task_.notify_all();
    }
  }

  void ScheduleLocked() {
    while (schedule_cursor_ < num_batches_) {
      Slot& s = slots_[schedule_cursor_ % slots_.size()];
      if (s.state != kFree) break;
      s.state = kFilling;
      s.batch_id = schedule_cursor_;
      s.remaining = cfg_.batch;
      for (int k = 0; k < cfg_.batch; ++k)
        tasks_.push_back(Task{schedule_cursor_, k,
                              order_[schedule_cursor_ * cfg_.batch + k]});
      ++schedule_cursor_;
    }
  }

  void WorkerLoop(int tid) {
    std::mt19937 rng(static_cast<uint32_t>(cfg_.seed) + 77551u * (tid + 1));
    std::vector<uint8_t> payload, pixels, scratch;
    while (true) {
      Task t{};
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_task_.wait(lk, [&] { return stop_ || !tasks_.empty(); });
        if (stop_) return;
        t = tasks_.front();
        tasks_.pop_front();
        ++inflight_;
      }
      bool ok = Process(t, &rng, &payload, &pixels, &scratch);
      {
        std::lock_guard<std::mutex> lk(mu_);
        --inflight_;
        if (!ok) ++decode_failures_;
        Slot& s = slots_[t.batch_id % slots_.size()];
        if (s.state == kFilling && s.batch_id == t.batch_id &&
            --s.remaining == 0) {
          s.state = kReady;
          cv_ready_.notify_all();
        } else if (inflight_ == 0) {
          cv_ready_.notify_all();   // Reset() may be draining
        }
      }
    }
  }

  bool Process(const Task& t, std::mt19937* rng, std::vector<uint8_t>* payload,
               std::vector<uint8_t>* img, std::vector<uint8_t>* scratch) {
    Slot& s = slots_[t.batch_id % slots_.size()];
    float* lab = s.label + static_cast<size_t>(t.pos) * cfg_.label_width;
    for (int i = 0; i < cfg_.label_width; ++i) lab[i] = 0.f;

    int64_t off = offsets_[t.sample];
    uint8_t hdr8[8];
    if (::pread(fd_, hdr8, 8, off) != 8) return FillZero(t);
    uint32_t lrec;
    std::memcpy(&lrec, hdr8 + 4, 4);
    uint32_t len = lrec & ((1U << 29) - 1U);
    if (len < sizeof(IRHeader)) return FillZero(t);
    payload->resize(len);
    if (::pread(fd_, payload->data(), len, off + 8) != static_cast<ssize_t>(len))
      return FillZero(t);

    IRHeader ih;
    std::memcpy(&ih, payload->data(), sizeof(IRHeader));
    size_t img_off = sizeof(IRHeader);
    if (ih.flag > 0) {     // label array of `flag` floats follows
      size_t nl = ih.flag;
      if (img_off + nl * 4 > len) return FillZero(t);
      const float* lf = reinterpret_cast<const float*>(payload->data() + img_off);
      for (int i = 0; i < cfg_.label_width && i < static_cast<int>(nl); ++i)
        lab[i] = lf[i];
      img_off += nl * 4;
    } else {
      lab[0] = ih.label;
    }

    const uint8_t* jp = payload->data() + img_off;
    size_t jn = len - img_off;
    int denom = 1;
    int ph = 0, pw = 0;
    int target = cfg_.resize_short > 0 ? cfg_.resize_short : std::max(cfg_.h, cfg_.w);
    if (!JpegPeekDims(jp, jn, &ph, &pw)) return FillZero(t);
    int short_side = std::min(ph, pw);
    if (short_side >= 8 * target) denom = 8;
    else if (short_side >= 4 * target) denom = 4;
    else if (short_side >= 2 * target) denom = 2;
    int rows, cols, ch;
    if (!mxhost::JpegDecode(jp, jn, denom, 3, img, &rows, &cols, &ch).empty())
      return FillZero(t);

    // resize_short -> grow to fit -> crop (rand/center) -> mirror, the
    // order of image.CreateAugmenter
    if (cfg_.resize_short > 0) {
      int nw, nh;
      if (rows > cols) { nw = cfg_.resize_short; nh = cfg_.resize_short * rows / cols; }
      else { nh = cfg_.resize_short; nw = cfg_.resize_short * cols / rows; }
      if (nw != cols || nh != rows) {
        ResizeLinear(*img, rows, cols, scratch, nh, nw);
        img->swap(*scratch);
        rows = nh;
        cols = nw;
      }
    }
    if (rows < cfg_.h || cols < cfg_.w) {
      int nh = std::max(rows, cfg_.h), nw = std::max(cols, cfg_.w);
      ResizeLinear(*img, rows, cols, scratch, nh, nw);
      img->swap(*scratch);
      rows = nh;
      cols = nw;
    }
    int x0, y0;
    if (cfg_.rand_crop) {
      x0 = (*rng)() % (cols - cfg_.w + 1);
      y0 = (*rng)() % (rows - cfg_.h + 1);
    } else {
      x0 = (cols - cfg_.w) / 2;
      y0 = (rows - cfg_.h) / 2;
    }
    bool mirror = cfg_.rand_mirror && ((*rng)() & 1);

    size_t plane = static_cast<size_t>(cfg_.h) * cfg_.w;
    if (cfg_.out_uint8) {
      uint8_t* out = static_cast<uint8_t*>(s.data) +
                     static_cast<size_t>(t.pos) * cfg_.c * plane;
      for (int y = 0; y < cfg_.h; ++y) {
        const uint8_t* row = img->data() + (static_cast<size_t>(y0 + y) * cols + x0) * 3;
        uint8_t* orow = out + static_cast<size_t>(y) * cfg_.w * cfg_.c;
        if (!mirror) {
          std::memcpy(orow, row, static_cast<size_t>(cfg_.w) * 3);
        } else {
          for (int x = 0; x < cfg_.w; ++x) {
            const uint8_t* px = row + 3 * (cfg_.w - 1 - x);
            orow[3 * x + 0] = px[0];
            orow[3 * x + 1] = px[1];
            orow[3 * x + 2] = px[2];
          }
        }
      }
    } else {
      float* out = static_cast<float*>(s.data) +
                   static_cast<size_t>(t.pos) * cfg_.c * plane;
      float inv_std[3] = {1.f / cfg_.stdv[0], 1.f / cfg_.stdv[1], 1.f / cfg_.stdv[2]};
      for (int y = 0; y < cfg_.h; ++y) {
        const uint8_t* row = img->data() + (static_cast<size_t>(y0 + y) * cols + x0) * 3;
        for (int x = 0; x < cfg_.w; ++x) {
          int sx = mirror ? (cfg_.w - 1 - x) : x;
          const uint8_t* px = row + 3 * sx;
          size_t o = static_cast<size_t>(y) * cfg_.w + x;
          out[0 * plane + o] = (px[0] - cfg_.mean[0]) * inv_std[0];
          out[1 * plane + o] = (px[1] - cfg_.mean[1]) * inv_std[1];
          out[2 * plane + o] = (px[2] - cfg_.mean[2]) * inv_std[2];
        }
      }
    }
    return true;
  }

  bool FillZero(const Task& t) {
    Slot& s = slots_[t.batch_id % slots_.size()];
    size_t pix = static_cast<size_t>(cfg_.c) * cfg_.h * cfg_.w;
    if (cfg_.out_uint8)
      std::memset(static_cast<uint8_t*>(s.data) + t.pos * pix, 0, pix);
    else
      std::memset(static_cast<float*>(s.data) + t.pos * pix, 0, pix * sizeof(float));
    return false;
  }

  Config cfg_;
  int fd_ = -1;
  std::vector<int64_t> offsets_;
  std::vector<int64_t> order_;
  std::vector<Slot> slots_;
  std::deque<Task> tasks_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_task_, cv_ready_;
  bool stop_ = false;
  int inflight_ = 0;
  int in_use_slot_ = -1;
  int64_t schedule_cursor_ = 0, consume_cursor_ = 0;
  int64_t num_batches_ = 0, epoch_ = 0;
  std::atomic<int64_t> decode_failures_{0};
  std::string err_;
};

}  // namespace

extern "C" {

// `slot_data` and `slot_label` hold `prefetch` caller-owned buffers each
// (batch * c * h * w bytes, or floats; batch * label_width floats); they
// must outlive the pipeline.  nullptr if the file cannot be opened or the
// arguments are out of range (c must be 3).
void* imgpipe_create(const char* rec_path, int batch, int c, int h, int w,
                     int threads, int prefetch, int shuffle, uint64_t seed,
                     int part_index, int num_parts, int resize_short,
                     int rand_crop, int rand_mirror, const float* mean,
                     const float* stdv, int out_uint8, int label_width,
                     void** slot_data, float** slot_label) {
  if (c != 3) return nullptr;
  if (batch <= 0 || h <= 0 || w <= 0 || prefetch < 2) return nullptr;
  if (!slot_data || !slot_label) return nullptr;
  Config cfg;
  cfg.batch = batch; cfg.c = c; cfg.h = h; cfg.w = w;
  cfg.threads = threads > 0 ? threads : 1;
  cfg.prefetch = prefetch;
  cfg.shuffle = shuffle; cfg.seed = seed;
  cfg.resize_short = resize_short;
  cfg.rand_crop = rand_crop; cfg.rand_mirror = rand_mirror;
  if (mean) for (int i = 0; i < 3; ++i) cfg.mean[i] = mean[i];
  if (stdv) for (int i = 0; i < 3; ++i) cfg.stdv[i] = stdv[i];
  cfg.out_uint8 = out_uint8;
  cfg.label_width = label_width > 0 ? label_width : 1;
  auto* p = new Pipe(rec_path, cfg, part_index, num_parts, slot_data, slot_label);
  if (p->error()) { delete p; return nullptr; }
  return p;
}

int imgpipe_next(void* h, int* slot) { return static_cast<Pipe*>(h)->Next(slot); }

void imgpipe_reset(void* h) { static_cast<Pipe*>(h)->Reset(); }

int64_t imgpipe_num_batches(void* h) { return static_cast<Pipe*>(h)->num_batches(); }

int64_t imgpipe_decode_failures(void* h) {
  return static_cast<Pipe*>(h)->decode_failures();
}

void imgpipe_destroy(void* h) { delete static_cast<Pipe*>(h); }

}  // extern "C"
