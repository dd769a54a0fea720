// Native host-side I/O runtime for fovvideovdp_tpu_torch (a copy of the
// JAX package's fvvdp_io.cpp, built by native/__init__.py with g++).
//
//  * yuv_reader: raw planar YUV file access with a background prefetch
//    thread and a ring of frame buffers, so disk/page-cache reads overlap
//    the card's work.  Blocks are written into a caller-given buffer, a
//    pinned staging buffer in the file sources, so no host copy follows
//    the reader's own.
//  * frame block assembly: gathers arbitrary frame indices into one
//    contiguous buffer ready for a single host->device transfer.
//  * pipe_reader: a prefetching drain for the ffmpeg rawvideo pipe — a
//    background thread reads frames off the decoder's stdout into a ring of
//    host buffers, so ffmpeg keeps decoding ahead while the card scores the
//    previous block (a kernel pipe holds ~64 KB, a fraction of one frame, so
//    without this the decoder stalls whenever the consumer is busy).
//  * fixed-point unpack helpers (limited-range YUV -> float) for host-side
//    checks.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 dependency).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if !defined(_WIN32)
#include <cerrno>
#include <unistd.h>
#endif

namespace {

struct YuvFormat {
  int width = 0;
  int height = 0;
  int bit_depth = 8;
  int chroma_ss = 420;  // 420 or 444
  size_t bytes_per_sample() const { return bit_depth > 8 ? 2 : 1; }
  size_t y_samples() const { return (size_t)width * height; }
  size_t uv_samples() const {
    return chroma_ss == 420 ? y_samples() / 4 : y_samples();
  }
  size_t frame_samples() const { return y_samples() + 2 * uv_samples(); }
  size_t frame_bytes() const { return frame_samples() * bytes_per_sample(); }
};

struct Slot {
  std::vector<uint8_t> data;
  long frame = -1;
  bool ready = false;
};

struct YuvReader {
  FILE* f = nullptr;  // owns the handle (fclose); POSIX reads go through fd
  int fd = -1;
  YuvFormat fmt;
  long n_frames = 0;

  // prefetch ring
  std::vector<Slot> ring;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  std::atomic<bool> stop{false};
  long next_prefetch = 0;   // next frame the worker should read
  int ring_size = 4;
  std::mutex read_mu;  // non-POSIX only: serialize the shared file position

  ~YuvReader() {
    stop.store(true);
    cv.notify_all();
    if (worker.joinable()) worker.join();
    if (f) fclose(f);
  }

  // Called concurrently by the prefetch worker and fetch(); must not share
  // a file position between threads (an interleaved seek would silently
  // deliver the wrong frame's bytes).  POSIX pread carries its own offset;
  // elsewhere a mutex serializes seek+read.
  bool read_frame_at(long idx, uint8_t* dst) {
    if (idx < 0 || idx >= n_frames) return false;
    const size_t fb = fmt.frame_bytes();
#if defined(_WIN32)
    std::lock_guard<std::mutex> lk(read_mu);
    _fseeki64(f, (long long)idx * fb, SEEK_SET);
    return fread(dst, 1, fb, f) == fb;
#else
    size_t got = 0;
    while (got < fb) {
      ssize_t n = ::pread(fd, dst + got, fb - got,
                          (off_t)((size_t)idx * fb + got));
      if (n == 0) return false;
      if (n < 0) {
        if (errno == EINTR) continue;
        return false;
      }
      got += (size_t)n;
    }
    return true;
#endif
  }

  void worker_loop() {
    std::unique_lock<std::mutex> lk(mu);
    while (!stop.load()) {
      // find a free slot and the next frame to prefetch
      Slot* free_slot = nullptr;
      for (auto& s : ring) {
        if (!s.ready && s.frame < 0) { free_slot = &s; break; }
      }
      if (free_slot == nullptr || next_prefetch >= n_frames) {
        cv.wait(lk);
        continue;
      }
      long idx = next_prefetch++;
      free_slot->frame = idx;
      lk.unlock();
      bool ok = read_frame_at(idx, free_slot->data.data());
      lk.lock();
      free_slot->ready = ok;
      if (!ok) free_slot->frame = -1;
      cv.notify_all();
    }
  }

  // Sequential fetch with read-ahead; falls back to direct read for random
  // access (circular/pingpong padding).
  bool fetch(long idx, uint8_t* dst) {
    std::unique_lock<std::mutex> lk(mu);
    for (auto& s : ring) {
      if (s.frame == idx && s.ready) {
        memcpy(dst, s.data.data(), fmt.frame_bytes());
        s.frame = -1;
        s.ready = false;
        cv.notify_all();
        return true;
      }
    }
    // not prefetched (random access or first use): read directly and steer
    // the prefetcher to follow this position
    if (idx + 1 > next_prefetch || idx + (long)ring.size() < next_prefetch) {
      next_prefetch = idx + 1;
      for (auto& s : ring) {             // drop stale prefetches
        if (s.ready && (s.frame < idx || s.frame > idx + ring_size)) {
          s.frame = -1;
          s.ready = false;
        }
      }
      cv.notify_all();
    }
    lk.unlock();
    return read_frame_at(idx, dst);
  }
};

#if !defined(_WIN32)

// Prefetching drain for a rawvideo pipe (ffmpeg stdout).  A background
// thread reads whole frames into a ring of `ring_frames` buffers; the
// consumer copies them out in order.  Single producer, single consumer.
struct PipeReader {
  int fd = -1;
  size_t frame_bytes = 0;
  long ring_frames = 0;
  std::vector<uint8_t> buf;  // ring_frames * frame_bytes
  std::mutex mu;
  std::condition_variable cv_space;  // producer waits for a free slot
  std::condition_variable cv_data;   // consumer waits for a filled slot
  long head = 0;  // frames produced
  long tail = 0;  // frames consumed
  bool eof = false;
  std::atomic<bool> stop{false};
  std::thread worker;

  ~PipeReader() {
    stop.store(true);
    cv_space.notify_all();
    cv_data.notify_all();
    if (worker.joinable()) worker.join();
  }

  bool read_full_frame(uint8_t* dst) {
    size_t got = 0;
    while (got < frame_bytes) {
      ssize_t n = ::read(fd, dst + got, frame_bytes - got);
      if (n == 0) return false;  // EOF (a partial trailing frame is dropped)
      if (n < 0) {
        if (errno == EINTR) continue;
        return false;
      }
      got += (size_t)n;
    }
    return true;
  }

  void worker_loop() {
    for (;;) {
      long slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || head - tail < ring_frames;
        });
        if (stop.load()) return;
        slot = head % ring_frames;
      }
      bool ok = read_full_frame(&buf[(size_t)slot * frame_bytes]);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) {
          eof = true;
          cv_data.notify_all();
          return;
        }
        ++head;
      }
      cv_data.notify_all();
    }
  }

  // Copy up to `count` frames into `dst`; blocks until they are available.
  // Returns the number delivered (< count only at end of stream).
  long read_block(long count, uint8_t* dst) {
    long done = 0;
    while (done < count) {
      long take;
      long start_tail;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_data.wait(lk, [&] { return head > tail || eof || stop.load(); });
        if (head == tail) break;  // drained and EOF/stopped
        take = std::min(count - done, head - tail);
        start_tail = tail;
      }
      for (long i = 0; i < take; ++i) {
        long slot = (start_tail + i) % ring_frames;
        memcpy(dst + (size_t)(done + i) * frame_bytes,
               &buf[(size_t)slot * frame_bytes], frame_bytes);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        tail += take;
      }
      cv_space.notify_all();
      done += take;
    }
    return done;
  }
};

#endif  // !_WIN32

}  // namespace

extern "C" {

void* fvvdp_yuv_open(const char* path, int width, int height, int bit_depth,
                     int chroma_ss, int ring_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new YuvReader();
  r->f = f;
#if !defined(_WIN32)
  r->fd = fileno(f);
#endif
  r->fmt = YuvFormat{width, height, bit_depth, chroma_ss};
#if defined(_WIN32)
  _fseeki64(f, 0, SEEK_END);
  long long sz = _ftelli64(f);
#else
  fseeko(f, 0, SEEK_END);
  off_t sz = ftello(f);
#endif
  r->n_frames = (long)(sz / r->fmt.frame_bytes());
  r->ring_size = ring_size > 0 ? ring_size : 4;
  r->ring.resize(r->ring_size);
  for (auto& s : r->ring) s.data.resize(r->fmt.frame_bytes());
  r->worker = std::thread([r] { r->worker_loop(); });
  return r;
}

long fvvdp_yuv_frame_count(void* handle) {
  return handle ? static_cast<YuvReader*>(handle)->n_frames : -1;
}

// Read `count` frames starting at `start` into a contiguous buffer of
// count * frame_bytes. Returns frames read.
long fvvdp_yuv_read_block(void* handle, long start, long count, uint8_t* dst) {
  if (!handle) return 0;
  auto* r = static_cast<YuvReader*>(handle);
  size_t fb = r->fmt.frame_bytes();
  long done = 0;
  for (long i = 0; i < count; ++i) {
    if (!r->fetch(start + i, dst + (size_t)i * fb)) break;
    ++done;
  }
  return done;
}

// Gather arbitrary frame indices into a contiguous buffer.
long fvvdp_yuv_read_indices(void* handle, const long* indices, long count,
                            uint8_t* dst) {
  if (!handle) return 0;
  auto* r = static_cast<YuvReader*>(handle);
  size_t fb = r->fmt.frame_bytes();
  long done = 0;
  for (long i = 0; i < count; ++i) {
    if (!r->fetch(indices[i], dst + (size_t)i * fb)) break;
    ++done;
  }
  return done;
}

void fvvdp_yuv_close(void* handle) {
  delete static_cast<YuvReader*>(handle);
}

#if !defined(_WIN32)

// Start draining frames of `frame_bytes` from file descriptor `fd` into a
// ring of `ring_frames` host buffers.  The fd stays owned by the caller (the
// subprocess pipe); the reader only read()s from it.
void* fvvdp_pipe_open(int fd, long frame_bytes, long ring_frames) {
  if (fd < 0 || frame_bytes <= 0 || ring_frames <= 0) return nullptr;
  auto* r = new PipeReader();
  r->fd = fd;
  r->frame_bytes = (size_t)frame_bytes;
  r->ring_frames = ring_frames;
  r->buf.resize((size_t)ring_frames * (size_t)frame_bytes);
  r->worker = std::thread([r] { r->worker_loop(); });
  return r;
}

long fvvdp_pipe_read_block(void* handle, long count, uint8_t* dst) {
  if (!handle) return 0;
  return static_cast<PipeReader*>(handle)->read_block(count, dst);
}

void fvvdp_pipe_close(void* handle) {
  delete static_cast<PipeReader*>(handle);
}

#endif  // !_WIN32

// Limited-range fixed-point -> float unpack (video_source_yuv.py:205-218):
// luma:   clip(v / (2^(bd-8) * 219) - 16/219, 0, 1)
// chroma: clip(v / (2^(bd-8) * 224) - 128/224, -0.5, 0.5)
static inline void unpack_plane(const void* src, float* dst, size_t n,
                                int bit_depth, int is_chroma) {
  const float scale = 1.0f / ((float)(1 << (bit_depth - 8)) *
                              (is_chroma ? 224.0f : 219.0f));
  const float offset = is_chroma ? 128.0f / 224.0f : 16.0f / 219.0f;
  const float lo = is_chroma ? -0.5f : 0.0f;
  const float hi = is_chroma ? 0.5f : 1.0f;
  if (bit_depth > 8) {
    const uint16_t* s = static_cast<const uint16_t*>(src);
    for (size_t i = 0; i < n; ++i) {
      float v = (float)s[i] * scale - offset;
      dst[i] = v < lo ? lo : (v > hi ? hi : v);
    }
  } else {
    const uint8_t* s = static_cast<const uint8_t*>(src);
    for (size_t i = 0; i < n; ++i) {
      float v = (float)s[i] * scale - offset;
      dst[i] = v < lo ? lo : (v > hi ? hi : v);
    }
  }
}

void fvvdp_unpack_yuv_frame(const uint8_t* frame, float* y_out, float* u_out,
                            float* v_out, int width, int height, int bit_depth,
                            int chroma_ss) {
  YuvFormat fmt{width, height, bit_depth, chroma_ss};
  size_t bps = fmt.bytes_per_sample();
  const uint8_t* y = frame;
  const uint8_t* u = y + fmt.y_samples() * bps;
  const uint8_t* v = u + fmt.uv_samples() * bps;
  unpack_plane(y, y_out, fmt.y_samples(), bit_depth, 0);
  unpack_plane(u, u_out, fmt.uv_samples(), bit_depth, 1);
  unpack_plane(v, v_out, fmt.uv_samples(), bit_depth, 1);
}

}  // extern "C"
