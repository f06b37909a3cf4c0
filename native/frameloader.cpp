// Native frame loader: threaded video decode into a preallocated ring.
//
// Native equivalent of the reference's IO layer hot path
// (SURVEY.md §2.1 #8): the reference decoded frames synchronously inside
// the Python driver loop; here a C++ worker thread decodes ahead into a
// bounded ring of reusable BGR buffers so host decode overlaps device
// compute (SURVEY.md §7 "host decode throughput": decouple via prefetch
// thread + pinned buffers).  Exposed through a C ABI for ctypes — no
// Python-extension build step needed.
//
// Build: see native/Makefile (g++ -O3 -shared against system OpenCV 4.x).

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/videoio.hpp>

namespace {

struct Ring {
    std::vector<std::vector<uint8_t>> slots;
    std::vector<bool> full;
    size_t head = 0;  // next slot the consumer reads
    size_t tail = 0;  // next slot the producer writes
    size_t count = 0;
    std::mutex mu;
    std::condition_variable cv_space, cv_data;
    bool done = false;
};

struct Loader {
    cv::VideoCapture cap;
    int width = 0, height = 0, channels = 3;
    int64_t num_frames = 0;
    double fps = 0.0;
    size_t frame_bytes = 0;
    Ring ring;
    std::thread worker;
    bool error = false;

    // gray mode: convert on the decode thread with cv2's exact fixed-point
    // BT.601 (15-bit) BGR->gray so the device sees bit-identical u8
    // intensities to ops/color.grayscale_u8 — and the host->device
    // transfer moves 1/3 of the bytes (the H2D link, not decode, is the
    // end-to-end bottleneck on relay-attached hosts: measured 137 ms vs
    // 12.7 ms per 1080p frame).
    static inline void bgr_to_gray_row(const uint8_t* src, uint8_t* dst,
                                       int n) {
        for (int x = 0; x < n; ++x) {
            const int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
            dst[x] = static_cast<uint8_t>(
                (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15);
        }
    }

    void decode_loop() {
        cv::Mat frame;
        for (;;) {
            if (!cap.read(frame)) break;
            // never trust the container header: a stream that changes
            // resolution mid-file (or misreports CAP_PROP_FRAME_*) would
            // make the row copies below read past the decoded Mat
            if (frame.rows != height || frame.cols != width ||
                frame.channels() != 3 || frame.depth() != CV_8U) {
                std::lock_guard<std::mutex> lk(ring.mu);
                error = true;
                ring.done = true;
                ring.cv_data.notify_all();
                return;
            }
            std::unique_lock<std::mutex> lk(ring.mu);
            ring.cv_space.wait(lk, [&] {
                return ring.count < ring.slots.size() || ring.done;
            });
            if (ring.done) return;
            auto& slot = ring.slots[ring.tail];
            if (channels == 1) {
                for (int y = 0; y < height; ++y)
                    bgr_to_gray_row(frame.ptr(y),
                                    slot.data() +
                                        static_cast<size_t>(y) * width,
                                    width);
            } else if (frame.isContinuous() &&
                       frame.total() * frame.elemSize() == frame_bytes) {
                std::memcpy(slot.data(), frame.data, frame_bytes);
            } else {
                size_t row = static_cast<size_t>(width) * channels;
                for (int y = 0; y < height; ++y)
                    std::memcpy(slot.data() + y * row, frame.ptr(y), row);
            }
            ring.full[ring.tail] = true;
            ring.tail = (ring.tail + 1) % ring.slots.size();
            ++ring.count;
            ring.cv_data.notify_one();
        }
        std::lock_guard<std::mutex> lk(ring.mu);
        ring.done = true;
        ring.cv_data.notify_all();
    }
};

}  // namespace

extern "C" {

void* fl_open2(const char* path, int ring_capacity, int gray) {
    auto* L = new Loader();
    if (!L->cap.open(path)) {
        delete L;
        return nullptr;
    }
    L->channels = gray ? 1 : 3;
    L->width = static_cast<int>(L->cap.get(cv::CAP_PROP_FRAME_WIDTH));
    L->height = static_cast<int>(L->cap.get(cv::CAP_PROP_FRAME_HEIGHT));
    L->num_frames = static_cast<int64_t>(L->cap.get(cv::CAP_PROP_FRAME_COUNT));
    L->fps = L->cap.get(cv::CAP_PROP_FPS);
    L->frame_bytes =
        static_cast<size_t>(L->width) * L->height * L->channels;
    if (ring_capacity < 2) ring_capacity = 2;
    L->ring.slots.resize(ring_capacity);
    L->ring.full.assign(ring_capacity, false);
    for (auto& s : L->ring.slots) s.resize(L->frame_bytes);
    L->worker = std::thread(&Loader::decode_loop, L);
    return L;
}

void* fl_open(const char* path, int ring_capacity) {
    return fl_open2(path, ring_capacity, 0);
}

void fl_info(void* h, int* w, int* ht, int64_t* n, double* fps) {
    auto* L = static_cast<Loader*>(h);
    *w = L->width;
    *ht = L->height;
    *n = L->num_frames;
    *fps = L->fps;
}

// Copies the next frame (BGR, HxWx3 uint8) into out. Returns 1 on success,
// 0 on end of stream.
int fl_next(void* h, uint8_t* out) {
    auto* L = static_cast<Loader*>(h);
    std::unique_lock<std::mutex> lk(L->ring.mu);
    L->ring.cv_data.wait(lk, [&] {
        return L->ring.count > 0 || L->ring.done;
    });
    if (L->ring.count == 0) return 0;
    std::memcpy(out, L->ring.slots[L->ring.head].data(), L->frame_bytes);
    L->ring.full[L->ring.head] = false;
    L->ring.head = (L->ring.head + 1) % L->ring.slots.size();
    --L->ring.count;
    L->ring.cv_space.notify_one();
    return 1;
}

// 1 if the decode thread hit an error (e.g. a frame whose decoded
// dimensions disagree with the container header) — lets the Python side
// distinguish a truncated stream from a clean end-of-stream.
int fl_error(void* h) {
    auto* L = static_cast<Loader*>(h);
    std::lock_guard<std::mutex> lk(L->ring.mu);
    return L->error ? 1 : 0;
}

void fl_close(void* h) {
    auto* L = static_cast<Loader*>(h);
    {
        std::lock_guard<std::mutex> lk(L->ring.mu);
        L->ring.done = true;
    }
    L->ring.cv_space.notify_all();
    L->ring.cv_data.notify_all();
    if (L->worker.joinable()) L->worker.join();
    delete L;
}

}  // extern "C"
