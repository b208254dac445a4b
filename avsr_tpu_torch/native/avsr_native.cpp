// avsr_native: host-side native helpers for the data pipeline of the
// PyTorch port (a copy of avsr_tpu/native/avsr_native.cpp, ABI version 3).
//
//   * RIFF/WAV decode (PCM 8/16/24/32 + IEEE float, any channel count)
//   * high-quality polyphase resampling to 16 kHz (windowed-sinc kernel,
//     matching scipy.signal.resample_poly within float tolerance)
//   * multi-threaded batch decode straight into a caller-provided padded
//     [B, S] float32 buffer — no per-sample Python in the loop
//   * shortest-side bilinear resize + centre crop of uint8 frames, and the
//     planar YUV420 packing of the compact host->device link format.
//
// Exposed with a plain C ABI consumed via ctypes (avsr_tpu_torch/native/__init__.py).
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libavsr_native.so avsr_native.cpp -lpthread
// (no -march=native: it is ~10x slower on hosts that trap AVX).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <list>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

struct Wav {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

bool read_wav(const std::string& path, Wav* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char hdr[12];
  if (!f.read(hdr, 12)) return false;
  if (std::memcmp(hdr, "RIFF", 4) != 0 || std::memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;

  uint16_t fmt_tag = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<char> data;
  while (f) {
    char chunk[8];
    if (!f.read(chunk, 8)) break;
    uint32_t size;
    std::memcpy(&size, chunk + 4, 4);
    if (std::memcmp(chunk, "fmt ", 4) == 0) {
      std::vector<char> fmt(size);
      if (!f.read(fmt.data(), size)) return false;
      std::memcpy(&fmt_tag, fmt.data(), 2);
      std::memcpy(&channels, fmt.data() + 2, 2);
      std::memcpy(&rate, fmt.data() + 4, 4);
      std::memcpy(&bits, fmt.data() + 14, 2);
      if (fmt_tag == 0xFFFE && size >= 26)  // extensible
        std::memcpy(&fmt_tag, fmt.data() + 24, 2);
    } else if (std::memcmp(chunk, "data", 4) == 0) {
      data.resize(size);
      if (!f.read(data.data(), size)) return false;
    } else {
      f.seekg(size + (size & 1), std::ios::cur);
    }
    if (fmt_tag && !data.empty()) break;
  }
  if (!fmt_tag || data.empty() || channels == 0) return false;

  size_t frames = 0;
  std::vector<float> mono;
  auto mix = [&](auto get, size_t bytes_per) {
    frames = data.size() / (bytes_per * channels);
    mono.resize(frames);
    for (size_t i = 0; i < frames; ++i) {
      double acc = 0;
      for (int c = 0; c < channels; ++c) acc += get(i * channels + c);
      mono[i] = static_cast<float>(acc / channels);
    }
  };

  const char* d = data.data();
  if (fmt_tag == 1 && bits == 16) {
    mix([&](size_t i) {
      int16_t v; std::memcpy(&v, d + i * 2, 2); return v / 32768.0; }, 2);
  } else if (fmt_tag == 1 && bits == 32) {
    mix([&](size_t i) {
      int32_t v; std::memcpy(&v, d + i * 4, 4); return v / 2147483648.0; }, 4);
  } else if (fmt_tag == 1 && bits == 24) {
    mix([&](size_t i) {
      const unsigned char* p =
          reinterpret_cast<const unsigned char*>(d + i * 3);
      int32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
      if (v & 0x800000) v -= (1 << 24);
      return v / 8388608.0; }, 3);
  } else if (fmt_tag == 1 && bits == 8) {
    mix([&](size_t i) {
      return (static_cast<unsigned char>(d[i]) - 128.0) / 128.0; }, 1);
  } else if (fmt_tag == 3 && bits == 32) {
    mix([&](size_t i) {
      float v; std::memcpy(&v, d + i * 4, 4); return (double)v; }, 4);
  } else {
    return false;
  }
  out->samples = std::move(mono);
  out->sample_rate = static_cast<int>(rate);
  return true;
}

// ---------------------------------------------------------------------------
// Polyphase resampler (windowed sinc, Kaiser-like Hann window)
// ---------------------------------------------------------------------------

uint64_t gcd_u(uint64_t a, uint64_t b) { return b ? gcd_u(b, a % b) : a; }

// Polyphase filter bank: the windowed-sinc tap weights depend only on the
// output phase (t mod up) and the tap index, so they are computed ONCE per
// (up, down) pair — the inner resample loop is then a short float dot
// product per output sample (no transcendentals in the hot path).
struct PolyBank {
  int up = 0, down = 0, taps = 0, center = 0;
  std::vector<float> w;  // [up, taps]
};

const PolyBank& get_bank(int up, int down) {
  // std::list: node storage is stable, so references handed to concurrent
  // decode threads survive later insertions (a std::vector would relocate).
  static std::list<PolyBank> cache;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& b : cache)
    if (b.up == up && b.down == down) return b;

  PolyBank b;
  b.up = up;
  b.down = down;
  const int half = 10 * std::max(up, down);
  const double cutoff = 0.5 / std::max(up, down);
  b.center = half / up + 1;
  b.taps = 2 * b.center + 1;
  b.w.assign(static_cast<size_t>(up) * b.taps, 0.0f);
  for (int p = 0; p < up; ++p) {
    for (int i = 0; i < b.taps; ++i) {
      const double d = static_cast<double>(i - b.center) * up + p;
      if (std::abs(d) > half) continue;
      double wv;
      if (d == 0) {
        wv = 2 * cutoff;
      } else {
        wv = std::sin(2 * kPi * cutoff * d) / (kPi * d);
      }
      const double hann = 0.5 + 0.5 * std::cos(kPi * d / half);
      b.w[static_cast<size_t>(p) * b.taps + i] =
          static_cast<float>(wv * hann * up);
    }
  }
  cache.push_back(std::move(b));
  return cache.back();
}  // NOLINT: reference stability guaranteed by std::list

std::vector<float> resample(const std::vector<float>& x, int sr_in, int sr_out) {
  if (sr_in == sr_out || x.empty()) return x;
  uint64_t g = gcd_u(sr_in, sr_out);
  const int up = static_cast<int>(sr_out / g);
  const int down = static_cast<int>(sr_in / g);
  const PolyBank& bank = get_bank(up, down);

  const int64_t n_in = static_cast<int64_t>(x.size());
  const size_t n_out = (x.size() * static_cast<uint64_t>(up) + down - 1) / down;
  std::vector<float> y(n_out);
  for (size_t m = 0; m < n_out; ++m) {
    const int64_t t = static_cast<int64_t>(m) * down;
    const int64_t q = t / up;
    const int p = static_cast<int>(t % up);
    const float* w = &bank.w[static_cast<size_t>(p) * bank.taps];
    // Contribution of input sample n = q - (i - center): mirror tap order.
    const int64_t n0 = q + bank.center;   // n for i = 0
    float acc = 0.f;
    if (n0 < n_in && q - bank.center >= 0) {
      // fast path: fully interior
      const float* xp = &x[n0];
      for (int i = 0; i < bank.taps; ++i) acc += w[i] * xp[-i];
    } else {
      for (int i = 0; i < bank.taps; ++i) {
        const int64_t n = n0 - i;
        if (n >= 0 && n < n_in) acc += w[i] * x[n];
      }
    }
    y[m] = acc;
  }
  return y;
}

}  // namespace

extern "C" {

// Decode one WAV to mono float32 at target_sr. Returns number of samples
// written (<= max_samples), or -1 on failure. Caller provides `out`.
int64_t avsr_decode_wav(const char* path, int target_sr, float* out,
                        int64_t max_samples) {
  Wav w;
  if (!read_wav(path, &w)) return -1;
  std::vector<float> s = resample(w.samples, w.sample_rate, target_sr);
  const int64_t n = std::min<int64_t>(s.size(), max_samples);
  std::memcpy(out, s.data(), n * sizeof(float));
  return n;
}

// Batch decode into a padded [batch, max_samples] float32 buffer, zeroed
// padding, multi-threaded. paths: array of C strings. lens_out: [batch].
// Returns number of failures (failed rows are zero with len 0).
int avsr_decode_wav_batch(const char** paths, int batch, int target_sr,
                          float* out, int64_t max_samples, int32_t* lens_out,
                          int num_threads) {
  std::atomic<int> failures{0};
  std::atomic<int> next{0};
  if (num_threads <= 0)
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  num_threads = std::min(num_threads, batch);

  auto work = [&]() {
    for (int i = next.fetch_add(1); i < batch; i = next.fetch_add(1)) {
      float* row = out + static_cast<int64_t>(i) * max_samples;
      std::memset(row, 0, max_samples * sizeof(float));
      int64_t n = avsr_decode_wav(paths[i], target_sr, row, max_samples);
      if (n < 0) {
        failures.fetch_add(1);
        lens_out[i] = 0;
      } else {
        lens_out[i] = static_cast<int32_t>(n);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(work);
  for (auto& th : threads) th.join();
  return failures.load();
}

// Shortest-side bilinear resize + center crop for a clip of video frames:
// u8 [T, H, W, 3] -> u8 [T, S, S, 3], multi-threaded over frames. Replaces
// the per-frame Python/cv2 loop in the dataset (the reference's data-side
// hot loop, simple_dataset.py:213-249). Half-pixel-center sampling matches
// cv2.INTER_LINEAR geometry.
void avsr_resize_crop_frames(const uint8_t* in, int t, int h, int w,
                             uint8_t* out, int s, int num_threads) {
  // shortest-side resize target
  int nh, nw;
  if (h <= w) {
    nh = s;
    nw = std::max(s, (int)std::lround((double)w * s / h));
  } else {
    nw = s;
    nh = std::max(s, (int)std::lround((double)h * s / w));
  }
  const int top = (nh - s) / 2, left = (nw - s) / 2;
  const double sy = (double)h / nh, sx = (double)w / nw;

  // Precompute fixed-point (8.8) taps for the cropped output grid.
  std::vector<int> x0(s), x1(s), wx1(s);
  for (int ox = 0; ox < s; ++ox) {
    double src = (ox + left + 0.5) * sx - 0.5;
    src = std::max(0.0, std::min(src, (double)w - 1));
    int xi = (int)src;
    x0[ox] = xi * 3;
    x1[ox] = std::min(xi + 1, w - 1) * 3;
    wx1[ox] = (int)std::lround((src - xi) * 256.0);
  }
  std::vector<int> y0(s), y1(s), wy1(s);
  for (int oy = 0; oy < s; ++oy) {
    double src = (oy + top + 0.5) * sy - 0.5;
    src = std::max(0.0, std::min(src, (double)h - 1));
    int yi = (int)src;
    y0[oy] = yi;
    y1[oy] = std::min(yi + 1, h - 1);
    wy1[oy] = (int)std::lround((src - yi) * 256.0);
  }

  std::atomic<int> next{0};
  if (num_threads <= 0)
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  num_threads = std::min(num_threads, t);

  auto work = [&]() {
    for (int i = next.fetch_add(1); i < t; i = next.fetch_add(1)) {
      const uint8_t* src = in + (int64_t)i * h * w * 3;
      uint8_t* dst = out + (int64_t)i * s * s * 3;
      for (int oy = 0; oy < s; ++oy) {
        const uint8_t* r0 = src + (int64_t)y0[oy] * w * 3;
        const uint8_t* r1 = src + (int64_t)y1[oy] * w * 3;
        const int v1 = wy1[oy], v0 = 256 - v1;
        uint8_t* orow = dst + (int64_t)oy * s * 3;
        for (int ox = 0; ox < s; ++ox) {
          const int u1 = wx1[ox], u0 = 256 - u1;
          const int a = x0[ox], b = x1[ox];
          for (int c = 0; c < 3; ++c) {
            // (8.8 x 8.8 -> 16.16 fixed point, round at the end)
            const int top_v = u0 * r0[a + c] + u1 * r0[b + c];
            const int bot_v = u0 * r1[a + c] + u1 * r1[b + c];
            orow[ox * 3 + c] =
                (uint8_t)((v0 * top_v + v1 * bot_v + 32768) >> 16);
          }
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int th = 0; th < num_threads; ++th) threads.emplace_back(work);
  for (auto& th : threads) th.join();
}

// Planar YUV420 packing for the host->device link: u8 [T, S, S, 3] RGB ->
// Y u8 [T, S, S] + interleaved UV u8 [T, S/2, S/2, 2]. 1.5 bytes/px instead
// of 3 — the chroma subsampling every consumer video codec already applies,
// so for codec-sourced frames this is lossless w.r.t. the decoded stream.
// Full-range BT.601 ("JPEG") matrix in 16.16 fixed point; chroma from the
// 2x2 box-summed RGB (conversion is linear, so sum-then-convert == average
// of per-pixel chroma). S must be even. Threaded over frames.
void avsr_rgb_to_yuv420(const uint8_t* in, int t, int s, uint8_t* y_out,
                        uint8_t* uv_out, int num_threads) {
  const int hs = s / 2;
  std::atomic<int> next{0};
  if (num_threads <= 0)
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  num_threads = std::min(num_threads, t);

  auto work = [&]() {
    for (int i = next.fetch_add(1); i < t; i = next.fetch_add(1)) {
      const uint8_t* src = in + (int64_t)i * s * s * 3;
      uint8_t* yp = y_out + (int64_t)i * s * s;
      uint8_t* uvp = uv_out + (int64_t)i * hs * hs * 2;
      for (int by = 0; by < hs; ++by) {
        const uint8_t* r0 = src + (int64_t)(2 * by) * s * 3;
        const uint8_t* r1 = r0 + (int64_t)s * 3;
        uint8_t* y0 = yp + (int64_t)(2 * by) * s;
        uint8_t* y1 = y0 + s;
        uint8_t* uvrow = uvp + (int64_t)by * hs * 2;
        for (int bx = 0; bx < hs; ++bx) {
          const int a = 6 * bx, b = a + 3;
          // luma per pixel (Y = .299R + .587G + .114B, 16.16 fixed point)
          int rs = 0, gs = 0, bs = 0;
          auto luma = [&](const uint8_t* p) {
            rs += p[0]; gs += p[1]; bs += p[2];
            return (uint8_t)((19595 * p[0] + 38470 * p[1] + 7471 * p[2] +
                              32768) >> 16);
          };
          y0[2 * bx] = luma(r0 + a);
          y0[2 * bx + 1] = luma(r0 + b);
          y1[2 * bx] = luma(r1 + a);
          y1[2 * bx + 1] = luma(r1 + b);
          // chroma from the 2x2 RGB sums (>>18 = /65536/4), offset 128
          int u = (32768 * bs - 11059 * rs - 21710 * gs + (128 << 18) +
                   (1 << 17)) >> 18;
          int v = (32768 * rs - 27439 * gs - 5329 * bs + (128 << 18) +
                   (1 << 17)) >> 18;
          uvrow[2 * bx] = (uint8_t)std::min(255, std::max(0, u));
          uvrow[2 * bx + 1] = (uint8_t)std::min(255, std::max(0, v));
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int th = 0; th < num_threads; ++th) threads.emplace_back(work);
  for (auto& th : threads) th.join();
}

// Version marker for the ctypes loader.
int avsr_native_abi_version() { return 3; }

}  // extern "C"
