// Native data loader: grayscale image decoding + threaded prefetch.
//
// A copy of plsvo_tpu/native/loader.cpp. The reference loads frames with
// OpenCV imread on the benchmark thread (app/run_pipeline.cpp:397-407).
// Supports PGM/PPM (P2/P3/P5/P6), 8-bit PNG
// (gray / RGB / RGBA / palette, non-interlaced; zlib inflate) and
// uncompressed 24/32-bit BMP. A background worker decodes frames ahead of
// the consumer so host IO overlaps device compute.
//
// C ABI (ctypes):
//   int  load_gray(const char* path, float* out, int cap, int* w, int* h);
//   void* prefetcher_create(const char** paths, int n, int w, int h, int depth);
//   int  prefetcher_next(void* p, float* out);   // blocks; 0 on end
//   void prefetcher_destroy(void* p);

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

// ---------------------------------------------------------------- PNM ----
int pnm_next_token(const std::vector<uint8_t>& d, size_t& i) {
  // skips whitespace + comments, parses an ASCII int
  while (i < d.size()) {
    if (d[i] == '#') {
      while (i < d.size() && d[i] != '\n') ++i;
    } else if (isspace(d[i])) {
      ++i;
    } else {
      break;
    }
  }
  int v = 0;
  while (i < d.size() && isdigit(d[i])) v = v * 10 + (d[i++] - '0');
  return v;
}

bool decode_pnm(const std::vector<uint8_t>& d, std::vector<float>& out,
                int* w, int* h) {
  if (d.size() < 2 || d[0] != 'P') return false;
  int kind = d[1] - '0';
  if (kind < 2 || kind > 6 || kind == 4) return false;
  size_t i = 2;
  int W = pnm_next_token(d, i);
  int H = pnm_next_token(d, i);
  int maxv = pnm_next_token(d, i);
  if (W <= 0 || H <= 0 || maxv <= 0) return false;
  float scale = 255.0f / maxv;
  out.resize((size_t)W * H);
  int ch = (kind == 3 || kind == 6) ? 3 : 1;
  if (kind == 2 || kind == 3) {  // ascii
    for (size_t p = 0; p < (size_t)W * H; ++p) {
      float acc = 0;
      for (int c = 0; c < ch; ++c) acc += pnm_next_token(d, i);
      out[p] = acc / ch * scale;
    }
  } else {  // binary: one whitespace after maxval
    ++i;
    size_t need = (size_t)W * H * ch * (maxv > 255 ? 2 : 1);
    if (i + need > d.size()) return false;
    const uint8_t* p8 = d.data() + i;
    for (size_t p = 0; p < (size_t)W * H; ++p) {
      float acc = 0;
      for (int c = 0; c < ch; ++c) {
        if (maxv > 255) {
          acc += (p8[0] << 8 | p8[1]);
          p8 += 2;
        } else {
          acc += *p8++;
        }
      }
      out[p] = acc / ch * scale;
    }
  }
  *w = W;
  *h = H;
  return true;
}

// ---------------------------------------------------------------- PNG ----
uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool decode_png(const std::vector<uint8_t>& d, std::vector<float>& out,
                int* w, int* h) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (d.size() < 8 || memcmp(d.data(), magic, 8) != 0) return false;
  size_t i = 8;
  int W = 0, H = 0, depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // rgb triplets
  while (i + 8 <= d.size()) {
    uint32_t len = be32(&d[i]);
    const char* type = reinterpret_cast<const char*>(&d[i + 4]);
    const uint8_t* data = &d[i + 8];
    if (i + 12 + len > d.size()) return false;
    if (!memcmp(type, "IHDR", 4)) {
      W = be32(data);
      H = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
    } else if (!memcmp(type, "PLTE", 4)) {
      palette.assign(data, data + len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    i += 12 + len;
  }
  if (W <= 0 || H <= 0 || depth != 8 || interlace != 0) return false;
  int ch;
  switch (color) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 3: ch = 1; break;  // palette index
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return false;
  }
  size_t stride = (size_t)W * ch;
  std::vector<uint8_t> raw((stride + 1) * H);
  uLongf rawlen = raw.size();
  if (uncompress(raw.data(), &rawlen, idat.data(), idat.size()) != Z_OK)
    return false;

  std::vector<uint8_t> img(stride * H);
  const uint8_t* src = raw.data();
  for (int y = 0; y < H; ++y) {
    uint8_t filter = *src++;
    uint8_t* cur = &img[y * stride];
    const uint8_t* prev = y ? &img[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= (size_t)ch ? cur[x - ch] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= (size_t)ch) ? prev[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      cur[x] = (uint8_t)v;
    }
    src += stride;
  }

  out.resize((size_t)W * H);
  for (size_t p = 0; p < (size_t)W * H; ++p) {
    const uint8_t* px = &img[p * ch];
    float v;
    if (color == 3) {
      if (px[0] * 3 + 2 >= (int)palette.size()) return false;
      const uint8_t* rgb = &palette[px[0] * 3];
      v = 0.299f * rgb[0] + 0.587f * rgb[1] + 0.114f * rgb[2];
    } else if (ch >= 3) {
      v = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
    } else {
      v = px[0];
    }
    out[p] = v;
  }
  *w = W;
  *h = H;
  return true;
}

// ---------------------------------------------------------------- BMP ----
bool decode_bmp(const std::vector<uint8_t>& d, std::vector<float>& out,
                int* w, int* h) {
  if (d.size() < 54 || d[0] != 'B' || d[1] != 'M') return false;
  uint32_t off = d[10] | (d[11] << 8) | (d[12] << 16) | (d[13] << 24);
  int32_t W = d[18] | (d[19] << 8) | (d[20] << 16) | (d[21] << 24);
  int32_t H = d[22] | (d[23] << 8) | (d[24] << 16) | (d[25] << 24);
  uint16_t bpp = d[28] | (d[29] << 8);
  uint32_t comp = d[30] | (d[31] << 8) | (d[32] << 16) | (d[33] << 24);
  if (comp != 0 || (bpp != 8 && bpp != 24 && bpp != 32) || W <= 0) return false;
  bool flip = H > 0;
  int HH = H > 0 ? H : -H;
  int nb = bpp / 8;
  size_t rowsz = ((size_t)W * nb + 3) & ~3u;
  if (off + rowsz * HH > d.size()) return false;
  // 8bpp: palettized (cv2 writes grayscale BMPs this way). Color table of
  // BGRA entries follows the 40-byte info header.
  uint32_t hdrsz = d[14] | (d[15] << 8) | (d[16] << 16) | (d[17] << 24);
  const uint8_t* pal = (bpp == 8) ? &d[14 + hdrsz] : nullptr;
  uint32_t ncolors = (bpp == 8) ? (off - 14 - hdrsz) / 4 : 0;
  out.resize((size_t)W * HH);
  for (int y = 0; y < HH; ++y) {
    const uint8_t* row = &d[off + (size_t)(flip ? HH - 1 - y : y) * rowsz];
    for (int x = 0; x < W; ++x) {
      const uint8_t* px = row + (size_t)x * nb;  // BGR(A) or palette index
      float v;
      if (bpp == 8) {
        uint32_t idx = px[0] < ncolors ? px[0] : 0;
        const uint8_t* c = pal + idx * 4;
        v = 0.114f * c[0] + 0.587f * c[1] + 0.299f * c[2];
      } else {
        v = 0.114f * px[0] + 0.587f * px[1] + 0.299f * px[2];
      }
      out[(size_t)y * W + x] = v;
    }
  }
  *w = W;
  *h = HH;
  return true;
}

bool decode_any(const char* path, std::vector<float>& out, int* w, int* h) {
  std::vector<uint8_t> d;
  if (!read_file(path, d) || d.size() < 8) return false;
  if (d[0] == 'P') return decode_pnm(d, out, w, h);
  if (d[0] == 137) return decode_png(d, out, w, h);
  if (d[0] == 'B' && d[1] == 'M') return decode_bmp(d, out, w, h);
  return false;
}

// ---------------------------------------------------------- Prefetcher ----
struct Prefetcher {
  std::vector<std::string> paths;
  int w = 0, h = 0, depth = 4;
  std::deque<std::vector<float>> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  size_t next_load = 0;
  std::thread worker;

  void run() {
    while (!stop.load()) {
      std::vector<float> img;
      int iw, ih;
      if (next_load >= paths.size()) break;
      bool ok = decode_any(paths[next_load].c_str(), img, &iw, &ih);
      ++next_load;
      if (!ok || iw != w || ih != h) img.assign((size_t)w * h, 0.0f);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < (size_t)depth || stop.load(); });
      if (stop.load()) break;
      queue.push_back(std::move(img));
      cv_pop.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    queue.push_back({});  // sentinel
    cv_pop.notify_one();
  }
};

}  // namespace

extern "C" {

int load_gray(const char* path, float* out, int cap, int* w, int* h) {
  std::vector<float> img;
  if (!decode_any(path, img, w, h)) return 0;
  if ((int)img.size() > cap) return -(int)img.size();
  memcpy(out, img.data(), img.size() * sizeof(float));
  return (int)img.size();
}

void* prefetcher_create(const char** paths, int n, int w, int h, int depth) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n; ++i) p->paths.emplace_back(paths[i]);
  p->w = w;
  p->h = h;
  p->depth = depth > 0 ? depth : 4;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

int prefetcher_next(void* vp, float* out) {
  auto* p = static_cast<Prefetcher*>(vp);
  std::vector<float> img;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_pop.wait(lk, [&] { return !p->queue.empty(); });
    img = std::move(p->queue.front());
    p->queue.pop_front();
    p->cv_push.notify_one();
  }
  if (img.empty()) return 0;
  memcpy(out, img.data(), img.size() * sizeof(float));
  return 1;
}

void prefetcher_destroy(void* vp) {
  auto* p = static_cast<Prefetcher*>(vp);
  p->stop.store(true);
  p->cv_push.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
