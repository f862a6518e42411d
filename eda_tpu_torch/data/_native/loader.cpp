// Native core of the port's host pipeline (ctypes, a plain C interface).
//
// The port's own copy of eda_tpu/data/_native/loader.cpp, built by
// eda_tpu_torch/data/native.py with g++ on first use:
//
//   * binary little-endian PLY vertex decoding;
//   * Morton (Z-order) keys and a stable LSD radix argsort of them;
//   * a fused scene preparation: the seeded downsample (numpy's legacy
//     RandomState draw, bit for bit), the axis alignment and the Morton sort.
//
// The dataset sorts with numpy (data/presort.py), as the JAX package's does;
// these functions are held to their numpy versions by the tests. All buffers
// are caller-allocated numpy arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Morton keys: 10 bits per axis, interleaved.
// ---------------------------------------------------------------------------
static inline uint32_t spread10(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

void morton_keys(const float* xyz, int64_t n, float cell_size, float origin,
                 int32_t* keys_out) {
  const float inv = 1.0f / cell_size;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t c[3];
    for (int d = 0; d < 3; ++d) {
      float cf = std::floor((xyz[i * 3 + d] - origin) * inv);
      int32_t ci = (int32_t)cf;
      ci = ci < 0 ? 0 : (ci > 1023 ? 1023 : ci);
      c[d] = (uint32_t)ci;
    }
    keys_out[i] =
        (int32_t)(spread10(c[0]) | (spread10(c[1]) << 1) | (spread10(c[2]) << 2));
  }
}

// ---------------------------------------------------------------------------
// Stable LSD radix argsort of uint32 keys (4 passes of 8 bits).
// ---------------------------------------------------------------------------
void radix_argsort_u32(const uint32_t* keys, int64_t n, int32_t* order_out) {
  std::vector<int32_t> idx(n), tmp(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
  std::vector<int64_t> count(257);
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[((keys[idx[i]] >> shift) & 0xFF) + 1];
    for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i)
      tmp[count[(keys[idx[i]] >> shift) & 0xFF]++] = idx[i];
    idx.swap(tmp);
  }
  std::memcpy(order_out, idx.data(), n * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// Binary little-endian PLY vertex block decode.
//
// data points at the first byte after end_header. Properties are described
// by (offsets[i], sizes[i]) byte layouts within a vertex record of
// `stride` bytes; each requested property is widened to float32 (u8/u16/
// i32/f32/f64 supported, selected by sizes/kinds).
// kind: 0 = unsigned int, 1 = signed int, 2 = float.
// ---------------------------------------------------------------------------
void ply_decode_vertices(const uint8_t* data, int64_t count, int64_t stride,
                         const int64_t* offsets, const int64_t* sizes,
                         const int32_t* kinds, int64_t n_props,
                         float* out /* count x n_props */) {
  for (int64_t i = 0; i < count; ++i) {
    const uint8_t* rec = data + i * stride;
    for (int64_t p = 0; p < n_props; ++p) {
      const uint8_t* src = rec + offsets[p];
      float v = 0.0f;
      switch (kinds[p]) {
        case 0:  // unsigned
          switch (sizes[p]) {
            case 1: v = (float)(*src); break;
            case 2: { uint16_t x; std::memcpy(&x, src, 2); v = (float)x; } break;
            case 4: { uint32_t x; std::memcpy(&x, src, 4); v = (float)x; } break;
          }
          break;
        case 1:  // signed
          switch (sizes[p]) {
            case 1: v = (float)(*(const int8_t*)src); break;
            case 2: { int16_t x; std::memcpy(&x, src, 2); v = (float)x; } break;
            case 4: { int32_t x; std::memcpy(&x, src, 4); v = (float)x; } break;
          }
          break;
        default:  // float
          if (sizes[p] == 4) {
            std::memcpy(&v, src, 4);
          } else {
            double d; std::memcpy(&d, src, 8); v = (float)d;
          }
      }
      out[i * n_props + p] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// numpy-legacy random draw: MT19937 (identical init/tempering to numpy's
// RandomState) + rk_interval masked rejection + the legacy Fisher-Yates
// shuffle, so prepare_scene's downsample reproduces
//   np.random.RandomState(seed).choice(n, keep_n, replace=False)
// (= permutation(n)[:keep_n]) bit-for-bit: the seed-1184 draw of the Python
// packing path (data/scannet.py).
// ---------------------------------------------------------------------------
struct NpMt19937 {
  uint32_t mt[624];
  int idx;
  explicit NpMt19937(uint32_t seed) {
    mt[0] = seed;
    for (int i = 1; i < 624; ++i)
      mt[i] = 1812433253u * (mt[i - 1] ^ (mt[i - 1] >> 30)) + (uint32_t)i;
    idx = 624;
  }
  uint32_t next() {
    if (idx >= 624) {
      for (int i = 0; i < 624; ++i) {
        uint32_t y = (mt[i] & 0x80000000u) | (mt[(i + 1) % 624] & 0x7fffffffu);
        mt[i] = mt[(i + 397) % 624] ^ (y >> 1);
        if (y & 1u) mt[i] ^= 2567483615u;
      }
      idx = 0;
    }
    uint32_t y = mt[idx++];
    y ^= y >> 11;
    y ^= (y << 7) & 2636928640u;
    y ^= (y << 15) & 4022730752u;
    y ^= y >> 18;
    return y;
  }
  // uniform in [0, max] via numpy's rk_interval mask rejection
  uint32_t interval(uint32_t max) {
    if (max == 0) return 0;
    uint32_t mask = max;
    mask |= mask >> 1;
    mask |= mask >> 2;
    mask |= mask >> 4;
    mask |= mask >> 8;
    mask |= mask >> 16;
    uint32_t v;
    while ((v = next() & mask) > max) {
    }
    return v;
  }
};

// ---------------------------------------------------------------------------
// Fused scene prep: axis-align (4x4 row-major matrix, may be null),
// numpy-exact seeded downsample to keep_n, morton keys + radix sort.
// Outputs sorted xyz and the chosen source row per output slot (for
// gathering colors/labels).
// ---------------------------------------------------------------------------
void prepare_scene(const float* xyz, int64_t n, const double* align4x4,
                   int64_t keep_n, uint64_t seed, float cell_size,
                   float origin, float* xyz_out /* keep_n x 3 */,
                   int32_t* src_rows /* keep_n */) {
  std::vector<float> pts(keep_n * 3);
  std::vector<int32_t> rows(keep_n);
  NpMt19937 gen((uint32_t)seed);
  if (n >= keep_n) {
    // RandomState.choice(n, keep_n, replace=False) = permutation(n)[:keep_n]
    std::vector<int64_t> perm(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    for (int64_t i = n - 1; i > 0; --i) {
      uint32_t j = gen.interval((uint32_t)i);
      std::swap(perm[i], perm[j]);
    }
    for (int64_t i = 0; i < keep_n; ++i) rows[i] = (int32_t)perm[i];
  } else {
    // replace=True path: randint(0, n) per slot (legacy rk_interval draw)
    for (int64_t i = 0; i < keep_n; ++i)
      rows[i] = (n > 0) ? (int32_t)gen.interval((uint32_t)(n - 1)) : 0;
  }
  for (int64_t i = 0; i < keep_n; ++i) {
    int64_t r = rows[i];
    const float* p = xyz + r * 3;
    if (align4x4) {
      double x = p[0], y = p[1], z = p[2];
      for (int d = 0; d < 3; ++d) {
        pts[i * 3 + d] = (float)(align4x4[d * 4 + 0] * x +
                                 align4x4[d * 4 + 1] * y +
                                 align4x4[d * 4 + 2] * z + align4x4[d * 4 + 3]);
      }
    } else {
      pts[i * 3 + 0] = p[0];
      pts[i * 3 + 1] = p[1];
      pts[i * 3 + 2] = p[2];
    }
  }
  std::vector<int32_t> keys(keep_n);
  morton_keys(pts.data(), keep_n, cell_size, origin, keys.data());
  std::vector<int32_t> order(keep_n);
  radix_argsort_u32((const uint32_t*)keys.data(), keep_n, order.data());
  for (int64_t i = 0; i < keep_n; ++i) {
    const int32_t o = order[i];
    xyz_out[i * 3 + 0] = pts[o * 3 + 0];
    xyz_out[i * 3 + 1] = pts[o * 3 + 1];
    xyz_out[i * 3 + 2] = pts[o * 3 + 2];
    src_rows[i] = rows[o];
  }
}

}  // extern "C"
