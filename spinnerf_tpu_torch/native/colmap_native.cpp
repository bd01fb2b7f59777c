// COLMAP binary-model parser with a plain C interface (the port's copy of
// spinnerf_tpu/native/colmap_native.cpp, which is a CPython extension).
//
// Each model file is parsed twice from the caller's bytes: a `*_count` call
// validates the whole file and returns the record count and the sizes of
// its variable-length parts, then a `*_fill` call writes every column into
// buffers the caller allocated from those sizes. Python loads this library
// with ctypes (spinnerf_tpu_torch/native/build.py) and views the columns as
// numpy arrays (spinnerf_tpu_torch/data/colmap_fast.py).
//
// Every function returns the record count (>= 0) or a negative error:
//   CM_TRUNCATED   the bytes end inside a record
//   CM_BAD_COUNT   the header's count exceeds what the bytes can hold
//   CM_BAD_MODEL   an unknown camera model id
// A fill call repeats the count call's checks, so it never writes past the
// sizes that call reported for the same bytes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t CM_TRUNCATED = -1;
constexpr int64_t CM_BAD_COUNT = -2;
constexpr int64_t CM_BAD_MODEL = -3;

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T get() {
    if (static_cast<size_t>(end - p) < sizeof(T)) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  // copy n bytes to dst (when dst is not null) and advance
  bool take(void* dst, size_t n) {
    if (static_cast<size_t>(end - p) < n) {
      ok = false;
      return false;
    }
    if (dst) std::memcpy(dst, p, n);
    p += n;
    return true;
  }

  // a NUL-terminated name: its length without the NUL, or -1
  int64_t name_length() {
    const void* nul = std::memchr(p, 0, static_cast<size_t>(end - p));
    if (!nul) {
      ok = false;
      return -1;
    }
    return static_cast<const uint8_t*>(nul) - p;
  }

  size_t left() const { return static_cast<size_t>(end - p); }
};

int camera_model_params(int model_id) {
  switch (model_id) {
    case 0: return 3;   // SIMPLE_PINHOLE
    case 1: return 4;   // PINHOLE
    case 2: return 4;   // SIMPLE_RADIAL
    case 3: return 5;   // RADIAL
    case 4: return 8;   // OPENCV
    case 5: return 8;   // OPENCV_FISHEYE
    case 6: return 12;  // FULL_OPENCV
    case 7: return 5;   // FOV
    case 8: return 4;   // SIMPLE_RADIAL_FISHEYE
    case 9: return 5;   // RADIAL_FISHEYE
    case 10: return 12; // THIN_PRISM_FISHEYE
    default: return -1;
  }
}

// cameras.bin: per camera i32 id, i32 model, u64 width, u64 height, then
// the model's f64 parameters. Null outputs parse without writing.
int64_t cameras(const uint8_t* buf, int64_t len, int64_t* n_params,
                int32_t* cam_id, int32_t* model_id, uint64_t* width,
                uint64_t* height, int64_t* param_offsets, double* params) {
  Reader r{buf, buf + len};
  uint64_t n = r.get<uint64_t>();
  if (!r.ok) return CM_TRUNCATED;
  // the smallest record: 2 x i32 + 2 x u64 + 3 f64 parameters
  if (n > static_cast<uint64_t>(len) / 40) return CM_BAD_COUNT;
  int64_t total = 0;
  if (param_offsets) param_offsets[0] = 0;
  for (uint64_t i = 0; i < n; ++i) {
    int32_t id = r.get<int32_t>();
    int32_t model = r.get<int32_t>();
    uint64_t wd = r.get<uint64_t>();
    uint64_t ht = r.get<uint64_t>();
    if (!r.ok) return CM_TRUNCATED;
    int np = camera_model_params(model);
    if (np < 0) return CM_BAD_MODEL;
    if (!r.take(params ? params + total : nullptr, 8 * static_cast<size_t>(np)))
      return CM_TRUNCATED;
    total += np;
    if (cam_id) {
      cam_id[i] = id;
      model_id[i] = model;
      width[i] = wd;
      height[i] = ht;
      param_offsets[i + 1] = total;
    }
  }
  if (n_params) *n_params = total;
  return static_cast<int64_t>(n);
}

// images.bin: per image i32 id, f64 qvec[4], f64 tvec[3], i32 camera id,
// NUL-terminated name, u64 point count, then (f64 x, f64 y, i64 point3D id)
// per 2D point.
int64_t images(const uint8_t* buf, int64_t len, int64_t* n_points,
               int64_t* n_name_bytes, int32_t* img_id, double* qvec,
               double* tvec, int32_t* cam_id, int64_t* name_offsets,
               char* names, int64_t* point_offsets, double* xys,
               int64_t* point3d_ids) {
  Reader r{buf, buf + len};
  uint64_t n = r.get<uint64_t>();
  if (!r.ok) return CM_TRUNCATED;
  // the smallest record: i32 + 32 + 24 + i32 + NUL + u64 = 73 bytes
  if (n > static_cast<uint64_t>(len) / 73) return CM_BAD_COUNT;
  int64_t pts = 0, name_bytes = 0;
  if (name_offsets) {
    name_offsets[0] = 0;
    point_offsets[0] = 0;
  }
  for (uint64_t i = 0; i < n; ++i) {
    int32_t id = r.get<int32_t>();
    if (!r.take(qvec ? qvec + 4 * i : nullptr, 32)) return CM_TRUNCATED;
    if (!r.take(tvec ? tvec + 3 * i : nullptr, 24)) return CM_TRUNCATED;
    int32_t cam = r.get<int32_t>();
    if (!r.ok) return CM_TRUNCATED;
    int64_t nl = r.name_length();
    if (nl < 0) return CM_TRUNCATED;
    r.take(names ? names + name_bytes : nullptr, static_cast<size_t>(nl));
    r.take(nullptr, 1);  // the NUL
    name_bytes += nl;
    uint64_t np = r.get<uint64_t>();
    if (!r.ok) return CM_TRUNCATED;
    // 24 bytes a 2D point: bound the count by what the bytes can hold
    if (np > r.left() / 24) return CM_TRUNCATED;
    for (uint64_t k = 0; k < np; ++k) {
      double x = r.get<double>();
      double y = r.get<double>();
      int64_t pid = r.get<int64_t>();
      if (xys) {
        xys[2 * (pts + k)] = x;
        xys[2 * (pts + k) + 1] = y;
        point3d_ids[pts + k] = pid;
      }
    }
    pts += static_cast<int64_t>(np);
    if (img_id) {
      img_id[i] = id;
      cam_id[i] = cam;
      name_offsets[i + 1] = name_bytes;
      point_offsets[i + 1] = pts;
    }
  }
  if (n_points) *n_points = pts;
  if (n_name_bytes) *n_name_bytes = name_bytes;
  return static_cast<int64_t>(n);
}

// points3D.bin: per point i64 id, f64 xyz[3], u8 rgb[3], f64 error, u64
// track length, then (i32 image id, i32 2D point index) per track element.
int64_t points(const uint8_t* buf, int64_t len, int64_t* n_track,
               int64_t* ids, double* xyz, uint8_t* rgb, double* error,
               int64_t* track_offsets, int32_t* track) {
  Reader r{buf, buf + len};
  uint64_t n = r.get<uint64_t>();
  if (!r.ok) return CM_TRUNCATED;
  // the smallest record: i64 + 3 f64 + 3 u8 + f64 + u64 = 51 bytes
  if (n > static_cast<uint64_t>(len) / 51) return CM_BAD_COUNT;
  int64_t elems = 0;
  if (track_offsets) track_offsets[0] = 0;
  for (uint64_t i = 0; i < n; ++i) {
    int64_t id = r.get<int64_t>();
    if (!r.take(xyz ? xyz + 3 * i : nullptr, 24)) return CM_TRUNCATED;
    if (!r.take(rgb ? rgb + 3 * i : nullptr, 3)) return CM_TRUNCATED;
    double err = r.get<double>();
    uint64_t tl = r.get<uint64_t>();
    if (!r.ok) return CM_TRUNCATED;
    if (tl > r.left() / 8) return CM_TRUNCATED;
    if (!r.take(track ? track + 2 * elems : nullptr, 8 * tl))
      return CM_TRUNCATED;
    elems += static_cast<int64_t>(tl);
    if (ids) {
      ids[i] = id;
      error[i] = err;
      track_offsets[i + 1] = elems;
    }
  }
  if (n_track) *n_track = elems;
  return static_cast<int64_t>(n);
}

}  // namespace

extern "C" {

int64_t cm_cameras_count(const uint8_t* buf, int64_t len, int64_t* n_params) {
  return cameras(buf, len, n_params, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr);
}

int64_t cm_cameras_fill(const uint8_t* buf, int64_t len, int32_t* cam_id,
                        int32_t* model_id, uint64_t* width, uint64_t* height,
                        int64_t* param_offsets, double* params) {
  return cameras(buf, len, nullptr, cam_id, model_id, width, height,
                 param_offsets, params);
}

int64_t cm_images_count(const uint8_t* buf, int64_t len, int64_t* n_points,
                        int64_t* n_name_bytes) {
  return images(buf, len, n_points, n_name_bytes, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
}

int64_t cm_images_fill(const uint8_t* buf, int64_t len, int32_t* img_id,
                       double* qvec, double* tvec, int32_t* cam_id,
                       int64_t* name_offsets, char* names,
                       int64_t* point_offsets, double* xys,
                       int64_t* point3d_ids) {
  return images(buf, len, nullptr, nullptr, img_id, qvec, tvec, cam_id,
                name_offsets, names, point_offsets, xys, point3d_ids);
}

int64_t cm_points_count(const uint8_t* buf, int64_t len, int64_t* n_track) {
  return points(buf, len, n_track, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr);
}

int64_t cm_points_fill(const uint8_t* buf, int64_t len, int64_t* ids,
                       double* xyz, uint8_t* rgb, double* error,
                       int64_t* track_offsets, int32_t* track) {
  return points(buf, len, nullptr, ids, xyz, rgb, error, track_offsets,
                track);
}

}  // extern "C"
