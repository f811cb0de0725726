// Host-side filters of funny_lidar_slam_torch: the port's copy of the JAX
// package's native/flp_native.cpp (the two entry points the port calls).
//
// The reference runs its host pipeline in C++ (PreProcessing's range/jump
// filter loops, src/slam/preprocessing.cpp:181-225; pcl::VoxelGrid map
// filtering). The same code here gives the port the JAX package's results
// bit for bit: range/jump filtering with padding into fixed-capacity
// buffers, and the voxel-grid centroid filter of the map products, the
// loop-closure submap merge and the localization map load.
//
// Plain C ABI for ctypes; `native/__init__.py` builds it with g++ at first
// use into build/host/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

extern "C" {

// Range filter + jump-span subsample + pad into fixed-capacity buffers.
// Returns the number of valid points written (<= capacity). out_pts is
// [capacity*3] and zero-padded; out_rel [capacity]; out_mask [capacity].
int64_t flp_filter_pad(const float* pts, const float* rel, int64_t n,
                       float min_r, float max_r, int64_t jump,
                       int64_t capacity, float* out_pts, float* out_rel,
                       uint8_t* out_mask) {
    if (jump < 1) jump = 1;
    const float min2 = min_r * min_r, max2 = max_r * max_r;
    int64_t w = 0, kept = 0;
    for (int64_t i = 0; i < n && w < capacity; ++i) {
        const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
        const float r2 = x * x + y * y + z * z;
        if (r2 < min2 || r2 > max2) continue;
        if (kept++ % jump != 0) continue;
        out_pts[3 * w] = x;
        out_pts[3 * w + 1] = y;
        out_pts[3 * w + 2] = z;
        out_rel[w] = rel ? rel[i] : 0.0f;
        out_mask[w] = 1;
        ++w;
    }
    for (int64_t i = w; i < capacity; ++i) {
        out_pts[3 * i] = out_pts[3 * i + 1] = out_pts[3 * i + 2] = 0.0f;
        out_rel[i] = 0.0f;
        out_mask[i] = 0;
    }
    return w;
}

struct Key3 {
    int32_t x, y, z;
    bool operator==(const Key3& o) const { return x == o.x && y == o.y && z == o.z; }
};
struct Key3Hash {
    // same large-prime XOR scheme as the device hash
    // (include/common/hash_function.h:10-15)
    size_t operator()(const Key3& k) const {
        return (static_cast<size_t>(static_cast<uint32_t>(k.x)) * 73856093u) ^
               (static_cast<size_t>(static_cast<uint32_t>(k.y)) * 471943u) ^
               (static_cast<size_t>(static_cast<uint32_t>(k.z)) * 83492791u);
    }
};

struct Accum { double sx, sy, sz; int64_t n; };

// Voxel-grid centroid downsample (pcl::VoxelGrid semantics). Returns number
// of voxels written into out (capped at cap).
int64_t flp_voxel_downsample(const float* pts, int64_t n, float voxel,
                             int64_t cap, float* out) {
    if (voxel <= 0.0f || n == 0) {
        int64_t m = n < cap ? n : cap;
        std::memcpy(out, pts, static_cast<size_t>(m) * 3 * sizeof(float));
        return m;
    }
    const float inv = 1.0f / voxel;
    std::unordered_map<Key3, Accum, Key3Hash> grid;
    grid.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
        Key3 k{static_cast<int32_t>(std::floor(x * inv)),
               static_cast<int32_t>(std::floor(y * inv)),
               static_cast<int32_t>(std::floor(z * inv))};
        auto& a = grid[k];
        a.sx += x; a.sy += y; a.sz += z; a.n += 1;
    }
    int64_t w = 0;
    for (const auto& kv : grid) {
        if (w >= cap) break;
        const Accum& a = kv.second;
        out[3 * w] = static_cast<float>(a.sx / a.n);
        out[3 * w + 1] = static_cast<float>(a.sy / a.n);
        out[3 * w + 2] = static_cast<float>(a.sz / a.n);
        ++w;
    }
    return w;
}

}  // extern "C"
