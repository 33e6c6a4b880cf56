// Native host-side mesh preprocessing for parcels_tpu_torch.
//
// These run once per grid at ingest but scale with mesh size (FESOM/ICON
// meshes reach millions of triangles), where the pure-Python loops in
// _core/uxgrid.py become the dominant ingest cost. Compiled on demand by
// parcels_tpu_torch.native (g++ -O3) and called through ctypes; the Python
// implementations remain as fallback.
//
// Reference capability: the host-side build phase of the spatial hash
// (reference src/parcels/_core/spatialhash.py:45-231) — here the analogous
// structures are the face-adjacency table (drives the device-side walk) and
// the exact coverage raster (cold-start seeds).

#include <cstdint>
#include <unordered_map>
#include <algorithm>
#include <cmath>

extern "C" {

// adj[f*3 + k] = face sharing the edge opposite node k of face f, or -1.
void build_face_adjacency(const int32_t* conn, int64_t n_face, int32_t* adj) {
    std::unordered_map<uint64_t, uint64_t> edge_owner;  // key -> (face<<2)|k
    edge_owner.reserve(static_cast<size_t>(n_face) * 2);
    for (int64_t f = 0; f < n_face; ++f) {
        for (int k = 0; k < 3; ++k) {
            adj[f * 3 + k] = -1;
        }
    }
    for (int64_t f = 0; f < n_face; ++f) {
        for (int64_t k = 0; k < 3; ++k) {
            int32_t a = conn[f * 3 + (k + 1) % 3];
            int32_t b = conn[f * 3 + (k + 2) % 3];
            uint64_t lo = static_cast<uint32_t>(std::min(a, b));
            uint64_t hi = static_cast<uint32_t>(std::max(a, b));
            uint64_t key = (hi << 32) | lo;
            auto it = edge_owner.find(key);
            if (it == edge_owner.end()) {
                edge_owner.emplace(key, (static_cast<uint64_t>(f) << 2) | k);
            } else {
                int64_t g = static_cast<int64_t>(it->second >> 2);
                int64_t j = static_cast<int64_t>(it->second & 3);
                adj[f * 3 + k] = static_cast<int32_t>(g);
                adj[g * 3 + j] = static_cast<int32_t>(f);
                edge_owner.erase(it);
            }
        }
    }
}

static inline double tri_area2(double ax, double ay, double bx, double by,
                               double cx, double cy) {
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

// Exact rasterization: tbl[ry*nx + rx] = first face containing the raster
// cell center, or -1. tbl must be pre-filled with -1.
void rasterize_faces(const double* node_lon, const double* node_lat,
                     const int32_t* conn, int64_t n_face,
                     double lat_min, double lon_min,
                     double step_y, double step_x,
                     int64_t ny, int64_t nx, int32_t* tbl) {
    for (int64_t f = 0; f < n_face; ++f) {
        double tx[3], ty[3];
        for (int k = 0; k < 3; ++k) {
            tx[k] = node_lon[conn[f * 3 + k]];
            ty[k] = node_lat[conn[f * 3 + k]];
        }
        double a = tri_area2(tx[0], ty[0], tx[1], ty[1], tx[2], ty[2]);
        if (std::fabs(a) < 1e-14) continue;
        double xmin = std::min({tx[0], tx[1], tx[2]});
        double xmax = std::max({tx[0], tx[1], tx[2]});
        double ymin = std::min({ty[0], ty[1], ty[2]});
        double ymax = std::max({ty[0], ty[1], ty[2]});
        int64_t x0 = std::clamp<int64_t>(static_cast<int64_t>((xmin - lon_min) / step_x), 0, nx - 1);
        int64_t x1 = std::clamp<int64_t>(static_cast<int64_t>((xmax - lon_min) / step_x) + 1, 0, nx);
        int64_t y0 = std::clamp<int64_t>(static_cast<int64_t>((ymin - lat_min) / step_y), 0, ny - 1);
        int64_t y1 = std::clamp<int64_t>(static_cast<int64_t>((ymax - lat_min) / step_y) + 1, 0, ny);
        for (int64_t ry = y0; ry < y1; ++ry) {
            double py = lat_min + (ry + 0.5) * step_y;
            for (int64_t rx = x0; rx < x1; ++rx) {
                if (tbl[ry * nx + rx] >= 0) continue;
                double px = lon_min + (rx + 0.5) * step_x;
                double b0 = tri_area2(px, py, tx[1], ty[1], tx[2], ty[2]) / a;
                double b1 = tri_area2(tx[0], ty[0], px, py, tx[2], ty[2]) / a;
                double b2 = 1.0 - b0 - b1;
                if (b0 >= -1e-9 && b1 >= -1e-9 && b2 >= -1e-9) {
                    tbl[ry * nx + rx] = static_cast<int32_t>(f);
                }
            }
        }
    }
}

}  // extern "C"
