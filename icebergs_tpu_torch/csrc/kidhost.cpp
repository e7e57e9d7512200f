// Host-side native kernels for icebergs_tpu_torch: O(n) cell-hashed bond
// initialization and union-find conglomerate labeling.  The same source
// as icebergs_tpu/csrc/kidhost.cpp, kept here so that the port builds
// from its own package.
//
// The reference does this work inside its Fortran list machinery
// (initialize_iceberg_bonds, icebergs.F90:355-442; conglomerate ids via
// set_conglom_ids, icebergs_framework.F90:2601-2687).  The numpy route
// in ops/forces.py is O(n^2) in memory and time, which is fine for test
// fixtures but not for makeberg-scale initial conditions (e.g.
// rasterized A68 outlines with 10^5+ elements).
//
// Built by native.py with `g++ -O2 -shared -fPIC` into _build/; loaded
// via ctypes.  Pure C ABI, no Python dependencies.

#include <cmath>
#include <cstdint>
#include <vector>
#include <unordered_map>
#include <algorithm>

extern "C" {

// Bond initialization.
//   lon/lat: positions (degrees when latlon != 0, else meters)
//   R:       per-berg interaction radius (meters)
//   crit_const: > 0 -> bond when dist < crit_const (meters)
//               <= 0 -> bond when dist < 1.25 * (R_i + R_j)  (the radii
//                       rule, icebergs.F90:423-427)
//   bond_idx (n*B, init to -1), bond_len (n*B), n_bonds (n): outputs.
//   Partners are recorded in ascending slot order, first B kept —
//   matching the numpy fallback's semantics.
// Returns the total number of directed bonds.
int64_t kid_bond_init(int64_t n, const double* lon, const double* lat,
                      const double* R, double crit_const, int latlon,
                      double Rearth, int B, int32_t* bond_idx,
                      double* bond_len, double* n_bonds) {
    if (n <= 0) return 0;
    // max interaction distance for cell sizing
    double rmax = 0.0;
    for (int64_t i = 0; i < n; ++i) rmax = std::max(rmax, R[i]);
    double dmax = crit_const > 0.0 ? crit_const : 1.25 * 2.0 * rmax;
    if (dmax <= 0.0) return 0;

    // positions in meters (local equirectangular for lat-lon grids)
    const double PI_180 = M_PI / 180.0;
    // hash coordinates: per-point cos(lat) scaling approximates the
    // per-pair metric; the +/-2-cell scan below absorbs the distortion
    // for nearby pairs (pair distances themselves use the exact per-pair
    // cos(mean lat) formula of the numpy path)
    std::vector<double> x(n), y(n), xh(n);
    for (int64_t i = 0; i < n; ++i) {
        if (latlon) {
            x[i] = PI_180 * Rearth * lon[i];
            y[i] = PI_180 * Rearth * lat[i];
            xh[i] = x[i] * std::cos(PI_180 * lat[i]);
        } else {
            x[i] = lon[i];
            y[i] = lat[i];
            xh[i] = x[i];
        }
    }

    // spatial hash on dmax-sized cells (hash covers lat-lon too since the
    // cos(lat) metric only shrinks x-distances)
    auto key = [&](int64_t cx, int64_t cy) {
        return (uint64_t)(cx * 73856093LL) ^ (uint64_t)(cy * 19349663LL);
    };
    std::unordered_map<uint64_t, std::vector<int32_t>> cells;
    cells.reserve((size_t)n * 2);
    std::vector<int64_t> cxs(n), cys(n);
    for (int64_t i = 0; i < n; ++i) {
        cxs[i] = (int64_t)std::floor(xh[i] / dmax);
        cys[i] = (int64_t)std::floor(y[i] / dmax);
        cells[key(cxs[i], cys[i])].push_back((int32_t)i);
    }

    const int64_t span = latlon ? 2 : 1;
    int64_t total = 0;
    std::vector<int32_t> partners;
    for (int64_t i = 0; i < n; ++i) {
        partners.clear();
        for (int64_t dy = -span; dy <= span; ++dy) {
            for (int64_t dx = -span; dx <= span; ++dx) {
                auto it = cells.find(key(cxs[i] + dx, cys[i] + dy));
                if (it == cells.end()) continue;
                for (int32_t j : it->second) {
                    if (j == (int32_t)i) continue;
                    double ddx = x[i] - x[j];
                    double ddy = y[i] - y[j];
                    if (latlon) {
                        // per-pair metric: dx scaled by cos(mean lat)
                        double latm = 0.5 * (lat[i] + lat[j]);
                        ddx *= std::cos(PI_180 * latm);
                    }
                    double r = std::sqrt(ddx * ddx + ddy * ddy);
                    double crit = crit_const > 0.0
                        ? crit_const : 1.25 * (R[i] + R[j]);
                    if (r > 0.0 && r < crit)
                        partners.push_back(j);
                }
            }
        }
        std::sort(partners.begin(), partners.end());
        int nb = 0;
        for (int32_t j : partners) {
            if (nb >= B) break;
            double ddx = x[i] - x[j];
            double ddy = y[i] - y[j];
            if (latlon) {
                double latm = 0.5 * (lat[i] + lat[j]);
                ddx *= std::cos(PI_180 * latm);
            }
            bond_idx[i * B + nb] = j;
            bond_len[i * B + nb] = std::sqrt(ddx * ddx + ddy * ddy);
            ++nb;
        }
        n_bonds[i] = (double)std::min((size_t)partners.size(), (size_t)B);
        total += nb;
    }
    return total;
}

// Conglomerate labels from a bond table: connected components by
// union-find (path halving + union by size).  labels[i] = 1-based
// component id for bonded bergs, 0 for unbonded, matching
// compute_conglom_ids_host's convention.
void kid_conglom_label(int64_t n, const int32_t* bond_idx, int B,
                       int32_t* labels) {
    std::vector<int32_t> parent(n), size(n, 1);
    for (int64_t i = 0; i < n; ++i) parent[i] = (int32_t)i;
    auto find = [&](int32_t a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    };
    bool any = false;
    std::vector<bool> bonded(n, false);
    for (int64_t i = 0; i < n; ++i) {
        for (int b = 0; b < B; ++b) {
            int32_t j = bond_idx[i * B + b];
            if (j < 0 || j >= n) continue;
            bonded[i] = bonded[j] = true;
            any = true;
            int32_t ra = find((int32_t)i), rb = find(j);
            if (ra == rb) continue;
            if (size[ra] < size[rb]) std::swap(ra, rb);
            parent[rb] = ra;
            size[ra] += size[rb];
        }
    }
    (void)any;
    // stable 1-based ids in order of first appearance
    std::unordered_map<int32_t, int32_t> remap;
    int32_t next = 1;
    for (int64_t i = 0; i < n; ++i) {
        if (!bonded[i]) { labels[i] = 0; continue; }
        int32_t r = find((int32_t)i);
        auto it = remap.find(r);
        if (it == remap.end()) { remap[r] = next; labels[i] = next; ++next; }
        else labels[i] = it->second;
    }
}

}  // extern "C"
